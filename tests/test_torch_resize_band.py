"""The Python around the banded crop + resize kernel (ops/resize_kernels.py),
on the CPU: the kernel's rule for a row's candidate taps holds every
non-zero weight of the dense matrices at COCO's sizes in every bucket, the
wrapper takes the plain chain for CPU tensors and launches nothing, and the
engine's crops and the train transform reach the wrapper once a batch.

The kernel itself runs only on the card: tests/test_torch_cuda_kernels.py
holds it to resize_band_plain there. Imports no JAX."""

import numpy as np
import pytest
import torch

from leclip_tpu_torch.inference import tta
from leclip_tpu_torch.ops import launches, preprocess
from leclip_tpu_torch.ops import resize_kernels as rk
from leclip_tpu_torch.ops.crops import tta_sampling_boxes
from leclip_tpu_torch.ops.resize_matmul import (axis_resize_matrix, crop_and_resize_matmul,
                                                crop_and_resize_matmul_batch,
                                                crop_and_resize_matmul_per_image)

torch.set_num_threads(2)

# COCO's common image sizes (h, w), fitted into a bucket as pad_to_bucket does
COCO_SIZES = ((480, 640), (640, 427), (375, 500), (612, 612))


def _content(size, bucket):
    h, w = size
    if h > bucket[0] or w > bucket[1]:
        s = min(bucket[0] / h, bucket[1] / w)
        h, w = max(1, int(h * s)), max(1, int(w * s))
    return h, w


def _spans(h, w, rng):
    """16 (lo, hi) along each axis of an (h, w) content: the engine's global
    crop and some of its pyramid's, with random, edge-touching and upscaled
    (side 72) ones."""
    pyramid, _ = tta_sampling_boxes(h, w, (2, 3, 4))
    side = min(h, w)
    gy, gx = (h - side) / 2.0, (w - side) / 2.0
    boxes = np.concatenate([[[gy, gx, gy + side, gx + side]], pyramid]).astype(np.float32)
    spans = []
    for lo_col, size in ((0, h), (1, w)):
        got = sorted({(float(b[lo_col]), float(b[lo_col + 2])) for b in boxes})
        got = set(got[::max(1, len(got) // 7)][:7])
        for s in (min(72.0, size), float(size), size * 0.5):
            got |= {(0.0, s), (size - s, float(size))}
        while len(got) < 16:
            s = float(rng.uniform(8.0, size))
            lo = float(rng.uniform(0.0, size - s))
            got.add((lo, lo + s))
        spans.append((size, sorted(got)))
    return spans


@pytest.mark.parametrize("bucket", tta.DEFAULT_BUCKETS, ids=lambda b: f"{b[0]}x{b[1]}")
def test_tap_band_covers_every_nonzero_weight(bucket):
    """Every non-zero weight of axis_resize_matrix (the dense rows the plain
    chain multiplies) lies inside the kernel's candidate taps, and their
    count stays within max_taps, which sizes the kernel's shared memory."""
    rng = np.random.default_rng(sum(bucket))
    seen = 0
    for k, size in enumerate(COCO_SIZES):
        h, w = _content(size, bucket)
        for (content, spans), side in zip(_spans(h, w, rng), bucket):
            for antialias in (True, False)[:2 if k == 0 else 1]:
                lo = torch.tensor([s[0] for s in spans])
                hi = torch.tensor([s[1] for s in spans])
                dense = axis_resize_matrix(lo, hi, content, side, 224, antialias)
                first, count = rk.tap_band(lo, hi, content, 224, antialias)
                assert count.max().item() <= rk.max_taps(max(bucket), 224, antialias)
                idx = torch.arange(side)
                inside = (idx >= first[..., None]) & (idx < (first + count)[..., None])
                assert not ((dense != 0) & ~inside).any(), (size, content, antialias)
                seen += int((dense != 0).sum())
    assert seen > 0


def _batch(shapes, bucket, seed=0):
    rng = np.random.default_rng(seed)
    imgs, content = [], []
    for h, w in shapes:
        img = np.zeros(bucket + (3,), np.uint8)
        img[:h, :w] = rng.integers(0, 256, (h, w, 3))
        imgs.append(img)
        content.append((h, w))
    return torch.from_numpy(np.stack(imgs)), torch.tensor(content, dtype=torch.int32)


BOXES = torch.tensor([[0.0, 0.0, 40.0, 40.0], [5.5, 10.25, 60.0, 66.0], [30.0, 40.0, 60.0, 80.0]])


@pytest.mark.parametrize("route", ["shared", "per_image", "one_box"])
def test_resize_band_on_cpu_is_the_plain_chain_and_launches_nothing(route):
    """CPU tensors take the port's route before the kernel, unchanged (the
    engine's shared batch, its image-by-image loop, the train transform's one
    box an image), and count no launch."""
    same = route == "shared"
    images, content = _batch([(60, 80), (60, 80) if same else (50, 70)], (64, 96))
    imgs = images.to(torch.bfloat16) / 255.0
    if route == "shared":
        boxes = BOXES
        ref = crop_and_resize_matmul_batch(imgs, boxes, 32, True, content_hw=(60, 80))
    elif route == "per_image":
        boxes = torch.stack([BOXES, BOXES.flip(0)])
        ref = torch.stack([crop_and_resize_matmul(imgs[i], boxes[i], 32, True,
                                                  content_hw=tuple(content[i].tolist()))
                           for i in range(2)])
    else:
        boxes = BOXES[:2, None]
        ref = crop_and_resize_matmul_per_image(imgs, boxes[:, 0], content.float(), 32)[:, None]
    launches.reset_launch_counts()
    out = rk.resize_band(images, boxes, content, 32, dtype=torch.bfloat16, normalize=False)
    normed = rk.resize_band(images, boxes, content, 32, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (2, boxes.shape[-2], 32, 32, 3)
    assert torch.equal(out, ref)
    assert torch.equal(normed, preprocess.clip_normalize(ref))
    assert launches.launch_counts()["resize_band"] == 0
    with pytest.raises(ValueError, match="bf16 or fp32"):
        rk.resize_band(images, boxes, content, 32, dtype=torch.float16)


def _tiny_engine():
    from leclip_tpu_torch.data.vocab import COCO_OBJECT_CATEGORIES
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
    from leclip_tpu_torch.models.dense_clip import DenseFlags
    from leclip_tpu_torch.models.prompt import build_prompt_learner

    cfg = PRESETS["ViT-TEST"]
    g = torch.Generator().manual_seed(0)
    params = init_clip_params(g, cfg, device="cpu")
    tr, consts = build_prompt_learner(g, params, COCO_OBJECT_CATEGORIES[:4], n_ctx=4)
    spec = tta.build_model_spec(params, cfg, tr, consts, DenseFlags())
    return tta.TTAEngine(params, cfg, {"best": spec}, scales=(2,), crop_size=32, device="cpu")


@pytest.mark.parametrize("sizes", [[(72, 96), (96, 72), (60, 80)], [(72, 96), (72, 96)]],
                         ids=["mixed", "same"])
def test_engine_crops_make_one_wrapper_call(monkeypatch, sizes):
    """A staged batch's crops are one resize_band call, mixed sizes (each
    image's boxes) or not (the batch's boxes), with the values of the
    engine's route before the kernel."""
    engine = _tiny_engine()
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, s + (3,)).astype(np.uint8) for s in sizes]
    staged = engine.stage_batch_fused(images)
    assert staged.boxes.dim() == (3 if len(set(sizes)) > 1 else 2)
    calls = []

    def counted(*a, **k):
        calls.append(a[1].shape)
        return rk.resize_band(*a, **k)

    monkeypatch.setattr(tta, "resize_band", counted)
    crops = engine._crops(staged)
    assert len(calls) == 1 and crops.shape == (len(sizes), staged.n_boxes, 32, 32, 3)
    imgs = staged.images.to(engine.compute_dtype) / 255.0
    for i, (h, w) in enumerate(sizes):
        boxes = staged.boxes if staged.boxes.dim() == 2 else staged.boxes[i]
        ref = crop_and_resize_matmul(imgs[i], boxes, 32, True, content_hw=(h, w))
        assert torch.equal(crops[i], preprocess.clip_normalize(ref))


def test_train_transform_makes_one_wrapper_call(monkeypatch):
    """preprocess_train_batch resizes the batch's boxes, one an image, in one
    resize_band call, unnormalised (the cutout and the flip come between),
    with the values of its route before the kernel."""
    images, content = _batch([(60, 80), (64, 50), (40, 90)], (64, 96), seed=5)
    draws = preprocess.sample_train(torch.Generator().manual_seed(7), (3,), size=32)
    calls = []

    def counted(*a, **k):
        calls.append(k.get("normalize"))
        return rk.resize_band_plain(*a, **k)

    monkeypatch.setattr(rk, "resize_band", counted)
    out = preprocess.preprocess_train_batch(images, content, draws, size=32)
    assert calls == [False] and out.shape == (3, 32, 32, 3)
    monkeypatch.undo()
    hw = content.float()
    box_rrc = preprocess.random_resized_crop_box(hw[:, 0], hw[:, 1], draws.rrc)
    side = torch.minimum(hw[:, 0], hw[:, 1])
    cy, cx = hw[:, 0] / 2.0, hw[:, 1] / 2.0
    box_cc = torch.stack([cy - side / 2, cx - side / 2, cy + side / 2, cx + side / 2], dim=-1)
    box = torch.where(draws.use_rrc[:, None], box_rrc, box_cc)
    crop = crop_and_resize_matmul_per_image(images.float() / 255.0, box, hw, 32)
    cut = preprocess.cutout(crop, draws.cut_y, draws.cut_x, 0.4)
    crop = torch.where(draws.use_rrc[:, None, None, None], crop, cut)
    ref = preprocess.clip_normalize(preprocess.random_flip(crop, draws.flip))
    assert torch.equal(out, ref)
