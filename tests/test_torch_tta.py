"""The port's TTA engine and its pieces against leclip_tpu's: crop geometry,
the matmul resizer, the fusion math, and ``TTAEngine.run_batch_fused`` with
a six-member ensemble in the three launcher groups, a caption bank and a
co-occurrence matrix.

Tolerances: fp32 end to end 1e-4 (summation order only); bf16 params and
compute (JAX ``bf16_fused=True``, Pallas in interpret mode) 5e-2 with
correlation > 0.999, as tests/test_block_kernels.py holds the JAX fused
engine against its unfused one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_port, tta_ensemble
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.inference import tta as jtta
from leclip_tpu.models import clip as jclip
from leclip_tpu.ops import crops as jcrops
from leclip_tpu.ops import ensemble as jens
from leclip_tpu.ops import resize_matmul as jrm
from leclip_tpu_torch.inference import tta as ttta
from leclip_tpu_torch.ops import crops as tcrops
from leclip_tpu_torch.ops import ensemble as tens
from leclip_tpu_torch.ops import resize_matmul as trm

torch.set_num_threads(2)

CFG = jclip.PRESETS["ViT-TEST"]
CLASSES = COCO_OBJECT_CATEGORIES[:8]
# the reference launcher's grouping: (members, use_evidence, use_freq, n_ctx)
GROUPS = ((("best", "difft"), True, True, 16), (("zema", "diff", "diffh"), False, False, 16),
          (("ema",), False, False, 64))


def test_sampling_boxes_305_and_equal():
    boxes, counts = tcrops.tta_sampling_boxes(480, 640, (2, 3, 4))
    assert counts == (40, 100, 164) and 1 + len(boxes) == 305
    for hw in [(480, 640), (375, 500), (97, 131)]:
        jb, jc = jcrops.tta_sampling_boxes(*hw, (2, 3, 4))
        tb, tc = tcrops.tta_sampling_boxes(*hw, (2, 3, 4))
        assert jc == tc
        np.testing.assert_array_equal(jb, tb)


def test_pick_and_pad_bucket_match():
    img = np.random.default_rng(0).integers(0, 255, (300, 1400, 3)).astype(np.uint8)
    for shape in [(200, 200), (300, 500), (1500, 900)]:
        assert ttta.pick_bucket(*shape) == jtta.pick_bucket(*shape)
    bucket = ttta.pick_bucket(300, 1400)
    jp, jhw = jtta.pad_to_bucket(img, bucket)
    tp, thw = ttta.pad_to_bucket(img, bucket)
    assert jhw == thw
    np.testing.assert_array_equal(jp, tp)


@pytest.mark.parametrize("antialias", [True, False])
def test_crop_and_resize_matmul_batch_matches(antialias):
    rng = np.random.default_rng(1)
    imgs = rng.random((2, 96, 128, 3)).astype(np.float32)
    boxes, _ = jcrops.tta_sampling_boxes(90, 120, (2,))
    ref = jrm.crop_and_resize_matmul_batch(jnp.asarray(imgs), jnp.asarray(boxes), 32,
                                           antialias, content_hw=jnp.asarray([90, 120]))
    out = trm.crop_and_resize_matmul_batch(torch.tensor(imgs), torch.tensor(boxes), 32,
                                           antialias, content_hw=(90, 120))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    one = trm.crop_and_resize_matmul(torch.tensor(imgs[1]), torch.tensor(boxes), 32, antialias,
                                     content_hw=(90, 120))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref[1]), atol=1e-5, rtol=1e-5)


def test_fusion_math_matches():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((3, 40, 8)).astype(np.float32)
    sims = rng.random((3, 40, 10)).astype(np.float32)
    base = rng.standard_normal((3, 8)).astype(np.float32)
    p = rng.random((8, 8)).astype(np.float32)
    t = torch.tensor
    for jf, tf in [(jens.fuse, tens.fuse), (jens.fuse6, tens.fuse6)]:
        np.testing.assert_allclose(tf(t(data), t(sims)).numpy(), jf(data, sims),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tens.aggregate_blocks(t(data), base=t(base)).numpy(),
                               jens.aggregate_blocks(data, base=base), atol=1e-6)
    np.testing.assert_allclose(tens.aggregate_blocks(t(data), 0.1, 2.0).numpy(),
                               jens.aggregate_blocks(data, 0.1, 2.0), atol=1e-6)
    np.testing.assert_allclose(tens.adjust_predictions(t(data), t(p)).numpy(),
                               jens.adjust_predictions(data, p), atol=1e-5, rtol=1e-5)
    names = ["best", "ema", "zema", "diff", "diffh", "difft"]
    np.testing.assert_array_equal(tens.routing_vector(names), jens.routing_vector(names))
    adj, nums = rng.random((8, 8)), rng.random(8) + 1
    np.testing.assert_array_equal(tens.normalized_cooccurrence(adj, nums),
                                  jens.normalized_cooccurrence(adj, nums))


def test_generate_final_answers_matches(tmp_path):
    """The numpy host-side fusion + routing + impreds.json writer."""
    rng = np.random.default_rng(3)
    data = {name: {"output": rng.standard_normal((2, 80)),
                   "output_pos": rng.standard_normal((2, 80)),
                   "output_blocks": rng.standard_normal((2, 40, 80)),
                   "output_pos_blocks": rng.standard_normal((2, 40, 80))}
            for name in ("best", "ema", "zema", "diff", "diffh", "difft")}
    sims = rng.random((2, 40, 10))
    ref = jens.generate_final_answers(data, sims, out_path=str(tmp_path / "j.json"))
    out = tens.generate_final_answers(data, sims, out_path=str(tmp_path / "t.json"))
    np.testing.assert_array_equal(out, ref)
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()


def _ensemble(dtype):
    """Both sides' six-member ensembles from one JAX pytree and numpy prompts."""
    return tta_ensemble(dtype, CFG, CLASSES, GROUPS)


@pytest.fixture(scope="module")
def fp32_ensemble():
    return _ensemble("fp32")


def _images(mixed: bool):
    shapes = [(72, 96), (80, 96)] if mixed else [(72, 96), (72, 96)]
    return [np.random.default_rng(10 + i).integers(0, 255, s + (3,)).astype(np.uint8)
            for i, s in enumerate(shapes)]


@pytest.mark.parametrize("mixed", [False, True])
def test_run_batch_fused_fp32_matches_jax(fp32_ensemble, mixed):
    jp, tp, jspecs, tspecs, bank, cooc = fp32_ensemble
    images = _images(mixed)
    kw = dict(scales=(2,), cooccurrence=cooc, crop_size=CFG.image_resolution)
    ref = jtta.TTAEngine(jp, CFG, jspecs, caption_bank=jnp.asarray(bank),
                         compute_dtype=jnp.float32, **kw).run_batch_fused(images)
    eng = ttta.TTAEngine(tp, CFG, tspecs, caption_bank=torch.tensor(bank),
                         compute_dtype=torch.float32, device="cpu", **kw)
    assert [tuple(g[0]) for g in eng._model_groups()] == [g[0] for g in GROUPS]
    out = eng.run_batch_fused(images)
    assert out.shape == ref.shape == (2, 8) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    # both pipelined drivers yield the same batches
    for run in (eng.run_batches_fused, eng.run_batches_fused_staged):
        got = list(run(iter([images, images[:1]])))
        np.testing.assert_allclose(got[0], out, atol=1e-6)
        np.testing.assert_allclose(got[1], out[:1], atol=1e-5)


def test_run_batch_fused_bf16_matches_jax():
    """Both engines score the same member specs (JAX's prompt features moved
    across): in bf16 the two text towers' 1-ulp differences would otherwise
    dominate, amplified by the gated block fusion — prompt features are held
    to JAX's separately, at fp32 (test_torch_dense_clip.py)."""
    jp, tp, jspecs, tspecs, bank, cooc = _ensemble("bf16")
    tspecs = {n: s._replace(text_feats=to_port(jspecs[n].text_feats)) for n, s in tspecs.items()}
    images = _images(False)
    kw = dict(scales=(2,), cooccurrence=cooc, crop_size=CFG.image_resolution)
    ref = jtta.TTAEngine(jp, CFG, jspecs, caption_bank=jnp.asarray(bank),
                         compute_dtype=jnp.bfloat16, bf16_fused=True, **kw).run_batch_fused(images)
    eng = ttta.TTAEngine(tp, CFG, tspecs, caption_bank=torch.tensor(bank),
                         compute_dtype=torch.bfloat16, bf16_fused=True, device="cpu", **kw)
    assert eng._fused
    out = eng.run_batch_fused(images)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=5e-2, atol=5e-2)
    c = np.corrcoef(ref.ravel(), out.ravel())[0, 1]
    assert c > 0.999, c
