"""Zero-shot scoring of the port (leclip_tpu_torch/cli/zeroshot.py) and the
pieces it adds (ops/crops.py ``crop_and_resize``, ops/preprocess.py
``resize_center_crop`` / ``preprocess_eval``) against leclip_tpu's.

Tolerances. The sampler: 1e-5 of max(1, max|ref|). Both packages compute
the sample coordinates, tap weights and sums in fp32; a coordinate near 60
carries fp32's 4e-6 spacing, so each side sits ~2-3e-6 from a float64
sampler on unit-range images (measured) and the two within 5e-6 of each
other. Chunking changes no number: the port's crops are bitwise equal for
any chunk. The text features and scores: 1e-5 / 1e-4 of max(1, max|ref|)
(fp32 towers, summation order only). The CLI's ``--out`` JSON: 1e-4, and
the same ``zero-shot mAP`` line."""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import openai_rn_state_dict, openai_vit_state_dict, rn_clip_params, to_port
from leclip_tpu.cli import zeroshot as jzs
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.models import clip as jclip
from leclip_tpu.ops import crops as jcrops
from leclip_tpu.ops import preprocess as jpre
from leclip_tpu_torch.cli import zeroshot as tzs
from leclip_tpu_torch.ops import crops as tcrops
from leclip_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(2)

BOXES = np.array([[-5, -3, 20, 30],        # past the top-left edge: reflected
                  [10.3, 2.7, 36.2, 51.9],  # fractional, inside
                  [30, 40, 60, 70],         # past the bottom-right edge
                  [0, 0, 37, 53],           # the whole image
                  [1.5, 2.5, 3.5, 4.5],     # upsampled 2x2
                  [-40, -60, 80, 110]],     # more than an image past every edge
                 np.float32)


def _close(out, ref, tol):
    ref = np.asarray(ref, np.float32)
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("content", [None, (30, 45), (1, 53)], ids=["full", "content", "one-row"])
@pytest.mark.parametrize("method", ["cubic", "linear"])
def test_crop_and_resize_matches_jax(method, content):
    img = np.random.default_rng(0).random((37, 53, 3)).astype(np.float32)
    jhw = None if content is None else (jnp.int32(content[0]), jnp.int32(content[1]))
    ref = jcrops.crop_and_resize(jnp.asarray(img), jnp.asarray(BOXES), 17, method, chunk=4,
                                 content_hw=jhw)
    outs = [tcrops.crop_and_resize(torch.tensor(img), torch.tensor(BOXES), 17, method,
                                   chunk=chunk, content_hw=hw)
            for chunk, hw in ((1, content), (4, content), (16, None if content is None else
                                                           tuple(torch.tensor(v) for v in content)))]
    _close(outs[0], ref, 1e-5)
    for o in outs[1:]:  # chunking (and int or tensor extents) change no number
        assert torch.equal(o, outs[0])


def test_reflect_index_matches_jax():
    idx = np.arange(-30, 60, dtype=np.int32)
    for size in (1, 2, 7, 29):
        ref = np.asarray(jcrops._reflect_index(jnp.asarray(idx), size))
        np.testing.assert_array_equal(tcrops._reflect_index(torch.tensor(idx), size).numpy(), ref)
        traced = np.asarray(jcrops._reflect_index(jnp.asarray(idx), jnp.int32(size)))
        np.testing.assert_array_equal(
            tcrops._reflect_index(torch.tensor(idx), torch.tensor(size)).numpy(), traced)


@pytest.mark.parametrize("hw", [(40, 64), (64, 40), (50, 50), (33, 97)])
def test_preprocess_eval_matches_jax(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,)).astype(np.uint8)
    ref = jpre.preprocess_eval(jnp.asarray(img), 32)
    out = tpre.preprocess_eval(torch.tensor(img), 32)
    assert out.shape == (32, 32, 3) and out.dtype == torch.float32
    _close(out, ref, 1e-5)
    _close(tpre.resize_center_crop(tpre.to_float(torch.tensor(img)), 24, "linear"),
           jpre.resize_center_crop(jpre.to_float(jnp.asarray(img)), 24, "linear"), 1e-5)


def _params(preset):
    cfg = jclip.PRESETS[preset]
    if cfg.vision_patch_size is None:
        return cfg, rn_clip_params(cfg, 3)
    return cfg, jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(3), cfg))


@pytest.mark.parametrize("templates", [False, True], ids=["one", "templates"])
def test_text_features_match_jax(templates):
    cfg, jp = _params("ViT-TEST")
    classes = list(COCO_OBJECT_CATEGORIES[:6])
    ref = jzs.zero_shot_text_features(jax.tree.map(jnp.asarray, jp), cfg, classes, templates)
    out = tzs.zero_shot_text_features(to_port(jp), cfg, classes, templates)
    assert out.shape == (6, cfg.embed_dim)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("preset", ["RN-TEST", "ViT-TEST"])
def test_scores_match_jax(preset):
    cfg, jp = _params(preset)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((3, cfg.image_resolution, cfg.image_resolution, 3)).astype(
        np.float32)
    text = rng.standard_normal((10, cfg.embed_dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    ref = jzs.zero_shot_scores(jax.tree.map(jnp.asarray, jp), cfg, jnp.asarray(images), text)
    out = tzs.zero_shot_scores(to_port(jp), cfg, torch.tensor(images), text)
    assert out.shape == (3, 10)
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("preset", ["RN-TEST", "ViT-TEST"])
def test_cli_out_json_matches_jax(preset, tmp_path, capsys):
    cfg, jp = _params(preset)
    sd = openai_rn_state_dict(jp) if cfg.vision_patch_size is None else \
        openai_vit_state_dict(jp, cfg.vision_patch_size)
    weights = tmp_path / "clip.pt"
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, weights)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(2)
    for i, (h, w) in enumerate([(60, 80), (80, 60), (70, 70)]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(
            imgs / f"{i}.jpg", quality=90)
    Image.fromarray(rng.integers(0, 255, (50, 90, 3)).astype(np.uint8)).save(imgs / "3.png")
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({"0.jpg": [1, 5], "1.jpg": [2], "2.jpg": [5, 7], "3.png": [1]}))
    common = ["--weights", str(weights), "--images-dir", str(imgs), "--labels", str(labels),
              "--batch-size", "3"]
    jzs.main(common + ["--out", str(tmp_path / "jax.json")])
    jtext = capsys.readouterr().out
    tzs.main(common + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    ttext = capsys.readouterr().out
    ref = json.loads((tmp_path / "jax.json").read_text())
    out = json.loads((tmp_path / "port.json").read_text())
    assert sorted(out) == sorted(ref) == ["0.jpg", "1.jpg", "2.jpg", "3.png"]
    for name in ref:
        _close(np.asarray(out[name]), np.asarray(ref[name]), 1e-4)
    mine = re.search(r"^zero-shot mAP: (.*)$", ttext, re.M).group(1)
    assert mine == re.search(r"^zero-shot mAP: (.*)$", jtext, re.M).group(1)
    assert "scored 4 images" in ttext and re.search(r"^kernel launches: \{", ttext, re.M)
