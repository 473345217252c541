"""The port's per-member dump path against leclip_tpu's: ``TTAEngine.run_batch``
(every member key and both retrieval sims, six members in the launcher's
three groups, co-occurrence on the evidence group only, a caption bank),
against the port's own ``run_batch_multidispatch`` and fused path, and
``run_full_inference(save_dir=...)``'s ``data.pkl`` / ``sim_matrix.pkl``.

Tolerances: against JAX 1e-4 (fp32 end to end, summation order only, as
tests/test_torch_tta.py); the port against itself 1e-5 (the same logits,
aggregated on the device or on the host); the fused path against the host
fusion of the dumps 1e-4, as tests/test_tta.py holds the JAX pair."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from _torch_port import tta_engines
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.inference import pipeline as jpipe
from leclip_tpu.models import clip as jclip
from leclip_tpu_torch.inference import pipeline as tpipe
from leclip_tpu_torch.ops.ensemble import DEFAULT_ROUTING, generate_final_answers

torch.set_num_threads(2)

CFG = jclip.PRESETS["ViT-TEST"]
CLASSES = COCO_OBJECT_CATEGORIES[:8]
GROUPS = ((("best", "difft"), True, True, 16), (("zema", "diff", "diffh"), False, False, 16),
          (("ema",), False, False, 64))
KEYS = ("output", "output_pos", "output_blocks", "output_pos_blocks", "output_final",
        "output_pos_final")


@pytest.fixture(scope="module")
def engines():
    return tta_engines(CFG, CLASSES, GROUPS)


def _images(mixed: bool):
    shapes = [(72, 96), (80, 96)] if mixed else [(72, 96), (72, 96)]
    return [np.random.default_rng(20 + i).integers(0, 255, s + (3,)).astype(np.uint8)
            for i, s in enumerate(shapes)]


def _assert_dumps_close(out, ref, tol):
    assert list(out) == list(ref)
    for name in ref:
        if name == "_sims":
            continue
        assert set(out[name]) == set(KEYS)
        for k in KEYS:
            got, want = out[name][k], np.asarray(ref[name][k])
            assert got.dtype == np.float32 and got.shape == want.shape, (name, k)
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=f"{name}/{k}")
    for k in ("sims_all", "sims_blocks_all") if "_sims" in ref else ():
        got, want = out["_sims"][k], np.asarray(ref["_sims"][k])
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=k)


@pytest.mark.parametrize("mixed", [False, True])
def test_run_batch_matches_jax(engines, mixed):
    jeng, teng = engines
    images = _images(mixed)
    out, ref = teng.run_batch(images), jeng.run_batch(images)
    n = 1 + teng.n_blocks
    assert out["best"]["output_blocks"].shape == (2, n - 1, len(CLASSES))
    assert out["_sims"]["sims_blocks_all"].shape == (2, n - 1, 5)
    _assert_dumps_close(out, ref, 1e-4)


def test_run_batch_matches_multidispatch(engines):
    _, teng = engines
    images = _images(False)
    _assert_dumps_close(teng.run_batch(images), teng.run_batch_multidispatch(images), 1e-5)


def test_dump_passes_pickle_identically(engines):
    _, teng = engines
    images = _images(True)
    assert pickle.dumps(teng.run_batch(images)) == pickle.dumps(teng.run_batch(images))


def test_fused_path_matches_host_fusion(engines):
    _, teng = engines
    images = _images(True)
    fused = teng.run_batch_fused(images)
    dumps = teng.run_batch(images)
    sims = dumps.pop("_sims")
    host = generate_final_answers(dumps, sims["sims_blocks_all"], routing=DEFAULT_ROUTING,
                                  base="best")
    assert fused.shape == host.shape == (2, len(CLASSES))
    np.testing.assert_allclose(fused, host, atol=1e-4, rtol=1e-4)


def test_bf16_fused_path_matches_jax_host_fusion_of_its_dumps():
    """The fused path fuses fp32 logits, where JAX's ``_fused_fn`` fuses in
    the compute dtype: on a bf16 engine its scores are pinned to the JAX
    package's own ``generate_final_answers`` over the same engine's fp32
    dumps (the reference's dump-then-fuse flow)."""
    from leclip_tpu.ops import ensemble as jens

    from _torch_port import to_port, tta_ensemble
    from leclip_tpu_torch.inference import tta as ttta

    jp, tp, jspecs, tspecs, bank, cooc = tta_ensemble("bf16", CFG, CLASSES, GROUPS)
    tspecs = {n: s._replace(text_feats=to_port(jspecs[n].text_feats)) for n, s in tspecs.items()}
    kw = dict(scales=(2,), cooccurrence=cooc, crop_size=CFG.image_resolution, topk=5)
    teng = ttta.TTAEngine(tp, CFG, tspecs, caption_bank=torch.tensor(bank),
                          compute_dtype=torch.bfloat16, device="cpu", **kw)
    images = _images(True)

    def host_fusion(dumps):
        sims = dumps.pop("_sims")["sims_blocks_all"]
        return jens.generate_final_answers(dumps, sims, routing=jens.DEFAULT_ROUTING, base="best")

    fused, host = teng.run_batch_fused(images), host_fusion(teng.run_batch(images))
    assert fused.shape == host.shape == (2, len(CLASSES))
    np.testing.assert_allclose(fused, host, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("dump_images")
    paths = []
    for i, hw in enumerate([(72, 96), (80, 96), (72, 96)]):
        arr = np.random.default_rng(30 + i).integers(0, 255, hw + (3,)).astype(np.uint8)
        paths.append(str(root / f"img_{i}.png"))
        Image.fromarray(arr).save(paths[-1])
    return paths


def test_run_full_inference_save_dir_matches_jax(engines, image_files, tmp_path):
    jeng, teng = engines
    ref = jpipe.run_full_inference(jeng, image_files, batch_size=2,
                                   save_dir=str(tmp_path / "jax"),
                                   out_json=str(tmp_path / "jax.json"), progress=False)
    out = tpipe.run_full_inference(teng, image_files, batch_size=2,
                                   save_dir=str(tmp_path / "port"),
                                   out_json=str(tmp_path / "port.json"), progress=False)
    assert out.shape == ref.shape == (3, len(CLASSES))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    # input order restored: the dump path equals the fused path image by image
    fused = tpipe.run_full_inference(teng, image_files, batch_size=2, progress=False)
    np.testing.assert_allclose(out, fused, atol=1e-4, rtol=1e-4)
    for fname in ("data.pkl", "sim_matrix.pkl"):
        with open(tmp_path / "jax" / fname, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / fname, "rb") as f:
            got = pickle.load(f)
        if fname == "sim_matrix.pkl":
            got, want = {"_sims": got}, {"_sims": want}
        _assert_dumps_close(got, want, 1e-4)
    pj, jj = (np.asarray(json.load(open(tmp_path / f"{n}.json"))) for n in ("port", "jax"))
    np.testing.assert_allclose(pj, out, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(pj, jj, atol=1e-4, rtol=1e-4)


def test_empty_save_dir_runs_the_dump_path_and_writes_nothing(engines, image_files, tmp_path,
                                                              monkeypatch):
    _, teng = engines
    monkeypatch.chdir(tmp_path)
    calls = []
    real = teng.dispatch_batch_dump
    monkeypatch.setattr(teng, "dispatch_batch_dump",
                        lambda images: calls.append(len(images)) or real(images))
    out = tpipe.run_full_inference(teng, image_files, batch_size=2, save_dir="", progress=False)
    assert calls == [2, 1] and os.listdir(tmp_path) == []
    np.testing.assert_allclose(
        out, tpipe.run_full_inference(teng, image_files, batch_size=2, progress=False),
        atol=1e-4, rtol=1e-4)
