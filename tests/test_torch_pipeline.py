"""The port's pipeline against leclip_tpu's: the caption bank (default and
bf16 precision), and ``run_full_inference`` / ``cli/eval.py`` on PNG files
with six reference-format member checkpoints, an OpenAI-layout weights
file, a caption bank and co-occurrence statistics, all read by both sides.

Tolerances: fp32 1e-4 (summation order only); the bf16 bank 2e-2 (a few
bf16 ulps of unit-norm features through the tower)."""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from _torch_port import openai_vit_state_dict, to_port
from leclip_tpu.data.tokenizer import tokenize
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu.inference import pipeline as jpipe
from leclip_tpu.models import clip as jclip
from leclip_tpu.models.convert import load_clip_weights as jload
from leclip_tpu_torch.cli.eval import main as teval_main
from leclip_tpu_torch.engine.config import resolve_test_precision, setup_config as tsetup
from leclip_tpu_torch.inference import pipeline as tpipe
from leclip_tpu_torch.models.convert import load_clip_weights as tload

torch.set_num_threads(2)

CFG = jclip.PRESETS["ViT-TEST"]
CAPTIONS = ["a dog runs in a park", "a cat on a couch", "a person rides a bicycle",
            "pizza on a dining table", "two buses and a truck", "an airplane in the sky",
            "a train at the station", "a car parked near a motorcycle", "a red bicycle",
            "people walking"]


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), CFG))


@pytest.mark.parametrize("precision,tol", [("default", 2e-5), ("bf16", 2e-2)])
def test_caption_bank_matches_jax(jparams, precision, tol):
    toks = tokenize(CAPTIONS)
    ref = jpipe.build_caption_bank(jparams, CFG, toks, batch_size=4, precision=precision)
    out = tpipe.build_caption_bank(to_port(jparams), CFG, toks, batch_size=4,
                                   precision=precision, device="cpu")
    assert out.shape == ref.shape == (len(CAPTIONS), CFG.embed_dim) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, jparams):
    ws = tmp_path_factory.mktemp("port_eval")
    root = ws / "data" / "official_a"
    (root / "images").mkdir(parents=True)
    classes = COCO_OBJECT_CATEGORIES[:8]
    (root / "classes.txt").write_text("\n".join(classes))
    from PIL import Image

    names = []
    for i, hw in enumerate([(72, 96), (80, 96), (72, 96)]):
        arr = np.random.default_rng(i).integers(0, 255, hw + (3,)).astype(np.uint8)
        Image.fromarray(arr).save(root / "images" / f"img_{i}.png")
        names.append(f"img_{i}.png")
    (root / "imnames_finalA.json").write_text(json.dumps(names))
    # reference-format prompt checkpoints (model.pth.tar), read by both sides
    rng = np.random.default_rng(1)
    for name in ["best", "ema", "zema", "diff", "diffh", "difft"]:
        n_ctx = 64 if name == "ema" else 16
        sd = {f"prompt_learner.{k}": torch.tensor(
            0.02 * rng.standard_normal((n_ctx, 64)), dtype=torch.float32)
              for k in ("ctx", "ctx_double", "ctx_evidence")}
        sd.update({f"prompt_learner.{k}": torch.tensor(v) for k, v in
                   (("temperature", 3.0), ("spatial_T", 3.0), ("ranking_scale", 4.0))})
        (ws / "best_model" / name).mkdir(parents=True)
        torch.save({"state_dict": sd, "epoch": 5}, ws / "best_model" / name / "model.pth.tar")
    sd = openai_vit_state_dict(jparams, patch=16)
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, ws / "vit_test.pt")
    bank = rng.standard_normal((30, CFG.embed_dim)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    with open(ws / "bank.pkl", "wb") as f:
        pickle.dump(bank, f)
    with open(ws / "freq.pkl", "wb") as f:
        pickle.dump({"adj": rng.random((8, 8)) * 10, "nums": rng.random(8) * 10 + 1}, f)
    return ws


def _opts(ws):
    return ["DATASET.ROOT", str(ws / "data"), "TEST.multi_scale", "(2,)",
            "TEST.PREC", "fp32", "TEST.use_freq", "True"]


def test_run_full_inference_and_cli_match_jax(workspace):
    ws = workspace
    root = ws / "data" / "official_a"
    paths = [str(root / "images" / f"img_{i}.png") for i in range(3)]
    classes = (root / "classes.txt").read_text().split("\n")
    bank = pickle.load(open(ws / "bank.pkl", "rb"))
    freq = pickle.load(open(ws / "freq.pkl", "rb"))

    jcfg = jsetup(opts=_opts(ws), eval_only=True)
    clip_cfg, jp = jload(str(ws / "vit_test.pt"))
    specs = jpipe.load_ensemble_specs(jcfg, jp, clip_cfg, classes, str(ws / "best_model"))
    eng = jpipe.make_engine(jcfg, jp, clip_cfg, specs, caption_bank=bank, freq_stats=freq,
                            mesh=None)
    ref = jpipe.run_full_inference(eng, paths, batch_size=2, out_json=str(ws / "jax.json"),
                                   progress=False)

    tcfg = tsetup(opts=_opts(ws), eval_only=True)
    tclip_cfg, tp = tload(str(ws / "vit_test.pt"))
    tspecs = tpipe.load_ensemble_specs(tcfg, tp, tclip_cfg, classes, str(ws / "best_model"))
    teng = tpipe.make_engine(tcfg, tp, tclip_cfg, tspecs, caption_bank=bank, freq_stats=freq,
                             device="cpu")
    out = tpipe.run_full_inference(teng, paths, batch_size=2, out_json=str(ws / "port.json"),
                                   progress=False)
    assert out.shape == ref.shape == (3, 8)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    teval_main(["--weights", str(ws / "vit_test.pt"), "--model-dir", str(ws / "best_model"),
                "--caption-bank", str(ws / "bank.pkl"), "--freq-stats", str(ws / "freq.pkl"),
                "--out", str(ws / "cli.json"), "--batch-size", "2", "--device", "cpu"]
               + _opts(ws))
    jj, pj, cj = (np.asarray(json.load(open(ws / f"{n}.json"))) for n in ("jax", "port", "cli"))
    assert cj.shape == (3, 8) and np.isfinite(cj).all()
    np.testing.assert_allclose(pj, jj, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(cj, pj, atol=1e-6, rtol=1e-6)


def test_pending_options_raise(workspace):
    """What is still to port raises: the int8 engine of a ResNet tower (the
    per-member dump path, ``save_dir``, no longer does: tests/test_torch_dump.py);
    int8 no longer does either (it resolves, and on the CPU degrades to bf16
    with a warning)."""
    from leclip_tpu_torch.inference.tta import TTAEngine

    assert resolve_test_precision("auto", CFG, "cpu") == "bf16"
    assert resolve_test_precision("fp32", CFG, "cpu") == "fp32"
    with pytest.warns(UserWarning, match="falling back to bf16"):
        assert resolve_test_precision("int8", CFG, "cpu") == "bf16"
    with pytest.raises(ValueError, match="ViT backbones only"):
        TTAEngine({}, jclip.PRESETS["RN-TEST"], {}, precision="int8", device="cpu")


def test_prompt_checkpoint_formats(tmp_path):
    """The port's own model.pt files round-trip, win over a reference
    model.pth.tar in the same directory, and pick the highest epoch."""
    from leclip_tpu_torch.engine.checkpoint import load_prompt_params, save_prompt_params

    rng = np.random.default_rng(0)

    def trainable():
        return {k: torch.tensor(rng.standard_normal((4, 8)), dtype=torch.float32)
                for k in ("ctx", "ctx_double", "ctx_evidence")}

    ref_sd = {f"prompt_learner.{k}": v for k, v in trainable().items()}
    ref_sd.update({f"prompt_learner.{k}": torch.tensor(1.0)
                   for k in ("temperature", "spatial_T", "ranking_scale")})
    (tmp_path / "best").mkdir()
    torch.save({"state_dict": ref_sd, "epoch": 2}, tmp_path / "best" / "model.pth.tar-2")
    got = load_prompt_params(str(tmp_path), "best")
    torch.testing.assert_close(got["ctx"], ref_sd["prompt_learner.ctx"])
    early, late = trainable(), trainable()
    save_prompt_params(early, str(tmp_path), "best", epoch=1)
    save_prompt_params(late, str(tmp_path), "best", epoch=3)
    got = load_prompt_params(str(tmp_path), "best")
    torch.testing.assert_close(got["ctx"], late["ctx"])
    torch.testing.assert_close(load_prompt_params(str(tmp_path), "best", epoch=1)["ctx"],
                               early["ctx"])
    with pytest.raises(FileNotFoundError):
        load_prompt_params(str(tmp_path), "ema")
