"""The port's scoring path with a ResNet image tower against leclip_tpu's:
``TTAEngine.run_batch_fused`` with a six-member ensemble in the three
launcher groups, a caption bank and a co-occurrence matrix, and
``run_full_inference`` / ``cli/eval.py`` on PNG files with an OpenAI-layout
RN-TEST weights file, every batch norm's statistics drawn at random.

Tolerance: fp32 end to end 1e-4 (summation order only)."""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import openai_rn_state_dict, rn_clip_params, tta_ensemble
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu.inference import pipeline as jpipe
from leclip_tpu.inference import tta as jtta
from leclip_tpu.models import clip as jclip
from leclip_tpu.models.convert import load_clip_weights as jload
from leclip_tpu_torch.cli.eval import main as teval_main
from leclip_tpu_torch.engine.config import resolve_test_precision
from leclip_tpu_torch.engine.config import setup_config as tsetup
from leclip_tpu_torch.inference import pipeline as tpipe
from leclip_tpu_torch.inference import tta as ttta
from leclip_tpu_torch.models.convert import load_clip_weights as tload

torch.set_num_threads(2)

CFG = jclip.PRESETS["RN-TEST"]
CLASSES = COCO_OBJECT_CATEGORIES[:8]
GROUPS = ((("best", "difft"), True, True, 16), (("zema", "diff", "diffh"), False, False, 16),
          (("ema",), False, False, 64))


@pytest.fixture(scope="module")
def jparams():
    return rn_clip_params(CFG)


def _images(mixed: bool):
    shapes = [(72, 96), (80, 96)] if mixed else [(72, 96), (72, 96)]
    return [np.random.default_rng(20 + i).integers(0, 255, s + (3,)).astype(np.uint8)
            for i, s in enumerate(shapes)]


@pytest.mark.parametrize("mixed", [False, True])
def test_rn_run_batch_fused_fp32_matches_jax(jparams, mixed):
    jp, tp, jspecs, tspecs, bank, cooc = tta_ensemble("fp32", CFG, CLASSES, GROUPS, jp=jparams)
    images = _images(mixed)
    kw = dict(scales=(2,), cooccurrence=cooc, crop_size=CFG.image_resolution)
    ref = jtta.TTAEngine(jp, CFG, jspecs, caption_bank=jnp.asarray(bank),
                         compute_dtype=jnp.float32, **kw).run_batch_fused(images)
    eng = ttta.TTAEngine(tp, CFG, tspecs, caption_bank=torch.tensor(bank),
                         compute_dtype=torch.float32, device="cpu", **kw)
    assert not eng._fused and eng._q8 is None
    out = eng.run_batch_fused(images)
    assert out.shape == ref.shape == (2, 8) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_rn_precision_rules():
    """TEST.PREC auto is bf16 for a ResNet tower (on the card too), and an
    int8 engine refuses one, as in the JAX package."""
    assert resolve_test_precision("auto", CFG, "cpu") == "bf16"
    assert resolve_test_precision("auto", jclip.PRESETS["RN50"], "cuda") == "bf16"
    from leclip_tpu_torch.models.clip import init_clip_params

    tp = init_clip_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    with pytest.raises(ValueError, match="ViT"):
        ttta.TTAEngine(tp, CFG, {}, precision="int8", device="cpu")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, jparams):
    from PIL import Image

    ws = tmp_path_factory.mktemp("port_rn_eval")
    root = ws / "data" / "official_a"
    (root / "images").mkdir(parents=True)
    (root / "classes.txt").write_text("\n".join(CLASSES))
    names = []
    for i, hw in enumerate([(72, 96), (80, 96), (72, 96)]):
        arr = np.random.default_rng(30 + i).integers(0, 255, hw + (3,)).astype(np.uint8)
        Image.fromarray(arr).save(root / "images" / f"img_{i}.png")
        names.append(f"img_{i}.png")
    (root / "imnames_finalA.json").write_text(json.dumps(names))
    rng = np.random.default_rng(2)
    for name in ["best", "ema", "zema", "diff", "diffh", "difft"]:
        n_ctx = 64 if name == "ema" else 16
        sd = {f"prompt_learner.{k}": torch.tensor(
            0.02 * rng.standard_normal((n_ctx, CFG.transformer_width)), dtype=torch.float32)
              for k in ("ctx", "ctx_double", "ctx_evidence")}
        sd.update({f"prompt_learner.{k}": torch.tensor(v) for k, v in
                   (("temperature", 3.0), ("spatial_T", 3.0), ("ranking_scale", 4.0))})
        (ws / "best_model" / name).mkdir(parents=True)
        torch.save({"state_dict": sd, "epoch": 5}, ws / "best_model" / name / "model.pth.tar")
    sd = openai_rn_state_dict(jparams)
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, ws / "rn_test.pt")
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


def test_rn_run_full_inference_and_cli_match_jax(workspace):
    ws = workspace
    root = ws / "data" / "official_a"
    paths = [str(root / "images" / f"img_{i}.png") for i in range(3)]
    bank = pickle.load(open(ws / "bank.pkl", "rb"))
    freq = pickle.load(open(ws / "freq.pkl", "rb"))

    jcfg = jsetup(opts=_opts(ws), eval_only=True)
    clip_cfg, jp = jload(str(ws / "rn_test.pt"))
    assert not clip_cfg.is_vit
    specs = jpipe.load_ensemble_specs(jcfg, jp, clip_cfg, CLASSES, str(ws / "best_model"))
    eng = jpipe.make_engine(jcfg, jp, clip_cfg, specs, caption_bank=bank, freq_stats=freq,
                            mesh=None)
    ref = jpipe.run_full_inference(eng, paths, batch_size=2, out_json=str(ws / "jax.json"),
                                   progress=False)

    tcfg = tsetup(opts=_opts(ws), eval_only=True)
    tclip_cfg, tp = tload(str(ws / "rn_test.pt"))
    tspecs = tpipe.load_ensemble_specs(tcfg, tp, tclip_cfg, CLASSES, str(ws / "best_model"))
    teng = tpipe.make_engine(tcfg, tp, tclip_cfg, tspecs, caption_bank=bank, freq_stats=freq,
                             device="cpu")
    out = tpipe.run_full_inference(teng, paths, batch_size=2, out_json=str(ws / "port.json"),
                                   progress=False)
    assert out.shape == ref.shape == (3, 8)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    teval_main(["--weights", str(ws / "rn_test.pt"), "--model-dir", str(ws / "best_model"),
                "--caption-bank", str(ws / "bank.pkl"), "--freq-stats", str(ws / "freq.pkl"),
                "--out", str(ws / "cli.json"), "--batch-size", "2", "--device", "cpu"]
               + _opts(ws))
    pj, cj = (np.asarray(json.load(open(ws / f"{n}.json"))) for n in ("port", "cli"))
    assert cj.shape == (3, 8) and np.isfinite(cj).all()
    np.testing.assert_allclose(cj, pj, atol=1e-6, rtol=1e-6)


def test_rn_cli_random_init_backbone(workspace):
    """``--backbone`` with no weights file: the seeded random ResNet tower
    scores every image (the dry-run route the chip smoke drives at RN50)."""
    ws = workspace
    teval_main(["--backbone", "RN-TEST", "--model-dir", str(ws / "best_model"),
                "--caption-bank", str(ws / "bank.pkl"), "--out", str(ws / "rnd.json"),
                "--batch-size", "2", "--device", "cpu"] + _opts(ws))
    out = np.asarray(json.load(open(ws / "rnd.json")))
    assert out.shape == (3, 8) and np.isfinite(out).all()
