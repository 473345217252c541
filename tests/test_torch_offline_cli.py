"""The port's offline CLIs against leclip_tpu's: ``gen_final_ans`` on each
package's dumps (the two packages' ``data.pkl`` / ``sim_matrix.pkl`` are
read by each other's fusion CLI), ``parse_results`` over one
``metrics.jsonl``, and ``build_caption_bank`` on a tiny corpus with an
OpenAI-layout weights file that both sides read.

Tolerances: the fusion CLIs run the same numpy math on the same pickles,
1e-5; the two packages' dumps differ by fp32 summation order, 1e-4 (as
tests/test_torch_dump.py). The bank CLI: default 1e-5; bf16 2e-2 (a few bf16
ulps of unit-norm rows, as tests/test_torch_pipeline.py); int8 all rows
within 1e-4 but at most a tenth of them and nowhere beyond 2e-3, where a
one-ulp difference flips an int8 code (as tests/test_torch_int8_path.py)."""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from _torch_port import openai_vit_state_dict, tta_engines
from leclip_tpu.cli import build_caption_bank as jbank_cli
from leclip_tpu.cli import gen_final_ans as jgen
from leclip_tpu.cli import parse_results as jparse
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.inference import pipeline as jpipe
from leclip_tpu.models import clip as jclip
from leclip_tpu_torch.cli import build_caption_bank as tbank_cli
from leclip_tpu_torch.cli import gen_final_ans as tgen
from leclip_tpu_torch.cli import parse_results as tparse
from leclip_tpu_torch.engine.metrics import MetricsWriter
from leclip_tpu_torch.inference import pipeline as tpipe

torch.set_num_threads(2)

CFG = jclip.PRESETS["ViT-TEST"]
CLASSES = COCO_OBJECT_CATEGORIES[:8]
GROUPS = ((("best", "difft"), True, True, 16), (("zema", "diff", "diffh"), False, False, 16),
          (("ema",), False, False, 64))


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both packages' dumps of the same three PNG files."""
    from PIL import Image

    root = tmp_path_factory.mktemp("offline")
    paths = []
    for i, hw in enumerate([(72, 96), (80, 96), (72, 96)]):
        arr = np.random.default_rng(40 + i).integers(0, 255, hw + (3,)).astype(np.uint8)
        paths.append(str(root / f"img_{i}.png"))
        Image.fromarray(arr).save(paths[-1])
    jeng, teng = tta_engines(CFG, CLASSES, GROUPS)
    jpipe.run_full_inference(jeng, paths, batch_size=2, save_dir=str(root / "jax"),
                             progress=False)
    tpipe.run_full_inference(teng, paths, batch_size=2, save_dir=str(root / "port"),
                             progress=False)
    return root


def _fuse(main, root, src, tag):
    out = root / f"{src}_{tag}.json"
    main(["--data", str(root / src / "data.pkl"), "--sim-matrix",
          str(root / src / "sim_matrix.pkl"), "--out", str(out)])
    return np.asarray(json.load(open(out)))


@pytest.mark.parametrize("src", ["jax", "port"])
def test_gen_final_ans_reads_either_packages_dumps(dumps, src):
    """Each package's fusion CLI on the other's dumps gives that package's
    impreds.json; the dumps hold plain numpy only."""
    with open(dumps / src / "data.pkl", "rb") as f:
        data = pickle.load(f)
    assert all(type(v) is np.ndarray and v.dtype == np.float32
               for outs in data.values() for v in outs.values())
    port, jax_ = _fuse(tgen.main, dumps, src, "port_cli"), _fuse(jgen.main, dumps, src, "jax_cli")
    assert port.shape == (3, len(CLASSES)) and np.isfinite(port).all()
    np.testing.assert_allclose(port, jax_, atol=1e-5, rtol=1e-5)


def test_gen_final_ans_on_both_dumps_agree(dumps):
    np.testing.assert_allclose(_fuse(tgen.main, dumps, "port", "a"),
                               _fuse(tgen.main, dumps, "jax", "a"), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("argv", [[], ["--last"], ["--tag", "train/loss"],
                                  ["--tag", "nope"]])
def test_parse_results_prints_jax_lines(tmp_path, capsys, argv):
    rng = np.random.default_rng(0)
    runs = []
    for r in range(2):
        d = tmp_path / f"run{r}"
        w = MetricsWriter(str(d), tensorboard=False)
        for step in range(5):
            w.write_scalars({"loss": float(rng.random()), "lr": 1e-3 / (step + 1)}, step,
                            prefix="train/")
        w.write_scalar("test/mAP", float(rng.random() * 100), 5)
        w.close()
        runs.append(str(d))
    runs.append(str(tmp_path / "missing"))
    jparse.main(runs + argv)
    want = capsys.readouterr().out
    tparse.main(runs + argv)
    got = capsys.readouterr().out
    assert got == want and want.strip()


CAPTIONS = ["a dog runs in a park", "a cat on a couch", "a person rides a bicycle",
            "pizza on a dining table", "two buses and a truck", "an airplane in the sky",
            "a train at the station", "a car parked near a motorcycle", "a red bicycle",
            "people walking", "a plain wall"]


@pytest.fixture(scope="module")
def bank_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bank")
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(3), CFG))
    sd = openai_vit_state_dict(jp, patch=16)
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, root / "vit_test.pt")
    for side in ("jax", "port"):  # each side labels and caches its own copy
        (root / side).mkdir()
        corpus = [{"id": i, "caption": c} for i, c in enumerate(CAPTIONS)]
        (root / side / "tiny_corpus.json").write_text(json.dumps(corpus))
    return root


def _close_but_flips(out, ref, tol, rows=0.1, cap=2e-3):
    diff = np.abs(out - ref)
    over = diff > tol + tol * np.abs(ref)
    assert over.any(-1).mean() <= rows and diff.max() <= cap, (over.any(-1).mean(), diff.max())


@pytest.mark.parametrize("precision", ["default", "bf16", "int8"])
def test_build_caption_bank_cli_matches_jax(bank_inputs, precision, capsys):
    root = bank_inputs
    banks = {}
    for side, main, extra in (("jax", jbank_cli.main, []),
                              ("port", tbank_cli.main, ["--device", "cpu"])):
        out = root / f"{side}_{precision}.pkl"
        main(["--weights", str(root / "vit_test.pt"), "--backbone", "ViT-TEST",
              "--caption-root", str(root / side), "--corpora", "tiny_corpus",
              "--out", str(out), "--batch-size", "4", "--precision", precision] + extra)
        with open(out, "rb") as f:
            banks[side] = pickle.load(f)
        assert os.path.exists(root / side / "tiny_corpus_labels.pkl")
        if side == "port":  # the CPU runs the plain versions: no kernel counted
            line = [ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("kernel launches: ")]
            counts = json.loads(line[0][len("kernel launches: "):])
            assert len(line) == 1 and "attn_block_bf16" in counts and not any(counts.values())
    out, ref = banks["port"], np.asarray(banks["jax"])
    # "a plain wall" names no class and is left out
    assert out.shape == ref.shape == (len(CAPTIONS) - 1, CFG.embed_dim)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    if precision == "int8":
        _close_but_flips(out, ref, tol=1e-4)
    else:
        tol = 1e-5 if precision == "default" else 2e-2
        np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
