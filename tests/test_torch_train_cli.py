"""The port's training CLI end to end on the CPU: ``python -m
leclip_tpu_torch.cli.train ... --device cpu`` on a fixture corpus (the
plain variant: a caption a class) and the RN-TEST backbone writes
``model.ckpt-0``; the JAX package's ``load_prompt_params`` reads the same
prompt tensors from it (exact), and the port's evaluation CLI scores images
with it staged as all six ensemble members."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from leclip_tpu.engine.checkpoint import load_prompt_params as jload
from leclip_tpu_torch.engine.checkpoint import load_prompt_params as tload

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _workspace(tmp):
    """The plain variant's corpus (one caption a class) and two images."""
    croot = tmp / "text_result" / "generated_captions"
    croot.mkdir(parents=True)
    (croot / "classdict.json").write_text(json.dumps(
        {str(i): [f"a photo of the number {i}."] for i in range(80)}))
    droot = tmp / "data" / "A_datasets"
    (droot / "dataset_A").mkdir(parents=True)
    from PIL import Image

    rng = np.random.default_rng(0)
    names = []
    for i in range(2):
        name = f"img_{i}.png"
        Image.fromarray(rng.integers(0, 255, (72 + 8 * i, 96, 3)).astype(np.uint8)).save(
            droot / "dataset_A" / name)
        names.append(name)
    (droot / "imnames_A.json").write_text(json.dumps(names))
    return ["DATASET.ROOT", str(tmp / "data"),
            "DATASET.caption_feat_root", str(tmp / "text_result"),
            "DATASET.NAME", "chatglm_caption", "TRAIN.Caption_name", "classdict",
            "OPTIM.MAX_EPOCH", "1", "DATALOADER.BATCH_SIZE_TRAIN", "16",
            "TRAINER.N_CTX", "4", "TRAIN.PRINT_FREQ", "2", "TEST.NO_TEST", "True"]


def test_train_cli_on_cpu_writes_a_checkpoint_jax_reads(tmp_path):
    opts = _workspace(tmp_path)
    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "leclip_tpu_torch.cli.train", "--device", "cpu",
                        "--output-dir", str(out), "--backbone", "RN-TEST", "--seed", "0"] + opts,
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "checkpoint →" in r.stdout and "training done" in r.stdout
    ckpt = out / "prompt_learner" / "model.ckpt-0"
    assert ckpt.exists() and (out / "prompt_learner" / "checkpoint").read_text() == "model.ckpt-0"
    assert (out / "metrics.jsonl").exists() and (out / "log.txt").exists()

    port = tload(str(out), "prompt_learner")
    ref = jload(str(out), "prompt_learner")
    assert set(port) == set(ref) and port["ctx"].shape == (4, 64)
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))

    # the port's evaluation reads it back, staged as the six members
    from leclip_tpu_torch.cli.eval import main as eval_main

    model_dir = tmp_path / "best_model"
    for name in ("best", "ema", "zema", "diff", "diffh", "difft"):
        (model_dir / name).mkdir(parents=True)
        shutil.copy(ckpt, model_dir / name / "model.ckpt")
    impreds = tmp_path / "impreds.json"
    eval_main(["--device", "cpu", "--backbone", "RN-TEST", "--model-dir", str(model_dir),
               "--out", str(impreds), "--batch-size", "2"] + opts + ["TEST.multi_scale", "(2,)"])
    preds = np.asarray(json.load(open(impreds)))
    assert preds.shape == (2, 80) and np.isfinite(preds).all()
