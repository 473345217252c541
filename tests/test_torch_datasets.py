"""The port's caption datasets and evaluator against leclip_tpu's.

On tiny synthetic corpora written to ``tmp_path`` (one copy per package, so
neither reads the label / token caches the other writes), the port's
``build_dataset`` gives the same tokens, labels, classnames and test images
as JAX's for each registered variant (mix, check, zema, zuan, plain), and
writes the same class-frequency artifact. The port's evaluator gives the
same mAP / OF1 / CF1 as JAX's on seeded scores. Tolerance: exact (the same
numpy code on both sides)."""

import json
import os
import pickle
import shutil

import numpy as np
import pytest

from leclip_tpu.data.datasets import build_dataset as jbuild
from leclip_tpu.engine import evaluator as jev
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu_torch.data.datasets import build_dataset as tbuild
from leclip_tpu_torch.engine import evaluator as tev
from leclip_tpu_torch.engine.config import setup_config as tsetup


def _corpora(root):
    """Every file the five builders read, at a few lines each."""
    cap = root / "captions" / "generated_captions"
    (cap / "challenge").mkdir(parents=True)
    single = {"16": ["1. A dog is running in the park.", "bad line", "2. 一只狗"],
              "15": ["1. A cat sits on a couch next to a dog."],
              "49": ["1. A knife lies beside a fork and a bowl."]}
    (cap / "ChatGLM_single_label_1.json").write_text(json.dumps(single))
    multi = [{"id": 0, "caption": "A person rides a bicycle past a bench."},
             {"id": 1, "caption": "Nothing recognisable here."},
             {"id": 2, "caption": "Two dogs and a frisbee near a truck."},
             {"id": 3, "caption": "A suitcase and a bottle on a bench."}]
    (cap / "tiny_corpus.json").write_text(json.dumps(multi))
    line = {"labels": ["knife", "spoon"], "captions": ["1. A knife and a spoon."]}
    (cap / "challenge" / "c.jsonl").write_text(json.dumps(line) + "\n")
    (cap / "category_sets.txt").write_text("dog,cat\nperson,bicycle,bench\nknife\ntruck,bench\n")
    (cap / "components_of_few_shot_classes.json").write_text(
        json.dumps({"toaster": ["bread", "kitchen counter"]}))
    (cap / "classdict.json").write_text(json.dumps({str(i): [f"a photo number {i}."]
                                                    for i in range(80)}))
    data = root / "data"
    for sub, name, images in (("official_a", "imnames_finalA.json", ["x/1.jpg", "x/2.jpg"]),
                              ("official_a", "imnames_A.json", ["y/3.jpg"]),
                              ("A_datasets", "imnames_A.json", ["z/4.jpg"])):
        (data / sub).mkdir(parents=True, exist_ok=True)
        (data / sub / name).write_text(json.dumps(images))
    return root


VARIANTS = {
    "mix": ["DATASET.NAME", "chatglm_caption_mix", "TRAIN.add_few_shot", "True"],
    "check": ["DATASET.NAME", "chatglm_caption_check", "TRAIN.challenge_data", "True",
              "TRAIN.hard_data", "hard"],
    "zema": ["DATASET.NAME", "chatglm_caption_zema"],
    "zuan": ["DATASET.NAME", "chatglm_caption_zuan", "TRAIN.add_few_shot", "True"],
    "plain": ["DATASET.NAME", "chatglm_caption", "TRAIN.Caption_name", "classdict"],
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_dataset_matches_jax(tmp_path, variant):
    base = _corpora(tmp_path / "jax")
    shutil.copytree(base, tmp_path / "port")
    out = {}
    for side, setup, build in (("jax", jsetup, jbuild), ("port", tsetup, tbuild)):
        root = tmp_path / side
        opts = ["DATASET.caption_feat_root", str(root / "captions"),
                "DATASET.ROOT", str(root / "data"), "DATASET.dataset_select", "A",
                "TRAIN.Caption_name", "tiny_corpus", "SEED", "3"] + VARIANTS[variant]
        out[side] = build(setup(opts=opts))
    j, t = out["jax"], out["port"]
    assert len(j) > 0 or variant == "plain"
    np.testing.assert_array_equal(t.tokens, j.tokens)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.tokens.dtype == j.tokens.dtype and t.labels.dtype == j.labels.dtype
    assert t.classnames == j.classnames and len(t.classnames) == 80
    assert ([os.path.relpath(p, tmp_path / "port") for p in t.test_images]
            == [os.path.relpath(p, tmp_path / "jax") for p in j.test_images])
    freq = "captions/generated_captions/tiny_corpus_class_freq.pkl"
    if (tmp_path / "jax" / freq).exists():
        a = pickle.load(open(tmp_path / "port" / freq, "rb"))
        b = pickle.load(open(tmp_path / "jax" / freq, "rb"))
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_evaluator_matches_jax():
    rng = np.random.default_rng(0)
    n, c = 40, 12
    gt = (rng.random((n, c)) < 0.3).astype(np.float32)
    gt[:, 3] = 0  # a class without positives
    outs = [rng.standard_normal((n, c)).astype(np.float32) for _ in range(2)]
    res = {}
    for side, mod in (("jax", jev), ("port", tev)):
        ev = mod.MLClassificationEvaluator(0.3)
        for i in range(0, n, 16):
            ev.process(outs[0][i:i + 16], gt[i:i + 16], outs[1][i:i + 16])
        meter = mod.AveragePrecisionMeter()
        meter.add(outs[0], gt)
        res[side] = (ev.evaluate(), mod.mAP(gt, outs[0]), meter.value(), meter.overall(),
                     meter.overall_topk(3), mod.voc2012_mAP(np.concatenate(
                         [outs[0], gt * 2 - 1], axis=1), c))
    for a, b in zip(res["port"], res["jax"]):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            a, b = [a[k] for k in b], list(b.values())
        np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
    assert res["port"][0]["mAP"] > 0
