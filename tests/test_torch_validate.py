"""The trainer's image-split ``validate`` of the port
(leclip_tpu_torch/engine/trainer.py) against leclip_tpu's
``_trainer_validate``, and the ``TRAIN.profile_dir`` trace window.

Both packages' trainers hold the same CLIP weights (RN-TEST and ViT-TEST
towers), captions and trained prompt state (the port's state is the JAX
trainer's after 2 training steps), and 4 synthetic JPEG val images
(``test[::100]`` of a 400-image test split). Each ``validate`` feeds
``MLClassificationEvaluator.process`` once per batch of 2 (monkeypatched to
record its arrays): the port's ``output_final`` / ``output_pos_final``
within 1e-4 of max(1, max|ref|) of JAX's (fp32 on both sides: the towers,
the crops' resize and the block fusion differ by summation order; measured
~1e-6), labels equal (zeros), and the results dicts equal. With
``TRAIN.probe_holdout`` set, the caption probe still comes first. An adapter
trainer's image pass scores without its adapter, as JAX's does (a hazard of
the reference, ROADMAP.md). The profiler: a counterpart of
tests/test_train.py::test_profiler_trace_window."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import to_port
from test_torch_train import captions, state_dict
from leclip_tpu.data.datasets import CaptionDataset as JDataset
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.engine import evaluator as jev
from leclip_tpu.engine import trainer as jtr
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu.models import clip as jclip
from leclip_tpu_torch.data.datasets import CaptionDataset as TDataset
from leclip_tpu_torch.engine import evaluator as tev
from leclip_tpu_torch.engine import trainer as ttr
from leclip_tpu_torch.engine.checkpoint import restore_train_state
from leclip_tpu_torch.engine.config import setup_config as tsetup

torch.set_num_threads(2)

CLASSES = list(COCO_OBJECT_CATEGORIES[:8])
OPTS = ["OPTIM.MAX_EPOCH", "1", "OPTIM.LR", "0.01", "OPTIM.WARMUP_EPOCH", "-1",
        "DATALOADER.BATCH_SIZE_TRAIN", "16", "TRAINER.N_CTX", "4", "OUTPUT_DIR", "",
        "TRAIN.PRINT_FREQ", "100", "TEST.multi_scale", "(2, 3)"]


@pytest.fixture(scope="module")
def test_split(tmp_path_factory):
    """400 test paths over 4 seeded JPEGs of different sizes: the val split
    (every 100th) is the 4 files in order."""
    d = tmp_path_factory.mktemp("val")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (40, 40), (70, 90)]):
        p = str(d / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(p, quality=90)
        paths.append(p)
    return [p for p in paths for _ in range(100)]


def _record(monkeypatch, cls):
    calls = []
    orig = cls.process

    def process(self, out, labels, out_local=None):
        calls.append(tuple(None if a is None else np.array(a, np.float32)
                           for a in (out, labels, out_local)))
        return orig(self, out, labels, out_local)

    monkeypatch.setattr(cls, "process", process)
    return calls


def _trainers(preset, opts, test_images, adapter=False):
    """JAX and port trainers on one JAX init; the port's prompt state is the
    JAX trainer's after 2 steps."""
    cfg = jclip.PRESETS[preset]
    toks, labs = captions(32)
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), cfg))
    jcls = jtr.CaptionDistillAdapterTrainer if adapter else jtr.CaptionDistillTrainer
    jtrainer = jcls(jsetup(opts=opts), jp, cfg,
                    dataset=JDataset(toks, labs, list(test_images), CLASSES))
    for batch in list(jtrainer.batcher.epoch(0))[:2]:
        jtrainer.state, _ = jtrainer.train_step(jtrainer.state, jnp.asarray(batch["img"]),
                                                jnp.asarray(batch["label"]))
    tcls = ttr.CaptionDistillAdapterTrainer if adapter else ttr.CaptionDistillTrainer
    kw = {"adapter": to_port(jtrainer.adapter)} if adapter else {}
    ttrainer = tcls(tsetup(opts=opts), to_port(jp), cfg,
                    dataset=TDataset(toks, labs, list(test_images), CLASSES), device="cpu", **kw)
    ttrainer.state = restore_train_state(ttrainer.state, {
        k: to_port(v) if isinstance(v, dict) else v for k, v in state_dict(jtrainer.state).items()})
    return jtrainer, ttrainer


def _compare(port_calls, ref_calls, port_res, ref_res):
    assert len(port_calls) == len(ref_calls) == 2  # 4 val images in batches of 2
    for got, want in zip(port_calls, ref_calls):
        for o, r in zip(got, want):
            assert (o is None) == (r is None)
            if r is not None:
                assert o.shape == r.shape and np.isfinite(o).all()
                np.testing.assert_allclose(o, r, rtol=0,
                                           atol=1e-4 * max(1.0, float(np.abs(r).max())))
    assert port_res == ref_res


@pytest.mark.parametrize("preset", ["RN-TEST", "ViT-TEST"])
def test_validate_scores_the_val_images_as_jax(monkeypatch, test_split, preset):
    jtrainer, ttrainer = _trainers(preset, OPTS, test_split)
    assert ttrainer.dataset.val_images == jtrainer.dataset.val_images and \
        len(ttrainer.dataset.val_images) == 4
    jcalls, tcalls = _record(monkeypatch, jev.MLClassificationEvaluator), \
        _record(monkeypatch, tev.MLClassificationEvaluator)
    ref = jtrainer.validate(batch_size=2)
    out = ttrainer.validate(batch_size=2)
    _compare(tcalls, jcalls, out, ref)
    assert tcalls[0][0].shape == (2, len(CLASSES)) and not tcalls[0][1].any()


def test_validate_takes_the_caption_probe_first(monkeypatch, test_split):
    opts = OPTS + ["TRAIN.probe_holdout", "4"]
    jtrainer, ttrainer = _trainers("RN-TEST", opts, test_split)
    jcalls, tcalls = _record(monkeypatch, jev.MLClassificationEvaluator), \
        _record(monkeypatch, tev.MLClassificationEvaluator)
    ref, out = jtrainer.validate(), ttrainer.validate()
    assert len(tcalls) == len(jcalls) == 1 and len(tcalls[0][0]) == 8  # the 8 held-out captions
    assert tcalls[0][1].any()  # real labels: the probe, not the val images
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-4, err_msg=k)


def test_adapter_trainer_validates_images_without_its_adapter(monkeypatch, test_split):
    """The JAX package's image validate strips ``_adapter`` and builds the
    spec without it (leclip_tpu/engine/trainer.py:570-574); the port matches
    its numbers, so the adapter trainer's scores equal those of a plain
    trainer with the same prompt state."""
    opts = OPTS + ["TRAINER.adapter_trainable", "True"]
    jtrainer, ttrainer = _trainers("RN-TEST", opts, test_split, adapter=True)
    assert "_adapter" in ttrainer.state.params
    jcalls, tcalls = _record(monkeypatch, jev.MLClassificationEvaluator), \
        _record(monkeypatch, tev.MLClassificationEvaluator)
    ref = jtrainer.validate(batch_size=2)
    out = ttrainer.validate(batch_size=2)
    _compare(tcalls, jcalls, out, ref)
    plain = ttr.CaptionDistillTrainer(ttrainer.cfg, ttrainer.clip_params, ttrainer.clip_cfg,
                                      dataset=ttrainer.dataset, device="cpu")
    plain.state = plain.state._replace(params={k: v for k, v in ttrainer.state.params.items()
                                               if k != "_adapter"})
    before = len(tcalls)
    plain.validate(batch_size=2)
    for got, want in zip(tcalls[before:], tcalls[:before]):
        for o, r in zip(got, want):
            np.testing.assert_array_equal(o, r)


def test_profiler_trace_window(tmp_path):
    """TRAIN.profile_dir: a bounded first-epoch window of steps is traced
    and written as a TensorBoard-loadable trace (Chrome trace JSON), the
    counterpart of tests/test_train.py::test_profiler_trace_window; a
    window that raises still closes the profiler."""
    toks, labs = captions(64)
    cfg = tsetup(opts=OPTS + ["TRAIN.profile_dir", str(tmp_path / "prof"),
                              "OUTPUT_DIR", str(tmp_path / "out")])
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), jclip.PRESETS["RN-TEST"]))
    tr = ttr.CaptionDistillTrainer(cfg, to_port(jp), jclip.PRESETS["RN-TEST"],
                                   dataset=TDataset(toks, labs, [], CLASSES), device="cpu")
    assert tr.batcher.steps_per_epoch() == 4  # the window: after steps 1 .. 3
    tr.train(resume=False)
    files = [p for p in (tmp_path / "prof").rglob("*") if p.is_file()]
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # the window turns the program's spans on: the trace names the step's parts
    names = {str(e.get("name", "")) for e in events}
    assert {"train.upload", "train.caption", "train.optimizer", "loader.caption_batch"} <= names
    assert tr._prof_cm is None

    # the NaN guard inside the window: the profiler is closed and written
    bad = ttr.CaptionDistillTrainer(
        tsetup(opts=OPTS + ["TRAIN.profile_dir", str(tmp_path / "prof2"),
                            "OUTPUT_DIR", str(tmp_path / "out2")]), to_port(jp),
        jclip.PRESETS["RN-TEST"], dataset=TDataset(toks, labs, [], CLASSES), device="cpu")
    step = bad.train_step
    calls = []

    def failing(state, captions_, labels):
        calls.append(1)
        new, m = step(state, captions_, labels)
        if len(calls) == 3:
            m = dict(m, loss=torch.tensor(float("nan")))
        return new, m

    bad.train_step = failing
    with pytest.raises(FloatingPointError):
        bad.train(resume=False)
    assert bad._prof_cm is None
    assert [p for p in (tmp_path / "prof2").rglob("*.pt.trace.json")]
    # ... so a later window in the process opens and writes its own trace
    from leclip_tpu_torch.utils.tracing import profiler_trace

    with profiler_trace(str(tmp_path / "prof3")):
        torch.ones(4).sum()
    assert [p for p in (tmp_path / "prof3").rglob("*.pt.trace.json")]
