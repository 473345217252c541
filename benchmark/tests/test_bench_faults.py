"""The comparison that decides ``correct`` fails a broken timed path: each
cell's run, with the look for a card skipped, driven on the CPU at a tiny
size with a fault planted in the program underneath, reads ``correct``
false. The faults are those each cell can have: an answer altered where it
is produced (every class of every image reversed, the last slot of every
batch answering with its classes rolled by one, every score scaled), a step that returns its state
unchanged and a step over half of its batch (training). And the control,
the reference one precision below the configuration's put in the program's
place, reads ``correct`` false as a run reads it."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from benchmark.reference.lowprec import CONTROLS
from benchmark.traffic import score, serve, train


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(harness, "device_info", lambda torch_, n: {
        "platform": "cpu", "kind": "cpu", "count": n, "memory_peak_bytes": 0})
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def alter_answers(monkeypatch, fault: str = "reversed"):
    """Every dispatched batch's scores come back altered: with the classes
    reversed, with the last slot's classes rolled by one place (a row of
    one slot answered wrong), or scaled by 1.25."""
    import torch as t
    from leclip_tpu_torch.inference.tta import TTAEngine

    alter = {"reversed": lambda out: out.flip(-1),
             "slot": lambda out: t.cat([out[:-1], out[-1:].roll(1, -1)]),
             "scaled": lambda out: out * 1.25}[fault]
    real = TTAEngine.dispatch_staged_fused
    monkeypatch.setattr(TTAEngine, "dispatch_staged_fused",
                        lambda self, staged: alter(real(self, staged)))


def control_in_place(monkeypatch):
    """The program's sampled answers replaced by the control's: the
    reference at the cell's control precision, on the same images."""
    real = score.compared

    def compared(ctx, st, images, got, control=None):
        low = score.reference_scores(ctx, st, images, CONTROLS[ctx.params["control"]])
        return real(ctx, st, images, low, control)
    monkeypatch.setattr(score, "compared", compared)


def wrap_step(monkeypatch, wrapper):
    from leclip_tpu_torch.engine import trainer

    real = trainer.make_train_step
    monkeypatch.setattr(trainer, "make_train_step",
                        lambda *a, **k: wrapper(real(*a, **k)))


def unchanged_state(step):
    def broken(state, captions, labels, mark=None):
        _, metrics = step(state, captions, labels, mark)
        return state, metrics
    return broken


def half_batch(step):
    def broken(state, captions, labels, mark=None):
        half = len(captions) // 2
        return step(state, captions[:half], labels[:half], mark)
    return broken


def train_ctx():
    cfg = tiny.tiny_config("rn50")
    params = tiny.load("workloads/rn50.train.json")
    params.update(corpus_rows=2048, n_ctx=8, window_check_step=4)
    params["recipe_config"]["DATALOADER"]["BATCH_SIZE_TRAIN"] = 64
    return tiny.context("rn50.train", cfg, params, seconds=1.0)


def serve_ctx():
    cfg = tiny.tiny_config("rn50")
    params = tiny.load("workloads/rn50.serve.json")
    params.update({"pool_images": 8, "batch_images": 4, "sample_images": 8, "rate": 4.0,
                   "sizes": [[128, 96, 3], [96, 128, 3], [112, 112, 2]]})
    return tiny.context("rn50.serve", cfg, params, seconds=2.0)


def outcome(ctx, driver):
    out = driver.run(ctx)
    return harness.result_line(ctx.bench, ctx.cell, out, False)


def score_ctx(cell, monkeypatch):
    name = cell.split(".")[0]
    ctx = tiny.context(cell, tiny.tiny_config(name), tiny.tiny_score_params(cell))
    if name == "vitb16":
        # TEST.PREC auto is int8 on the card and bf16 on the CPU, where the
        # program's ViT engine fails on float32 weights (models/vit.py, a
        # bf16 projection of float32 tokens); its fp32 engine stands in
        from benchmark import program

        build = program.build_engine
        monkeypatch.setattr(program, "build_engine",
                            lambda *a, **k: build(*a, **{**k, "prec": "fp32"}))
    return ctx


@pytest.mark.parametrize("fault", ["reversed", "slot", "scaled"])
@pytest.mark.parametrize("cell", ["rn50.score", "vitb16.score"])
def test_bench_score_cell_fails_an_altered_answer(cell, fault, monkeypatch):
    ctx = score_ctx(cell, monkeypatch)
    alter_answers(monkeypatch, fault)
    result = outcome(ctx, score)
    assert result["correct"] is False
    gap = result["compared"]["score_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("cell", ["rn50.score", "vitb16.score"])
def test_bench_score_cell_fails_its_control(cell, monkeypatch):
    ctx = score_ctx(cell, monkeypatch)
    control_in_place(monkeypatch)
    result = outcome(ctx, score)
    assert result["correct"] is False, result["compared"]


def test_bench_score_cell_passes_sound_answers(monkeypatch):
    result = outcome(score_ctx("rn50.score", monkeypatch), score)
    assert result["correct"] is True, result["compared"]


@pytest.mark.parametrize("fault", ["reversed", "scaled"])
def test_bench_serve_cell_fails_an_altered_answer(fault, monkeypatch):
    alter_answers(monkeypatch, fault)
    result = outcome(serve_ctx(), serve)
    assert result["correct"] is False


def test_bench_train_cell_passes_sound_steps():
    result = outcome(train_ctx(), train)
    assert result["correct"] is True, result["compared"]
    assert result["metrics"]["train_captions_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_bench_train_cell_fails_a_broken_step(fault, monkeypatch):
    wrap_step(monkeypatch, fault)
    result = outcome(train_ctx(), train)
    assert result["correct"] is False, result["compared"]


def test_bench_train_cell_fails_its_control(monkeypatch):
    """The program's three recorded steps replaced by the reference's under
    TF32 operands, from the same starts."""
    def control_numbers(ctx, st):
        momentum = ctx.params["recipe"]["sgd_momentum"]
        got = {key: train.got_of(st[key], momentum) for key in train.RECORDS.values()}
        for key in got:
            rec = st[key]
            alt = train.reference_run(ctx, st, rec, num=CONTROLS[ctx.params["control"]])
            got[key] = train.ref_as_got(alt, rec.start)
        for key in ("step", "state", "feed"):
            st.pop(key, None)
        return got
    monkeypatch.setattr(train, "free_program", control_numbers)
    result = outcome(train_ctx(), train)
    assert result["correct"] is False, result["compared"]
