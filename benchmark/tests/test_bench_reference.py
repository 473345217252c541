"""The benchmark's plain reference held against leclip_tpu_torch's CPU path at
tiny sizes, for each cell's entry: an image's fused scores (RN and ViT, the
program's fp32 engine, whose numbers the reference must give), a training
step's loss, gradient and parameters, and the pieces (crop boxes, resize
weights, tokenizer) one by one. The test files import both; the reference
itself imports nothing of the program (test_bench_imports.py)."""

import tempfile

import numpy as np
import pytest
import torch

from benchmark import harness, program, weights
from benchmark.reference import score_ref
from benchmark.reference.lowprec import CONTROLS, tf32_round
from benchmark.reference.tokenizer import tokenize as ref_tokenize
from benchmark.tests import tiny
from benchmark.traffic import score, train

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_bench_crop_boxes_are_the_engines():
    from leclip_tpu_torch.ops.crops import tta_sampling_boxes

    for h, w in ((480, 640), (427, 640), (640, 640), (97, 131)):
        pyramid, _ = tta_sampling_boxes(h, w, (2, 3, 4))
        ours = score_ref.crop_boxes(h, w, (2, 3, 4))
        assert ours.shape == (1 + len(pyramid), 4)
        np.testing.assert_array_equal(ours[1:], pyramid)
        s = min(h, w)
        np.testing.assert_allclose(ours[0], [(h - s) / 2, (w - s) / 2, (h + s) / 2, (w + s) / 2])


def test_bench_resize_weights_are_the_engines():
    from leclip_tpu_torch.ops.resize_matmul import axis_resize_matrix

    lo = torch.tensor([0.0, 13.5, -7.0, 100.0])
    hi = torch.tensor([480.0, 213.5, 173.0, 160.0])
    ours = score_ref.axis_weights(lo, hi, 480, 224)
    theirs = axis_resize_matrix(lo, hi, 480, 480, 224, True)
    torch.testing.assert_close(ours, theirs, rtol=0, atol=2e-6)


def test_bench_tokenizer_is_clips():
    from leclip_tpu_torch.data.tokenizer import tokenize

    texts = ["X X X X person.", "a dog and a cat on a sofa", "X " * 80, "dining table."]
    np.testing.assert_array_equal(ref_tokenize(texts), tokenize(texts))


def test_bench_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-8, 65504.0])
    y = tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0                       # a tie goes to even
    assert y[2] == 1.0 + 2 ** -9                             # and up from odd
    assert (y.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("name", ["rn50", "vitb16"])
def test_bench_score_reference_matches_the_fp32_engine(name):
    """The program's fp32 engine and the reference give an image the same
    fused scores (both float32; only the order of sums differs)."""
    from leclip_tpu_torch.data.loader import ImageBatcher

    cfg = tiny.tiny_config(name)
    ctx = tiny.context(f"{name}.score", cfg, tiny.tiny_score_params(f"{name}.score"))
    inp = score.make_inputs(ctx, 11, CPU)
    with tempfile.TemporaryDirectory() as tmp:
        paths = weights.write_pool(inp["blobs"], tmp)
        engine = program.build_engine(cfg, inp["weights"], inp["members"], inp["bank"], CPU,
                                      prec="fp32")
        batcher = ImageBatcher(paths, 4, sort_by_bucket=True)
        got = np.concatenate(list(engine.run_batches_fused(im for im, _ in batcher)))
        got = got[batcher.inverse_order]
        ref = score.reference_scores(ctx, inp, [score.decode(p) for p in paths])
    assert score.score_gap(got, ref) < 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_bench_train_reference_matches_the_trainer_step():
    """Three of the trainer's fp32 steps and three of the reference's, from
    the seed's start and from a state of the window: the losses, the first
    gradient's norm as SGD took it and the parameters' change, each within
    1e-4 (the teacher's x10000 KL term turns fp32 rounding into ~1e-5 of
    the loss)."""
    cfg = tiny.tiny_config("rn50")
    params = tiny.load("workloads/rn50.train.json")
    params.update(corpus_rows=2048, n_ctx=8, setup_steps=3, window_check_step=4)
    params["recipe_config"]["DATALOADER"]["BATCH_SIZE_TRAIN"] = 64
    ctx = tiny.context("rn50.train", cfg, params)
    st = train.setup(ctx, 2 ** 31 + 17)
    train.window(ctx, st, 0.0, False)
    got = train.free_program(ctx, st)
    for key in ("setup", "window"):
        rec = st[key]
        ref = train.reference_run(ctx, st, rec)
        nums = train.compare(rec.start, got[key], ref)
        assert train.moved_leaves(ref) == ["ctx", "ctx_double"]
        assert max(nums.values()) < 1e-4, (key, nums)
        # and the changes themselves, not only their norms
        for k in ("ctx", "ctx_double"):
            mine = got[key]["params3"][k] - rec.start["params"][k]
            theirs = ref.params[k] - rec.start["params"][k]
            assert float((mine - theirs).norm() / theirs.norm()) < 1e-3, (key, k)


def test_bench_controls_read_above_the_program():
    """At a tiny size too, the lower-precision controls move the compared
    numbers well past the program's: the training step under TF32 operands
    and the scores under fp8 (the RN cell's) and int4 (the ViT cell's)."""
    cfg = tiny.tiny_config("rn50")
    params = tiny.load("workloads/rn50.train.json")
    params.update(corpus_rows=2048, n_ctx=8, setup_steps=3, window_check_step=4)
    params["recipe_config"]["DATALOADER"]["BATCH_SIZE_TRAIN"] = 64
    ctx = tiny.context("rn50.train", cfg, params)
    rows = train.readings(ctx, [2 ** 31 + 23], 0.0)
    prog, ctrl = rows[0]["program"], rows[0]["control"]
    assert max(c["value"] for c in ctrl.values()) > 10 * max(
        c["value"] for c in prog.values()), rows
    assert rows[0]["control_correct"] is False and all(c["ok"] for c in prog.values()), rows
    for name, control in (("rn50", "fp8"), ("vitb16", "int4")):
        cfg = tiny.tiny_config(name)
        ctx = tiny.context(f"{name}.score", cfg, tiny.tiny_score_params(f"{name}.score"))
        inp = score.make_inputs(ctx, 29, CPU)
        with tempfile.TemporaryDirectory() as tmp:
            images = [score.decode(p) for p in weights.write_pool(inp["blobs"], tmp)[:3]]
            ref = score.reference_scores(ctx, inp, images)
            low = score.reference_scores(ctx, inp, images, CONTROLS[control])
        assert score.score_gap(low, ref) > 1e-3, (name, control)


def test_bench_sub_seeds_are_stable_and_distinct():
    big = 2 ** 31 + 12345
    assert harness.sub_seed(big, "weights") == harness.sub_seed(big, "weights")
    assert harness.sub_seed(big, "weights") != harness.sub_seed(big, "bank")
    assert harness.sub_seed(big, "weights") != harness.sub_seed(big + 1, "weights")
    assert 0 <= harness.sub_seed(2 ** 40, "x") < 2 ** 63
