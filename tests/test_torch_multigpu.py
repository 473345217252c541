"""The port's data-parallel trainer, fine-tuner and mesh engine across real
OS processes over gloo on the CPU (tests/_torch_dist_worker.py: one process
a rank, as torchrun starts one a card), against the JAX package's
single-process runs on the same inputs (tests/test_multihost.py, its
workers, tests/test_parallel.py:192):

* trainer, world 2 (RN-TEST, 16 captions a rank): one step equals JAX's
  single-process step over the concatenated global batch (rtol 1e-5, atol
  1e-6, JAX's own bound in tests/test_multihost.py); both ranks hold bitwise
  the same parameters after train(); only rank 0 writes checkpoints; depth-2
  prefetch ends on bitwise the parameters of the inline loop; a fresh world-2
  trainer resumes from the shared directory and continues the numbering;
* fine-tuner, world 2 (ViT-TEST, 4 pairs a rank): the gradient of the global
  batch's loss equals the port's world-1 gradient over the global batch and
  JAX's, each leaf within 1e-4 of its largest element; the loss within 1e-5
  relative; one Adam step's parameter change, leaf by leaf, within 1e-3 of
  world 1's change in norm (qkv_bias aside: the exact gradient of its key
  third is 0, so Adam turns each side's rounding into a step; an element
  whose gradient is near Adam's eps, 1e-8, steps by lr·g/eps, so elements
  are held in norm, as chip_smoke.py holds the card's step); the augmented
  step's loss (each rank takes its rows of the global batch's draws) within
  1e-5 of world 1's;
* engine, world 2 and 4 (ViT-TEST, shard_bank=True, 37-row bank): the ranks
  bitwise equal; the fused scores within 1e-4 of JAX's mesh engine
  (tests/_multihost_infer_worker.build_engine) on a mesh of the same size
  and of the port's one-process engine; the partial batch of 5 equals the
  full batch's first 5 rows; the pipelined and staged fetches equal the
  one-shot calls; the dump path and its multi-dispatch check equal the
  one-process engine's within 1e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _multihost_infer_worker import CLASSNAMES, build_engine as jax_build_engine, make_images
from _multihost_worker import synth
from _torch_dist_worker import build_engine, run_ranks
from leclip_tpu.engine import finetune as jft
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import prompt as jprompt
from leclip_tpu.parallel.mesh import data_mesh as jax_data_mesh
from leclip_tpu_torch.engine.finetune import CLIPFineTuner
from leclip_tpu_torch.models.convert import from_jax_params, to_jax_params

torch.set_num_threads(2)

TRAIN_OPTS = ["OPTIM.MAX_EPOCH", "2", "OPTIM.LR", "0.05", "OPTIM.WARMUP_EPOCH", "-1",
              "TRAINER.N_CTX", "4", "TRAIN.PRINT_FREQ", "1000"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(a, b, what):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys(), what
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{what}{k}")


# ---------------------------------- trainer -----------------------------------


@pytest.fixture(scope="module")
def train_world2(tmp_path_factory):
    """JAX's trainer at the global batch (32) and the port's world-2 run
    started from its state."""
    from leclip_tpu.data.datasets import CaptionDataset
    from leclip_tpu.engine.config import setup_config
    from leclip_tpu.engine.trainer import CaptionDistillTrainer

    d = tmp_path_factory.mktemp("train_world2")
    tiny = jclip.PRESETS["RN-TEST"]
    clip_params = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), tiny))
    tokens, labels = synth(64, seed=0, classnames=CLASSNAMES)
    cfg = setup_config(opts=TRAIN_OPTS + ["DATALOADER.BATCH_SIZE_TRAIN", "32",
                                          "TRAIN.CHECKPOINT_FREQ", "-1"], SEED=3)
    jtr = CaptionDistillTrainer(cfg, clip_params, tiny,
                                dataset=CaptionDataset(tokens, labels, [], CLASSNAMES))
    state0 = jax.tree.map(lambda x: x.copy() if hasattr(x, "copy") else x, jtr.state)
    res = run_ranks("train", 2, d, dict(
        dir=str(d), clip_params=clip_params, tokens=tokens, labels=labels,
        classnames=CLASSNAMES, opts=TRAIN_OPTS + ["DATALOADER.BATCH_SIZE_TRAIN", "16"],
        state=jax.device_get(serialization.to_state_dict(state0))))
    return d, jtr, res


def test_trainer_world2_step_equals_jax_global_batch_step(train_world2):
    """The all-reduced step of two ranks of 16 captions equals JAX's
    single-process step over their 32 (rank 0's rows, then rank 1's)."""
    _, jtr, res = train_world2
    assert [r["num_shards"] for r in res] == [(0, 2), (1, 2)]
    global_batch = {k: np.concatenate([r["local_batch"][k] for r in res])
                    for k in res[0]["local_batch"]}
    state1, aux = jtr.train_step(jtr.state, jnp.asarray(global_batch["img"]),
                                 jnp.asarray(global_batch["label"]))
    want = dict(_flat(jax.device_get(state1.params)))
    for r in res:
        got = dict(_flat(r["params_step1"]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r["loss_step1"], float(aux["loss"]), rtol=1e-5)
    assert res[0]["loss_step1"] == res[1]["loss_step1"]


def test_trainer_world2_ranks_agree_and_only_rank0_writes(train_world2):
    d, _, res = train_world2
    for key in ("params_step1", "params_final"):
        _assert_trees_equal(res[0][key], res[1][key], key)
    moved = any(not np.array_equal(a, b) for (_, a), (_, b) in
                zip(_flat(res[0]["params_step1"]), _flat(res[0]["params_final"])))
    assert moved

    def ckpts(sub):
        return [f for _, _, fs in os.walk(d / sub) for f in fs if "model" in f]

    assert sorted(ckpts("proc0")) == ["model.ckpt-0", "model.ckpt-1"]
    assert ckpts("proc1") == []
    assert (d / "proc0" / "metrics.jsonl").exists() and not (d / "proc1").exists()


def test_trainer_world2_prefetch_equals_inline(train_world2):
    """TRAIN.prefetch_batches 2 ends on bitwise the inline loop's params."""
    _, _, res = train_world2
    for r in res:
        _assert_trees_equal(r["params_prefetch"], r["params_final"], "prefetch ")


def test_trainer_world2_resumes_from_shared_checkpoint(train_world2):
    """A fresh world-2 trainer resumes from the rank-0 checkpoint of a
    shared directory on both ranks, continues the numbering (ckpt-2,
    ckpt-3) and ends on the final checkpoint's params."""
    from leclip_tpu_torch.engine.checkpoint import load_checkpoint

    d, _, res = train_world2
    assert [r["phase1_ckpt"] for r in res] == ["model.ckpt-1"] * 2
    for key in ("resumed_params", "final_params"):
        _assert_trees_equal(res[0][key], res[1][key], key)
    pl = d / "shared_out" / "prompt_learner"
    assert {"model.ckpt-2", "model.ckpt-3"} <= set(os.listdir(pl))
    ck1 = load_checkpoint(str(pl / "model.ckpt-1"))["params"]
    _assert_trees_equal(res[0]["resumed_params"], ck1, "resumed ")
    ck3 = load_checkpoint(str(pl / "model.ckpt-3"))["params"]
    _assert_trees_equal(res[0]["final_params"], ck3, "final ")
    assert any(not np.array_equal(a, b) for (_, a), (_, b) in
               zip(_flat(res[0]["resumed_params"]), _flat(res[0]["final_params"])))


# --------------------------------- fine-tuner ---------------------------------

FT_BATCH = 8  # global: 4 pairs a rank


def _ft_tokens(n, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, 77), np.int32)
    for i, length in enumerate(rng.integers(3, 12, n)):
        toks[i, 0] = 49406
        toks[i, 1:1 + length] = rng.integers(1, 4000, length)
        toks[i, 1 + length] = 49407
    return toks


@pytest.fixture(scope="module")
def finetune_world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("finetune_world2")
    vit = jclip.PRESETS["ViT-TEST"]
    params = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), vit))
    rng = np.random.default_rng(1)
    images = rng.standard_normal((FT_BATCH, 64, 64, 3)).astype(np.float32)
    tokens = _ft_tokens(FT_BATCH, 2)
    raw = {"image_u8": rng.integers(0, 255, (FT_BATCH, 80, 96, 3)).astype(np.uint8),
           "content": np.asarray([(80 - 4 * i, 96 - 2 * i) for i in range(FT_BATCH)], np.int32),
           "tokens": _ft_tokens(FT_BATCH, 3)}
    res = run_ranks("finetune", 2, d, dict(params=params, images=images, tokens=tokens, raw=raw))

    # the port's world 1 over the global batch, in this process
    one = CLIPFineTuner(from_jax_params(params, "cpu"), vit, lr=1e-3, warmup_steps=0,
                        total_steps=10, device="cpu")
    p0 = to_jax_params(one.state.params)
    loss, _, grads = one._loss_and_grads(one.state.params, torch.tensor(images),
                                         torch.tensor(tokens))
    state, m = one.train_step(one.state, images, tokens)
    _, m_raw = one.raw_train_step(state, 7, raw["image_u8"], raw["content"], raw["tokens"])
    world1 = dict(loss=float(loss), grads=to_jax_params(grads), params=to_jax_params(state.params),
                  step={k: float(v) for k, v in m.items()},
                  raw_step={k: float(v) for k, v in m_raw.items()})
    # JAX's loss and gradient over the same global batch
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jft.clip_contrastive_loss(p, vit, jnp.asarray(images), jnp.asarray(tokens)),
        has_aux=True)(params)
    return res, world1, p0, dict(loss=float(jloss), grads=jax.device_get(jgrads))


def _assert_grads(got, want, tol=1e-4):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k in want:
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= tol * scale, k


@pytest.mark.parametrize("ref", ["port_world1", "jax"])
def test_finetune_world2_gradient_equals_global_batch(finetune_world2, ref):
    res, world1, _, jax_ref = finetune_world2
    want = world1 if ref == "port_world1" else jax_ref
    for r in res:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        _assert_grads(r["grads"], want["grads"])
    _assert_trees_equal(res[0]["grads"], res[1]["grads"], "grads ")


def test_finetune_world2_step_equals_world1_step(finetune_world2):
    """One Adam step of world 2 against world 1, then the augmented step:
    each rank takes its own rows of the global batch's draws."""
    res, world1, p0, _ = finetune_world2
    want, p0 = dict(_flat(world1["params"])), dict(_flat(p0))
    for r in res:
        got = dict(_flat(r["params"]))
        for k in want:
            change = np.linalg.norm(want[k] - p0[k])
            if k.endswith("qkv_bias"):
                continue  # its key third: gradient 0, so Adam steps on rounding
            assert change > 0, k
            assert np.linalg.norm(got[k] - want[k]) <= 1e-3 * change, k
        for part in ("step", "raw_step"):
            np.testing.assert_allclose(r[part]["loss"], world1[part]["loss"], rtol=1e-5,
                                       err_msg=part)
            np.testing.assert_allclose(r[part]["grad_norm"], world1[part]["grad_norm"],
                                       rtol=1e-4, err_msg=part)
        assert r["raw_step"] == res[0]["raw_step"]
    _assert_trees_equal(res[0]["params"], res[1]["params"], "params ")


# ----------------------------------- engine -----------------------------------


@pytest.fixture(scope="module")
def engine_inputs():
    """JAX's ViT-TEST params, the two members' prompts and the 37-row bank
    of tests/_multihost_infer_worker.build_engine, as numpy."""
    cfg = jclip.PRESETS["ViT-TEST"]
    params = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), cfg))
    trainables = [jax.device_get(jprompt.build_prompt_learner(
        jax.random.PRNGKey(1 + i), params, CLASSNAMES, n_ctx=4)[0]) for i in range(2)]
    rng = np.random.default_rng(7)
    bank = rng.normal(size=(37, cfg.embed_dim)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    inputs = dict(params=params, trainables=trainables, bank=bank, classnames=CLASSNAMES,
                  uniform=make_images(uniform=True), mixed=make_images(uniform=False))
    one = build_engine(inputs, None, shard_bank=False)
    ref = {"uniform": one.run_batch_fused(inputs["uniform"]),
           "mixed": one.run_batch_fused(inputs["mixed"]),
           "dump": one.run_batch(inputs["mixed"][:5])}
    return inputs, ref


def _assert_dumps(got, want, tol):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in want[name]:
            assert got[name][k].shape == want[name][k].shape, (name, k)
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=tol, atol=tol,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("world", [2, 4])
def test_engine_sharded_bank_matches_jax_mesh_engine(world, tmp_path, engine_inputs):
    inputs, ref = engine_inputs
    res = run_ranks("engine", world, tmp_path, inputs)
    # the bank really is row-sharded: 37 rows zero-padded to a multiple
    assert [r["bank_shard_rows"] for r in res] == [-(-37 // world)] * world
    for r in res[1:]:
        for key in ("uniform", "mixed", "partial"):
            np.testing.assert_array_equal(r[key], res[0][key])
        for a, b in zip(r["piped"] + r["staged"], res[0]["piped"] + res[0]["staged"]):
            np.testing.assert_array_equal(a, b)
        _assert_dumps(r["dump"], res[0]["dump"], 0)
    out = res[0]
    assert out["partial"].shape == (5, len(CLASSNAMES))
    np.testing.assert_allclose(out["partial"], out["uniform"][:5], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out["piped"][0], out["uniform"])
    np.testing.assert_array_equal(out["piped"][1], out["mixed"])
    np.testing.assert_array_equal(out["staged"][0], out["mixed"])
    np.testing.assert_array_equal(out["staged"][1], out["partial"])

    jengine = jax_build_engine(mesh=jax_data_mesh(jax.devices()[:world]), shard_bank=True)
    for key, uniform in (("uniform", True), ("mixed", False)):
        want = np.asarray(jengine.run_batch_fused(make_images(uniform=uniform)))
        np.testing.assert_allclose(out[key], want, rtol=1e-4, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=1e-4, err_msg=key)
    _assert_dumps(out["dump"], ref["dump"], 1e-4)
    _assert_dumps(out["multidispatch"], ref["dump"], 1e-4)


def test_engine_refuses_shard_bank_without_mesh_or_bank(engine_inputs):
    from leclip_tpu_torch.parallel.mesh import local_mesh

    inputs, _ = engine_inputs
    with pytest.raises(ValueError, match="needs both a mesh and a caption_bank"):
        build_engine(inputs, None, shard_bank=True)
    with pytest.raises(ValueError, match="needs both a mesh and a caption_bank"):
        build_engine(dict(inputs, bank=None), local_mesh("cpu"), shard_bank=True)


def test_make_engine_auto_mesh_is_none_without_a_group(engine_inputs):
    """make_engine(mesh="auto") builds the one-process engine where no
    process group holds more than one rank; an explicit one-rank mesh with
    shard_bank scores as it does (the ring of one shard)."""
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.inference.pipeline import make_engine
    from leclip_tpu_torch.parallel.mesh import local_mesh

    inputs, ref = engine_inputs
    one = build_engine(inputs, None, shard_bank=False)
    cfg = setup_config(opts=["TEST.multi_scale", "(2,)", "TEST.retrieval_topk", "5",
                             "TEST.PREC", "fp32"])
    auto = make_engine(cfg, one.clip_params, one.clip_cfg, one.models,
                       caption_bank=inputs["bank"], device="cpu")
    assert auto.mesh is None and not auto.shard_bank
    np.testing.assert_allclose(auto.run_batch_fused(inputs["uniform"]), ref["uniform"],
                               rtol=1e-5, atol=1e-5)
    meshed = make_engine(cfg, one.clip_params, one.clip_cfg, one.models,
                         caption_bank=inputs["bank"], mesh=local_mesh("cpu"), shard_bank=True)
    assert meshed.mesh is not None and meshed.shard_bank
    np.testing.assert_allclose(meshed.run_batch_fused(inputs["mixed"]), ref["mixed"],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="mesh must be"):
        make_engine(cfg, one.clip_params, one.clip_cfg, one.models, device="cpu", mesh="all")
