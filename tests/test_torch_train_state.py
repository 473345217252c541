"""The port's optimizer and LR schedule (leclip_tpu_torch/engine/train_state.py)
against leclip_tpu/engine/train_state.py.

* ``epoch_lr_schedule`` at every step of every schedule the JAX function
  implements (cosine, single_step, multi_step, constant) under each warmup
  (none, constant, linear, with and without WARMUP_RECOUNT): equal to the
  bit, since both compute in float32 in the same order.
* ``build_optimizer("sgd")`` over 5 steps of seeded gradients (plain,
  weight decay, dampening, Nesterov, both): params and momentum within 1e-6
  of max(1, max|leaf|) of the optax chain's (the same fp32 operations; XLA
  contracts some of them into FMAs, an ulp apart), and
  the state tree (keys, shapes, dtypes) equal to flax's state dict of the
  optax state, so a checkpoint's ``opt_state`` maps leaf for leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from leclip_tpu.engine import train_state as J
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu_torch.engine import train_state as T
from leclip_tpu_torch.engine.config import setup_config as tsetup

torch.set_num_threads(2)

SCHEDS = {
    "cosine": [],
    "single_step": ["OPTIM.STEPSIZE", "(3,)", "OPTIM.GAMMA", "0.5"],
    "single_step_default": ["OPTIM.GAMMA", "0.3"],
    "multi_step": ["OPTIM.STEPSIZE", "(2, 5, 9)", "OPTIM.GAMMA", "0.1"],
    "constant": ["OPTIM.SCHED", "constant"],
}
WARMUPS = {
    "none": ["OPTIM.WARMUP_EPOCH", "-1"],
    "constant": ["OPTIM.WARMUP_EPOCH", "3", "OPTIM.WARMUP_TYPE", "constant",
                 "OPTIM.WARMUP_CONS_LR", "1e-3"],
    "linear": ["OPTIM.WARMUP_EPOCH", "4", "OPTIM.WARMUP_TYPE", "linear",
               "OPTIM.WARMUP_MIN_LR", "2e-5"],
    "constant_norecount": ["OPTIM.WARMUP_EPOCH", "3", "OPTIM.WARMUP_TYPE", "constant",
                           "OPTIM.WARMUP_RECOUNT", "False"],
    "linear_norecount": ["OPTIM.WARMUP_EPOCH", "6", "OPTIM.WARMUP_TYPE", "linear",
                         "OPTIM.WARMUP_RECOUNT", "False"],
}


def _opts(sched, warm, max_epoch=13):
    s = SCHEDS[sched]
    if sched != "constant":
        s = ["OPTIM.SCHED", sched.replace("_default", "")] + s
    return ["OPTIM.LR", "0.037", "OPTIM.MAX_EPOCH", str(max_epoch)] + s + WARMUPS[warm]


@pytest.mark.parametrize("warm", list(WARMUPS))
@pytest.mark.parametrize("sched", list(SCHEDS))
def test_lr_schedule_equals_jax_at_every_step(sched, warm):
    opts = _opts(sched, warm)
    jlr = jax.jit(J.epoch_lr_schedule(jsetup(opts=opts).OPTIM, 3))
    tlr = T.epoch_lr_schedule(tsetup(opts=opts).OPTIM, 3)
    steps = np.arange(3 * 16)
    ref = np.asarray(jax.vmap(jlr)(jnp.asarray(steps, jnp.int32)), np.float32)
    got = np.asarray([tlr(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, ref)
    assert len(set(got.tolist())) > (1 if sched != "constant" or warm != "none" else 0)


def test_lr_schedule_cosine_at_recipe_lengths():
    """The cosine's float32 cos is the C library's cosf, as XLA's on the CPU:
    equal over MAX_EPOCH 5..200 at one step an epoch."""
    for max_epoch in (5, 15, 20, 100, 200):
        for warm in ("none", "constant", "constant_norecount"):
            opts = _opts("cosine", warm, max_epoch)
            jlr = J.epoch_lr_schedule(jsetup(opts=opts).OPTIM, 1)
            tlr = T.epoch_lr_schedule(tsetup(opts=opts).OPTIM, 1)
            steps = jnp.arange(max_epoch + 2, dtype=jnp.int32)
            ref = np.asarray(jax.jit(jax.vmap(jlr))(steps), np.float32)
            got = np.asarray([tlr(s) for s in range(max_epoch + 2)], np.float32)
            np.testing.assert_array_equal(got, ref, err_msg=f"{max_epoch} {warm}")


SGD = {
    "plain": ["OPTIM.WEIGHT_DECAY", "0.0"],
    "weight_decay": [],
    "dampening": ["OPTIM.SGD_DAMPNING", "0.3"],
    "nesterov": ["OPTIM.SGD_NESTEROV", "True"],
    "dampening_nesterov": ["OPTIM.SGD_DAMPNING", "0.3", "OPTIM.SGD_NESTEROV", "True"],
}


def _params(rng):
    return {"ctx": rng.standard_normal((4, 8)).astype(np.float32),
            "ctx_double": rng.standard_normal((3, 4, 8)).astype(np.float32),
            "temperature": np.float32(3.0)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("name", list(SGD))
def test_sgd_matches_the_optax_chain_for_5_steps(name):
    opts = ["OPTIM.LR", "0.05", "OPTIM.MAX_EPOCH", "4", "OPTIM.WARMUP_EPOCH", "1",
            "OPTIM.WARMUP_TYPE", "constant", "OPTIM.WARMUP_CONS_LR", "0.01"] + SGD[name]
    jopt = J.build_optimizer(jsetup(opts=opts).OPTIM, 2)
    topt = T.build_optimizer(tsetup(opts=opts).OPTIM, 2)
    rng = np.random.default_rng(len(name))
    p0 = _params(rng)
    jstate = J.create_train_state(jax.tree.map(jnp.asarray, p0), jopt)
    tstate = T.create_train_state({k: torch.tensor(v) for k, v in p0.items()}, topt)
    jp, jos = jstate.params, jstate.opt_state
    tp, tos = tstate.params, tstate.opt_state

    def tree_equal(port, ref, atol):
        a, b = _flat(port), _flat(jax.device_get(serialization.to_state_dict(ref)))
        assert set(a) == set(b)
        for k in b:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            tol = atol * max(1.0, float(np.abs(b[k]).max(initial=0.0)))
            np.testing.assert_allclose(a[k], b[k], atol=tol, rtol=0, err_msg=k)

    tree_equal(tos, jos, 0)
    jupdate = jax.jit(jopt.update)
    for step in range(5):
        g = {k: (rng.standard_normal(np.shape(v)) * 3).astype(np.float32) for k, v in p0.items()}
        upd, jos = jupdate(jax.tree.map(jnp.asarray, g), jos, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        tp, tos = topt.update({k: torch.tensor(v) for k, v in g.items()}, tos, tp)
        tree_equal(tp, jp, 1e-6)
        tree_equal(tos, jos, 1e-6)
    assert int(tos["2"]["count"]) == 5
