"""The port's optimizer menu (leclip_tpu_torch/engine/train_state.py
``build_optimizer``: adam, amsgrad, adamw, rmsprop, radam) against
leclip_tpu/engine/train_state.py's optax chains.

* Each optimizer over 5 steps of seeded gradients with weight decay and a
  constant warmup epoch (and once more on a prompt tree that holds the
  adapter trainer's nested ``_adapter`` subtree, without weight decay):
  params and every leaf of ``opt_state`` within 1e-6 of max(1, max|leaf|)
  of the optax chain's (the same fp32 operations; XLA contracts some of
  them into FMAs and computes ``decay ** count`` with its own ``pow``, an
  ulp apart), and the state tree (keys, shapes, dtypes) equal to flax's
  state dict of the optax state, so a checkpoint's ``opt_state`` maps leaf
  for leaf.
* An adam checkpoint resumed across the packages both ways, bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port import to_port
from test_torch_train_state import _flat
from leclip_tpu.engine import checkpoint as jck
from leclip_tpu.engine import train_state as J
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu_torch.engine import checkpoint as tck
from leclip_tpu_torch.engine import train_state as T
from leclip_tpu_torch.engine.config import setup_config as tsetup

torch.set_num_threads(2)

NAMES = ("adam", "amsgrad", "adamw", "rmsprop", "radam")
BASE = ["OPTIM.LR", "0.05", "OPTIM.MAX_EPOCH", "4", "OPTIM.WARMUP_EPOCH", "1",
        "OPTIM.WARMUP_TYPE", "constant", "OPTIM.WARMUP_CONS_LR", "0.01",
        "OPTIM.WEIGHT_DECAY", "0.01"]


def _params(rng, adapter=False):
    p = {"ctx": rng.standard_normal((4, 8)).astype(np.float32),
         "ctx_double": rng.standard_normal((3, 4, 8)).astype(np.float32),
         "temperature": np.float32(3.0)}
    if adapter:
        p["_adapter"] = {"down_kernel": rng.standard_normal((8, 2)).astype(np.float32),
                         "up_kernel": rng.standard_normal((2, 8)).astype(np.float32)}
    return p


def _tmap(fn, tree):
    return {k: _tmap(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _tree_close(port, ref, atol):
    a, b = _flat(port), _flat(jax.device_get(serialization.to_state_dict(ref)))
    assert set(a) == set(b), set(a) ^ set(b)
    for k in b:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        tol = atol * max(1.0, float(np.abs(b[k]).max(initial=0.0)))
        np.testing.assert_allclose(a[k], b[k], atol=tol, rtol=0, err_msg=k)


def _run_both(name, opts, adapter, steps=5):
    """``steps`` updates of both packages' optimizer from the same params on
    the same seeded gradients, held together after each."""
    opts = opts + ["OPTIM.NAME", name]
    jopt = J.build_optimizer(jsetup(opts=opts).OPTIM, 2)
    topt = T.build_optimizer(tsetup(opts=opts).OPTIM, 2)
    rng = np.random.default_rng(len(name) + 10 * adapter)
    p0 = _params(rng, adapter)
    jstate = J.create_train_state(jax.tree.map(jnp.asarray, p0), jopt)
    tstate = T.create_train_state(_tmap(torch.tensor, p0), topt)
    jp, jos = jstate.params, jstate.opt_state
    tp, tos = tstate.params, tstate.opt_state
    _tree_close(tos, jos, 0)
    jupdate = jax.jit(jopt.update)
    for _ in range(steps):
        g = _tmap(lambda v: (rng.standard_normal(np.shape(v)) * 3).astype(np.float32), p0)
        upd, jos = jupdate(jax.tree.map(jnp.asarray, g), jos, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        tp, tos = topt.update(_tmap(torch.tensor, g), tos, tp)
        _tree_close(tp, jp, 1e-6)
        _tree_close(tos, jos, 1e-6)
    return tp, tos, jp


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_the_optax_chain_for_5_steps(name):
    tp, tos, _ = _run_both(name, BASE, adapter=False)
    assert int(tos[str(len(tos) - 1)]["count"]) == 5
    assert not torch.equal(tp["ctx"], torch.tensor(_params(np.random.default_rng(len(name)))
                                                   ["ctx"]))


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_on_the_adapter_trainers_nested_tree(name):
    """The adapter trainer's state holds ``_adapter`` as a subtree of the
    params: every link's state nests the same way (flax's state dict)."""
    tp, tos, _ = _run_both(name, BASE[:-2] + ["OPTIM.WEIGHT_DECAY", "0.0"], adapter=True)
    assert set(tp["_adapter"]) == {"down_kernel", "up_kernel"}


def _adam_state(seed):
    """A JAX adam TrainState three updates in (every leaf non-trivial)."""
    opts = BASE + ["OPTIM.NAME", "adam"]
    opt = J.build_optimizer(jsetup(opts=opts).OPTIM, 2)
    rng = np.random.default_rng(seed)
    p = _params(rng)
    state = J.create_train_state(jax.tree.map(jnp.asarray, p), opt)
    for _ in range(3):
        g = jax.tree.map(lambda v: jnp.asarray(rng.standard_normal(np.shape(v)), jnp.float32), p)
        upd, os_ = opt.update(g, state.opt_state, state.params)
        state = J.TrainState(state.step + 1, jax.tree.map(lambda a, b: a + b, state.params, upd),
                             jax.tree.map(lambda a: a * 0.5, state.params), os_)
    return state, opts


def _bitwise(port_tree, jax_tree):
    a, b = _flat(port_tree), _flat(jax.device_get(serialization.to_state_dict(jax_tree)))
    assert set(a) == set(b), set(a) ^ set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_adam_checkpoint_from_jax_resumes_in_the_port(tmp_path):
    state, opts = _adam_state(1)
    jck.save_checkpoint(state, str(tmp_path), "prompt_learner", 4)
    zeros = {k: torch.zeros(np.shape(v)) for k, v in jax.device_get(state.params).items()}
    template = T.create_train_state(zeros, T.build_optimizer(tsetup(opts=opts).OPTIM, 2))
    restored, start = tck.resume_if_exists(template, str(tmp_path), "prompt_learner")
    assert start == 5 and restored.step == 3
    for part in ("params", "ema_params", "opt_state"):
        _bitwise({part: getattr(restored, part)}, {part: getattr(state, part)})
    # and the port's next update is JAX's
    g = {k: np.full(np.shape(v), 0.5, np.float32) for k, v in zeros.items()}
    topt = T.build_optimizer(tsetup(opts=opts).OPTIM, 2)
    tp, tos = topt.update(_tmap(torch.tensor, g), restored.opt_state, restored.params)
    jopt = J.build_optimizer(jsetup(opts=opts).OPTIM, 2)
    upd, jos = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, g), state.opt_state, state.params)
    _tree_close(tp, jax.tree.map(lambda a, b: a + b, state.params, upd), 1e-6)
    _tree_close(tos, jos, 1e-6)


def test_adam_checkpoint_from_the_port_resumes_in_jax(tmp_path):
    jstate, opts = _adam_state(2)
    state = T.TrainState(int(jstate.step), to_port(jstate.params), to_port(jstate.ema_params),
                         to_port(serialization.to_state_dict(jstate.opt_state)))
    path = tck.save_checkpoint(state, str(tmp_path / "port"), "prompt_learner", 7)
    ref = jck.save_checkpoint(jstate, str(tmp_path / "jax"), "prompt_learner", 7)
    assert open(path, "rb").read() == open(ref, "rb").read()  # the same bytes
    template = J.create_train_state(jax.tree.map(jnp.zeros_like, jstate.params),
                                    J.build_optimizer(jsetup(opts=opts).OPTIM, 2))
    restored, start = jck.resume_if_exists(template, str(tmp_path / "port"), "prompt_learner")
    assert start == 8 and int(restored.step) == 3
    for part in ("params", "ema_params", "opt_state"):
        _bitwise({part: getattr(state, part)}, {part: getattr(restored, part)})
