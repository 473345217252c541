"""Training state + optimizer/schedule construction (counterpart of
leclip_tpu/engine/train_state.py).

Optimizer semantics match the reference stack (ref: Dassl dassl/optim/
optimizer.py:13-137, lr_scheduler.py:83-154, update cadence
dassl/engine/trainer.py + Caption_distill_double.py:894-895): SGD with
momentum 0.9 and coupled weight decay 5e-4 over the prompt-learner params
only, cosine annealing stepped ONCE PER EPOCH, optional constant/linear
warmup epochs. adam, amsgrad, adamw, rmsprop and radam complete the JAX
package's menu.

The update is written as plain functions on tensors, not ``torch.optim``, so
that the optimizer state is the JAX package's tree leaf for leaf: its
optax chain's state in flax's state-dict form, one entry per link of the
chain, keyed ``"0"``, ``"1"``, ... (SGD: ``{"0": {}, "1": {"trace": {...}},
"2": {"count": int32}}``, ``"1"`` also holding ``"step"`` when SGD dampening
is set; adam: ``{"0": {}, "1": {"count", "mu", "nu"}, "2": {"count"}}``; the
table in :func:`build_optimizer`). A checkpoint's ``opt_state`` therefore
crosses between the packages unchanged.

The learning rate is computed on the host in float32, operation for
operation as XLA compiles the JAX package's schedule (its float32 ``cos`` on
the CPU is the C library's ``cosf``, called here through ctypes), so both
packages take the same rate at every step; so are the moment optimizers'
bias corrections."""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..models.prompt import ema_init
from .config import OptimConfig

_F32 = np.float32


class TrainState(NamedTuple):
    step: int                           # global step counter
    params: Dict[str, torch.Tensor]     # trainable prompt-learner tensors
    ema_params: Dict[str, torch.Tensor]  # momentum twin (same keys)
    opt_state: dict                     # the optax chain's state, flax state-dict form


class Optimizer(NamedTuple):
    """``init(params) → opt_state``; ``update(grads, opt_state, params) →
    (new params, new opt_state)``."""

    init: Callable
    update: Callable


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.cosf.restype = ctypes.c_float
    lib.cosf.argtypes = [ctypes.c_float]
    return lib


def _cos(x) -> np.float32:
    return _F32(_libm().cosf(float(x)))


def _recip(x) -> np.float32:
    return _F32(1.0) / _F32(x)


def epoch_lr_schedule(optim: OptimConfig, steps_per_epoch: int) -> Callable[[int], np.float32]:
    """LR as a function of the global step, constant within an epoch (the
    reference steps its scheduler at epoch end): cosine (default),
    single_step (periodic StepLR), multi_step and constant annealing, plus
    constant/linear warmup with WARMUP_RECOUNT, with dassl's per-epoch values
    (see the JAX function's notes on WARMUP_RECOUNT=False's phase jump and
    StepLR's periodic drops). Every operation is the float32 operation that
    XLA compiles the JAX function into (its training step evaluates the
    schedule inside the jitted step): a division by a constant becomes a
    product with the constant's float32 reciprocal, folded into the other
    constants. So the value is the JAX step's to the bit."""
    base = optim.LR
    max_epoch = optim.MAX_EPOCH
    warmup = optim.WARMUP_EPOCH
    recount = getattr(optim, "WARMUP_RECOUNT", True)
    sched = optim.SCHED.lower()
    warm_on = bool(warmup and warmup > 0)
    # the angle per epoch, pi / MAX_EPOCH, as XLA folds it: the division by
    # a constant becomes a product with its float32 reciprocal
    per_epoch = _F32(np.pi) * _recip(max_epoch)

    def gamma_pow(drops: int) -> np.float32:
        return _F32(base) * _F32(optim.GAMMA) ** _F32(drops)

    def anneal(epoch: int) -> np.float32:
        if sched == "cosine":
            if warm_on and recount:
                return _F32(base * 0.5) * (_F32(1.0) + _cos(_F32(epoch - warmup) * per_epoch))
            if warm_on:
                den = _F32(1.0) + _cos(np.pi * warmup / max_epoch)
                return (_F32(1.0) + _cos(_F32(epoch) * per_epoch)) * (_F32(base) * _recip(den))
            return _F32(base * 0.5) * (_F32(1.0) + _cos(_F32(epoch) * per_epoch))
        if sched == "single_step":
            ss = optim.STEPSIZE[0] if optim.STEPSIZE else -1
            ss = ss if ss > 0 else max_epoch  # dassl: stepsize<=0 → max_epoch
            if warm_on and recount:
                drops = (epoch - warmup) // ss
            elif warm_on:
                drops = epoch // ss - warmup // ss
            else:
                drops = epoch // ss
            return gamma_pow(drops)
        if sched == "multi_step":
            ms = optim.STEPSIZE
            if warm_on and recount:
                drops = sum(1 for m in ms if epoch - warmup >= m)
            elif warm_on:
                drops = sum(1 for m in ms if m > warmup and epoch >= m)
            else:
                drops = sum(1 for m in ms if epoch >= m)
            return gamma_pow(drops)
        if sched == "constant":
            return _F32(base)
        raise ValueError(f"unknown scheduler {optim.SCHED!r}")

    def lr(step: int) -> np.float32:
        epoch = int(step) // steps_per_epoch
        if warm_on and epoch < warmup:
            if optim.WARMUP_TYPE == "linear":
                return (_F32(optim.WARMUP_MIN_LR) if epoch == 0
                        else _F32(epoch) * (_F32(base) * _recip(warmup)))
            return _F32(optim.WARMUP_CONS_LR)
        return anneal(epoch)

    return lr


def _tree(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts of one structure (the
    prompt params, with the adapter trainer's ``_adapter`` subtree)."""
    if isinstance(trees[0], dict):
        return {k: _tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _zeros(params: dict) -> dict:
    return _tree(torch.zeros_like, params)


def _count() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _bias(decay: float, count: int) -> np.float32:
    """optax's bias correction ``1 - decay ** count`` in float32."""
    return _F32(1.0) - _F32(decay) ** _F32(count)


def _scaled(u: dict, step_size: np.float32, params: dict) -> dict:
    """``params + step_size * u`` (``scale_by_learning_rate`` then
    ``apply_updates``), the scalar in each leaf's dtype."""
    return _tree(lambda p, ui: p + torch.tensor(step_size, dtype=ui.dtype, device=ui.device)
                 * ui, params, u)


def _adam_moments(g: dict, mu: dict, nu: dict, b1: float, b2: float):
    """optax's ``update_moment`` of orders 1 and 2."""
    return (_tree(lambda gi, m: (1 - b1) * gi + b1 * m, g, mu),
            _tree(lambda gi, v: (1 - b2) * (gi * gi) + b2 * v, g, nu))


def build_optimizer(optim: OptimConfig, steps_per_epoch: int) -> Optimizer:
    """The optimizer menu with torch-exact update semantics (the reference
    builds torch optimizers, dassl/optim/optimizer.py:83-137), each the JAX
    package's optax chain written out on tensors: weight decay is added to
    the GRADIENT before the moment updates for every optimizer except AdamW
    (decoupled, ``optax.adamw``) and RAdam (the vendored dassl RAdam adds
    it after the scaling). The chains, whose links key the state:

    ==========  ===================================================  ==========================
    sgd         add_decayed_weights, trace (or torch's dampened       "1": trace (+ step)
                buffer when SGD_DAMPNING is set), lr
    adam        add_decayed_weights, scale_by_adam, lr               "1": count, mu, nu
    amsgrad     add_decayed_weights, torch's amsgrad (the max of the  "1": count, mu, nu, nu_max
                RAW second moment, then the bias correction), lr
    adamw       scale_by_adam, add_decayed_weights, lr               "0": count, mu, nu
    rmsprop     add_decayed_weights, scale_by_rms (eps outside the   "1": nu; "2": trace
                sqrt), trace(MOMENTUM), lr
    radam       scale_by_radam, add_decayed_weights, lr              "0": count, mu, nu
    ==========  ===================================================  ==========================

    The last link is ``scale_by_learning_rate``, whose state is the step
    ``count`` the schedule reads; every other link's state is ``{}``."""
    name = optim.NAME.lower()
    schedule = epoch_lr_schedule(optim, steps_per_epoch)
    wd = optim.WEIGHT_DECAY
    b1 = getattr(optim, "ADAM_BETA1", 0.9)
    b2 = getattr(optim, "ADAM_BETA2", 0.999)
    eps = 1e-8

    def decayed(g: dict, params: dict) -> dict:              # add_decayed_weights
        return _tree(lambda gi, p: gi + wd * p, g, params)

    def adam(g: dict, st: dict):                             # scale_by_adam
        mu, nu = _adam_moments(g, st["mu"], st["nu"], b1, b2)
        count = st["count"] + 1
        bc1, bc2 = _bias(b1, int(count)), _bias(b2, int(count))
        u = _tree(lambda m, v: (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + eps), mu, nu)
        return u, {"count": count, "mu": mu, "nu": nu}

    def amsgrad(g: dict, st: dict):                          # torch's amsgrad
        mu, nu = _adam_moments(g, st["mu"], st["nu"], b1, b2)
        nu_max = _tree(torch.maximum, st["nu_max"], nu)
        count = st["count"] + 1
        bc1, bc2 = _bias(b1, int(count)), _bias(b2, int(count))
        u = _tree(lambda m, v: (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + eps), mu, nu_max)
        return u, {"count": count, "mu": mu, "nu": nu, "nu_max": nu_max}

    def radam(g: dict, st: dict):                            # scale_by_radam
        mu, nu = _adam_moments(g, st["mu"], st["nu"], b1, b2)
        count = st["count"] + 1
        c = int(count)
        bc1, bc2 = _bias(b1, c), _bias(b2, c)
        ro_inf = _F32(2.0 / (1.0 - b2) - 1.0)
        b2t = _F32(b2) ** _F32(c)
        ro = ro_inf - _F32(2 * c) * b2t / (_F32(1.0) - b2t)
        if ro >= 5.0:
            r = float(np.sqrt((ro - _F32(4.0)) * (ro - _F32(2.0)) * ro_inf
                              / ((ro_inf - _F32(4.0)) * (ro_inf - _F32(2.0)) * ro)))
            u = _tree(lambda m, v: r * (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + eps),
                      mu, nu)
        else:
            u = _tree(lambda m: m / float(bc1), mu)
        return u, {"count": count, "mu": mu, "nu": nu}

    if name == "sgd":
        return _sgd(optim, schedule, decayed)
    if name in ("adam", "amsgrad"):
        scale = adam if name == "adam" else amsgrad

        def init(params):
            st = {"count": _count(), "mu": _zeros(params), "nu": _zeros(params)}
            if name == "amsgrad":
                st["nu_max"] = _zeros(params)
            return {"0": {}, "1": st, "2": {"count": _count()}}

        def update(grads, state, params):
            u, st = scale(decayed(grads, params), state["1"])
            count = state["2"]["count"]
            return (_scaled(u, -schedule(int(count)), params),
                    {"0": {}, "1": st, "2": {"count": count + 1}})

        return Optimizer(init, update)
    if name in ("adamw", "radam"):
        scale = adam if name == "adamw" else radam

        def init(params):
            return {"0": {"count": _count(), "mu": _zeros(params), "nu": _zeros(params)},
                    "1": {}, "2": {"count": _count()}}

        def update(grads, state, params):
            u, st = scale(grads, state["0"])
            u = decayed(u, params)
            count = state["2"]["count"]
            return (_scaled(u, -schedule(int(count)), params),
                    {"0": st, "1": {}, "2": {"count": count + 1}})

        return Optimizer(init, update)
    if name == "rmsprop":
        # torch RMSprop: sq = α·sq + (1−α)·g², denom = √sq + eps (eps OUTSIDE
        # the sqrt), buf = m·buf + g/denom, p -= lr·buf
        alpha = getattr(optim, "RMSPROP_ALPHA", 0.99)
        decay = optim.MOMENTUM

        def init(params):
            return {"0": {}, "1": {"nu": _zeros(params)}, "2": {"trace": _zeros(params)},
                    "3": {"count": _count()}}

        def update(grads, state, params):
            g = decayed(grads, params)
            nu = _tree(lambda gi, v: (1 - alpha) * (gi * gi) + alpha * v, g, state["1"]["nu"])
            u = _tree(lambda gi, v: (1 / (torch.sqrt(v) + eps)) * gi, g, nu)
            trace = _tree(lambda ui, t: ui + decay * t, u, state["2"]["trace"])
            count = state["3"]["count"]
            return (_scaled(trace, -schedule(int(count)), params),
                    {"0": {}, "1": {"nu": nu}, "2": {"trace": trace}, "3": {"count": count + 1}})

        return Optimizer(init, update)
    raise ValueError(f"unknown optimizer {optim.NAME!r}")


def _sgd(optim: OptimConfig, schedule: Callable, decayed: Callable) -> Optimizer:
    """SGD (the reference builds torch.optim.SGD): the momentum buffer
    follows ``optax.trace`` (= torch's without dampening) or, when
    SGD_DAMPNING is set, torch's dampened buffer whose first step is the raw
    gradient."""
    decay = optim.MOMENTUM
    dampening = getattr(optim, "SGD_DAMPNING", 0.0)  # dassl's spelling
    nesterov = getattr(optim, "SGD_NESTEROV", False)

    def init(params: dict) -> dict:
        mom = {"trace": _zeros(params)}
        if dampening:
            mom["step"] = _count()
        return {"0": {}, "1": mom, "2": {"count": _count()}}

    def update(grads: dict, state: dict, params: dict):
        g = decayed(grads, params)
        mom = state["1"]
        if dampening:                                            # torch's dampened buffer
            first = int(mom["step"]) == 0
            trace = g if first else _tree(
                lambda t, gi: decay * t + (1.0 - dampening) * gi, mom["trace"], g)
            new_mom = {"trace": trace, "step": mom["step"] + 1}
        else:                                                    # optax.trace
            trace = _tree(lambda gi, t: gi + decay * t, g, mom["trace"])
            new_mom = {"trace": trace}
        u = _tree(lambda gi, t: gi + decay * t, g, trace) if nesterov else trace
        count = state["2"]["count"]
        return (_scaled(u, -schedule(int(count)), params),
                {"0": {}, "1": new_mom, "2": {"count": count + 1}})

    return Optimizer(init, update)


def create_train_state(trainable: Dict[str, torch.Tensor], optimizer: Optimizer) -> TrainState:
    params = _tree(lambda v: v.detach().clone(), trainable)
    return TrainState(step=0, params=params, ema_params=ema_init(params),
                      opt_state=optimizer.init(params))
