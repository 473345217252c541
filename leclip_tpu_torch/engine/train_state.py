"""Training state + optimizer/schedule construction (counterpart of
leclip_tpu/engine/train_state.py).

Optimizer semantics match the reference stack (ref: Dassl dassl/optim/
optimizer.py:13-137, lr_scheduler.py:83-154, update cadence
dassl/engine/trainer.py + Caption_distill_double.py:894-895): SGD with
momentum 0.9 and coupled weight decay 5e-4 over the prompt-learner params
only, cosine annealing stepped ONCE PER EPOCH, optional constant/linear
warmup epochs.

The update is written as plain functions on tensors, not ``torch.optim``, so
that the optimizer state is the JAX package's tree leaf for leaf: its
``optax.chain(add_decayed_weights, trace, scale_by_learning_rate)`` state in
flax's state-dict form, ``{"0": {}, "1": {"trace": {...}}, "2": {"count":
int32}}`` (``"1"`` also holds ``"step"`` when SGD dampening is set). A
checkpoint's ``opt_state`` therefore crosses between the packages unchanged.

The learning rate is computed on the host in float32, operation for
operation as XLA compiles the JAX package's schedule (its float32 ``cos`` on
the CPU is the C library's ``cosf``, called here through ctypes), so both
packages take the same rate at every step. Only ``sgd`` is ported; the
other optimizers of the JAX menu raise."""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..models.prompt import ema_init
from .config import OptimConfig

NOT_PORTED = ("optimizer {!r} is not ported yet (ROADMAP.md queue 1); the port trains "
              "with 'sgd', which every shipped recipe uses")
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


def _tree(fn, *trees: dict) -> dict:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def build_optimizer(optim: OptimConfig, steps_per_epoch: int) -> Optimizer:
    """SGD with torch-exact update semantics (the reference builds
    torch.optim.SGD, dassl/optim/optimizer.py:83-137): weight decay is added
    to the GRADIENT before the momentum update; the momentum buffer follows
    ``optax.trace`` (= torch's without dampening) or, when SGD_DAMPNING is
    set, torch's dampened buffer whose first step is the raw gradient."""
    name = optim.NAME.lower()
    if name != "sgd":
        raise NotImplementedError(NOT_PORTED.format(optim.NAME))
    schedule = epoch_lr_schedule(optim, steps_per_epoch)
    wd = optim.WEIGHT_DECAY
    decay = optim.MOMENTUM
    dampening = getattr(optim, "SGD_DAMPNING", 0.0)  # dassl's spelling
    nesterov = getattr(optim, "SGD_NESTEROV", False)

    def init(params: dict) -> dict:
        mom = {"trace": {k: torch.zeros_like(v) for k, v in params.items()}}
        if dampening:
            mom["step"] = torch.zeros((), dtype=torch.int32)
        return {"0": {}, "1": mom, "2": {"count": torch.zeros((), dtype=torch.int32)}}

    def update(grads: dict, state: dict, params: dict):
        g = _tree(lambda gi, p: gi + wd * p, grads, params)  # add_decayed_weights
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
        step_size = -schedule(int(count))                        # scale_by_learning_rate
        new = _tree(lambda p, ui: p + torch.tensor(step_size, dtype=ui.dtype,
                                                   device=ui.device) * ui, params, u)
        return new, {"0": {}, "1": new_mom, "2": {"count": count + 1}}

    return Optimizer(init, update)


def create_train_state(trainable: Dict[str, torch.Tensor], optimizer: Optimizer) -> TrainState:
    params = {k: v.detach().clone() for k, v in trainable.items()}
    return TrainState(step=0, params=params, ema_params=ema_init(params),
                      opt_state=optimizer.init(params))
