"""Checkpoint I/O (counterpart of leclip_tpu/engine/checkpoint.py): prompt-
learner checkpoints with the reference's directory layout.

Per-model directories ``{dir}/{name}/``. Training writes the JAX package's
own format: ``model.ckpt-{epoch}``, the flax-msgpack bytes of ``{"params",
"ema_params", "opt_state", "step", "epoch"}`` (engine/flax_msgpack.py, the
same bytes flax writes for the same tree), beside a ``checkpoint`` pointer
file naming the latest; resume restores params, EMA twin, optimizer state
and step. The two packages read each other's files. Evaluation reads just
the trainable prompt tensors, from (in order of preference) ``model.ckpt*``,
the port's ``model.pt[-e]`` files (:func:`save_prompt_params`), or the
reference's own ``model.pth.tar[-e]`` torch checkpoints
(models/convert.py ``load_prompt_checkpoint``). The JAX package's orbax
backend is not ported."""

from __future__ import annotations

import os
from os.path import join
from typing import Optional

import torch

from . import flax_msgpack
from .train_state import TrainState


def save_checkpoint(state: TrainState, directory: str, name: str, epoch: int) -> str:
    """Write ``{directory}/{name}/model.ckpt-{epoch}`` and point
    ``checkpoint`` at it."""
    model_dir = join(directory, name)
    os.makedirs(model_dir, exist_ok=True)
    path = join(model_dir, f"model.ckpt-{epoch}")
    payload = {"params": state.params, "ema_params": state.ema_params,
               "opt_state": state.opt_state, "step": int(state.step), "epoch": epoch}
    with open(path, "wb") as f:
        f.write(flax_msgpack.packb(payload))
    with open(join(model_dir, "checkpoint"), "w") as f:
        f.write(os.path.basename(path))
    return path


def latest_checkpoint(directory: str, name: str) -> Optional[str]:
    """The file the ``checkpoint`` pointer names, else the highest-numbered
    ``model.ckpt*``."""
    pointer = join(directory, name, "checkpoint")
    if os.path.exists(pointer):
        with open(pointer) as f:
            fname = f.read().strip()
        path = join(directory, name, fname)
        if os.path.exists(path):
            return path
    model_dir = join(directory, name)
    if not os.path.isdir(model_dir):
        return None
    ckpts = [f for f in os.listdir(model_dir) if f.startswith("model.ckpt")]
    if not ckpts:
        return None
    ckpts.sort(key=lambda f: int(f.rsplit("-", 1)[-1]) if "-" in f else -1)
    return join(model_dir, ckpts[-1])


def load_checkpoint(path: str) -> dict:
    """The payload of a ``model.ckpt*`` file, arrays as CPU tensors."""
    with open(path, "rb") as f:
        return flax_msgpack.unpackb(f.read())


def _like(template, value):
    """``value`` (a payload subtree) shaped as ``template``: each tensor on
    the template leaf's device, every key of the template required."""
    if isinstance(template, dict):
        return {k: _like(template[k], value[k]) for k in template}
    if isinstance(template, torch.Tensor):
        if tuple(value.shape) != tuple(template.shape) or value.dtype != template.dtype:
            raise ValueError(f"checkpoint leaf {tuple(value.shape)} {value.dtype} does not "
                             f"match {tuple(template.shape)} {template.dtype}")
        return value.to(template.device)
    return value


def restore_train_state(state: TrainState, payload: dict) -> TrainState:
    """Full resume: params + ema + optimizer + step (template-shaped)."""
    return TrainState(step=int(payload.get("step", 0)),
                      params=_like(state.params, payload["params"]),
                      ema_params=_like(state.ema_params, payload["ema_params"]),
                      opt_state=_like(state.opt_state, payload["opt_state"]))


def resume_if_exists(state: TrainState, directory: str, name: str):
    """RESUME semantics: restore the newest checkpoint if one exists; returns
    (state, start_epoch)."""
    path = latest_checkpoint(directory, name)
    if path is None:
        return state, 0
    payload = load_checkpoint(path)
    return restore_train_state(state, payload), int(payload.get("epoch", -1)) + 1


def _suffix_rank(fname: str, stem: str) -> int:
    suffix = fname[len(stem):]
    if not suffix:
        return 10 ** 9  # unsuffixed = the chosen ("best") model
    try:
        return int(suffix.lstrip("-"))
    except ValueError:
        return -1


def _latest(model_dir: str, stem: str) -> Optional[str]:
    if not os.path.isdir(model_dir):
        return None
    files = [f for f in os.listdir(model_dir)
             if f.startswith(stem) and _suffix_rank(f, stem) >= 0]
    if not files:
        return None
    files.sort(key=lambda f: _suffix_rank(f, stem))
    return join(model_dir, files[-1])


def save_prompt_params(trainable: dict, directory: str, name: str,
                       epoch: Optional[int] = None) -> str:
    """Write ``{directory}/{name}/model.pt[-epoch]`` (CPU tensors)."""
    model_dir = join(directory, name)
    os.makedirs(model_dir, exist_ok=True)
    path = join(model_dir, "model.pt" if epoch is None else f"model.pt-{epoch}")
    torch.save({"params": {k: v.detach().cpu() for k, v in trainable.items()},
                "epoch": -1 if epoch is None else epoch}, path)
    return path


def load_prompt_params(directory: str, name: str, epoch: Optional[int] = None,
                       device="cpu", use_ema: bool = False) -> dict:
    """Just the trainable prompt tensors of member ``name``: ``model.ckpt*``
    first (``use_ema`` takes its EMA twin), then the port's ``model.pt``
    files, then the reference's ``model.pth.tar``. Files without an EMA twin
    give their params under ``use_ema`` (the reference exports its EMA
    variant as a model directory of its own)."""
    model_dir = join(directory, name)
    if epoch is not None:
        cands = [join(model_dir, f"model.ckpt-{epoch}"), join(model_dir, f"model.pt-{epoch}"),
                 join(model_dir, f"model.pth.tar-{epoch}")]
        path = next((p for p in cands if os.path.exists(p)), None)
    else:
        direct = join(model_dir, "model.ckpt")
        # "model.pth.tar" never ranks under the "model.pt" stem (its suffix
        # "h.tar" is not an epoch)
        path = ((direct if os.path.exists(direct) else latest_checkpoint(directory, name))
                or _latest(model_dir, "model.pt") or _latest(model_dir, "model.pth.tar"))
    if path is None:
        raise FileNotFoundError(f"no checkpoint for {name!r} under {directory!r}")
    base = os.path.basename(path)
    if base.startswith("model.ckpt"):
        trainable = load_checkpoint(path)["ema_params" if use_ema else "params"]
    elif "model.pth.tar" in base:
        from ..models.convert import load_prompt_checkpoint

        trainable, _ = load_prompt_checkpoint(path)
    else:
        trainable = torch.load(path, map_location="cpu", weights_only=True)["params"]
    return {k: v.to(device) for k, v in trainable.items()}
