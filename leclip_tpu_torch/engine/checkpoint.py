"""Prompt-checkpoint loading for evaluation (counterpart of
``load_prompt_params`` in leclip_tpu/engine/checkpoint.py).

Per-model directories ``{dir}/{name}/``. Two formats are read:

* the reference's own ``model.pth.tar[-e]`` torch checkpoints
  (models/convert.py ``load_prompt_checkpoint``);
* the port's ``model.pt[-e]`` files, written by :func:`save_prompt_params`
  with ``torch.save({"params": trainable, "epoch": e})``.

The JAX package's flax-msgpack ``model.ckpt[-e]`` files wait (msgpack is not
a dependency of the port); finding only those raises."""

from __future__ import annotations

import os
from os.path import join
from typing import Optional

import torch

MSGPACK_PENDING = ("flax msgpack checkpoints (model.ckpt*) are not read by the port yet "
                   "(ROADMAP.md queue 1); convert them to model.pt or model.pth.tar")


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
                       device="cpu") -> dict:
    """Just the trainable prompt tensors of member ``name``. Prefers the
    port's ``model.pt`` files, then the reference's ``model.pth.tar``."""
    model_dir = join(directory, name)
    if epoch is not None:
        cands = [join(model_dir, f"model.pt-{epoch}"), join(model_dir, f"model.pth.tar-{epoch}")]
        path = next((p for p in cands if os.path.exists(p)), None)
    else:
        # "model.pth.tar" never ranks under the "model.pt" stem (its suffix
        # "h.tar" is not an epoch)
        path = _latest(model_dir, "model.pt") or _latest(model_dir, "model.pth.tar")
    if path is None:
        if _latest(model_dir, "model.ckpt") is not None:
            raise NotImplementedError(MSGPACK_PENDING)
        raise FileNotFoundError(f"no checkpoint for {name!r} under {directory!r}")
    if "model.pth.tar" in os.path.basename(path):
        from ..models.convert import load_prompt_checkpoint

        trainable, _ = load_prompt_checkpoint(path)
    else:
        trainable = torch.load(path, map_location="cpu", weights_only=True)["params"]
    return {k: v.to(device) for k, v in trainable.items()}
