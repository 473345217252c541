"""Multi-process runtime of the port (counterpart of
leclip_tpu/parallel/multihost.py): one process per GPU, joined by
torch.distributed, the reference's own layout (``train_caption.py:176-179``
init_process_group over NCCL, rank-gated checkpoints
``Caption_distill_double.py:576-587`` and printing
``dassl/engine/trainer.py:656``).

* :func:`initialize` joins the process group: from torchrun's ``env://``
  variables when called with no arguments, else from the arguments given.
  CUDA devices join over NCCL with ``device_id=cuda:LOCAL_RANK``; gloo only
  when the caller asks for the CPU (``device="cpu"``, as the tests do).
* :func:`is_primary` is the rank-0 gate of checkpoint writes, metric files
  and console lines: every rank holds the same replicated state, and on a
  shared filesystem concurrent writers would race on the same paths.
* :func:`barrier` is a sync point (``dist.barrier``).
* :func:`local_device` is this process's card, ``cuda:LOCAL_RANK``.

Launch ``N`` ranks on one host with ``torchrun --nproc_per_node N -m
leclip_tpu_torch.cli.train ...``."""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

# the env:// rendezvous variables torchrun sets in every rank
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _cluster_env_detected() -> bool:
    """True only on evidence of a MULTI-process launch: torchrun's
    WORLD_SIZE, SLURM's task count or Open MPI's world size above 1. A
    one-task allocation is still one process. (The port's own copy of the
    JAX package's rule, with torchrun's variable in place of the TPU pod's
    markers.)"""
    env = os.environ
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(env.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def local_device(device: DeviceLike = None) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for a CUDA device given
    without an index (``None`` means CUDA), the device as given otherwise.
    Through ``device.resolve_device``, so it raises without a card instead
    of drifting to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(dev)


def initialize(device: DeviceLike = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: Optional[float] = None) -> bool:
    """Join the process group; returns whether this process is in one.

    With no rendezvous arguments it reads torchrun's ``env://`` variables
    and is a no-op where they are absent, so single-process entry points
    call it unconditionally. Where cluster markers say the launch has
    several processes but the join cannot be made, it raises, as a failed
    join does: a silent single-process fallback would make every rank
    "primary", each training on the full data and writing the same
    checkpoint paths. ``init_method`` / ``world_size`` / ``rank`` join
    explicitly (``"file:///path"`` or ``"tcp://host:port"``); a world of one
    joins too, so a one-card launch runs the collectives for real."""
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None and rank is None:
        if not all(v in os.environ for v in TORCHRUN_VARS):
            if _cluster_env_detected():
                raise RuntimeError(
                    "a multi-process launch is indicated (WORLD_SIZE / SLURM_NTASKS / "
                    "OMPI_COMM_WORLD_SIZE > 1) but torchrun's env:// variables "
                    f"{TORCHRUN_VARS} are not all set; launch with torchrun or pass "
                    "init_method, world_size and rank")
            return False
        init_method = "env://"
    dev = local_device(device)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
        kwargs["device_id"] = dev
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kwargs)
    return True


def is_primary() -> bool:
    """True on the process that writes checkpoints, metrics and logs (the
    reference's ``rank == 0`` gate); True without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Block until every rank reaches this point (no-op without a group)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
