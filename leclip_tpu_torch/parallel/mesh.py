"""The data mesh of the port (counterpart of leclip_tpu/parallel/mesh.py):
one process per GPU, the batch split over the ranks, parameters replicated,
gradients all-reduced — the reference's DDP/NCCL layout (ref
train_caption.py:176-179, DDP wrap Caption_distill_double.py:786-787,
CustomDistributedSamplerWrapper dassl/data/samplers.py:181-195).

A :class:`DataMesh` names the process group, this process's rank, the world
size and the device. :func:`data_mesh` gives the initialized group's world,
or a one-rank mesh without a group (no collectives) where none is
initialized. The helpers are JAX's, each in the process-local form:

* :func:`shard_batch`: the rank's own batch (its ``CaptionBatcher`` /
  ``PairBatcher`` shard) up to its device;
* :func:`put_global`: every rank holds the same global array and keeps its
  own rows;
* :func:`fetch_global`: every rank gets every rank's rows
  (``all_gather_into_tensor``), as a host array; :func:`gather_rows` keeps
  them on the device;
* :func:`replicate`: a broadcast from rank 0 (non-array leaves pass);
* :func:`shard_along`: each rank keeps its own slice of every leaf;
* :func:`pad_to_multiple`: pad an axis to a multiple of the world;
* :func:`prefetch_sharded`: batch N+1 uploads from a producer thread while
  batch N computes.

NCCL carries CUDA tensors, gloo CPU tensors; each rank's tensors live on
the mesh's device."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from .multihost import local_device

# all_gather_into_tensor under its newer name where the installed torch has it
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh: ``world`` ranks, this one ``rank``, on ``device``.
    ``group`` is the process group; ``None`` is one process without a
    group, where every helper is a local operation."""

    rank: int
    world: int
    device: torch.device
    group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None


def local_mesh(device: DeviceLike = None) -> DataMesh:
    """One rank on ``device`` without a process group (no collectives)."""
    return DataMesh(0, 1, resolve_device(device))


def data_mesh(device: DeviceLike = None) -> DataMesh:
    """The initialized process group's world on this rank's device
    (``device`` ``None``: the card, ``cuda:LOCAL_RANK``, over NCCL; the CPU
    over gloo), or :func:`local_mesh` where no group is initialized."""
    if not dist.is_initialized():
        return local_mesh(device)
    backend = dist.get_backend()
    if device is None:
        device = "cpu" if backend == "gloo" else "cuda"
    dev = local_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL process group carries CUDA tensors, not {dev}")
    return DataMesh(dist.get_rank(), dist.get_world_size(), dev, dist.group.WORLD)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _map(fn, tree):
    """``fn`` on every array leaf of a nested dict / list / tuple; other
    leaves pass through."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if _is_array(tree) else tree


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def shard_batch(batch, mesh: DataMesh):
    """The rank's own batch (its loader shard, local batch = global /
    world) onto its device: the process-local contract of the JAX
    package's multi-process branch. Every rank calls with the same local
    shapes, its data drawn as ``CaptionBatcher(shard_index=rank,
    num_shards=world)`` draws it."""
    return _map(lambda x: _tensor(x).to(mesh.device, non_blocking=True), batch)


def _rows(n: int, mesh: DataMesh, what: str) -> slice:
    if n % mesh.world:
        raise ValueError(f"{what}: {n} rows do not divide the world ({mesh.world}); pad with "
                         "parallel.mesh.pad_to_multiple first")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def put_global(x, mesh: DataMesh, dim: int = 0) -> torch.Tensor:
    """Every rank holds the same global array ``x``; each keeps its own
    contiguous rows along ``dim`` on its device (rank r: rows r·n/world to
    (r+1)·n/world). ``x.shape[dim]`` must divide the world."""
    t = _tensor(x)
    rows = _rows(t.shape[dim], mesh, "put_global")
    return t.narrow(dim, rows.start, rows.stop - rows.start).to(mesh.device)


def gather_rows(x: torch.Tensor, mesh: DataMesh, dim: int = 0) -> torch.Tensor:
    """Every rank's rows of ``x`` along ``dim``, in rank order, on every
    rank (``all_gather_into_tensor``); ``x`` itself without a group."""
    if not mesh.distributed:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((mesh.world * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _all_gather(out, src, group=mesh.group)
    return out.movedim(0, dim)


def all_reduce_mean(tensors, mesh: DataMesh) -> list:
    """The mean over the ranks of each tensor, every rank getting the same
    bits (one all-reduce per dtype over a flat buffer); the tensors as
    given without a group."""
    out = list(tensors)
    if not mesh.distributed:
        return out
    by_dtype: dict = {}
    for i, t in enumerate(out):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([out[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        flat = flat / mesh.world
        off = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[off: off + n].view(out[i].shape)
            off += n
    return out


class _GatherRows(torch.autograd.Function):
    """all_gather with a gradient: forward gathers every rank's rows; the
    backward sums the cotangent over the ranks (each rank's loss reads every
    row) and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.group)
        n = g.shape[0] // mesh.world
        return g[mesh.rank * n: (mesh.rank + 1) * n], None


def gather_with_grad(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """:func:`gather_rows` along dim 0 that autograd differentiates
    (``dist.all_gather`` alone drops the gradient): a loss over the global
    batch, computed alike on every rank, then gives each rank's rows the
    world's summed cotangent, and the mean of the ranks' parameter
    gradients (:func:`all_reduce_mean`) is the global loss's gradient. ``x``
    itself without a group."""
    return _GatherRows.apply(x, mesh) if mesh.distributed else x


def fetch_global(x: torch.Tensor, mesh: DataMesh, dim: int = 0) -> np.ndarray:
    """:func:`gather_rows` as a host array: the full global value on every
    rank."""
    return gather_rows(x, mesh, dim).cpu().numpy()


def replicate(tree, mesh: DataMesh):
    """Every array leaf of ``tree`` on the mesh's device, rank 0's value on
    every rank (a broadcast from rank 0). Non-array leaves (static metadata,
    step counts) pass through."""

    def put(x):
        src = _tensor(x)
        t = src.to(mesh.device)
        if not mesh.distributed:
            return t
        # the broadcast writes in place into a contiguous buffer: never into
        # the caller's memory; the result keeps the leaf's strides (the int8
        # kernels' K-contiguous weight layout)
        buf = t.contiguous()
        if buf.data_ptr() == src.data_ptr():
            buf = buf.clone()
        dist.broadcast(buf, src=0, group=mesh.group)
        return buf if t.is_contiguous() else torch.empty_like(t).copy_(buf)

    return _map(put, tree)


def shard_along(tree, mesh: DataMesh, dim: int = 0):
    """Every array leaf of ``tree`` cut along ``dim``, each rank keeping its
    own slice (e.g. a caption feature bank row-sharded across the cards)."""
    return _map(lambda x: put_global(x, mesh, dim), tree)


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0, mode: str = "wrap"):
    """Pad so an axis divides the world; returns (padded, original_length).

    mode='wrap' repeats leading rows — right for batches, where padded rows'
    outputs are discarded by original_length. mode='zero' appends zero rows —
    right for a retrieval BANK, where a wrapped duplicate could occupy two
    top-k slots (the sharded search excludes the pad rows by index)."""
    n = array.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return array, n
    if mode == "zero":
        shape = list(array.shape)
        shape[axis] = pad
        take = np.zeros(shape, dtype=array.dtype)
    elif mode == "wrap":
        take = np.take(array, np.arange(pad) % n, axis=axis)
    else:
        raise ValueError(f"mode must be wrap | zero, got {mode!r}")
    return np.concatenate([array, take], axis=axis), n


def _pinned(x) -> torch.Tensor:
    t = _tensor(x)
    return t if t.is_cuda or t.is_pinned() else t.pin_memory()


def prefetch_sharded(batches, mesh: DataMesh, depth: int = 2):
    """Iterate host batches, each uploaded by :func:`shard_batch`'s rule
    from a producer thread, so batch N+1's host→device copy overlaps batch
    N's compute. ``depth <= 0`` uploads inline, the plain loop's method.

    On the card the producer copies each batch into pinned host buffers and
    up with ``non_blocking=True`` on a side stream, recording an event after
    it; the consumer's stream waits on that event before the batch is used,
    and ``record_stream`` marks each tensor as used there, so the caching
    allocator does not hand its memory out again while the consumer's
    kernels may still read it. A producer's error is re-raised in the
    consumer; the thread is reaped when the epoch ends, the consumer raises
    (the NaN guard) or the iterator is abandoned. Same values, same order
    as the inline loop."""
    if depth <= 0:
        for b in batches:
            yield shard_batch(b, mesh)
        return
    side = torch.cuda.Stream(mesh.device) if mesh.device.type == "cuda" else None

    def upload(b):
        if side is None:
            return shard_batch(b, mesh), None
        with torch.cuda.stream(side):
            out = _map(lambda x: _pinned(x).to(mesh.device, non_blocking=True), b)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()
    failure = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if not put(upload(b)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            failure.append(e)
        finally:
            put(end)

    t = threading.Thread(target=producer, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            out, done = item
            if done is not None:
                stream = torch.cuda.current_stream(mesh.device)
                stream.wait_event(done)
                _map(lambda x: x.record_stream(stream), out)
            yield out
    finally:
        # reap the producer whether the epoch completed, the consumer raised
        # or the generator was abandoned: unblock a pending put, then join
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=30.0)
    if failure:
        raise failure[0]
