"""Device resolution for the port's entry points.

Entry points default to the card. They never drift to the CPU on their own:
asking for CUDA where there is none raises, and the CPU is used only when the
caller passes ``device="cpu"`` (as the tests do)."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "leclip_tpu_torch needs a CUDA device (torch.cuda.is_available() "
            "is False); pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def cast_floating(tree, dtype: Optional[torch.dtype]):
    """Cast every floating tensor leaf to ``dtype`` (no-op for None)."""
    if dtype is None:
        return tree
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


@contextlib.contextmanager
def no_tf32():
    """fp32 convolutions and products in full fp32 for the duration of the
    call: cuDNN runs fp32 convolutions in TF32 by default, which keeps about
    three decimal digits. The previous settings are restored on exit."""
    cudnn, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = mm
