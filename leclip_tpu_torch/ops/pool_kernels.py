"""The ResNet trunk's average pools: a hand-written NHWC kernel and its
plain version.

* ``avg_pool_nhwc(x, k)`` — x [B, H, W, C] (bf16 or fp32, contiguous) →
  [B, H // k, W // k, C]: the mean of each k x k window at stride k, no
  padding, floor mode, as ``F.avg_pool2d(x, k)`` on the NCHW view. Each
  output is the fp32 sum of its window from 0 (rows top to bottom, columns
  left to right), divided by k² in fp32 and rounded once, as the library's
  CUDA kernel computes it, so the two agree bit for bit. CUDA source:
  ``csrc/avg_pool_nhwc.cu``.

The kernel replaces no Pallas kernel: the JAX package's pool is XLA's
``reduce_window`` (leclip_tpu/models/resnet.py ``avg_pool``). It was added
because PyTorch's pool ran at ~12% of the card's bandwidth on the trunk's
NHWC maps; what bounds it and how it is built is in the note at the top of
its source.

:func:`avg_pool_nhwc_plain` is the same function in plain PyTorch (the
library's pool on the NCHW view). The CPU runs it, and the card tests hold
the kernel to it. The wrapper takes its plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises, never falling
back. Under autograd it is a ``torch.autograd.Function`` whose forward is
the kernel and whose backward is plain (:func:`avg_pool_nhwc_grad_plain`,
the library's gradient bit for bit). ``avg_pool_nhwc.launches`` counts the
launches (ops/launches.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .block_kernels import _raise_on, _stream

DTYPES = (torch.bfloat16, torch.float32)


def avg_pool_nhwc_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`avg_pool_nhwc`'s function in plain PyTorch, on any device."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def avg_pool_nhwc_grad_plain(g: torch.Tensor, shape, k: int) -> torch.Tensor:
    """The gradient of :func:`avg_pool_nhwc` at an input of ``shape`` from
    the output's ``g``: each window's ``g / k²`` (fp32, rounded once to g's
    dtype) on every one of its pixels, 0 on the rows and columns floor mode
    dropped. The divisor is a tensor, since PyTorch's CUDA ops turn a
    division by a Python number into a product by its reciprocal (not the
    library's bits at k = 3)."""
    b, h, w, c = shape
    div = torch.tensor(float(k * k), device=g.device)
    share = (g.float() / div).to(g.dtype)
    out = g.new_zeros((b, h, w, c))
    ho, wo = g.shape[1], g.shape[2]
    out[:, :ho * k, :wo * k] = share.repeat_interleave(k, 1).repeat_interleave(k, 2)
    return out


def _launch(x: torch.Tensor, k: int) -> torch.Tensor:
    """One launch of csrc/avg_pool_nhwc.cu on x's device and current stream."""
    if x.dtype not in DTYPES:
        raise TypeError(f"avg_pool_nhwc: takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"avg_pool_nhwc: x must be a contiguous [B, H, W, C] map, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    b, h, w, c = x.shape
    if c * x.element_size() % 16 or x.data_ptr() % 16:
        raise ValueError(f"avg_pool_nhwc: a pixel's channels must fill 16-byte vectors from a "
                         f"16-byte boundary, got C = {c} of {x.dtype}")
    if k < 1 or h < k or w < k:
        raise ValueError(f"avg_pool_nhwc: window {k} does not fit a {h}x{w} map")
    out = torch.empty((b, h // k, w // k, c), dtype=x.dtype, device=x.device)
    lib = _build.load("avg_pool_nhwc")
    rc = lib.leclip_avg_pool_nhwc(x.data_ptr(), out.data_ptr(), b, h, w, c, int(k),
                                  int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(rc, "avg_pool_nhwc")
    avg_pool_nhwc.launches += 1
    return out


class _AvgPool(torch.autograd.Function):
    """Forward: the kernel (its plain version on the CPU). Backward:
    :func:`avg_pool_nhwc_grad_plain`."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.shape, ctx.k = tuple(x.shape), k
        return avg_pool_nhwc_plain(x, k) if x.device.type == "cpu" else _launch(x, k)

    @staticmethod
    def backward(ctx, g):
        return avg_pool_nhwc_grad_plain(g, ctx.shape, ctx.k), None


def avg_pool_nhwc(x: torch.Tensor, k: int) -> torch.Tensor:
    """NHWC x [B, H, W, C] → [B, H // k, W // k, C], each k x k window's
    mean (see the module's note): the kernel on the card, differentiable
    where x requires grad; :func:`avg_pool_nhwc_plain` on the CPU."""
    if x.device.type == "cpu":
        return avg_pool_nhwc_plain(x, k)
    if torch.is_grad_enabled() and x.requires_grad:
        return _AvgPool.apply(x, k)
    return _launch(x, k)


avg_pool_nhwc.launches = 0
