"""The bf16 convolution of the ResNet trunk: a hand-written Hopper kernel whose
output for an image does not depend on the batch, and its plain version.

* ``conv_bf16`` — NHWC x [B, H, W, Cin] (bf16) convolved with a kernel
  [Cout, Cin, kh, kw] (models/resnet.conv_layout: stored [Cout, kh, kw, Cin]),
  padded "SAME" as ``lax.conv_general_dilated`` pads, each output element
  the fp32 sum of its products over K = (kh, kw, cin) in that order, rounded
  to bf16 once. CUDA source: ``csrc/conv_bf16.cu``.

It replaces no Pallas kernel: the JAX package leaves its convolutions to XLA
(leclip_tpu/models/resnet.py ``conv2d``), which gives an image the same
values at every batch size. cuDNN's bf16 kernels are chosen by shape and sum
an image's products in another order in a batch of another size, so the
port's bf16 trunk runs every convolution through this kernel, which walks K
in one order fixed by K alone (no split-K, no atomics, one tile shape chosen
by Cout). What bounds it and how it is built is in the note at the top of
the source.

:func:`conv_bf16_plain` is the same function in plain PyTorch: the fp32
convolution of the widened bf16 values (TF32 off), rounded once; the CPU
runs it, and chip_smoke.py holds the kernel to it on the card.
:func:`conv_bf16` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises, never falling back. Under
autograd it is a ``torch.autograd.Function`` whose backward is the
library's convolution gradient (``torch.nn.grad``), as JAX's is XLA's.
``conv_bf16.launches`` counts the launches (ops/launches.py)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import no_tf32
from . import _build
from .block_kernels import _raise_on, _stream


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of ``lax.conv_general_dilated(padding="SAME")``:
    the output keeps ceil(size / stride) positions and an odd total pads one
    more after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel: torch.Tensor, stride: int):
    kh, kw = kernel.shape[-2:]
    return same_pads(x.shape[1], kh, stride), same_pads(x.shape[2], kw, stride)


def conv_library(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The same convolution by ``F.conv2d`` in x's dtype (cuDNN on the card):
    x [B, H, W, Cin] as an NCHW view with channels-last strides, asymmetric
    pads (the stem's (0, 1)) by an explicit pad."""
    (top, bottom), (left, right) = _pads(x, kernel, stride)
    xc = x.permute(0, 3, 1, 2)
    w = kernel.to(x.dtype)
    if top == bottom and left == right:
        y = F.conv2d(xc, w, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), w, stride=stride)
    return y.permute(0, 2, 3, 1)


def conv_bf16_plain(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The kernel's function: the fp32 convolution of the exactly widened
    bf16 values, TF32 off, rounded to bf16 once (JAX's single rounding
    point)."""
    with no_tf32():
        return conv_library(x.float(), kernel.to(x.dtype).float(), stride).to(torch.bfloat16)


def _launch(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """One launch of csrc/conv_bf16.cu on x's device and current stream."""
    b, h, w, cin = x.shape
    cout, kcin, kh, kw = kernel.shape
    if kcin != cin:
        raise ValueError(f"conv_bf16: kernel takes {kcin} channels, x has {cin}")
    (top, _), (left, _) = _pads(x, kernel, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    x = x.contiguous()
    wk = kernel.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()  # [Cout, kh, kw, Cin]
    if cin % 8:  # zero-filled channels: each adds +0 to an fp32 sum
        extra = 8 - cin % 8
        x = F.pad(x, (0, extra))
        wk = F.pad(wk, (0, extra))
        cin += extra
    n_out = -(-cout // 8) * 8  # zero-filled output channels, cut off again below
    if n_out != cout:
        wk = F.pad(wk, (0, 0, 0, 0, 0, 0, 0, n_out - cout))
    for name, t in (("x", x), ("kernel", wk)):
        if t.data_ptr() % 16:
            raise ValueError(f"conv_bf16 {name}: data must start on a 16-byte boundary")
    out = torch.empty((b, ho, wo, n_out), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("conv_bf16")
    rc = lib.leclip_conv_bf16(x.data_ptr(), wk.data_ptr(), out.data_ptr(), b, h, w, cin, ho, wo,
                              n_out, kh, kw, int(stride), top, left, _stream(x.device))
    _raise_on(rc, "conv_bf16")
    conv_bf16.launches += 1
    return out if n_out == cout else out[..., :cout].contiguous()


def _forward(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv_bf16: takes bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return conv_bf16_plain(x, kernel, stride)
    if x.device.type != "cuda":
        raise ValueError(f"conv_bf16: unsupported device {x.device}")
    if kernel.device != x.device:
        raise ValueError(f"conv_bf16: kernel on {kernel.device}, x on {x.device}")
    return _launch(x, kernel, stride)


class _ConvBF16(torch.autograd.Function):
    """Forward: the kernel (its plain version on the CPU). Backward: the
    library's convolution gradients on the padded input, in x's dtype."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        ctx.save_for_backward(x, kernel)
        ctx.stride = stride
        return _forward(x, kernel, stride)

    @staticmethod
    def backward(ctx, grad):
        x, kernel = ctx.saved_tensors
        stride = ctx.stride
        (top, bottom), (left, right) = _pads(x, kernel, stride)
        xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
        g = grad.permute(0, 3, 1, 2).to(x.dtype)
        w = kernel.to(x.dtype)
        gx = gk = None
        if ctx.needs_input_grad[0]:
            gp = torch.nn.grad.conv2d_input(xc.shape, w, g, stride=stride)
            gx = gp[:, :, top:top + x.shape[1], left:left + x.shape[2]].permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            gk = torch.nn.grad.conv2d_weight(xc, w.shape, g, stride=stride).to(kernel.dtype)
        return gx, gk, None


def conv_bf16(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """bf16 x [B, H, W, Cin] → [B, ceil(H/s), ceil(W/s), Cout], padded "SAME";
    ``kernel`` [Cout, Cin, kh, kw], cast to bf16. Differentiable where an
    input requires grad."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        return _ConvBF16.apply(x, kernel, stride)
    return _forward(x, kernel, stride)


conv_bf16.launches = 0
