"""The convolutions of the ResNet trunk: two hand-written Hopper kernels
whose output for an image does not depend on the batch, and their plain
versions.

* ``conv_bf16`` — NHWC x [B, H, W, Cin] (bf16) convolved with a kernel
  [Cout, Cin, kh, kw] (models/resnet.conv_layout: stored [Cout, kh, kw, Cin]),
  padded "SAME" as ``lax.conv_general_dilated`` pads, each output element
  the fp32 sum of its products over K = (kh, kw, cin) in that order, rounded
  to bf16 once. With ``scale`` / ``offset`` (bf16 [Cout]) it also runs the
  trunk's chain after the convolution in its epilogue: the batch norm's
  multiply and add, then ``residual`` (bf16, the output's shape) and the
  ReLU where asked, each step rounded to bf16 as PyTorch's bf16 elementwise
  ops round, so that it equals the unfused chain bit for bit. CUDA source:
  ``csrc/conv_bf16.cu``.
* ``conv_fp32`` — the same convolution in fp32 on the CUDA cores, each
  output element one FMA chain over K in that order; no TF32. With
  ``scale`` / ``offset`` (fp32 [Cout]) the same chain in its epilogue, each
  step rounded as PyTorch's fp32 ops round (no FMA contraction), so that it
  equals the unfused chain bit for bit; an ``offset`` alone is a bias add.
  CUDA source: ``csrc/conv_fp32.cu``. ``matmul_fp32`` runs it as a 1x1
  convolution for the attention pool's and the dense projection's fp32
  products, their bias in the epilogue.

Neither replaces a Pallas kernel: the JAX package leaves its convolutions
to XLA (leclip_tpu/models/resnet.py ``conv2d``), which gives an image the
same values at every batch size. cuDNN's kernels are chosen by shape and sum
an image's products in another order in a batch of another size, in bf16
and in fp32 alike, so the port's trunk runs every convolution through these
kernels, which walk K in one order fixed by K alone (no split-K, no
atomics). What bounds them and how they are built is in the note at the top
of each source.

:func:`conv_bf16_plain` and :func:`conv_fp32_plain` are the same functions
in plain PyTorch: the fp32 convolution (TF32 off) of the widened bf16 values
rounded once, then the unfused chain; and the fp32 convolution with TF32
off, then the unfused chain. The CPU runs them, and chip_smoke.py holds the
kernels to them on the card. A wrapper takes its plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises, never
falling back. Under
autograd a wrapper is a ``torch.autograd.Function`` whose backward is the
library's convolution gradient (``torch.nn.grad``), as JAX's is XLA's (the
fused chain is not offered there: models/resnet.conv_bn runs it unfused).
``conv_bf16.launches`` and ``conv_fp32.launches`` count the launches
(ops/launches.py)."""

from __future__ import annotations

from typing import Optional, Tuple

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


def bn_chain(y: torch.Tensor, scale: Optional[torch.Tensor], offset: torch.Tensor,
             residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """The trunk's chain after a convolution as PyTorch ops in y's dtype:
    ``y * scale + offset`` (models/resnet.batch_norm's two ops), then ``+
    residual``, then the ReLU; with no ``scale``, ``y + offset`` (a bias)."""
    if scale is not None:
        y = y * scale.to(y.dtype)
    y = y + offset.to(y.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def conv_bf16_plain(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                    scale: Optional[torch.Tensor] = None, offset: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """The kernel's function: the fp32 convolution of the exactly widened
    bf16 values, TF32 off, rounded to bf16 once (JAX's single rounding
    point); with ``scale``, :func:`bn_chain` after it."""
    with no_tf32():
        y = conv_library(x.float(), kernel.to(x.dtype).float(), stride).to(torch.bfloat16)
    return y if scale is None else bn_chain(y, scale, offset, residual, relu)


def conv_fp32_plain(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                    scale: Optional[torch.Tensor] = None, offset: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """conv_fp32's function: the fp32 convolution by the library with TF32
    off (the route of every fp32 convolution before the kernel); with
    ``scale`` or ``offset``, :func:`bn_chain` after it."""
    with no_tf32():
        y = conv_library(x, kernel.to(x.dtype), stride)
    return y if offset is None else bn_chain(y, scale, offset, residual, relu)


def _check_chain(name: str, x: torch.Tensor, kernel: torch.Tensor, stride: int, scale, offset,
                 residual, relu: bool, bias: bool) -> None:
    """The chain's arguments, on every device: ``scale`` and ``offset`` [Cout]
    together (``offset`` alone where ``bias``), ``residual`` and ``relu`` only
    after them, ``residual`` in x's dtype and the output's shape."""
    cout = kernel.shape[0]
    if scale is None:
        if residual is not None or relu:
            raise ValueError(f"{name}: residual and relu come after the batch norm (scale)")
        if offset is not None and not bias:
            raise ValueError(f"{name}: offset comes with scale")
    elif offset is None:
        raise ValueError(f"{name}: scale comes with offset")
    for label, t in (("scale", scale), ("offset", offset)):
        if t is not None and tuple(t.shape) != (cout,):
            raise ValueError(f"{name}: {label} must be [{cout}], got {tuple(t.shape)}")
    if residual is not None:
        shape = (x.shape[0], -(-x.shape[1] // stride), -(-x.shape[2] // stride), cout)
        if tuple(residual.shape) != shape or residual.dtype != x.dtype:
            raise ValueError(f"{name}: residual must be {x.dtype} {shape}, got "
                             f"{residual.dtype} {tuple(residual.shape)}")


def _prepare(x: torch.Tensor, kernel: torch.Tensor, stride: int, dtype: torch.dtype, align: int,
             name: str):
    """x and the kernel as the kernels take them: contiguous NHWC x, the
    weight as [Cout, kh, kw, Cin] in ``dtype``, Cin zero-filled to a multiple
    of ``align`` (each filled channel adds +0 to an fp32 sum); with the
    output's grid and the top / left pads."""
    b, h, w, cin = x.shape
    cout, kcin, kh, kw = kernel.shape
    if kcin != cin:
        raise ValueError(f"{name}: kernel takes {kcin} channels, x has {cin}")
    (top, _), (left, _) = _pads(x, kernel, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    x = x.contiguous()
    wk = kernel.to(dtype).permute(0, 2, 3, 1).contiguous()  # [Cout, kh, kw, Cin]
    if cin % align:
        extra = align - cin % align
        x = F.pad(x, (0, extra))
        wk = F.pad(wk, (0, extra))
    for label, t in (("x", x), ("kernel", wk)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} {label}: data must start on a 16-byte boundary")
    return x, wk, (ho, wo, top, left)


def _chain_tensors(scale, offset, residual, dtype: torch.dtype):
    """The chain's tensors as a kernel reads them: contiguous, ``scale`` and
    ``offset`` in ``dtype`` (None where absent)."""
    return (None if scale is None else scale.to(dtype).contiguous(),
            None if offset is None else offset.to(dtype).contiguous(),
            None if residual is None else residual.contiguous())


def _ptrs(tensors):
    return [0 if t is None else t.data_ptr() for t in tensors]


def _launch(x: torch.Tensor, kernel: torch.Tensor, stride: int, scale=None, offset=None,
            residual=None, relu: bool = False) -> torch.Tensor:
    """One launch of csrc/conv_bf16.cu on x's device and current stream."""
    cout, _, kh, _ = kernel.shape
    x, wk, (ho, wo, top, left) = _prepare(x, kernel, stride, torch.bfloat16, 8, "conv_bf16")
    b, h, w, cin = x.shape
    n_out = -(-cout // 8) * 8  # zero-filled output channels, cut off again below
    if n_out != cout:
        if scale is not None:
            raise ValueError(f"conv_bf16: the fused epilogue takes Cout % 8 == 0, got {cout}")
        wk = F.pad(wk, (0, 0, 0, 0, 0, 0, 0, n_out - cout))
    out = torch.empty((b, ho, wo, n_out), dtype=torch.bfloat16, device=x.device)
    chain = _chain_tensors(scale, offset, residual, torch.bfloat16)
    lib = _build.load("conv_bf16")
    rc = lib.leclip_conv_bf16(x.data_ptr(), wk.data_ptr(), out.data_ptr(), *_ptrs(chain),
                              int(relu), b, h, w, cin, ho, wo, n_out, kh, kernel.shape[-1],
                              int(stride), top, left, _stream(x.device))
    _raise_on(rc, "conv_bf16")
    conv_bf16.launches += 1
    return out if n_out == cout else out[..., :cout].contiguous()


def _launch_fp32(x: torch.Tensor, kernel: torch.Tensor, stride: int, scale=None, offset=None,
                 residual=None, relu: bool = False) -> torch.Tensor:
    """One launch of csrc/conv_fp32.cu on x's device and current stream."""
    cout, _, kh, kw = kernel.shape
    x, wk, (ho, wo, top, left) = _prepare(x, kernel, stride, torch.float32, 4, "conv_fp32")
    b, h, w, cin = x.shape
    n_out = -(-cout // 4) * 4
    if n_out != cout:
        if offset is not None:
            raise ValueError(f"conv_fp32: the fused epilogue takes Cout % 4 == 0, got {cout}")
        wk = F.pad(wk, (0, 0, 0, 0, 0, 0, 0, n_out - cout))
    out = torch.empty((b, ho, wo, n_out), dtype=torch.float32, device=x.device)
    chain = _chain_tensors(scale, offset, residual, torch.float32)
    lib = _build.load("conv_fp32")
    rc = lib.leclip_conv_fp32(x.data_ptr(), wk.data_ptr(), out.data_ptr(), *_ptrs(chain),
                              int(relu), b, h, w, cin, ho, wo, n_out, kh, kw, int(stride), top,
                              left, _stream(x.device))
    _raise_on(rc, "conv_fp32")
    conv_fp32.launches += 1
    return out if n_out == cout else out[..., :cout].contiguous()


def _check(name: str, x: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype, *others):
    """The wrapper's own checks: x's dtype, and every tensor on x's device.
    Returns whether x lies on the CPU (the plain version's case)."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: takes {dtype}, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in (kernel,) + others:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: a tensor on {t.device}, x on {x.device}")
    return x.device.type == "cpu"


def _forward(x, kernel, stride, scale=None, offset=None, residual=None, relu=False):
    if _check("conv_bf16", x, kernel, torch.bfloat16, scale, offset, residual):
        return conv_bf16_plain(x, kernel, stride, scale, offset, residual, relu)
    return _launch(x, kernel, stride, scale, offset, residual, relu)


def _forward_fp32(x, kernel, stride, scale=None, offset=None, residual=None, relu=False):
    if _check("conv_fp32", x, kernel, torch.float32, scale, offset, residual):
        return conv_fp32_plain(x, kernel, stride, scale, offset, residual, relu)
    return _launch_fp32(x, kernel, stride, scale, offset, residual, relu)


class _Conv(torch.autograd.Function):
    """Forward: the kernel (its plain version on the CPU). Backward: the
    library's convolution gradients on the padded input, in x's dtype, TF32
    off."""

    @staticmethod
    def forward(ctx, x, kernel, stride, forward):
        ctx.save_for_backward(x, kernel)
        ctx.stride = stride
        return forward(x, kernel, stride)

    @staticmethod
    def backward(ctx, grad):
        x, kernel = ctx.saved_tensors
        stride = ctx.stride
        (top, bottom), (left, right) = _pads(x, kernel, stride)
        xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
        g = grad.permute(0, 3, 1, 2).to(x.dtype)
        w = kernel.to(x.dtype)
        gx = gk = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                gp = torch.nn.grad.conv2d_input(xc.shape, w, g, stride=stride)
                gx = gp[:, :, top:top + x.shape[1], left:left + x.shape[2]].permute(0, 2, 3, 1)
            if ctx.needs_input_grad[1]:
                gk = torch.nn.grad.conv2d_weight(xc, w.shape, g, stride=stride).to(kernel.dtype)
        return gx, gk, None, None


def _grad_wanted(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def conv_bf16(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
              scale: Optional[torch.Tensor] = None, offset: Optional[torch.Tensor] = None,
              residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """bf16 x [B, H, W, Cin] → [B, ceil(H/s), ceil(W/s), Cout], padded "SAME";
    ``kernel`` [Cout, Cin, kh, kw], cast to bf16. With ``scale`` / ``offset``
    the batch norm (and ``residual``, ``relu``) in the kernel's epilogue.
    Differentiable where an input requires grad (the chain then runs as
    PyTorch ops after the convolution)."""
    _check_chain("conv_bf16", x, kernel, stride, scale, offset, residual, relu, bias=False)
    if _grad_wanted(x, kernel, scale, offset, residual):
        y = _Conv.apply(x, kernel, stride, _forward)
        return y if scale is None else bn_chain(y, scale, offset, residual, relu)
    return _forward(x, kernel, stride, scale, offset, residual, relu)


def conv_fp32(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
              scale: Optional[torch.Tensor] = None, offset: Optional[torch.Tensor] = None,
              residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """fp32 x [B, H, W, Cin] → [B, ceil(H/s), ceil(W/s), Cout], padded
    "SAME"; ``kernel`` [Cout, Cin, kh, kw], cast to fp32; full fp32
    whatever the caller's TF32 setting. With ``scale`` / ``offset`` the
    batch norm (and ``residual``, ``relu``) in the kernel's epilogue; an
    ``offset`` alone is added as a bias. Differentiable where an input
    requires grad (the chain then runs as PyTorch ops after the
    convolution)."""
    _check_chain("conv_fp32", x, kernel, stride, scale, offset, residual, relu, bias=True)
    if _grad_wanted(x, kernel, scale, offset, residual):
        y = _Conv.apply(x, kernel, stride, _forward_fp32)
        return y if offset is None else bn_chain(y, scale, offset, residual, relu)
    return _forward_fp32(x, kernel, stride, scale, offset, residual, relu)


def conv_fp32_tile(m: int, cout: int) -> Tuple[int, int]:
    """(BM, BN): the block tile conv_fp32's kernel takes for ``m`` output
    positions (B·Ho·Wo) and ``cout`` channels (csrc/conv_fp32.cu
    conv_fp32_tile; every tile gives the same bits)."""
    code = _build.load("conv_fp32").leclip_conv_fp32_tile(int(m), -(-int(cout) // 4) * 4)
    return code >> 16, code & 0xFFFF


def matmul_fp32_plain(y: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """matmul_fp32's function: ``y @ w`` in fp32 with TF32 off, then ``+
    bias``."""
    with no_tf32():
        out = y @ w
    return out if bias is None else out + bias


def matmul_fp32(y: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 y [..., K] @ w [K, N] (+ bias [N]) → [..., N], each output one
    FMA chain over K: on the card conv_fp32 as a 1x1 convolution over y's
    rows (a launch of its kernel, the bias added in its epilogue), whose
    sums do not depend on the number of rows, as cuBLAS's split-K choices
    do; on the CPU :func:`matmul_fp32_plain`. Differentiable where an input
    requires grad."""
    if _check("matmul_fp32", y, w, torch.float32, bias):
        return matmul_fp32_plain(y, w, bias)
    rows = conv_fp32(y.reshape(-1, 1, 1, y.shape[-1]), w.t()[:, :, None, None], offset=bias)
    return rows.reshape(y.shape[:-1] + (w.shape[1],))


conv_bf16.launches = 0
conv_fp32.launches = 0
