"""Fused bf16 transformer sub-blocks (inference): hand-written Hopper kernels
and their plain PyTorch versions.

* ``attn_block_bf16`` — x + OutProj(MHA(LN(x)·W_qkv + b_qkv)).
  Replaces leclip_tpu/ops/block_kernels.py ``attn_block_bf16``
  (``_attn_block_bf16_kernel``). CUDA source: ``csrc/attn_block_bf16.cu``.
* ``mlp_bf16`` — x + QuickGELU(LN(x)·W_fc + b_fc)·W_proj + b_proj.
  Replaces leclip_tpu/ops/block_kernels.py ``mlp_bf16``
  (``_mlp_bf16_kernel``). CUDA source: ``csrc/mlp_bf16.cu``.

What bounds them on the H100, and what the design does about it, is in the
note at the top of each source. In short: both are bound by tensor-core
operations at the ViT-B/16 and caption-bank shapes. Each block first takes
the LayerNorm once per row in its own launch (``csrc/layernorm.cuh``, the
row statistics shared with ``ln_quant``), writing bf16(LN(x)), the TPU
kernels' rounding point; every product then runs through one Hopper GEMM
(``csrc/gemm_sm90.cuh``: wgmma fed by TMA, one persistent warp-specialised
block per SM) with the bias / GELU / residual applied in its epilogue, and
the attention core keeps its scores in registers (``csrc/attn_core.cuh``).
The attention block is four launches (LN, QKV, per-head attention,
out-proj+residual) and the MLP three (LN, fc+GELU, proj+residual); LN(x),
the bf16 qkv, per-head outputs and MLP hidden go through HBM, at exactly the
points where the TPU kernels round them — later PRs fuse that traffic away.

Each wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. The kernels
are forward-only: under grad mode, an input that requires grad makes every
wrapper raise, on both devices (:func:`refuse_grad`), since a launch on
``data_ptr()`` would hand back an output with no gradient. ``launches``
on each wrapper counts the calls that launched the kernel (ops/launches.py
reads and resets the counts of every kernel).

The CUDA kernels take widths D % 128 == 0 up to 1024 (every CLIP tower:
512, 640, 768, 1024), head width 32, 64 or 128, any row count, and tensors
whose data start on a 16-byte boundary (TMA and 16-byte copies). Where they
run is still decided by the TPU kernels' VMEM gates (:func:`fits_vmem_attn`,
:func:`fits_vmem_mlp`, copied here): the fused residual block of
models/transformer.py takes them so that it computes the numbers the JAX
reference computes, which runs the unfused XLA block where a gate fails."""

from __future__ import annotations

import torch

from . import _build


# The JAX package's VMEM budget (leclip_tpu/ops/block_kernels.py
# _VMEM_BUDGET_BYTES). The card has no such limit; the gates below only say
# where the reference runs its fused kernels, and so which rounding points
# the port must keep.
_VMEM_BUDGET_BYTES = 12 * 1024 * 1024


def fits_vmem_attn(d: int) -> bool:
    """Whether the reference fuses the attention sub-block at width ``d``:
    bf16 QKV [D, 3D] + out [D, D] weights within its VMEM budget."""
    return 2 * (d * 3 * d + d * d) <= _VMEM_BUDGET_BYTES


def fits_vmem_mlp(d: int, hidden: int) -> bool:
    """Whether the reference fuses the MLP sub-block: bf16 fc [D, H] + proj
    [H, D] weights within its VMEM budget (D <= 886 at H = 4D)."""
    return 2 * (2 * d * hidden) <= _VMEM_BUDGET_BYTES


# ------------------------------ plain versions -------------------------------


def _ln32(x32: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """fp32 LayerNorm statistics exactly as the TPU kernels write them."""
    m = x32.mean(-1, keepdim=True)
    c = x32 - m
    v = (c * c).mean(-1, keepdim=True)
    y = c * torch.rsqrt(v + eps)
    return y * scale.float() + bias.float()


def attention_plain(qkv: torch.Tensor, b: int, t: int, n_heads: int, kv_len: int,
                    causal: bool) -> torch.Tensor:
    """The attention core shared by the bf16 and int8 blocks, on packed qkv
    [B·T, 3D] in its working dtype: fp32 scores scaled by dh^-0.5 AFTER QKᵀ
    plus a −1e30 bias on masked keys; p = exp(s − max) rounded unnormalised;
    the denominator is Σp in fp32 (the ones-column of p·[V|1]); each head's
    output rounded. Returns the packed heads [B·T, D]."""
    d = qkv.shape[-1] // 3
    dh = d // n_heads
    dt = qkv.dtype
    qkv = qkv.reshape(b, t, 3, n_heads, dh).permute(2, 0, 3, 1, 4)  # [3, B, H, T, dh]
    q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()
    col = torch.arange(t, device=qkv.device)
    valid = col[None, :] < kv_len
    if causal:
        valid = valid & (col[None, :] <= col[:, None])
    kbias = torch.where(valid, 0.0, -1e30).to(torch.float32).expand(t, t)
    sc = (q @ k.transpose(-1, -2)) * dh**-0.5 + kbias
    p = torch.exp(sc - sc.amax(-1, keepdim=True)).to(dt).float()
    num = p @ v
    den = p.sum(-1, keepdim=True)
    return (num / den).to(dt).permute(0, 2, 1, 3).reshape(b * t, d)


def attn_block_bf16_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                          n_heads: int, kv_len=None, causal: bool = False,
                          eps: float = 1e-5) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch, same rounding points:
    LN(x) and qkv rounded to x.dtype; the attention core of
    :func:`attention_plain`; fp32 out-proj; the residual sum rounded once."""
    b, t, d = x.shape
    if kv_len is None:
        kv_len = t
    dt = x.dtype
    x32 = x.float()
    y = _ln32(x32, ln_scale, ln_bias, eps)
    qkv = (y.to(dt).reshape(b * t, d).float() @ qkv_w.float() + qkv_b.float()).to(dt)
    att = attention_plain(qkv, b, t, n_heads, kv_len, causal)
    out = (att.float() @ out_w.float()).reshape(b, t, d)
    return (x32 + out + out_b.float()).to(dt)


def mlp_bf16_plain(x, ln_scale, ln_bias, fc_w, fc_b, pj_w, pj_b,
                   eps: float = 1e-5) -> torch.Tensor:
    """The TPU kernel's arithmetic: fp32 LN, LN(x) rounded to x.dtype, fp32
    fc + bias + QuickGELU, hidden rounded, fp32 proj + bias, residual rounded
    once."""
    shape = x.shape
    d = shape[-1]
    dt = x.dtype
    x32 = x.reshape(-1, d).float()
    y = _ln32(x32, ln_scale, ln_bias, eps)
    h = y.to(dt).float() @ fc_w.float() + fc_b.float()
    h = h * torch.sigmoid(1.702 * h)
    o = h.to(dt).float() @ pj_w.float() + pj_b.float()
    return (x32 + o).to(dt).reshape(shape)


# --------------------------------- wrappers ----------------------------------


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.bfloat16) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must start on a 16-byte boundary")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where autograd would want a gradient through a forward-only
    kernel: grad mode is on and an input requires grad. Without this, the
    CUDA launch would return an output with no ``grad_fn`` (the gradient
    silently dropped), while the CPU's plain version would differentiate."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: the kernel is forward-only and an input requires "
                           "grad; call it under torch.no_grad() (the JAX kernel has no "
                           "VJP either)")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def attn_block_bf16(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                    n_heads: int, kv_len=None, causal: bool = False,
                    eps: float = 1e-5) -> torch.Tensor:
    """x + OutProj(Attention(QKV(LN(x)))) over [B, T, D]; weights [D, 3D] /
    [D, D] in [in, out] layout. ``kv_len`` masks trailing pad keys;
    ``causal`` adds the lower-triangular mask."""
    args = (x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b)
    refuse_grad("attn_block_bf16", *args)
    if x.device.type == "cpu":
        return attn_block_bf16_plain(*args, n_heads, kv_len=kv_len, causal=causal, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"attn_block_bf16: unsupported device {x.device}")
    b, t, d = x.shape
    kv_len = t if kv_len is None else int(kv_len)
    dh = d // n_heads
    if d % 128 or d > 1024 or dh * n_heads != d or dh not in (32, 64, 128):
        raise ValueError(f"attn_block_bf16: CUDA kernel needs D % 128 == 0, D <= 1024 and "
                         f"head width 32/64/128, got D={d}, heads={n_heads}")
    if not 1 <= kv_len <= t:
        raise ValueError(f"attn_block_bf16: kv_len {kv_len} outside [1, {t}]")
    dev = x.device
    for name, ten, shape in (
        ("x", x, (b, t, d)), ("ln_scale", ln_scale, (d,)), ("ln_bias", ln_bias, (d,)),
        ("qkv_w", qkv_w, (d, 3 * d)), ("qkv_b", qkv_b, (3 * d,)),
        ("out_w", out_w, (d, d)), ("out_b", out_b, (d,)),
    ):
        _check(f"attn_block_bf16 {name}", ten, shape, dev)
    lib = _build.load("attn_block_bf16")
    smem = lib.leclip_attn_core_smem(t, dh)
    if smem > 232448:
        raise ValueError(f"attn_block_bf16: T={t} needs {smem} B of shared memory, "
                         "above the card's 227 KB")
    qkv = torch.empty((b * t, 3 * d), dtype=x.dtype, device=dev)
    att = torch.empty((b * t, d), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    rc = lib.leclip_attn_block_bf16(
        *(a.data_ptr() for a in args), qkv.data_ptr(), att.data_ptr(), out.data_ptr(),
        b, t, d, n_heads, kv_len, int(bool(causal)), float(eps), _stream(dev),
    )
    _raise_on(rc, "attn_block_bf16")
    attn_block_bf16.launches += 1
    return out


attn_block_bf16.launches = 0


def mlp_bf16(x, ln_scale, ln_bias, fc_w, fc_b, pj_w, pj_b,
             eps: float = 1e-5) -> torch.Tensor:
    """x + MLP(LN(x)) over [..., D]; fc [D, H], proj [H, D] in [in, out]
    layout. Rows are independent, so any leading shape is flattened."""
    args = (x, ln_scale, ln_bias, fc_w, fc_b, pj_w, pj_b)
    refuse_grad("mlp_bf16", *args)
    if x.device.type == "cpu":
        return mlp_bf16_plain(*args, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_bf16: unsupported device {x.device}")
    d = x.shape[-1]
    hidden = fc_w.shape[-1]
    if d % 128 or d > 1024 or hidden % 128:
        raise ValueError(f"mlp_bf16: CUDA kernel needs D % 128 == 0, D <= 1024 and "
                         f"hidden % 128 == 0, got D={d}, hidden={hidden}")
    dev = x.device
    rows = x.numel() // d
    for name, ten, shape in (
        ("x", x, x.shape), ("ln_scale", ln_scale, (d,)), ("ln_bias", ln_bias, (d,)),
        ("fc_w", fc_w, (d, hidden)), ("fc_b", fc_b, (hidden,)),
        ("pj_w", pj_w, (hidden, d)), ("pj_b", pj_b, (d,)),
    ):
        _check(f"mlp_bf16 {name}", ten, shape, dev)
    lib = _build.load("mlp_bf16")
    out = torch.empty_like(x)
    hid = torch.empty((rows, hidden), dtype=x.dtype, device=dev)
    rc = lib.leclip_mlp_bf16(
        *(a.data_ptr() for a in args), out.data_ptr(), hid.data_ptr(), rows, d, hidden,
        float(eps), _stream(dev),
    )
    _raise_on(rc, "mlp_bf16")
    mlp_bf16.launches += 1
    return out


mlp_bf16.launches = 0
