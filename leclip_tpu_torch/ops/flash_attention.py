"""The unfused attention kernels (counterpart of leclip_tpu/ops/flash_attention.py):
hand-written Hopper kernels and their plain PyTorch versions.

* ``resident_attention`` — softmax attention per head of PACKED q/k/v
  ``[B, T, H·64]``, trailing keys ≥ ``kv_len`` masked. Replaces
  ``resident_attention`` (``_resident_call`` / ``_resident_kernel``). CUDA
  source: ``csrc/resident_attention.cu`` (bf16: the attention core of the
  block kernels; fp32: a CUDA-core core, no TF32). A
  ``torch.autograd.Function``: the backward pass recomputes
  :func:`packed_attention_reference` and returns its vector-Jacobian
  product, as ``_resident_bwd`` does.
* ``flash_attention`` — online-softmax attention over ``[B, H, T, D]`` with
  an additive mask. Replaces ``flash_attention`` (``_flash_attention_padded``:
  ``_flash_kernel_single`` / ``_flash_kernel``). CUDA source:
  ``csrc/flash_attention.cu`` (bf16: mma.sync on the tensor cores,
  ``csrc/flash_mma.cuh``; fp32: the CUDA-core loops of ``csrc/attn_simt.cuh``
  it shares with ``resident_attention``, no TF32).

Each plain version repeats its TPU kernel's rounding points (see the
functions), and each CUDA kernel rounds at the same points. Each wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises, and ``launches`` counts those launches. The
CUDA kernels take fp32 or bf16, head width 64 (every CLIP preset's), and:
``resident_attention`` T % 8 == 0 (the JAX rule) up to what fits shared
memory (fp32: kv_len ≤ 1180, bf16: T ≤ 832; the wrapper raises with the
limit); ``flash_attention`` any T, keys streamed in blocks."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .block_kernels import _raise_on, _stream, attention_plain, refuse_grad

NEG_INF = -1e30
BLOCK_K = 256  # the TPU wrapper's default key block, where its rounding regimes split
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100
_DTYPES = (torch.float32, torch.bfloat16)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check_operands(name: str, q, k, v) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: the CUDA kernel takes fp32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v on {q.device}/{k.device}/{v.device}")


# ---------------------------- resident attention -----------------------------


def resident_attention_plain(q, k, v, n_heads: int, kv_len: Optional[int] = None):
    """The TPU kernel's arithmetic on packed ``[B, T, W]``: s = (q·kᵀ)·dh^-0.5
    in fp32, keys ≥ kv_len masked before the max, p = exp(s − max) rounded
    to v.dtype unnormalised, out = (p·v)/(p·1) with both sums over the
    rounded p in fp32, rounded to q.dtype — the attention core of the block
    kernels (block_kernels.attention_plain), without a causal mask."""
    b, t, w = q.shape
    kv_len = t if kv_len is None else int(kv_len)
    qkv = torch.cat([q, k, v], dim=-1).reshape(b * t, 3 * w)
    return attention_plain(qkv, b, t, n_heads, kv_len, causal=False).reshape(b, t, w)


def packed_attention_reference(q, k, v, n_heads: int, kv_len: Optional[int] = None):
    """Reference math on the packed layout (``_xla_packed_attention``), the
    recompute of the backward pass: q scaled BEFORE the product, fp32
    scores, keys ≥ kv_len at −1e30, fp32 softmax, p cast to v.dtype."""
    b, t, w = q.shape
    dh = w // n_heads
    kv_len = t if kv_len is None else int(kv_len)

    def heads(x):
        return x.reshape(b, t, n_heads, dh).transpose(1, 2)  # [B, H, T, dh]

    s = (heads(q) * dh ** -0.5).float() @ heads(k).float().transpose(-1, -2)
    if kv_len < t:
        s = torch.where(torch.arange(t, device=q.device) < kv_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = p.to(v.dtype) @ heads(v)
    return o.transpose(1, 2).reshape(b, t, w).to(q.dtype)


def _packed_qkv(q, k, v) -> torch.Tensor:
    """One ``[B, T, 3W]`` buffer holding q | k | v: the buffer itself when
    q, k, v are its three thirds (as ``attention_from_qkv`` splits them),
    else a copy."""
    b, t, w = q.shape
    es = q.element_size()
    base = q.data_ptr()
    views = (q.stride() == (t * 3 * w, 3 * w, 1) and k.stride() == q.stride()
             and v.stride() == q.stride() and k.data_ptr() == base + w * es
             and v.data_ptr() == base + 2 * w * es and base % 16 == 0)
    return q if views else torch.cat([q, k, v], dim=-1)


def _resident_forward(q, k, v, n_heads: int, kv_len: Optional[int]) -> torch.Tensor:
    if q.device.type == "cpu":
        return resident_attention_plain(q, k, v, n_heads, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"resident_attention: unsupported device {q.device}")
    _check_operands("resident_attention", q, k, v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"resident_attention: q/k/v shapes {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)} differ")
    b, t, w = q.shape
    kv_len = t if kv_len is None else int(kv_len)
    if w != 64 * n_heads:
        raise ValueError(f"resident_attention: the CUDA kernel takes head width 64, got "
                         f"W={w} over {n_heads} heads")
    if t % 8:
        raise ValueError(f"resident_attention: T must be a multiple of 8, got {t}")
    if not 1 <= kv_len <= t:
        raise ValueError(f"resident_attention: kv_len {kv_len} outside [1, {t}]")
    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = _build.load("resident_attention")
    smem = lib.leclip_resident_smem(t, kv_len, is_bf16)
    if smem > SMEM_LIMIT:
        raise ValueError(f"resident_attention: T={t}, kv_len {kv_len} in {q.dtype} needs {smem} "
                         f"B of shared memory, above the card's {SMEM_LIMIT} B")
    qkv = _packed_qkv(q, k, v)
    out = torch.empty((b, t, w), dtype=q.dtype, device=q.device)
    rc = lib.leclip_resident_attention(qkv.data_ptr(), out.data_ptr(), b, t, w, n_heads,
                                       kv_len, is_bf16, _stream(q.device))
    _raise_on(rc, "resident_attention")
    resident_attention.launches += 1
    return out


class _ResidentAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_heads, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.n_heads, ctx.kv_len = n_heads, kv_len
        return _resident_forward(q, k, v, n_heads, kv_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [a.detach().requires_grad_() for a in (q, k, v)]
            out = packed_attention_reference(*qkv, ctx.n_heads, ctx.kv_len)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None)


def resident_attention(q, k, v, n_heads: int, kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention over packed heads ``[B, T, H·Dh]`` → ``[B, T, H·Dh]``;
    ``kv_len`` masks trailing pad keys (pad query rows compute values the
    caller slices off). Differentiable: the backward pass recomputes
    :func:`packed_attention_reference`."""
    return _ResidentAttention.apply(q, k, v, n_heads, kv_len)


resident_attention.launches = 0


# ------------------------------ flash attention ------------------------------


def flash_block_k(tk: int) -> int:
    """The TPU wrapper's key block for Tk keys: a multiple of 128, at least
    128, at most ``BLOCK_K``. One key block (every CLIP length ≤ 256) or
    several (ViT-L/14's 264) decides the rounding regime."""
    return _round_up(max(128, min(BLOCK_K, _round_up(tk, 128))), 128)


def flash_attention_plain(q, k, v, mask=None):
    """The TPU kernel's arithmetic over ``[B, H, T, D]``: keys zero-padded to
    a multiple of the key block (:func:`flash_block_k`) with a −1e30 bias,
    the mask clamped at −1e30; s = (q·kᵀ)·scale + bias in fp32. One key
    block: p = exp(s − max), l = Σp in fp32, p/l rounded to v.dtype, then
    p·v. Several: per block the
    running max m and corr = exp(m_prev − m), l = l·corr + Σp (fp32 p),
    acc = acc·corr + round(p)·v, out = acc / l."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    block_k = flash_block_k(tk)
    tk_p = _round_up(tk, block_k)
    kf = F.pad(k.float(), (0, 0, 0, tk_p - tk))
    vp = F.pad(v, (0, 0, 0, tk_p - tk))
    bias = torch.zeros((tq, tk_p), dtype=torch.float32, device=q.device)
    if mask is not None:
        mk = torch.as_tensor(mask, device=q.device).float()
        bias[:, :tk] = torch.broadcast_to(mk, (tq, tk)).clamp(min=NEG_INF)
    bias[:, tk:] = NEG_INF
    s = (q.float() @ kf.transpose(-1, -2)) * d ** -0.5 + bias
    if tk_p == block_k:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = (p / p.sum(-1, keepdim=True)).to(v.dtype).float() @ vp.float()
        return o.to(q.dtype)
    m = torch.full((b, h, tq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, tq, d), device=q.device)
    for j in range(0, tk_p, block_k):
        sj = s[..., j:j + block_k]
        m_cur = torch.maximum(m, sj.amax(-1, keepdim=True))
        corr = torch.exp(m - m_cur)
        p = torch.exp(sj - m_cur)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vp[..., j:j + block_k, :].float()
        m = m_cur
    return (acc / l).to(q.dtype)


def _flash_mask(mask, tq: int, tk: int, device):
    """(fp32 mask on the card, its rows): None, a [tk] vector that every row
    shares (rows 0), or the [tq, tk] matrix the mask broadcasts to."""
    if mask is None:
        return None, 0
    m = torch.broadcast_to(torch.as_tensor(mask, device=device).float(), (tq, tk))
    if m.stride(0) == 0:
        return m[0].contiguous(), 0
    return m.contiguous(), tq


def flash_attention(q, k, v, mask=None) -> torch.Tensor:
    """Attention over ``[B, H, T, D]``; ``mask`` is an additive float mask
    broadcastable to ``[Tq, Tk]`` (e.g. causal, or a ``[Tk]`` pad-key row).
    Any 16-byte-aligned strides with a contiguous head dim go to the kernel
    as they are (others raise); the result is a ``[B, H, Tq, D]`` view of a
    ``[B, Tq, H, D]`` buffer. Forward-only: an input that requires grad
    under grad mode raises (``block_kernels.refuse_grad``)."""
    refuse_grad("flash_attention", q, k, v, mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_operands("flash_attention", q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d != 64:
        raise ValueError(f"flash_attention: the CUDA kernel takes head width 64 (every CLIP "
                         f"preset's), got D={d}")
    if tuple(k.shape) != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    lib = _build.load("flash_attention")
    if q.stride(-1) != 1:
        q = q.contiguous()
    if k.stride(-1) != 1 or v.stride() != k.stride():
        k, v = k.contiguous(), v.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16 or any(st * x.element_size() % 16 for st in x.stride()[:3]):
            raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary with "
                             f"16-byte-aligned (sequence, head, row) strides (the kernels copy "
                             f"16-byte rows), got strides {tuple(x.stride())}")
    mask_t, rows = _flash_mask(mask, tq, tk, q.device)
    is_bf16 = q.dtype == torch.bfloat16
    scratch = None  # bf16 with a [tq, tk] mask: its class map (csrc/flash_mma.cuh)
    if is_bf16 and rows:
        scratch = torch.empty(lib.leclip_flash_scratch_bytes(tq, tk), dtype=torch.uint8,
                              device=q.device)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    rc = lib.leclip_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if mask_t is None else mask_t.data_ptr(),
        None if scratch is None else scratch.data_ptr(), rows, b, h, tq, tk, flash_block_k(tk),
        *q.stride()[:3], *k.stride()[:3], *out.stride()[:3], int(is_bf16), _stream(q.device))
    _raise_on(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
