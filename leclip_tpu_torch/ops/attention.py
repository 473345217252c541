"""Multi-head attention, plain path (counterpart of leclip_tpu/ops/attention.py).

The unfused towers (the fp32 prompt-feature pass, the fp32 caption bank and
fp32 TTA) come through here. Weights use the packed-QKV ``[in, out]`` layout
of the JAX package: ``{qkv_kernel [D,3D], qkv_bias [3D], out_kernel [D,D],
out_bias [D]}``.

Note the scaling point: this path scales q BEFORE the QK product, as
``_attention_bthd`` does, while the fused kernel (ops/block_kernels.py)
scales the product afterwards. Each is kept as written.

Not ported: the TPU-only ``resident`` and ``pallas`` (flash) routes, which
are kernels of their own (ROADMAP.md queue 2)."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and fp32 result (einsum with
    ``preferred_element_type=float32``): operands upcast, products exact."""
    return a.float() @ b.float()


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's dtype promotion (bf16 with fp32 → fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _attention_bthd(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Attention over [B, T, H, Dh]. bf16 inputs get the bf16-storage softmax
    of the JAX path (logits stored bf16, max/sum in fp32)."""
    scale = q.shape[-1] ** -0.5
    logits = _mm32((q * scale).permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))  # [B,H,Tq,Tk]
    if mask is not None:
        logits = logits + mask.float()
    if q.dtype == torch.bfloat16:
        logits = logits.to(torch.bfloat16)
        m = logits.amax(-1, keepdim=True)
        e = torch.exp((logits - m).float()).to(torch.bfloat16)
        s = e.float().sum(-1, keepdim=True)
        probs = e / s.to(torch.bfloat16)
    else:
        probs = torch.softmax(logits, dim=-1)
    out = _matmul(probs.to(v.dtype), v.permute(0, 2, 1, 3))  # [B,H,T,Dh]
    return out.permute(0, 2, 1, 3)


def multi_head_attention(x: torch.Tensor, params: dict, n_heads: int, *,
                         mask: Optional[torch.Tensor] = None,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """Self-attention over [B, T, D] with packed-QKV parameters. ``kv_len``
    marks trailing KEY positions as padding (pad query rows compute values
    the caller slices off)."""
    qkv = _matmul(x, params["qkv_kernel"]) + params["qkv_bias"]
    return attention_from_qkv(qkv, params, n_heads, mask=mask, kv_len=kv_len)


def attention_from_qkv(qkv: torch.Tensor, params: dict, n_heads: int, *,
                       mask: Optional[torch.Tensor] = None,
                       kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention core + output projection from packed [B, T, 3D] QKV."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    q, k, v = qkv.split(d, dim=-1)
    if kv_len is not None and kv_len < t:
        pad = torch.where(torch.arange(t, device=qkv.device) < kv_len, 0.0, -1e30)
        mask = pad if mask is None else mask + pad
    out = _attention_bthd(
        q.reshape(b, t, n_heads, hd), k.reshape(b, t, n_heads, hd),
        v.reshape(b, t, n_heads, hd), mask,
    ).reshape(b, t, d)
    return _matmul(out, params["out_kernel"]) + params["out_bias"]


@functools.lru_cache()
def _causal_mask_np(context_length: int) -> np.ndarray:
    mask = np.full((context_length, context_length), -np.inf, np.float32)
    return np.triu(mask, k=1)


def causal_mask(context_length: int, device=None) -> torch.Tensor:
    """Additive causal mask (upper triangle = -inf), as the text tower uses."""
    return torch.from_numpy(_causal_mask_np(context_length)).to(
        "cpu" if device is None else device)
