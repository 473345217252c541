"""Multi-head attention (counterpart of leclip_tpu/ops/attention.py): the
single attention entry point of every tower, with the JAX package's routes.

* ``xla``      — plain PyTorch math (the JAX package leaves it to XLA);
* ``resident`` — the resident-head kernel on packed q/k/v
  (:func:`leclip_tpu_torch.ops.flash_attention.resident_attention`);
* ``pallas``   — the flash-attention kernel over [B, H, T, D]
  (:func:`leclip_tpu_torch.ops.flash_attention.flash_attention`).

``impl="auto"`` follows the JAX rule with "on the TPU" read as "on a CUDA
device" (:func:`attention_route`); on the CPU it is always ``xla``.
:func:`attention_core` is the JAX package's attention over [B, H, T, Dh]
heads (called alone only by the RN attention pool's full map): the plain
math, or ``flash_attention`` under "pallas" (by itself at T ≥ 8192 on the
card). Weights use the packed-QKV ``[in, out]`` layout of
the JAX package: ``{qkv_kernel [D,3D], qkv_bias [3D], out_kernel [D,D],
out_bias [D]}``.

Note the scaling point: the plain path scales q BEFORE the QK product, as
``_attention_bthd`` does, while the kernels scale the product afterwards.
Each is kept as written.

Unlike the JAX package, a forced ``impl="resident"`` with a mask raises: the
resident kernel takes no mask, and dropping a causal mask would change the
result silently."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .flash_attention import flash_attention, resident_attention

IMPLS = ("auto", "xla", "resident", "pallas")
# the JAX rule: flash attention engages by itself only where the [T, T]
# logits become a memory hazard
_PALLAS_MIN_SEQ = 8192


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and fp32 result (einsum with
    ``preferred_element_type=float32``): operands upcast, products exact."""
    return a.float() @ b.float()


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's dtype promotion (bf16 with fp32 → fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def attention_route(impl: str, t: int, hd: int, has_mask: bool, device_type: str) -> str:
    """The route ``impl`` takes for sequence length ``t``, head width ``hd``
    and a mask or none, on a device of ``device_type``. Under "auto", on a
    CUDA device: the resident kernel without a mask at T % 8 == 0, T ≥ 128,
    hd == 64; flash attention at T ≥ 8192; else (and always on the CPU) the
    plain math."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    on_card = device_type == "cuda"
    if on_card and not has_mask and t % 8 == 0 and t >= 128 and hd == 64:
        return "resident"
    return "pallas" if on_card and t >= _PALLAS_MIN_SEQ else "xla"


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mask: Optional[torch.Tensor] = None, impl: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention over [B, H, T, Dh] with an optional
    additive [T, T] mask. "pallas" runs the flash-attention kernel; "auto"
    picks it on a CUDA device at T ≥ 8192 and else, like every other impl
    (as in the JAX function), the plain math: fp32 logits of the scaled q,
    stored in bf16 for bf16 inputs, an fp32 softmax, probabilities cast to
    v's dtype before the second product."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        on_card = q.device.type == "cuda"
        impl = "pallas" if on_card and q.shape[-2] >= _PALLAS_MIN_SEQ else "xla"
    if impl == "pallas":
        return flash_attention(q, k, v, mask=mask)
    store = q.dtype if q.dtype == torch.bfloat16 else torch.float32
    logits = _mm32(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits.to(store).float(), dim=-1)
    return _matmul(probs.to(v.dtype), v)


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
                         mask: Optional[torch.Tensor] = None, impl: str = "auto",
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """Self-attention over [B, T, D] with packed-QKV parameters. ``kv_len``
    marks trailing KEY positions as padding (pad query rows compute values
    the caller slices off)."""
    qkv = _matmul(x, params["qkv_kernel"]) + params["qkv_bias"]
    return attention_from_qkv(qkv, params, n_heads, mask=mask, impl=impl, kv_len=kv_len)


def attention_from_qkv(qkv: torch.Tensor, params: dict, n_heads: int, *,
                       mask: Optional[torch.Tensor] = None, impl: str = "auto",
                       kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention core + output projection from packed [B, T, 3D] QKV."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    q, k, v = qkv.split(d, dim=-1)
    route = attention_route(impl, t, hd, mask is not None, qkv.device.type)
    if route == "resident":
        if mask is not None:
            raise ValueError("attention impl 'resident' takes no mask (pad keys go through "
                             "kv_len); run a masked attention with impl 'xla' or 'pallas'")
        out = resident_attention(q, k, v, n_heads, kv_len)
        return _matmul(out, params["out_kernel"]) + params["out_bias"]
    if kv_len is not None and kv_len < t:
        pad = torch.where(torch.arange(t, device=qkv.device) < kv_len, 0.0, -1e30)
        mask = pad if mask is None else mask + pad
    if route == "pallas":
        def heads(y):
            return y.reshape(b, t, n_heads, hd).transpose(1, 2)

        out = flash_attention(heads(q), heads(k), heads(v), mask=mask)
        out = out.transpose(1, 2).reshape(b, t, d)
    else:
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
