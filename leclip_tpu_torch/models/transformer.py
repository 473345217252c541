"""Shared transformer machinery (counterpart of leclip_tpu/models/transformer.py):
pre-LN residual blocks over [B, T, D], layers stacked along a leading axis
and applied by a Python loop (the JAX package's ``lax.scan``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import _matmul, multi_head_attention


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, result cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x) — NOT exact GELU."""
    return x * torch.sigmoid(1.702 * x)


def _mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = layer_norm(x, p["ln_2"]["scale"], p["ln_2"]["bias"])
    h = quick_gelu(_matmul(y, p["mlp"]["fc_kernel"]) + p["mlp"]["fc_bias"])
    return x + (_matmul(h, p["mlp"]["proj_kernel"]) + p["mlp"]["proj_bias"])


def residual_block(x: torch.Tensor, p: dict, n_heads: int,
                   mask: Optional[torch.Tensor] = None, impl: str = "auto", kv_len=None,
                   q8: Optional[dict] = None, causal: bool = False,
                   fused: bool = False) -> torch.Tensor:
    """One pre-LN residual attention block over [B, T, D].

    ``q8`` (inference only) is this layer's int8 weights (ops/quant.py) and
    runs the W8A8 kernels (ops/quant_kernels.py): LN + int8 QKV + bf16
    attention and out-projection, then the whole MLP with both products in
    int8. ``fused`` (inference only) runs the two bf16 block kernels
    (ops/block_kernels.py) where the JAX reference runs its own: the
    attention kernel where ``fits_vmem_attn(D)`` holds, the MLP kernel where
    ``fits_vmem_mlp(D, H)`` holds and B·T % 8 == 0; each sub-block that
    fails its gate runs the unfused bf16 math instead (ViT-L/14's 1024-wide
    MLP). ``causal`` marks ``mask`` as the standard lower-triangular mask so
    the kernels apply it natively. Without either the block is the unfused
    math, its attention routed by ``impl`` (ops/attention.py: "auto", "xla",
    "resident" or "pallas"), which the q8 branch and the fused kernels
    ignore."""
    if q8 is not None:
        if mask is not None and not causal:
            raise ValueError(
                "int8 (q8) blocks support unmasked or causal self-attention "
                "only; arbitrary additive masks must run the bf16 path"
            )
        from ..ops.quant_kernels import attn_block_int8, mlp_int8

        # q8's ln1/ln2 are the channel-equilibrated LN affines (quant.py
        # _equilibrate): they REPLACE p's, paired with the rescaled kernels
        x = attn_block_int8(
            x, *q8["ln1"],
            *q8["attn"]["qkv"], p["attn"]["qkv_bias"],
            p["attn"]["out_kernel"], p["attn"]["out_bias"],
            n_heads, kv_len=kv_len, causal=causal,
        )
        return mlp_int8(
            x, *q8["ln2"],
            *q8["mlp"]["fc"], p["mlp"]["fc_bias"],
            *q8["mlp"]["proj"], p["mlp"]["proj_bias"],
        )
    attn_kernel = mlp_kernel = False
    if fused and (mask is None or causal):
        from ..ops.block_kernels import attn_block_bf16, fits_vmem_attn, fits_vmem_mlp, mlp_bf16

        d, hidden = x.shape[-1], p["mlp"]["fc_kernel"].shape[-1]
        attn_kernel = fits_vmem_attn(d)
        mlp_kernel = fits_vmem_mlp(d, hidden) and (x.shape[0] * x.shape[1]) % 8 == 0
    if attn_kernel:
        x = attn_block_bf16(
            x, p["ln_1"]["scale"], p["ln_1"]["bias"],
            p["attn"]["qkv_kernel"], p["attn"]["qkv_bias"],
            p["attn"]["out_kernel"], p["attn"]["out_bias"],
            n_heads, kv_len=kv_len, causal=causal,
        )
    else:
        y = layer_norm(x, p["ln_1"]["scale"], p["ln_1"]["bias"])
        x = x + multi_head_attention(y, p["attn"], n_heads, mask=mask, impl=impl, kv_len=kv_len)
    if mlp_kernel:
        return mlp_bf16(
            x, p["ln_2"]["scale"], p["ln_2"]["bias"],
            p["mlp"]["fc_kernel"], p["mlp"]["fc_bias"],
            p["mlp"]["proj_kernel"], p["mlp"]["proj_bias"],
        )
    return _mlp(x, p)


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked block pytree (nested dicts and tuples)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    if isinstance(stacked, (tuple, list)):
        return tuple(layer_params(v, i) for v in stacked)
    return stacked[i]


def run_transformer(x: torch.Tensor, stacked: dict, n_heads: int,
                    mask: Optional[torch.Tensor] = None, impl: str = "auto",
                    kv_len: Optional[int] = None,
                    q8: Optional[dict] = None, causal: bool = False,
                    fused: bool = False) -> torch.Tensor:
    """Apply the L stacked residual blocks in order. ``q8`` is the stacked
    int8 weight pytree of ops/quant.py ``quantize_block_stack``; layer ``i``
    of it goes with layer ``i`` of ``stacked``."""
    n_layers = stacked["ln_1"]["scale"].shape[0]
    for i in range(n_layers):
        x = residual_block(x, layer_params(stacked, i), n_heads, mask=mask, impl=impl,
                           kv_len=kv_len,
                           q8=None if q8 is None else layer_params(q8, i),
                           causal=causal, fused=fused)
    return x


def init_block_stack(generator: torch.Generator, layers: int, width: int,
                     dtype=torch.float32, device=None) -> dict:
    """L stacked blocks with the reference's init scheme: attn std w^-0.5,
    out/proj std (w^-0.5)(2L)^-0.5, fc std (2w)^-0.5, LN ones/zeros."""
    proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    return {
        "ln_1": {"scale": full((layers, width), 1.0), "bias": full((layers, width), 0.0)},
        "attn": {
            "qkv_kernel": normal((layers, width, 3 * width), attn_std),
            "qkv_bias": full((layers, 3 * width), 0.0),
            "out_kernel": normal((layers, width, width), proj_std),
            "out_bias": full((layers, width), 0.0),
        },
        "ln_2": {"scale": full((layers, width), 1.0), "bias": full((layers, width), 0.0)},
        "mlp": {
            "fc_kernel": normal((layers, width, 4 * width), fc_std),
            "fc_bias": full((layers, 4 * width), 0.0),
            "proj_kernel": normal((layers, 4 * width, width), proj_std),
            "proj_bias": full((layers, width), 0.0),
        },
    }

