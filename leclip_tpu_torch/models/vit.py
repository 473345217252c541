"""CLIP VisionTransformer, NHWC (counterpart of leclip_tpu/models/vit.py),
with the dense output mode (all projected patch tokens). Patchify is a
reshape plus one matmul, equivalent to the stride-p conv."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.tracing import span
from .transformer import init_block_stack, layer_norm, run_transformer


def patchify(x: torch.Tensor, kernel: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] → [B, (H/p)*(W/p), width] via reshape + matmul; the
    kernel rows are in (p, p, c) order."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, patch * patch * c)
    return x @ kernel.to(x.dtype)


def encode_image_vit(x: torch.Tensor, params: dict, n_heads: int, patch: int,
                     dense: bool = False, impl: str = "auto", q8: dict = None,
                     fused: bool = False):
    """Images [B, H, W, 3] → global [B, E] (and dense [B, P, E]). The token
    axis is padded once to a multiple of 8 (197 → 200 at 224²); pad keys are
    masked through ``kv_len`` and pad query rows sliced off. ``q8``: stacked
    int8 block weights (ops/quant.py), the W8A8 path; ``fused`` runs the bf16
    block kernels (ops/block_kernels.py); ``impl`` routes the unfused
    attention (ops/attention.py). With spans on, the blocks are the
    device-timed span ``score.blocks``."""
    tokens = patchify(x, params["patch_kernel"], patch)
    b, n, width = tokens.shape
    cls = params["class_embedding"].to(x.dtype).expand(b, 1, width)
    tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + params["positional_embedding"][: n + 1].to(x.dtype)
    tokens = layer_norm(tokens, params["ln_pre"]["scale"], params["ln_pre"]["bias"])
    n_real = n + 1
    t_pad = (-n_real) % 8
    if t_pad:
        tokens = F.pad(tokens, (0, 0, 0, t_pad))
    with span("score.blocks", device=True):
        tokens = run_transformer(tokens, params["blocks"], n_heads, impl=impl,
                                 kv_len=n_real if t_pad else None, q8=q8, fused=fused)
    if t_pad:
        tokens = tokens[:, :n_real]
    tokens = layer_norm(tokens, params["ln_post"]["scale"], params["ln_post"]["bias"])
    proj = params["proj"].to(x.dtype)
    g = tokens[:, 0] @ proj
    if dense:
        return g, tokens[:, 1:] @ proj
    return g


def init_vit_params(generator: torch.Generator, input_resolution: int, patch_size: int,
                    width: int, layers: int, output_dim: int, dtype=torch.float32,
                    device=None) -> dict:
    scale = width ** -0.5
    grid = input_resolution // patch_size
    fan_in = patch_size * patch_size * 3

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    def ln():
        return {"scale": torch.ones(width, dtype=dtype, device=device),
                "bias": torch.zeros(width, dtype=dtype, device=device)}

    return {
        "patch_kernel": normal((fan_in, width), (2.0 / fan_in) ** 0.5),
        "class_embedding": normal((width,), scale),
        "positional_embedding": normal((grid * grid + 1, width), scale),
        "ln_pre": ln(),
        "blocks": init_block_stack(generator, layers, width, dtype, device),
        "ln_post": ln(),
        "proj": normal((width, output_dim), scale),
    }
