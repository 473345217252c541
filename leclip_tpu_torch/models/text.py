"""CLIP text tower (counterpart of leclip_tpu/models/text.py).

* ``encode_text(tokens)``                 → EOT feature [N, E] (argmax convention)
* ``encode_text_embeds(embeds, eot_idx)`` → same, from pre-built embeddings
* ``encode_text_sequence(embeds)``        → all projected positions [N, L, E]

``adapter=`` inserts the bottleneck adapter (models/adapter.py) as a
residual over the transformer output before ln_final (the
AdapterTextEncoder variant, ref Caption_distill_double_adapter.py:99-112)."""

from __future__ import annotations

import torch

from ..ops.attention import causal_mask
from .transformer import init_block_stack, layer_norm, run_transformer


def init_text_params(generator: torch.Generator, vocab_size: int, context_length: int,
                     width: int, layers: int, embed_dim: int, dtype=torch.float32,
                     device=None) -> dict:
    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    return {
        "token_embedding": normal((vocab_size, width), 0.02),
        "positional_embedding": normal((context_length, width), 0.01),
        "blocks": init_block_stack(generator, layers, width, dtype, device),
        "ln_final": {"scale": torch.ones(width, dtype=dtype, device=device),
                     "bias": torch.zeros(width, dtype=dtype, device=device)},
        "text_projection": normal((width, embed_dim), width ** -0.5),
    }


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids [N, L] → embeddings [N, L, W]."""
    return params["token_embedding"][tokens.long()]


def _backbone(params: dict, x: torch.Tensor, n_heads: int, impl: str = "auto",
              q8: dict = None, fused: bool = False, adapter: dict = None) -> torch.Tensor:
    """Embeddings [N, L, W] → post-ln_final features [N, L, W]. ``q8``:
    stacked int8 block weights (ops/quant.py), the W8A8 path with the causal
    mask applied inside the kernels. ``impl`` routes the unfused attention
    (ops/attention.py; "pallas" runs the flash kernel under the causal
    mask)."""
    ctx_len = x.shape[1]
    x = x + params["positional_embedding"][:ctx_len].to(x.dtype)
    # the int8 stack runs in the dtype of its LN affines (bf16 where the
    # card's kernels take it), the embeddings, ln_final and projection in
    # the tower's own
    stack_dtype = x.dtype if q8 is None else q8["ln1"][0].dtype
    x = run_transformer(x.to(stack_dtype), params["blocks"], n_heads,
                        mask=causal_mask(ctx_len, x.device), impl=impl, q8=q8, causal=True,
                        fused=fused).to(x.dtype)
    if adapter is not None:
        from .adapter import apply_adapter

        x = x + apply_adapter(x, adapter)
    return layer_norm(x, params["ln_final"]["scale"], params["ln_final"]["bias"])


def encode_text_sequence(params: dict, embeds: torch.Tensor, n_heads: int,
                         impl: str = "auto", q8: dict = None,
                         fused: bool = False) -> torch.Tensor:
    """All projected token features [N, L, E] (texts-as-images)."""
    x = _backbone(params, embeds, n_heads, impl=impl, q8=q8, fused=fused)
    return x @ params["text_projection"].to(x.dtype)


def encode_text_embeds(params: dict, embeds: torch.Tensor, eot_idx: torch.Tensor,
                       n_heads: int, impl: str = "auto", q8: dict = None,
                       fused: bool = False, adapter: dict = None) -> torch.Tensor:
    """EOT-position features [N, E]; ``eot_idx`` is tokens.argmax(-1)."""
    x = _backbone(params, embeds, n_heads, impl=impl, q8=q8, fused=fused, adapter=adapter)
    eot = x[torch.arange(x.shape[0], device=x.device), eot_idx.long().to(x.device)]
    return eot @ params["text_projection"].to(x.dtype)


def encode_text(params: dict, tokens: torch.Tensor, n_heads: int, impl: str = "auto",
                sequence: bool = False, q8: dict = None, fused: bool = False) -> torch.Tensor:
    """Token ids [N, L] → EOT feature [N, E] (or all positions if sequence)."""
    embeds = embed_tokens(params, tokens)
    if sequence:
        return encode_text_sequence(params, embeds, n_heads, impl=impl, q8=q8, fused=fused)
    return encode_text_embeds(params, embeds, tokens.argmax(-1), n_heads, impl=impl, q8=q8,
                              fused=fused)

