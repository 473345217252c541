"""PromptLearner (counterpart of leclip_tpu/models/prompt.py): three learnable
context-token sets (positive / negative-"local" / evidence), learnable scalar
temperatures, frozen SOS-prefix / CLS+EOS-suffix token embeddings per class,
and end/middle/front class-token placement.

Split into a *trainable* dict (what a checkpoint holds) and a *constant*
dict (embedded prompt scaffolding rebuilt from the class list), and the EMA
twin of the trainable dict that the training step keeps."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..data.tokenizer import get_tokenizer, tokenize


def build_prompt_learner(generator: torch.Generator, clip_params: dict,
                         classnames: List[str], n_ctx: int = 16, csc: bool = False,
                         ctx_init: str = "", class_token_position: str = "end",
                         dtype=torch.float32) -> Tuple[dict, dict]:
    """Returns (trainable, constants) on the device of the token embedding.

    trainable: ctx / ctx_double / ctx_evidence [n_ctx, D] (or [C, n_ctx, D]
    when class-specific), temperature / spatial_T / ranking_scale scalars.
    constants: token_prefix [C,1,D], token_suffix [C,*,D], token_suffix_nocls,
    tokenized_prompts [C,77], eot_idx, name_lens, n_ctx, n_cls,
    class_token_position. The random ctx init draws from ``generator``."""
    token_embedding = clip_params["text"]["token_embedding"]
    device = token_embedding.device
    ctx_dim = token_embedding.shape[1]
    n_cls = len(classnames)
    tok = get_tokenizer()

    def embed(ids: np.ndarray) -> torch.Tensor:
        return token_embedding[torch.as_tensor(ids, dtype=torch.long, device=device)]

    if ctx_init:
        words = ctx_init.replace("_", " ")
        init_ids = tokenize(words)[0]
        # reference convention: n_ctx = word count, NOT BPE token count
        n_ctx = len(words.split(" "))
        ctx = embed(init_ids[1: 1 + n_ctx]).to(dtype)
        ctx_double = ctx
        ctx_evidence = ctx
        prompt_prefix = words
    else:
        shape = (n_cls, n_ctx, ctx_dim) if csc else (n_ctx, ctx_dim)

        def normal(shape):
            return (torch.randn(shape, generator=generator, device=generator.device)
                    * 0.02).to(dtype).to(device)

        ctx = normal(shape)
        ctx_double = normal(shape)
        # the evidence context is always class-agnostic in the reference
        ctx_evidence = normal((n_ctx, ctx_dim))
        prompt_prefix = " ".join(["X"] * n_ctx)

    classnames = [c.replace("_", " ") for c in classnames]
    name_lens = [len(tok.encode(c)) for c in classnames]
    tokenized = tokenize([f"{prompt_prefix} {c}." for c in classnames], truncate=True)
    embedded = embed(tokenized)  # [C, 77, D]
    nocls = tokenize([f"{prompt_prefix}."] * n_cls, truncate=True)
    embedded_nocls = embed(nocls)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    trainable = {
        "ctx": ctx,
        "ctx_double": ctx_double,
        "ctx_evidence": ctx_evidence,
        "temperature": scalar(3.0),
        "spatial_T": scalar(3.0),
        "ranking_scale": scalar(4.0),
    }
    constants = {
        "token_prefix": embedded[:, :1].to(dtype),            # SOS
        "token_suffix": embedded[:, 1 + n_ctx:].to(dtype),     # CLS, EOS
        "token_suffix_nocls": embedded_nocls[:, 1 + n_ctx:].to(dtype),
        "tokenized_prompts": torch.as_tensor(tokenized, dtype=torch.int32, device=device),
        "eot_idx": torch.as_tensor(tokenized.argmax(-1), dtype=torch.long, device=device),
        "name_lens": tuple(name_lens),
        "n_ctx": n_ctx,
        "n_cls": n_cls,
        "class_token_position": class_token_position,
    }
    return trainable, constants


def assemble_prompts(trainable: dict, constants: dict, neg_prompt_wcls: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[prefix | ctx | suffix] per class for the three prompt sets → three
    [C, 77, D] embedding tensors."""
    n_cls = constants["n_cls"]
    n_ctx = constants["n_ctx"]
    prefix = constants["token_prefix"]
    suffix = constants["token_suffix"]
    suffix_nocls = constants["token_suffix_nocls"]
    position = constants["class_token_position"]

    def expand(ctx):
        if ctx.dim() == 2:
            return ctx[None].expand(n_cls, *ctx.shape)
        return ctx

    ctx = expand(trainable["ctx"])
    ctx_double = expand(trainable["ctx_double"])
    ctx_evidence = expand(trainable["ctx_evidence"])

    if position == "end":
        prompts = torch.cat([prefix, ctx, suffix], dim=1)
        sfx_neg = suffix if neg_prompt_wcls else suffix_nocls
        prompts_neg = torch.cat([prefix, ctx_double, sfx_neg], dim=1)
        prompts_evd = torch.cat([prefix, ctx_evidence, sfx_neg], dim=1)
        return prompts, prompts_neg, prompts_evd

    if position in ("middle", "front"):
        half = n_ctx // 2
        rows = []
        for i, name_len in enumerate(constants["name_lens"]):
            pre = prefix[i: i + 1]
            cls_tok = suffix[i: i + 1, :name_len]
            rest = suffix[i: i + 1, name_len:]
            c = ctx[i: i + 1]
            if position == "middle":
                row = torch.cat([pre, c[:, :half], cls_tok, c[:, half:], rest], dim=1)
            else:
                row = torch.cat([pre, cls_tok, c, rest], dim=1)
            rows.append(row)
        prompts = torch.cat(rows, dim=0)
        # the reference rebuilds only the positive set for middle/front
        prompts_neg = torch.cat([prefix, ctx_double, suffix], dim=1)
        prompts_evd = torch.cat([prefix, ctx_evidence, suffix], dim=1)
        return prompts, prompts_neg, prompts_evd

    raise ValueError(f"unknown class_token_position {position!r}")


def ema_init(trainable: dict) -> dict:
    """EMA twin starts as a copy (ref copy_params, :547-552); nested dicts
    (the adapter trainer's ``_adapter``) are copied leaf by leaf."""
    return {k: ema_init(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in trainable.items()}


def ema_update(ema: dict, trainable: dict, momentum: float) -> dict:
    """param_m ← m·param_m + (1-m)·param (ref _momentum_update, :554-559).

    Rounded as the JAX package's compiled step rounds it: XLA contracts the
    sum into fma(param_m, m, (1-m)·param), so param_m·m is not rounded on
    its own. The sum is formed in float64 (exact for fp32 operands but for a
    rare double rounding) and rounded once; the EMA teacher's ×10000 KL term
    would turn the one-ulp difference of separate roundings into 1e-4 of
    the loss."""
    out = {}
    for k, m in ema.items():
        if isinstance(m, dict):
            out[k] = ema_update(m, trainable[k], momentum)
            continue
        mom = torch.tensor(momentum, dtype=m.dtype).item()  # the constant in m's dtype
        rest = trainable[k].detach() * (1.0 - momentum)
        out[k] = (m.double() * mom + rest.double()).to(m.dtype)
    return out
