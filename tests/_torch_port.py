"""Shared helpers for the port's parity tests (tests/test_torch_*.py): move
JAX pytrees to the port and build OpenAI-layout state dicts from them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from leclip_tpu.inference import tta as jtta
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import dense_clip as jdc
from leclip_tpu.models import prompt as jprompt
from leclip_tpu.models.transformer import init_block_stack
from leclip_tpu_torch.inference import tta as ttta
from leclip_tpu_torch.models import dense_clip as tdc
from leclip_tpu_torch.models import prompt as tprompt
from leclip_tpu_torch.models.convert import from_jax_params


def to_port(tree):
    """JAX pytree → port params on the CPU (value for value)."""
    return from_jax_params(jax.device_get(tree), "cpu")


def _blocks_to_sd(blocks, prefix, sd):
    layers = blocks["ln_1"]["scale"].shape[0]
    for i in range(layers):
        p = f"{prefix}.{i}"
        sd[f"{p}.ln_1.weight"] = blocks["ln_1"]["scale"][i]
        sd[f"{p}.ln_1.bias"] = blocks["ln_1"]["bias"][i]
        sd[f"{p}.attn.in_proj_weight"] = blocks["attn"]["qkv_kernel"][i].T
        sd[f"{p}.attn.in_proj_bias"] = blocks["attn"]["qkv_bias"][i]
        sd[f"{p}.attn.out_proj.weight"] = blocks["attn"]["out_kernel"][i].T
        sd[f"{p}.attn.out_proj.bias"] = blocks["attn"]["out_bias"][i]
        sd[f"{p}.ln_2.weight"] = blocks["ln_2"]["scale"][i]
        sd[f"{p}.ln_2.bias"] = blocks["ln_2"]["bias"][i]
        sd[f"{p}.mlp.c_fc.weight"] = blocks["mlp"]["fc_kernel"][i].T
        sd[f"{p}.mlp.c_fc.bias"] = blocks["mlp"]["fc_bias"][i]
        sd[f"{p}.mlp.c_proj.weight"] = blocks["mlp"]["proj_kernel"][i].T
        sd[f"{p}.mlp.c_proj.bias"] = blocks["mlp"]["proj_bias"][i]


def openai_vit_state_dict(params, patch: int):
    """A JAX ViT CLIP pytree (numpy leaves) → an OpenAI-layout state dict."""
    v, t = params["visual"], params["text"]
    width = v["patch_kernel"].shape[1]
    conv = v["patch_kernel"].reshape(patch, patch, 3, width).transpose(3, 2, 0, 1)
    sd = {
        "visual.conv1.weight": conv,
        "visual.class_embedding": v["class_embedding"],
        "visual.positional_embedding": v["positional_embedding"],
        "visual.ln_pre.weight": v["ln_pre"]["scale"], "visual.ln_pre.bias": v["ln_pre"]["bias"],
        "visual.ln_post.weight": v["ln_post"]["scale"], "visual.ln_post.bias": v["ln_post"]["bias"],
        "visual.proj": v["proj"],
        "token_embedding.weight": t["token_embedding"],
        "positional_embedding": t["positional_embedding"],
        "ln_final.weight": t["ln_final"]["scale"], "ln_final.bias": t["ln_final"]["bias"],
        "text_projection": t["text_projection"],
        "logit_scale": np.asarray(params["logit_scale"], np.float32),
    }
    _blocks_to_sd(v["blocks"], "visual.transformer.resblocks", sd)
    _blocks_to_sd(t["blocks"], "transformer.resblocks", sd)
    return {k: np.ascontiguousarray(np.asarray(a, np.float32)) for k, a in sd.items()}


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def block_stack(width, layers, seed, dtype="fp32", outlier=None):
    """A JAX block stack (numpy leaves) with non-trivial LN affines and
    biases; ``outlier`` multiplies the LN gains of channels 5, 17, 42."""
    rng = np.random.default_rng(seed)
    blocks = jax.device_get(init_block_stack(jax.random.PRNGKey(seed), layers, width))
    gain = np.ones((layers, width), np.float32)
    if outlier:
        gain[:, [5, 17, 42]] = outlier
    for ln in ("ln_1", "ln_2"):
        blocks[ln]["scale"] = ((1 + 0.1 * rng.standard_normal((layers, width))) * gain
                               ).astype(np.float32)
        blocks[ln]["bias"] = (0.1 * rng.standard_normal((layers, width))).astype(np.float32)
    for grp, key, n in (("attn", "qkv_bias", 3 * width), ("attn", "out_bias", width),
                        ("mlp", "fc_bias", 4 * width), ("mlp", "proj_bias", width)):
        blocks[grp][key] = (0.02 * rng.standard_normal((layers, n))).astype(np.float32)
    if dtype == "bf16":
        blocks = jax.device_get(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), blocks))
    return blocks


def tta_ensemble(dtype, cfg, classes, groups, attention_impl="auto"):
    """Both sides' six-member ensembles (``groups``: (members, use_evidence,
    use_freq, n_ctx)) from one JAX pytree of preset ``cfg`` and numpy prompts,
    every member's flags carrying ``attention_impl``; plus a caption bank and
    a co-occurrence matrix. Returns (jax params, port params, jax specs, port
    specs, bank, cooc)."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), cfg, dtype=jdt))
    tp = to_port(jp)
    rng = np.random.default_rng(7)
    jspecs, tspecs, jconst, tconst = {}, {}, {}, {}
    for names, evd, use_freq, n_ctx in groups:
        if n_ctx not in jconst:
            _, jconst[n_ctx] = jprompt.build_prompt_learner(
                jax.random.PRNGKey(0), jp, classes, n_ctx=n_ctx, dtype=jdt)
            _, tconst[n_ctx] = tprompt.build_prompt_learner(
                torch.Generator().manual_seed(0), tp, classes, n_ctx=n_ctx,
                dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
        for name in names:
            tr = {k: (0.02 * rng.standard_normal((n_ctx, cfg.transformer_width))).astype(np.float32)
                  for k in ("ctx", "ctx_double", "ctx_evidence")}
            tr.update(temperature=np.float32(3), spatial_T=np.float32(3),
                      ranking_scale=np.float32(4))
            jtr = {k: jnp.asarray(v, jdt) for k, v in tr.items()}
            jflags = jdc.DenseFlags(use_evidence=evd, attention_impl=attention_impl)
            tflags = tdc.DenseFlags(use_evidence=evd, attention_impl=attention_impl)
            jspecs[name] = jtta.build_model_spec(jp, cfg, jtr, jconst[n_ctx], jflags,
                                                 use_freq=use_freq)
            tspecs[name] = ttta.build_model_spec(tp, cfg, to_port(jtr), tconst[n_ctx], tflags,
                                                 use_freq=use_freq)
    bank = rng.standard_normal((40, cfg.embed_dim)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    cooc = rng.random((len(classes),) * 2).astype(np.float32)
    cooc /= cooc.sum(-1, keepdims=True)
    return jp, tp, jspecs, tspecs, bank, cooc
