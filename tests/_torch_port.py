"""Shared helpers for the port's parity tests (tests/test_torch_*.py): move
JAX pytrees to the port and build OpenAI-layout state dicts from them."""

import jax
import jax.numpy as jnp
import numpy as np

from leclip_tpu.models.transformer import init_block_stack
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
