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


def tta_ensemble(dtype, cfg, classes, groups, attention_impl="auto", jp=None):
    """Both sides' six-member ensembles (``groups``: (members, use_evidence,
    use_freq, n_ctx)) from one JAX pytree of preset ``cfg`` (``jp``, else a
    seeded init) and numpy prompts, every member's flags carrying
    ``attention_impl``; plus a caption bank and a co-occurrence matrix.
    Returns (jax params, port params, jax specs, port specs, bank, cooc)."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    if jp is None:
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


def tta_engines(cfg, classes, groups):
    """Both packages' fp32 TTAEngines (the port's on the CPU) over
    :func:`tta_ensemble`'s members, bank and co-occurrence: scales (2,),
    top-5 retrieval. Returns (jax engine, port engine)."""
    jp, tp, jspecs, tspecs, bank, cooc = tta_ensemble("fp32", cfg, classes, groups)
    kw = dict(scales=(2,), cooccurrence=cooc, crop_size=cfg.image_resolution, topk=5)
    return (jtta.TTAEngine(jp, cfg, jspecs, caption_bank=jnp.asarray(bank),
                           compute_dtype=jnp.float32, **kw),
            ttta.TTAEngine(tp, cfg, tspecs, caption_bank=torch.tensor(bank),
                           compute_dtype=torch.float32, device="cpu", **kw))


def random_bn(tree, seed: int):
    """A JAX ResNet tree with every batch norm's statistics and affine drawn
    at random (the JAX init zeroes each bn3 scale, which would leave every
    residual branch out of a comparison)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            if set(t) == {"scale", "bias", "mean", "var"}:
                shape = np.shape(t["scale"])
                return {"scale": rng.uniform(0.5, 1.0, shape).astype(np.float32),
                        "bias": rng.normal(0.0, 0.1, shape).astype(np.float32),
                        "mean": rng.normal(0.0, 0.1, shape).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, shape).astype(np.float32)}
            return {k: walk(v) for k, v in t.items()}
        return t

    return walk(tree)


def rn_visual_numpy(cfg, seed: int = 0):
    """A JAX ResNet image tower of preset ``cfg`` filled from numpy (the JAX
    init's shapes and scales: He-normal convs, normal pool projections of
    std embed^-0.5, small random biases), with random BN; quick at RN50's
    widths, where the JAX init takes many seconds on the CPU."""
    from leclip_tpu.models.resnet import init_resnet_params

    shapes = jax.eval_shape(lambda k: init_resnet_params(
        k, cfg.vision_layers, cfg.embed_dim, cfg.image_resolution, cfg.vision_width),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    embed = cfg.vision_width * 32

    def fill(key, s):
        if key.startswith("conv"):
            fan_in = int(np.prod(s.shape[-4:-1]))
            return (rng.standard_normal(s.shape) * (2.0 / fan_in) ** 0.5).astype(np.float32)
        if key in ("kernel", "positional_embedding"):
            return (rng.standard_normal(s.shape) * embed ** -0.5).astype(np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)

    def walk(t, key=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return fill(key, t)

    return random_bn(walk(shapes), seed)


def rn_clip_params(cfg, seed: int = 0):
    """JAX CLIP params (numpy leaves) of ResNet preset ``cfg``: the seeded
    JAX init's text tower, :func:`rn_visual_numpy`'s image tower."""
    params = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(seed), cfg))
    params["visual"] = rn_visual_numpy(cfg, seed)
    return params


def openai_rn_state_dict(params):
    """A JAX ResNet CLIP pytree (numpy leaves) → an OpenAI-layout state dict."""
    v, t = params["visual"], params["text"]
    sd = {}

    def conv(key, w):
        sd[key] = np.asarray(w).transpose(3, 2, 0, 1)  # HWIO → OIHW

    def bn(prefix, p):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{prefix}.{theirs}"] = p[ours]

    def block(prefix, p):
        for i in (1, 2, 3):
            conv(f"{prefix}.conv{i}.weight", p[f"conv{i}"])
            bn(f"{prefix}.bn{i}", p[f"bn{i}"])
        if "downsample" in p:
            conv(f"{prefix}.downsample.0.weight", p["downsample"]["conv"])
            bn(f"{prefix}.downsample.1", p["downsample"]["bn"])

    for i in (1, 2, 3):
        conv(f"visual.conv{i}.weight", v[f"conv{i}"])
        bn(f"visual.bn{i}", v[f"bn{i}"])
    for li in (1, 2, 3, 4):
        stage = v[f"layer{li}"]
        block(f"visual.layer{li}.0", stage["block0"])
        if "rest" in stage:
            n = stage["rest"]["conv1"].shape[0]
            for b in range(n):
                block(f"visual.layer{li}.{b + 1}", jax.tree.map(lambda a: a[b], stage["rest"]))
    ap = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = ap["positional_embedding"]
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd[f"visual.attnpool.{name}.weight"] = np.asarray(ap[name]["kernel"]).T
        sd[f"visual.attnpool.{name}.bias"] = ap[name]["bias"]
    sd.update({
        "token_embedding.weight": t["token_embedding"],
        "positional_embedding": t["positional_embedding"],
        "ln_final.weight": t["ln_final"]["scale"], "ln_final.bias": t["ln_final"]["bias"],
        "text_projection": t["text_projection"],
        "logit_scale": np.asarray(params["logit_scale"], np.float32),
    })
    _blocks_to_sd(t["blocks"], "transformer.resblocks", sd)
    return {k: np.ascontiguousarray(np.asarray(a, np.float32)) for k, a in sd.items()}
