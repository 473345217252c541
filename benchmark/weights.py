"""Seeded inputs of a run, made by the benchmark and handed the same to the
program and to the reference: the CLIP weights (random, OpenAI CLIP's
published widths), random batch-norm statistics, the ensemble members'
context vectors, the caption bank of unit rows, and the JPEG pool.

Weights are drawn on the device in two calls (one normal buffer, one
uniform buffer) and carved into the parameter tree the program takes:
linear kernels ``[in, out]``, transformer layers stacked on a leading axis,
convolution kernels ``[out, in, kh, kw]`` with channels-last strides (stored
``[out, kh, kw, in]``), the bottlenecks after a stage's first stacked."""

from __future__ import annotations

import io
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

# ------------------------------------ the plan --------------------------------------
# a leaf: (kind, shape, a, b, layout). kind "normal": a * N(0, 1) + b;
# "uniform": a + (b - a) * U(0, 1); "const": every element a


def _normal(shape, std, mean=0.0, layout=None):
    return ("normal", tuple(shape), float(std), float(mean), layout)


def _uniform(shape, lo, hi):
    return ("uniform", tuple(shape), float(lo), float(hi), None)


def _ln(width, layers=None):
    lead = () if layers is None else (layers,)
    return {"scale": _normal(lead + (width,), 0.05, 1.0), "bias": _normal(lead + (width,), 0.02)}


def _blocks(layers: int, width: int) -> dict:
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    return {
        "ln_1": _ln(width, layers),
        "attn": {"qkv_kernel": _normal((layers, width, 3 * width), attn_std),
                 "qkv_bias": _normal((layers, 3 * width), 0.02),
                 "out_kernel": _normal((layers, width, width), proj_std),
                 "out_bias": _normal((layers, width), 0.02)},
        "ln_2": _ln(width, layers),
        "mlp": {"fc_kernel": _normal((layers, width, 4 * width), fc_std),
                "fc_bias": _normal((layers, 4 * width), 0.02),
                "proj_kernel": _normal((layers, 4 * width, width), proj_std),
                "proj_bias": _normal((layers, width), 0.02)},
    }


def _bn(c, lead=()):
    """Random running statistics and affine: scale U(0.5, 1), bias and mean
    0.1 N(0, 1), var U(0.5, 1.5)."""
    shape = tuple(lead) + (c,)
    return {"scale": _uniform(shape, 0.5, 1.0), "bias": _normal(shape, 0.1),
            "mean": _normal(shape, 0.1), "var": _uniform(shape, 0.5, 1.5)}


def _conv(cin, cout, k, lead=()):
    """He-normal kernel, stored [*lead, out, kh, kw, in]."""
    return _normal(tuple(lead) + (cout, k, k, cin), (2.0 / (k * k * cin)) ** 0.5,
                   layout="conv")


def _bottleneck(cin, planes, stride, lead=()):
    cout = planes * 4
    p = {"conv1": _conv(cin, planes, 1, lead), "bn1": _bn(planes, lead),
         "conv2": _conv(planes, planes, 3, lead), "bn2": _bn(planes, lead),
         "conv3": _conv(planes, cout, 1, lead), "bn3": _bn(cout, lead)}
    if stride > 1 or cin != cout:
        p["downsample"] = {"conv": _conv(cin, cout, 1, lead), "bn": _bn(cout, lead)}
    return p


def _resnet(cfg: dict) -> dict:
    width = cfg["vision_width"]
    p = {"conv1": _conv(3, width // 2, 3), "bn1": _bn(width // 2),
         "conv2": _conv(width // 2, width // 2, 3), "bn2": _bn(width // 2),
         "conv3": _conv(width // 2, width, 3), "bn3": _bn(width)}
    cin = width
    for i, (n, stride) in enumerate(zip(cfg["vision_layers"], (1, 2, 2, 2)), start=1):
        planes = width * 2 ** (i - 1)
        stage = {"block0": _bottleneck(cin, planes, stride)}
        cin = planes * 4
        if n > 1:
            stage["rest"] = _bottleneck(cin, planes, 1, lead=(n - 1,))
        p[f"layer{i}"] = stage
    embed = width * 32
    grid = cfg["image_resolution"] // 32
    std = embed ** -0.5

    def lin(a, b):
        return {"kernel": _normal((a, b), std), "bias": _normal((b,), 0.02)}

    p["attnpool"] = {"positional_embedding": _normal((grid * grid + 1, embed), std),
                     "q_proj": lin(embed, embed), "k_proj": lin(embed, embed),
                     "v_proj": lin(embed, embed), "c_proj": lin(embed, cfg["embed_dim"])}
    return p


def _vit(cfg: dict) -> dict:
    width, patch = cfg["vision_width"], cfg["vision_patch_size"]
    grid = cfg["image_resolution"] // patch
    fan_in = patch * patch * 3
    scale = width ** -0.5
    return {"patch_kernel": _normal((fan_in, width), (2.0 / fan_in) ** 0.5),
            "class_embedding": _normal((width,), scale),
            "positional_embedding": _normal((grid * grid + 1, width), scale),
            "ln_pre": _ln(width),
            "blocks": _blocks(cfg["vision_layers"], width),
            "ln_post": _ln(width),
            "proj": _normal((width, cfg["embed_dim"]), scale)}


def _text(cfg: dict) -> dict:
    width = cfg["transformer_width"]
    return {"token_embedding": _normal((cfg["vocab_size"], width), 0.02),
            "positional_embedding": _normal((cfg["context_length"], width), 0.01),
            "blocks": _blocks(cfg["transformer_layers"], width),
            "ln_final": _ln(width),
            "text_projection": _normal((width, cfg["embed_dim"]), width ** -0.5)}


def weight_plan(cfg: dict, parts=("visual", "text")) -> dict:
    plan = {}
    if "visual" in parts:
        plan["visual"] = _vit(cfg) if cfg["vision_patch_size"] else _resnet(cfg)
    if "text" in parts:
        plan["text"] = _text(cfg)
    return plan


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _carve(plan, flat: Dict[str, torch.Tensor], offsets: Dict[str, int]):
    if isinstance(plan, dict):
        return {k: _carve(v, flat, offsets) for k, v in plan.items()}
    kind, shape, a, b, layout = plan
    n = math.prod(shape)
    buf = flat[kind]
    t = buf[offsets[kind]: offsets[kind] + n].view(shape)
    offsets[kind] += n
    t = t * a + b if kind == "normal" else a + (b - a) * t
    if layout == "conv":  # stored [..., out, kh, kw, in] → viewed [..., out, in, kh, kw]
        lead = list(range(len(shape) - 4))
        k = len(lead)
        t = t.permute(*lead, k, k + 3, k + 1, k + 2)
    return t


def make_weights(cfg: dict, seed: int, device, parts=("visual", "text")) -> dict:
    """The CLIP parameter tree of configuration ``cfg`` from ``seed`` (the
    towers named in ``parts``): two large draws on ``device`` (float32),
    carved and scaled."""
    plan = weight_plan(cfg, parts)
    need = {"normal": 0, "uniform": 0}
    for _, (kind, shape, *_rest) in _leaves(plan):
        need[kind] += math.prod(shape)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {"normal": torch.randn(need["normal"], generator=gen, device=device),
            "uniform": torch.rand(need["uniform"], generator=gen, device=device)}
    tree = _carve(plan, flat, {"normal": 0, "uniform": 0})
    tree["logit_scale"] = torch.tensor(math.log(1 / 0.07), device=device)
    return tree


# ------------------------------------ members ---------------------------------------


def make_members(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """Every ensemble member's context vectors from ``seed``: positive,
    negative and evidence contexts [n_ctx, width], 0.02 N(0, 1), in one draw,
    with the prompt learner's fixed scalars."""
    width = cfg["transformer_width"]
    total = sum(3 * m["n_ctx"] * width for m in cfg["members"])
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device) * 0.02
    out, off = {}, 0
    for m in cfg["members"]:
        sets = []
        for _ in range(3):
            n = m["n_ctx"] * width
            sets.append(flat[off: off + n].view(m["n_ctx"], width))
            off += n
        scalar = lambda v: torch.tensor(v, device=device)  # noqa: E731
        out[m["name"]] = {"evidence": m["evidence"],
                          "trainable": {"ctx": sets[0], "ctx_double": sets[1],
                                        "ctx_evidence": sets[2], "temperature": scalar(3.0),
                                        "spatial_T": scalar(3.0),
                                        "ranking_scale": scalar(4.0)}}
    return out


def make_bank(rows: int, dim: int, seed: int, device, chunk: int = 1 << 15) -> torch.Tensor:
    """[rows, dim] float32 unit rows from ``seed``, normalised in chunks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bank = torch.randn(rows, dim, generator=gen, device=device)
    for i in range(0, rows, chunk):
        part = bank[i: i + chunk]
        part /= part.norm(dim=-1, keepdim=True)
    return bank


# ------------------------------------ images ----------------------------------------


def image_sizes(shares: List[Tuple[int, int, int]], n: int) -> List[Tuple[int, int]]:
    """``n`` (h, w) sizes in the pool's fixed shares: [(w, h, count)] whose
    counts sum to ``n``, interleaved so that neighbours differ."""
    if sum(c for _, _, c in shares) != n:
        raise ValueError(f"the size shares {shares} do not sum to {n}")
    sizes = []
    left = {i: c for i, (_, _, c) in enumerate(shares)}
    while any(left.values()):
        for i, (w, h, _) in enumerate(shares):
            if left[i]:
                sizes.append((h, w))
                left[i] -= 1
    return sizes


def _jpeg(args) -> bytes:
    """One smooth random image as a JPEG: a coarse random grid (cells of 12
    to 96 pixels) resized bicubic, the image's own tint (up to 60 levels a
    channel) and contrast (0.3 to 1), plus noise. Images differ in what
    a whole image holds, as photographs do, not only in where."""
    from PIL import Image

    seed, h, w, quality = args
    rng = np.random.default_rng(seed)
    cell = int(rng.choice([12, 24, 48, 96]))
    coarse = rng.integers(0, 256, (max(2, h // cell), max(2, w // cell), 3)).astype(np.float32)
    coarse = 128 + rng.uniform(-60, 60, 3) + rng.uniform(0.3, 1.0) * (coarse - 128)
    coarse = np.clip(coarse, 0, 255).astype(np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.int16)
    img = np.clip(img + rng.normal(0, 6, img.shape).astype(np.int16), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def make_jpegs(sizes: List[Tuple[int, int]], seed: int, quality: int,
               threads: int = 8) -> List[bytes]:
    """The pool's JPEG bytes, image i from (seed, i) alone."""
    seeds = np.random.SeedSequence(seed).generate_state(len(sizes), dtype=np.uint64)
    jobs = [(int(s), h, w, quality) for s, (h, w) in zip(seeds, sizes)]
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(_jpeg, jobs))


def write_pool(blobs: List[bytes], directory: str) -> List[str]:
    paths = []
    for i, blob in enumerate(blobs):
        path = os.path.join(directory, f"{i:04d}.jpg")
        with open(path, "wb") as f:
            f.write(blob)
        paths.append(path)
    return paths
