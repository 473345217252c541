"""The plain reference of the scoring path: one image at a time, in float32,
from its decoded pixels to its fused [C] scores.

An image's 305 crops (the central square, then the sliding-window pyramid of
scales 2, 3 and 4, each window mapped to its central square), a separable
bicubic resize of each crop to 224 (Keys a = -0.5, widened by the shrink
factor, taps reflected at the image edge), CLIP's normalisation, the image
tower, an exact top-k search of the caption bank, every member's global and
local logits against its prompt features (the prompt learner's three
context sets through the text tower), fuse / fuse6 block fusion, and the
per-class routing between members. Nothing here imports the program."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import clip_ref as C
from .tokenizer import get_tokenizer, tokenize

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FIXED_LOGIT_SCALE = 4.0
FUSE_COEF = 1.5


# ------------------------------------ crops -----------------------------------------


def _stride(scale: int, block: int, slide: int) -> int:
    return ((scale - 1) * block) // (slide - 1) + 1


def window_boxes(h: int, w: int, scales: Sequence[int]) -> np.ndarray:
    """The multi-scale sliding windows (y0, x0, y1, x1) of an (h, w) image:
    square windows over the reflect-padded image, then 1x2, 2x1, 2:3, 3:2
    and (scale >= 3) 2x3 and 3x2 windows clamped at the image edge."""
    boxes: List[Tuple[int, int, int, int]] = []
    for s in scales:
        slide = 2 * s
        bh, bw = h // s, w // s
        sh, sw = _stride(s, bh, slide), _stride(s, bw, slide)
        for i in range(slide):
            for j in range(slide):
                boxes.append((i * sh, j * sw, i * sh + bh, j * sw + bw))
        families = [
            ((h // s, w * 2 // s), (2 * s, s)),
            ((h * 2 // s, w // s), (s, 2 * s)),
            ((h // s, w * 3 // (2 * s)), (2 * s, 2 * s * 2 // 3)),
            ((h * 3 // (2 * s), w // s), (2 * s * 2 // 3, 2 * s)),
        ]
        if s >= 3:
            families += [((h * 2 // s, w * 3 // s), (s, 2 * s // 3)),
                         ((h * 3 // s, w * 2 // s), (2 * s // 3, s))]
        for (bh, bw), (nh, nw) in families:
            sh, sw = _stride(s, bh, nh), _stride(s, bw, nw)
            for i in range(nh):
                for j in range(nw):
                    ch, cw = min(bh, h - i * sh), min(bw, w - j * sw)
                    if ch > 0 and cw > 0:
                        boxes.append((i * sh, j * sw, i * sh + ch, j * sw + cw))
    return np.asarray(boxes, np.float32)


def crop_boxes(h: int, w: int, scales: Sequence[int]) -> np.ndarray:
    """[n, 4] sampling boxes: the image's central square, then each window's
    central square."""
    win = window_boxes(h, w, scales)
    side = np.minimum(win[:, 2] - win[:, 0], win[:, 3] - win[:, 1])
    cy, cx = (win[:, 0] + win[:, 2]) / 2, (win[:, 1] + win[:, 3]) / 2
    squares = np.stack([cy - side / 2, cx - side / 2, cy + side / 2, cx + side / 2], 1)
    s = min(h, w)
    first = np.asarray([[(h - s) / 2, (w - s) / 2, (h + s) / 2, (w + s) / 2]], np.float32)
    return np.concatenate([first, squares.astype(np.float32)])


def _cubic(x: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    ax = x.abs()
    inner = (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1
    outer = a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a
    return torch.where(ax <= 1, inner, torch.where(ax < 2, outer, torch.zeros_like(ax)))


def axis_weights(lo: torch.Tensor, hi: torch.Tensor, n: int, out: int) -> torch.Tensor:
    """[K, out, n] weights resampling the spans [lo, hi) of an axis of ``n``
    pixels to ``out`` samples: half-pixel centres, the cubic's support widened
    by the shrink factor, taps past either edge reflected once onto the
    pixels inside, each row normalised."""
    span = (hi - lo)[:, None]
    centre = lo[:, None] + (torch.arange(out, device=lo.device) + 0.5) * span / out - 0.5
    widen = torch.clamp(span / out, min=1.0)[:, :, None]
    i = torch.arange(n, dtype=torch.float32, device=lo.device)
    c = centre[:, :, None]
    w = _cubic((i - c) / widen)
    w = w + torch.where(i <= n - 2, _cubic((2 * (n - 1) - i - c) / widen), 0.0)
    w = w + torch.where(i >= 1, _cubic((-i - c) / widen), 0.0)
    return w / w.sum(-1, keepdim=True).clamp(min=1e-8)


def crops_of(image_u8: np.ndarray, scales: Sequence[int], size: int, device,
             num: C.Numerics = C.FP32) -> torch.Tensor:
    """One decoded image [h, w, 3] uint8 → its normalised crops [n, size,
    size, 3]: the rows pass, then the columns pass, each a product."""
    h, w = image_u8.shape[:2]
    img = torch.from_numpy(np.array(image_u8, np.uint8)).to(device).float() / 255.0
    boxes = torch.as_tensor(crop_boxes(h, w, scales), device=device)
    ry = axis_weights(boxes[:, 0], boxes[:, 2], h, size)          # [n, O, h]
    rx = axis_weights(boxes[:, 1], boxes[:, 3], w, size)          # [n, O, w]
    n = ry.shape[0]
    rows = num.matmul(ry, img.reshape(h, w * 3)).reshape(n, size, w, 3)
    cols = num.matmul(rows.permute(0, 1, 3, 2).reshape(n, size * 3, w), rx.transpose(1, 2))
    out = cols.reshape(n, size, 3, size).permute(0, 1, 3, 2)
    mean = torch.tensor(CLIP_MEAN, device=device)
    std = torch.tensor(CLIP_STD, device=device)
    return (out - mean) / std


# ------------------------------------ prompts ---------------------------------------


def prompt_scaffold(token_embedding: torch.Tensor, classnames: Sequence[str], n_ctx: int):
    """(SOS embedding [C, 1, W], class + EOS embeddings [C, L - 1 - n_ctx, W],
    EOT positions [C]) of the prompts "X X ... X <class>."."""
    prefix = " ".join(["X"] * n_ctx)
    names = [c.replace("_", " ") for c in classnames]
    ids = tokenize([f"{prefix} {c}." for c in names], truncate=True)
    emb = token_embedding.float()[torch.as_tensor(ids, dtype=torch.long,
                                                  device=token_embedding.device)]
    eot = torch.as_tensor(ids.argmax(-1), device=token_embedding.device)
    return emb[:, :1], emb[:, 1 + n_ctx:], eot


def prompt_features(text: dict, heads: int, classnames: Sequence[str], trainable: dict,
                    evidence: bool, num: C.Numerics = C.FP32) -> Dict[str, torch.Tensor]:
    """Normalised class features [C, E] of the positive, negative ("local")
    and, with evidence, the evidence prompts: [SOS | context | class, EOS]."""
    get_tokenizer()
    n_ctx = trainable["ctx"].shape[-2]
    sos, rest, eot = prompt_scaffold(text["token_embedding"], classnames, n_ctx)
    n_cls = sos.shape[0]

    def enc(ctx):
        ctx = ctx.float()[None].expand(n_cls, -1, -1)
        return C.normalize(C.text_eot(torch.cat([sos, ctx, rest], 1), eot, text, heads, num))

    out = {"pos": enc(trainable["ctx"]), "neg": enc(trainable["ctx_double"])}
    if evidence:
        out["evd"] = enc(trainable["ctx_evidence"])
    return out


# ------------------------------------ scoring ---------------------------------------


def local_logits(dense: torch.Tensor, feats: Dict[str, torch.Tensor], spatial_scale: float,
                 evidence: bool) -> torch.Tensor:
    """[n, C] local logits of dense features [n, P, E]: the negative prompts'
    logits weighted by a softmax over the positions (of the evidence logits
    where there are evidence prompts, whose negative logits are first
    reweighted by a winner-take-all softmax over the classes)."""
    raw = dense @ feats["neg"].T
    if evidence:
        w = torch.softmax(spatial_scale * raw * (raw.amax(-1, keepdim=True) + 1.0), dim=-1)
        neg = raw * w
        prob = torch.softmax(spatial_scale * (dense @ feats["evd"].T), dim=-2)
    else:
        neg = raw
        prob = torch.softmax(spatial_scale * raw, dim=-2)
    return (FIXED_LOGIT_SCALE * neg * prob).sum(-2)


def block_fuse(blocks: torch.Tensor, sims: torch.Tensor, twice: bool,
               threshold: float = 0.2) -> torch.Tensor:
    """fuse (``twice``: fuse6) of one image's block logits [n - 1, C] with
    their retrieval scores [n - 1, k] → [C]."""
    weight = 1.0 + sims.mean(-1, keepdim=True)
    if twice:
        var0 = 1.0 + blocks.var(dim=-1, keepdim=True)
        ws = weight * blocks
        data = var0 * (1.0 + ws.var(dim=-1, keepdim=True)) * ws
    else:
        data = weight * blocks
        data = (1.0 + data.var(dim=-1, keepdim=True)) * data
    hi, lo = data.amax(0), data.amin(0)
    return torch.where(hi > threshold, hi, lo)


def score_image(image_u8: np.ndarray, model: dict, num: C.Numerics = C.FP32) -> torch.Tensor:
    """One image → its fused, routed scores [C] (float32)."""
    dev = model["bank"].device
    cfg = model["config"]
    crops = crops_of(image_u8, cfg["scales"], cfg["image_resolution"], dev, num)
    g, dense = C.image_features(crops, model["visual"], cfg, num)
    sims = g @ model["bank"].T
    top, idx = torch.topk(sims, cfg["topk"], dim=-1)
    aug = (g + model["bank"][idx].mean(1)) / 2.0
    blocks_sims = top[1:]
    per_member = {}
    for name, m in model["members"].items():
        glob = FIXED_LOGIT_SCALE * aug @ m["feats"]["pos"].T
        loc = local_logits(dense, m["feats"], cfg["spatial_scale_image"], m["evidence"])
        base = name == model["base"]
        o = glob[0] + FUSE_COEF * block_fuse(glob[1:], blocks_sims, base)
        a = loc[0] + FUSE_COEF * block_fuse(loc[1:], blocks_sims, base)
        per_member[name] = o + (1.5 if base else 1.0) * a
    fused = per_member[model["base"]].clone()
    for name, cols in model["routing"].items():
        if name in per_member:
            fused[cols] = per_member[name][cols]
    return fused


def build_model(weights: dict, cfg: dict, members: Dict[str, dict], bank: torch.Tensor,
                num: C.Numerics = C.FP32) -> dict:
    """The reference's scoring model: the weights, the bank, and each
    member's prompt features worked out from its context vectors."""
    heads = cfg["transformer_heads"]
    with C.no_tf32(), torch.no_grad():
        feats = {name: {"feats": prompt_features(weights["text"], heads, cfg["classnames"],
                                                 m["trainable"], m["evidence"], num),
                        "evidence": m["evidence"]}
                 for name, m in members.items()}
    return {"visual": weights["visual"], "config": cfg, "members": feats, "bank": bank,
            "base": cfg["routing_base"], "routing": cfg["routing"]}


def score_images(images: Sequence[np.ndarray], model: dict,
                 num: C.Numerics = C.FP32) -> np.ndarray:
    """Each image on its own → [B, C] float32 scores."""
    with C.no_tf32(), torch.no_grad():
        return np.stack([score_image(im, model, num).cpu().numpy() for im in images])
