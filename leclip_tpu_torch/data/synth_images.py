"""Synthetic labelled images: procedural class glyphs (the port's own copy
of leclip_tpu/data/synth_images.py, numpy only, the same numbers for the
same seed).

Every one of the 80 COCO classes has a unique glyph (a colour x shape x
texture combination), and a scene composes 1-4 glyphs at random positions
and scales on a textured background, so multi-label ground truth holds by
construction and the signal is spatially localised. Captions name exactly
the rendered classes, which makes the renderer the (image, caption) pair
source of dual-encoder fine-tuning where no image dataset is at hand.

Glyph identity (class index c):
  hue      = c % 10        (10 evenly spaced hues)
  shape    = (c // 10) % 4 (disk, square, triangle, ring)
  texture  = c // 40       (solid, striped)
10 x 4 x 2 = 80 unique combinations.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

N_HUES = 10
N_SHAPES = 4
N_TEXTURES = 2
N_CLASSES = N_HUES * N_SHAPES * N_TEXTURES  # 80


def class_attributes(c: int) -> Tuple[int, int, int]:
    """(hue_id, shape_id, texture_id) for class index ``c``."""
    if not 0 <= c < N_CLASSES:
        raise ValueError(f"class index {c} outside [0, {N_CLASSES})")
    return c % N_HUES, (c // N_HUES) % N_SHAPES, c // (N_HUES * N_SHAPES)


def _hsv_to_rgb(h: float, s: float, v: float) -> np.ndarray:
    """Vector-free HSV→RGB (colorsys semantics) returning float32 [3]."""
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]
    return np.asarray(rgb, np.float32)


def class_color(c: int) -> np.ndarray:
    hue_id, _, _ = class_attributes(c)
    return _hsv_to_rgb(hue_id / N_HUES, 0.9, 0.9)


def _shape_mask(shape_id: int, size: int) -> np.ndarray:
    """Float32 [size, size] alpha mask, antialiased by 2× supersampling."""
    ss = 2 * size
    y, x = np.mgrid[0:ss, 0:ss].astype(np.float32)
    # normalized coords in [-1, 1]
    y = (y + 0.5) / ss * 2 - 1
    x = (x + 0.5) / ss * 2 - 1
    if shape_id == 0:      # disk
        m = (x * x + y * y) <= 1.0
    elif shape_id == 1:    # square
        m = np.maximum(np.abs(x), np.abs(y)) <= 0.88
    elif shape_id == 2:    # triangle (apex up)
        m = (y >= -0.95) & (np.abs(x) <= (1.0 - (y + 0.95) / 1.9) * 0.95)
    elif shape_id == 3:    # ring
        r2 = x * x + y * y
        m = (r2 <= 1.0) & (r2 >= 0.5 * 0.5)
    else:
        raise ValueError(f"shape_id {shape_id}")
    m = m.astype(np.float32)
    return m.reshape(size, 2, size, 2).mean(axis=(1, 3))


def render_glyph(c: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rgb [size, size, 3] float32 in [0,1], alpha [size, size]) for class c."""
    hue_id, shape_id, texture_id = class_attributes(c)
    color = class_color(c)
    rgb = np.broadcast_to(color, (size, size, 3)).copy()
    if texture_id == 1:  # striped: dark bands of the same hue along x
        x = (np.arange(size, dtype=np.float32) + 0.5) / size
        bands = (np.sin(x * np.pi * 5.0) > 0).astype(np.float32)
        dark = _hsv_to_rgb(hue_id / N_HUES, 0.9, 0.3)
        rgb = bands[None, :, None] * rgb + (1 - bands)[None, :, None] * dark
    alpha = _shape_mask(shape_id, size)
    return rgb.astype(np.float32), alpha


def render_scene(
    rng: np.random.Generator,
    class_ids: Sequence[int],
    h: int,
    w: int,
    scale_range: Tuple[float, float] = (0.25, 0.6),
) -> np.ndarray:
    """Compose the given classes' glyphs on a textured background → uint8
    [h, w, 3]. Positions/scales are random; glyph centers are rejection-
    sampled apart so every class stays visible."""
    base = 0.15 + 0.2 * rng.random()
    img = np.full((h, w, 3), base, np.float32)
    # slow linear gradient + pixel noise so background windows aren't flat
    gy = np.linspace(0, 0.08 * (rng.random() - 0.5) * 2, h, dtype=np.float32)
    gx = np.linspace(0, 0.08 * (rng.random() - 0.5) * 2, w, dtype=np.float32)
    img += gy[:, None, None] + gx[None, :, None]
    img += rng.normal(0.0, 0.02, (h, w, 3)).astype(np.float32)

    centers: List[Tuple[float, float]] = []
    short = min(h, w)
    for c in class_ids:
        size = int(short * (scale_range[0]
                            + (scale_range[1] - scale_range[0]) * rng.random()))
        size = max(8, min(size, short - 2))
        for _ in range(12):  # keep glyph centers apart (best effort)
            y0 = int(rng.integers(0, h - size + 1))
            x0 = int(rng.integers(0, w - size + 1))
            cy, cx = y0 + size / 2, x0 + size / 2
            if all((cy - py) ** 2 + (cx - px) ** 2 > (0.35 * short) ** 2
                   for py, px in centers):
                break
        centers.append((cy, cx))
        rgb, alpha = render_glyph(int(c), size)
        a = alpha[..., None]
        patch = img[y0:y0 + size, x0:x0 + size]
        img[y0:y0 + size, x0:x0 + size] = (1 - a) * patch + a * rgb
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def default_caption(rng: np.random.Generator, names: Sequence[str]) -> str:
    """Fallback caption template (scripts may pass their own caption_fn to
    stay in-distribution with a specific training corpus)."""
    openers = ["A photo of", "An image showing", "There is", "A scene with"]
    body = " and a ".join(names)
    return f"{openers[rng.integers(len(openers))]} a {body}."


def sample_scene(
    rng: np.random.Generator,
    classnames: Sequence[str],
    h: int,
    w: int,
    k_range: Tuple[int, int] = (1, 3),
    scale_range: Tuple[float, float] = (0.25, 0.6),
    caption_fn: Optional[Callable] = None,
) -> Tuple[np.ndarray, np.ndarray, str]:
    """One labeled scene: (image uint8 [h,w,3], multi-hot labels [C], caption
    naming exactly the rendered classes)."""
    n_cls = len(classnames)
    if n_cls > N_CLASSES:
        raise ValueError(f"renderer supports at most {N_CLASSES} classes")
    k = int(rng.integers(k_range[0], k_range[1] + 1))
    ids = rng.choice(n_cls, size=k, replace=False)
    img = render_scene(rng, ids, h, w, scale_range)
    labels = np.zeros(n_cls, np.float32)
    labels[ids] = 1.0
    cap = (caption_fn or default_caption)(rng, [classnames[int(i)] for i in ids])
    return img, labels, cap


def make_labeled_images(
    n: int,
    classnames: Sequence[str],
    seed: int,
    sizes: Sequence[Tuple[int, int]] = ((192, 192),),
    k_range: Tuple[int, int] = (1, 3),
    scale_range: Tuple[float, float] = (0.25, 0.6),
    caption_fn: Optional[Callable] = None,
) -> Tuple[List[np.ndarray], np.ndarray, List[str]]:
    """n labeled scenes cycling through ``sizes`` → (images, labels [n, C],
    captions). Deterministic in (n, seed, sizes)."""
    rng = np.random.default_rng(seed)
    imgs, labels, caps = [], [], []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        img, lab, cap = sample_scene(rng, classnames, h, w, k_range,
                                     scale_range, caption_fn)
        imgs.append(img)
        labels.append(lab)
        caps.append(cap)
    return imgs, np.stack(labels), caps
