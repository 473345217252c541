"""Multi-scale sliding-window TTA crop geometry (the numpy half of
leclip_tpu/ops/crops.py, copied): the reference's crop factory — same
integer stride/padding formulas, same window families. Scales (2,3,4) →
40+100+164 = 304 crops per image (+1 global added by the engine). Each
window maps to its central square (resize-smaller-edge + center-crop
identity), which the matmul resizer (ops/resize_matmul.py) samples.

The gather-based device sampler (``crop_and_resize``) is not ported."""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np


def _stride(scale: int, block: int, slide: int) -> int:
    """Reference stride formula: ((s-1)*block)//(slide-1) + 1."""
    return ((scale - 1) * block) // (slide - 1) + 1


def sliding_window_boxes(
    h: int, w: int, scales: Sequence[int] = (2, 3, 4)
) -> Tuple[np.ndarray, List[int]]:
    """All TTA window boxes for an (h, w) image.

    Returns (boxes [N, 4] float32 as (y0, x0, y1, x1) in ORIGINAL image
    coordinates — square-window boxes may extend past the bottom/right edge
    by the reflect padding — and per-scale crop counts)."""
    boxes: List[Tuple[float, float, float, float]] = []
    counts: List[int] = []
    for s in scales:
        start = len(boxes)

        # ① square sliding windows over the reflect-padded image
        slide = 2 * s
        bh, bw = h // s, w // s
        sh, sw = _stride(s, bh, slide), _stride(s, bw, slide)
        for i in range(slide):
            for j in range(slide):
                boxes.append((i * sh, j * sw, i * sh + bh, j * sw + bw))

        # ② 1×2 and 2×1 aspect windows (clamped at the image edge)
        # ③ 2:3 and 3:2 aspect windows
        # ④ (s ≥ 3) oversized 2×3 and 3×2 windows
        families = [
            ((h // s, w * 2 // s), (2 * s, s)),
            ((h * 2 // s, w // s), (s, 2 * s)),
            ((h // s, w * 3 // (2 * s)), (2 * s, 2 * s * 2 // 3)),
            ((h * 3 // (2 * s), w // s), (2 * s * 2 // 3, 2 * s)),
        ]
        if s >= 3:
            families += [
                ((h * 2 // s, w * 3 // s), (s, 2 * s // 3)),
                ((h * 3 // s, w * 2 // s), (2 * s // 3, s)),
            ]
        for (bh, bw), (snh, snw) in families:
            sh, sw = _stride(s, bh, snh), _stride(s, bw, snw)
            for i in range(snh):
                for j in range(snw):
                    ch = min(bh, h - i * sh)
                    cw = min(bw, w - j * sw)
                    if ch <= 0 or cw <= 0:
                        continue
                    boxes.append((i * sh, j * sw, i * sh + ch, j * sw + cw))
        counts.append(len(boxes) - start)
    return np.asarray(boxes, np.float32), counts


def central_square_boxes(boxes: np.ndarray) -> np.ndarray:
    """Map each window to its central square (side = min(h, w)) — the
    resize-smaller-edge + center-crop identity."""
    y0, x0, y1, x1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    bh, bw = y1 - y0, x1 - x0
    side = np.minimum(bh, bw)
    cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
    half = side / 2
    return np.stack([cy - half, cx - half, cy + half, cx + half], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def tta_sampling_boxes(
    h: int, w: int, scales: Tuple[int, ...] = (2, 3, 4)
) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Cached: final square sampling boxes for the full pyramid of an (h, w)
    image, plus per-scale counts."""
    boxes, counts = sliding_window_boxes(h, w, scales)
    return central_square_boxes(boxes), tuple(counts)
