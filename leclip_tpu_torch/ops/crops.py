"""Multi-scale sliding-window TTA crop geometry and the gather sampler
(counterpart of leclip_tpu/ops/crops.py): the reference's crop factory —
same integer stride/padding formulas, same window families. Scales (2,3,4)
→ 40+100+164 = 304 crops per image (+1 global added by the engine). Each
window maps to its central square (resize-smaller-edge + center-crop
identity), which the matmul resizer (ops/resize_matmul.py) samples in the
TTA engine.

``crop_and_resize`` is the gather sampler on tensors (cubic Keys a = −0.5 or
linear taps, half-pixel centres, reflection at the content boundary), which
the eval preprocess (ops/preprocess.py) and the zero-shot CLI use."""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch


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


# --------------------------- gather sampler ---------------------------------


def _reflect_index(idx: torch.Tensor, size) -> torch.Tensor:
    """Reflect out-of-range indices (np.pad 'reflect' semantics: the edge is
    not repeated). ``size`` is an int or a tensor (a bucket-padded image's
    content extent)."""
    if not isinstance(size, torch.Tensor):
        if size == 1:
            return torch.zeros_like(idx)
        period = 2 * (size - 1)
        idx = idx.abs() % period
        return torch.where(idx >= size, period - idx, idx)
    size = size.to(idx.dtype)
    period = torch.clamp(2 * (size - 1), min=1)
    wrapped = idx.abs() % period
    out = torch.where(wrapped >= size, period - wrapped, wrapped)
    return torch.where(size <= 1, torch.zeros_like(idx), out)


def _cubic_weights(t: torch.Tensor, a: float = -0.5):
    """Keys cubic kernel weights for the 4 taps around fractional offset t
    (a=-0.5 → Catmull-Rom, PIL's bicubic kernel)."""
    t2, t3 = t * t, t * t * t
    w0 = a * (t3 - 2 * t2 + t)                      # tap at floor-1
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1            # tap at floor
    w2 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t   # tap at floor+1
    w3 = a * (t2 - t3)                              # tap at floor+2
    return w0, w1, w2, w3


def _taps(coords: torch.Tensor, axis_size, method: str, dtype):
    """(reflected index, weight) of each tap at fractional ``coords``."""
    f = torch.floor(coords)
    t = (coords - f).to(dtype)
    base = f.to(torch.int64)
    if method == "cubic":
        w0, w1, w2, w3 = _cubic_weights(t)
        taps = [(base - 1, w0), (base, w1), (base + 1, w2), (base + 2, w3)]
    else:
        taps = [(base, 1.0 - t), (base + 1, t)]
    return [(_reflect_index(i, axis_size), w) for i, w in taps]


def _sample_chunk(img: torch.Tensor, boxes: torch.Tensor, out_size: int, method: str,
                  content_hw) -> torch.Tensor:
    """Sample each box [K, 4] from [H, W, C] → [K, out, out, C]: the rows
    first, then the columns of the sampled rows (the JAX sampler's order)."""
    h, w = img.shape[0], img.shape[1]
    if content_hw is not None:
        h, w = content_hw[0], content_hw[1]
    y0, x0, y1, x1 = (boxes[:, i:i + 1] for i in range(4))
    o = torch.arange(out_size, dtype=img.dtype, device=img.device)
    # the division by the output size as a product with its reciprocal,
    # which is what CUDA's division by a scalar computes: the same
    # coordinates on every device (a division rounds differently, by ~1e-4
    # of a unit-range image at 900-pixel coordinates)
    inv = 1.0 / out_size
    ys = y0 + (o + 0.5) * (y1 - y0) * inv - 0.5             # [K, O]
    xs = x0 + (o + 0.5) * (x1 - x0) * inv - 0.5
    rows = None                                               # [K, O, W, C]
    for idx, wgt in _taps(ys, h, method, img.dtype):
        term = img[idx] * wgt[..., None, None]
        rows = term if rows is None else rows + term
    k = torch.arange(boxes.shape[0], device=img.device)[:, None]
    cols = None                                               # [K, O(x), O(y), C]
    for idx, wgt in _taps(xs, w, method, img.dtype):
        term = rows[k, :, idx] * wgt[..., None, None]
        cols = term if cols is None else cols + term
    return cols.transpose(1, 2)


def crop_and_resize(image: torch.Tensor, boxes, out_size: int = 224, method: str = "cubic",
                    chunk: int = 16, content_hw=None) -> torch.Tensor:
    """Batched crop + resize of ``image`` [H, W, C] (float) at ``boxes``
    [N, 4] (y0, x0, y1, x1 pixel coordinates) → [N, out, out, C].

    Out-of-bounds coordinates reflect at the CONTENT boundary
    (``content_hw``, the true extent of a bucket-padded image; the whole
    image by default): the reference reflect-pads the raw image before its
    sliding windows (data_manager.py:383-398), so a window overflowing the
    image sees mirrored content, not the bucket's zero padding. ``chunk``
    boxes are sampled at a time to bound the gather intermediate; each
    crop's numbers are the same for any chunk."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=image.device).to(image.dtype)
    if content_hw is not None:
        content_hw = tuple(torch.as_tensor(v, device=image.device)
                           if isinstance(v, torch.Tensor) else int(v) for v in content_hw)
    return torch.cat([_sample_chunk(image, boxes[i:i + chunk], out_size, method, content_hw)
                      for i in range(0, boxes.shape[0], chunk)])
