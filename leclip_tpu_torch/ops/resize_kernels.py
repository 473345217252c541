"""Crop + bicubic resize + normalise of a batch of bucket-padded uint8
images: a hand-written banded kernel and its plain version.

* ``resize_band(images, boxes, content_hw, out_size, antialias, dtype,
  normalize)`` — images [B, H, W, 3] uint8, boxes (y0, x0, y1, x1) [N, 4]
  shared by the batch or [B, N, 4] each image's own, ``content_hw`` [B, 2]
  each image's (h, w) inside the bucket → [B, N, out, out, 3] in ``dtype``
  (bf16 or fp32): the scale ``to(dtype) / 255``, the antialiased bicubic
  resize of ops/resize_matmul.py (reflection at the content's edge) and,
  where ``normalize``, ``clip_normalize``, each rounded where the plain
  chain rounds. On the card one launch a batch, on both routes (the shared
  route is the per-image route with a box stride of 0). CUDA source:
  ``csrc/resize_band.cu``.

The kernel replaces no Pallas kernel: the JAX package leaves the resize to
XLA as two dense products a crop. It computes a row's candidate taps only
(:func:`tap_band`: the hull of the cubic's support and of its two
reflections, which holds every non-zero weight of the dense row), in a
fixed order, so that a crop's values depend on its geometry alone, never on
its batch or route; what bounds it and how it is built is in the note at
the top of its source.

:func:`resize_band_plain` is the same function in plain PyTorch: the dense
matrices of ops/resize_matmul.py and their two products (the port's route
before the kernel), as one batch where the boxes and the contents are
shared, one box an image, or image by image. The CPU runs it, and the card
tests hold the kernel to it. The wrapper takes its plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises,
never falling back. ``resize_band.launches`` counts the launches
(ops/launches.py)."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .block_kernels import _raise_on, _stream
from .preprocess import CLIP_MEAN, CLIP_STD, clip_normalize
from .resize_matmul import (crop_and_resize_matmul, crop_and_resize_matmul_batch,
                            crop_and_resize_matmul_per_image)

DTYPES = (torch.bfloat16, torch.float32)


def max_taps(side: int, out_size: int, antialias: bool = True) -> int:
    """The most candidate taps of a row of a crop that lies inside its
    content, in a bucket whose longer side is ``side``: 4 ss + 5 with ss the
    shrink factor (at most ``side / out_size`` under antialias, else 1), and
    one more for ss's fp32 rounding. Sizes the kernel's shared memory; a row
    with more is written as NaN."""
    return 4 * max(side if antialias else 0, out_size) // out_size + 7


def tap_band(lo, hi, content, out_size: int, antialias: bool = True):
    """The kernel's candidate taps of each output position along one axis,
    in its fp32 arithmetic: crops from ``lo`` to ``hi`` [...] over
    ``content`` valid pixels (broadcast with them) → (first, count), each
    [..., out_size] int64. The candidates are the hull of the supports of
    axis_resize_matrix's three terms inside [0, content): the cubic's
    |i - c| < 2 ss, its reflection at the far edge |(2 (content - 1) - i) -
    c| < 2 ss (i <= content - 2) and at 0 |-i - c| < 2 ss (i >= 1). On the
    card a division by a Python number is a product by its fp32 reciprocal,
    so the centres c are computed that way here too."""
    f32 = torch.float32
    lo = torch.as_tensor(lo, dtype=f32)
    hi = torch.as_tensor(hi, dtype=f32)
    content = torch.as_tensor(content, dtype=f32)[..., None]
    inv = torch.tensor(1.0, dtype=f32) / torch.tensor(float(out_size), dtype=f32)
    span = (hi - lo)[..., None]
    o = torch.arange(out_size, dtype=f32)
    c = lo[..., None] + (o + 0.5) * span * inv - 0.5
    ss = torch.clamp(span * inv, min=1.0) if antialias else torch.ones_like(span)
    r = 2.0 * ss
    kt = 2.0 * (content - 1.0)
    first = last = None
    for centre, low, high in ((c, 0.0, content - 1.0), (kt - c, 0.0, content - 2.0),
                              (-c, 1.0, content - 1.0)):
        s = torch.clamp(torch.floor(centre - r), min=low)
        e = torch.minimum(torch.ceil(centre + r), high)
        s, e = torch.where(s <= e, s, torch.inf), torch.where(s <= e, e, -torch.inf)
        first = s if first is None else torch.minimum(first, s)
        last = e if last is None else torch.maximum(last, e)
    count = torch.clamp(last - first + 1, min=0)
    first = torch.where(count > 0, first, torch.zeros((), dtype=f32))
    return first.long(), count.long()


def resize_band_plain(images: torch.Tensor, boxes: torch.Tensor, content_hw,
                      out_size: int = 224, antialias: bool = True, dtype=torch.float32,
                      normalize: bool = True) -> torch.Tensor:
    """:func:`resize_band`'s function in plain PyTorch, on any device: the
    scaled images resampled by ops/resize_matmul.py's dense products (one
    batch where every image shares the boxes and the content, one box an
    image, else image by image), then ``clip_normalize`` where asked."""
    imgs = images.to(dtype) / 255.0
    rows = torch.as_tensor(content_hw).tolist()
    if boxes.dim() == 2 and all(r == rows[0] for r in rows):
        crops = crop_and_resize_matmul_batch(imgs, boxes, out_size, antialias,
                                             content_hw=tuple(rows[0]))
    elif boxes.dim() == 3 and boxes.shape[1] == 1:
        crops = crop_and_resize_matmul_per_image(imgs, boxes[:, 0], rows, out_size,
                                                 antialias)[:, None]
    else:
        crops = torch.stack([
            crop_and_resize_matmul(imgs[i], boxes if boxes.dim() == 2 else boxes[i], out_size,
                                   antialias, content_hw=tuple(rows[i]))
            for i in range(len(rows))])
    return clip_normalize(crops) if normalize else crops


def resize_band(images: torch.Tensor, boxes: torch.Tensor, content_hw, out_size: int = 224,
                antialias: bool = True, dtype=torch.float32,
                normalize: bool = True) -> torch.Tensor:
    """Every crop of a batch, resized to out_size² and normalised (see the
    module's note): the kernel on the card, :func:`resize_band_plain` on the
    CPU."""
    if dtype not in DTYPES:
        raise ValueError(f"resize_band: dtype must be bf16 or fp32, got {dtype}")
    if images.device.type == "cpu":
        return resize_band_plain(images, boxes, content_hw, out_size, antialias, dtype, normalize)
    b, h, w, ch = images.shape
    n = boxes.shape[-2]
    if images.dtype != torch.uint8 or ch != 3:
        raise ValueError(f"resize_band: images must be uint8 [B, H, W, 3], got {images.dtype} "
                         f"{tuple(images.shape)}")
    if tuple(boxes.shape) not in ((n, 4), (b, n, 4)) or boxes.device != images.device:
        raise ValueError(f"resize_band: boxes must be [N, 4] or [{b}, N, 4] on "
                         f"{images.device}, got {tuple(boxes.shape)} on {boxes.device}")
    images = images.contiguous()
    boxes = boxes.to(torch.float32).contiguous()
    content = torch.as_tensor(content_hw).to(device=images.device, dtype=torch.int32).contiguous()
    if tuple(content.shape) != (b, 2):
        raise ValueError(f"resize_band: content_hw must be [{b}, 2], got {tuple(content.shape)}")
    if images.data_ptr() % 4:
        raise ValueError("resize_band images: data must start on a 4-byte boundary")
    out = torch.empty((b, n, out_size, out_size, 3), dtype=dtype, device=images.device)
    mean, std = ((ctypes.c_float * 3)(*torch.tensor(v, dtype=dtype).float().tolist())
                 for v in (CLIP_MEAN, CLIP_STD))
    lib = _build.load("resize_band")
    rc = lib.leclip_resize_band(images.data_ptr(), boxes.data_ptr(), content.data_ptr(),
                                out.data_ptr(), b, h, w, n, 0 if boxes.dim() == 2 else n * 4,
                                out_size, max_taps(max(h, w), out_size, antialias),
                                int(antialias), int(dtype == torch.bfloat16), int(normalize),
                                mean, std, _stream(images.device))
    _raise_on(rc, "resize_band")
    resize_band.launches += 1
    return out


resize_band.launches = 0
