"""Matmul-formulated batched crop + bicubic resize (counterpart of
leclip_tpu/ops/resize_matmul.py).

Separable resampling as two dense products per crop,

    out[o, p, c] = Σ_h Σ_w  R_y[o, h] · img[h, w, c] · R_x[p, w]

with per-crop interpolation matrices. Keys cubic a=-0.5 (PIL's bicubic);
``antialias`` widens the support by the downscale factor and renormalises
rows (PIL behaviour on downscale); out-of-range taps reflect once at the
content boundary; rows renormalised in fp32, matrices then cast to the image
dtype; both products accumulate in fp32 and round to the image dtype, as the
JAX function does."""

from __future__ import annotations

import torch


def cubic_kernel(x: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """Keys cubic convolution kernel (a=-0.5 → Catmull-Rom, PIL's bicubic)."""
    ax = x.abs()
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(ax <= 1.0, inner, torch.where(ax < 2.0, outer, zero))


def axis_resize_matrix(lo, hi, content, bucket: int, out_size: int,
                       antialias: bool = True, device=None) -> torch.Tensor:
    """Interpolation matrices resampling the [lo, hi) spans of an axis with
    ``content`` valid pixels (bucket-padded to ``bucket``). ``lo``/``hi`` are
    [N] (or scalars) → [N, out_size, bucket] (or [out_size, bucket])."""
    f32 = torch.float32
    lo = torch.as_tensor(lo, dtype=f32, device=device)
    hi = torch.as_tensor(hi, dtype=f32, device=lo.device)
    content = torch.as_tensor(content, dtype=f32, device=lo.device)
    span = (hi - lo)[..., None]                                          # [N, 1]
    o = torch.arange(out_size, dtype=f32, device=lo.device)
    centers = lo[..., None] + (o + 0.5) * span / out_size - 0.5           # [N, O]
    if antialias:
        ss = torch.clamp(span / out_size, min=1.0)[..., None]             # [N, 1, 1]
    else:
        ss = torch.ones((), dtype=f32, device=lo.device)
    i = torch.arange(bucket, dtype=f32, device=lo.device)                 # [W]
    c = centers[..., None]                                                # [N, O, 1]
    w = cubic_kernel((i - c) / ss)
    zero = torch.zeros((), dtype=f32, device=lo.device)
    top = cubic_kernel((2.0 * (content - 1.0) - i - c) / ss)
    w = w + torch.where(i <= content - 2.0, top, zero)
    bot = cubic_kernel((-i - c) / ss)
    w = w + torch.where(i >= 1.0, bot, zero)
    w = torch.where(i < content, w, zero)                                 # zero pad cols
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)


def _matrices(boxes, h, w, H, W, out_size, antialias, dtype):
    boxes = boxes.float()
    ry = axis_resize_matrix(boxes[:, 0], boxes[:, 2], h, H, out_size, antialias,
                            device=boxes.device).to(dtype)               # [N, O, H]
    rx = axis_resize_matrix(boxes[:, 1], boxes[:, 3], w, W, out_size, antialias,
                            device=boxes.device).to(dtype)               # [N, O, W]
    return ry, rx


def crop_and_resize_matmul(image: torch.Tensor, boxes: torch.Tensor, out_size: int = 224,
                           antialias: bool = True, content_hw=None) -> torch.Tensor:
    """One image [H, W, C] and boxes [N, 4] (y0, x0, y1, x1) → [N, out, out, C]."""
    return crop_and_resize_matmul_batch(image[None], boxes, out_size, antialias,
                                        content_hw)[0]


def crop_and_resize_matmul_batch(images: torch.Tensor, boxes: torch.Tensor,
                                 out_size: int = 224, antialias: bool = True,
                                 content_hw=None) -> torch.Tensor:
    """Shared-geometry batch: every image has the same content (h, w), so the
    interpolation matrices are built once. images [B, H, W, C], boxes [N, 4]
    → [B, N, out, out, C]."""
    B, H, W, C = images.shape
    h = content_hw[0] if content_hw is not None else H
    w = content_hw[1] if content_hw is not None else W
    ry, rx = _matrices(boxes, h, w, H, W, out_size, antialias, images.dtype)
    img_cw = images.permute(0, 3, 2, 1).reshape(B, C * W, H)
    tmp = torch.einsum("noh,bxh->bnox", ry.float(), img_cw.float()).to(images.dtype)
    tmp = tmp.reshape(B, -1, out_size, C, W)
    out = torch.einsum("bnocw,npw->bnopc", tmp.float(), rx.float())
    return out.to(images.dtype)
