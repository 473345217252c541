"""RandAugment on tensors (counterpart of leclip_tpu/ops/randaugment.py): the
reference's policy library (Dassl dassl/data/transforms/randaugment.py) as
functions of (image [H, W, C] in [0, 1], signed level, the op's own draws),
so that augmentation runs on the image's device instead of PIL.

Geometric ops are inverse-affine bilinear warps (:func:`affine_warp`, ``fill``
outside the image); colour ops are elementwise. Sampling is split from
applying: :func:`sample_randaugment` draws the op indices, signs and the
cutout centres from a ``torch.Generator``, :func:`randaugment_apply` is
deterministic in them. Levels are float32, as the JAX functions compute
them."""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple

import torch
import torch.nn.functional as F

MAX_LEVEL = 30.0
_F32 = torch.float32


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=device)


# ----------------------------- warp machinery --------------------------------


def affine_warp(img: torch.Tensor, matrix: torch.Tensor, fill: float = 0.5) -> torch.Tensor:
    """Inverse-warp [H, W, C] by a 2x3 affine ``matrix`` (output → input
    coordinates, (y, x) order), bilinear, ``fill`` outside the image."""
    h, w = img.shape[0], img.shape[1]
    m = matrix.to(device=img.device, dtype=_F32)
    yy = torch.arange(h, dtype=_F32, device=img.device)[:, None]
    xx = torch.arange(w, dtype=_F32, device=img.device)[None, :]
    src_y = m[0, 0] * yy + m[0, 1] * xx + m[0, 2]
    src_x = m[1, 0] * yy + m[1, 1] * xx + m[1, 2]
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    ty, tx = (src_y - y0)[..., None], (src_x - x0)[..., None]
    fill_t = torch.tensor(fill, dtype=img.dtype, device=img.device)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = img[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return torch.where(valid[..., None], vals, fill_t)

    out = (gather(y0, x0) * (1 - ty) * (1 - tx) + gather(y0, x0 + 1) * (1 - ty) * tx
           + gather(y0 + 1, x0) * ty * (1 - tx) + gather(y0 + 1, x0 + 1) * ty * tx)
    return out.to(img.dtype)


def _center_affine(h: int, w: int, a, b, c, d, device=None) -> torch.Tensor:
    """Affine about the image centre: [src_y, src_x] = M @ [y − cy, x − cx] +
    centre, as a 2x3 matrix."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    m = torch.stack([torch.stack([_f32(a, device), _f32(b, device)]),
                     torch.stack([_f32(c, device), _f32(d, device)])])
    ctr = _f32([cy, cx], device)
    offset = ctr - m @ ctr
    return torch.cat([m, offset[:, None]], dim=1)


# ----------------------------- individual ops --------------------------------
# each op: (image, level, draws) → image; ``draws`` (two uniforms) is read by
# cutout_op alone


def _blend(a, b, factor):
    return torch.clamp(b + factor * (a - b), 0.0, 1.0)


def identity(img, level, draws=None):
    return img


def brightness(img, level, draws=None):
    return _blend(img, torch.zeros_like(img), 1.0 + _f32(level, img.device))


def color(img, level, draws=None):
    gray = img.mean(-1, keepdim=True) * torch.ones_like(img)
    return _blend(img, gray, 1.0 + _f32(level, img.device))


def contrast(img, level, draws=None):
    return _blend(img, img.mean().expand_as(img), 1.0 + _f32(level, img.device))


def solarize(img, level, draws=None):
    thresh = 1.0 - _f32(level, img.device).abs()
    return torch.where(img >= thresh, 1.0 - img, img)


def posterize(img, level, draws=None):
    bits = torch.clamp(8 - torch.floor(_f32(level, img.device).abs() * 6).to(torch.int32), 1, 8)
    scale = (2.0 ** bits.to(_F32) - 1).to(img.dtype)
    return torch.round(img * scale) / scale


def sharpness(img, level, draws=None):
    c = img.shape[-1]
    kernel = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=img.dtype,
                          device=img.device) / 13.0
    blurred = F.conv2d(img.permute(2, 0, 1)[None], kernel.expand(c, 1, 3, 3), padding=1,
                       groups=c)[0].permute(1, 2, 0)
    return _blend(img, blurred, 1.0 + _f32(level, img.device))


def autocontrast(img, level, draws=None):
    lo = img.amin(dim=(0, 1), keepdim=True)
    hi = img.amax(dim=(0, 1), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo + 1e-8), torch.ones_like(hi))
    return torch.clamp((img - lo) * scale, 0.0, 1.0)


def equalize(img, level, draws=None):
    """Per-channel histogram equalisation over 256 bins."""
    def eq_channel(ch):
        flat = torch.clamp((ch * 255).to(torch.int32), 0, 255).long()
        hist = torch.bincount(flat.reshape(-1), minlength=256).to(_F32)
        cdf = torch.cumsum(hist, 0)
        cdf_min = cdf[torch.argmax((hist > 0).to(torch.int8))]
        denom = torch.clamp(cdf[-1] - cdf_min, min=1.0)
        lut = torch.clamp((cdf - cdf_min) / denom, 0.0, 1.0)
        return lut[flat]

    return torch.stack([eq_channel(img[..., i]) for i in range(img.shape[-1])], dim=-1)


def rotate(img, level, draws=None):
    theta = _f32(level, img.device) * math.pi / 6.0  # up to ±30° at full magnitude
    c, s = torch.cos(theta), torch.sin(theta)
    return affine_warp(img, _center_affine(img.shape[0], img.shape[1], c, -s, s, c, img.device))


def shear_x(img, level, draws=None):
    return affine_warp(img, _center_affine(img.shape[0], img.shape[1], 1.0, 0.0, level, 1.0,
                                           img.device))


def shear_y(img, level, draws=None):
    return affine_warp(img, _center_affine(img.shape[0], img.shape[1], 1.0, level, 0.0, 1.0,
                                           img.device))


def translate_x(img, level, draws=None):
    shift = _f32(level, img.device) * img.shape[1] / 3.0
    zero, one = _f32(0.0, img.device), _f32(1.0, img.device)
    return affine_warp(img, torch.stack([torch.stack([one, zero, zero]),
                                         torch.stack([zero, one, -shift])]))


def translate_y(img, level, draws=None):
    shift = _f32(level, img.device) * img.shape[0] / 3.0
    zero, one = _f32(0.0, img.device), _f32(1.0, img.device)
    return affine_warp(img, torch.stack([torch.stack([one, zero, -shift]),
                                         torch.stack([zero, one, zero])]))


def invert(img, level, draws=None):
    """ImageOps.invert: used by the AutoAugment policies, not RandAugment."""
    return 1.0 - img


def cutout_op(img, level, draws):
    """A square of side max(|level|·min(H, W)/2, 1) filled with 0.5, centred
    at (draws[0]·H, draws[1]·W)."""
    h, w = img.shape[0], img.shape[1]
    size = torch.clamp(_f32(level, img.device).abs() * 0.5 * min(h, w), min=1.0)
    d = _f32(draws, img.device)
    cy, cx = d[0] * h, d[1] * w
    yy = torch.arange(h, dtype=_F32, device=img.device)[:, None]
    xx = torch.arange(w, dtype=_F32, device=img.device)[None, :]
    inside = ((yy - cy).abs() < size / 2) & ((xx - cx).abs() < size / 2)
    return torch.where(inside[..., None], torch.tensor(0.5, dtype=img.dtype,
                                                       device=img.device), img)


RANDAUGMENT_OPS: List[Callable] = [
    identity, brightness, color, contrast, solarize, posterize, sharpness,
    autocontrast, equalize, rotate, shear_x, shear_y, translate_x,
    translate_y, cutout_op,
]


class RandAugmentDraws(NamedTuple):
    op: torch.Tensor     # [n] op indices into RANDAUGMENT_OPS
    sign: torch.Tensor   # [n] ±1
    args: torch.Tensor   # [n, 2] uniforms, each op's own draws


def sample_randaugment(generator: torch.Generator, num_ops: int = 2) -> RandAugmentDraws:
    """The RandAugment recipe's draws (on the generator's device): ``num_ops``
    uniformly chosen ops, each with a random sign."""
    dev = generator.device
    op = torch.randint(0, len(RANDAUGMENT_OPS), (num_ops,), generator=generator, device=dev)
    sign = torch.where(torch.rand(num_ops, generator=generator, device=dev) < 0.5, 1.0, -1.0)
    return RandAugmentDraws(op, sign, torch.rand(num_ops, 2, generator=generator, device=dev))


def randaugment_apply(img: torch.Tensor, draws: RandAugmentDraws,
                      magnitude: float = 9.0) -> torch.Tensor:
    """Apply the drawn ops in turn at level ``sign · magnitude / 30``."""
    level = _f32(magnitude / MAX_LEVEL)
    for op, sign, args in zip(draws.op.tolist(), draws.sign.to(_F32).cpu(), draws.args):
        img = RANDAUGMENT_OPS[op](img, sign * level, args)
    return img


def randaugment(generator: torch.Generator, img: torch.Tensor, num_ops: int = 2,
                magnitude: float = 9.0) -> torch.Tensor:
    """The RandAugment recipe in one call: :func:`sample_randaugment` from
    ``generator``, then :func:`randaugment_apply` (the JAX package's
    ``randaugment(key, img, ...)``, a generator in place of the key)."""
    return randaugment_apply(img, sample_randaugment(generator, num_ops), magnitude)
