"""Image preprocessing (counterpart of leclip_tpu/ops/preprocess.py):
``clip_normalize``, ``to_float``, the reference's test transform
(resize-smaller-edge → center-crop → CLIP-normalise, as one central-square
``crop_and_resize``, ops/crops.py), and the train transform:
RandomChoice[RandomResizedCrop, resize + Cutout] → random flip → normalise.
Images are float in [0, 1], NHWC.

Every random train-time function is split in two: a sampler that draws its
parameters from an explicit ``torch.Generator`` (``sample_*``), and an apply
that is deterministic in them. torch and JAX generators cannot give the
same numbers, so the tests feed the applies the draws that the JAX
functions make from their keys."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .crops import crop_and_resize

RRC_TRIALS = 10  # torchvision's rejection trials, picked vectorised
RRC_SCALE = (0.6, 1.0)
RRC_RATIO = (3.0 / 4.0, 4.0 / 3.0)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(img: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """(img - mean) / std over the last (channel) axis, in img's dtype."""
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def to_float(img_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return img_u8.to(dtype) / 255.0


def resize_center_crop(img: torch.Tensor, size: int = 224, method: str = "cubic") -> torch.Tensor:
    """resize-smaller-edge(size) + center-crop(size) ≡ the central square
    resized to size² (bicubic, matching INPUT.INTERPOLATION)."""
    h, w = img.shape[0], img.shape[1]
    side = min(h, w)
    y0, x0 = (h - side) / 2.0, (w - side) / 2.0
    box = torch.tensor([[y0, x0, y0 + side, x0 + side]], dtype=torch.float32)
    return crop_and_resize(img, box, out_size=size, method=method, chunk=1)[0]


def preprocess_eval(img_u8: torch.Tensor, size: int = 224, dtype=torch.float32) -> torch.Tensor:
    """uint8 [H, W, 3] → normalised [size, size, 3]: the whole eval
    transform."""
    return clip_normalize(resize_center_crop(to_float(img_u8, dtype), size))


# --------------------------- train-time augmentations ------------------------


class RRCDraws(NamedTuple):
    """A random resized crop's draws, for any leading batch shape: the area
    fraction and log aspect ratio of each of the ten trials, and the box's
    corner as fractions of the free span."""

    area_frac: torch.Tensor   # [..., 10] in scale
    log_ratio: torch.Tensor   # [..., 10] in log(ratio)
    fy: torch.Tensor          # [...] in [0, 1)
    fx: torch.Tensor          # [...] in [0, 1)


def sample_rrc(generator: torch.Generator, shape: Tuple[int, ...] = (),
               scale: Tuple[float, float] = RRC_SCALE,
               ratio: Tuple[float, float] = RRC_RATIO, device=None) -> RRCDraws:
    """Uniform draws of :class:`RRCDraws` on ``device`` (the generator's)."""
    def uniform(sh, lo, hi):
        return lo + (hi - lo) * torch.rand(sh, generator=generator, device=device)

    return RRCDraws(uniform(shape + (RRC_TRIALS,), *scale),
                    uniform(shape + (RRC_TRIALS,), math.log(ratio[0]), math.log(ratio[1])),
                    uniform(shape, 0.0, 1.0), uniform(shape, 0.0, 1.0))


def random_resized_crop_box(h, w, draws: RRCDraws) -> torch.Tensor:
    """torchvision's RandomResizedCrop box (y0, x0, y1, x1) → [..., 4] from
    its draws: the first of the ten trials whose box fits inside the (h, w)
    content, else a square of side min(h, w); the corner at (fy, fx) of the
    free span. ``h``/``w`` are numbers or tensors of the draws' batch
    shape (bucket-padded batches give each image's content extent)."""
    f32 = torch.float32
    dev = draws.fy.device
    h = torch.as_tensor(h, dtype=f32, device=dev)
    w = torch.as_tensor(w, dtype=f32, device=dev)
    target = (h * w)[..., None] * draws.area_frac
    ar = torch.exp(draws.log_ratio)
    cw = torch.sqrt(target * ar)
    ch = torch.sqrt(target / ar)
    valid = (cw <= w[..., None]) & (ch <= h[..., None])
    side = torch.minimum(h, w)[..., None]
    cw = torch.where(valid, cw, side)
    ch = torch.where(valid, ch, side)
    pick = torch.argmax(valid.to(torch.int8), dim=-1, keepdim=True)  # 0 when none fits
    cw, ch = cw.gather(-1, pick)[..., 0], ch.gather(-1, pick)[..., 0]
    y0 = draws.fy * (h - ch)
    x0 = draws.fx * (w - cw)
    return torch.stack([y0, x0, y0 + ch, x0 + cw], dim=-1)


def random_resized_crop(img: torch.Tensor, draws: RRCDraws, size: int = 224,
                        method: str = "cubic") -> torch.Tensor:
    """One image [H, W, C] → its random resized crop [size, size, C]
    (the gather sampler, as ``resize_center_crop``)."""
    box = random_resized_crop_box(img.shape[0], img.shape[1], draws)[None]
    return crop_and_resize(img, box, out_size=size, method=method, chunk=1)[0]


def sample_flip(generator: torch.Generator, shape: Tuple[int, ...] = (), p: float = 0.5,
                device=None) -> torch.Tensor:
    """Bernoulli(p) flip decisions."""
    return torch.rand(shape, generator=generator, device=device) < p


def random_flip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the W axis of [..., H, W, C] where ``flip`` ([...] bool)."""
    return torch.where(flip.reshape(flip.shape + (1, 1, 1)), img.flip(-2), img)


def sample_cutout(generator: torch.Generator, h: int, w: int, shape: Tuple[int, ...] = (),
                  proportion: float = 0.4, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cutout box's corner (y0, x0), uniform integers in
    [0, max(h - ch, 1)) and [0, max(w - cw, 1))."""
    ch, cw = int(h * proportion), int(w * proportion)
    y0 = torch.randint(0, max(h - ch, 1), shape, generator=generator, device=device)
    x0 = torch.randint(0, max(w - cw, 1), shape, generator=generator, device=device)
    return y0, x0


def cutout(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, proportion: float = 0.4,
           fill: float = 0.0) -> torch.Tensor:
    """CutoutPIL analogue on [..., H, W, C]: the box of side
    (int(H·proportion), int(W·proportion)) at (y0, x0) ([...] each) filled
    with ``fill``."""
    h, w = img.shape[-3], img.shape[-2]
    ch, cw = int(h * proportion), int(w * proportion)
    lead = y0.shape + (1, 1)
    y0, x0 = y0.reshape(lead), x0.reshape(lead)
    rows = torch.arange(h, device=img.device)[:, None]
    cols = torch.arange(w, device=img.device)[None, :]
    inside = (rows >= y0) & (rows < y0 + ch) & (cols >= x0) & (cols < x0 + cw)
    return torch.where(inside[..., None], torch.tensor(fill, dtype=img.dtype,
                                                       device=img.device), img)


class TrainDraws(NamedTuple):
    """Every draw of the train transform, for a leading batch shape: the
    RandomChoice (random resized crop, else the centre crop and a cutout),
    the crop's draws, the cutout corner and the flip."""

    use_rrc: torch.Tensor
    rrc: RRCDraws
    cut_y: torch.Tensor
    cut_x: torch.Tensor
    flip: torch.Tensor


def sample_train(generator: torch.Generator, shape: Tuple[int, ...] = (), size: int = 224,
                 rrc_scale: Tuple[float, float] = RRC_SCALE, cutout_proportion: float = 0.4,
                 device=None) -> TrainDraws:
    """The draws of :func:`preprocess_train` (``shape=()``) or of
    :func:`preprocess_train_batch` (``shape=(B,)``) on ``device``."""
    use_rrc = sample_flip(generator, shape, 0.5, device)
    rrc = sample_rrc(generator, shape, rrc_scale, device=device)
    cut_y, cut_x = sample_cutout(generator, size, size, shape, cutout_proportion, device)
    return TrainDraws(use_rrc, rrc, cut_y, cut_x, sample_flip(generator, shape, 0.5, device))


def preprocess_train(img_u8: torch.Tensor, draws: TrainDraws, size: int = 224,
                     cutout_proportion: float = 0.4, dtype=torch.float32) -> torch.Tensor:
    """The reference train transform on one uint8 [H, W, 3] image:
    RandomChoice[RandomResizedCrop, Resize + Cutout] → flip → normalise."""
    img = to_float(img_u8, dtype)
    a = random_resized_crop(img, draws.rrc, size)
    b = cutout(resize_center_crop(img, size), draws.cut_y, draws.cut_x, cutout_proportion)
    img = torch.where(draws.use_rrc, a, b)
    return clip_normalize(random_flip(img, draws.flip))


def preprocess_train_batch(images_u8: torch.Tensor, content_hw: torch.Tensor,
                           draws: TrainDraws, size: int = 224,
                           cutout_proportion: float = 0.4,
                           dtype=torch.float32) -> torch.Tensor:
    """The train transform on a bucket-padded uint8 batch [B, bh, bw, 3]
    with each image's true (h, w) in ``content_hw`` [B, 2]: the random
    resized crop's box inside the content, else the content's central
    square, scaled to [0, 1] and resampled by the antialiased bicubic
    resizer (ops/resize_kernels.resize_band, one box an image: the banded
    kernel on the card; reflection at the content boundary); the cutout
    on the centre-crop branch only; then the flip and CLIP normalisation.
    → [B, size, size, 3] in ``dtype``."""
    from .resize_kernels import resize_band  # it imports this module

    hw = content_hw.to(device=images_u8.device, dtype=torch.float32)
    h, w = hw[:, 0], hw[:, 1]
    box_rrc = random_resized_crop_box(h, w, draws.rrc)
    side = torch.minimum(h, w)
    cy, cx = h / 2.0, w / 2.0
    box_cc = torch.stack([cy - side / 2, cx - side / 2, cy + side / 2, cx + side / 2], dim=-1)
    box = torch.where(draws.use_rrc[:, None], box_rrc, box_cc)
    crop = resize_band(images_u8, box[:, None], content_hw, size, dtype=dtype,
                       normalize=False)[:, 0]
    cut = cutout(crop, draws.cut_y, draws.cut_x, cutout_proportion)
    crop = torch.where(draws.use_rrc[:, None, None, None], crop, cut)
    return clip_normalize(random_flip(crop, draws.flip))
