"""Image preprocessing (counterpart of the eval half of
leclip_tpu/ops/preprocess.py): ``clip_normalize``, ``to_float``, and the
reference's test transform, resize-smaller-edge → center-crop →
CLIP-normalise, as one central-square ``crop_and_resize`` (ops/crops.py; no
intermediate full-size resize). Images are float in [0, 1], NHWC. The
train-time augmentations (random resized crop, flip, cutout) are not ported
yet (ROADMAP.md queue 1)."""

from __future__ import annotations

import torch

from .crops import crop_and_resize

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
