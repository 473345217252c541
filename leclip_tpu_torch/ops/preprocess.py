"""Image normalisation (counterpart of ``clip_normalize`` in
leclip_tpu/ops/preprocess.py). The train-time transforms wait for the
training slice."""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(img: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """(img - mean) / std over the last (channel) axis, in img's dtype."""
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std
