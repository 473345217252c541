"""CLIP assembly: config, presets, seeded init and encode functions
(counterpart of leclip_tpu/models/clip.py).

Parameters are nested dicts of tensors with the JAX package's keys and
layouts ([in, out] kernels, block params stacked on a leading layer axis),
so ``models/convert.py`` moves a JAX pytree in value for value."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from ..device import resolve_device
from .resnet import encode_image_resnet, init_resnet_params
from .text import init_text_params
from .vit import encode_image_vit, init_vit_params


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    image_resolution: int
    vision_layers: Union[Tuple[int, int, int, int], int]
    vision_width: int
    vision_patch_size: Optional[int]
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64

    @property
    def grid_size(self) -> int:
        if self.is_vit:
            return self.image_resolution // self.vision_patch_size
        return self.image_resolution // 32


PRESETS = {
    "RN50": CLIPConfig(1024, 224, (3, 4, 6, 3), 64, None),
    "RN101": CLIPConfig(512, 224, (3, 4, 23, 3), 64, None),
    "RN50x4": CLIPConfig(
        640, 288, (4, 6, 10, 6), 80, None,
        transformer_width=640, transformer_heads=10, transformer_layers=12,
    ),
    "RN50x16": CLIPConfig(
        768, 384, (6, 8, 18, 8), 96, None,
        transformer_width=768, transformer_heads=12, transformer_layers=12,
    ),
    "ViT-B/32": CLIPConfig(512, 224, 12, 768, 32),
    "ViT-B/16": CLIPConfig(512, 224, 12, 768, 16),
    "ViT-L/14": CLIPConfig(
        768, 224, 24, 1024, 14,
        transformer_width=768, transformer_heads=12, transformer_layers=12,
    ),
    "RN-SYN": CLIPConfig(
        128, 64, (1, 1, 1, 1), 16, None,
        transformer_width=128, transformer_heads=4, transformer_layers=4,
    ),
    "ViT-SYN": CLIPConfig(
        512, 64, 12, 768, 16,
        transformer_width=256, transformer_heads=4, transformer_layers=4,
    ),
    "ViT-SYN-L": CLIPConfig(
        512, 64, 12, 1024, 16,
        transformer_width=256, transformer_heads=4, transformer_layers=4,
    ),
    # miniature towers for tests / smoke runs (not real CLIP geometries)
    "RN-TEST": CLIPConfig(
        64, 64, (1, 1, 1, 1), 8, None,
        transformer_width=64, transformer_heads=2, transformer_layers=2,
    ),
    "ViT-TEST": CLIPConfig(
        64, 64, 2, 64, 16,
        transformer_width=64, transformer_heads=2, transformer_layers=2,
    ),
}


def init_clip_params(generator: torch.Generator, cfg: CLIPConfig,
                     dtype=torch.float32, device=None) -> dict:
    """Random CLIP params with the reference's init scheme, drawn from
    ``generator`` (which must live on ``device``). The numbers differ from
    the JAX package's for the same seed; tests move one pytree across with
    models/convert.py instead."""
    device = resolve_device(device)
    if cfg.is_vit:
        visual = init_vit_params(
            generator, cfg.image_resolution, cfg.vision_patch_size, cfg.vision_width,
            cfg.vision_layers, cfg.embed_dim, dtype, device,
        )
    else:
        visual = init_resnet_params(
            generator, cfg.vision_layers, cfg.embed_dim, cfg.image_resolution,
            cfg.vision_width, dtype, device,
        )
    return {
        "visual": visual,
        "text": init_text_params(
            generator, cfg.vocab_size, cfg.context_length, cfg.transformer_width,
            cfg.transformer_layers, cfg.embed_dim, dtype, device,
        ),
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=device),
    }


def clip_encode_image(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                      dense: bool = False, if_pos: bool = True, impl: str = "auto",
                      q8: dict = None, fused: bool = False, pool_map: bool = True):
    """Images [B, H, W, 3] (normalised) → global [B, E]; with ``dense`` also
    the per-position embeddings (ViT), or the pool map (None under
    ``pool_map=False``) and the trunk map (ResNet). ``impl`` routes the
    unfused ViT attention (ops/attention.py); ``q8``: stacked int8 block
    weights of the ViT tower (ops/quant.py), the W8A8 path; ``fused``: bf16
    block kernels (ViT). ``if_pos`` and ``pool_map`` are the ResNet pool's
    (models/resnet.py)."""
    if cfg.is_vit:
        return encode_image_vit(images, params["visual"], cfg.vision_heads,
                                cfg.vision_patch_size, dense=dense, impl=impl, q8=q8,
                                fused=fused)
    return encode_image_resnet(images, params["visual"], cfg.vision_heads, dense=dense,
                               if_pos=if_pos, pool_map=pool_map)


def config_from_state_dict(sd: dict) -> CLIPConfig:
    """Architecture geometry from an OpenAI-format state dict's shapes
    (``sd`` maps name → anything with ``.shape``)."""
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len(
            {k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks")}
        )
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        counts = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4)
        )
        vision_layers = counts
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_patch_size = None
        image_resolution = out_width * 32

    embed_dim = sd["text_projection"].shape[1]
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=embed_dim,
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len(
            {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}
        ),
    )
