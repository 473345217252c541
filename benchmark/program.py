"""The system under test, built from the benchmark's seeded inputs: the
port's scoring engine (``make_engine`` with ``TEST.PREC auto``, members from
the prompt learner and ``build_model_spec``), its trainer step, and its
scoring service. This file and the drivers are the only ones that import the
program; the reference under benchmark/reference/ imports none of it."""

from __future__ import annotations

from typing import Dict

import torch

# the libraries each precision's route launches (ops/_build.KERNELS names)
ROUTE_KERNELS = {
    "bf16-rn": ["conv_bf16", "conv_fp32"],
    "int8-vit": ["ln_quant", "attn_block_int8", "mlp_int8"],
    "fp32-train": [],
}


def build_kernels(route: str, device) -> Dict[str, float]:
    """nvcc the route's libraries into the package's build directory (kept
    in the checkout, hashed by source); {library: seconds} of those built
    now, empty when every one was there or off the card (whose routes run
    the kernels' plain versions)."""
    from leclip_tpu_torch.ops._build import build_all

    names = ROUTE_KERNELS[route]
    return build_all(names) if names and device.type == "cuda" else {}


def clip_config(cfg: dict):
    from leclip_tpu_torch.models.clip import PRESETS

    clip_cfg = PRESETS[cfg["preset"]]
    for key in ("embed_dim", "image_resolution", "vision_width", "vision_patch_size",
                "context_length", "vocab_size", "transformer_width", "transformer_heads",
                "transformer_layers"):
        if getattr(clip_cfg, key) != cfg[key]:
            raise ValueError(f"{cfg['preset']}: {key} is {getattr(clip_cfg, key)} in the "
                             f"program's preset, {cfg[key]} in the configuration")
    return clip_cfg


def build_engine(cfg: dict, weights: dict, members: Dict[str, dict], bank: torch.Tensor,
                 device, prec: str = "auto"):
    """The engine ``cli/eval.py`` builds, on the benchmark's weights, members
    and bank: ``TEST.PREC auto`` (``prec``), the eval CLI's defaults
    otherwise."""
    from leclip_tpu_torch.engine.config import default_config
    from leclip_tpu_torch.inference.pipeline import make_engine
    from leclip_tpu_torch.inference.tta import build_model_spec
    from leclip_tpu_torch.models.dense_clip import DenseFlags
    from leclip_tpu_torch.models.prompt import build_prompt_learner

    conf = default_config()
    conf.TEST.PREC = prec
    conf.TEST.multi_scale = tuple(cfg["scales"])
    conf.TEST.retrieval_topk = cfg["topk"]
    clip_cfg = clip_config(cfg)
    constants = {}
    specs = {}
    for m in cfg["members"]:
        n_ctx = m["n_ctx"]
        if n_ctx not in constants:
            _, constants[n_ctx] = build_prompt_learner(
                torch.Generator(device=device).manual_seed(0), weights, cfg["classnames"],
                n_ctx=n_ctx)
        flags = DenseFlags(use_evidence=m["evidence"], learn_scale=False,
                           learn_spatial_scale=False,
                           spatial_scale_image=float(cfg["spatial_scale_image"]))
        specs[m["name"]] = build_model_spec(weights, clip_cfg, members[m["name"]]["trainable"],
                                            constants[n_ctx], flags)
    return make_engine(conf, weights, clip_cfg, specs, caption_bank=bank, device=device,
                       mesh=None)


def engine_route(engine) -> str:
    """Which precision route the engine resolved to."""
    if engine.precision == "int8":
        return "int8"
    return "fp32" if engine.compute_dtype == torch.float32 else "bf16"
