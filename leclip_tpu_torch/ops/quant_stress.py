"""Activation-outlier stress for the int8 (W8A8) accuracy gates (counterpart
of leclip_tpu/ops/quant_stress.py), on the port's stacked block tree.

Real CLIP towers show per-channel activation scales that are mildly
log-normal, with under 1% of channels carrying 20-100x outliers (LLM.int8
§3, SmoothQuant §3). These helpers plant that statistic without changing
the function: the LayerNorm gain and bias channels are scaled by a
per-channel profile m and the consuming kernel's input rows divided by m,
so the fp forward is the same function while the quantizer sees m-times
outliers at both LN → matmul boundaries. The profile is drawn with numpy
from a seed, the same numbers as the JAX package's."""

from __future__ import annotations

import numpy as np
import torch


def fitted_channel_scales(layers: int, width: int, seed: int = 7, sigma: float = 0.25,
                          outlier_frac: float = 0.008, outlier_mult: float = 50.0) -> np.ndarray:
    """[layers, width] per-channel activation-scale multipliers: a log-normal
    body (σ 0.25) and ``outlier_frac`` of each layer's channels at
    ``outlier_mult`` times (0.8% at 50x by default)."""
    rng = np.random.default_rng(seed)
    m = np.exp(rng.normal(0.0, sigma, (layers, width))).astype(np.float32)
    n_out = round(outlier_frac * width) if outlier_frac else 0
    for layer in range(layers):
        if n_out:
            m[layer, rng.choice(width, n_out, replace=False)] *= outlier_mult
    return m


def apply_outlier_profile(blocks: dict, m: np.ndarray) -> dict:
    """The profile ``m`` ([layers, width]) planted into a stacked block tree:
    ln_1 / ln_2 channels scaled by m, the rows of qkv_kernel / fc_kernel
    divided by m. Returns a new tree; ``blocks`` is not changed."""
    b = dict(blocks)
    mt = torch.as_tensor(m, device=blocks["ln_1"]["scale"].device)
    b["ln_1"] = {"scale": blocks["ln_1"]["scale"] * mt, "bias": blocks["ln_1"]["bias"] * mt}
    b["attn"] = dict(blocks["attn"], qkv_kernel=blocks["attn"]["qkv_kernel"] / mt[:, :, None])
    b["ln_2"] = {"scale": blocks["ln_2"]["scale"] * mt, "bias": blocks["ln_2"]["bias"] * mt}
    b["mlp"] = dict(blocks["mlp"], fc_kernel=blocks["mlp"]["fc_kernel"] / mt[:, :, None])
    return b


def inject_outliers(blocks: dict, mult: float, channels=(5, 17, 42),
                    heavy_tail: bool = False) -> dict:
    """The given channels scaled by ``mult`` in every layer; ``heavy_tail``
    also spreads the fitted log-normal body over every channel."""
    layers, width = blocks["ln_1"]["scale"].shape
    m = np.ones((layers, width), np.float32)
    if heavy_tail:
        m = m * fitted_channel_scales(layers, width, outlier_frac=0.0)
    m[:, list(channels)] = mult
    return apply_outlier_profile(blocks, m)
