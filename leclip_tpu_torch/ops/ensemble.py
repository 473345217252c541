"""Ensemble post-processing (counterpart of leclip_tpu/ops/ensemble.py).

* torch versions of the on-device fusion math used by the fused TTA path:
  ``adjust_predictions``, ``aggregate_blocks``, ``fuse``, ``fuse6``;
* numpy copies of the host-side pieces: ``normalized_cooccurrence``,
  ``routing_vector``, ``DEFAULT_ROUTING`` and ``generate_final_answers``
  (with its ``fuse``/``fuse6``/``model_result``/``route_ensemble`` helpers).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# Per-class model routing from the winning submission (gen_final_ans.py:143-149)
DEFAULT_ROUTING: Dict[str, List[int]] = {
    "ema": [2, 6, 7, 8, 14, 16, 17, 25, 27, 31, 33, 34, 37, 38, 39, 40, 41, 43,
            49, 52, 57, 62, 67, 73, 74, 76],
    "zema": [0, 4, 21, 23, 32, 35, 45, 53, 54, 55, 58, 59, 61],
    "diff": [13, 22, 42, 78],
    "diffh": [24, 26, 47, 56],
    "difft": [1, 3, 12, 29, 36, 68, 72, 79],
}


# ------------------------------ torch (device) -------------------------------


def adjust_predictions(preds: torch.Tensor, p_matrix: torch.Tensor,
                       weight: float = 0.5) -> torch.Tensor:
    """out + w·(out @ P̂) — boosts classes that co-occur with confident ones."""
    return preds + weight * (preds @ p_matrix)


def aggregate_blocks(block_scores: torch.Tensor, threshold: float = 0.3,
                     coef: float = 1.4, base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per class: the max block score if it clears ``threshold``, else the
    min; scaled and added to the base score. block_scores [N, n_blocks, C]."""
    alpha = block_scores.amax(dim=1)
    beta = block_scores.amin(dim=1)
    gamma = (alpha > threshold).to(block_scores.dtype)
    s_ag = gamma * alpha + (1 - gamma) * beta
    return coef * s_ag if base is None else coef * s_ag + base


def fuse(data: torch.Tensor, sims_blocks: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """Similarity- then variance-weighted block fusion.
    data [N, n_blocks, C]; sims_blocks [N, n_blocks, k]."""
    sims = 1.0 + sims_blocks.mean(-1, keepdim=True)
    data = sims * data
    var = 1.0 + data.var(dim=2, keepdim=True, correction=1)
    data = var * data
    alpha = data.amax(dim=1)
    beta = data.amin(dim=1)
    gamma = (alpha > threshold).to(data.dtype)
    return gamma * alpha + (1 - gamma) * beta


def fuse6(data: torch.Tensor, sims_blocks: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """Variance weighting applied twice, before and after the similarity
    weighting (the 'best' member only)."""
    var0 = 1.0 + data.var(dim=2, keepdim=True, correction=1)
    sims = 1.0 + sims_blocks.mean(-1, keepdim=True)
    data_sim = sims * data
    var1 = 1.0 + data_sim.var(dim=2, keepdim=True, correction=1)
    data = var0 * var1 * data_sim
    alpha = data.amax(dim=1)
    beta = data.amin(dim=1)
    gamma = (alpha > threshold).to(data.dtype)
    return gamma * alpha + (1 - gamma) * beta


# ------------------------------- numpy (host) --------------------------------


def normalized_cooccurrence(adj: np.ndarray, nums: np.ndarray) -> np.ndarray:
    """P̂[i, j]: row-normalised P(j | i) from co-occurrence counts."""
    p = adj / nums[:, None]
    return p / p.sum(-1, keepdims=True)


def routing_vector(model_names: Sequence[str], routing: Dict[str, List[int]] = DEFAULT_ROUTING,
                   base: str = "best", n_cls: int = 80) -> np.ndarray:
    """class → model-index vector for gather-based routing."""
    names = list(model_names)
    base_idx = names.index(base) if base in names else 0
    r = np.full(n_cls, base_idx, np.int32)
    for name, cols in routing.items():
        if name in names:
            valid = [c for c in cols if c < n_cls]
            r[valid] = names.index(name)
    return r


def _np_fuse(data, sims_blocks, threshold=0.2, twice=False):
    data = np.asarray(data)
    sims = 1.0 + np.asarray(sims_blocks).mean(-1, keepdims=True)
    if twice:
        var0 = 1.0 + data.var(axis=2, keepdims=True, ddof=1)
        data_sim = sims * data
        data = var0 * (1.0 + data_sim.var(axis=2, keepdims=True, ddof=1)) * data_sim
    else:
        data = sims * data
        data = (1.0 + data.var(axis=2, keepdims=True, ddof=1)) * data
    alpha = data.max(axis=1)
    beta = data.min(axis=1)
    gamma = (alpha > threshold).astype(data.dtype)
    return gamma * alpha + (1 - gamma) * beta


def model_result(outputs: Dict[str, np.ndarray], sims_blocks: np.ndarray,
                 use_fuse6: bool = False, coef: float = 1.5, aux_coef: float = 1.0) -> np.ndarray:
    """Fused score of one member: (output + coef·fuse(blocks)) +
    aux_coef·(output_pos + coef·fuse(pos_blocks))."""
    o = outputs["output"] + coef * _np_fuse(outputs["output_blocks"], sims_blocks,
                                            twice=use_fuse6)
    a = outputs["output_pos"] + coef * _np_fuse(outputs["output_pos_blocks"], sims_blocks,
                                                twice=use_fuse6)
    return o + aux_coef * a


def route_ensemble(per_model: Dict[str, np.ndarray], routing: Dict[str, List[int]] = DEFAULT_ROUTING,
                   base: str = "best") -> np.ndarray:
    """Start from the base member's scores; overwrite each routed class
    column from its specialist member."""
    if base not in per_model:
        base = next(iter(per_model))
    fused = per_model[base].copy()
    n_cls = fused.shape[1]
    for name, cols in routing.items():
        cols = [c for c in cols if c < n_cls]
        if name in per_model and cols:
            fused[:, cols] = per_model[name][:, cols]
    return fused


def write_impreds(fused: np.ndarray, out_path: str) -> None:
    """The competition ``impreds.json``: one list of class scores per image."""
    with open(out_path, "w") as f:
        json.dump([row.tolist() for row in np.asarray(fused, np.float64)], f)


def generate_final_answers(data: Dict[str, Dict[str, np.ndarray]], sims_blocks: np.ndarray,
                           routing: Dict[str, List[int]] = DEFAULT_ROUTING, base: str = "best",
                           coef: float = 1.5, out_path: Optional[str] = None) -> np.ndarray:
    """Per-member fusion → per-class routing → (optionally) ``impreds.json``."""
    per_model = {
        name: model_result(outputs, sims_blocks, use_fuse6=(name == base), coef=coef,
                           aux_coef=1.5 if name == base else 1.0)
        for name, outputs in data.items()
    }
    fused = route_ensemble(per_model, routing, base=base)
    if out_path:
        write_impreds(fused, out_path)
    return fused
