"""Class co-occurrence statistics (`freq_stats.pkl`); the port's own copy of
leclip_tpu/data/freq_stats.py.

The reference ships this artifact pre-built (project/my_code/freq_stats.pkl:
{'adj': [80,80] float64 co-occurrence counts with zero diagonal,
'nums': [80] per-class counts}) and uses it for test-time score modulation
(Caption_distill_double.py:614-636) and the ranking_with_cooccurrence loss.
This module is the builder the reference never shipped, plus load/save."""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np


def build_freq_stats(labels: np.ndarray) -> Dict[str, np.ndarray]:
    """Label matrix [N, C] (multi-hot) → {'adj', 'nums'}.

    adj[i, j] = number of samples containing both i and j (diagonal zeroed);
    nums[i] = number of samples containing i."""
    lab = np.asarray(labels, np.float64)
    nums = lab.sum(axis=0)
    adj = lab.T @ lab
    np.fill_diagonal(adj, 0.0)
    return {"adj": adj, "nums": nums}


def save_freq_stats(stats: Dict[str, np.ndarray], path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(stats, f)


def load_freq_stats(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return pickle.load(f)
