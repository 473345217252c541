"""Tiny versions of the benchmark's configurations and cells, for CPU tests:
the program's RN-TEST and ViT-TEST presets, a small bank, small JPEGs, one
TTA scale, short prompts."""

from __future__ import annotations

import copy
import json
import os
import time
import types

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

TINY = {
    "rn50": {"preset": "RN-TEST", "embed_dim": 64, "image_resolution": 64,
             "vision_layers": [1, 1, 1, 1], "vision_width": 8, "vision_patch_size": None,
             "transformer_width": 64, "transformer_heads": 2, "transformer_layers": 2},
    "vitb16": {"preset": "ViT-TEST", "embed_dim": 64, "image_resolution": 64,
               "vision_layers": 2, "vision_width": 64, "vision_patch_size": 16,
               "transformer_width": 64, "transformer_heads": 2, "transformer_layers": 2},
}


def load(rel: str) -> dict:
    with open(os.path.join(BENCH, rel)) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    cfg = load(f"configs/{name}.json")
    cfg.update(copy.deepcopy(TINY[name]))
    cfg["bank_rows"] = 512
    cfg["scales"] = [2]
    n_ctx = {16: 4, 64: 8}
    cfg["members"] = [dict(m, n_ctx=n_ctx[m["n_ctx"]]) for m in cfg["members"]]
    return cfg


def tiny_score_params(cell: str) -> dict:
    params = load(f"workloads/{cell}.json")
    params.update({"pool_images": 8, "batch_images": 4, "sample_images": 8,
                   "sizes": [[128, 96, 3], [96, 128, 3], [112, 112, 2]]})
    return params


def context(cell: str, config: dict, params: dict, seed: int = 2 ** 31 + 5,
            seconds: float = 2.0):
    """A run's context on the CPU, as benchmark/run.py builds it on the card."""
    device = torch.device("cpu")
    return types.SimpleNamespace(
        bench=load("../BENCHMARK.json"), entry={"name": cell}, cell=cell, params=params,
        config=config, seed=seed, seconds=seconds, trace=False, torch=torch, device=device,
        t0=time.perf_counter(), sync=lambda: None)
