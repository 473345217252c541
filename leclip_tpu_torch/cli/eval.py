"""Evaluation / full-competition-inference CLI (counterpart of
leclip_tpu/cli/eval.py, same arguments): loads the six prompt checkpoints
with their launcher groupings, TTA-scores every test image once (image
features shared across members), applies fuse/fuse6 + per-class routing and
writes ``impreds.json``.

Usage:
    python -m leclip_tpu_torch.cli.eval \\
        --model-dir best_model --weights ViT-B-16.pt \\
        --caption-bank caption_bank.pkl DATASET.ROOT /data --out impreds.json

Runs on the card; ``--device cpu`` runs it on the CPU explicitly. The
precision follows ``TEST.PREC`` (engine/config.py resolve_test_precision):
``auto`` is int8 for a gate-validated ViT on the card and bf16 otherwise.
``--save-dir DIR`` takes the per-member dump path: ``DIR/data.pkl`` and
``DIR/sim_matrix.pkl`` are written (``cli/gen_final_ans.py`` fuses them
again later) and fused into the same ``impreds.json``."""

from __future__ import annotations

import argparse
import json
import os
import pickle
from os.path import join
from typing import List

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="leclip_tpu_torch ensemble TTA inference")
    ap.add_argument("--dataset-config", default="")
    ap.add_argument("--trainer-config", default="")
    ap.add_argument("--model-dir", default="best_model")
    ap.add_argument("--weights", default="")
    ap.add_argument("--backbone", default="")
    ap.add_argument("--caption-bank", default="", help="pickled [N,E] caption feature bank")
    ap.add_argument("--freq-stats", default="", help="freq_stats.pkl (adj + nums)")
    ap.add_argument("--out", default="impreds.json")
    ap.add_argument("--save-dir", default="")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    return ap.parse_args(argv)


# --- own copies of the dataset helpers the eval pass needs ------------------


def _load_classnames(root: str) -> List[str]:
    from ..data.vocab import COCO_OBJECT_CATEGORIES

    path = join(root, "classes.txt")
    if os.path.exists(path):
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]
    return list(COCO_OBJECT_CATEGORIES)


def _load_test_images(root: str, select: str, final: bool = True,
                      img_dir: str = "images") -> List[str]:
    """imnames_final{A}.json under images/ (mix/check), or imnames_{A}.json
    under dataset_{A}/ (zema/zuan/plain)."""
    name = f"imnames_final{select}.json" if final else f"imnames_{select}.json"
    path = join(root, name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        imnames = json.load(f)
    return [join(root, img_dir, n.split("/")[-1]) for n in imnames]


def eval_split(cfg):
    """(classnames, test image paths) for DATASET.NAME, with the data roots
    of leclip_tpu/data/datasets.py."""
    root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT)) if cfg.DATASET.ROOT else ""
    select = cfg.DATASET.dataset_select
    name = cfg.DATASET.NAME
    if name == "chatglm_caption":
        droot = join(root, "A_datasets") if root else ""
        return _load_classnames(droot), _load_test_images(droot, "A", final=False,
                                                          img_dir="dataset_A")
    droot = join(root, f"official_{select.lower()}") if root else ""
    if name in ("chatglm_caption_zema", "chatglm_caption_zuan"):
        images = _load_test_images(droot, select, final=False, img_dir=f"dataset_{select}")
    else:
        images = _load_test_images(droot, select)
    return _load_classnames(droot), images


def load_clip(cfg, args, device):
    """CLIP weights from an OpenAI checkpoint, or a seeded random init of the
    preset (dry runs / tests — real runs pass --weights)."""
    import torch

    from ..models.clip import PRESETS, init_clip_params
    from ..models.convert import load_clip_weights

    path = args.weights or cfg.MODEL.WEIGHTS
    if path and os.path.exists(path):
        return load_clip_weights(path, device=device)
    name = args.backbone or cfg.MODEL.BACKBONE_NAME
    clip_cfg = PRESETS[name]
    print(f"WARNING: no CLIP weights found; random-initialising {name}")
    generator = torch.Generator(device=device).manual_seed(0)
    return clip_cfg, init_clip_params(generator, clip_cfg, device=device)


def run_eval(cfg, clip_params, clip_cfg, model_dir, classnames, images, caption_bank=None,
             freq_stats=None, out_json="impreds.json", save_dir="", batch_size=8, device=None):
    from ..inference.pipeline import load_ensemble_specs, make_engine, run_full_inference

    specs = load_ensemble_specs(cfg, clip_params, clip_cfg, classnames, model_dir)
    engine = make_engine(cfg, clip_params, clip_cfg, specs, caption_bank=caption_bank,
                         freq_stats=freq_stats, device=device)
    if not images:
        raise SystemExit("no test images found — check DATASET.ROOT / imnames json")
    return run_full_inference(engine, images, batch_size=batch_size,
                              save_dir=save_dir or None, out_json=out_json)


def main(argv=None):
    args = parse_args(argv)
    from ..device import resolve_device
    from ..engine.config import setup_config

    device = resolve_device(args.device)
    cfg = setup_config(dataset_yaml=args.dataset_config, trainer_yaml=args.trainer_config,
                       opts=args.opts, eval_only=True)
    clip_cfg, clip_params = load_clip(cfg, args, device)
    bank = None
    if args.caption_bank and os.path.exists(args.caption_bank):
        with open(args.caption_bank, "rb") as f:
            bank = np.asarray(pickle.load(f), np.float32)
    freq = None
    if args.freq_stats and os.path.exists(args.freq_stats):
        with open(args.freq_stats, "rb") as f:
            freq = pickle.load(f)
    classnames, images = eval_split(cfg)
    return run_eval(cfg, clip_params, clip_cfg, args.model_dir, classnames, images,
                    caption_bank=bank, freq_stats=freq, out_json=args.out,
                    save_dir=args.save_dir, batch_size=args.batch_size, device=device)


if __name__ == "__main__":
    main()
