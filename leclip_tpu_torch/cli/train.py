"""Training CLI (counterpart of leclip_tpu/cli/train.py, same arguments):
dataset/trainer config YAMLs, free-form KEY VALUE overrides, seed, output
dir, resume, eval-only.

Usage:
    python -m leclip_tpu_torch.cli.train \\
        --trainer-config configs/trainers/ema.yaml \\
        --output-dir output/ema --weights /path/to/RN50.pt \\
        DATASET.caption_feat_root /data/captions

Runs on the card; ``--device cpu`` runs it on the CPU explicitly. It writes
``{output-dir}/{TEST.multi_model[0]}/model.ckpt-{epoch}`` in the JAX
package's format, which the port's ``cli/eval.py`` and the JAX package both
read. Without ``--weights`` the backbone preset is initialised at random
from a fixed seed (a dry run)."""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="leclip_tpu_torch prompt-tuning trainer")
    ap.add_argument("--dataset-config", default="", help="dataset yaml")
    ap.add_argument("--trainer-config", default="", help="trainer yaml")
    ap.add_argument("--output-dir", default="./output")
    ap.add_argument("--weights", default="", help="OpenAI CLIP checkpoint (.pt)")
    ap.add_argument("--backbone", default="",
                    help="backbone preset when no weights (RN50, ViT-B/16, ...)")
    ap.add_argument("--trainer", default="",
                    help="TRAINER_REGISTRY name (ref --trainer; default Caption_distill_double)")
    ap.add_argument("--resume", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--model-dir", default="", help="checkpoint dir for eval-only")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..device import resolve_device
    from ..engine.config import setup_config
    from ..engine.trainer import build_trainer
    from ..utils.logging import set_random_seed, setup_logger
    from .eval import eval_split, load_clip, run_eval

    device = resolve_device(args.device)
    cfg = setup_config(
        dataset_yaml=args.dataset_config,
        trainer_yaml=args.trainer_config,
        # --trainer lands before the free-form opts, like the reference's
        # reset_cfg → merge_from_list order (train_caption.py:158-162)
        opts=(["TRAINER.NAME", args.trainer] if args.trainer else []) + (args.opts or []),
        OUTPUT_DIR=args.output_dir,
        RESUME=args.resume,
        SEED=args.seed,
        eval_only=args.eval_only,
    )
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    setup_logger(cfg.OUTPUT_DIR)
    set_random_seed(cfg.SEED)
    print("config:", cfg.to_dict())

    clip_cfg, clip_params = load_clip(cfg, args, device)
    if args.eval_only:
        classnames, images = eval_split(cfg)
        return run_eval(cfg, clip_params, clip_cfg, args.model_dir or cfg.OUTPUT_DIR,
                        classnames, images, device=device)

    trainer = build_trainer(cfg, clip_params, clip_cfg, device=device)
    trainer.train(resume=bool(args.resume))
    if not cfg.TEST.NO_TEST:
        # reference after_train final test (dassl trainer.py:415-436); with
        # TRAIN.probe_holdout set this reports mAP on held-out captions
        trainer.validate()
    return trainer


if __name__ == "__main__":
    main()
