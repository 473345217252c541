"""Zero-shot multi-label scoring CLI (counterpart of
leclip_tpu/cli/zeroshot.py, same arguments plus ``--device``): BASELINE
config 1 ("CLIP RN50 zero-shot multi-label scoring") and the dense zero-shot
baseline the reference's zsclip.sh points at (ZeroshotCLIP_dense, not
shipped there).

Scores images against "a photo of a {}" prompts (optionally averaged over
the 80 ImageNet templates), global + dense logits merged with GL_merge_rate,
and reports mAP when a label file is given.

Usage:
    python -m leclip_tpu_torch.cli.zeroshot --weights RN50.pt \\
        --images-dir ./imgs [--labels labels.json] [--templates] [--out scores.json]

Runs on the card; ``--device cpu`` runs it on the CPU explicitly. Without
``--weights`` the backbone preset is initialised at random from a fixed
seed (a dry run). Each image is resized and center-cropped by the gather
sampler (ops/preprocess.py ``preprocess_eval``); the image tower runs in
fp32, its attention routed as ``DenseFlags.attention_impl`` says ("auto":
the resident-attention kernel in every ViT layer on the card). After the
scores it prints the process's kernel launch counts (``ops/launches.py``)
as one JSON line."""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def zero_shot_text_features(clip_params, clip_cfg, classnames, use_templates=False):
    """[C, E] L2-normalised class features: each template's normalised text
    features, averaged over the templates and normalised again."""
    import torch

    from ..data.tokenizer import tokenize
    from ..data.vocab import IMAGENET_TEMPLATES, PROMPT_TEMPLATE
    from ..device import no_tf32
    from ..models.text import encode_text

    templates = IMAGENET_TEMPLATES if use_templates else [PROMPT_TEMPLATE]
    text = clip_params["text"]
    feats = []
    with torch.no_grad(), no_tf32():
        for t in templates:
            toks = torch.as_tensor(np.asarray(tokenize([t.format(c) for c in classnames])),
                                   device=text["token_embedding"].device)
            f = encode_text(text, toks, clip_cfg.transformer_heads).float()
            feats.append((f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)).cpu().numpy())
    mean = np.mean(feats, axis=0)
    mean /= np.linalg.norm(mean, axis=-1, keepdims=True)
    return mean


def zero_shot_scores(clip_params, clip_cfg, images, text_feats, gl_merge=0.5,
                     spatial_scale=50.0, attention_impl="auto"):
    """Global + dense zero-shot logits for a batch of CLIP-normalised images
    [B, H, W, 3] → merged [B, C] scores (numpy)."""
    import torch

    from ..device import no_tf32
    from ..models.dense_clip import DenseFlags, _aggregate_local, encode_image_features

    flags = DenseFlags(spatial_scale_image=spatial_scale, attention_impl=attention_impl)
    with torch.no_grad(), no_tf32():
        feats = encode_image_features(clip_params, clip_cfg, images, flags)
        tf = torch.as_tensor(text_feats, device=images.device)
        tf = {"pos": tf, "neg": tf}
        logits_global = 4.0 * feats.global_feat.float() @ tf["pos"].T
        logits_local, _ = _aggregate_local(feats.spatial_feats, tf, 4.0, spatial_scale,
                                           use_evidence=False)
    g, loc = logits_global.cpu().numpy(), logits_local.float().cpu().numpy()
    return g * gl_merge + loc * (1 - gl_merge)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default="")
    ap.add_argument("--backbone", default="RN50")
    ap.add_argument("--images-dir", required=True)
    ap.add_argument("--labels", default="", help="json {filename: [class indices]}")
    ap.add_argument("--templates", action="store_true", help="average 80 ImageNet templates")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..data.loader import ImageBatcher
    from ..data.vocab import COCO_OBJECT_CATEGORIES
    from ..device import resolve_device
    from ..engine.config import setup_config
    from ..engine.evaluator import mAP
    from ..ops import launches
    from ..ops.preprocess import preprocess_eval
    from .eval import load_clip

    device = resolve_device(args.device)
    cfg = setup_config()
    clip_cfg, clip_params = load_clip(cfg, args, device)
    text_feats = zero_shot_text_features(clip_params, clip_cfg, COCO_OBJECT_CATEGORIES,
                                         args.templates)
    paths = sorted(os.path.join(args.images_dir, f) for f in os.listdir(args.images_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    all_scores, all_names = [], []
    t0 = time.perf_counter()
    for images, names in ImageBatcher(paths, args.batch_size):
        batch = torch.stack([preprocess_eval(torch.tensor(im, device=device),
                                             clip_cfg.image_resolution) for im in images])
        all_scores.append(zero_shot_scores(clip_params, clip_cfg, batch, text_feats))
        all_names.extend(names)
    scores = np.concatenate(all_scores)
    secs = time.perf_counter() - t0

    if args.labels:
        with open(args.labels) as f:
            lab = json.load(f)
        targets = np.zeros_like(scores, dtype=np.int64)
        for i, p in enumerate(all_names):
            for c in lab.get(os.path.basename(p), []):
                targets[i, c] = 1
        print(f"zero-shot mAP: {mAP(targets, scores):.2f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({os.path.basename(p): s.tolist() for p, s in zip(all_names, scores)}, f)
    print(f"scored {len(all_names)} images in {secs:.3f} s ({len(all_names) / secs:.1f} "
          f"images/s: decode, preprocess, towers and scores)")
    print(f"kernel launches: {json.dumps(launches.launch_counts())}")
    return scores


if __name__ == "__main__":
    main()
