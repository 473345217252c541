"""Caption feature-bank precompute (counterpart of
leclip_tpu/cli/build_caption_bank.py, same arguments plus ``--device``):
encode every caption of the training corpora with the frozen CLIP text
tower into the L2-normalised retrieval bank of test-time retrieval
augmentation.

Usage:
    python -m leclip_tpu_torch.cli.build_caption_bank \\
        --weights RN50.pt \\
        --caption-root .../generated_captions \\
        --corpora "ChatGLM_multi_labels_filtered challenge_captions_5w" \\
        --out caption_bank.pkl [--precision default|bf16|int8]

Runs on the card; ``--device cpu`` runs it on the CPU explicitly.
``--precision`` picks the text tower's kernels as
``inference.pipeline.build_caption_bank`` does: ``default`` the fp32 tower
(no hand-written kernel), ``bf16`` attn_block_bf16 + mlp_bf16, ``int8``
ln_quant + attn_block_int8 + mlp_int8. After the encode it prints the
process's kernel launch counts (``ops/launches.py``) as one JSON line."""

from __future__ import annotations

import argparse
import json
import pickle
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default="")
    ap.add_argument("--backbone", default="RN50")
    ap.add_argument("--caption-root", required=True)
    ap.add_argument("--corpora", required=True, help="space-separated corpus names")
    ap.add_argument("--out", default="caption_bank.pkl")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--precision", default="default", choices=["default", "bf16", "int8"],
                    help="int8: W8A8 kernels; bf16: fused bf16 block kernels "
                         "(no quantization noise)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data.corpora import load_multi_label_corpus
    from ..data.labeling import CaptionLabeler
    from ..device import resolve_device
    from ..engine.config import setup_config
    from ..inference.pipeline import build_caption_bank
    from ..ops import launches
    from .eval import load_clip

    device = resolve_device(args.device)
    clip_cfg, clip_params = load_clip(setup_config(), args, device)
    labeler = CaptionLabeler()
    tokens = np.concatenate([load_multi_label_corpus(args.caption_root, name, labeler)[0]
                             for name in args.corpora.split()])
    print(f"encoding {len(tokens)} captions…")
    t0 = time.perf_counter()
    bank = build_caption_bank(clip_params, clip_cfg, tokens, args.batch_size,
                              precision=args.precision, device=device)
    secs = time.perf_counter() - t0
    print(f"encoded {len(tokens)} captions in {secs:.3f} s ({len(tokens) / secs:.1f} "
          f"captions/s, {args.precision} on {device})")
    print(f"kernel launches: {json.dumps(launches.launch_counts())}")
    with open(args.out, "wb") as f:
        pickle.dump(bank, f)
    print(f"wrote {args.out}: {bank.shape}")
    return bank


if __name__ == "__main__":
    main()
