"""Offline ensemble fusion (counterpart of leclip_tpu/cli/gen_final_ans.py):
the reference's ``gen_final_ans.py`` step of the dump-then-fuse flow.

Reads the ``data.pkl`` and ``sim_matrix.pkl`` that
``inference.pipeline.run_full_inference(save_dir=...)`` writes (plain pickled
numpy, so the JAX package's dumps read here and the port's there) and writes
the competition ``impreds.json``. Runs on the host.

Usage:
    python -m leclip_tpu_torch.cli.gen_final_ans --data dumps/data.pkl \\
        --sim-matrix dumps/sim_matrix.pkl --out impreds.json
"""

from __future__ import annotations

import argparse
import pickle


def main(argv=None):
    ap = argparse.ArgumentParser(description="fuse saved TTA dumps → impreds.json")
    ap.add_argument("--data", required=True, help="data.pkl from run_full_inference")
    ap.add_argument("--sim-matrix", required=True, help="sim_matrix.pkl")
    ap.add_argument("--out", default="impreds.json")
    ap.add_argument("--base", default="best")
    ap.add_argument("--coef", type=float, default=1.5)
    args = ap.parse_args(argv)

    from ..ops.ensemble import generate_final_answers

    with open(args.data, "rb") as f:
        data = pickle.load(f)
    with open(args.sim_matrix, "rb") as f:
        sims = pickle.load(f)
    fused = generate_final_answers(data, sims["sims_blocks_all"], base=args.base,
                                   coef=args.coef, out_path=args.out)
    print(f"wrote {args.out}: {fused.shape[0]} images × {fused.shape[1]} classes")
    return fused


if __name__ == "__main__":
    main()
