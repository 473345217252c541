"""Experiment-results aggregator (counterpart of
leclip_tpu/cli/parse_results.py): summarises the ``metrics.jsonl`` files that
``engine/metrics.py`` writes, one line per run and tag, in the same format
as the JAX package's. Runs on the host.

Usage:
    python -m leclip_tpu_torch.cli.parse_results output_dir [output_dir2 ...] \\
        [--tag train/loss] [--last]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Dict, List


def load_metrics(run_dir: str) -> Dict[str, List[dict]]:
    path = os.path.join(run_dir, "metrics.jsonl")
    by_tag: Dict[str, List[dict]] = defaultdict(list)
    if not os.path.exists(path):
        return by_tag
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rec = json.loads(line)
                by_tag[rec["tag"]].append(rec)
    return by_tag


def summarize(run_dirs: List[str], tag: str = "", last: bool = False) -> List[dict]:
    rows = []
    for d in run_dirs:
        for t, recs in sorted(load_metrics(d).items()):
            if tag and t != tag:
                continue
            values = [r["value"] for r in recs]
            row = {"run": d, "tag": t, "n": len(values), "last": values[-1]}
            if not last:
                row.update({"mean": sum(values) / len(values), "min": min(values),
                            "max": max(values)})
            rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dirs", nargs="+")
    ap.add_argument("--tag", default="")
    ap.add_argument("--last", action="store_true", help="only the last value")
    args = ap.parse_args(argv)
    rows = summarize(args.run_dirs, args.tag, args.last)
    if not rows:
        print("no metrics found")
        return
    for row in rows:
        parts = [f"{row['run']}", f"{row['tag']}", f"n={row['n']}", f"last={row['last']:.6g}"]
        if "mean" in row:
            parts.append(f"mean={row['mean']:.6g} min={row['min']:.6g} max={row['max']:.6g}")
        print("  ".join(parts))


if __name__ == "__main__":
    main()
