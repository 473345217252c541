"""The banded crop + resize kernel alone on one NVIDIA GPU: build
``resize_band``, print ptxas' register and spill report, then hold it
against its plain version and time it beside the plain version and its
bound at the scoring cells' batches, with chip_smoke.py's own phase:

    python3 scripts/probe_resize_band.py

A short run (well under a minute with the build) for iterating on the
kernel before a full chip_smoke.py. Imports nothing of JAX."""

import importlib.util
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_resize_band: no CUDA device", file=sys.stderr)
        return 2
    from leclip_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(["resize_band"])
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    regs = [ln.strip() for ln in _build.build_log("resize_band").splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[ptxas] resize_band: {' | '.join(regs)}", flush=True)
    res = smoke.phase_resize(smoke.card_line())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
