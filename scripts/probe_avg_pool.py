"""The ResNet trunk's average-pool kernel alone on one NVIDIA GPU: build
``avg_pool_nhwc``, print ptxas' register and spill report, then hold it to
F.avg_pool2d (0 values may differ) and time it beside the library's pool
and its bytes bound at RN50's seven pool shapes, with chip_smoke.py's own
phase:

    python3 scripts/probe_avg_pool.py

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
        print("probe_avg_pool: no CUDA device", file=sys.stderr)
        return 2
    from leclip_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    t0 = time.perf_counter()
    _build.build_all(["avg_pool_nhwc"])
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    regs = [ln.strip() for ln in _build.build_log("avg_pool_nhwc").splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[ptxas] avg_pool_nhwc: {' | '.join(regs)}", flush=True)
    res = smoke.phase_avg_pool(smoke.card_line())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
