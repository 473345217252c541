"""The unfused attention kernels alone on one NVIDIA GPU: build
``resident_attention`` and ``flash_attention``, print ptxas' register and
spill report, then hold each against its plain version and time it beside
SDPA and its bound at chip_smoke.py's shapes (ViT-B/16, text, ViT-L/14) in
fp32 and bf16, with chip_smoke.py's own phase:

    python3 scripts/probe_attention_kernels.py

A short run (about a minute with the build) for iterating on these kernels
before a full chip_smoke.py. Imports nothing of JAX."""

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
        print("probe_attention_kernels: no CUDA device", file=sys.stderr)
        return 2
    from leclip_tpu_torch.ops import _build
    from leclip_tpu_torch.ops import flash_attention as fa

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("resident_attention", "flash_attention")
    t0 = time.perf_counter()
    _build.build_all(names)
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    for k in names:
        regs = [ln.strip() for ln in _build.build_log(k).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[ptxas] {k}: {' | '.join(regs)}", flush=True)
    print(f"[device] {smoke.card_line()}", flush=True)
    res = smoke.phase_kernels_attention(fa, torch.Generator(device="cuda").manual_seed(0))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
