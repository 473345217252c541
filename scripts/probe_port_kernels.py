"""Device time of every launch inside the port's five block kernels
(leclip_tpu_torch), by torch.profiler, on one NVIDIA GPU:

    python3 scripts/probe_port_kernels.py [--shape vit|text] [--reps 5]

Each wrapper of ops/block_kernels.py and ops/quant_kernels.py is several
launches (GEMMs, the attention core, ln_quant); chip_smoke.py times a wrapper
as a whole, this prints the CUDA kernels under it with their mean device
time, so the slowest launch of a block is known before it is tuned. Weights
are seeded random, shapes are chip_smoke.py's: ViT-B/16 crops [610, 200, 768]
(kv_len 197) or the caption bank's text tower [256, 77, 512] (causal).
Imports nothing of JAX."""

import argparse
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = {"vit": (610, 200, 768, 12, 197, False), "text": (256, 77, 512, 8, 77, True)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="vit", choices=sorted(SHAPES))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_port_kernels: no CUDA device", file=sys.stderr)
        return 2
    from leclip_tpu_torch.models.transformer import init_block_stack, layer_params
    from leclip_tpu_torch.ops import block_kernels as bk
    from leclip_tpu_torch.ops import quant_kernels as qk
    from leclip_tpu_torch.ops.quant import quantize_block_stack

    dev = torch.device("cuda")
    b, t, d, heads, kv_len, causal = SHAPES[args.shape]
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks = init_block_stack(gen, 1, d, dtype=torch.bfloat16, device=dev)
    q8, p = layer_params(quantize_block_stack(blocks), 0), layer_params(blocks, 0)
    x = torch.randn(b, t, d, generator=gen, device=dev).bfloat16()
    akw = dict(kv_len=kv_len, causal=causal)
    calls = {
        "attn_block_bf16": lambda: bk.attn_block_bf16(
            x, p["ln_1"]["scale"], p["ln_1"]["bias"], p["attn"]["qkv_kernel"],
            p["attn"]["qkv_bias"], p["attn"]["out_kernel"], p["attn"]["out_bias"], heads, **akw),
        "mlp_bf16": lambda: bk.mlp_bf16(
            x, p["ln_2"]["scale"], p["ln_2"]["bias"], p["mlp"]["fc_kernel"], p["mlp"]["fc_bias"],
            p["mlp"]["proj_kernel"], p["mlp"]["proj_bias"]),
        "attn_block_int8": lambda: qk.attn_block_int8(
            x, *q8["ln1"], *q8["attn"]["qkv"], p["attn"]["qkv_bias"], p["attn"]["out_kernel"],
            p["attn"]["out_bias"], heads, **akw),
        "mlp_int8": lambda: qk.mlp_int8(
            x, *q8["ln2"], *q8["mlp"]["fc"], p["mlp"]["fc_bias"], *q8["mlp"]["proj"],
            p["mlp"]["proj_bias"]),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; shape {args.shape} [{b}, {t}, {d}], {args.reps} calls each")
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / args.reps / 1e3, e.count // args.reps)
                for e in prof.key_averages() if e.device_time_total > 0 and
                e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(r[1] for r in rows)
        print(f"{name}: {total:.3f} ms of device time per call")
        for key, ms, n in sorted(rows, key=lambda r: -r[1]):
            print(f"    {ms:8.3f} ms  x{n}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
