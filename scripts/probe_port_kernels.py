"""Device time of every launch inside the port's four block kernels
(leclip_tpu_torch), by torch.profiler, on one NVIDIA GPU:

    python3 scripts/probe_port_kernels.py [--shape vit|text] [--reps 5]

Each wrapper of ops/block_kernels.py and ops/quant_kernels.py is several
launches (LN row passes, GEMMs, the attention core); chip_smoke.py times a
wrapper as a whole, this prints the CUDA kernels under it with their mean
device time, so the slowest launch of a block is known before it is tuned,
and the rate of each launch from its shape (TFLOP/s of the bf16 GEMMs and
the attention core, TOP/s of the int8 GEMMs, GB/s of the row passes).
chip_smoke.py imports :func:`launch_times` and prints the same table at the
ViT shape. Weights are seeded random, shapes are chip_smoke.py's: ViT-B/16
crops [610, 200, 768] (kv_len 197) or the caption bank's text tower [256,
77, 512] (causal). Imports nothing of JAX."""

import argparse
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UNIT = {"TFLOP/s": 1e9, "TOP/s": 1e9, "GB/s": 1e6}  # amount per ms -> unit
SHAPES = {"vit": (610, 200, 768, 12, 197, False), "text": (256, 77, 512, 8, 77, True)}


def launch_times(shape: str = "vit", reps: int = 5) -> dict:
    """{block kernel: [(launch name, ms per call, rate or None, unit), ...]},
    slowest launch first, each block called ``reps`` times under the
    profiler after one warm-up call."""
    from leclip_tpu_torch.models.transformer import init_block_stack, layer_params
    from leclip_tpu_torch.ops import block_kernels as bk
    from leclip_tpu_torch.ops import quant_kernels as qk
    from leclip_tpu_torch.ops.quant import quantize_block_stack

    dev = torch.device("cuda")
    b, t, d, heads, kv_len, causal = SHAPES[shape]
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
    rows, pairs = b * t, (t * (t + 1) // 2 if causal else t * kv_len)
    core = ("attn_core", 4 * b * d * pairs, "TFLOP/s")
    work = {  # launch name -> (operations or bytes, unit), per block kernel
        "attn_block_bf16": [("ln_bf16_rows", 4 * rows * d, "GB/s"),
                            ("hopper_gemm<0>", 6 * rows * d * d, "TFLOP/s"), core,
                            ("hopper_gemm<2>", 2 * rows * d * d, "TFLOP/s")],
        "mlp_bf16": [("ln_bf16_rows", 4 * rows * d, "GB/s"),
                     ("hopper_gemm<1>", 8 * rows * d * d, "TFLOP/s"),
                     ("hopper_gemm<3>", 8 * rows * d * d, "TFLOP/s")],
        # the int8 wgmma GEMM (csrc/gemm_int8.cuh): QKV, fc pass 1 (absmax),
        # fc pass 2 (codes), proj
        "attn_block_int8": [("ln_quant_rows", 3 * rows * d, "GB/s"),
                            ("hopper_gemm_s8<0>", 6 * rows * d * d, "TOP/s"), core,
                            ("hopper_gemm<2>", 2 * rows * d * d, "TFLOP/s")],
        "mlp_int8": [("ln_quant_rows", 3 * rows * d, "GB/s"),
                     ("hopper_gemm_s8<1>", 8 * rows * d * d, "TOP/s"),
                     ("hopper_gemm_s8<2>", 8 * rows * d * d, "TOP/s"),
                     ("hopper_gemm_s8<3>", 8 * rows * d * d, "TOP/s")],
    }
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = []
        for e in prof.key_averages():
            if e.device_time_total <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = e.device_time_total / reps / 1e3
            short = e.key.removeprefix("void ").removeprefix("leclip::").split("(")[0]
            rate, unit = next(((amount / ms / UNIT[u], u) for pre, amount, u in work[name]
                               if short.startswith(pre)), (None, ""))
            got.append((short, ms, rate, unit))
        out[name] = sorted(got, key=lambda r: -r[1])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="vit", choices=sorted(SHAPES))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_port_kernels: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    b, t, d = SHAPES[args.shape][:3]
    print(f"{card}; shape {args.shape} [{b}, {t}, {d}], {args.reps} calls each")
    for name, rows in launch_times(args.shape, args.reps).items():
        print(f"{name}: {sum(r[1] for r in rows):.3f} ms of device time per call")
        for short, ms, rate, unit in rows:
            shown = f"{rate:8.1f} {unit:7s}" if rate is not None else " " * 16
            print(f"    {ms:8.3f} ms  {shown}  {short}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
