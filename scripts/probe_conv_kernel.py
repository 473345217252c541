"""The RN50 trunk's two convolution kernels alone on one NVIDIA GPU: build
``conv_bf16`` and ``conv_fp32``, print ptxas' register and spill report,
then, on seeded random RN50 weights (random BN statistics) and random crops
at 224², in bf16 and in fp32:

1. every one of the trunk's 55 convolution-with-batch-norm calls against
   the kernel's plain version on a small batch (chip_smoke.trunk_conv_check,
   no timing; also the fused epilogue against the unfused chain, in fp32
   also the head's products against y @ w, their fused bias against + bias);
2. the batch witness by operation (chip_smoke.rn_witness_layers): 8 images
   of 305 crops, each convolution on each route of chip_smoke.conv_routes
   (cuDNN and the port's kernel), each average pool and each product of the
   attention pool and the dense projection, in batches of 1, 2 and 5
   images, 5 padded to 8 and the 8 reversed, against the same images in the
   batch of 8;
3. the 55 calls at 610 crops, checked and timed beside the plain version,
   cuDNN in the same dtype and the bound, the fused calls beside cuDNN +
   the unfused chain (fp32: the head's products beside cuBLAS, and
   conv_fp32's tile witness, chip_smoke.conv_fp32_tile_witness);
4. the whole trunk (models/resnet.resnet_features) at 610 crops on each
   route (the port's kernel fused and unfused, cuDNN), by CUDA events, on
   the same inputs.

    python3 scripts/probe_conv_kernel.py [--no-witness] [--only bf16|fp32]

A short run for iterating on the kernels before a full chip_smoke.py.
Imports nothing of JAX."""

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
        print("probe_conv_kernel: no CUDA device", file=sys.stderr)
        return 2
    from leclip_tpu_torch.device import cast_floating
    from leclip_tpu_torch.models import resnet
    from leclip_tpu_torch.models.clip import PRESETS
    from leclip_tpu_torch.ops import _build, conv_kernels

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(["conv_bf16", "conv_fp32"])
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    for name in ("conv_bf16", "conv_fp32"):
        regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[ptxas] {name}: {' | '.join(regs)}", flush=True)
    card = smoke.card_line()
    print(f"[device] {card}", flush=True)

    cfg = PRESETS["RN50"]
    dev = torch.device("cuda")
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    res = {}
    for prec, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        if only not in (None, prec):
            continue
        g = torch.Generator(device=dev).manual_seed(50)
        vis = resnet.init_resnet_params(g, cfg.vision_layers, cfg.embed_dim,
                                        cfg.image_resolution, cfg.vision_width, dtype=dtype,
                                        device=dev)
        vis = cast_floating(smoke.randomize_bn(vis, g), dtype)

        def crops(n, seed):
            return torch.randn(n, 224, 224, 3, device=dev, generator=torch.Generator(
                device=dev).manual_seed(seed)).to(dtype)

        out = res[prec] = {"small": smoke.trunk_conv_check(
            vis, crops(16, 1), card, time_it=False, heads=cfg.vision_heads)["totals"]}
        if "--no-witness" not in sys.argv:
            t0 = time.perf_counter()
            try:  # a failure is logged by the witness itself; the probe goes on
                smoke.rn_witness_layers(vis, crops(smoke.SERVICE_BATCH * 305, 2), card,
                                        cfg.vision_heads)
                out["witness"] = "the port's route read 0 everywhere"
            except AssertionError as e:
                out["witness"] = f"FAILED: {e}"
            print(f"[witness:{prec}] {time.perf_counter() - t0:.1f} s: {out['witness']}",
                  flush=True)
            torch.cuda.empty_cache()
        x = crops(smoke.N_IMAGES * 305, 3)
        out["main"] = smoke.trunk_conv_check(vis, x, card, heads=cfg.vision_heads)["totals"]
        if prec == "fp32":
            out["tile_witness"] = smoke.conv_fp32_tile_witness(vis, x.shape[0], card)
        torch.cuda.empty_cache()
        routes = dict(smoke.conv_routes(dtype))
        port = smoke.PORT_ROUTE[dtype]
        bare = getattr(conv_kernels, port)
        routes[f"{port} unfused"] = lambda x_, k_, s_=1: bare(x_, k_, s_)
        trunk = {}
        for route, fn in routes.items():
            with smoke.conv_route(fn), torch.inference_mode():
                trunk[route] = smoke.cuda_ms(lambda: resnet.resnet_features(x, vis), 3)
        print(f"[trunk:{prec}] resnet_features at {x.shape[0]} crops, median of 3 by CUDA "
              f"events: " + ", ".join(f"{r} {ms:.3f} ms" for r, ms in trunk.items())
              + f" on {card}", flush=True)
        out["trunk_ms"] = trunk
        del x, vis
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
