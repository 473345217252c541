"""The RN50 trunk's bf16 convolution kernel alone on one NVIDIA GPU: build
``conv_bf16``, print ptxas' register and spill report, then, on seeded
random RN50 bf16 weights (random BN statistics) and random crops at 224²:

1. every one of the trunk's 55 convolutions against conv_bf16_plain on a
   small batch (chip_smoke.trunk_conv_check, no timing);
2. the batch witness by layer (chip_smoke.rn_witness_layers): 8 images of
   305 crops, each convolution under cuDNN bf16, the route before the kernel
   and the kernel, in batches of 1, 2 and 5 images, 5 padded to 8 and the 8
   reversed, against the same images in the batch of 8;
3. the 55 convolutions at 610 crops, checked and timed beside the plain
   version, cuDNN bf16 and the bound;
4. the whole trunk (models/resnet.resnet_features) at 610 crops on each
   route, by CUDA events, on the same inputs.

    python3 scripts/probe_conv_kernel.py [--no-witness]

A short run for iterating on the kernel before a full chip_smoke.py.
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
    from leclip_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(["conv_bf16"])
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    regs = [ln.strip() for ln in _build.build_log("conv_bf16").splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[ptxas] conv_bf16: {' | '.join(regs)}", flush=True)
    card = smoke.card_line()
    print(f"[device] {card}", flush=True)

    cfg = PRESETS["RN50"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(50)
    vis = resnet.init_resnet_params(g, cfg.vision_layers, cfg.embed_dim, cfg.image_resolution,
                                    cfg.vision_width, dtype=torch.bfloat16, device=dev)
    vis = cast_floating(smoke.randomize_bn(vis, g), torch.bfloat16)

    def crops(n, seed):
        return torch.randn(n, 224, 224, 3, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev).to(torch.bfloat16)

    res = {"small": smoke.trunk_conv_check(vis, crops(16, 1), card, time_it=False)["totals"]}
    if "--no-witness" not in sys.argv:
        t0 = time.perf_counter()
        smoke.rn_witness_layers(vis, crops(smoke.SERVICE_BATCH * 305, 2), card)
        print(f"[witness] {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    x = crops(smoke.N_IMAGES * 305, 3)
    res["main"] = smoke.trunk_conv_check(vis, x, card)["totals"]
    torch.cuda.empty_cache()
    trunk = {}
    for route, fn in smoke.conv_routes().items():
        with smoke.conv_route(fn), torch.inference_mode():
            trunk[route] = smoke.cuda_ms(lambda: resnet.resnet_features(x, vis), 3)
    print(f"[trunk] resnet_features at {x.shape[0]} crops, median of 3 by CUDA events: "
          + ", ".join(f"{r} {ms:.3f} ms" for r, ms in trunk.items()) + f" on {card}", flush=True)
    res["trunk_ms"] = trunk
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
