"""conv_fp32's kernel against variants of its source, on one NVIDIA GPU.

    python3 scripts/ab_conv_fp32.py VARIANT.cu [VARIANT.cu ...]

Each VARIANT.cu is an edited copy of leclip_tpu_torch/csrc/conv_fp32.cu with
the same C entry (leclip_conv_fp32, weights [Cout, kh, kw, Cin]). The port's
kernel and each variant are built with the port's nvcc flags (ptxas'
register and spill report printed), then the RN50 fp32 trunk runs at 610
crops of 224² on seeded random weights (random BN statistics), with each of
its 55 convolution-with-batch-norm calls and the head's 6 fp32 products
hooked. At each, every variant's output must equal the port kernel's bit
for bit (every tile sums an element in the same order), bare and with the
chain in its epilogue, and each is timed by CUDA events (median of 3):
bare, through the epilogue with scale 1 and offset 0, and fused. Prints a
line per call and the totals. Imports nothing of JAX."""

import ctypes
import importlib.util
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from leclip_tpu_torch.device import cast_floating, no_tf32
    from leclip_tpu_torch.models import resnet
    from leclip_tpu_torch.models.clip import PRESETS
    from leclip_tpu_torch.ops import _build
    from leclip_tpu_torch.ops import conv_kernels as ck

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build_all(["conv_fp32"])
    libs = {}
    for path in sys.argv[1:]:
        name = os.path.splitext(os.path.basename(path))[0]
        out = _build.BUILD_DIR / f"ab-{name}.so"
        r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                            str(out), path], capture_output=True, text=True)
        report = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"[ptxas] {name} rc {r.returncode}: " + " | ".join(report), flush=True)
        if r.returncode:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(out))
        lib.leclip_conv_fp32.argtypes = _build.KERNELS["conv_fp32"][1]["leclip_conv_fp32"]
        libs[name] = lib
    report = [ln.strip() for ln in _build.build_log("conv_fp32").splitlines()
              if "registers" in ln or "spill" in ln]
    print(f"[ptxas] conv_fp32: " + " | ".join(report), flush=True)
    print(f"[build] {time.perf_counter() - t0:.1f} s; {smoke.card_line()}", flush=True)

    def run(lib, x, kernel, stride, scale=None, offset=None, residual=None, relu=False):
        """conv_kernels._launch_fp32 on another library."""
        cout, _, kh, kw = kernel.shape
        x, wk, (ho, wo, top, left) = ck._prepare(x, kernel, stride, torch.float32, 4, "ab")
        b, h, w, cin = x.shape
        out = torch.empty((b, ho, wo, cout), device=x.device)
        chain = ck._chain_tensors(scale, offset, residual, torch.float32)
        rc = lib.leclip_conv_fp32(x.data_ptr(), wk.data_ptr(), out.data_ptr(), *ck._ptrs(chain),
                                  int(relu), b, h, w, cin, ho, wo, cout, kh, kw, stride, top,
                                  left, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    dev = torch.device("cuda")
    cfg = PRESETS["RN50"]
    g = torch.Generator(device=dev).manual_seed(50)
    vis = resnet.init_resnet_params(g, cfg.vision_layers, cfg.embed_dim, cfg.image_resolution,
                                    cfg.vision_width, dtype=torch.float32, device=dev)
    vis = cast_floating(smoke.randomize_bn(vis, g), torch.float32)
    x0 = torch.randn(610, 224, 224, 3, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
    totals, mismatches = {}, []
    port_conv_bn = resnet.conv_bn

    def add(key, ms):
        totals[key] = totals.get(key, 0.0) + ms

    def conv_bn(x, k, bn, stride=1, residual=None, relu=True):
        scale, offset = resnet.bn_affine(bn, x.dtype)
        ones, zeros = torch.ones_like(scale), torch.zeros_like(offset)
        name = smoke.conv_name(x, k, stride)
        ref = ck.conv_fp32(x, k, stride)
        ref_fused = port_conv_bn(x, k, bn, stride, residual, relu)
        calls = {"conv_fp32": (lambda: ck.conv_fp32(x, k, stride),
                               lambda: ck.conv_fp32(x, k, stride, ones, zeros),
                               lambda: port_conv_bn(x, k, bn, stride, residual, relu))}
        for v, lib in libs.items():
            calls[v] = (lambda lib=lib: run(lib, x, k, stride),
                        lambda lib=lib: run(lib, x, k, stride, ones, zeros),
                        lambda lib=lib: run(lib, x, k, stride, scale, offset, residual, relu))
            if not (torch.equal(calls[v][0](), ref) and torch.equal(calls[v][2](), ref_fused)):
                mismatches.append(f"{v} at {name}")
        line = f"{name:>26}:"
        with no_tf32():
            for v, (bare, unit, fused) in calls.items():
                ms = [smoke.cuda_ms(f, 3) for f in (bare, unit, fused)]
                for key, t in zip(("", " x1+0", " fused"), ms):
                    add(v + key, t)
                line += f" | {v} {ms[0]:.3f} {ms[1]:.3f} fused {ms[2]:.3f}"
        print(line, flush=True)
        return ref_fused

    def proj(y, p):
        w, bias = p["kernel"], p["bias"]
        rows = y.reshape(-1, y.shape[-1])
        ref = ck.matmul_fp32(rows, w, bias)
        line = f"product {rows.shape[0]}x{w.shape[0]}->{w.shape[1]}:"
        calls = {"conv_fp32": lambda: ck.matmul_fp32(rows, w, bias),
                 "cuBLAS": lambda: ck.matmul_fp32_plain(rows, w, bias)}
        for v, lib in libs.items():
            calls[v] = lambda lib=lib: run(lib, rows[:, None, None, :], w.t()[:, :, None, None],
                                           1, None, bias).reshape(ref.shape)
            if not torch.equal(calls[v](), ref):
                mismatches.append(f"{v} at {line}")
        for v, f in calls.items():
            ms = smoke.cuda_ms(f, 3)
            add("products " + v, ms)
            line += f" | {v} {ms:.3f}"
        print(line, flush=True)
        return ref.reshape(y.shape[:-1] + (w.shape[1],))

    with smoke.patched(resnet, "conv_bn", conv_bn), torch.inference_mode():
        feat = resnet.resnet_features(x0, vis)
    with smoke.patched(resnet, "_proj", proj), torch.inference_mode():
        resnet.attention_pool(feat, vis["attnpool"], cfg.vision_heads, if_pos=False,
                              global_only=True)
        resnet.project_dense(feat, vis["attnpool"])
    print("[totals] " + ", ".join(f"{k} {v:.3f}" for k, v in totals.items()) + " ms on "
          + smoke.card_line(), flush=True)
    if mismatches:
        print(f"[ab] outputs differ from conv_fp32's: {mismatches}", flush=True)
        return 1
    print("[ab] every variant bit for bit conv_fp32's, bare and fused", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
