"""Chip smoke test of the PyTorch / CUDA port (leclip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: card name, power limit, and the nvcc build of every kernel;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the main path's shapes (ViT-B/16 crops, caption-bank text),
     with CUDA-event timings, a PyTorch-ops yardstick and the roofline bound;
  3. main path at full ViT-B/16 width (12x768 vision, 12x512 text, seeded
     random bf16 weights): a bf16 caption bank built through the kernels, a
     six-member ensemble over the 80 COCO classes, and two 480x640 images
     (305 crops each) scored by make_engine's TTAEngine through
     run_batches_fused_staged — launch counters must show both kernels ran;
     impreds.json is written and read back; features and scores of the
     kernels' engine are held against the unfused plain path on a small input.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.

Imports nothing of JAX or the JAX package."""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
N_IMAGES = 2               # images per scored batch: 2 x 305 = 610 crops
BANK_ROWS = 8192


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median per-call time of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bf16_tol(ref: torch.Tensor) -> torch.Tensor:
    """Kernel and plain version round to bf16 at the same points and differ
    only in fp32 summation order: at most 4 bf16 ulps of max(1, |ref|)."""
    return 4 * 2.0 ** -8 * ref.float().abs().clamp(min=1.0)


def check_close(name, out, ref):
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (out.float() - ref.float()).abs()
    tol = bf16_tol(ref)
    err = diff.max().item()
    log(f"  {name}: max|kernel - plain| = {err:.6g} (tolerance 4 bf16 ulps of max(1,|ref|), "
        f"max tol {tol.max().item():.4g}; reason: same bf16 rounding points, different fp32 "
        f"accumulation order)")
    if not (diff <= tol).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max {err})")
    return err


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def lib_attn(x, s, b, qw, qb, ow, ob, heads, kv_len, causal):
    """Yardstick from PyTorch's own ops (LN, linear, SDPA); never used by the port."""
    bsz, t, d = x.shape
    y = F.layer_norm(x, (d,), s, b)
    qkv = F.linear(y, qw.t(), qb).view(bsz, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    mask = None
    if not causal and kv_len < t:
        mask = (torch.arange(t, device=x.device) < kv_len)[None, None, None, :]
    att = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=mask,
                                         is_causal=causal)
    return x + F.linear(att.transpose(1, 2).reshape(bsz, t, d), ow.t(), ob)


def lib_mlp(x, s, b, fw, fb, pw, pb):
    h = F.linear(F.layer_norm(x, (x.shape[-1],), s, b), fw.t(), fb)
    return x + F.linear(h * torch.sigmoid(1.702 * h), pw.t(), pb)


def phase_kernels(bk, gen):
    """Each kernel vs its plain version at the main path's shapes."""
    dev = torch.device("cuda")

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).bfloat16()

    def weights(d, hidden):
        attn = [1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, 3 * d, std=d ** -0.5),
                rn(3 * d, std=0.02), rn(d, d, std=(d ** -0.5) / math.sqrt(24)), rn(d, std=0.02)]
        mlp = [1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, hidden, std=(2 * d) ** -0.5),
               rn(hidden, std=0.02), rn(hidden, d, std=(d ** -0.5) / math.sqrt(24)),
               rn(d, std=0.02)]
        return attn, mlp

    shapes = {  # name: (batch, tokens, width, heads, kv_len, causal)
        "vit": (N_IMAGES * 305, 200, 768, 12, 197, False),
        "text": (256, 77, 512, 8, 77, True),
    }
    res = {}
    for tag, (b, t, d, heads, kv_len, causal) in shapes.items():
        x = rn(b, t, d)
        attn, mlp = weights(d, 4 * d)
        log(f"[kernels] {tag}: x [{b}, {t}, {d}] bf16, {heads} heads, kv_len {kv_len}, "
            f"causal {causal}")
        a_err = check_close("attn_block_bf16", bk.attn_block_bf16(x, *attn, heads, kv_len=kv_len,
                                                                  causal=causal),
                            bk.attn_block_bf16_plain(x, *attn, heads, kv_len=kv_len,
                                                     causal=causal))
        m_err = check_close("mlp_bf16", bk.mlp_bf16(x, *mlp), bk.mlp_bf16_plain(x, *mlp))
        pairs = t * (t + 1) / 2 if causal else t * kv_len
        a_bound = bound(8 * b * t * d * d + 4 * b * d * pairs, 4 * b * t * d + 8 * d * d)
        rows, hid = b * t, 4 * d
        m_bound = bound(4 * rows * d * hid, 4 * rows * d + 4 * d * hid)
        res[tag] = {
            "attn_block_bf16": dict(
                max_abs_err=a_err,
                ms=cuda_ms(lambda: bk.attn_block_bf16(x, *attn, heads, kv_len=kv_len,
                                                      causal=causal), 10),
                plain_ms=cuda_ms(lambda: bk.attn_block_bf16_plain(x, *attn, heads, kv_len=kv_len,
                                                                  causal=causal), 3),
                library_ms=cuda_ms(lambda: lib_attn(x, *attn, heads, kv_len, causal), 10),
                bound_ms=a_bound[0], bound_by=a_bound[1]),
            "mlp_bf16": dict(
                max_abs_err=m_err,
                ms=cuda_ms(lambda: bk.mlp_bf16(x, *mlp), 10),
                plain_ms=cuda_ms(lambda: bk.mlp_bf16_plain(x, *mlp), 3),
                library_ms=cuda_ms(lambda: lib_mlp(x, *mlp), 10),
                bound_ms=m_bound[0], bound_by=m_bound[1]),
        }
        for k, r in res[tag].items():
            log(f"  {k} [{tag}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        del x, attn, mlp
        torch.cuda.empty_cache()
    return res


def synthetic_captions(n, gen_np):
    """[n, 77] token rows: SOT, 5-30 random BPE ids, EOT (the highest id)."""
    toks = np.zeros((n, 77), np.int32)
    lengths = gen_np.integers(5, 31, n)
    for i, length in enumerate(lengths):
        toks[i, 0] = 49406
        toks[i, 1:1 + length] = gen_np.integers(1, 49406, length)
        toks[i, 1 + length] = 49407
    return toks


def phase_main_path(bk, card):
    from leclip_tpu_torch.data.vocab import COCO_OBJECT_CATEGORIES
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.inference.pipeline import (DEFAULT_MODEL_GROUPS, build_caption_bank,
                                                     make_engine)
    from leclip_tpu_torch.inference.tta import build_model_spec
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
    from leclip_tpu_torch.models.dense_clip import DenseFlags
    from leclip_tpu_torch.models.prompt import build_prompt_learner
    from leclip_tpu_torch.ops.ensemble import write_impreds

    dev = torch.device("cuda")
    clip_cfg = PRESETS["ViT-B/16"]
    params = init_clip_params(torch.Generator(device=dev).manual_seed(0), clip_cfg,
                              dtype=torch.bfloat16, device=dev)
    log(f"[main] ViT-B/16 bf16 params: vision {clip_cfg.vision_layers}x{clip_cfg.vision_width}, "
        f"text {clip_cfg.transformer_layers}x{clip_cfg.transformer_width}")
    rng = np.random.default_rng(0)

    # caption bank through the fused kernels
    toks = synthetic_captions(BANK_ROWS, rng)
    batch = 256
    bk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = build_caption_bank(params, clip_cfg, toks, batch_size=batch, precision="bf16",
                              device=dev)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    bank_counts = bk.launch_counts()
    n_pass = math.ceil(BANK_ROWS / batch)
    log(f"[main] caption bank {bank.shape}: launches {bank_counts} "
        f"(expect {12 * n_pass} each: 12 layers x {n_pass} batches)")
    if not np.isfinite(bank).all() or bank.shape != (BANK_ROWS, clip_cfg.embed_dim):
        raise AssertionError("caption bank not finite / wrong shape")
    if not np.allclose(np.linalg.norm(bank, axis=-1), 1.0, atol=1e-3):
        raise AssertionError("caption bank rows are not unit norm")
    if any(v != 12 * n_pass for v in bank_counts.values()):
        raise AssertionError(f"bank build did not run both kernels per layer: {bank_counts}")
    log(f"[main] captions/s {BANK_ROWS / bank_s:.1f} ({BANK_ROWS} captions in {bank_s:.3f} s "
        f"incl. first-call setup) on {card}")

    # six members over the 80 COCO classes, grouped as the launcher groups them
    specs = {}
    seed = 1
    for names, evd, use_freq, n_ctx in DEFAULT_MODEL_GROUPS:
        for name in names:
            trainable, constants = build_prompt_learner(
                torch.Generator(device=dev).manual_seed(seed), params, COCO_OBJECT_CATEGORIES,
                n_ctx=n_ctx or 16, dtype=torch.bfloat16)
            seed += 1
            specs[name] = build_model_spec(params, clip_cfg, trainable, constants,
                                           DenseFlags(use_evidence=evd), use_freq=use_freq)
    log(f"[main] members: {[(n, int(s.trainable['ctx'].shape[0])) for n, s in specs.items()]}")
    freq = {"adj": rng.random((80, 80)) * 50, "nums": rng.random(80) * 50 + 1}
    cfg = setup_config(opts=["TEST.PREC", "bf16", "TEST.multi_scale", "(2, 3, 4)",
                             "TEST.use_freq", "True"])
    engine = make_engine(cfg, params, clip_cfg, specs, caption_bank=bank, freq_stats=freq,
                         device=dev)
    if not engine._fused:
        raise AssertionError("the engine did not select the fused bf16 kernels")
    images = [rng.integers(0, 255, (480, 640, 3)).astype(np.uint8) for _ in range(N_IMAGES)]
    crops = N_IMAGES * (1 + engine.n_blocks)
    log(f"[main] {N_IMAGES} images 480x640 -> {crops} crops per batch")

    warm = list(engine.run_batches_fused_staged(iter([images])))[0]  # first-call setup
    n_batches = 3
    bk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = list(engine.run_batches_fused_staged(iter([images] * n_batches), depth=2))
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    score_counts = bk.launch_counts()
    log(f"[main] scoring launches {score_counts} (expect {12 * n_batches} each: 12 layers x "
        f"{n_batches} batches)")
    if any(v != 12 * n_batches for v in score_counts.values()):
        raise AssertionError(f"scoring did not run both kernels per layer: {score_counts}")
    fused = outs[0]
    if fused.shape != (N_IMAGES, 80) or not np.isfinite(fused).all():
        raise AssertionError(f"fused scores bad: shape {fused.shape}")
    if any(not np.array_equal(o, fused) for o in outs) or not np.allclose(warm, fused):
        raise AssertionError("repeated batches gave different scores")
    log(f"[main] crop-forwards/s {n_batches * crops / score_s:.1f} ({n_batches} batches of "
        f"{crops} crops in {score_s:.3f} s, host prep staged ahead) on {card}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "impreds.json")
        write_impreds(fused, path)
        back = np.asarray(json.load(open(path)))
    if back.shape != (N_IMAGES, 80) or not np.allclose(back, fused):
        raise AssertionError("impreds.json did not read back")
    log(f"[main] impreds.json: {back.shape[0]} rows x {back.shape[1]} classes, finite, "
        f"read back; first row head {np.round(back[0, :4], 4).tolist()}")

    # correctness on a small input: the kernels' engine against the same
    # engine on the unfused plain path (bf16 compute on both). Image features
    # must agree to bf16 precision; the fused scores pass through gated block
    # fusion (max/min switched at a threshold), which turns bf16-ulp feature
    # differences into occasional jumps, so they are held by correlation
    from leclip_tpu_torch.inference.tta import TTAEngine
    from leclip_tpu_torch.models.dense_clip import encode_image_features

    small = dict(scales=(2,), caption_bank=torch.as_tensor(bank), crop_size=224,
                 compute_dtype=torch.bfloat16, device=dev, cooccurrence=engine.cooccurrence.cpu())
    one = [images[0]]
    k_eng = TTAEngine(params, clip_cfg, specs, bf16_fused=True, **small)
    p_eng = TTAEngine(params, clip_cfg, specs, bf16_fused=False, **small)
    with torch.inference_mode():
        crops_in = k_eng._crops(k_eng.stage_batch_fused(one)).flatten(0, 1)
        fk = encode_image_features(params, clip_cfg, crops_in, DenseFlags(), fused=True)
        fp = encode_image_features(params, clip_cfg, crops_in, DenseFlags(), fused=False)
        cos_g = (fk.global_feat.float() * fp.global_feat.float()).sum(-1).min().item()
        cos_d = (fk.spatial_feats.float() * fp.spatial_feats.float()).sum(-1).min().item()
    f_k, f_p = k_eng.run_batch_fused(one), p_eng.run_batch_fused(one)
    corr = np.corrcoef(f_k.ravel(), f_p.ravel())[0, 1]
    log(f"[main] small input (1 image, {crops_in.shape[0]} crops), fused kernels vs unfused "
        f"plain path: min cosine global {cos_g:.5f}, dense {cos_d:.5f} (> 0.99); scores "
        f"corr {corr:.6f} (> 0.999), max|d| {np.abs(f_k - f_p).max():.4g}")
    if not (cos_g > 0.99 and cos_d > 0.99 and corr > 0.999 and np.isfinite(f_k).all()):
        raise AssertionError("fused engine disagrees with the plain engine")
    return {k: bank_counts[k] + score_counts[k] for k in bank_counts}, bank_counts, score_counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from leclip_tpu_torch.ops import _build
    from leclip_tpu_torch.ops import block_kernels as bk

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are fp32 products
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {name}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[device] kernels built in {time.perf_counter() - t0:.2f} s: "
        f"{ {k: round(v, 2) for k, v in built.items()} }")
    for k in _build.KERNELS:
        _build.load(k)
        regs = [ln.strip() for ln in _build.build_log(k).splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[device] ptxas {k}: {' | '.join(regs)}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    kern = phase_kernels(bk, gen)
    total, bank_counts, score_counts = phase_main_path(bk, card)

    sources = {"attn_block_bf16": ("leclip_tpu_torch/csrc/attn_block_bf16.cu",
                                   "leclip_tpu/ops/block_kernels.py:122"),
               "mlp_bf16": ("leclip_tpu_torch/csrc/mlp_bf16.cu",
                            "leclip_tpu/ops/block_kernels.py:185")}
    line = {"kernels": []}
    for k, (src, replaces) in sources.items():
        vit, text = kern["vit"][k], kern["text"][k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": total[k],
            "max_abs_err": max(vit["max_abs_err"], text["max_abs_err"]),
            "ms": vit["ms"], "plain_ms": vit["plain_ms"], "bound_ms": vit["bound_ms"],
            "bound_by": vit["bound_by"], "library_ms": vit["library_ms"],
            "shape": f"ViT-B/16 image tower [{N_IMAGES * 305}, 200, 768]",
            "text_shape": "caption bank [256, 77, 512] causal",
            "text": {key: text[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by")},
            "launches_bank": bank_counts[k], "launches_scoring": score_counts[k],
        })
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
