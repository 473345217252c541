"""Chip smoke test of the PyTorch / CUDA port (leclip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: card name, power limit, the nvcc build of every kernel (eleven
     libraries, one nvcc each, all started together), and in the SASS of the
     four libraries whose products run on the Hopper GEMMs the wgmma (HGMMA
     bf16 in attn_block_bf16, mlp_bf16 and attn_block_int8's out-projection;
     IGMMA int8 in attn_block_int8 and mlp_int8, which must hold no mma.sync
     IMMA) and UTMALDG (TMA load) instructions that show it, in
     flash_attention's the HMMA (mma.sync) of its bf16 tensor-core path,
     in conv_bf16's HGMMA, UTMALDG and LDGSTS (its cp.async loads), and in
     conv_fp32's FFMA and LDGSTS with no tensor-core product (HMMA, HGMMA:
     no TF32);
  2. kernels: each of the seven kernels of the ViT and text paths
     (attn_block_bf16, mlp_bf16, ln_quant, attn_block_int8, mlp_int8,
     resident_attention, flash_attention; the eighth and ninth, conv_bf16
     and conv_fp32, are held at the RN50 trunk's shapes in phase 5) against
     its plain version on the card at the
     main paths' shapes (ViT-B/16 crops, caption-bank text, the trainer's
     [1024, 77, 512] causal caption branch for the five block kernels; the attention
     kernels also at ViT-L/14's 264 tokens, in fp32 and bf16), with
     CUDA-event timings, a PyTorch-ops yardstick and the roofline bound (the
     attention kernels and their yardstick also by device time alone,
     torch.profiler); resident_attention's gradient against autograd
     through its reference; the int8 GEMM epilogue's branch-free forms
     against the divisions they replace;
     resize_band (the crops of a batch: the scale, the banded bicubic resize
     and the normalisation) against its plain version at the scoring cells'
     batches, timed beside it and its bound (scripts/probe_resize_band.py
     runs this part alone);
     avg_pool_nhwc (the ResNet trunk's average pools) at RN50's seven pool
     shapes at the scored batch's crops, bf16 and fp32: 0 values differ
     from F.avg_pool2d, timed beside the library's pool and its bytes bound
     (scripts/probe_avg_pool.py runs this part alone);
     and the device time and rate of every launch inside the four block
     kernels at the ViT shape (scripts/probe_port_kernels.py, torch.profiler);
  3. the main paths at full ViT-B/16 width (12x768 vision, 12x512 text,
     seeded random bf16 weights), TEST.PREC bf16 and then TEST.PREC auto,
     which must resolve to int8 on the card: a caption bank of 8,192 rows
     built through the kernels, a six-member ensemble over the 80 COCO
     classes, and two 480x640 images (305 crops each) scored by make_engine's
     TTAEngine through run_batches_fused_staged — launch counters must show
     that each path ran its own kernels in every layer and none of the other
     path's; impreds.json is written and read back; the bf16 engine is held
     against the unfused plain path on a small input, and the int8 engine and
     bank against the bf16 ones; then the bf16 ViT batch split into its
     stages by CUDA events (host staging, resize + normalise, patch
     embedding, block kernels, retrieval, scoring + fusion);
  4. the unfused paths on the same weights in fp32: TEST.PREC fp32 (the
     reference-parity precision; fp32 caption bank, fp32 prompt features),
     whose image tower runs resident_attention in every layer, and one batch
     with DenseFlags(attention_impl="pallas"), which runs flash_attention in
     every layer of the image tower and of the prompt-feature text pass; both
     held against an attention_impl="xla" plain fp32 engine;
  5. the RN50 scoring path that every shipped recipe runs, at full RN50
     geometry with seeded random bf16 weights and random BN statistics:
     TEST.PREC auto (→ bf16 for a ResNet tower) with its 8,192-row bf16
     caption bank through attn_block_bf16 + mlp_bf16, make_engine, three
     staged batches and run_full_inference → impreds.json, the image tower
     launching conv_bf16 in each of its 55 convolutions (the batch norm, the
     residual add and the ReLUs fused in its epilogue); then TEST.PREC fp32,
     its tower launching conv_fp32 in each of the 55; bf16 held against
     fp32, the fp32 tower held to cuDNN fp32 with TF32 switched on around it
     (and bitwise itself with the tower's own no_tf32 guard lifted); at each
     of the 55 trunk calls on the engines' own 610 crops: conv_bf16 (the
     epilogue off) against conv_bf16_plain within 1 bf16 ulp of
     max(|plain|, 2^-8 sum|a||w|); conv_fp32 (the epilogue off) against
     conv_fp32_plain within 2^-16 sum|a||w|; in both dtypes the fused call
     (models/resnet.conv_bn: batch norm, residual, ReLU in the epilogue)
     equal to the unfused chain over the bare kernel's output (torch.equal);
     at the head's 6 fp32 products (conv_fp32 as 1x1 convolutions) against
     y @ w with TF32 off within the same bound, and with the bias in the
     epilogue equal to the product + bias; each timed beside its plain
     version and cuDNN in its dtype, the fused calls against cuDNN + the
     unfused chain, the products (bare and with the bias) beside cuBLAS's;
     conv_fp32's tile witness (a convolution and a product at two batch
     sizes whose tiles differ: the shared crops bit for bit the same); each
     precision's batch split into stages as in phase 3 on its kernel, then
     on its kernel with the chain unfused and on cuDNN throughout;
  6. the caption-distillation trainer that all 19 recipes run, at RN50's
     text width (12x512, seeded random fp32 weights) on 8,192 synthetic
     captions with token-decided labels over the 80 COCO classes, the ema
     recipe's settings (N_CTX 64, EMA teacher, SGD, constant warmup LR 1e-3,
     batch 1024: 8 steps an epoch): CaptionDistillTrainer.train() for 2
     epochs under TRAINER.PREC fp32, bf16 (caption branch on
     attn_block_bf16 + mlp_bf16), TRAIN.int8_captions (ln_quant + the int8
     blocks) and fp32 with use_evidence, each writing model.ckpt-1 — launch
     counters show each run's own kernels at 12 a step and no other, every
     loss is finite and the 16th step's is below the first's, the bf16 and
     int8 runs' first-step caption features and prompt gradients are held
     against fp32's (cosine >= 0.99), their caption features of 64 captions
     against the CPU port's same route on the same weights (cosine >= 0.9995
     bf16, 0.999 int8) and the int8 run's against the fp32 residual stream
     of the JAX package's route (cosine >= 0.999), the fp32 step against itself with TF32
     switched on around it (equal) and against float64 on the card (1e-4),
     the checkpoint reads back bitwise, a trainer resumed from it takes the
     uninterrupted run's next step exactly, and the checkpoint scores one
     batch as an RN50 make_engine member; steps/s, captions/s, peak memory
     and a per-step split by CUDA events are printed.
  7. on the engines of phases 3 (ViT-B/16 TEST.PREC auto -> int8) and 5
     (RN50 auto -> bf16, its bf16 bank), run after phase 5 and freed before
     phase 6: the per-member dump path, run_full_inference(save_dir) over
     four 480x640 PNG files in two batches, against the fused path on the
     same files (cli.gen_final_ans on data.pkl / sim_matrix.pkl within 1e-4
     of max(1, max|fused|); run_batch against run_batch_multidispatch;
     JAX's pickle keys and shapes; int8 kernels in every ViT layer, none in
     the RN50 tower), with both paths' crop-forwards/s; python -m
     leclip_tpu_torch.cli.build_caption_bank --backbone RN50 at precision
     default, bf16 and int8 over the 8,192 synthetic captions written as a
     corpus, each bank bitwise equal to build_caption_bank() called here,
     bf16 / int8 rows at cosine >= 0.995 to fp32, captions/s of the command
     and of the encode; the scoring service (cli/serve.py build_service,
     TEST.PREC auto, batch 8) for each engine behind a ThreadingHTTPServer:
     128 POSTs of one 480x640 JPEG from 16 clients, every answer within 1e-4
     of engine.run_batch_fused, /healthz 305 crops, /metrics 128 requests
     and no error; images/s, p50/p99 latency, padding share, peak memory;
     128 more at a 50 ms micro-batch window (reported); then 128 more with
     one POST /reload in flight; the RN50 batch witness (run again, reversed,
     another company, 5 padded to 8 against 5 alone: the bf16 and the fp32
     engines must read 0 in all four), also split by stage (crops, trunk,
     pool, dense projection, scores) and by operation (each convolution
     with its batch norm, each average pool, each product of the pool and
     the dense projection, alone on its input), each over batches of 1, 2
     and 5 images, 5 padded to 8 and the 8 reversed against the same images
     in the batch of 8, for each engine on its routes side by side: bf16 on
     cuDNN bf16 and conv_bf16; fp32 on cuDNN fp32 and conv_fp32; the port's
     route must read 0 everywhere; and one line on
     whether the native JPEG decoder's toolchain (g++, jpeglib.h, libjpeg)
     exists.
  8. after phase 6, on its fp32 trainer: the native JPEG decoder (what the
     probe finds, its build from runtime/, 64 JPEGs 480x640 bitwise equal to
     PIL with none sent to PIL, images/s against PIL); trainer.validate()
     with an RN50 image tower over 64 val images at 305 crops, and a
     ViT-B/16 trainer of 2 steps validated on 16 images (resident_attention
     in every layer), each against run_batch of a freshly built one-member
     engine; the adapter trainer (fp32, bf16, int8 captions; frozen and
     trainable; 16 steps each: falling loss, launches, a resumed step, the
     first-step prompt gradient against the CPU port); the five other
     optimizers (8 steps against the CPU port, the card's checkpoint read
     back bitwise); a TRAIN.profile_dir window whose trace names the block
     kernels; the zero-shot CLI in a fresh process for RN50 and ViT-B/16
     against attention_impl="xla"; score_caption_benchmark over 1,024
     captions and six members, bf16 against fp32 and fp32 against the CPU
     port.
  9. dual-encoder fine-tuning (engine/finetune.py, config 4): resident_attention
     under autograd at [64, 200, 768] fp32, kv_len 197 (output against its
     plain version, dq/dk/dv against autograd through
     packed_attention_reference, forward + backward timed beside SDPA and
     the bound); the full-width ViT-B/16 fp32 train_step at batch 64 with
     remat on the text tower, one warm-up and 3 warm steps on the "auto"
     route (12 resident launches per image forward) against the same steps
     with attention_impl="xla" (loss, gradient norm, parameters within
     1e-4 relative); fit_pairs over 256 JPEGs rendered by
     data/synth_images.py, read by PairBatcher on the native decoder with
     the augmentation on the card, 2 epochs with checkpoints, then a fresh
     tuner resumed at epoch 2 with the same step and parameters; one warm
     step split by CUDA events (augmentation, each tower's forward and
     backward, loss, optimizer) with images/s and peak memory; RN101 at
     batch 32, 2 steps with the loss falling.
 10. the data mesh (leclip_tpu_torch/parallel/): torchrun --standalone
     starts chip_smoke.py --phase10 as NCCL ranks, one a card (world 1 on
     one card; worlds 2 and 4 only where the machine has that many cards,
     "not run" printed otherwise: NCCL refuses two ranks on one card). Each
     rank joins the group from torchrun's variables and drives the real
     entry points: CaptionDistillTrainer on the mesh (RN50 text tower, bf16
     caption branch on attn_block_bf16 + mlp_bf16, 4 steps of 1024 captions
     a rank): prefetch 2 bitwise equal to the inline loop, the ranks'
     parameters bitwise equal, at world 1 bitwise equal to a trainer
     without a process group, a rank-0 checkpoint and a resume;
     CLIPFineTuner on the mesh (ViT-B/16 fp32, 2 steps of 64 pairs a rank,
     the loss over the global batch, resident_attention in every image
     layer): prefetch 2 bitwise equal, the ranks equal, at world 1 within
     phase 9's bounds of the tuner without a group; make_engine(TEST.PREC
     auto -> int8, mesh, shard_bank=True) on an 8,192-row int8 bank
     against the engine without a mesh (within 1e-4; the same int8
     codes), its launches counted, and the ring retrieval timed against
     the replicated one. The ranks' launch counts join the kernels line.
     ``python3 chip_smoke.py --only-phase10`` builds the kernels and runs
     this phase alone, without the result lines.
RN50's convolutions (models/resnet.conv2d, conv_bn): on the card every bf16
one runs the hand-written conv_bf16 kernel with the batch norm, residual
add and ReLU in its epilogue (unfused under autograd), every fp32 one the
hand-written conv_fp32 kernel (one FMA chain over K an output, no TF32), so
that an image's scores do not depend on the batch in either precision; on
the CPU their plain versions with the chain unfused. The CPU tests of those
routes, against JAX:
``JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_resnet.py``; the
card tests of every kernel: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py``; the convolution kernels alone:
``python3 scripts/probe_conv_kernel.py``.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.

Imports nothing of JAX or the JAX package."""

import contextlib
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
N_IMAGES = 2               # images per scored batch: 2 x 305 = 610 crops
BANK_ROWS = 8192
DEVICE = torch.device("cuda")


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


def device_ms(fn, reps: int = 5) -> float:
    """Device time per call of the CUDA kernels ``fn`` launches, by
    torch.profiler, without the host's share (which ``cuda_ms`` counts where
    the host is slower than the card: a small attention call's Python)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0)
    return total / reps / 1e3


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
    return bound_s(flops / PEAK_BF16_FLOPS, nbytes)


def bound_s(t_ops: float, nbytes: float):
    """(bound ms, what bounds it) from the operations' time at their peak
    rate and the bytes that must move."""
    t_bytes = nbytes / PEAK_BYTES
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


SHAPES = {  # name: (batch, tokens, width, heads, kv_len, causal)
    "vit": (N_IMAGES * 305, 200, 768, 12, 197, False),
    "text": (256, 77, 512, 8, 77, True),
    "train": (1024, 77, 512, 8, 77, True),  # the trainer's caption branch (phase 6)
}


def phase_kernels_bf16(bk, gen):
    """Each bf16 kernel vs its plain version at the main path's shapes."""
    dev = DEVICE

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).bfloat16()

    def weights(d, hidden):
        attn = [1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, 3 * d, std=d ** -0.5),
                rn(3 * d, std=0.02), rn(d, d, std=(d ** -0.5) / math.sqrt(24)), rn(d, std=0.02)]
        mlp = [1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, hidden, std=(2 * d) ** -0.5),
               rn(hidden, std=0.02), rn(hidden, d, std=(d ** -0.5) / math.sqrt(24)),
               rn(d, std=0.02)]
        return attn, mlp

    res = {}
    for tag, (b, t, d, heads, kv_len, causal) in SHAPES.items():
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


# ------------------------------ int8 kernels --------------------------------

# Tolerances of the int8 kernels against their plain versions. Integer sums
# are exact and the fp32 epilogues run the same operations in the same order
# (no fused multiply-add), so the two differ only through the LayerNorm
# statistics (summed in another order): a value within an ulp of a .5
# boundary may round to the neighbouring int8 code, and that row of the
# product then moves by up to one quantization step per element
# (127 * s_row * s_col, printed) before the rest of the block spreads it.
# Measured at the ViT-B/16 shape (NVIDIA H100 80GB HBM3, 700.00 W): 35 of
# 93.7e6 codes flipped; no row of attn_block_int8 and 3 of 122,000 rows of
# mlp_int8 held an element beyond 4 bf16 ulps, the largest at 6.5.
LN_CODE_FLIP_FRACTION = 1e-4   # share of int8 codes that may differ, each by exactly 1
SCALE_RTOL = 1e-6              # per-row scales
BLOCK_ROW_FRACTION = 1e-3      # share of rows that may hold an element beyond 4 bf16 ulps
BLOCK_ULP_CAP = 16             # ... and no element anywhere beyond this many


def int_mm_works() -> bool:
    """Whether torch._int_mm (the library's int8 product, a yardstick only)
    runs on this build and card."""
    if not hasattr(torch, "_int_mm"):
        return False
    a = torch.ones((32, 128), dtype=torch.int8, device=DEVICE)
    w = torch.ones((128, 128), dtype=torch.int8, device=DEVICE).t()  # K contiguous per column
    try:
        ok = bool((torch._int_mm(a, w) == 128).all())
    except RuntimeError as e:
        log(f"  torch._int_mm unavailable ({str(e).splitlines()[0]}): the library yardstick "
            "uses bf16 F.linear for the int8 products")
        return False
    return ok


def lib_ln_quant(x, s, b):
    """Yardstick: LN + per-row quantization in PyTorch's own ops."""
    y = F.layer_norm(x.float(), (x.shape[-1],), s.float(), b.float())
    sc = (y.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(y / sc).clamp(-127, 127).to(torch.int8), sc


def lib_int8_linear(xi, sx, w_i8, s_w, bias, int_mm: bool):
    """Yardstick for one W8A8 product: torch._int_mm where it runs, else the
    dequantized bf16 F.linear."""
    if int_mm:
        acc = torch._int_mm(xi, w_i8).float()
        return acc * (sx * s_w) + bias.float()
    w = (w_i8.float() * s_w).bfloat16()
    return F.linear((xi.float() * sx).bfloat16(), w.t(), bias).float()


def lib_attn_int8(x, s, b, w_i8, s_w, qb, ow, ob, heads, kv_len, causal, int_mm):
    bsz, t, d = x.shape
    xi, sx = lib_ln_quant(x.reshape(bsz * t, d), s, b)
    qkv = lib_int8_linear(xi, sx, w_i8, s_w, qb, int_mm).bfloat16()
    qkv = qkv.view(bsz, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    mask = None
    if not causal and kv_len < t:
        mask = (torch.arange(t, device=x.device) < kv_len)[None, None, None, :]
    att = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=mask,
                                         is_causal=causal)
    return x + F.linear(att.transpose(1, 2).reshape(bsz, t, d), ow.t(), ob)


def lib_mlp_int8(x, s, b, fw, fs, fb, pw, ps, pb, int_mm):
    d = x.shape[-1]
    xi, sx = lib_ln_quant(x.reshape(-1, d), s, b)
    h = lib_int8_linear(xi, sx, fw, fs, fb, int_mm)
    h = h * torch.sigmoid(1.702 * h)
    hs = (h.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
    hi = torch.round(h / hs).clamp(-127, 127).to(torch.int8)
    o = lib_int8_linear(hi, hs, pw, ps, pb, int_mm)
    return (x.reshape(-1, d).float() + o).bfloat16().reshape(x.shape)


def check_ln_quant(qk, x, ln_s, ln_b):
    xi, xs = qk.ln_quant(x, ln_s, ln_b)
    ri, rs = qk.ln_quant_plain(x, ln_s, ln_b)
    torch.cuda.synchronize()
    d = (xi.int() - ri.int()).abs()
    flips = int((d != 0).sum().item())
    frac = flips / d.numel()
    s_err = ((xs - rs).abs() / rs).max().item()
    log(f"  ln_quant: {flips} of {d.numel()} codes differ from the plain version "
        f"({frac:.3g}; allowed {LN_CODE_FLIP_FRACTION:g}, each by exactly 1), max |d code| "
        f"{int(d.max().item())}; scales max rel err {s_err:.3g} (allowed {SCALE_RTOL:g}); "
        "reason: a value within an ulp of a .5 boundary, LN statistics summed in another order")
    if xi.dtype != torch.int8 or xs.shape != rs.shape or not torch.isfinite(xs).all():
        raise AssertionError("ln_quant: wrong output type / shape / non-finite scale")
    if int(d.max().item()) > 1 or frac > LN_CODE_FLIP_FRACTION or s_err > SCALE_RTOL:
        raise AssertionError("ln_quant: kernel disagrees with its plain version")
    return float(d.max().item())


def check_int8_block(name, out, ref, step):
    """Within 4 bf16 ulps of max(1, |ref|) on all but the few rows a flipped
    int8 code touches, and nowhere beyond BLOCK_ULP_CAP ulps."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    d = out.shape[-1]
    diff = (out.float() - ref.float()).abs().reshape(-1, d)
    ulps = 4 * diff / bf16_tol(ref).reshape(-1, d)
    rows_over = (ulps > 4).any(-1).float().mean().item()
    err, worst = diff.max().item(), ulps.max().item()
    log(f"  {name}: max|kernel - plain| = {err:.6g}; rows with an element beyond 4 bf16 ulps "
        f"of max(1,|ref|): {rows_over:.3g} (allowed {BLOCK_ROW_FRACTION:g}); largest "
        f"{worst:.3g} ulps (allowed {BLOCK_ULP_CAP}); one quantization step of its first "
        f"product, 127*s_row*s_col = {step:.4g}; reason: exact integer sums and the same fp32 "
        "epilogue operations, so only rows whose int8 code flipped at a .5 boundary differ by "
        "more than accumulation order")
    if rows_over > BLOCK_ROW_FRACTION or worst > BLOCK_ULP_CAP:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max {err})")
    return err


def phase_kernels_int8(qk, gen):
    """ln_quant, attn_block_int8 and mlp_int8 vs their plain versions at the
    main path's shapes; weights from quantize_block_stack of seeded bf16
    blocks with a few outlier LN channels."""
    from leclip_tpu_torch.models.transformer import init_block_stack, layer_params
    from leclip_tpu_torch.ops.quant import quantize_block_stack

    dev = DEVICE
    int_mm = int_mm_works()
    log(f"[kernels] library yardstick for int8 products: "
        f"{'torch._int_mm' if int_mm else 'bf16 F.linear on dequantized operands'}")
    bad = qk.int8_exact_forms_check(dev)
    log(f"[kernels] int8 GEMM epilogue, branch-free forms against the divisions they replace: "
        f"{bad[0]} of the 1,056,964,609 fp32 reciprocals in [1, 2^126] and {bad[1]} of 1.2e8 "
        "quantizer codes (3/4 within 4 ulps of a .5 boundary) differ (must be 0, 0)")
    if bad != (0, 0):
        raise AssertionError("the int8 epilogue's division-free forms are not exact")

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).bfloat16()

    res = {}
    for tag, (b, t, d, heads, kv_len, causal) in SHAPES.items():
        blocks = init_block_stack(gen, 1, d, dtype=torch.bfloat16, device=dev)
        gain = torch.ones(d, device=dev)
        gain[[5, 17, 42]] = 10.0  # outlier LN channels, as real CLIP ViTs carry
        for ln in ("ln_1", "ln_2"):
            blocks[ln]["scale"] = ((1 + rn(1, d, std=0.1).float()) * gain).bfloat16()
            blocks[ln]["bias"] = rn(1, d, std=0.1)
        blocks["attn"]["qkv_bias"] = rn(1, 3 * d, std=0.02)
        blocks["attn"]["out_bias"] = rn(1, d, std=0.02)
        blocks["mlp"]["fc_bias"] = rn(1, 4 * d, std=0.02)
        blocks["mlp"]["proj_bias"] = rn(1, d, std=0.02)
        q8 = layer_params(quantize_block_stack(blocks), 0)
        p = layer_params(blocks, 0)
        attn = (*q8["ln1"], *q8["attn"]["qkv"], p["attn"]["qkv_bias"], p["attn"]["out_kernel"],
                p["attn"]["out_bias"])
        mlp = (*q8["ln2"], *q8["mlp"]["fc"], p["mlp"]["fc_bias"], *q8["mlp"]["proj"],
               p["mlp"]["proj_bias"])
        x = rn(b, t, d)
        log(f"[kernels] {tag} int8: x [{b}, {t}, {d}] bf16, {heads} heads, kv_len {kv_len}, "
            f"causal {causal}")
        akw = dict(kv_len=kv_len, causal=causal)
        l_err = check_ln_quant(qk, x, *q8["ln1"])
        _, xs1 = qk.ln_quant_plain(x, *q8["ln1"])
        a_step = 127 * xs1.max().item() * q8["attn"]["qkv"][1].max().item()
        a_err = check_int8_block("attn_block_int8", qk.attn_block_int8(x, *attn, heads, **akw),
                                 qk.attn_block_int8_plain(x, *attn, heads, **akw), a_step)
        _, xs2 = qk.ln_quant_plain(x, *q8["ln2"])
        m_step = 127 * xs2.max().item() * q8["mlp"]["fc"][1].max().item()
        m_err = check_int8_block("mlp_int8", qk.mlp_int8(x, *mlp), qk.mlp_int8_plain(x, *mlp),
                                 m_step)
        rows, hid = b * t, 4 * d
        pairs = t * (t + 1) / 2 if causal else t * kv_len
        l_bound = bound_s(10 * rows * d / PEAK_FP32_FLOPS, 3 * rows * d + 4 * rows + 4 * d)
        a_bound = bound_s(6 * rows * d * d / PEAK_INT8_OPS
                          + (2 * rows * d * d + 4 * b * d * pairs) / PEAK_BF16_FLOPS,
                          4 * rows * d + 3 * d * d + 2 * d * d)
        m_bound = bound_s(4 * rows * d * hid / PEAK_INT8_OPS, 4 * rows * d + 2 * d * hid)
        res[tag] = {
            "ln_quant": dict(
                max_abs_err=l_err,
                ms=cuda_ms(lambda: qk.ln_quant(x, *q8["ln1"]), 10),
                device_ms=device_ms(lambda: qk.ln_quant(x, *q8["ln1"])),
                plain_ms=cuda_ms(lambda: qk.ln_quant_plain(x, *q8["ln1"]), 3),
                library_ms=cuda_ms(lambda: lib_ln_quant(x, *q8["ln1"]), 10),
                bound_ms=l_bound[0], bound_by=l_bound[1]),
            "attn_block_int8": dict(
                max_abs_err=a_err,
                ms=cuda_ms(lambda: qk.attn_block_int8(x, *attn, heads, **akw), 10),
                plain_ms=cuda_ms(lambda: qk.attn_block_int8_plain(x, *attn, heads, **akw), 2),
                library_ms=cuda_ms(lambda: lib_attn_int8(x, *attn, heads, kv_len, causal,
                                                         int_mm), 5),
                bound_ms=a_bound[0], bound_by=a_bound[1]),
            "mlp_int8": dict(
                max_abs_err=m_err,
                ms=cuda_ms(lambda: qk.mlp_int8(x, *mlp), 10),
                plain_ms=cuda_ms(lambda: qk.mlp_int8_plain(x, *mlp), 2),
                library_ms=cuda_ms(lambda: lib_mlp_int8(x, *mlp, int_mm), 5),
                bound_ms=m_bound[0], bound_by=m_bound[1]),
        }
        for k, r in res[tag].items():
            log(f"  {k} [{tag}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        r = res[tag]["ln_quant"]
        log(f"  ln_quant [{tag}]: device time alone {r['device_ms']:.4f} ms, "
            f"{(3 * rows * d + 4 * rows) / r['device_ms'] / 1e9:.3f} TB/s of the "
            f"{3 * rows * d + 4 * rows:.4g} bytes it must move")
        del x, attn, mlp, blocks, q8, p
        torch.cuda.empty_cache()
    return res


# ---------------------------- attention kernels -----------------------------

FP32_ATOL = 2e-5  # fp32 kernels on unit-scale inputs: fp32 sums in another order, no TF32
# bf16 attention outputs sit mostly at |x| ~ 0.1-0.3, so their ulps are taken
# of |ref| itself, floored at 2^-4 where an output nears zero; a p rounded
# across a bf16 boundary (its fp32 score summed in another order) moves o by
# 2^-8 (p/l) |v - o|, which scales with |v| and not |o| and is largest in rows
# with few keys (early causal rows): such outputs, at most ATTN_BF16_TAIL of
# them, are held to 2 ulps of max(1, |ref|) instead
ATTN_BF16_FLOOR = 2.0 ** -4
ATTN_BF16_TAIL = 1e-5


def check_attn(name, out, ref):
    """fp32 within FP32_ATOL absolute; bf16 within 4 bf16 ulps of
    max(|ref|, 2^-4) on all but ATTN_BF16_TAIL of the outputs, and within 2
    ulps of max(1, |ref|) everywhere."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if out.dtype == torch.float32:
        log(f"  {name}: max|kernel - plain| = {err:.6g} (tolerance {FP32_ATOL:g} absolute on "
            "unit-scale inputs; reason: fp32 sums in another order, no TF32)")
        ok = err <= FP32_ATOL
    else:
        rel = diff / (2.0 ** -8 * ref.float().abs().clamp(min=ATTN_BF16_FLOOR))
        tail = (rel > 4).float().mean().item()
        ulps_1 = (diff / (2.0 ** -8 * ref.float().abs().clamp(min=1.0))).max().item()
        log(f"  {name}: max|kernel - plain| = {err:.6g}; {rel.max().item():.3g} bf16 ulps of "
            f"max(|ref|, 2^-4), {tail:.3g} of outputs beyond 4 (tolerance {ATTN_BF16_TAIL:g}); "
            f"{ulps_1:.3g} ulps of max(1, |ref|) (tolerance 2); reason: same bf16 rounding "
            "points, different fp32 accumulation order")
        ok = tail <= ATTN_BF16_TAIL and ulps_1 <= 2
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max {err})")
    return err


def lib_sdpa(q, k, v, kv_len, causal):
    """Yardstick: one PyTorch SDPA call with the same mask (pad keys as a
    boolean key mask); never used by the port."""
    t = q.shape[-2]
    mask = None
    if not causal and kv_len < t:
        mask = (torch.arange(t, device=q.device) < kv_len)[None, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal)


def _heads(y, heads):
    b, t, w = y.shape
    return y.reshape(b, t, heads, w // heads).transpose(1, 2)


ATTN_SHAPES = {  # name: (batch, tokens, heads, kv_len, causal)
    "vit": (N_IMAGES * 305, 200, 12, 197, False),   # ViT-B/16 image tower
    "text": (256, 77, 8, 77, True),                 # text tower (flash only: causal)
    "vitl": (64, 264, 16, 257, False),              # ViT-L/14: two key blocks of 256
}


def phase_kernels_attention(fa, gen):
    """resident_attention and flash_attention against their plain versions
    on q/k/v that are the three thirds of one packed qkv buffer, as the
    unfused path hands them over, in fp32 and bf16; and resident_attention's
    gradient against autograd through its reference."""
    from leclip_tpu_torch.ops.attention import causal_mask

    res = {"resident_attention": {}, "flash_attention": {}}
    for tag, (b, t, heads, kv_len, causal) in ATTN_SHAPES.items():
        w = 64 * heads
        for dt in (torch.float32, torch.bfloat16):
            key = f"{tag} {'fp32' if dt == torch.float32 else 'bf16'}"
            es = 4 if dt == torch.float32 else 2
            peak = PEAK_FP32_FLOPS if dt == torch.float32 else PEAK_BF16_FLOPS
            qkv = torch.randn(b, t, 3 * w, generator=gen, device=DEVICE).to(dt)
            q, k, v = qkv.split(w, dim=-1)
            qh, kh, vh = (_heads(y, heads) for y in (q, k, v))
            log(f"[kernels] attention {key}: q/k/v [{b}, {t}, {w}] ({heads} heads of 64), "
                f"kv_len {kv_len}, causal {causal}")
            lib_ms = cuda_ms(lambda: lib_sdpa(qh, kh, vh, kv_len, causal), 10)
            lib_dev = device_ms(lambda: lib_sdpa(qh, kh, vh, kv_len, causal))
            if not causal:
                err = check_attn("resident_attention",
                                 fa.resident_attention(q, k, v, heads, kv_len),
                                 fa.resident_attention_plain(q, k, v, heads, kv_len))
                bnd = bound_s(4 * b * heads * t * kv_len * 64 / peak, 4 * b * t * w * es)
                res["resident_attention"][key] = dict(
                    max_abs_err=err,
                    ms=cuda_ms(lambda: fa.resident_attention(q, k, v, heads, kv_len), 10),
                    plain_ms=cuda_ms(lambda: fa.resident_attention_plain(q, k, v, heads, kv_len),
                                     3),
                    library_ms=lib_ms, bound_ms=bnd[0], bound_by=bnd[1],
                    device_ms=device_ms(lambda: fa.resident_attention(q, k, v, heads, kv_len)),
                    library_device_ms=lib_dev)
            mask = (causal_mask(t, DEVICE) if causal else
                    torch.where(torch.arange(t, device=DEVICE) < kv_len, 0.0, -1e30))
            err = check_attn("flash_attention", fa.flash_attention(qh, kh, vh, mask=mask),
                             fa.flash_attention_plain(qh, kh, vh, mask=mask))
            pairs = t * (t + 1) / 2 if causal else t * t
            bnd = bound_s(4 * b * heads * pairs * 64 / peak, 4 * b * t * w * es + 4 * t * t)
            res["flash_attention"][key] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: fa.flash_attention(qh, kh, vh, mask=mask), 10),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(qh, kh, vh, mask=mask), 3),
                library_ms=lib_ms, bound_ms=bnd[0], bound_by=bnd[1],
                device_ms=device_ms(lambda: fa.flash_attention(qh, kh, vh, mask=mask)),
                library_device_ms=lib_dev)
            for name, rows in res.items():
                if key in rows:
                    r = rows[key]
                    log(f"  {name} [{key}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                        f"ms, library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                        f"({r['bound_by']}); device time alone: kernel {r['device_ms']:.4f} ms, "
                        f"library {r['library_device_ms']:.4f} ms")
            del qkv, q, k, v, qh, kh, vh, mask
            torch.cuda.empty_cache()

    # the backward pass recomputes packed_attention_reference, so its VJP must
    # equal autograd's through the reference up to the library's own sums
    b, t, heads, kv_len = 8, 200, 12, 197
    q, k, v = (torch.randn(b, t, 64 * heads, generator=gen, device=DEVICE).requires_grad_()
               for _ in range(3))
    cot = torch.randn(b, t, 64 * heads, generator=gen, device=DEVICE)
    got = torch.autograd.grad((fa.resident_attention(q, k, v, heads, kv_len) * cot).sum(),
                              (q, k, v))
    want = torch.autograd.grad(
        (fa.packed_attention_reference(q, k, v, heads, kv_len) * cot).sum(), (q, k, v))
    g_err = max((a - r).abs().max().item() for a, r in zip(got, want))
    log(f"[kernels] resident_attention backward [{b}, {t}, {64 * heads}] fp32, kv_len {kv_len}: "
        f"max|grad - autograd through packed_attention_reference| = {g_err:.3g} (tolerance "
        "1e-6; reason: the backward recomputes that reference, so only the library's sums "
        "could differ)")
    if not all(torch.isfinite(a).all() for a in got) or g_err > 1e-6:
        raise AssertionError("resident_attention: gradient disagrees with autograd")
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


def build_bank(prec, params, clip_cfg, toks, card, label="main"):
    """The caption bank through the kernels of precision ``prec``, first call
    and a warm second pass. Returns (bank, launch counts of the first call).
    For "fp32" it is the bank CLI's default precision: the fp32 tower as
    given, whose causal attention takes the plain route (no kernel)."""
    from leclip_tpu_torch.inference.pipeline import build_caption_bank
    from leclip_tpu_torch.ops import launches

    batch = 256
    n_pass = math.ceil(BANK_ROWS / batch)
    rates = []
    for which in ("first call", "warm second pass"):
        launches.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank = build_caption_bank(params, clip_cfg, toks, batch_size=batch,
                                  precision="default" if prec == "fp32" else prec,
                                  device=DEVICE)
        torch.cuda.synchronize()
        rates.append((which, BANK_ROWS / (time.perf_counter() - t0)))
        if which == "first call":
            counts, first = launches.launch_counts(), bank
    log(f"[{label}:{prec}] caption bank {bank.shape}: launches {counts} (12 layers x {n_pass} "
        f"batches of {batch})")
    if not np.isfinite(bank).all() or bank.shape != (BANK_ROWS, clip_cfg.embed_dim):
        raise AssertionError("caption bank not finite / wrong shape")
    if not np.allclose(np.linalg.norm(bank, axis=-1), 1.0, atol=1e-3):
        raise AssertionError("caption bank rows are not unit norm")
    if not np.array_equal(bank, first):
        raise AssertionError("the second bank pass gave different rows")
    expect_launches(f"{prec} bank", counts, "plain" if prec == "fp32" else prec, 12 * n_pass)
    log(f"[{label}:{prec}] captions/s " + ", ".join(f"{r:.1f} ({w})" for w, r in rates)
        + f" ({BANK_ROWS} captions) on {card}")
    return bank, counts


PATH_KERNELS = {  # path: launches of each of its kernels per layer
    "bf16": {"attn_block_bf16": 1, "mlp_bf16": 1},
    "int8": {"attn_block_int8": 1, "mlp_int8": 1, "ln_quant": 2},  # ln_quant inside each block
    "fp32": {"resident_attention": 1},
    "pallas": {"flash_attention": 1},
    "plain": {},
}


RN50_CONVS = 55  # convolutions of the RN50 trunk: conv_bf16 launches of one bf16 tower forward
RN_POOLS = 7     # average pools of a ResNet tower forward: the stem's, two a stride-2 stage
# conv_fp32 launches of one fp32 forward: every convolution, and the pool's
# fp32 products (q, k, v, c; 4) and the dense projection's (v, c; 2), which
# run conv_fp32 as 1x1 convolutions (models/resnet._proj)
POOL_PRODUCTS = {"dense": 6, "global": 4}
RN50_FP32 = RN50_CONVS + POOL_PRODUCTS["dense"]


def expect_launches(what, counts, path, n, rn_forwards=0, rn32_forwards=0, rn_convs=RN50_CONVS,
                    rn32_launches=RN50_FP32, resizes=0):
    """The kernels of ``path`` ran in each of n layers, conv_bf16 once per
    convolution (``rn_convs`` a forward) of each of ``rn_forwards`` bf16
    ResNet tower forwards and conv_fp32 ``rn32_launches`` times in each of
    ``rn32_forwards`` fp32 ones (None: a positive number of forwards),
    avg_pool_nhwc ``RN_POOLS`` times in each of those forwards, resize_band
    ``resizes`` times (once a batch of crops), and no other kernel ran."""
    want = dict.fromkeys(counts, 0)
    want.update({k: m * n for k, m in PATH_KERNELS[path].items()})
    want["resize_band"] = resizes
    for kernel, forwards, per in (("conv_bf16", rn_forwards, rn_convs),
                                  ("conv_fp32", rn32_forwards, rn32_launches)):
        got = counts.get(kernel, 0)
        if forwards is None and (got <= 0 or got % per):
            raise AssertionError(f"{what}: {kernel} launched {got} times, not a positive "
                                 f"multiple of a forward's {per}")
        want[kernel] = got if forwards is None else per * forwards
        want["avg_pool"] += RN_POOLS * want[kernel] // per
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def rn_bf16(engine) -> bool:
    """Whether the engine's image tower is a bf16 ResNet (conv_bf16 in
    every convolution)."""
    return not engine.clip_cfg.is_vit and engine.compute_dtype == torch.bfloat16


def rn_fp32(engine) -> bool:
    """Whether the engine's image tower is an fp32 ResNet (conv_fp32 in
    every convolution)."""
    return not engine.clip_cfg.is_vit and engine.compute_dtype == torch.float32


# (tower, path): the engine make_engine must build — (precision, fused bf16
# blocks, int8 weights, compute dtype) — and the kernels its scoring launches
# in each layer of the image tower (PATH_KERNELS)
ENGINES = {
    ("vit", "bf16"): (("bf16", True, False, torch.bfloat16), "bf16"),
    ("vit", "int8"): (("int8", False, True, torch.bfloat16), "int8"),
    ("vit", "fp32"): (("bf16", False, False, torch.float32), "fp32"),
    # a ResNet tower's layers launch no block kernel (a bf16 trunk launches
    # conv_bf16 in each convolution: expect_launches' rn_forwards)
    ("rn", "bf16"): (("bf16", False, False, torch.bfloat16), "plain"),
    ("rn", "fp32"): (("bf16", False, False, torch.float32), "plain"),
}


def score_path(prec, opt_prec, params, clip_cfg, specs, bank, freq, images, card, tower="vit"):
    """make_engine under TEST.PREC ``opt_prec`` (must resolve to ``prec``),
    three staged batches, impreds.json. Returns (engine, scores, counts)."""
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.inference.pipeline import make_engine
    from leclip_tpu_torch.ops import launches
    from leclip_tpu_torch.ops.ensemble import write_impreds

    tag = f"main:{prec}" if tower == "vit" else f"{tower}50:{prec}"
    cfg = setup_config(opts=["TEST.PREC", opt_prec, "TEST.multi_scale", "(2, 3, 4)",
                             "TEST.use_freq", "True"])
    engine = make_engine(cfg, params, clip_cfg, specs, caption_bank=bank, freq_stats=freq,
                         device=DEVICE)
    want, launch_path = ENGINES[(tower, prec)]
    got = (engine.precision, engine._fused, engine._q8 is not None, engine.compute_dtype)
    if got != want:
        raise AssertionError(f"TEST.PREC {opt_prec} gave (precision, fused, q8, compute dtype) "
                             f"{got}: expected {want}, the {tag} path")
    crops = N_IMAGES * (1 + engine.n_blocks)
    warm = list(engine.run_batches_fused_staged(iter([images])))[0]  # first-call setup
    n_batches = 3
    launches.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = list(engine.run_batches_fused_staged(iter([images] * n_batches), depth=2))
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    counts = launches.launch_counts()
    log(f"[{tag}] TEST.PREC {opt_prec} -> engine precision {engine.precision}, compute "
        f"{str(engine.compute_dtype).split('.')[-1]}; {N_IMAGES} images 480x640 "
        f"-> {crops} crops per batch; scoring launches {counts} (expected: "
        f"{PATH_KERNELS[launch_path] or 'none'} in each of 12 layers x {n_batches} batches)")
    expect_launches(f"{tag} scoring", counts, launch_path, 12 * n_batches,
                    rn_forwards=n_batches if rn_bf16(engine) else 0,
                    rn32_forwards=n_batches if rn_fp32(engine) else 0, resizes=n_batches)
    fused = outs[0]
    if fused.shape != (N_IMAGES, 80) or not np.isfinite(fused).all():
        raise AssertionError(f"fused scores bad: shape {fused.shape}")
    if any(not np.array_equal(o, fused) for o in outs) or not np.allclose(warm, fused):
        raise AssertionError("repeated batches gave different scores")
    log(f"[{tag}] crop-forwards/s {n_batches * crops / score_s:.1f} ({n_batches} batches "
        f"of {crops} crops in {score_s:.3f} s, host prep staged ahead) on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "impreds.json")
        write_impreds(fused, path)
        back = np.asarray(json.load(open(path)))
    if back.shape != (N_IMAGES, 80) or not np.allclose(back, fused):
        raise AssertionError("impreds.json did not read back")
    log(f"[{tag}] impreds.json: {back.shape[0]} rows x {back.shape[1]} classes, finite, "
        f"read back; first row head {np.round(back[0, :4], 4).tolist()}")
    return engine, fused, counts


def build_members(params, clip_cfg, dtype, attention_impl="auto"):
    """Six members over the 80 COCO classes, grouped as the launcher groups
    them; their prompt features are encoded here (the prompt-feature pass)."""
    from leclip_tpu_torch.data.vocab import COCO_OBJECT_CATEGORIES
    from leclip_tpu_torch.inference.pipeline import DEFAULT_MODEL_GROUPS
    from leclip_tpu_torch.inference.tta import build_model_spec
    from leclip_tpu_torch.models.dense_clip import DenseFlags
    from leclip_tpu_torch.models.prompt import build_prompt_learner

    specs = {}
    seed = 1
    for names, evd, use_freq, n_ctx in DEFAULT_MODEL_GROUPS:
        for name in names:
            trainable, constants = build_prompt_learner(
                torch.Generator(device=DEVICE).manual_seed(seed), params,
                COCO_OBJECT_CATEGORIES, n_ctx=n_ctx or 16, dtype=dtype)
            seed += 1
            flags = DenseFlags(use_evidence=evd, attention_impl=attention_impl)
            specs[name] = build_model_spec(params, clip_cfg, trainable, constants, flags,
                                           use_freq=use_freq)
    return specs


def with_impl(specs, impl):
    """The same members (same prompt features) under another attention_impl."""
    return {n: s._replace(flags=s.flags._replace(attention_impl=impl)) for n, s in specs.items()}


def main_inputs():
    """Seeded ViT-B/16 bf16 weights, caption tokens, co-occurrence statistics
    and two 480x640 images, shared by every main path."""
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params

    clip_cfg = PRESETS["ViT-B/16"]
    params = init_clip_params(torch.Generator(device=DEVICE).manual_seed(0), clip_cfg,
                              dtype=torch.bfloat16, device=DEVICE)
    log(f"[main] ViT-B/16 bf16 params: vision {clip_cfg.vision_layers}x{clip_cfg.vision_width}, "
        f"text {clip_cfg.transformer_layers}x{clip_cfg.transformer_width}")
    rng = np.random.default_rng(0)
    toks = synthetic_captions(BANK_ROWS, rng)
    freq = {"adj": rng.random((80, 80)) * 50, "nums": rng.random(80) * 50 + 1}
    images = [rng.integers(0, 255, (480, 640, 3)).astype(np.uint8) for _ in range(N_IMAGES)]
    return clip_cfg, params, toks, freq, images


def phase_main_paths(card, inputs):
    from leclip_tpu_torch.inference.tta import TTAEngine
    from leclip_tpu_torch.models.dense_clip import DenseFlags, encode_image_features

    dev = DEVICE
    clip_cfg, params, toks, freq, images = inputs
    specs = build_members(params, clip_cfg, torch.bfloat16)
    log(f"[main] members: {[(n, int(s.trainable['ctx'].shape[0])) for n, s in specs.items()]}")

    # ---- the bf16 path, then the default path: TEST.PREC auto -> int8
    banks, engines, scores, bank_counts, score_counts = {}, {}, {}, {}, {}
    for prec, opt_prec in (("bf16", "bf16"), ("int8", "auto")):
        banks[prec], bank_counts[prec] = build_bank(prec, params, clip_cfg, toks, card)
        engines[prec], scores[prec], score_counts[prec] = score_path(
            prec, opt_prec, params, clip_cfg, specs, banks[prec], freq, images, card)

    # ---- the bf16 kernels' engine against the unfused plain path, on a small
    # input. Image features must agree to bf16 precision; the fused scores pass
    # through gated block fusion (max/min switched at a threshold), which turns
    # bf16-ulp feature differences into occasional jumps, so they are held by
    # correlation
    engine = engines["bf16"]
    small = dict(scales=(2,), caption_bank=torch.as_tensor(banks["bf16"]), crop_size=224,
                 compute_dtype=torch.bfloat16, device=dev, cooccurrence=engine.cooccurrence.cpu())
    one = [images[0]]
    k_eng = TTAEngine(params, clip_cfg, specs, bf16_fused=True, **small)
    # the plain reference stays plain: pinned to the xla route, or "auto"
    # would run the resident-attention kernel in its unfused layers
    p_eng = TTAEngine(params, clip_cfg, with_impl(specs, "xla"), bf16_fused=False, **small)
    with torch.inference_mode():
        crops_in = k_eng._crops(k_eng.stage_batch_fused(one)).flatten(0, 1)
        fk = encode_image_features(params, clip_cfg, crops_in, DenseFlags(), fused=True)
        fp = encode_image_features(params, clip_cfg, crops_in, DenseFlags(attention_impl="xla"),
                                   fused=False)
        cos_g = (fk.global_feat.float() * fp.global_feat.float()).sum(-1).min().item()
        cos_d = (fk.spatial_feats.float() * fp.spatial_feats.float()).sum(-1).min().item()
    f_k, f_p = k_eng.run_batch_fused(one), p_eng.run_batch_fused(one)
    corr = np.corrcoef(f_k.ravel(), f_p.ravel())[0, 1]
    log(f"[main:bf16] small input (1 image, {crops_in.shape[0]} crops), fused kernels vs unfused "
        f"plain path: min cosine global {cos_g:.5f}, dense {cos_d:.5f} (> 0.99); scores "
        f"corr {corr:.6f} (> 0.999), max|d| {np.abs(f_k - f_p).max():.4g}")
    if not (cos_g > 0.99 and cos_d > 0.99 and corr > 0.999 and np.isfinite(f_k).all()):
        raise AssertionError("fused engine disagrees with the plain engine")

    # ---- the int8 path against the bf16 path on the same input: the JAX
    # suite's bounds (bank rows cosine > 0.995, fused scores corr > 0.99)
    bank_cos = (banks["int8"] * banks["bf16"]).sum(-1).min()
    e8 = engines["int8"]
    with torch.inference_mode():
        crops_in = e8._crops(e8.stage_batch_fused(images)).flatten(0, 1)
        f8 = encode_image_features(e8.clip_params, clip_cfg, crops_in, DenseFlags(), q8=e8._q8)
        fb = encode_image_features(engine.clip_params, clip_cfg, crops_in, DenseFlags(),
                                   fused=True)
        cos_g = (f8.global_feat.float() * fb.global_feat.float()).sum(-1).min().item()
        cos_d = (f8.spatial_feats.float() * fb.spatial_feats.float()).sum(-1).min().item()
    corr = np.corrcoef(scores["int8"].ravel(), scores["bf16"].ravel())[0, 1]
    log(f"[main:int8] against the bf16 path, {crops_in.shape[0]} crops: image features min "
        f"cosine global {cos_g:.5f} (> 0.99), dense {cos_d:.5f}; fused scores corr {corr:.6f} "
        f"(> 0.99), max|d| {np.abs(scores['int8'] - scores['bf16']).max():.4g}; bank rows min "
        f"cosine {bank_cos:.5f} (> 0.995)")
    if not (cos_g > 0.99 and corr > 0.99 and bank_cos > 0.995):
        raise AssertionError("the int8 path disagrees with the bf16 path")
    total = {k: sum(c[p][k] for c in (bank_counts, score_counts) for p in c)
             for k in bank_counts["bf16"]}
    stages = stage_split("vit:bf16", engines["bf16"], images, card)
    keep = dict(engine=engines["int8"], params=params, clip_cfg=clip_cfg, bank=banks["int8"],
                freq=freq)
    return total, bank_counts, score_counts, stages, keep


def tower_parts(engine):
    """The engine's image tower as two timed parts: (stem, head). ViT: the
    patch embedding (patchify, class token, positions, ln_pre, pad), then
    the twelve blocks (the block kernels) with ln_post and the projection;
    ResNet: the stem and trunk (cuDNN convs), then the single-query pool and
    the dense projection. Both end in models/dense_clip.py's ImageFeatures,
    held against the engine's own ``_features``."""
    from leclip_tpu_torch.models.dense_clip import ImageFeatures, _normalize
    from leclip_tpu_torch.models.resnet import attention_pool, project_dense, resnet_features
    from leclip_tpu_torch.models.transformer import layer_norm, run_transformer
    from leclip_tpu_torch.models.vit import patchify

    cfg, v = engine.clip_cfg, engine.clip_params["visual"]
    if not cfg.is_vit:
        def head(feat):
            g, _ = attention_pool(feat, v["attnpool"], cfg.vision_heads, if_pos=False,
                                  global_only=True)
            return ImageFeatures(_normalize(g), _normalize(project_dense(feat, v["attnpool"])))

        return (lambda flat: resnet_features(flat, v)), head

    def stem(flat):
        tokens = patchify(flat, v["patch_kernel"], cfg.vision_patch_size)
        b, n, width = tokens.shape
        cls = v["class_embedding"].to(flat.dtype).expand(b, 1, width)
        tokens = torch.cat([cls, tokens], dim=1) + v["positional_embedding"][: n + 1].to(
            flat.dtype)
        tokens = layer_norm(tokens, v["ln_pre"]["scale"], v["ln_pre"]["bias"])
        return F.pad(tokens, (0, 0, 0, (-(n + 1)) % 8)), n + 1

    def head(st):
        tokens, n_real = st
        flags = next(iter(engine.models.values())).flags
        tokens = run_transformer(tokens, v["blocks"], cfg.vision_heads,
                                 impl=flags.attention_impl,
                                 kv_len=n_real if tokens.shape[1] > n_real else None,
                                 q8=engine._q8, fused=engine._fused)[:, :n_real]
        tokens = layer_norm(tokens, v["ln_post"]["scale"], v["ln_post"]["bias"])
        proj = v["proj"].to(tokens.dtype)
        return ImageFeatures(_normalize(tokens[:, 0] @ proj), _normalize(tokens[:, 1:] @ proj))

    return stem, head


STAGES = ("host staging (pad, boxes, upload)", "resize + normalise",
          "patch embedding / stem + trunk", "block kernels + head / pool + dense projection",
          "retrieval", "scoring + fusion + routing")


def stage_split(tag, engine, images, card, reps=3):
    """Per-stage times of one scored batch: the host's staging by the host
    clock (it ends in an upload and a synchronise), each device stage by
    CUDA events recorded between the engine's own steps; the median of
    ``reps`` warm batches. The staged result is held against
    ``dispatch_staged_fused``."""
    stem, head = tower_parts(engine)
    runs = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = engine.stage_batch_fused(images)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        with torch.inference_mode():
            ev[0].record()
            crops = engine._crops(staged)
            flat = crops.reshape((-1,) + crops.shape[2:])
            ev[1].record()
            mid = stem(flat)
            ev[2].record()
            feats = head(mid)
            ev[3].record()
            aug, scores = engine._retrieve(feats)
            ev[4].record()
            fused = engine._score(feats, aug, scores, staged.batch, staged.n_boxes)
            ev[5].record()
        torch.cuda.synchronize()
        runs.append([host_ms] + [ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
    ms = np.median(np.asarray(runs[1:]), axis=0)
    want = engine.dispatch_staged_fused(staged)
    torch.cuda.synchronize()
    err = (fused.float() - want.float()).abs().max().item()
    if err > 1e-5:
        raise AssertionError(f"{tag} stage split: scores differ from the engine's by {err}")
    total = float(ms.sum())
    log(f"[stages:{tag}] one batch of {flat.shape[0]} crops, median of {reps} warm batches, on "
        f"{card} (scores equal to dispatch_staged_fused's within {err:.3g}):")
    for name, t in zip(STAGES, ms):
        log(f"  {t:9.3f} ms  {100 * t / total:5.1f}%  {name}")
    log(f"  {total:9.3f} ms  in all (the staged loop overlaps the host's staging with compute)")
    return dict(zip(STAGES, (float(t) for t in ms)))


def rn_tower_flops(cfg, res=224) -> float:
    """Operations (2 per multiply-add) of one crop through the ResNet tower
    as the scoring path runs it: the 3-conv stem, every bottleneck's convs
    (1x1 and 3x3 at the block's input grid, the last 1x1 and the downsample
    after the anti-aliasing pool), the single-query pool (k, v over the
    H*W + 1 tokens, q and c_proj over one) and the dense projection
    (v_proj, c_proj at every position)."""
    w = cfg.vision_width
    h = res // 2
    f = 2 * h * h * 9 * (3 * (w // 2) + (w // 2) * (w // 2) + (w // 2) * w)
    h //= 2
    cin = w
    for i, n in enumerate(cfg.vision_layers):
        planes = w * 2 ** i
        cout = 4 * planes
        for b in range(n):
            stride = 2 if (b == 0 and i > 0) else 1
            ho = h // stride
            f += 2 * h * h * (cin * planes + 9 * planes * planes) + 2 * ho * ho * planes * cout
            if stride > 1 or cin != cout:
                f += 2 * ho * ho * cin * cout
            h, cin = ho, cout
    e, t = w * 32, h * h + 1
    f += 2 * (2 * t + 1) * e * e + 2 * e * cfg.embed_dim + 4 * t * e
    f += 2 * h * h * (e * e + e * cfg.embed_dim)
    return float(f)


# --------------------- RN50 trunk: conv_bf16 and conv_fp32 ---------------------
# each convolution of the trunk against its kernel's plain version, and the
# routes the batch witnesses compare

# of S = sum |a||w|: the least magnitude whose bf16 ulp bounds |kernel - plain|
CONV_FLOOR = 2.0 ** -8
# conv_fp32 against its plain version: |d| <= 2^-16 S. Both are fp32 sums of
# the same exact-in-fp64 products in another order: the worst case of a
# sequential sum is K 2^-24 S (2.7e-4 S at K = 4,608), its typical error
# sqrt(K) 2^-24 S (~4e-6 S)
CONV32_TOL = 2.0 ** -16
PORT_ROUTE = {torch.bfloat16: "conv_bf16", torch.float32: "conv_fp32"}


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at |v| (8 significant bits), for normal values."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126))) - 7)


def conv_routes(dtype=torch.bfloat16):
    """{route: conv2d function} for the RN50 batch witnesses of a tower in
    ``dtype``: cuDNN in that dtype for every shape (fp32 inside the tower's
    no_tf32), and the port's conv2d (its kernel, with the batch norm and the
    rest of the chain in its epilogue)."""
    from leclip_tpu_torch.models import resnet

    name = "fp32" if dtype == torch.float32 else "bf16"
    return {f"cuDNN {name}": resnet.conv2d_native, PORT_ROUTE[dtype]: resnet.conv2d}


def conv_bn_over(fn):
    """models/resnet.conv_bn with its convolution by ``fn`` and the chain
    after it as separate ops (batch norm, + residual, ReLU)."""
    from leclip_tpu_torch.models import resnet
    from leclip_tpu_torch.ops.conv_kernels import bn_chain

    def conv_bn(x, k, bn, stride=1, residual=None, relu=True):
        return bn_chain(fn(x, k, stride), *resnet.bn_affine(bn, x.dtype), residual, relu)

    return conv_bn


def plain_proj(y, p):
    """models/resnet._proj by the library's product (cuBLAS on the card) in
    y's dtype: the library route's head, which the witnesses and the TF32
    check compare the port's with."""
    return y @ p["kernel"].to(y.dtype) + p["bias"].to(y.dtype)


@contextlib.contextmanager
def conv_route(fn):
    """models/resnet.conv2d replaced by ``fn`` for the duration, conv_bn by
    the unfused chain over it and the head's products (_proj) by the
    library's (:func:`plain_proj`): the library route throughout. The
    port's own conv2d keeps the port's conv_bn (fused on the card) and _proj
    (conv_fp32 for the fp32 products on the card, the bias fused)."""
    from leclip_tpu_torch.models import resnet

    saved = resnet.conv2d, resnet.conv_bn, resnet._proj
    if fn is not saved[0]:
        resnet.conv_bn = conv_bn_over(fn)
        resnet._proj = plain_proj
    resnet.conv2d = fn
    try:
        yield
    finally:
        resnet.conv2d, resnet.conv_bn, resnet._proj = saved


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` replaced by ``fn`` for the duration (the hooks of the
    trunk checks and the witnesses)."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield saved
    finally:
        setattr(module, name, saved)


def conv_work(x_shape, k_shape, stride, elem=2):
    """(operations, bytes) of one convolution: 2 per multiply-add over
    K = kh*kw*Cin; input, weight and output each moved once, ``elem`` bytes
    an element (2 bf16, 4 fp32)."""
    b, h, w, cin = x_shape
    cout, _, kh, kw = k_shape
    m = b * -(-h // stride) * -(-w // stride)
    return 2.0 * m * cout * kh * kw * cin, elem * (b * h * w * cin + cout * kh * kw * cin
                                                   + m * cout)


def conv_name(x, k, stride):
    kh = k.shape[-1]
    return f"{kh}x{kh}/{stride} {x.shape[1]}x{x.shape[2]}x{x.shape[3]}->{k.shape[0]}"


def trunk_conv_check(vis, flat, card, reps=3, time_it=True, heads=32):
    """The trunk over ``flat`` crops (bf16 or fp32, the tower's dtype) with
    each of its 55 convolution-with-batch-norm calls (models/resnet.conv_bn)
    hooked, each held on its own input:

    bf16: conv_bf16 with the epilogue off against conv_bf16_plain within 1
    bf16 ulp of max(|plain|, CONV_FLOOR * S), S = sum |a||w| the element's own
    scale (the two round the same exact bf16 products and differ only in the
    order of an fp32 sum, whose error is a few fp32 ulps of S; where the
    products cancel, |plain| is far below S and its own ulp below that
    error). fp32: conv_fp32 with the epilogue off against conv_fp32_plain
    within CONV32_TOL * S. Both: the port's fused call (batch norm,
    residual, ReLU in the epilogue) equal to the unfused chain over the bare
    kernel's output (torch.equal). fp32, then the head (the global pool and
    the dense projection) over the trunk map with each of its 6 fp32
    products (models/resnet._proj) hooked: conv_fp32 as a 1x1 convolution
    (conv_kernels.matmul_fp32) against ``y @ w`` with TF32 off within
    CONV32_TOL * S, and with its bias in the epilogue equal to the product
    + bias (torch.equal). Reports the share of elements exactly equal; with
    ``time_it``, times per call the kernel (epilogue off), its plain version
    and cuDNN in the same dtype (conv2d_native, the library call), the fused
    call and cuDNN followed by the unfused chain, in fp32 each product bare
    and with its bias beside cuBLAS's (+ the bias). Each call's bound is that
    of the bare convolution, and of the fused one (its residual read too).
    Returns {rows, totals, products}."""
    from leclip_tpu_torch.device import no_tf32
    from leclip_tpu_torch.models import resnet
    from leclip_tpu_torch.ops import conv_kernels as ck

    dtype = flat.dtype
    bf16 = dtype == torch.bfloat16
    kernel = PORT_ROUTE[dtype]
    rows = []
    port_conv_bn = resnet.conv_bn

    bare, plain_fn = ((ck.conv_bf16, ck.conv_bf16_plain) if bf16
                      else (ck.conv_fp32, ck.conv_fp32_plain))

    def recording(x, k, bn, stride=1, residual=None, relu=True):
        scale, offset = resnet.bn_affine(bn, dtype)
        with no_tf32():
            s_abs = ck.conv_library(x.float().abs(), k.float().abs(), stride)
        row = dict(name=conv_name(x, k, stride))
        fused = port_conv_bn(x, k, bn, stride, residual, relu)
        out = bare(x, k, stride)
        plain = plain_fn(x, k, stride)
        row["fused_equal"] = torch.equal(fused, ck.bn_chain(out, scale, offset, residual, relu))
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{kernel}: non-finite output")
        p = plain.float()
        d = (out.float() - p).abs()
        if bf16:
            tol = bf16_ulp(torch.maximum(p.abs(), CONV_FLOOR * s_abs))
            row["worst"] = (d / tol).max().item()
            row["own_ulp"] = (d <= bf16_ulp(p)).float().mean().item()
        else:
            tol = CONV32_TOL * s_abs
            row["worst"] = 0.0 if not (d > 0).any() else (d / tol.clamp(min=1e-38)).max().item()
        row.update(exact=(d == 0).float().mean().item(), max_abs=d.max().item())
        del plain, p, d, tol, s_abs
        elem = 2 if bf16 else 4
        flops, nbytes = conv_work(tuple(x.shape), tuple(k.shape), stride, elem)
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
        row["bound_ms"] = max(flops / peak, nbytes / PEAK_BYTES) * 1e3
        row["bound_by"] = "operations" if flops / peak >= nbytes / PEAK_BYTES else "bytes"
        fused_bytes = nbytes + (elem * residual.numel() if residual is not None else 0)
        row["fused_bound_ms"] = max(flops / peak, fused_bytes / PEAK_BYTES) * 1e3
        if time_it:
            with no_tf32():
                row["ms"] = cuda_ms(lambda: bare(x, k, stride), reps)
                row["plain_ms"] = cuda_ms(lambda: plain_fn(x, k, stride), reps)
                row["fused_ms"] = cuda_ms(
                    lambda: port_conv_bn(x, k, bn, stride, residual, relu), reps)
                row["fused_library_ms"] = cuda_ms(lambda: ck.bn_chain(
                    resnet.conv2d_native(x, k, stride), scale, offset, residual, relu), reps)
                row["library_ms"] = cuda_ms(lambda: resnet.conv2d_native(x, k, stride), reps)
        rows.append(row)
        if row["worst"] > 1:
            raise AssertionError(f"{kernel} disagrees with its plain version at {row['name']}: "
                                 f"{row['worst']:.3g} of its tolerance")
        if not row["fused_equal"]:
            raise AssertionError(f"{kernel}'s fused epilogue differs from the unfused chain at "
                                 f"{row['name']}")
        del out
        return fused

    products = []
    port_proj = resnet._proj

    def product(y, p):
        w, bias = p["kernel"].to(y.dtype), p["bias"].to(y.dtype)
        out = ck.matmul_fp32(y, w)
        fused = ck.matmul_fp32(y, w, bias)
        plain = ck.matmul_fp32_plain(y, w)
        s_abs = ck.matmul_fp32_plain(y.abs(), w.abs())
        torch.cuda.synchronize()
        d = (out - plain).abs()
        rows_, (k_, n_) = y.shape[:-1].numel(), w.shape
        flops, nbytes = 2.0 * rows_ * k_ * n_, 4.0 * (rows_ * k_ + k_ * n_ + rows_ * n_ + n_)
        row = dict(name=f"product {k_}->{n_} at {rows_} rows",
                   worst=0.0 if not (d > 0).any()
                   else (d / (CONV32_TOL * s_abs).clamp(min=1e-38)).max().item(),
                   exact=(d == 0).float().mean().item(), max_abs=d.max().item(),
                   finite=bool(torch.isfinite(out).all()),
                   fused_equal=torch.equal(fused, out + bias),
                   bound_ms=max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3)
        if time_it:
            row["ms"] = cuda_ms(lambda: ck.matmul_fp32(y, w), reps)
            row["plain_ms"] = cuda_ms(lambda: ck.matmul_fp32_plain(y, w), reps)
            row["fused_ms"] = cuda_ms(lambda: ck.matmul_fp32(y, w, bias), reps)
            row["fused_library_ms"] = cuda_ms(lambda: ck.matmul_fp32_plain(y, w, bias), reps)
        products.append(row)
        if not row["finite"] or row["worst"] > 1:
            raise AssertionError(f"conv_fp32 disagrees with y @ w at the {row['name']}: "
                                 f"{row['worst']:.3g} of its tolerance")
        if not row["fused_equal"]:
            raise AssertionError(f"conv_fp32's fused bias differs from the product + bias at the "
                                 f"{row['name']}")
        del out, fused, plain, s_abs, d
        return port_proj(y, p)

    with patched(resnet, "conv_bn", recording), torch.inference_mode():
        feat = resnet.resnet_features(flat, vis)
    if not bf16:
        with patched(resnet, "_proj", product), torch.inference_mode():
            resnet.attention_pool(feat, vis["attnpool"], heads, if_pos=False, global_only=True)
            resnet.project_dense(feat, vis["attnpool"])
        if len(products) != POOL_PRODUCTS["dense"]:
            raise AssertionError(f"the fp32 head ran {len(products)} products, expected "
                                 f"{POOL_PRODUCTS['dense']}")
    del feat
    keys = ("bound_ms", "fused_bound_ms")
    if time_it:
        keys += ("ms", "plain_ms", "library_ms", "fused_ms", "fused_library_ms")
    totals = {k: float(sum(r[k] for r in rows)) for k in keys}
    by = {b: sum(r["bound_ms"] for r in rows if r["bound_by"] == b)
          for b in ("bytes", "operations")}
    totals["bound_by"] = max(by, key=by.get)  # what bounds most of the summed bound
    totals["max_abs_err"] = max(r["max_abs"] for r in rows)
    totals["worst"] = max(r["worst"] for r in rows)
    totals["exact"] = float(np.mean([r["exact"] for r in rows]))
    tol_text = ("1 bf16 ulp of max(|plain|, 2^-8 S), S = sum|a||w|; reason: the same bf16 "
                "products, fp32 sums in another order" if bf16 else
                "2^-16 S, S = sum|a||w|; reason: fp32 sums of the same products in another "
                "order, worst case K 2^-24 S")
    log(f"[{kernel}] {len(rows)} trunk convolutions on {flat.shape[0]} crops, each against its "
        f"plain version on its input (tolerance: {tol_text}): worst {totals['worst']:.3g} of "
        f"the tolerance, max|d| {totals['max_abs_err']:.4g}; share exactly equal "
        f"{min(r['exact'] for r in rows):.6f}..{max(r['exact'] for r in rows):.6f}"
        + (f", within 1 ulp of |plain| itself {min(r['own_ulp'] for r in rows):.8f}.."
           f"{max(r['own_ulp'] for r in rows):.8f}" if bf16 else "")
        + f"; fused epilogue equal to the unfused chain at all {len(rows)} calls on {card}")
    for r in rows:
        log(f"  {r['name']:>26}: worst {r['worst']:.3g}, exact {r['exact']:.6f}"
            + (f", own-ulp {r['own_ulp']:.8f}" if bf16 else "")
            + (f"; {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, cuDNN {r['library_ms']:.3f}, "
               f"bound {r['bound_ms']:.3f} by {r['bound_by']}); fused {r['fused_ms']:.3f} "
               f"(cuDNN + unfused chain {r['fused_library_ms']:.3f}, bound "
               f"{r['fused_bound_ms']:.3f})" if time_it else ""))
    if time_it:
        log(f"[{kernel}] the trunk's convolutions in all: {totals['ms']:.3f} ms (plain "
            f"{totals['plain_ms']:.3f}, cuDNN {totals['library_ms']:.3f}, bound "
            f"{totals['bound_ms']:.3f}); the fused calls {totals['fused_ms']:.3f} ms (cuDNN + "
            f"the unfused chain {totals['fused_library_ms']:.3f}, bound "
            f"{totals['fused_bound_ms']:.3f}) on {card}")
    for r in products:
        log(f"  {r['name']:>32}: conv_fp32 1x1 against y @ w (TF32 off; tolerance 2^-16 S, "
            f"S = |y| @ |w|): worst {r['worst']:.3g}, exact {r['exact']:.6f}, max|d| "
            f"{r['max_abs']:.4g}, with the bias fused equal to the product + bias"
            + (f"; {r['ms']:.3f} ms (cuBLAS fp32 {r['plain_ms']:.3f}, bound {r['bound_ms']:.3f}); "
               f"with the bias {r['fused_ms']:.3f} (cuBLAS + the bias {r['fused_library_ms']:.3f})"
               if time_it else "") + f" on {card}")
    if products:
        totals["products"] = {"calls": len(products),
                              "worst": max(r["worst"] for r in products),
                              "max_abs_err": max(r["max_abs"] for r in products),
                              "bound_ms": float(sum(r["bound_ms"] for r in products)),
                              **({k: float(sum(r[k] for r in products))
                                  for k in ("ms", "plain_ms", "fused_ms", "fused_library_ms")}
                                 if time_it else {})}
    return dict(rows=rows, totals=totals, products=products)


def conv_fp32_tile_witness(vis, crops, card):
    """conv_fp32's tile follows M, and every tile sums an element in the same
    order: three calls of the RN50 fp32 tower at ``crops`` crops and at a
    few, whose tiles differ (layer1's 3x3 64->64 at 56x56 with its batch
    norm, a residual and the ReLU; layer4's last 3x3 512->512 at 7x7 with
    its batch norm and ReLU; the pool's v product 2048->2048 at 50 rows a
    crop with its bias), each on seeded random inputs; the shared crops'
    outputs must be bit for bit the same. Returns {call: {tiles, equal}}."""
    from leclip_tpu_torch.device import tree_map
    from leclip_tpu_torch.models import resnet
    from leclip_tpu_torch.ops import conv_kernels as ck

    gen = torch.Generator(device=DEVICE).manual_seed(16)
    l1, l4 = vis["layer1"]["block0"], tree_map(lambda t: t[-1], vis["layer4"]["rest"])
    v = vis["attnpool"]["v_proj"]
    # label: (an input's shape a crop, the output's, crops run alone, the call)
    calls = {
        "layer1 3x3 56x56x64->64 + bn + residual + relu": (
            (56, 56, 64), (56, 56, 64), 3,
            lambda x, r: resnet.conv_bn(x, l1["conv2"], l1["bn2"], 1, r, True)),
        "layer4 3x3 7x7x512->512 + bn + relu": (
            (7, 7, 512), (7, 7, 512), 1,
            lambda x, r: resnet.conv_bn(x, l4["conv2"], l4["bn2"])),
        "product 2048->2048 + bias, 50 rows a crop": (
            (50, 2048), (50, 2048), 5, lambda y, r: ck.matmul_fp32(y, v["kernel"], v["bias"])),
    }
    out = {}
    with torch.inference_mode():
        for label, (shape, out_shape, few, fn) in calls.items():
            x = torch.randn((crops,) + shape, generator=gen, device=DEVICE)
            r = torch.randn((crops,) + out_shape, generator=gen, device=DEVICE)
            full, part = fn(x, r), fn(x[:few], r[:few])
            rows = math.prod(out_shape[:-1])
            tiles = {n: ck.conv_fp32_tile(n * rows, out_shape[-1]) for n in (crops, few)}
            torch.cuda.synchronize()
            same = torch.equal(part, full[:few])
            out[label] = {"tiles": {n: f"{t[0]}x{t[1]}" for n, t in tiles.items()},
                          "equal": same}
            log(f"[conv_fp32:tile] {label}: {crops} crops on tile {out[label]['tiles'][crops]}, "
                f"the first {few} alone on {out[label]['tiles'][few]}: the shared crops bit for "
                f"bit the same: {same} on {card}")
            if tiles[crops] == tiles[few] or not same:
                raise AssertionError(f"conv_fp32's tile witness failed at {label}: {out[label]}")
            del x, r, full, part
    return out


def randomize_bn(tree, gen):
    """Every batch norm of a ResNet tree with random running statistics and
    affine (seeded): the JAX init zeroes each bn3 scale, which would leave
    every residual branch out of the bf16 / fp32 comparison."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            def u(lo, hi, like):
                r = torch.rand(like.shape, generator=gen, device=like.device)
                return (lo + (hi - lo) * r).to(like.dtype)

            def n(std, like):
                return (torch.randn(like.shape, generator=gen, device=like.device) * std
                        ).to(like.dtype)

            return {"scale": u(0.5, 1.0, tree["scale"]), "bias": n(0.1, tree["bias"]),
                    "mean": n(0.1, tree["mean"]), "var": u(0.5, 1.5, tree["var"])}
        return {k: randomize_bn(v, gen) for k, v in tree.items()}
    return tree


def phase_rn50(card, inputs):
    """The RN50 scoring path, as every shipped recipe runs it: full RN50
    geometry ((3, 4, 6, 3) bottlenecks at width 64, embed 1024, 32 pool
    heads; text 12x512), seeded random bf16 weights with random BN
    statistics. TEST.PREC auto (→ bf16 for a ResNet tower): the 8,192-row
    bf16 caption bank through the block kernels, six members, make_engine,
    three staged batches and run_full_inference over PNG files →
    impreds.json; the image tower launches conv_bf16 in each of its 55
    convolution-with-batch-norm calls (the chain fused in its epilogue).
    Then TEST.PREC fp32 on the same weights widened (the fp32 bank, plain),
    its tower launching conv_fp32 in each of the 55. bf16 held against fp32;
    the fp32 tower held to full fp32 with TF32 switched on around the call;
    each kernel held against its plain version at every trunk shape and
    timed beside cuDNN in its dtype (trunk_conv_check); each precision's
    batch split into stages on its port route and on the routes it is
    compared with."""
    from PIL import Image

    from leclip_tpu_torch.device import cast_floating
    from leclip_tpu_torch.inference.pipeline import run_full_inference
    from leclip_tpu_torch.models import resnet
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
    from leclip_tpu_torch.models.dense_clip import DenseFlags, encode_image_features

    _, _, toks, freq, images = inputs
    cfg = PRESETS["RN50"]
    gen = torch.Generator(device=DEVICE).manual_seed(50)
    params = init_clip_params(gen, cfg, dtype=torch.bfloat16, device=DEVICE)
    params["visual"] = randomize_bn(params["visual"], gen)
    crops = N_IMAGES * 305
    flops = rn_tower_flops(cfg) * crops
    log(f"[rn50] RN50 bf16 params: vision {cfg.vision_layers} bottlenecks at width "
        f"{cfg.vision_width}, embed {cfg.embed_dim}, {cfg.vision_heads} pool heads; text "
        f"{cfg.transformer_layers}x{cfg.transformer_width}; BN statistics random. Tower "
        f"operations {rn_tower_flops(cfg) / 1e9:.3f} GFLOP a crop, {flops / 1e12:.3f} TFLOP a "
        f"{crops}-crop batch: bound {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms in bf16, "
        f"{flops / PEAK_FP32_FLOPS * 1e3:.3f} ms in fp32 (operations at peak)")

    out = {}
    for prec in ("bf16", "fp32"):
        dt = torch.bfloat16 if prec == "bf16" else torch.float32
        p = params if prec == "bf16" else cast_floating(params, torch.float32)
        specs = build_members(p, cfg, dt)
        bank, bank_counts = build_bank(prec, p, cfg, toks, card, label="rn50")
        engine, fused, counts = score_path(prec, "auto" if prec == "bf16" else "fp32", p, cfg,
                                           specs, bank, freq, images, card, tower="rn")
        out[prec] = dict(params=p, engine=engine, fused=fused, bank=bank,
                         bank_counts=bank_counts, counts=counts)

    # run_full_inference, the CLI's own loop, on the bf16 engine
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"img{i}.png") for i in range(len(images))]
        for path, im in zip(paths, images):
            Image.fromarray(im).save(path)
        out_json = os.path.join(tmp, "impreds.json")
        full = run_full_inference(out["bf16"]["engine"], paths, batch_size=N_IMAGES,
                                  out_json=out_json, progress=False)
        back = np.asarray(json.load(open(out_json)))
    if not (np.allclose(full, out["bf16"]["fused"], rtol=0, atol=1e-6)
            and np.allclose(back, full) and back.shape == (N_IMAGES, 80)):
        raise AssertionError("rn50: run_full_inference disagrees with the staged batches")
    log(f"[rn50:bf16] run_full_inference over {len(paths)} PNG files -> impreds.json "
        f"{back.shape}, equal to the staged batches")

    # bf16 against fp32: each path's own crops and tower, then the scores
    feats, flats = {}, {}
    with torch.inference_mode():
        for prec in ("bf16", "fp32"):
            e = out[prec]["engine"]
            flat = flats[prec] = e._crops(e.stage_batch_fused(images)).flatten(0, 1)
            feats[prec] = e._features(flat)
    cos_g = (feats["bf16"].global_feat.float() * feats["fp32"].global_feat.float()
             ).sum(-1).min().item()
    cos_d = (feats["bf16"].spatial_feats.float() * feats["fp32"].spatial_feats.float()
             ).sum(-1).min().item()
    s16, s32 = out["bf16"]["fused"], out["fp32"]["fused"]
    corr = float(np.corrcoef(s16.ravel(), s32.ravel())[0, 1])
    bank_cos = float((out["bf16"]["bank"] * out["fp32"]["bank"]).sum(-1).min())
    log(f"[rn50] bf16 path against fp32, {flat.shape[0]} crops: image features min cosine "
        f"global {cos_g:.5f}, dense {cos_d:.5f} (> 0.99); fused scores corr {corr:.6f} "
        f"(> 0.999), max|d| {np.abs(s16 - s32).max():.4g}; bank rows min cosine {bank_cos:.5f}")
    if not (cos_g > 0.99 and cos_d > 0.99 and corr > 0.999):
        raise AssertionError("rn50: the bf16 path disagrees with the fp32 path")

    # the fp32 tower runs in full fp32 whatever the caller's TF32 setting: the
    # port's trunk (conv_fp32) and features with TF32 switched on around the
    # call against cuDNN fp32 under cudnn.flags(allow_tf32=False); the port's
    # trunk with its own no_tf32 guard lifted as well, which conv_fp32 must
    # not notice (bitwise), and cuDNN's with the guard lifted: what TF32 gives
    p32 = out["fp32"]["params"]
    x = flat[:64].float()
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with torch.inference_mode():
            got = resnet.resnet_features(x, p32["visual"])
            g_got = encode_image_features(p32, cfg, x, DenseFlags()).global_feat
            with patched(resnet, "_no_tf32", contextlib.nullcontext):
                lifted = resnet.resnet_features(x, p32["visual"])
                with conv_route(resnet.conv2d_native):
                    tf32 = resnet.resnet_features(x, p32["visual"])
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), torch.inference_mode(), \
                conv_route(resnet.conv2d_native):
            torch.backends.cuda.matmul.allow_tf32 = False
            want = resnet.resnet_features(x, p32["visual"])
            g_want = encode_image_features(p32, cfg, x, DenseFlags()).global_feat
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    scale = want.abs().max().item()
    d_port = max((got - want).abs().max().item() / scale,
                 (g_got - g_want).abs().max().item())
    d_tf32 = (tf32 - want).abs().max().item() / scale
    log(f"[rn50:fp32] with TF32 switched on around the call, {x.shape[0]} crops: the port's "
        f"fp32 trunk map (conv_fp32) and features against cuDNN fp32 under "
        f"cudnn.flags(allow_tf32=False): {d_port:.3g} (<= 1e-4, of max|map| {scale:.4g}); the "
        f"port's trunk with its no_tf32 guard lifted bitwise the same: "
        f"{torch.equal(lifted, got)}; cuDNN's trunk with the guard lifted (TF32): {d_tf32:.3g}")
    if d_port > 1e-4 or not torch.equal(lifted, got):
        raise AssertionError("rn50: the fp32 tower ran in TF32")
    # each kernel against its plain version at each of the 55 trunk shapes, on
    # the engine's own crops, timed per convolution beside cuDNN in its dtype
    conv = trunk_conv_check(out["bf16"]["engine"].clip_params["visual"], flats["bf16"], card)
    torch.cuda.empty_cache()
    conv32 = trunk_conv_check(out["fp32"]["engine"].clip_params["visual"], flats["fp32"], card,
                              heads=cfg.vision_heads)
    conv32["tile_witness"] = conv_fp32_tile_witness(out["fp32"]["engine"].clip_params["visual"],
                                                    flats["fp32"].shape[0], card)
    torch.cuda.empty_cache()
    # the batch split into stages on the port's routes, then on the routes it
    # is compared with: its kernel with the chain unfused (the route before
    # the fused epilogue), cuDNN throughout
    stages, before = {}, {"bf16": {}, "fp32": {}}
    trunk = STAGES[2]
    for prec in ("bf16", "fp32"):
        eng = out[prec]["engine"]
        port = PORT_ROUTE[eng.compute_dtype]
        stages[prec] = stage_split(f"rn50:{prec}", eng, images, card)
        routes = {r: fn for r, fn in conv_routes(eng.compute_dtype).items() if r != port}
        from leclip_tpu_torch.ops import conv_kernels
        bare = getattr(conv_kernels, port)
        routes = {f"{port} unfused": lambda x_, k_, s_=1, f_=bare: f_(x_, k_, s_), **routes}
        for route, fn in routes.items():
            with conv_route(fn):
                before[prec][route] = stage_split(f"rn50:{prec} {route}", eng, images, card)
        mine = stages[prec]
        log(f"[rn50:{prec}] trunk (stem + trunk stage) {mine[trunk]:.3f} ms on {port}, "
            + ", ".join(f"{mine[trunk] / b[trunk]:.3f}x of {b[trunk]:.3f} ms on {r}"
                        for r, b in before[prec].items())
            + f"; the batch {sum(mine.values()):.3f} ms against "
            + ", ".join(f"{sum(b.values()):.3f} ms ({r})" for r, b in before[prec].items())
            + f" on {card}")
    keep = dict(engine=out["bf16"]["engine"], engine_fp32=out["fp32"]["engine"], params=params,
                clip_cfg=cfg, bank=out["bf16"]["bank"], freq=freq)
    return ({k: out["bf16"]["bank_counts"][k] + out["bf16"]["counts"][k]
             for k in out["bf16"]["counts"]}, out["bf16"]["bank_counts"], stages, keep,
            dict(conv, counts=out["bf16"]["counts"], trunk_ms=stages["bf16"][trunk],
                 batch_ms=sum(stages["bf16"].values()),
                 trunk_before_ms={r: b[trunk] for r, b in before["bf16"].items()}),
            dict(conv32, counts=out["fp32"]["counts"], trunk_ms=stages["fp32"][trunk],
                 batch_ms=sum(stages["fp32"].values()),
                 trunk_before_ms={r: b[trunk] for r, b in before["fp32"].items()}))


def phase_unfused_paths(card, inputs):
    """(a) TEST.PREC fp32 — the reference-parity precision — on the same
    weights widened to fp32: fp32 caption bank (the bank CLI's default) and
    prompt features, make_engine, three batches; resident_attention must run
    in every image-tower layer and no other kernel anywhere. (b) the same
    engine with DenseFlags(attention_impl="pallas"): prompt features and one
    batch, flash_attention in every layer of both towers. Both against an
    attention_impl="xla" plain fp32 engine on a small input."""
    from leclip_tpu_torch.device import cast_floating
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.inference.pipeline import DEFAULT_MODEL_GROUPS, make_engine
    from leclip_tpu_torch.inference.tta import TTAEngine
    from leclip_tpu_torch.models.dense_clip import DenseFlags, encode_image_features
    from leclip_tpu_torch.ops import launches

    clip_cfg, params16, toks, freq, images = inputs
    params = cast_floating(params16, torch.float32)
    specs = build_members(params, clip_cfg, torch.float32)
    bank, bank_counts = build_bank("fp32", params, clip_cfg, toks, card)
    engine, fused_a, counts_a = score_path("fp32", "fp32", params, clip_cfg, specs, bank, freq,
                                           images, card)
    # run_full_inference, the CLI's own loop, on the same images written as PNG (lossless)
    from PIL import Image

    from leclip_tpu_torch.inference.pipeline import run_full_inference

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"img{i}.png") for i in range(len(images))]
        for p, im in zip(paths, images):
            Image.fromarray(im).save(p)
        out_json = os.path.join(tmp, "impreds.json")
        full = run_full_inference(engine, paths, batch_size=N_IMAGES, out_json=out_json,
                                  progress=False)
        back = np.asarray(json.load(open(out_json)))
    if not (np.allclose(full, fused_a, rtol=0, atol=1e-6) and np.allclose(back, full)):
        raise AssertionError("run_full_inference disagrees with the staged batches")
    log(f"[main:fp32] run_full_inference over {len(paths)} PNG files -> impreds.json "
        f"{back.shape}, equal to the staged batches")

    # ---- (b): flash attention in the prompt pass and the image tower
    cfg = setup_config(opts=["TEST.PREC", "fp32", "TEST.multi_scale", "(2, 3, 4)",
                             "TEST.use_freq", "True"])
    launches.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    specs_b = build_members(params, clip_cfg, torch.float32, attention_impl="pallas")
    engine_b = make_engine(cfg, params, clip_cfg, specs_b, caption_bank=bank, freq_stats=freq,
                           device=DEVICE)
    fused_b = list(engine_b.run_batches_fused_staged(iter([images])))[0]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts_b = launches.launch_counts()
    text_passes = sum(len(names) * (3 if evd else 2) for names, evd, _, _ in DEFAULT_MODEL_GROUPS)
    log(f"[main:pallas] prompt features of {len(specs_b)} members ({text_passes} text passes) + "
        f"one batch of {N_IMAGES * (1 + engine_b.n_blocks)} crops in {run_s:.3f} s; launches "
        f"{counts_b} (12 layers x ({text_passes} text passes + 1 image tower))")
    expect_launches("pallas prompt features + scoring", counts_b, "pallas", 12 * (text_passes + 1),
                    resizes=1)
    if fused_b.shape != (N_IMAGES, 80) or not np.isfinite(fused_b).all():
        raise AssertionError(f"pallas path: fused scores bad, shape {fused_b.shape}")
    crops = N_IMAGES * (1 + engine_b.n_blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = list(engine_b.run_batches_fused_staged(iter([images] * 3), depth=2))
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    if any(not np.array_equal(o, fused_b) for o in again):
        raise AssertionError("pallas path: repeated batches gave different scores")
    log(f"[main:pallas] crop-forwards/s {3 * crops / score_s:.1f} (3 batches of {crops} crops in "
        f"{score_s:.3f} s, host prep staged ahead) on {card}")

    # ---- agreement on a small input against the plain fp32 engine (same
    # members, attention_impl="xla"): image features, then fused scores
    small = dict(scales=(2,), caption_bank=torch.as_tensor(bank),
                 crop_size=clip_cfg.image_resolution, compute_dtype=torch.float32, device=DEVICE,
                 cooccurrence=engine.cooccurrence.cpu())
    one = [images[0]]
    e_x = TTAEngine(params, clip_cfg, with_impl(specs, "xla"), **small)
    e_a = TTAEngine(params, clip_cfg, specs, **small)
    e_b = TTAEngine(params, clip_cfg, specs_b, **small)
    feats, f_counts = {}, {}
    with torch.inference_mode():
        crops_in = e_x._crops(e_x.stage_batch_fused(one)).flatten(0, 1)
        for impl in ("xla", "auto", "pallas"):
            launches.reset_launch_counts()
            feats[impl] = encode_image_features(params, clip_cfg, crops_in,
                                                DenseFlags(attention_impl=impl))
            f_counts[impl] = {k: n for k, n in launches.launch_counts().items() if n}
    if f_counts != {"xla": {}, "auto": {"resident_attention": 12},
                    "pallas": {"flash_attention": 12}}:
        raise AssertionError(f"small-input towers took the wrong routes: {f_counts}")
    f_err = {impl: max((getattr(feats[impl], a) - getattr(feats["xla"], a)).abs().max().item()
                       for a in ("global_feat", "spatial_feats")) for impl in ("auto", "pallas")}
    s_x, s_a, s_b = (e.run_batch_fused(one) for e in (e_x, e_a, e_b))
    d_a = float(np.abs(s_a - s_x).max())
    d_b = float(np.abs(s_b - s_x).max())
    corr_b = float(np.corrcoef(s_b.ravel(), s_a.ravel())[0, 1])
    log(f"[main:fp32] small input (1 image, {crops_in.shape[0]} crops) against the xla plain "
        f"fp32 engine (tower launches {f_counts}): image features max|d| resident "
        f"{f_err['auto']:.3g}, flash "
        f"{f_err['pallas']:.3g}; fused scores max|d| (a) resident {d_a:.3g} (<= 1e-4), (b) "
        f"flash with flash prompt features {d_b:.3g} (<= 1e-4); corr (b) vs (a) {corr_b:.7f} (>= 0.9999)")
    if not (d_a <= 1e-4 and d_b <= 1e-4 and corr_b >= 0.9999 and np.isfinite(s_b).all()):
        raise AssertionError("the unfused kernels' engines disagree with the plain fp32 engine")
    return {"resident_attention": counts_a["resident_attention"],
            "flash_attention": counts_b["flash_attention"]}, bank_counts, counts_a, counts_b


# library: (the instructions its SASS must hold, those it must not)
SASS_KERNELS = {
    "attn_block_bf16": (("HGMMA", "UTMALDG"), ()),  # built on gemm_sm90.cuh: wgmma fed by TMA
    "mlp_bf16": (("HGMMA", "UTMALDG"), ()),
    # int8 QKV on gemm_int8.cuh (integer wgmma: IGMMA), bf16 out-proj on gemm_sm90.cuh
    "attn_block_int8": (("IGMMA", "HGMMA", "UTMALDG"), ("IMMA",)),
    "mlp_int8": (("IGMMA", "UTMALDG"), ("IMMA",)),  # every product on the int8 wgmma GEMM
    "flash_attention": (("HMMA",), ()),             # bf16 flash on the tensor cores (mma.sync)
    # wgmma on stages gathered by cp.async (LDGSTS), the weights by TMA
    "conv_bf16": (("HGMMA", "UTMALDG", "LDGSTS"), ()),
    # fp32 FMA chains on the CUDA cores, stages filled by cp.async (LDGSTS):
    # no tensor-core (TF32) product
    "conv_fp32": (("FFMA", "LDGSTS"), ("HMMA", "HGMMA")),
}
SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA", "UTMALDG", "UTMASTG", "LDGSTS", "FFMA", "CALL")
# (library, kernel): the most subroutine calls the kernel's SASS may hold.
# ln_quant_rows divides only per row: the LN's two means, the row's scale
# and its correctly rounded reciprocal, each with a slow path ptxas may
# call; a division per element would add one for each of a lane's 32
# elements (the loops are unrolled)
SASS_CALL_LIMITS = {("ln_quant", "ln_quant_rows"): 4}


def check_sass(build):
    """The products went through the tensor cores: wgmma (HGMMA bf16, IGMMA
    int8) fed by TMA (UTMALDG) in the Hopper GEMMs' libraries, with no
    mma.sync int8 product (IMMA) left in the int8 blocks, and mma.sync (HMMA)
    in bf16 flash_attention; count each in the library's SASS (cuobjdump)."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    for (k, fn), limit in SASS_CALL_LIMITS.items():
        sass = subprocess.run([cuobjdump, "--dump-sass", str(build._lib_path(k))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        funcs = {part.split("\n", 1)[0].strip(): part for part in sass.split("Function : ")[1:]}
        calls = [len(re.findall(r"\bCALL\b", f)) for name, f in funcs.items() if fn in name]
        log(f"[device] SASS {k}: CALLs in each instance of {fn} {calls} (at most {limit}: no "
            "division slow path per element)")
        if not calls or max(calls) > limit:
            raise AssertionError(f"{k}: {fn} missing from its SASS, or a division per element")
    for k, (need, banned) in SASS_KERNELS.items():
        sass = subprocess.run([cuobjdump, "--dump-sass", str(build._lib_path(k))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        n = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
        log(f"[device] SASS {k}: {n}")
        if not all(n[op] for op in need):
            raise AssertionError(f"{k}: no {' / '.join(need)} in its SASS")
        if any(n[op] for op in banned):
            raise AssertionError(f"{k}: {' / '.join(banned)} in its SASS")


def phase_launch_times(card):
    """Device time and rate of every launch inside the four block kernels at
    the ViT shape, by torch.profiler (scripts/probe_port_kernels.py).
    Returns {block kernel: {launch: ms}}."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "probe_port_kernels.py")
    spec = importlib.util.spec_from_file_location("probe_port_kernels", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    res = {}
    log(f"[launches] per launch at the ViT shape {list(probe.SHAPES['vit'][:3])} on {card}:")
    for name, rows in probe.launch_times("vit", 5).items():
        log(f"  {name}: {sum(r[1] for r in rows):.4f} ms of device time per call")
        for short, ms, rate, unit in rows:
            log(f"    {ms:.4f} ms  {short}" + (f"  {rate:.1f} {unit}" if rate is not None else ""))
        res[name] = {short: ms for short, ms, _, _ in rows}
    return res


# --------------------------- crop + resize ------------------------------------

# the scoring cells' batches: 8 images, 305 crops each, in the engine's bucket
RESIZE_SHAPES = {  # name: (content (h, w) of each image, bucket, boxes shared)
    "sorted batch 8 x 480x640 in 512x768 (rn50.score, vitb16.score)":
        ([(480, 640)] * 8, (512, 768), True),
    "mixed batch of 8 in 768x768 (rn50.serve)":
        ([(480, 640), (640, 480), (427, 640), (640, 427), (640, 640), (480, 640), (640, 480),
          (427, 640)], (768, 768), False),
}


def resize_flops(sides, out=224) -> float:
    """benchmark/work.py's count: the separable bicubic resize of square
    crops of the given sides to out x out x 3 at the taps the cubic needs
    (4, widened by the shrink factor), a rows pass then a columns pass."""
    total = 0.0
    for s in sides:
        taps = 4.0 * max(s / out, 1.0)
        total += 2.0 * (out * taps * s * 3 + out * out * 3 * taps)
    return total


def resize_inputs(sizes, bucket, shared, seed=0):
    """uint8 images of the given contents zero-padded into the bucket and
    the engine's boxes (central square, then the 2/3/4 pyramid): the first
    image's where ``shared``, else each image's own; with the crops' sides."""
    from leclip_tpu_torch.ops.crops import tta_sampling_boxes

    rng = np.random.default_rng(seed)
    imgs, boxes = np.zeros((len(sizes),) + bucket + (3,), np.uint8), []
    for i, (h, w) in enumerate(sizes):
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        pyramid, _ = tta_sampling_boxes(h, w, (2, 3, 4))
        side = min(h, w)
        gy, gx = (h - side) / 2.0, (w - side) / 2.0
        boxes.append(np.concatenate([[[gy, gx, gy + side, gx + side]], pyramid]))
    boxes = np.stack(boxes).astype(np.float32)
    sides = [float(v) for b in (boxes[:1] if shared else boxes) for v in b[:, 2] - b[:, 0]]
    return (torch.from_numpy(imgs).to(DEVICE),
            torch.from_numpy(boxes[0] if shared else boxes).to(DEVICE),
            torch.tensor(sizes, dtype=torch.int32, device=DEVICE),
            sides * (len(sizes) if shared else 1))


def phase_resize(card):
    """resize_band (ops/resize_kernels.py) at the cells' batches, bf16 as the
    scoring engines run it: the resize against its plain version (the dense
    fp32 products of ops/resize_matmul.py) within one bf16 ulp on under 0.1%
    of the values (summation order only), the fused normalisation equal to
    clip_normalize of the kernel's own resize, one launch a call; the
    kernel's time (CUDA events and device time) beside the plain version's
    and its bound (benchmark/work.py's: the taps' fp32 operations, the
    images read and the crops written once). Returns {shape: row}."""
    from leclip_tpu_torch.ops import resize_kernels as rk
    from leclip_tpu_torch.ops.preprocess import clip_normalize

    res = {}
    for name, (sizes, bucket, shared) in RESIZE_SHAPES.items():
        images, boxes, content, sides = resize_inputs(sizes, bucket, shared)
        before = rk.resize_band.launches
        out = rk.resize_band(images, boxes, content, 224, dtype=torch.bfloat16, normalize=False)
        if rk.resize_band.launches != before + 1:
            raise AssertionError(f"[resize] {name}: not one launch")
        ref = rk.resize_band_plain(images, boxes, content, 224, dtype=torch.bfloat16,
                                   normalize=False)
        normed = rk.resize_band(images, boxes, content, 224, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        mant, exp = torch.frexp(ref.float())
        ulps = (d / torch.ldexp(torch.ones_like(mant), exp - 8)).max().item()
        share = (d > 0).float().mean().item()
        same_norm = torch.equal(normed, clip_normalize(out))
        del ref, normed, d, mant, exp
        args = (images, boxes, content, 224)
        ms = cuda_ms(lambda: rk.resize_band(*args, dtype=torch.bfloat16), 10)
        dev = device_ms(lambda: rk.resize_band(*args, dtype=torch.bfloat16), 5)
        plain = cuda_ms(lambda: rk.resize_band_plain(*args, dtype=torch.bfloat16), 3)
        nbytes = images.numel() + out.numel() * 2
        b_ms, by = bound_s(resize_flops(sides) / PEAK_FP32_FLOPS, nbytes)
        log(f"[resize] {name}, {out.shape[1]} crops an image, bf16: kernel {ms:.3f} ms (device "
            f"{dev:.3f}), plain {plain:.3f} ms, bound {b_ms:.4f} ms ({by}: "
            f"{resize_flops(sides) / 1e9:.2f} GFLOP at the taps, {nbytes / 1e6:.1f} MB); "
            f"against plain max {ulps:.3g} bf16 ulps, {share:.2e} of the values differ (<= 1 "
            f"ulp on < 1e-3), fused normalisation exact: {same_norm}, on {card}")
        if not (ulps <= 1.0 and share < 1e-3 and same_norm):
            raise AssertionError(f"[resize] {name}: kernel disagrees with its plain version")
        res[name] = dict(ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                         max_ulps=ulps, differ_share=share)
        del out, images
        torch.cuda.empty_cache()
    return res


# ------------------------------ average pool ----------------------------------

# the RN50 trunk's seven pools at 224² crops: (where, input H = W, C)
POOL_SHAPES = (("stem", 112, 64), ("layer2 conv3", 56, 128), ("layer2 downsample", 56, 256),
               ("layer3 conv3", 28, 256), ("layer3 downsample", 28, 512),
               ("layer4 conv3", 14, 512), ("layer4 downsample", 14, 1024))


def phase_avg_pool(card):
    """avg_pool_nhwc (ops/pool_kernels.py) at the RN50 trunk's seven pool
    shapes at the scored batch's crops (N_IMAGES x 305), bf16 as the scoring
    engines run it and fp32 as TEST.PREC fp32 does: 0 values differ from
    F.avg_pool2d on the card, one launch a call; the kernel's time (CUDA
    events and device time) beside the library's and the bytes bound (the
    map read once, the output written once). Returns {dtype: {shape: row,
    "total": the seven summed}}."""
    from leclip_tpu_torch.ops import pool_kernels as pk

    crops = N_IMAGES * 305
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    res = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        rows = {}
        for where, h, c in POOL_SHAPES:
            x = torch.randn(crops, h, h, c, generator=gen, device=DEVICE).to(dtype)
            before = pk.avg_pool_nhwc.launches
            out = pk.avg_pool_nhwc(x, 2)
            if pk.avg_pool_nhwc.launches != before + 1:
                raise AssertionError(f"[pool] {where}: not one launch")
            ref = pk.avg_pool_nhwc_plain(x, 2)
            torch.cuda.synchronize()
            differ = int((out != ref).sum().item())
            ms = cuda_ms(lambda: pk.avg_pool_nhwc(x, 2), 10)
            dev = device_ms(lambda: pk.avg_pool_nhwc(x, 2), 5)
            lib = cuda_ms(lambda: pk.avg_pool_nhwc_plain(x, 2), 10)
            lib_dev = device_ms(lambda: pk.avg_pool_nhwc_plain(x, 2), 5)
            nbytes = (x.numel() + out.numel()) * x.element_size()
            b_ms, by = bound_s(0.0, nbytes)
            rows[where] = dict(ms=ms, device_ms=dev, library_ms=lib, library_device_ms=lib_dev,
                               bound_ms=b_ms, bound_by=by, differ=differ)
            log(f"[pool] {tag} {where} [{crops}, {h}, {h}, {c}]: kernel {ms:.4f} ms (device "
                f"{dev:.4f}), library {lib:.4f} ms (device {lib_dev:.4f}), bound {b_ms:.4f} ms "
                f"({by}: {nbytes / 1e9:.3f} GB), {b_ms / dev:.1%} of the bound; {differ} values "
                f"differ from F.avg_pool2d")
            if differ:
                raise AssertionError(f"[pool] {tag} {where}: {differ} values differ from the "
                                     "library's")
            del x, out, ref
        total = {key: sum(r[key] for r in rows.values())
                 for key in ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms")}
        log(f"[pool] {tag}, the seven at {crops} crops: kernel {total['ms']:.4f} ms (device "
            f"{total['device_ms']:.4f}), library {total['library_ms']:.4f} (device "
            f"{total['library_device_ms']:.4f}), bound {total['bound_ms']:.4f} ms; "
            f"{total['bound_ms'] / total['device_ms']:.1%} of the bound, on {card}")
        res[tag] = dict(rows, total=dict(total, bound_by="bytes", differ=0))
        torch.cuda.empty_cache()
    return res


# ------------------------------- training -----------------------------------

# the ema recipe (configs/trainers/ema.yaml), cut to 2 epochs with every
# caption in training (no probe holdout): 8,192 captions, 8 steps an epoch
TRAIN_RECIPE = ["DATALOADER.BATCH_SIZE_TRAIN", "1024", "OPTIM.NAME", "sgd", "OPTIM.LR", "0.01",
                "OPTIM.MAX_EPOCH", "2", "OPTIM.WARMUP_EPOCH", "10",
                "OPTIM.WARMUP_TYPE", "constant", "OPTIM.WARMUP_CONS_LR", "1e-3",
                "TRAIN.LOSSFUNC", "double_ranking", "TRAIN.ema", "True", "TRAINER.N_CTX", "64",
                "TRAIN.spatial_SCALE_image", "50", "TRAIN.CHECKPOINT_FREQ", "5",
                "TRAIN.PRINT_FREQ", "4", "TRAIN.probe_holdout", "0", "SEED", "1"]


def caption_labels(toks):
    """Multi-hot labels that a caption's tokens decide: the classes of its
    first three BPE ids, skewed towards the low classes (u^3 of a uniform
    u), so the prompts have frequencies and token cues to learn."""
    labels = np.zeros((len(toks), 80), np.int8)
    u = (toks[:, 1:4] % 997) / 997.0
    np.put_along_axis(labels, (80 * u ** 3).astype(np.int64), 1, axis=1)
    return labels


TRAIN_RUNS = {  # run: (trainer options, its caption branch's path in PATH_KERNELS)
    "fp32": ([], "plain"),
    "bf16": (["TRAINER.PREC", "bf16"], "bf16"),
    "int8": (["TRAIN.int8_captions", "True"], "int8"),
    "fp32+evidence": (["TRAINER.use_evidence", "True"], "plain"),
}
# the step's parts between its marks (engine/trainer.make_train_step), and
# the split they are printed in
STEP_MARKS = ("caption", "teacher", "prompt forward", "loss", "backward", "optimizer")
STEP_SPLIT = {"caption branch (frozen, no_grad)": ("caption",),
              "prompt branch forward + backward": ("prompt forward", "backward"),
              "loss + EMA teacher": ("teacher", "loss"),
              "optimizer (SGD, EMA twin kept)": ("optimizer",)}


def cos_rows(a, b):
    a, b = a.double(), b.double()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def flat_tree(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat_tree(tree[k])]
    return [tree.reshape(-1)] if isinstance(tree, torch.Tensor) else []


def trees_equal(a, b):
    fa, fb = flat_tree(a), flat_tree(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for x, y in zip(fa, fb))


def step_split(trainer, batch, reps=3):
    """Per-part device times of warm training steps by CUDA events recorded
    at the step's own marks (median of ``reps``), on a copy of the state."""
    runs = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append(e)

        trainer.train_step(trainer.state, batch["img"], batch["label"], mark=mark)
        torch.cuda.synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(STEP_MARKS))])
    ms = dict(zip(STEP_MARKS, np.median(np.asarray(runs[1:]), axis=0)))
    return {name: float(sum(ms[m] for m in parts)) for name, parts in STEP_SPLIT.items()}


def train_run(name, clip_cfg, text, dataset, card, out_dir):
    """CaptionDistillTrainer.train() for 2 epochs; its losses, first-step
    caption features and prompt gradients, launches, rates and split."""
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillTrainer
    from leclip_tpu_torch.ops import launches

    opts, path = TRAIN_RUNS[name]
    cfg = setup_config(opts=TRAIN_RECIPE + opts + ["OUTPUT_DIR", out_dir])
    torch.cuda.reset_peak_memory_stats()
    trainer = CaptionDistillTrainer(cfg, {"text": text}, clip_cfg, dataset=dataset,
                                    device=DEVICE)
    if trainer.caption_route != path:
        raise AssertionError(f"[train:{name}] caption branch {trainer.caption_route}, "
                             f"expected {path}")
    first = next(iter(trainer.batcher.epoch(0)))
    feats = trainer.caption_features(first["img"])
    start = trainer.state
    step = trainer.train_step
    losses, grads = [], []

    def recording_step(state, captions, labels, mark=None):
        new, metrics = step(state, captions, labels, mark=mark)
        losses.append(metrics)
        if not grads:  # the first step's gradient: its trace less the weight decay
            wd = cfg.OPTIM.WEIGHT_DECAY
            grads.append({k: new.opt_state["1"]["trace"][k] - wd * state.params[k]
                          for k in state.params})
        return new, metrics

    trainer.train_step = recording_step
    steps = trainer.batcher.steps_per_epoch() * cfg.OPTIM.MAX_EPOCH
    launches.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches.launch_counts()
    trainer.train_step = step
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = [{k: float(v) for k, v in m.items()} for m in losses]
    expect_launches(f"[train:{name}] train()", counts, path, 12 * steps)
    if len(loss) != steps or not all(np.isfinite(v) for m in loss for v in m.values()):
        raise AssertionError(f"[train:{name}] losses not finite / {len(loss)} steps: {loss}")
    if not loss[-1]["loss"] < loss[0]["loss"]:
        raise AssertionError(f"[train:{name}] loss after {steps} steps {loss[-1]['loss']} not "
                             f"below the first step's {loss[0]['loss']}")
    split = step_split(trainer, first)
    rows = steps * cfg.DATALOADER.BATCH_SIZE_TRAIN
    log(f"[train:{name}] caption branch {path} ({PATH_KERNELS[path] or 'no kernel'} a layer); "
        f"train(): {steps} steps in {secs:.3f} s = {steps / secs:.3f} steps/s, "
        f"{rows / secs:.1f} captions/s (first-step setup and the checkpoint write included) "
        f"on {card}; peak memory {peak:.2f} GiB; launches {counts} (expected "
        f"{PATH_KERNELS[path] or 'none'} x 12 layers x {steps} steps)")
    log(f"[train:{name}] loss step 1 {loss[0]} -> step {steps} {loss[-1]}")
    warm = sum(split.values())
    log(f"[train:{name}] one warm step, {warm:.3f} ms by CUDA events ({1e3 / warm:.3f} steps/s, "
        f"{cfg.DATALOADER.BATCH_SIZE_TRAIN * 1e3 / warm:.1f} captions/s): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in split.items()))
    return dict(trainer=trainer, cfg=cfg, start=start, state=state, feats=feats, grad=grads[0],
                loss=loss, counts=counts, secs=secs, steps=steps, split=split, peak=peak,
                first=first)


# A kernel route's caption features against the CPU port's same route on
# the same weights (the kernels' plain versions), whole 12-layer branch, min
# cosine a row. bf16: the kernels' 4-ulp accumulation-order differences,
# compounded (bf16 against fp32 measured 0.9999). int8: with a bf16
# residual stream such differences flip int8 codes in every layer, so two
# int8 runs differ by quantization noise (measured 0.9995, max |d| 3e-3 of
# unit rows; the int8 path's fp32-residual bound, rows within 2e-4, does
# not hold: every row moves). Each layer is held tightly in phases 1-2 at
# this shape; this catches faults of composition.
BRANCH_COS = {"bf16": 0.9995, "int8": 0.999}
BRANCH_CAP = 2e-2  # max |d| of unit rows, the int8 path's cap
INT8_DEPARTURE_COS = 0.999  # bf16 against fp32 residual stream (0.99952 on the CPU)


def branch_against_cpu(name, run, clip_cfg, text, n=64):
    """The run's first-step caption features of ``n`` captions on the card
    against the CPU port's route on the same tower and kernel weights (the
    kernels' plain versions); for int8 also against the fp32 residual
    stream of the JAX package's q8 route."""
    from leclip_tpu_torch.device import tree_map
    from leclip_tpu_torch.models.dense_clip import encode_captions
    from leclip_tpu_torch.ops.quant import quantize_stack_on_device

    kw, flags = run["trainer"]._step_kwargs, run["trainer"].flags
    cpu = lambda t: t.cpu()  # noqa: E731
    caps = torch.as_tensor(run["first"]["img"][:n])
    text32 = tree_map(cpu, text)
    q8 = None if kw["caption_q8"] is None else tree_map(cpu, kw["caption_q8"])
    t0 = time.perf_counter()
    with torch.no_grad():
        refs = {"same": encode_captions({"text": tree_map(cpu, kw["caption_text"])}, clip_cfg,
                                        caps, flags, q8=q8, fused=kw["caption_fused"])}
        if name == "int8":
            refs["fp32 residual"] = encode_captions(
                {"text": text32}, clip_cfg, caps, flags,
                q8=quantize_stack_on_device(text32["blocks"]))
    secs = time.perf_counter() - t0
    valid = (refs["same"].pos_mask == 0).numpy()
    ok = True
    for field in ("global_feat", "spatial_feats"):
        out = getattr(run["feats"], field)[:n].float().cpu()
        got = {}
        for k, r in refs.items():
            r = getattr(r, field).float()
            o = out
            if field == "spatial_feats":
                o, r = o[valid], r[valid]
            got[k] = (cos_rows(o, r).min().item(),
                      ((o - r).abs().max() / r.abs().max().clamp(min=1.0)).item())
        cos, worst = got["same"]
        ok &= bool(torch.isfinite(out).all() and cos >= BRANCH_COS[name] and worst <= BRANCH_CAP)
        msg = (f"[train:{name}] {field} of {n} captions, card against the CPU port's route on the "
               f"same weights: min cosine {cos:.6f} (>= {BRANCH_COS[name]}), max |d| {worst:.4g} "
               f"(<= {BRANCH_CAP:g})")
        if "fp32 residual" in got:
            dep = got["fp32 residual"][0]
            ok &= dep >= INT8_DEPARTURE_COS
            msg += (f"; against the fp32 residual stream (the JAX package's q8 route) min cosine "
                    f"{dep:.6f} (>= {INT8_DEPARTURE_COS})")
        log(msg + f"; CPU {secs:.1f} s")
    if not ok:
        raise AssertionError(f"[train:{name}] the card's caption branch disagrees with the CPU "
                             "port's")


def phase_train(card, inputs):
    """The caption-distillation trainer that all 19 recipes run, at RN50's
    text width (12x512, 8 heads, embed 1024; seeded random weights): 8,192
    synthetic captions with token-decided multi-hot labels over the 80 COCO
    classes, the ema recipe's settings (TRAIN_RECIPE), train() for 2 epochs
    under TRAINER.PREC fp32, bf16 (caption branch on attn_block_bf16 +
    mlp_bf16), TRAIN.int8_captions (ln_quant + the int8 blocks), and fp32
    with use_evidence. Checks: launches, finite and falling loss, bf16 / int8
    caption features and prompt gradients against fp32, the bf16 / int8
    caption branch against the CPU port's on the same weights, the fp32 step in
    full fp32 (TF32 switched on around it; float64 on the card), the
    checkpoint's read-back, resume, and a make_engine member from the
    checkpoint scoring one batch."""
    from leclip_tpu_torch.data.datasets import CaptionDataset
    from leclip_tpu_torch.data.vocab import COCO_OBJECT_CATEGORIES
    from leclip_tpu_torch.device import cast_floating
    from leclip_tpu_torch.engine import checkpoint as ck
    from leclip_tpu_torch.engine import trainer as trainer_mod
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillTrainer, make_train_step
    from leclip_tpu_torch.inference.pipeline import load_ensemble_specs, make_engine
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
    from leclip_tpu_torch.models.text import init_text_params

    _, _, toks, _, images = inputs
    clip_cfg = PRESETS["RN50"]
    gen = torch.Generator(device=DEVICE).manual_seed(60)
    text = init_text_params(gen, clip_cfg.vocab_size, clip_cfg.context_length,
                            clip_cfg.transformer_width, clip_cfg.transformer_layers,
                            clip_cfg.embed_dim, device=DEVICE)
    dataset = CaptionDataset(toks, caption_labels(toks), [], list(COCO_OBJECT_CATEGORIES))
    log(f"[train] RN50 text tower {clip_cfg.transformer_layers}x{clip_cfg.transformer_width}, "
        f"{clip_cfg.transformer_heads} heads, embed {clip_cfg.embed_dim} (fp32, seeded random); "
        f"{len(toks)} captions, {dataset.labels.sum(1).mean():.2f} labels a caption; recipe "
        f"{' '.join(TRAIN_RECIPE)}")
    tmp = tempfile.mkdtemp(prefix="leclip_train_")
    try:
        runs = {name: train_run(name, clip_cfg, text, dataset, card, os.path.join(tmp, name))
                for name in TRAIN_RUNS}
        ref = runs["fp32"]
        for name in ("bf16", "int8"):
            r = runs[name]
            valid = ref["feats"].pos_mask == 0
            cg = cos_rows(r["feats"].global_feat, ref["feats"].global_feat).min().item()
            cs = cos_rows(r["feats"].spatial_feats, ref["feats"].spatial_feats)[valid].min().item()
            gr = torch.cat(flat_tree(r["grad"])), torch.cat(flat_tree(ref["grad"]))
            cgrad = cos_rows(gr[0][None], gr[1][None]).item()
            log(f"[train:{name}] first step against fp32: caption features min cosine global "
                f"{cg:.5f}, per token {cs:.5f} (>= 0.99); prompt gradient cosine {cgrad:.6f} "
                f"(>= 0.99)")
            if not (cg >= 0.99 and cs >= 0.99 and cgrad >= 0.99):
                raise AssertionError(f"[train:{name}] disagrees with the fp32 run")

        # each kernel route's caption branch against the CPU port's on the
        # same weights (the kernels' plain versions); for int8 also how far
        # its bf16 residual stream departs from the JAX package's fp32 one
        for name in ("bf16", "int8"):
            branch_against_cpu(name, runs[name], clip_cfg, text)

        # the fp32 step in full fp32: TF32 switched on around it changes nothing;
        # with the trainer's guard lifted it would
        trainer, batch, start = ref["trainer"], ref["first"], ref["start"]
        want, want_m = trainer.train_step(start, batch["img"], batch["label"])
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        guard = trainer_mod.no_tf32
        try:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            got, got_m = trainer.train_step(start, batch["img"], batch["label"])
            trainer_mod.no_tf32 = contextlib.nullcontext  # what TF32 would have given
            lifted, _ = trainer.train_step(start, batch["img"], batch["label"])
        finally:
            trainer_mod.no_tf32 = guard
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        g_want = torch.cat(flat_tree(want.opt_state["1"]["trace"]))
        d_lift = ((torch.cat(flat_tree(lifted.opt_state["1"]["trace"])) - g_want).abs().max()
                  / g_want.abs().max()).item()
        same = trees_equal(got._asdict(), want._asdict()) and float(got_m["loss"]) == float(
            want_m["loss"])
        log(f"[train:fp32] one step with TF32 switched on around it equals the "
            f"allow_tf32=False step: {same}; with the trainer's guard lifted the momentum "
            f"trace moves by {d_lift:.3g} of its largest value")
        if not same:
            raise AssertionError("[train:fp32] the fp32 step ran in TF32")

        # ... and agrees with the same step in float64 on the card
        f64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
        consts = {k: f64(v) if isinstance(v, torch.Tensor) else v
                  for k, v in trainer.constants.items()}
        step64 = make_train_step({"text": cast_floating(text, torch.float64)}, clip_cfg, consts,
                                 trainer.optimizer, trainer.flags, ema=True,
                                 momentum=ref["cfg"].TRAIN.momentum)
        s64, m64 = step64(start._replace(params=cast_floating(start.params, torch.float64),
                                         ema_params=cast_floating(start.ema_params,
                                                                  torch.float64),
                                         opt_state=cast_floating(start.opt_state,
                                                                 torch.float64)),
                          batch["img"], batch["label"])
        t32 = torch.cat(flat_tree(want.opt_state["1"]["trace"])).double()
        t64 = torch.cat(flat_tree(s64.opt_state["1"]["trace"]))
        d_grad = ((t32 - t64).abs().max() / t64.abs().max()).item()
        d_loss = abs(float(want_m["loss"]) - float(m64["loss"])) / abs(float(m64["loss"]))
        p32, p64 = torch.cat(flat_tree(want.params)).double(), torch.cat(flat_tree(s64.params))
        d_par = ((p32 - p64).abs().max() / p64.abs().max()).item()
        log(f"[train:fp32] one step against float64 on the card: loss {d_loss:.3g}, gradient "
            f"(momentum trace) {d_grad:.3g}, params {d_par:.3g} relative (<= 1e-4)")
        if max(d_loss, d_grad, d_par) > 1e-4:
            raise AssertionError("[train:fp32] the fp32 step disagrees with float64")

        # the checkpoint reads back bitwise; a trainer resumed from it takes the
        # uninterrupted third epoch's first step exactly
        path = ck.latest_checkpoint(ref["cfg"].OUTPUT_DIR, trainer.model_name)
        payload = ck.load_checkpoint(path)
        state = ref["state"]
        back = all(trees_equal(payload[k], getattr(state, k))
                   for k in ("params", "ema_params", "opt_state")) and payload["step"] == state.step
        batch3 = next(iter(trainer.batcher.epoch(2)))
        cont, cont_m = trainer.train_step(state, batch3["img"], batch3["label"])
        rcfg = setup_config(opts=TRAIN_RECIPE + ["OUTPUT_DIR", "", "RESUME",
                                                 ref["cfg"].OUTPUT_DIR])
        resumed = CaptionDistillTrainer(rcfg, {"text": text}, clip_cfg, dataset=dataset,
                                        device=DEVICE)
        rstate, start_epoch = ck.resume_if_exists(resumed.state, rcfg.RESUME,
                                                  resumed.model_name)
        rnext, r_m = resumed.train_step(rstate, batch3["img"], batch3["label"])
        exact = (start_epoch == 2 and rnext.step == cont.step
                 and trees_equal(rnext._asdict(), cont._asdict())
                 and float(r_m["loss"]) == float(cont_m["loss"]))
        log(f"[train:fp32] {os.path.basename(path)} ({os.path.getsize(path)} bytes, step "
            f"{payload['step']}) reads back bitwise: {back}; resumed at epoch {start_epoch + 1}, "
            f"its first step equals the uninterrupted run's: {exact}")
        if not (back and exact):
            raise AssertionError("[train:fp32] checkpoint read-back / resume differs")

        # the checkpoint as an RN50 ensemble member (every shipped recipe's
        # scoring path): load_prompt_params, make_engine, one batch
        gen = torch.Generator(device=DEVICE).manual_seed(61)
        params = init_clip_params(gen, clip_cfg, dtype=torch.bfloat16, device=DEVICE)
        params["text"] = text
        model_dir = os.path.join(tmp, "best_model", "ema")
        os.makedirs(model_dir)
        shutil.copy(path, os.path.join(model_dir, "model.ckpt"))
        ecfg = setup_config(opts=["TEST.PREC", "auto", "TEST.multi_scale", "(2, 3, 4)"])
        specs = load_ensemble_specs(ecfg, params, clip_cfg, list(COCO_OBJECT_CATEGORIES),
                                    os.path.dirname(model_dir))
        loaded = ck.load_prompt_params(os.path.dirname(model_dir), "ema", device=DEVICE)
        engine = make_engine(ecfg, params, clip_cfg, specs, device=DEVICE)
        scores = list(engine.run_batches_fused_staged(iter([images])))[0]
        if (list(specs) != ["ema"] or not trees_equal(loaded, state.params)
                or scores.shape != (N_IMAGES, 80) or not np.isfinite(scores).all()):
            raise AssertionError("[train] the checkpoint did not score as an ensemble member")
        log(f"[train] model.ckpt as RN50 member 'ema' (n_ctx "
            f"{int(specs['ema'].trainable['ctx'].shape[0])}): make_engine precision "
            f"{engine.precision}, one batch of {N_IMAGES} images -> scores {scores.shape}, "
            f"finite; first row head {np.round(scores[0, :4], 4).tolist()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = {k: sum(r["counts"][k] for r in runs.values()) for k in ref["counts"]}
    return total, {name: {key: r[key] for key in ("secs", "steps", "split", "peak")}
                   for name, r in runs.items()}, dict(trainer=ref["trainer"], text=text,
                                                      clip_cfg=clip_cfg, dataset=dataset)


# ------------------------------ phase 7 --------------------------------------
# the dump path, the bank CLI and the scoring service, on the engines of
# phases 3 (ViT-B/16, TEST.PREC auto -> int8) and 5 (RN50, auto -> bf16)

SERVICE_BATCH = 8          # the CLI's default batch (cli/eval.py, cli/serve.py)
DUMP_IMAGES = 6 * SERVICE_BATCH  # six batches: four of them between start-up and drain
PATHS_OF = {"vit": "int8", "rn": "plain"}  # each tower's auto path in PATH_KERNELS
AUTO_PREC = {"vit": "int8", "rn": "bf16"}   # the engine precision TEST.PREC auto gives it
BF16_UNIT = 2.0 ** -8      # a bf16 ulp of max(1, |x|), as bf16_tol counts it


def within(out, ref, rel=1e-4):
    """(max |out - ref|, whether it is within ``rel`` of max(1, max|ref|))."""
    err = float(np.abs(np.asarray(out, np.float64) - ref).max())
    return err, err <= rel * max(1.0, float(np.abs(ref).max()))


def dump_path(tag, engine, paths, card):
    """run_full_inference with save_dir (the dump path) against save_dir=None
    (the fused path) on the same PNG files at the CLI's batch 8: one warm
    batch of each, then three runs of each over every file, alternated. The
    pickles' keys and shapes, cli.gen_final_ans on them against the fused
    scores, run_batch against run_batch_multidispatch on one batch, the
    launch counts of each timed dump run, both paths' crop-forwards/s
    (median and range) and whether two dump passes pickle bitwise equal."""
    from leclip_tpu_torch.cli import gen_final_ans
    from leclip_tpu_torch.data.loader import load_image
    from leclip_tpu_torch.inference.pipeline import run_full_inference
    from leclip_tpu_torch.ops import launches

    n, n_cls, batch = len(paths), 80, SERVICE_BATCH
    n_batches = math.ceil(n / batch)
    crops = n * (1 + engine.n_blocks)
    tmp = os.path.dirname(paths[0])
    for save in (None, os.path.join(tmp, f"{tag}_warm")):
        run_full_inference(engine, paths[:batch], batch_size=batch, save_dir=save,
                           progress=False)
    secs = {"fused": [], "dump": []}
    dumps, counts = [], []
    for rep in range(3):
        for path in ("fused", "dump"):
            save = os.path.join(tmp, f"{tag}_{rep}") if path == "dump" else None
            launches.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_full_inference(engine, paths, batch_size=batch, save_dir=save,
                                     progress=False)
            torch.cuda.synchronize()
            secs[path].append(time.perf_counter() - t0)
            if path == "dump":
                counts.append(launches.launch_counts())
                dumps.append(save)
            else:
                fused = out
    for c in counts:
        expect_launches(f"[dump:{tag}] run_full_inference(save_dir)", c, PATHS_OF[tag],
                        12 * n_batches, rn_forwards=None if rn_bf16(engine) else 0,
                        resizes=n_batches)
    with open(os.path.join(dumps[-1], "data.pkl"), "rb") as f:
        data = pickle.load(f)
    with open(os.path.join(dumps[-1], "sim_matrix.pkl"), "rb") as f:
        sims = pickle.load(f)
    nb = engine.n_blocks
    want = {"output": (n, n_cls), "output_pos": (n, n_cls), "output_blocks": (n, nb, n_cls),
            "output_pos_blocks": (n, nb, n_cls), "output_final": (n, n_cls),
            "output_pos_final": (n, n_cls)}
    got = {name: {k: (v.shape, v.dtype) for k, v in outs.items()} for name, outs in data.items()}
    ok = (list(data) == list(engine.models) and set(sims) == {"sims_all", "sims_blocks_all"}
          and sims["sims_all"].shape == (n, engine.topk)
          and sims["sims_blocks_all"].shape == (n, nb, engine.topk)
          and all(got[m] == {k: (s, np.float32) for k, s in want.items()} for m in got))
    if not ok:
        raise AssertionError(f"[dump:{tag}] pickles: {got}, sims "
                             f"{ {k: v.shape for k, v in sims.items()} }")
    impreds = os.path.join(tmp, f"{tag}_impreds.json")
    fused_cli = gen_final_ans.main(["--data", os.path.join(dumps[-1], "data.pkl"),
                                    "--sim-matrix", os.path.join(dumps[-1], "sim_matrix.pkl"),
                                    "--out", impreds])
    back = np.asarray(json.load(open(impreds)))
    err, good = within(fused_cli, fused)
    log(f"[dump:{tag}] data.pkl: {len(data)} members x {list(want)} (blocks {want['output_blocks']}, "
        f"finals {want['output_final']}); sim_matrix.pkl sims_blocks_all "
        f"{sims['sims_blocks_all'].shape}; cli.gen_final_ans -> impreds.json {back.shape} against "
        f"the fused path: max|d| {err:.4g} (<= 1e-4 of max(1, max|fused|) "
        f"{np.abs(fused).max():.4g})")
    if not (good and back.shape == (n, n_cls) and np.allclose(back, fused_cli)):
        raise AssertionError(f"[dump:{tag}] gen_final_ans disagrees with the fused path")

    images = [load_image(p) for p in paths[:batch]]
    one, multi = engine.run_batch(images), engine.run_batch_multidispatch(images)
    worst = max(within(one[m][k], multi[m][k]) for m in one for k in one[m])
    log(f"[dump:{tag}] run_batch against run_batch_multidispatch, one batch of {batch}: "
        f"max|d| {worst[0]:.4g} (<= 1e-4 of max(1, max|x|) in every key)")
    if not all(within(one[m][k], multi[m][k])[1] for m in one for k in one[m]):
        raise AssertionError(f"[dump:{tag}] run_batch disagrees with run_batch_multidispatch")

    blobs = [open(os.path.join(d, "data.pkl"), "rb").read() for d in dumps[1:]]
    runs = {p: sorted(crops / x for x in s) for p, s in secs.items()}
    rate = {p: float(np.median(r)) for p, r in runs.items()}
    log(f"[dump:{tag}] two dump passes' data.pkl bitwise equal on the card: "
        f"{blobs[0] == blobs[1]} (reported, not required)")
    log(f"[dump:{tag}] crop-forwards/s, {n} PNG files 480x640 in {n_batches} batches of "
        f"{batch} ({crops} crops, decode included), three runs of each alternated in one call "
        f"after a warm batch: dump path {rate['dump']:.1f} (runs {runs['dump'][0]:.1f}-"
        f"{runs['dump'][-1]:.1f}), fused path {rate['fused']:.1f} (runs {runs['fused'][0]:.1f}-"
        f"{runs['fused'][-1]:.1f}); dump/fused {rate['dump'] / rate['fused']:.3f} (median), "
        f"{runs['dump'][0] / runs['fused'][-1]:.3f}-{runs['dump'][-1] / runs['fused'][0]:.3f} "
        f"(range); seconds "
        + ", ".join(f"{p} {[round(x, 4) for x in s]}" for p, s in secs.items())
        + f" on {card}")
    return dict(rate=rate, runs=runs, counts=counts[-1], bitwise=blobs[0] == blobs[1])


def bank_cli(card, toks, tmp, backbone="RN50"):
    """python -m leclip_tpu_torch.cli.build_caption_bank over the synthetic
    captions written as a corpus (the loader's cached layout: tokens and
    token-decided labels, as phase 6 builds its dataset), at each precision,
    a fresh process each: the launch counts the CLI prints after its encode
    (its process starts at 0); each CLI bank against build_caption_bank()
    called here on the same tokens and weights (bitwise; these calls'
    launches are not counted), bf16 and int8 rows against the default (fp32)
    rows (cosine >= 0.995)."""
    import argparse

    from leclip_tpu_torch.cli.eval import load_clip
    from leclip_tpu_torch.data.corpora import load_multi_label_corpus
    from leclip_tpu_torch.data.labeling import CaptionLabeler
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.inference.pipeline import build_caption_bank

    name = "synthetic_captions"
    root = os.path.join(tmp, "generated_captions")
    os.makedirs(root)
    labels = caption_labels(toks)
    with open(os.path.join(root, f"{name}_labels.pkl"), "wb") as f:
        pickle.dump({i: row.tolist() for i, row in enumerate(labels)}, f)
    with open(os.path.join(root, f"{name}_all_caption_tokenized.pkl"), "wb") as f:
        pickle.dump(toks, f)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    banks, cli = {}, {}
    for prec in ("default", "bf16", "int8"):
        out = os.path.join(tmp, f"bank_{prec}.pkl")
        cmd = [sys.executable, "-m", "leclip_tpu_torch.cli.build_caption_bank", "--backbone",
               backbone, "--caption-root", root, "--corpora", name, "--out", out,
               "--precision", prec, "--device", DEVICE.type]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=600)
        whole = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"[bank-cli:{prec}] exit {run.returncode}:\n{run.stdout}\n"
                                 f"{run.stderr}")
        enc = re.search(r"encoded (\d+) captions in ([\d.]+) s", run.stdout)
        launched = re.search(r"^kernel launches: (.*)$", run.stdout, re.M)
        with open(out, "rb") as f:
            banks[prec] = pickle.load(f)
        cli[prec] = (whole, float(enc.group(2)), int(enc.group(1)), json.loads(launched.group(1)))

    clip_cfg, params = load_clip(setup_config(), argparse.Namespace(weights="",
                                                                    backbone=backbone), DEVICE)
    tokens, _ = load_multi_label_corpus(root, name, CaptionLabeler())
    if not np.array_equal(tokens, toks):
        raise AssertionError("[bank-cli] the corpus did not read back as the written tokens")
    n_pass = math.ceil(len(tokens) / 256)
    counts, rows = {}, {}
    for prec in ("default", "bf16", "int8"):
        whole, enc_s, n, counts[prec] = cli[prec]
        expect_launches(f"[bank-cli:{prec}] the CLI's process", counts[prec],
                        "plain" if prec == "default" else prec, 12 * n_pass)
        direct = build_caption_bank(params, clip_cfg, tokens, 256, precision=prec, device=DEVICE)
        same = np.array_equal(banks[prec], direct)
        cos = float((banks[prec] * banks["default"]).sum(-1).min())
        rows[prec] = dict(whole=n / whole, encode=n / enc_s)
        log(f"[bank-cli:{prec}] {backbone} bank {banks[prec].shape} of {n} captions: CLI bank "
            f"bitwise equal to build_caption_bank() here: {same}; rows' min cosine to the "
            f"default (fp32) bank {cos:.5f} (>= 0.995); kernels the CLI's process launched "
            f"{counts[prec]}; captions/s: "
            f"whole command {rows[prec]['whole']:.1f} ({whole:.3f} s: process start, weights, "
            f"corpus, encode, write), encode alone {rows[prec]['encode']:.1f} ({enc_s:.3f} s) on "
            f"{card}")
        if not (same and banks[prec].shape == (len(toks), clip_cfg.embed_dim)
                and np.isfinite(banks[prec]).all() and cos >= 0.995):
            raise AssertionError(f"[bank-cli:{prec}] the CLI's bank disagrees")
    return dict(rates=rows, counts=counts)


def jpeg_blobs(n, gen_np):
    """``n`` seeded 480x640 JPEGs (quality 90)."""
    import io

    from PIL import Image

    out = []
    for _ in range(n):
        buf = io.BytesIO()
        Image.fromarray(gen_np.integers(0, 255, (480, 640, 3)).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


SERVICE_REQUESTS = 128
SERVICE_CLIENTS = 16
SERVICE_WAIT_MS = 5.0     # the CLI's default micro-batch window
SAME_BATCH_SAMPLE = 4     # dispatched batches recomputed a load (the same-batch check)
# every answer against run_batch_fused of the same images in fixed batches of
# 8, each within 1e-4 of max(1, max|ref|). The service pads every batch to 8,
# so its batches have the reference's shapes, and an image's scores do not
# depend on its place in a batch: on ViT int8 by the kernels' design, on
# RN50 bf16 since every convolution runs conv_bf16, which also makes them
# independent of the batch's size (rn_witness_stages requires both)
CROSS_BATCH = {"vit": ("max|d| / max(1, max|ref|) <=", 1e-4),
               "rn": ("max|d| / max(1, max|ref|) <=", 1e-4)}


def prometheus(url):
    import urllib.request

    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def service_load(url, blobs, n_requests, clients, reload_after=None):
    """``n_requests`` POSTs of one JPEG each from ``clients`` threads
    (request i sends blob i mod len(blobs)); with ``reload_after``, one POST
    /reload once that many answers are in. Returns a dict: seconds, scores
    {i: row}, client-side latencies, errors, and the reload's answer with
    the answers counted when it was sent and when it returned."""
    import threading
    import urllib.request

    def post(path, data, ctype):
        req = urllib.request.Request(f"{url}{path}", data=data, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    out = dict(scores={}, latency=[], errors=[], reload=None)
    lock = threading.Lock()
    ready = threading.Event()

    def client(c):
        for i in range(c, n_requests, clients):
            t0 = time.perf_counter()
            try:
                row = np.asarray(post("/score", blobs[i % len(blobs)], "image/jpeg")["scores"][0])
                with lock:
                    out["scores"][i] = row
                    out["latency"].append(time.perf_counter() - t0)
                    if reload_after is not None and len(out["scores"]) >= reload_after:
                        ready.set()
            except Exception as e:  # noqa: BLE001 — counted and reported by the caller
                with lock:
                    out["errors"].append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if reload_after is not None:
        ready.wait(timeout=600)
        sent, r0 = len(out["scores"]), time.perf_counter()
        answer = post("/reload", b"", "application/json")
        out["reload"] = (answer, sent, len(out["scores"]), time.perf_counter() - r0)
    for t in threads:
        t.join(timeout=600)
    out["seconds"] = time.perf_counter() - t0
    return out


def service(tag, keep, blobs, tmp, card):
    """build_service (TEST.PREC auto, batch 8) from the engine's members
    written as prompt checkpoints; a ThreadingHTTPServer on 127.0.0.1:0;
    128 POSTs from 16 clients at the CLI's 5 ms micro-batch window (rate,
    p50/p99 latency from /metrics, padding share, peak memory, launches),
    then 128 more with one POST /reload in flight. Every dispatch of the
    service's engines is recorded with its output. Three checks: every
    answer is a row of a dispatched output for its image (fan-out and
    order); a sample of the dispatched batches recomputed by
    engine.run_batch_fused equals the service's output (same batch, 1e-4);
    every answer against run_batch_fused of the same decoded images in
    fixed batches of 8 (CROSS_BATCH)."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from leclip_tpu_torch.cli.serve import build_service, make_handler
    from leclip_tpu_torch.data.loader import decode_bytes_batch
    from leclip_tpu_torch.engine.checkpoint import save_prompt_params
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.ops import launches

    model_dir = os.path.join(tmp, f"models_{tag}")
    for name, spec in keep["engine"].models.items():
        save_prompt_params(spec.trainable, model_dir, name)
    cfg = setup_config(opts=["TEST.PREC", "auto", "TEST.multi_scale", "(2, 3, 4)",
                             "TEST.use_freq", "True"], eval_only=True)
    svc = build_service(cfg, keep["params"], keep["clip_cfg"], model_dir,
                        caption_bank=keep["bank"], freq_stats=keep["freq"],
                        batch_size=SERVICE_BATCH, max_wait_ms=SERVICE_WAIT_MS, device=DEVICE)
    engine = svc.engine
    if engine.precision != AUTO_PREC[tag] or list(engine.models) != list(keep["engine"].models):
        raise AssertionError(f"[serve:{tag}] engine precision {engine.precision}, members "
                             f"{list(engine.models)}")
    images = decode_bytes_batch(blobs)
    which = {im.tobytes(): j for j, im in enumerate(images)}
    batches = [images[i: i + SERVICE_BATCH] for i in range(0, len(images), SERVICE_BATCH)]
    ref = np.concatenate(list(engine.run_batches_fused_staged(iter(batches), depth=2)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(engine.run_batches_fused_staged(iter(batches * 2), depth=2))
    torch.cuda.synchronize()
    engine_ips = 2 * len(images) / (time.perf_counter() - t0)

    dispatched = []  # (engine, the images of one dispatch, its output), in the worker's order

    def recorded(eng):
        # the worker stages each chunk, then dispatches it (cli/serve.py
        # _dispatch_async): each staged batch is matched to its images
        stage, launch = eng.stage_batch_fused, eng.dispatch_staged_fused
        chunks = {}

        def staged(batch):
            out = stage(batch)
            chunks[id(out)] = list(batch)
            return out

        def dispatch(st):
            out = launch(st)
            dispatched.append((eng, chunks.pop(id(st)), out))
            return out

        eng.stage_batch_fused, eng.dispatch_staged_fused = staged, dispatch
        return eng

    recorded(engine)
    factory = svc.engine_factory
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(
        svc, topk=5, reload_fn=lambda: recorded(factory())))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        before = prometheus(url)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        launches.reset_launch_counts()
        load = service_load(url, blobs, SERVICE_REQUESTS, SERVICE_CLIENTS)
        load["counts"] = launches.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        load["dispatched"] = list(dispatched)
        m = prometheus(url)
        d = {k: m[k] - before[k] for k in m}
        start = len(dispatched)
        reload = service_load(url, blobs, SERVICE_REQUESTS, SERVICE_CLIENTS, reload_after=8)
        reload["dispatched"] = dispatched[start:]
        final = prometheus(url)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()

    ok = health == {"status": "ok", "models": list(engine.models), "crops_per_image": 305}
    worst = dict(fanout=0.0, same=0.0)
    n_same = 0
    answers, refs = [], []
    for run in (load, reload):
        rows = {}  # image -> the rows of the service's outputs that hold it
        for eng, batch, out in run["dispatched"]:
            for im, row in zip(batch, eng._fetch(out)):
                rows.setdefault(which[im.tobytes()], []).append(row)
        for i, row in run["scores"].items():
            j = i % len(blobs)
            fan = min((within(row, c) for c in rows.get(j, [])), default=(np.inf, False))
            worst["fanout"] = max(worst["fanout"], fan[0])
            ok &= fan[1]
            answers.append(row)
            refs.append(ref[j])
        picks = np.unique(np.linspace(0, len(run["dispatched"]) - 1, SAME_BATCH_SAMPLE).round())
        for k in picks.astype(int):
            eng, batch, out = run["dispatched"][k]
            same = within(eng._fetch(out), eng._fetch(type(eng).dispatch_batch_fused(eng, batch)))
            worst["same"] = max(worst["same"], same[0])
            ok &= same[1]
            n_same += 1
        ok &= not run["errors"] and len(run["scores"]) == SERVICE_REQUESTS
    answers, refs = np.asarray(answers), np.asarray(refs)
    scale = max(1.0, float(np.abs(refs).max()))
    cross = dict(err=float(np.abs(answers - refs).max()),
                 corr=float(np.corrcoef(answers.ravel(), refs.ravel())[0, 1]))
    rule, bound = CROSS_BATCH[tag]
    ok &= cross["err"] <= bound * scale
    dispatches = int(d["leclip_dispatches_total"])
    expect_launches(f"[serve:{tag}] load", load["counts"], PATHS_OF[tag], 12 * dispatches,
                    rn_forwards=dispatches if rn_bf16(keep["engine"]) else 0, resizes=dispatches)
    pad = d["leclip_dispatch_padding_total"] / (d["leclip_dispatch_images_total"]
                                                + d["leclip_dispatch_padding_total"])
    lat = np.sort(load["latency"])
    rate = SERVICE_REQUESTS / load["seconds"]
    p50 = m['leclip_request_latency_seconds{quantile="0.5"}']
    p99 = m['leclip_request_latency_seconds{quantile="0.99"}']
    log(f"[serve:{tag}] {SERVICE_REQUESTS} POSTs of one 480x640 JPEG from {SERVICE_CLIENTS} "
        f"clients, micro-batch window {SERVICE_WAIT_MS:g} ms: {load['seconds']:.3f} s = "
        f"{rate:.2f} images/s ({rate / engine_ips:.3f} of the engine's {engine_ips:.2f} images/s "
        f"alone at batch {SERVICE_BATCH}); {int(d['leclip_dispatches_total'])} dispatches, "
        f"padding share {pad:.4f}; client latency p50 {lat[len(lat) // 2] * 1e3:.1f} ms, p99 "
        f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3:.1f} ms; launches "
        f"{load['counts']} on {card}")
    answer, sent, returned, reload_s = reload["reload"]
    log(f"[serve:{tag}] build_service TEST.PREC auto -> {engine.precision}; /healthz {health}; "
        f"{rate:.2f} images/s, /metrics p50 {p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms, requests "
        f"{int(m['leclip_requests_total'])}, errors {int(m['leclip_request_errors_total'])}; peak "
        f"memory over the load {peak / 2 ** 30:.2f} GiB ({(peak - base_mem) / 2 ** 30:.2f} GiB "
        f"above the {base_mem / 2 ** 30:.2f} held before it); images/s / (engine crop-forwards/s "
        f"/ 305) = {rate / engine_ips:.3f}")
    log(f"[serve:{tag}] answers against the service's dispatched outputs (fan-out): max|d| "
        f"{worst['fanout']:.4g} (<= 1e-4); {n_same} of "
        f"{len(load['dispatched']) + len(reload['dispatched'])} dispatched batches recomputed by "
        f"run_batch_fused (same batch): max|d| {worst['same']:.4g} (<= 1e-4); every answer "
        f"against run_batch_fused of its image in fixed batches of {SERVICE_BATCH}: max|d| "
        f"{cross['err']:.4g} ({cross['err'] / (BF16_UNIT * scale):.3g} bf16 ulps of max(1, "
        f"max|ref|) {scale:.4g}), correlation {cross['corr']:.7f} (required: {rule} {bound:g}); "
        f"POST /reload sent after {sent} answers of {SERVICE_REQUESTS}, "
        f"returned after {returned} in {reload_s:.3f} s: {answer}; {len(reload['scores'])} "
        f"answered, errors {len(reload['errors'])}; /metrics in all: requests "
        f"{int(final['leclip_requests_total'])}, errors {int(final['leclip_request_errors_total'])}")
    ok &= (m["leclip_requests_total"] == SERVICE_REQUESTS and m["leclip_request_errors_total"] == 0
           and answer.get("reloaded") is True and returned < SERVICE_REQUESTS
           and svc.engine is not engine and final["leclip_requests_total"] == 2 * SERVICE_REQUESTS
           and final["leclip_request_errors_total"] == 0)
    if not ok:
        errors = load["errors"] + reload["errors"]
        raise AssertionError(f"[serve:{tag}] failed: errors {errors[:3]}")
    return dict(rate=rate, p50=p50, p99=p99, pad=pad, peak=peak / 2 ** 30,
                engine_ips=engine_ips, counts=load["counts"], images=images)


def rn_batch_witness(engines, images, card):
    """Whether an RN50 image's scores depend on the batch it is scored in:
    one batch of 8 decoded JPEGs scored again (run to run), reversed
    (position), against another batch of 8 that shares four of its images
    at other positions (company), and five images padded to 8 by repeating
    the last, as the service pads, against the same five unpadded (batch
    size); on the bf16 engine (every convolution on conv_bf16) and the fp32
    one (every convolution on conv_fp32). Both must read 0 in all four."""
    a = images[:SERVICE_BATCH]
    out = {}
    for prec, eng in engines.items():
        base = eng.run_batch_fused(a)
        again = eng.run_batch_fused(a)
        rev = eng.run_batch_fused(a[::-1])[::-1]
        other = eng.run_batch_fused(images[4: 4 + SERVICE_BATCH])
        padded = eng.run_batch_fused(a[:5] + [a[4]] * 3)[:5]
        alone = eng.run_batch_fused(a[:5])
        ulp = BF16_UNIT * max(1.0, float(np.abs(base).max()))
        d = out[prec] = {"again": float(np.abs(again - base).max()),
                         "reversed": float(np.abs(rev - base).max()),
                         "other batch": float(np.abs(other[:4] - base[4:]).max()),
                         "padded 5 vs 5 alone": float(np.abs(padded - alone).max())}
        log(f"[serve:rn] batch witness, RN50 {prec} engine (compute {eng.compute_dtype}), max|d| "
            f"of the same images' scores: " + ", ".join(f"{k} {v:.4g} ({v / ulp:.3g} bf16 ulps)"
                                                        for k, v in d.items())
            + f" (a bf16 ulp of max(1, max|x|): {ulp:.4g}) on {card}")
    moved = {prec: d for prec, d in out.items() if any(d.values())}
    if moved:
        raise AssertionError(f"RN50 scores depend on the batch: {moved}")
    return out


# the batches each RN50 witness holds against the same images in one batch of
# SERVICE_BATCH as given, by image index: the batch-size axis (the first n
# images alone, the first five padded to eight by repeating the fifth, as the
# service pads) and the order axis (the batch reversed)
WITNESS_VARIANTS = {"1 alone": [0], "2 alone": [0, 1], "5 alone": [0, 1, 2, 3, 4],
                    "5 padded to 8": [0, 1, 2, 3, 4, 4, 4, 4],
                    "reversed": list(range(SERVICE_BATCH - 1, -1, -1))}


def witness_report(tag, out, card):
    """Log {route: {item: {variant: max|d|}}} one route a line; returns
    {route: {item: {variant: d}}} of the items that moved."""
    moved = {}
    for route, items in out.items():
        moved[route] = {k: {v: d for v, d in ds.items() if d != 0} for k, ds in items.items()}
        moved[route] = {k: v for k, v in moved[route].items() if v}
        worst = {v: max(ds[v] for ds in items.values()) for v in WITNESS_VARIANTS}
        log(f"[serve:rn] {tag}, route {route}: max|d| by batch " + ", ".join(
            f"{v} {d:.4g}" for v, d in worst.items()) + "; moved: "
            + ("; ".join(f"{k} ({', '.join(f'{v} {d:.3g}' for v, d in ds.items())})"
                         for k, ds in moved[route].items()) or "none") + f" on {card}")
    return moved


def rn_witness_stages(engine, images, card):
    """The RN50 batch witness split by stage: each stage of the engine's own
    pass (crops after resize + normalise, the trunk map, the pool's global
    feature, the dense projection, the fused scores) for each batch of
    WITNESS_VARIANTS, image for image against the same images in the batch
    of SERVICE_BATCH, under each route of conv_routes() for the engine's
    dtype. On the port's route (conv_bf16 or conv_fp32) every stage must
    read max|d| = 0 in every batch (the JAX trunk gives each image the same
    values whatever the batch); the other routes are reported. Returns
    {route: {stage: {variant: max|d|}}}."""
    stem, head = tower_parts(engine)

    def stages(batch):
        b = len(batch)
        engine._model_groups()  # builds the routing _score reads
        with torch.inference_mode():
            staged = engine.stage_batch_fused(batch)
            crops = engine._crops(staged)
            trunk = stem(crops.reshape((-1,) + crops.shape[2:]))
            feats = head(trunk)
            aug, scores = engine._retrieve(feats)
            fused = engine._score(feats, aug, scores, staged.batch, staged.n_boxes)
        per_image = lambda t: t.reshape((b, -1) + tuple(t.shape[1:])).float()  # noqa: E731
        return {"crops": per_image(crops), "trunk": per_image(trunk),
                "pool (global)": per_image(feats.global_feat),
                "dense projection": per_image(feats.spatial_feats), "scores": fused.float()}

    a = images[:SERVICE_BATCH]
    out = {}
    for route, fn in conv_routes(engine.compute_dtype).items():
        with conv_route(fn):
            base = stages(a)
            res = {k: {} for k in base}
            for variant, idx in WITNESS_VARIANTS.items():
                got = stages([a[i] for i in idx])
                for k in base:
                    res[k][variant] = (got[k] - base[k][idx]).abs().max().item()
                del got
        out[route] = res
        del base
    dtype = str(engine.compute_dtype).split(".")[-1]
    port = PORT_ROUTE[engine.compute_dtype]
    moved = witness_report(f"batch witness by stage, RN50 {dtype} engine, {SERVICE_BATCH} images "
                           f"({SERVICE_BATCH * 305} crops)", out, card)
    if moved[port]:
        raise AssertionError(f"RN50 {dtype} stages depend on the batch: {moved[port]}")
    return out


def rn_witness_layers(vis, flat, card, heads=32):
    """Each operation of the RN50 tower by itself, on its own input in the
    tower's pass over ``flat`` (SERVICE_BATCH images of 305 crops each, bf16
    or fp32): every convolution with its batch norm (models/resnet.conv_bn:
    55, with the residual add and ReLU where the trunk has them), every
    average pool (the stem's and the anti-aliasing ones) and every product
    of the single-query attention pool (q, k, v, c, its logits and its
    probabilities times v) and of the dense projection (v, c), run for each
    batch of WITNESS_VARIANTS and compared
    image for image with the same images in the full batch. The
    convolutions run by each route of conv_routes() for the dtype (cuDNN's
    route unfused; the port's as the tower runs it), and
    so do the pool's and the dense projection's products (the port's _proj
    on its route, the library's product on the others, as conv_route runs
    them); pools and the per-head products are the tower's own, reported
    under every route. The port's
    route must read 0 at every operation and in every batch; the others are
    reported (which operations move, and in which batches). Returns
    {route: {operation: {variant: max|d|}}}."""
    from leclip_tpu_torch.models import resnet

    dtype = flat.dtype
    routes = conv_routes(dtype)
    port = PORT_ROUTE[dtype]
    out = {r: {} for r in routes}
    n = SERVICE_BATCH
    port_conv_bn, port_pool, port_proj = resnet.conv_bn, resnet.avg_pool, resnet._proj

    def sub(t, idx):
        return None if t is None else t.reshape((n, -1) + tuple(t.shape[1:]))[idx].flatten(0, 1)

    def witness(res, run):
        """{variant: max|d|} of run(idx) against run(all) image for image."""
        base = run(list(range(n)))
        base = base.reshape((n, -1) + tuple(base.shape[1:]))
        for variant, idx in WITNESS_VARIANTS.items():
            got = run(idx)
            res[variant] = (got.reshape((len(idx), -1) + tuple(got.shape[1:])).float()
                            - base[idx].float()).abs().max().item()
            del got
        del base

    def name(kind):
        return f"{len(out[port]):02d} {kind}"

    def conv_bn(x, k, bn, stride=1, residual=None, relu=True):
        label = name(f"conv {conv_name(x, k, stride)}")
        for route, fn in routes.items():
            run_bn = port_conv_bn if route == port else conv_bn_over(fn)
            witness(out[route].setdefault(label, {}), lambda idx: run_bn(
                sub(x, idx), k, bn, stride, sub(residual, idx), relu))
        return port_conv_bn(x, k, bn, stride, residual, relu)

    def shared(label, run):  # an operation every route runs the same way
        res = {}
        witness(res, run)
        for route in routes:
            out[route][label] = dict(res)

    def avg_pool(x, window):
        if window > 1:
            shared(name(f"avg_pool {window} {x.shape[1]}x{x.shape[2]}x{x.shape[3]}"),
                   lambda idx: port_pool(sub(x, idx), window))
        return port_pool(x, window)

    def proj(y, p):  # the port's _proj on its route, the library's on the others
        label = name(f"product {y.shape[-1]}->{p['kernel'].shape[-1]} ({y.shape[1]} rows a "
                     f"crop)")
        for route in routes:
            run = port_proj if route == port else plain_proj
            witness(out[route].setdefault(label, {}), lambda idx: run(sub(y, idx), p))
        return port_proj(y, p)

    def batched(label, fn):  # the pool's per-head products, [B, H, ...] @ [B, H, ...]
        def run(u, v):
            shared(name(f"{label} {tuple(u.shape[1:])} @ {tuple(v.shape[1:])}"),
                   lambda idx: fn(sub(u, idx), sub(v, idx)))
            return fn(u, v)
        return run

    with patched(resnet, "conv_bn", conv_bn), patched(resnet, "avg_pool", avg_pool), \
            patched(resnet, "_proj", proj), \
            patched(resnet, "_mm32", batched("pool logits", resnet._mm32)), \
            patched(resnet, "_matmul", batched("pool probs x v", resnet._matmul)), \
            torch.inference_mode():
        feat = resnet.resnet_features(flat, vis)
        resnet.attention_pool(feat, vis["attnpool"], heads, if_pos=False, global_only=True)
        resnet.project_dense(feat, vis["attnpool"])
    kind = str(dtype).split(".")[-1]
    moved = witness_report(f"batch witness by operation, RN50 {kind} tower, {len(out[port])} "
                           f"operations on {flat.shape[0]} crops of {n} images", out, card)
    if moved[port]:
        raise AssertionError(f"RN50 {kind} operations depend on the batch: {moved[port]}")
    return out


def rn_witness_layers_engine(engine, images, card):
    """:func:`rn_witness_layers` on the engine's own crops of
    SERVICE_BATCH images."""
    with torch.inference_mode():
        crops = engine._crops(engine.stage_batch_fused(images[:SERVICE_BATCH]))
    return rn_witness_layers(engine.clip_params["visual"], crops.flatten(0, 1), card,
                             engine.clip_cfg.vision_heads)


def decoder_probe():
    """Whether the native JPEG decoder's toolchain exists here: g++, the
    libjpeg header and library (a one-line program that includes jpeglib.h
    and links -ljpeg). Information, not a check."""
    import ctypes.util

    gxx = shutil.which("g++")
    found = "g++ missing"
    if gxx:
        with tempfile.TemporaryDirectory() as d:
            src = os.path.join(d, "probe.cpp")
            with open(src, "w") as f:
                f.write("#include <cstdio>\n#include <jpeglib.h>\n"
                        "int main() { jpeg_decompress_struct c; jpeg_std_error(nullptr);"
                        " (void)c; return 0; }\n")
            hdr = subprocess.run([gxx, "-fsyntax-only", src], capture_output=True, text=True)
            link = subprocess.run([gxx, src, "-ljpeg", "-o", os.path.join(d, "probe")],
                                  capture_output=True, text=True)
            found = (f"jpeglib.h {'found' if hdr.returncode == 0 else 'missing'}, "
                     f"-ljpeg links {'yes' if link.returncode == 0 else 'no'}")
    log(f"[decoder] native JPEG decoder toolchain: g++ {gxx or 'missing'}; {found}; "
        f"libjpeg.so* {ctypes.util.find_library('jpeg') or 'not found'} (information only)")


def phase_dump_bank_service(card, inputs, vit, rn):
    """Phase 7: the dump path on both engines, the bank CLI at three
    precisions, the scoring service on both engines, the RN50 batch
    witness, the decoder probe. Returns (launches of the dump runs, the
    bank CLI's processes and the service loads, summed; per-part
    results)."""
    from PIL import Image

    _, _, toks, _, images = inputs
    gen_np = np.random.default_rng(70)
    tmp = tempfile.mkdtemp(prefix="leclip_phase7_")
    secs, res = {}, {}

    def part(key, fn, *args):
        t0 = time.perf_counter()
        res[key] = fn(*args)
        secs[key] = time.perf_counter() - t0

    t0 = time.perf_counter()
    try:
        paths = []
        extra = [gen_np.integers(0, 255, (480, 640, 3)).astype(np.uint8)
                 for _ in range(DUMP_IMAGES - len(images))]
        for i, im in enumerate(list(images) + extra):
            paths.append(os.path.join(tmp, f"img{i}.png"))
            Image.fromarray(im).save(paths[-1])
        part("dump:vit", dump_path, "vit", vit["engine"], paths, card)
        part("dump:rn", dump_path, "rn", rn["engine"], paths, card)
        part("bank-cli", bank_cli, card, toks, tmp)
        blobs = jpeg_blobs(SERVICE_CLIENTS, gen_np)
        part("serve:vit", service, "vit", vit, blobs, tmp, card)
        part("serve:rn", service, "rn", rn, blobs, tmp, card)
        part("witness:rn", rn_batch_witness, {"bf16": rn["engine"], "fp32": rn["engine_fp32"]},
             res["serve:rn"]["images"], card)
        for prec, key in (("bf16", "engine"), ("fp32", "engine_fp32")):
            part(f"witness-stages:rn {prec}", rn_witness_stages, rn[key],
                 res["serve:rn"]["images"], card)
            part(f"witness-layers:rn {prec}", rn_witness_layers_engine, rn[key],
                 res["serve:rn"]["images"], card)
            torch.cuda.empty_cache()
        decoder_probe()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[phase7] {time.perf_counter() - t0:.1f} s in all: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    parts = [res["dump:vit"]["counts"], res["dump:rn"]["counts"], res["serve:vit"]["counts"],
             res["serve:rn"]["counts"]] + list(res["bank-cli"]["counts"].values())
    total = {k: sum(c[k] for c in parts) for k in parts[0]}
    return total, res


# ------------------------------ phase 8 --------------------------------------
# the rest of the training flow and the scoring entry points on the card:
# the trainer's image-split validate, the adapter trainer, the optimizer
# menu, the profiler window, the native JPEG decoder, the zero-shot CLI and
# the caption benchmark

FLOW_IMAGES = 64           # JPEGs 480x640 written by the phase (phase 7's size)
VIT_VAL_IMAGES = 16
ADAPTER_RUNS = {  # run: (trainer options, its caption branch's path in PATH_KERNELS)
    "fp32": ([], "plain"),
    "bf16": (["TRAINER.PREC", "bf16"], "bf16"),
    "int8": (["TRAIN.int8_captions", "True"], "int8"),
}
OPTIMIZERS = ("adam", "amsgrad", "adamw", "rmsprop", "radam")
ZEROSHOT_BACKBONES = (("RN50", "plain"), ("ViT-B/16", "fp32"))  # (backbone, its path)
GRAD_CPU_CAPTIONS = 64     # the first step's captions held against the CPU port
CAPTION_EVAL_ROWS = 1024
CAPTION_EVAL_CPU_ROWS = 64


def decoder_check(paths, card):
    """The native JPEG decoder on this machine: what the probe finds (the
    glob over pillow.libs and the system, ctypes' find_library), the build
    and ABI check, every JPEG native and bitwise PIL's, no JPEG to PIL, and
    images/s native (8 threads) against PIL (one thread; eight threads)."""
    import concurrent.futures
    import ctypes.util

    from PIL import Image

    from leclip_tpu_torch.runtime import jpeg

    cands = jpeg.libjpeg_candidates()
    log(f"[decoder] probe: libjpeg*.so.62* by glob (pillow.libs, then the system's): "
        f"{cands or 'none'}; ctypes.util.find_library('jpeg'): "
        f"{ctypes.util.find_library('jpeg') or 'not found'}; g++ {shutil.which('g++') or 'missing'}")
    t0 = time.perf_counter()
    if not jpeg.native_available():
        raise AssertionError(f"[decoder] the native decoder did not load: {jpeg.failure()}")
    build_s = time.perf_counter() - t0
    pil = lambda p: np.asarray(Image.open(p).convert("RGB"))  # noqa: E731
    jpeg.reset_decode_counts()
    native = jpeg.decode_batch(paths, threads=8)
    counts = jpeg.decode_counts()
    same = all(np.array_equal(a, pil(p)) for a, p in zip(native, paths))
    rates = {}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for name, fn in (("native, 8 threads", lambda: jpeg.decode_batch(paths, threads=8)),
                         ("PIL, one thread", lambda: [pil(p) for p in paths]),
                         ("PIL, 8 threads", lambda: list(pool.map(pil, paths)))):
            took = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                took.append(time.perf_counter() - t0)
            rates[name] = len(paths) / float(np.median(took))
    log(f"[decoder] native decoder built and loaded in {build_s:.2f} s "
        f"({os.path.basename(jpeg.load()._name)}); {len(paths)} JPEGs 480x640: bitwise equal to "
        f"PIL: {same}; decoders {counts} (PIL's JPEGs must be 0); images/s (median of 3): "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + f" on {card}")
    if not same or counts != {"native": len(paths), "pil": 0, "pil_jpeg": 0}:
        raise AssertionError("[decoder] the native decoder disagrees with PIL or JPEGs went to PIL")
    return rates


def validate_run(tag, trainer, paths, n_images, path, card):
    """trainer.validate() over ``n_images`` val images (the dataset's test
    split made so that ``test[::100]`` is them): the arrays it feeds the
    evaluator, finite [N, 80]; its launches (``path`` in each of 12 layers,
    a batch of 8 at a time); every JPEG decoded natively; its first batch
    against run_batch of a freshly built one-member engine on the same
    params (1e-4 of max(1, max|ref|)); crop-forwards/s."""
    from PIL import Image

    from leclip_tpu_torch.data.datasets import CaptionDataset
    from leclip_tpu_torch.engine import evaluator
    from leclip_tpu_torch.inference.tta import TTAEngine, build_model_spec
    from leclip_tpu_torch.ops import launches
    from leclip_tpu_torch.runtime import jpeg

    ds = trainer.dataset
    trainer.dataset = CaptionDataset(ds.tokens, ds.labels,
                                     [p for p in paths[:n_images] for _ in range(100)],
                                     ds.classnames)
    calls = []
    orig = evaluator.MLClassificationEvaluator.process

    def process(self, out, labels, out_local=None):
        calls.append((np.asarray(out), np.asarray(labels), np.asarray(out_local)))
        return orig(self, out, labels, out_local)

    evaluator.MLClassificationEvaluator.process = process
    try:
        jpeg.reset_decode_counts()
        launches.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.validate()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, decoded = launches.launch_counts(), jpeg.decode_counts()
    finally:
        evaluator.MLClassificationEvaluator.process = orig
    out, labels, local = (np.concatenate([c[i] for c in calls]) for i in range(3))
    n_batches = math.ceil(n_images / SERVICE_BATCH)
    rn32 = None if not trainer.clip_cfg.is_vit else 0  # the fp32 engine's tower: conv_fp32
    expect_launches(f"[validate:{tag}] validate()", counts, path, 12 * n_batches,
                    rn32_forwards=rn32, resizes=n_batches)
    prompt = {k: v for k, v in trainer.state.params.items() if k != "_adapter"}
    spec = build_model_spec(trainer.clip_params, trainer.clip_cfg, prompt, trainer.constants,
                            trainer.flags)
    engine = TTAEngine(trainer.clip_params, trainer.clip_cfg, {trainer.model_name: spec},
                       scales=trainer.cfg.TEST.multi_scale,
                       crop_size=trainer.clip_cfg.image_resolution, device=DEVICE)
    ref = engine.run_batch([np.asarray(Image.open(p).convert("RGB"))
                            for p in paths[:SERVICE_BATCH]])[trainer.model_name]
    errs = [within(out[:SERVICE_BATCH], ref["output_final"]),
            within(local[:SERVICE_BATCH], ref["output_pos_final"])]
    finite = bool(np.isfinite(out).all() and np.isfinite(local).all())
    crops = n_images * (1 + engine.n_blocks)
    log(f"[validate:{tag}] trainer.validate() over {n_images} val images 480x640 ({crops} crops, "
        f"batches of {SERVICE_BATCH}) in {secs:.3f} s = {crops / secs:.1f} crop-forwards/s "
        f"(decode, engine build, prompt features and scoring) on {card}; results {res}; "
        f"evaluator arrays {out.shape} finite {finite}, labels zero {not labels.any()}; "
        f"decoders {decoded}; launches {counts}; first batch against run_batch of a fresh "
        f"one-member engine: output_final {errs[0][0]:.3g}, output_pos_final {errs[1][0]:.3g} "
        f"(<= 1e-4 of max(1, max|ref|))")
    if not (out.shape == local.shape == (n_images, 80) and finite and not labels.any()
            and all(ok for _, ok in errs) and decoded["pil_jpeg"] == 0
            and decoded["native"] == n_images):
        raise AssertionError(f"[validate:{tag}] validate() disagrees")
    return dict(secs=secs, rate=crops / secs, counts=counts)


def flat_params(tree):
    return torch.cat([t.reshape(-1).float().cpu() for t in flat_tree(tree)])


def adapter_run(name, trainable, clip_cfg, text, dataset, card, out_dir, split=False):
    """CaptionDistillAdapterTrainer.train() for 2 epochs (16 steps) on the
    ema recipe: losses, launches, the first step's state, a warm step's
    split."""
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillAdapterTrainer
    from leclip_tpu_torch.ops import launches

    opts, path = ADAPTER_RUNS[name]
    cfg = setup_config(opts=TRAIN_RECIPE + opts + ["OUTPUT_DIR", out_dir,
                                                   "TRAINER.adapter_trainable", str(trainable)])
    trainer = CaptionDistillAdapterTrainer(cfg, {"text": text}, clip_cfg, dataset=dataset,
                                           device=DEVICE)
    tag = f"[adapter:{name}:{'trainable' if trainable else 'frozen'}]"
    if trainer.caption_route != path or ("_adapter" in trainer.state.params) != trainable:
        raise AssertionError(f"{tag} route {trainer.caption_route}, state "
                             f"{sorted(trainer.state.params)}")
    start, step, losses = trainer.state, trainer.train_step, []

    def recording_step(state, captions, labels, mark=None):
        new, metrics = step(state, captions, labels, mark=mark)
        losses.append(metrics)
        return new, metrics

    trainer.train_step = recording_step
    steps = trainer.batcher.steps_per_epoch() * cfg.OPTIM.MAX_EPOCH
    launches.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches.launch_counts()
    trainer.train_step = step
    loss = [float(m["loss"]) for m in losses]
    expect_launches(f"{tag} train()", counts, path, 12 * steps)
    if len(loss) != steps or not np.isfinite(loss).all():
        raise AssertionError(f"{tag} losses not finite / {len(loss)} steps: {loss}")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"{tag} loss after {steps} steps {loss[-1]} not below the first "
                             f"step's {loss[0]}")
    moved = trainable and not torch.equal(state.params["_adapter"]["down_kernel"],
                                          trainer.adapter["down_kernel"])
    first = next(iter(trainer.batcher.epoch(0)))
    warm = step_split(trainer, first) if split else None
    log(f"{tag} caption branch {path}; train(): {steps} steps in {secs:.3f} s = "
        f"{steps / secs:.3f} steps/s on {card}; loss step 1 {loss[0]:.5f} -> step {steps} "
        f"{loss[-1]:.5f}; launches {counts}; adapter in the state {trainable}, moved {moved}"
        + ("" if warm is None else "; one warm step " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in warm.items()) + f" ({sum(warm.values()):.3f} ms)"))
    if trainable and not moved:
        raise AssertionError(f"{tag} the trainable adapter did not move")
    return dict(trainer=trainer, cfg=cfg, start=start, state=state, counts=counts, secs=secs,
                steps=steps, split=warm, first=first)


def adapter_phase(clip_cfg, text, dataset, card, tmp):
    """The adapter trainer at RN50's text width on the ema recipe: fp32,
    bf16 and TRAIN.int8_captions, each frozen and adapter_trainable (16
    steps each); a resumed step against the uninterrupted one (fp32, both);
    the card's first-step prompt gradient against the CPU port's on the
    same weights, captions and start (fp32 trainable, cosine >= 0.9999)."""
    from leclip_tpu_torch.device import tree_map
    from leclip_tpu_torch.engine import checkpoint as ck
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillAdapterTrainer

    runs = {}
    for name in ADAPTER_RUNS:
        for trainable in (False, True):
            runs[(name, trainable)] = adapter_run(
                name, trainable, clip_cfg, text, dataset, card,
                os.path.join(tmp, f"adapter_{name}_{trainable}"), split=trainable)
    for trainable in (False, True):
        run = runs[("fp32", trainable)]
        trainer = run["trainer"]
        batch3 = next(iter(trainer.batcher.epoch(2)))
        cont, cont_m = trainer.train_step(run["state"], batch3["img"], batch3["label"])
        rcfg = setup_config(opts=TRAIN_RECIPE + ["OUTPUT_DIR", "", "RESUME",
                                                 run["cfg"].OUTPUT_DIR,
                                                 "TRAINER.adapter_trainable", str(trainable)])
        resumed = CaptionDistillAdapterTrainer(rcfg, {"text": text}, clip_cfg, dataset=dataset,
                                               device=DEVICE)
        rstate, start_epoch = ck.resume_if_exists(resumed.state, rcfg.RESUME,
                                                  resumed.model_name)
        rnext, r_m = resumed.train_step(rstate, batch3["img"], batch3["label"])
        exact = (start_epoch == 2 and trees_equal(rnext._asdict(), cont._asdict())
                 and float(r_m["loss"]) == float(cont_m["loss"]))
        log(f"[adapter:fp32:{'trainable' if trainable else 'frozen'}] resumed at epoch "
            f"{start_epoch + 1} from its checkpoint: its first step equals the uninterrupted "
            f"run's: {exact}")
        if not exact:
            raise AssertionError("[adapter] a resumed step differs from the uninterrupted one")

    # the first step's prompt gradient (the adapter's included) on the card
    # against the CPU port's: the same start, weights and captions
    run = runs[("fp32", True)]
    trainer, start, first = run["trainer"], run["start"], run["first"]
    caps, labs = first["img"][:GRAD_CPU_CAPTIONS], first["label"][:GRAD_CPU_CAPTIONS]
    wd = run["cfg"].OPTIM.WEIGHT_DECAY

    def grad(new, s):  # the first SGD step's trace less the weight decay
        return flat_params(new.opt_state["1"]["trace"]) - wd * flat_params(s.params)

    g_card = grad(trainer.train_step(start, caps, labs)[0], start)
    cpu = lambda t: t.cpu()  # noqa: E731
    t0 = time.perf_counter()
    cpu_trainer = CaptionDistillAdapterTrainer(
        setup_config(opts=TRAIN_RECIPE + ["OUTPUT_DIR", "", "TRAINER.adapter_trainable", "True"]),
        {"text": tree_map(cpu, text)}, clip_cfg, dataset=dataset, device="cpu",
        adapter=tree_map(cpu, trainer.adapter))
    cstart = start._replace(params=tree_map(cpu, start.params),
                            ema_params=tree_map(cpu, start.ema_params),
                            opt_state=tree_map(cpu, start.opt_state))
    g_cpu = grad(cpu_trainer.train_step(cstart, caps, labs)[0], cstart)
    cpu_s = time.perf_counter() - t0
    cos = cos_rows(g_card[None], g_cpu[None]).item()
    log(f"[adapter:fp32:trainable] first-step prompt gradient ({g_card.numel()} values, the "
        f"adapter's included) of {GRAD_CPU_CAPTIONS} captions, card against the CPU port on the "
        f"same start and weights: cosine {cos:.7f} (>= 0.9999), max|d| "
        f"{(g_card - g_cpu).abs().max().item():.3g} of max|g| {g_cpu.abs().max().item():.3g}; "
        f"CPU {cpu_s:.1f} s")
    if not cos >= 0.9999:
        raise AssertionError("[adapter] the card's gradient disagrees with the CPU port's")
    total = {k: sum(r["counts"][k] for r in runs.values()) for k in run["counts"]}
    return total, {f"{n}:{'trainable' if t else 'frozen'}":
                   {k: r[k] for k in ("secs", "steps", "split")} for (n, t), r in runs.items()}


def optimizer_phase(params, card, tmp):
    """The five optimizers of the menu beside SGD, 8 steps each on the ema
    recipe's prompt tree (phase 6's trained params) with seeded gradients:
    the card against the CPU port within 1e-5 of each leaf's largest value,
    TF32 off; the card's checkpoint read back by the CPU port bitwise; the
    card's optimizer step by CUDA events (median of the 8)."""
    from leclip_tpu_torch.device import tree_map
    from leclip_tpu_torch.engine import checkpoint as ck
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.train_state import build_optimizer, create_train_state

    gen = torch.Generator().manual_seed(80)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    grads = [tree_map(lambda t: 0.01 * torch.randn(t.shape, generator=gen), cpu_params)
             for _ in range(8)]
    out = {}
    for name in OPTIMIZERS:
        opt = build_optimizer(setup_config(opts=TRAIN_RECIPE + ["OPTIM.NAME", name]).OPTIM, 8)
        on, off = create_train_state(params, opt), create_train_state(cpu_params, opt)
        p, s, cp, cs = on.params, on.opt_state, off.params, off.opt_state
        ms = []
        for g in grads:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            gd = tree_map(lambda t: t.to(DEVICE), g)
            e0.record()
            p, s = opt.update(gd, s, p)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            cp, cs = opt.update(g, cs, cp)
        worst = max(((a.cpu().double() - b.double()).abs().max()
                     / b.double().abs().max().clamp(min=1e-30)).item()
                    for a, b in zip(flat_tree({"p": p, "s": s}), flat_tree({"p": cp, "s": cs})))
        state = on._replace(step=8, params=p, ema_params=p, opt_state=s)
        path = ck.save_checkpoint(state, tmp, f"opt_{name}", 0)
        payload = ck.load_checkpoint(path)
        back = all(trees_equal(payload[k], tree_map(lambda t: t.cpu(), getattr(state, k)))
                   for k in ("params", "opt_state"))
        out[name] = float(np.median(ms))
        log(f"[optim:{name}] 8 steps on the prompt tree ({sum(t.numel() for t in flat_tree(p))} "
            f"values): card against the CPU port max|d| {worst:.3g} of each leaf's largest "
            f"(<= 1e-5); checkpoint ({os.path.getsize(path)} bytes) read back on the CPU "
            f"bitwise: {back}; optimizer step {out[name]:.3f} ms (CUDA events, median of 8) on "
            f"{card}")
        if worst > 1e-5 or not back:
            raise AssertionError(f"[optim:{name}] the card disagrees with the CPU port")
    return out


def profiler_check(clip_cfg, text, dataset, card, tmp):
    """TRAIN.profile_dir on a bf16 trainer (its caption branch on rows 1-2),
    one epoch of 8 steps, the window the steps after 1 .. 5: the trace files
    exist and name the block kernels' launches; train() with and without
    the window."""
    import glob

    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillTrainer

    secs = {}
    prof = os.path.join(tmp, "prof")
    for with_prof in (False, True):
        opts = TRAIN_RECIPE + ["TRAINER.PREC", "bf16", "OPTIM.MAX_EPOCH", "1", "OUTPUT_DIR",
                               os.path.join(tmp, f"prof_run_{with_prof}")]
        if with_prof:
            opts += ["TRAIN.profile_dir", prof]
        trainer = CaptionDistillTrainer(setup_config(opts=opts), {"text": text}, clip_cfg,
                                        dataset=dataset, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        secs[with_prof] = time.perf_counter() - t0
    files = sorted(glob.glob(os.path.join(prof, "**", "*.pt.trace.json"), recursive=True))
    names = set()
    for f in files:
        with open(f) as fh:
            names |= {e.get("name", "") for e in json.load(fh).get("traceEvents", [])
                      if e.get("cat") == "kernel"}
    rows = {"attn_block_bf16 (QKV GEMM)": any("hopper_gemm<0>" in n for n in names),
            "mlp_bf16 (fc GEMM)": any("hopper_gemm<1>" in n for n in names),
            "their LayerNorm": any("ln_bf16_rows" in n for n in names)}
    size = sum(os.path.getsize(f) for f in files)
    log(f"[profiler] TRAIN.profile_dir: {len(files)} trace file(s), {size / 2 ** 20:.2f} MiB, "
        f"{len(names)} kernel names; rows 1-2's launches named: {rows}; train() of 8 steps "
        f"{secs[False]:.3f} s without the window, {secs[True]:.3f} s with it (trace written) on "
        f"{card}")
    if not files or not any(rows.values()):
        raise AssertionError("[profiler] no trace, or it names no block kernel")
    return dict(files=len(files), bytes=size, secs=secs)


def zeroshot_cli(img_dir, paths, card):
    """python -m leclip_tpu_torch.cli.zeroshot in a fresh process for RN50
    and ViT-B/16 (seeded random fp32 weights) over the phase's JPEGs: its
    --out JSON against the same scoring here with DenseFlags(
    attention_impl="xla") (1e-4 of max(1, max|ref|)), the launches the CLI
    prints (ViT: resident_attention in each of 12 layers), images/s."""
    import argparse

    from leclip_tpu_torch.cli.eval import load_clip
    from leclip_tpu_torch.cli.zeroshot import zero_shot_scores, zero_shot_text_features
    from leclip_tpu_torch.data.vocab import COCO_OBJECT_CATEGORIES
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.ops.preprocess import preprocess_eval
    from leclip_tpu_torch.runtime import jpeg

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out, total = {}, None
    for backbone, path in ZEROSHOT_BACKBONES:
        out_json = os.path.join(os.path.dirname(img_dir),
                                f"zeroshot_{backbone.replace('/', '')}.json")
        cmd = [sys.executable, "-m", "leclip_tpu_torch.cli.zeroshot", "--backbone", backbone,
               "--images-dir", img_dir, "--out", out_json, "--batch-size", str(len(paths)),
               "--device", DEVICE.type]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=600)
        whole = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"[zeroshot:{backbone}] exit {run.returncode}:\n{run.stdout}\n"
                                 f"{run.stderr}")
        scored = re.search(r"scored (\d+) images in ([\d.]+) s", run.stdout)
        counts = json.loads(re.search(r"^kernel launches: (.*)$", run.stdout, re.M).group(1))
        expect_launches(f"[zeroshot:{backbone}] the CLI's process", counts, path, 12,
                        rn32_forwards=None if backbone.startswith("RN") else 0)
        with open(out_json) as f:
            got = json.load(f)
        clip_cfg, params = load_clip(setup_config(), argparse.Namespace(weights="",
                                                                        backbone=backbone), DEVICE)
        text_feats = zero_shot_text_features(params, clip_cfg, COCO_OBJECT_CATEGORIES)
        images = torch.stack([preprocess_eval(torch.tensor(im, device=DEVICE),
                                              clip_cfg.image_resolution)
                              for im in jpeg.decode_batch(paths)])
        ref = zero_shot_scores(params, clip_cfg, images, text_feats, attention_impl="xla")
        mine = np.asarray([got[os.path.basename(p)] for p in paths])
        err, ok = within(mine, ref)
        n, secs = int(scored.group(1)), float(scored.group(2))
        out[backbone] = dict(rate=n / secs, whole=whole, counts=counts)
        log(f"[zeroshot:{backbone}] CLI in a fresh process: {n} JPEGs scored in {secs:.3f} s = "
            f"{n / secs:.1f} images/s (decode, preprocess, towers, scores; the whole command "
            f"{whole:.2f} s); --out scores {mine.shape} against attention_impl=\"xla\" here: "
            f"max|d| {err:.3g} (<= 1e-4 of max(1, max|ref|)); kernels the CLI's process launched "
            f"{counts} on {card}")
        if not (ok and n == len(paths) and np.isfinite(mine).all()):
            raise AssertionError(f"[zeroshot:{backbone}] the CLI's scores disagree")
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
    return total, out


def caption_eval_check(clip_cfg, text, toks, card):
    """score_caption_benchmark over 1,024 synthetic captions, six members
    (RN50 text, phase 6's weights) and an 8,192-row bank: fp32, then the
    tower in bf16 (rows 1-2 in each layer); bf16 against fp32 (correlation
    >= 0.999 over every output), fp32 against the CPU port on the first 64
    captions (1e-4 of max(1, max|ref|)); warm captions/s."""
    from leclip_tpu_torch.device import cast_floating, tree_map
    from leclip_tpu_torch.inference.caption_eval import score_caption_benchmark
    from leclip_tpu_torch.ops import launches

    specs = build_members({"text": text}, clip_cfg, torch.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(81)
    bank = torch.nn.functional.normalize(
        torch.randn(BANK_ROWS, clip_cfg.embed_dim, generator=gen, device=DEVICE), dim=-1)
    caps = toks[:CAPTION_EVAL_ROWS]
    res, counts, rate = {}, {}, {}
    for prec, tower in (("fp32", text), ("bf16", cast_floating(text, torch.bfloat16))):
        score_caption_benchmark({"text": tower}, clip_cfg, specs, caps[:256], bank,
                                device=DEVICE)  # first use of each kernel and library
        launches.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[prec] = score_caption_benchmark({"text": tower}, clip_cfg, specs, caps, bank,
                                            device=DEVICE)
        torch.cuda.synchronize()
        rate[prec] = len(caps) / (time.perf_counter() - t0)
        counts[prec] = launches.launch_counts()
        expect_launches(f"[caption-eval:{prec}]", counts[prec],
                        "bf16" if prec == "bf16" else "plain", 12 * math.ceil(len(caps) / 256))

    def flat(r):
        return np.concatenate([r[0][m][k].ravel() for m in sorted(r[0]) for k in sorted(r[0][m])]
                              + [r[1].ravel()])

    corr = float(np.corrcoef(flat(res["bf16"]), flat(res["fp32"]))[0, 1])
    cpu = lambda t: t.cpu()  # noqa: E731
    t0 = time.perf_counter()
    ref, ref_sims = score_caption_benchmark(
        {"text": tree_map(cpu, text)}, clip_cfg, specs, caps[:CAPTION_EVAL_CPU_ROWS], bank.cpu(),
        device="cpu")
    cpu_s = time.perf_counter() - t0
    out32, sims32 = res["fp32"]
    errs = [within(out32[m][k][:CAPTION_EVAL_CPU_ROWS], ref[m][k]) for m in ref for k in ref[m]]
    errs.append(within(sims32[:CAPTION_EVAL_CPU_ROWS], ref_sims))
    shapes = {k: v.shape for k, v in out32[next(iter(out32))].items()}
    log(f"[caption-eval] score_caption_benchmark over {len(caps)} captions, {len(specs)} members, "
        f"a {BANK_ROWS}-row bank: outputs {shapes}, sims {sims32.shape}; captions/s fp32 "
        f"{rate['fp32']:.1f}, bf16 {rate['bf16']:.1f} (warm) on {card}; launches fp32 "
        f"{counts['fp32']}, bf16 {counts['bf16']}; bf16 against fp32 correlation {corr:.6f} "
        f"(>= 0.999); fp32 against the CPU port on {CAPTION_EVAL_CPU_ROWS} captions max|d| "
        f"{max(e for e, _ in errs):.3g} (<= 1e-4 of max(1, max|ref|)); CPU {cpu_s:.1f} s")
    if not (corr >= 0.999 and all(ok for _, ok in errs) and np.isfinite(flat(res["bf16"])).all()):
        raise AssertionError("[caption-eval] the benchmark disagrees")
    return counts["bf16"], rate


def phase_flow(card, inputs, trained):
    """Phase 8: validate on phase 6's fp32 RN50 trainer (its image tower
    added; 64 val images at 305 crops) and on a ViT-B/16 trainer of 2 steps
    (16 images; resident_attention in every layer), the adapter trainer,
    the optimizer menu, the profiler window, the native JPEG decoder, the
    zero-shot CLI and the caption benchmark. Returns ({path: launches},
    {part: results})."""
    from leclip_tpu_torch.data.datasets import CaptionDataset
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillTrainer
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params

    toks = inputs[2]
    text, clip_cfg, dataset, trainer = (trained[k] for k in ("text", "clip_cfg", "dataset",
                                                             "trainer"))
    gen_np = np.random.default_rng(80)
    tmp = tempfile.mkdtemp(prefix="leclip_phase8_")
    secs, res, launched = {}, {}, {}

    def part(key, fn, *args):
        t0 = time.perf_counter()
        res[key] = fn(*args)
        secs[key] = time.perf_counter() - t0

    t0 = time.perf_counter()
    try:
        img_dir = os.path.join(tmp, "jpegs")
        os.makedirs(img_dir)
        paths = []
        for i, blob in enumerate(jpeg_blobs(FLOW_IMAGES, gen_np)):
            paths.append(os.path.join(img_dir, f"img{i:02d}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(blob)
        part("decoder", decoder_check, paths, card)

        # validate on phase 6's trainer with an RN50 image tower added (fp32,
        # seeded random, random BN statistics)
        gen = torch.Generator(device=DEVICE).manual_seed(82)
        visual = randomize_bn(init_clip_params(gen, PRESETS["RN50"], device=DEVICE)["visual"],
                              gen)
        trainer.clip_params = dict(trainer.clip_params, visual=visual)
        part("validate:rn50", validate_run, "rn50", trainer, paths, FLOW_IMAGES, "plain", card)
        trainer.clip_params = {"text": trainer.clip_params["text"]}
        del visual

        # a ViT-B/16 trainer (fp32) of 2 steps, validated on 16 images
        vcfg = PRESETS["ViT-B/16"]
        vparams = init_clip_params(torch.Generator(device=DEVICE).manual_seed(83), vcfg,
                                   device=DEVICE)
        vit = CaptionDistillTrainer(
            setup_config(opts=TRAIN_RECIPE + ["OPTIM.MAX_EPOCH", "1", "OUTPUT_DIR",
                                              os.path.join(tmp, "vit")]),
            vparams, vcfg, device=DEVICE,
            dataset=CaptionDataset(toks[:2048], caption_labels(toks[:2048]), [],
                                   dataset.classnames))
        vit.train()
        part("validate:vit", validate_run, "vit-b16", vit, paths, VIT_VAL_IMAGES, "fp32", card)
        launched["validate"] = {k: res["validate:rn50"]["counts"][k]
                                + res["validate:vit"]["counts"][k]
                                for k in res["validate:vit"]["counts"]}
        del vit, vparams
        torch.cuda.empty_cache()

        part("adapter", adapter_phase, clip_cfg, text, dataset, card, tmp)
        launched["adapter"] = res["adapter"][0]
        part("optimizers", optimizer_phase, trainer.state.params, card, tmp)
        part("profiler", profiler_check, clip_cfg, text, dataset, card, tmp)
        part("zeroshot", zeroshot_cli, img_dir, paths, card)
        launched["zeroshot"] = res["zeroshot"][0]
        part("caption-eval", caption_eval_check, clip_cfg, text, toks, card)
        launched["caption_eval"] = res["caption-eval"][0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[phase8] {time.perf_counter() - t0:.1f} s in all: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    return launched, res


# ------------------------------ phase 9 --------------------------------------
# dual-encoder fine-tuning (engine/finetune.py): resident_attention under
# autograd at the fine-tune shape, the full-width ViT-B/16 step on the
# resident route against the plain one, fit_pairs over synthetic JPEGs with
# the augmentation on the card and a resume, and RN101, the second member

FT_BATCH = 64
FT_WARM_STEPS = 3          # warm steps held against the "xla" route, after one warm-up
FT_PAIRS = 256             # JPEGs rendered by data/synth_images.py
FT_SIZES = ((384, 512), (512, 384), (448, 448), (480, 512))  # each fits the bucket
FT_BUCKET = (512, 512)
FT_LR = 1e-5               # the JAX package's default
FT_REL = 1e-4              # resident route against xla, each step: loss, grad norm, gradients
FT_DREL = 1e-3             # ... and the parameters' change, in norm (ft_update_rel)
FT_ATTN = (FT_BATCH, 200, 12, 197)   # ViT-B/16 in training: [64, 200, 768], kv_len 197
RN101_BATCH = 32
RN101_LR = 1e-6
FT_STAGES = ("augmentation (on the card)", "image tower forward", "text tower forward (remat)",
             "loss forward + backward", "image tower backward",
             "text tower backward (remat recompute)", "optimizer (clip + AdamW)")


def ft_attention(fa, gen, card):
    """resident_attention under autograd at the fine-tune shape: the output
    against its plain version and dq/dk/dv against autograd through
    packed_attention_reference (which its backward recomputes), on q/k/v
    that are the thirds of one packed qkv leaf, as attention_from_qkv hands
    them over; forward + backward timed beside the plain version's autograd,
    SDPA's and the bound."""
    b, t, heads, kv = FT_ATTN
    w = 64 * heads
    qkv = torch.randn(b, t, 3 * w, generator=gen, device=DEVICE).requires_grad_()
    cot = torch.randn(b, t, w, generator=gen, device=DEVICE)

    def run(fn):
        q, k, v = qkv.split(w, dim=-1)
        out = fn(q, k, v, heads, kv)
        return out, torch.autograd.grad(out, (q, k, v), cot)

    log(f"[finetune] resident_attention under autograd: q/k/v [{b}, {t}, {w}] fp32 ({heads} "
        f"heads of 64), kv_len {kv}, forward + backward")
    out, got = run(fa.resident_attention)
    err = check_attn("resident_attention (fine-tune shape)", out.detach(),
                     fa.resident_attention_plain(*(y.detach() for y in qkv.split(w, dim=-1)),
                                                 heads, kv))
    _, want = run(fa.packed_attention_reference)
    g_err = max((a - r).abs().max().item() for a, r in zip(got, want))
    log(f"  resident_attention backward: max|dq, dk, dv - autograd through "
        f"packed_attention_reference| = {g_err:.3g} (tolerance 1e-6; reason: the backward "
        "recomputes that reference, so only the library's sums could differ)")
    if not all(torch.isfinite(a).all() for a in got) or g_err > 1e-6:
        raise AssertionError("resident_attention: gradient disagrees at the fine-tune shape")

    def sdpa(q, k, v, n_heads, kv_len):
        out = lib_sdpa(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads), kv_len, False)
        return out.transpose(1, 2).reshape(q.shape)

    # forward (QK^T, PV) and backward (dV, dP, dQ, dK): six products of
    # B·H·T·kv_len·64 multiply-adds; q, k, v and the cotangent read once,
    # the output and three gradients written once
    pairs = b * heads * t * kv * 64
    bnd = bound_s(12 * pairs / PEAK_FP32_FLOPS, 8 * b * t * w * 4)
    res = dict(max_abs_err=err, grad_max_abs_err=g_err,
               ms=cuda_ms(lambda: run(fa.resident_attention), 5),
               plain_ms=cuda_ms(lambda: run(fa.resident_attention_plain), 3),
               library_ms=cuda_ms(lambda: run(sdpa), 5), bound_ms=bnd[0], bound_by=bnd[1],
               shape=f"[{b}, {t}, {w}] fp32, kv_len {kv}, forward + backward under autograd")
    log(f"  resident_attention forward + backward: kernel route {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, SDPA {res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} "
        f"ms ({res['bound_by']}) on {card}")
    return res


def _flat_leaves(tree):
    from leclip_tpu_torch.engine.train_state import _tree

    out = []
    _tree(out.append, tree)
    return out


def _like_leaves(tree, leaves):
    from leclip_tpu_torch.engine.train_state import _tree

    it = iter(leaves)
    return _tree(lambda _: next(it), tree)


def ft_step_split(tuner, raw, card, reps=3):
    """One warm raw-batch step of ``tuner`` split by CUDA events into
    FT_STAGES (the median of ``reps``): the same computation as
    raw_train_step, its backward taken in two parts (the loss to the
    features, then each tower from its features), held against the tuner's
    own gradient norm on the same images; the state is left as it was."""
    from leclip_tpu_torch.engine.finetune import MAX_LOGIT_SCALE, global_norm
    from leclip_tpu_torch.models.clip import clip_encode_image, clip_encode_text
    from leclip_tpu_torch.ops.preprocess import preprocess_train_batch, sample_train

    cfg, size = tuner.clip_cfg, tuner.clip_cfg.image_resolution
    u8, content, toks = (torch.as_tensor(raw[k], device=DEVICE)
                         for k in ("image_u8", "content", "tokens"))
    state = tuner.state
    runs = []
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(FT_STAGES) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        gen = torch.Generator(device=DEVICE).manual_seed(r)
        images = preprocess_train_batch(u8, content, sample_train(gen, (u8.shape[0],), size,
                                                                  device=DEVICE), size=size)
        ev[1].record()
        with torch.enable_grad():
            live = {k: _like_leaves(v, [t.detach().requires_grad_() for t in _flat_leaves(v)])
                    for k, v in state.params.items() if k != "logit_scale"}
            live["logit_scale"] = state.params["logit_scale"].detach().requires_grad_()
            img = clip_encode_image(live, cfg, images, impl=tuner._impl)
            ev[2].record()
            txt = clip_encode_text(live, cfg, toks, impl=tuner._impl, remat=tuner._remat)
            ev[3].record()
            img_d, txt_d = img.detach().requires_grad_(), txt.detach().requires_grad_()
            a = img_d / img_d.norm(dim=-1, keepdim=True)
            bt = txt_d / txt_d.norm(dim=-1, keepdim=True)
            logits = live["logit_scale"].clamp(max=MAX_LOGIT_SCALE).exp() * a @ bt.t()
            labels = torch.arange(logits.shape[0], device=DEVICE)
            loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))
            g_img, g_txt, g_scale = torch.autograd.grad(loss, (img_d, txt_d, live["logit_scale"]))
            ev[4].record()
            g_vis = torch.autograd.grad(img, _flat_leaves(live["visual"]), g_img)
            ev[5].record()
            g_text = torch.autograd.grad(txt, _flat_leaves(live["text"]), g_txt)
            ev[6].record()
        grads = {"visual": _like_leaves(state.params["visual"], g_vis),
                 "text": _like_leaves(state.params["text"], g_text), "logit_scale": g_scale}
        with torch.no_grad():
            tuner.optimizer.update(grads, state.opt_state, state.params)
        ev[7].record()
        torch.cuda.synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(FT_STAGES))])
    _, _, want = tuner._loss_and_grads(state.params, images, toks)
    gn, gn_want = global_norm(grads).item(), global_norm(want).item()
    if abs(gn - gn_want) > 1e-5 * gn_want:
        raise AssertionError(f"finetune split: gradient norm {gn} against the tuner's {gn_want}")
    ms = np.median(np.asarray(runs[1:]), axis=0)
    total = float(ms.sum())
    log(f"[finetune:split] one warm ViT-B/16 fp32 step of batch {u8.shape[0]} from raw "
        f"{tuple(u8.shape[1:3])} uint8, median of {reps}, on {card} (gradient norm {gn:.6g}, the "
        f"tuner's {gn_want:.6g}):")
    for name, t in zip(FT_STAGES, ms):
        log(f"  {t:9.3f} ms  {100 * t / total:5.1f}%  {name}")
    log(f"  {total:9.3f} ms  in all: {u8.shape[0] / total * 1e3:.1f} images/s")
    return dict(zip(FT_STAGES, (float(t) for t in ms)))


def _path_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _path_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def ft_update_rel(after, ref_after, start):
    """How far one route's parameter change from ``start`` strays from the
    reference route's, Δ = after − start: (‖Δ − Δref‖ / ‖Δref‖ over the
    tree, and the largest |Δ − Δref| less one fp32 spacing of the
    reference's value over the largest |Δref|). The key third of each
    qkv_bias is left out: its gradient is 0 in exact arithmetic (a softmax
    ignores a shift of every logit of a row), so Adam turns each route's
    rounding noise there into a step of its own."""
    gap2, ref2, gap, moved = 0.0, 0.0, 0.0, 0.0
    for (path, a), (_, r), (_, p0) in zip(*(_path_leaves(t) for t in (after, ref_after, start))):
        d, dr = (a - p0).float() - (r - p0).float(), (r - p0).float()
        e = ((a - r).abs() - (torch.nextafter(r.abs(), r.abs() + 1) - r.abs())).clamp(min=0)
        if path.endswith("qkv_bias"):
            w = d.shape[-1] // 3
            d[..., w:2 * w] = 0
            e[..., w:2 * w] = 0
        gap = max(gap, e.max().item())
        moved = max(moved, dr.abs().max().item())
        gap2 += d.square().sum().item()
        ref2 += dr.square().sum().item()
    return (gap2 / ref2) ** 0.5, gap / moved


def ft_grads_rel(tuners, params, images, toks):
    """Both routes' gradients at the same parameters: the largest over the
    leaves of max|g − g_xla| / max|g_xla| of the leaf, and that leaf."""
    grads = {impl: dict(_path_leaves(t._loss_and_grads(params, images, toks)[2]))
             for impl, t in tuners.items()}
    return max(((a - grads["xla"][k]).abs().max().item()
                / max(grads["xla"][k].abs().max().item(), 1e-30), k)
               for k, a in grads["auto"].items())


def ft_routes(cfg, card):
    """The full-width step: ViT-B/16 fp32, batch 64, remat on the text tower,
    one warm-up and FT_WARM_STEPS warm train_steps on the "auto" route
    (resident_attention in every image layer) and on attention_impl="xla",
    in step. Before each step both routes' gradients at the auto route's
    parameters, leaf by leaf, within FT_REL of the leaf's largest; after it
    the loss and the gradient norm within FT_REL, and the parameters' change
    from the start within FT_DREL in norm (ft_update_rel; its largest
    element is reported: an element whose gradient is near Adam's eps, 1e-8,
    steps by lr·g/eps, so there the kernel's rounding of the gradient is
    seen at ~1e-9 / 1e-8 of a step). Returns (launches of the auto steps,
    results)."""
    from leclip_tpu_torch.engine.finetune import CLIPFineTuner
    from leclip_tpu_torch.models.clip import init_clip_params
    from leclip_tpu_torch.ops import launches

    params = init_clip_params(torch.Generator(device=DEVICE).manual_seed(90), cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(91)
    res_ = cfg.image_resolution
    images = torch.randn(FT_BATCH, res_, res_, 3, generator=gen, device=DEVICE)
    toks = torch.as_tensor(synthetic_captions(FT_BATCH, np.random.default_rng(91)), device=DEVICE)
    tuners = {impl: CLIPFineTuner(params, cfg, lr=FT_LR, warmup_steps=0, total_steps=100,
                                  remat=True, attention_impl=impl, device=DEVICE)
              for impl in ("auto", "xla")}
    start = tuners["xla"].state.params
    del params
    steps = {impl: [] for impl in tuners}
    peak = dict.fromkeys(tuners, 0.0)
    counts = {impl: dict.fromkeys(launches.launch_counts(), 0) for impl in tuners}
    gaps = []
    for i in range(1 + FT_WARM_STEPS):
        g_rel, g_leaf = ft_grads_rel(tuners, tuners["auto"].state.params, images, toks)
        for impl, tuner in tuners.items():
            launches.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tuner.state, m = tuner.train_step(tuner.state, images, toks)
            torch.cuda.synchronize()
            steps[impl].append(((time.perf_counter() - t0) * 1e3, m["loss"].item(),
                                m["grad_norm"].item()))
            counts[impl] = {k: v + launches.launch_counts()[k] for k, v in counts[impl].items()}
            peak[impl] = max(peak[impl], torch.cuda.max_memory_allocated() / 2 ** 30)
        (_, la, na), (_, lx, nx) = steps["auto"][-1], steps["xla"][-1]
        gaps.append((abs(la - lx) / abs(lx), abs(na - nx) / abs(nx), g_rel, g_leaf,
                     *ft_update_rel(tuners["auto"].state.params, tuners["xla"].state.params,
                                    start)))
    rows = {}
    for impl in tuners:
        ms = float(np.median([s[0] for s in steps[impl][1:]]))
        log(f"[finetune:{impl}] ViT-B/16 fp32 train_step, batch {FT_BATCH}, remat text: losses "
            f"{[round(s[1], 6) for s in steps[impl]]}, gradient norms "
            f"{[round(s[2], 5) for s in steps[impl]]}; warm step {ms:.1f} ms "
            f"({FT_BATCH / ms * 1e3:.1f} images/s), peak memory {peak[impl]:.2f} GiB (both "
            f"routes' tuners resident), launches {counts[impl]} on {card}")
        rows[impl] = dict(steps=steps[impl], ms=ms, peak_gib=peak[impl])
    expect_launches("finetune auto route", counts["auto"], "fp32", 12 * (1 + FT_WARM_STEPS))
    expect_launches("finetune xla route", counts["xla"], "plain", 0)
    fmt = lambda j: [f"{g[j]:.3g}" for g in gaps]  # noqa: E731
    log(f"[finetune] resident route against xla at each of {1 + FT_WARM_STEPS} steps: loss rel "
        f"{fmt(0)}, gradient norm rel {fmt(1)}, gradients at the same parameters max|d| / "
        f"max|g| of the worst leaf {fmt(2)} ({[g[3] for g in gaps]}) (each <= {FT_REL:g}); "
        f"the parameters' change from the start, ||d|| / ||change|| {fmt(4)} (each <= "
        f"{FT_DREL:g}), largest element's max|d| / max|change| {fmt(5)} (reported), the key "
        "bias aside; reason: the kernel's fp32 sums in another order")
    if not all(g[0] <= FT_REL and g[1] <= FT_REL and g[2] <= FT_REL and g[4] <= FT_DREL
               for g in gaps):
        raise AssertionError("finetune: the resident route disagrees with the xla route")
    return counts["auto"], dict(auto=rows["auto"], xla=rows["xla"], gaps=gaps)


def ft_pairs(cfg, tmp, card):
    """fit_pairs end to end: FT_PAIRS JPEGs rendered by data/synth_images.py
    with their captions, PairBatcher (bucket 512, the native decoder), 2
    epochs with checkpoints, a fresh tuner that resumes at epoch 2 with the
    same step and parameters (bitwise) and takes a third epoch; the
    augmentation runs on the card inside each step. Returns (launches,
    results, one raw batch for the step split, the tuner)."""
    from PIL import Image

    from leclip_tpu_torch.data.loader import PairBatcher
    from leclip_tpu_torch.data.synth_images import make_labeled_images
    from leclip_tpu_torch.data.vocab import COCO_OBJECT_CATEGORIES
    from leclip_tpu_torch.engine.finetune import CLIPFineTuner
    from leclip_tpu_torch.models.clip import init_clip_params
    from leclip_tpu_torch.ops import launches
    from leclip_tpu_torch.runtime import jpeg

    t0 = time.perf_counter()
    imgs, _, caps = make_labeled_images(FT_PAIRS, COCO_OBJECT_CATEGORIES, seed=92, sizes=FT_SIZES)
    paths = []
    for i, im in enumerate(imgs):
        paths.append(os.path.join(tmp, f"pair{i:03d}.jpg"))
        Image.fromarray(im).save(paths[-1], quality=90)
    render_s = time.perf_counter() - t0
    batcher = PairBatcher(paths, captions=caps, batch_size=FT_BATCH, bucket=FT_BUCKET)
    if not batcher.native:
        raise AssertionError(f"PairBatcher: the native decoder did not load: {jpeg.failure()}")
    steps = batcher.steps_per_epoch()
    out = os.path.join(tmp, "run")
    gen = torch.Generator(device=DEVICE).manual_seed(93)

    def tuner():
        return CLIPFineTuner(init_clip_params(gen, cfg, device=DEVICE), cfg, lr=FT_LR,
                             warmup_steps=2, total_steps=3 * steps, device=DEVICE)

    first = tuner()
    saves = []  # (seconds, bytes) of each of fit_pairs' own per-epoch checkpoints

    def timed_save(*args, _save=first.save, **kwargs):
        t1 = time.perf_counter()
        path = _save(*args, **kwargs)
        saves.append((time.perf_counter() - t1, os.path.getsize(path)))
        return path

    first.save = timed_save
    launches.reset_launch_counts()
    jpeg.reset_decode_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first.fit_pairs(batcher, epochs=2, output_dir=out, log_every=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, decoded = launches.launch_counts(), jpeg.decode_counts()
    expect_launches("fit_pairs", counts, "fp32", 12 * 2 * steps, resizes=2 * steps)
    save_s = sum(t for t, _ in saves)
    ckpt_bytes = saves[-1][1]
    loop_s = wall - save_s
    rows = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    losses = [r["value"] for r in rows if r["tag"] == "finetune/loss"]
    ckpts = sorted(f for f in os.listdir(os.path.join(out, "clip_finetune"))
                   if f.startswith("model.ckpt"))
    log(f"[finetune:fit_pairs] {FT_PAIRS} synthetic JPEGs ({render_s:.1f} s to render and "
        f"write), batch {FT_BATCH}, bucket {FT_BUCKET}: 2 epochs of {steps} steps in {wall:.2f} "
        f"s, of which two checkpoints of {ckpt_bytes / 2 ** 30:.2f} GiB (params and Adam's "
        f"moments) {save_s:.2f} s ({', '.join(f'{t:.2f}' for t, _ in saves)}); the loop "
        f"without them "
        f"{2 * steps * FT_BATCH / loop_s:.1f} images/s (decode and augmentation included), "
        f"losses {[round(v, 5) for v in losses]}, checkpoints {ckpts}, decoders {decoded}, "
        f"launches {counts} on {card}")
    if (first.state.step != 2 * steps or len(losses) != 2 * steps or len(saves) != 2
            or not all(np.isfinite(losses)) or ckpts != ["model.ckpt-0", "model.ckpt-1"]
            or decoded["pil_jpeg"] != 0 or decoded["native"] != 2 * steps * FT_BATCH):
        raise AssertionError("fit_pairs: wrong steps, losses, checkpoints or decoders")

    second = tuner()
    start = second.resume(out)
    same = trees_equal(second.state.params, first.state.params) and trees_equal(
        second.state.opt_state, first.state.opt_state)
    launches.reset_launch_counts()
    second.fit_pairs(batcher, epochs=3, output_dir=out, log_every=steps)
    torch.cuda.synchronize()
    resumed = launches.launch_counts()
    expect_launches("fit_pairs resumed", resumed, "fp32", 12 * steps, resizes=steps)
    log(f"[finetune:fit_pairs] a fresh tuner resumed at epoch {start}, step "
        f"{2 * steps} -> {second.state.step} after a third epoch; parameters and optimizer state "
        f"equal to the first run's: {same}")
    if start != 2 or not same or second.state.step != 3 * steps:
        raise AssertionError("fit_pairs: the resume did not pick up where the run ended")
    total = {k: counts[k] + resumed[k] for k in counts}
    raw = next(iter(batcher.epoch(0)))
    del first
    return total, dict(wall_s=wall, save_s=save_s, images_per_s=2 * steps * FT_BATCH / loop_s,
                       losses=losses), raw, second


def ft_rn101(card):
    """The second member of config 4: RN101 fp32 at batch 32, two
    train_steps on one batch; the loss finite and lower after them. Adam's
    first steps move each of RN101's ~56M weights by about the learning
    rate, so the rate is RN101_LR: at 1e-4 the first step overshoots on a
    repeated batch (the loss rises before it falls)."""
    from leclip_tpu_torch.engine.finetune import CLIPFineTuner, clip_contrastive_loss
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
    from leclip_tpu_torch.ops import launches

    cfg = PRESETS["RN101"]
    gen = torch.Generator(device=DEVICE).manual_seed(94)
    tuner = CLIPFineTuner(init_clip_params(gen, cfg, device=DEVICE), cfg, lr=RN101_LR,
                          warmup_steps=0, total_steps=100, device=DEVICE)
    res_ = cfg.image_resolution
    images = torch.randn(RN101_BATCH, res_, res_, 3, generator=gen, device=DEVICE)
    toks = torch.as_tensor(synthetic_captions(RN101_BATCH, np.random.default_rng(94)),
                           device=DEVICE)
    launches.reset_launch_counts()
    losses, times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tuner.state, m = tuner.train_step(tuner.state, images, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    with torch.no_grad():
        losses.append(clip_contrastive_loss(tuner.state.params, cfg, images, toks)[0].item())
    counts = launches.launch_counts()
    # every RN101 convolution and global pool product on conv_fp32: two
    # forwards under autograd, one without
    expect_launches("finetune RN101", counts, "plain", 0, rn32_forwards=3,
                    rn32_launches=3 + 3 * sum(cfg.vision_layers) + 4 + POOL_PRODUCTS["global"])
    log(f"[finetune:rn101] RN101 fp32 ({cfg.vision_layers} bottlenecks), batch {RN101_BATCH}: "
        f"losses {[round(v, 6) for v in losses]} (before step 1, before step 2, after), step ms "
        f"{[round(t, 1) for t in times]}; launches {counts} on {card}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("finetune RN101: the loss is not finite or did not fall")
    return dict(losses=losses, ms=times, counts=counts)


def phase_finetune(card, fa):
    """Phase 9: dual-encoder fine-tuning on the card. Returns (launches of
    the fine-tuning paths, results)."""
    from leclip_tpu_torch.models.clip import PRESETS

    cfg = PRESETS["ViT-B/16"]
    gen = torch.Generator(device=DEVICE).manual_seed(95)
    secs, res = {}, {}
    tmp = tempfile.mkdtemp(prefix="leclip_phase9_")
    t0 = time.perf_counter()
    try:
        def part(key, fn, *args):
            t1 = time.perf_counter()
            res[key] = fn(*args)
            secs[key] = time.perf_counter() - t1
            torch.cuda.empty_cache()

        part("attention", ft_attention, fa, gen, card)
        part("routes", ft_routes, cfg, card)
        part("pairs", ft_pairs, cfg, tmp, card)
        pair_counts, res["pairs"], raw, tuner = res["pairs"]
        part("split", ft_step_split, tuner, raw, card)
        del tuner
        part("rn101", ft_rn101, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[phase9] {time.perf_counter() - t0:.1f} s in all: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    counts = {k: res["routes"][0][k] + pair_counts[k] + res["rn101"]["counts"][k]
              for k in pair_counts}
    return counts, res


# ------------------------------ phase 10 -------------------------------------
# The data mesh (leclip_tpu_torch/parallel/): the real entry points as NCCL
# ranks started by torchrun, one a card. NCCL refuses two ranks on one card,
# so one card runs world 1 (every collective still goes through NCCL);
# world 2 runs where the machine has two cards. The cross-rank arithmetic of
# world 2 and 4 is held on the CPU over gloo by tests/test_torch_multigpu.py.

MESH_TRAIN_STEPS = 4       # a rank's steps an epoch at batch 1024
MESH_TRAIN_BATCH = 1024
MESH_FT_STEPS = 2
MESH_SCORE_BATCHES = 3
MESH_TIMEOUT_S = 420       # the torchrun launch, world 1 and world 2 each


def mesh_trainer_part(mesh, card, shared):
    """CaptionDistillTrainer on the mesh: the RN50 text tower (12x512, fp32
    weights from a seed) under TRAINER.PREC bf16, whose caption branch runs
    attn_block_bf16 + mlp_bf16, MESH_TRAIN_STEPS steps of MESH_TRAIN_BATCH
    captions a rank: prefetch 0 (the launches counted), prefetch 2 (bitwise
    the same parameters), prefetch 0 again, at world 1 a trainer without a
    process group (bitwise the same: the all-reduce of one rank is the
    identity), the ranks' parameters gathered and compared bit for bit, the
    checkpoints rank 0 alone writes into the ranks' ``shared`` directory, and
    a fresh mesh trainer that resumes from them."""
    from leclip_tpu_torch.data.datasets import CaptionDataset
    from leclip_tpu_torch.data.vocab import COCO_OBJECT_CATEGORIES
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillTrainer
    from leclip_tpu_torch.models.clip import PRESETS
    from leclip_tpu_torch.models.text import init_text_params
    from leclip_tpu_torch.ops import launches
    from leclip_tpu_torch.parallel.mesh import fetch_global, local_mesh

    clip_cfg = PRESETS["RN50"]
    text = init_text_params(torch.Generator(device=DEVICE).manual_seed(100), clip_cfg.vocab_size,
                            clip_cfg.context_length, clip_cfg.transformer_width,
                            clip_cfg.transformer_layers, clip_cfg.embed_dim, device=DEVICE)
    toks = synthetic_captions(MESH_TRAIN_STEPS * MESH_TRAIN_BATCH * mesh.world,
                              np.random.default_rng(100))
    dataset = CaptionDataset(toks, caption_labels(toks), [], list(COCO_OBJECT_CATEGORIES))
    recipe = TRAIN_RECIPE + ["TRAINER.PREC", "bf16", "OPTIM.MAX_EPOCH", "1",
                             "TRAIN.CHECKPOINT_FREQ", "1",
                             "DATALOADER.BATCH_SIZE_TRAIN", str(MESH_TRAIN_BATCH)]

    def run(tag, extra, mesh_, resume=False):
        out = os.path.join(shared, "resumed" if resume else tag.replace(" ", "_"))
        cfg = setup_config(opts=recipe + extra + ["OUTPUT_DIR", out,
                                                  "RESUME", os.path.join(shared, "prefetch_0")])
        trainer = CaptionDistillTrainer(cfg, {"text": text}, clip_cfg, dataset=dataset, mesh=mesh_)
        if trainer.caption_route != "bf16" or trainer.batcher.num_shards != mesh_.world:
            raise AssertionError(f"[mesh:train] {tag}: caption branch {trainer.caption_route}, "
                                 f"{trainer.batcher.num_shards} shards")
        launches.reset_launch_counts()
        torch.cuda.synchronize(DEVICE)
        t0 = time.perf_counter()
        state = trainer.train(resume=resume)
        torch.cuda.synchronize(DEVICE)
        return state, time.perf_counter() - t0, launches.launch_counts(), out

    run("warm-up", [], mesh)  # first use of every kernel and library
    s0, t_inline, counts, out0 = run("prefetch 0", [], mesh)
    expect_launches("[mesh:train] prefetch 0", counts, "bf16", 12 * MESH_TRAIN_STEPS)
    s2, t_pre, _, _ = run("prefetch 2", ["TRAIN.prefetch_batches", "2"], mesh)
    s0b, t_inline2, _, _ = run("prefetch 0 again", [], mesh)
    same_prefetch = trees_equal(s2.params, s0.params) and trees_equal(s0b.params, s0.params)
    flat = torch.cat(flat_tree(s0.params))
    ranks = fetch_global(flat[None], mesh)
    same_ranks = bool((ranks == ranks[0]).all()) and bool(np.isfinite(ranks).all())
    same_plain = None
    if mesh.world == 1:
        sp, _, _, _ = run("no process group", [], local_mesh(DEVICE))
        same_plain = trees_equal(sp.params, s0.params)
    ckpts = sorted(os.listdir(os.path.join(out0, "prompt_learner")))
    # a fresh trainer resumes from the rank-0 checkpoint: epoch 1 of 2
    s_res, _, _, _ = run("resume", ["OPTIM.MAX_EPOCH", "2"], mesh, resume=True)
    ms = lambda secs: 1e3 * secs / MESH_TRAIN_STEPS  # noqa: E731
    log(f"[mesh:train] RN50 text 12x512, caption branch bf16, {MESH_TRAIN_STEPS} steps of "
        f"{MESH_TRAIN_BATCH} captions a rank (global {MESH_TRAIN_BATCH * mesh.world}), world "
        f"{mesh.world} over NCCL: train() {ms(t_inline):.2f} / {ms(t_inline2):.2f} ms a step "
        f"inline (before / after), {ms(t_pre):.2f} ms with prefetch 2 (one checkpoint write "
        f"in each), on {card}; prefetch 2 bitwise equal: {same_prefetch}; ranks bitwise "
        f"equal: {same_ranks}; equal to the trainer without a process group: {same_plain}; "
        f"rank-0 checkpoints {ckpts}; resumed at epoch 1 to step {s_res.step}; launches "
        f"{counts}")
    if not (same_prefetch and same_ranks and same_plain in (None, True)
            and s_res.step == 2 * MESH_TRAIN_STEPS):
        raise AssertionError("[mesh:train] the data-parallel trainer failed a check")
    if ckpts != ["checkpoint", "model.ckpt-0"]:
        raise AssertionError(f"[mesh:train] rank 0 wrote {ckpts}")
    return counts, dict(ms_inline=ms(t_inline), ms_inline_again=ms(t_inline2),
                        ms_prefetch=ms(t_pre), prefetch_bitwise=same_prefetch,
                        ranks_bitwise=same_ranks, plain_bitwise=same_plain)


def mesh_finetune_part(mesh, card):
    """CLIPFineTuner on the mesh: ViT-B/16 fp32, MESH_FT_STEPS steps of
    FT_BATCH pairs a rank with the loss over the global batch (features
    gathered with their gradient, the gradient all-reduced), resident_attention
    in every image layer: fit() with prefetch 0 (launches counted) and
    prefetch 2 (bitwise the same), and at world 1 the same steps without a
    process group, held to phase 9's bounds (loss and gradient norm within
    FT_REL, the parameters' change within FT_DREL in norm)."""
    from leclip_tpu_torch.engine.finetune import CLIPFineTuner
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
    from leclip_tpu_torch.ops import launches
    from leclip_tpu_torch.parallel.mesh import fetch_global, local_mesh

    cfg = PRESETS["ViT-B/16"]
    params = init_clip_params(torch.Generator(device=DEVICE).manual_seed(101), cfg, device=DEVICE)
    rng = np.random.default_rng(101 + mesh.rank)
    res_ = cfg.image_resolution
    batches = [{"image": rng.standard_normal((FT_BATCH, res_, res_, 3)).astype(np.float32),
                "tokens": synthetic_captions(FT_BATCH, rng)} for _ in range(MESH_FT_STEPS)]

    def run(prefetch, mesh_):
        tuner = CLIPFineTuner(params, cfg, lr=FT_LR, warmup_steps=0, total_steps=100,
                              remat=True, mesh=mesh_)
        metrics = []
        step = tuner.train_step

        def recording(state, images, tokens):
            new, m = step(state, images, tokens)
            metrics.append(m)
            return new, m

        tuner.train_step = recording
        launches.reset_launch_counts()
        torch.cuda.synchronize(DEVICE)
        t0 = time.perf_counter()
        state = tuner.fit(iter(batches), log_every=MESH_FT_STEPS, prefetch=prefetch)
        torch.cuda.synchronize(DEVICE)
        secs = time.perf_counter() - t0
        return state, [{k: float(v) for k, v in m.items()} for m in metrics], secs, \
            launches.launch_counts()

    s0, m0, t_first, counts = run(0, mesh)
    expect_launches("[mesh:finetune] prefetch 0", counts, "fp32", 12 * MESH_FT_STEPS)
    s2, m2, t2, _ = run(2, mesh)
    same_prefetch = trees_equal(s2.params, s0.params) and m2 == m0
    del s2
    s0b, _, t0, _ = run(0, mesh)  # inline again, timed warm as the prefetch run is
    same_prefetch = same_prefetch and trees_equal(s0b.params, s0.params)
    del s0b
    flat = torch.cat([t.reshape(-1)[:4096].float() for t in flat_tree(s0.params)])
    ranks = fetch_global(flat[None], mesh)
    same_ranks = bool((ranks == ranks[0]).all())
    gaps = None
    if mesh.world == 1:
        sp, mp, _, _ = run(0, local_mesh(DEVICE))
        # the tuners copy ``params``: it is still every run's start
        d_rel, e_rel = ft_update_rel(s0.params, sp.params, params)
        gaps = dict(loss=max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(m0, mp)),
                    grad_norm=max(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                                  for a, b in zip(m0, mp)),
                    change_norm=d_rel, change_elem=e_rel,
                    bitwise=trees_equal(sp.params, s0.params))
        del sp
    del s0
    log(f"[mesh:finetune] ViT-B/16 fp32, {MESH_FT_STEPS} steps of {FT_BATCH} pairs a rank "
        f"(global {FT_BATCH * mesh.world}), loss over the global batch: fit() "
        f"{1e3 * t_first / MESH_FT_STEPS:.1f} ms a step inline on first use, then "
        f"{1e3 * t2 / MESH_FT_STEPS:.1f} ms with prefetch 2 and {1e3 * t0 / MESH_FT_STEPS:.1f} "
        f"ms inline again (a fresh tuner each), on {card}; losses "
        f"{[round(m['loss'], 6) for m in m0]}; prefetch 2 bitwise equal: {same_prefetch}; "
        f"ranks bitwise equal: {same_ranks}; against the tuner without a process group "
        f"(loss rel, gradient norm rel, change ||d||/||change|| each <= {FT_REL:g} / "
        f"{FT_REL:g} / {FT_DREL:g}): {gaps}; launches {counts}")
    if not (same_prefetch and same_ranks and all(np.isfinite(m["loss"]) for m in m0)):
        raise AssertionError("[mesh:finetune] prefetch or ranks disagree")
    if gaps is not None and not (gaps["loss"] <= FT_REL and gaps["grad_norm"] <= FT_REL
                                 and gaps["change_norm"] <= FT_DREL):
        raise AssertionError("[mesh:finetune] the mesh step strays from the plain step")
    return counts, dict(ms_first=1e3 * t_first / MESH_FT_STEPS,
                        ms_inline=1e3 * t0 / MESH_FT_STEPS, ms_prefetch=1e3 * t2 / MESH_FT_STEPS,
                        prefetch_bitwise=same_prefetch, ranks_bitwise=same_ranks, plain=gaps)


def mesh_engine_part(mesh, card):
    """make_engine under TEST.PREC auto (int8 on the card) with the ViT-B/16
    weights and six members of phase 3, an 8,192-caption int8 bank
    row-sharded over the mesh (shard_bank=True, the ring kNN), the int8
    stack quantized with mesh= (broadcast from rank 0): MESH_SCORE_BATCHES
    staged batches of N_IMAGES 480x640 images (610 crops) against the engine
    without a mesh on the same inputs (within 1e-4 of max(1, max|ref|)),
    its launches counted; and the ring retrieval of one batch's crops timed
    against the replicated one."""
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.inference.pipeline import build_caption_bank, make_engine
    from leclip_tpu_torch.models.dense_clip import retrieval_augment
    from leclip_tpu_torch.ops import launches
    from leclip_tpu_torch.parallel.retrieval import retrieval_augment_sharded

    clip_cfg, params, toks, freq, images = main_inputs()
    bank = build_caption_bank(params, clip_cfg, toks, batch_size=256, precision="int8",
                              device=DEVICE)
    specs = build_members(params, clip_cfg, torch.bfloat16)
    cfg = setup_config(opts=["TEST.PREC", "auto", "TEST.multi_scale", "(2, 3, 4)",
                             "TEST.use_freq", "True"])
    engines = {tag: make_engine(cfg, params, clip_cfg, specs, caption_bank=bank,
                                freq_stats=freq, device=DEVICE, mesh=m, shard_bank=sb)
               for tag, m, sb in (("mesh", mesh, True), ("plain", None, False))}
    del params
    got = {}
    for tag, engine in engines.items():
        if engine.precision != "int8" or engine._q8 is None:
            raise AssertionError(f"[mesh:engine] {tag}: precision {engine.precision}")
        list(engine.run_batches_fused_staged(iter([images])))  # first-call setup
        launches.reset_launch_counts()
        torch.cuda.synchronize(DEVICE)
        t0 = time.perf_counter()
        got[tag] = list(engine.run_batches_fused_staged(iter([images] * MESH_SCORE_BATCHES)))
        torch.cuda.synchronize(DEVICE)
        got[tag + "_s"] = time.perf_counter() - t0
        if tag == "mesh":
            counts = launches.launch_counts()
    expect_launches("[mesh:engine] scoring", counts, "int8", 12 * MESH_SCORE_BATCHES,
                    resizes=MESH_SCORE_BATCHES)
    eng = engines["mesh"]
    if eng.caption_bank.shape[0] != -(-BANK_ROWS // mesh.world):
        raise AssertionError(f"[mesh:engine] bank shard of {eng.caption_bank.shape[0]} rows")
    errs = [within(a, b) for a, b in zip(got["mesh"], got["plain"])]
    same_codes = trees_equal(eng._q8, engines["plain"]._q8)
    # the retrieval of one batch's crops: ring over the sharded bank against
    # the replicated search of the whole bank
    crops = N_IMAGES * (1 + eng.n_blocks)
    gf = torch.nn.functional.normalize(torch.randn(crops // mesh.world, clip_cfg.embed_dim,
                                                   generator=torch.Generator(
                                                       device=DEVICE).manual_seed(102),
                                                   device=DEVICE), dim=-1).to(torch.bfloat16)
    full = engines["plain"].caption_bank
    ring_ms = cuda_ms(lambda: retrieval_augment_sharded(
        gf, eng.caption_bank, eng.topk, mesh, n_valid=eng._bank_n_valid,
        bank_rows=eng._bank_rows), 10)
    rep_ms = cuda_ms(lambda: retrieval_augment(gf, full, eng.topk), 10)
    ring = retrieval_augment_sharded(gf, eng.caption_bank, eng.topk, mesh,
                                     n_valid=eng._bank_n_valid, bank_rows=eng._bank_rows)
    rep = retrieval_augment(gf, full, eng.topk)
    r_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(ring, rep))
    rate = lambda secs: MESH_SCORE_BATCHES * crops / secs  # noqa: E731
    log(f"[mesh:engine] ViT-B/16 TEST.PREC auto -> int8, shard_bank over world {mesh.world}: "
        f"bank {BANK_ROWS} rows, {eng.caption_bank.shape[0]} a rank; {MESH_SCORE_BATCHES} "
        f"batches of {crops} crops: mesh {rate(got['mesh_s']):.1f} crop-forwards/s, without "
        f"a mesh {rate(got['plain_s']):.1f}, on {card}; fused scores against the engine "
        f"without a mesh max|d| {[round(e, 9) for e, _ in errs]} (each within 1e-4 of "
        f"max(1, max|ref|)); int8 codes and scales equal: {same_codes}; launches {counts}; "
        f"retrieval of {crops // mesh.world} crops a rank: ring {ring_ms:.4f} ms, replicated "
        f"{rep_ms:.4f} ms, max|d| {r_err:.3g}")
    if not (all(ok for _, ok in errs) and same_codes and r_err <= 1e-4):
        raise AssertionError("[mesh:engine] the mesh engine disagrees with the plain engine")
    return counts, dict(ring_ms=ring_ms, replicated_ms=rep_ms, errs=[e for e, _ in errs],
                        crops_per_s_mesh=rate(got["mesh_s"]),
                        crops_per_s_plain=rate(got["plain_s"]))


def phase10_rank(out_dir):
    """One rank of phase 10, started by torchrun: joins the NCCL group from
    torchrun's variables (it raises if it cannot), runs the three parts in
    ``out_dir``, which every rank shares, and on rank 0 writes their launches
    and results there."""
    global DEVICE
    from leclip_tpu_torch.parallel import multihost
    from leclip_tpu_torch.parallel.mesh import data_mesh

    t0 = time.perf_counter()
    if not multihost.initialize():
        raise AssertionError("phase 10: no torchrun variables, the process group was not joined")
    mesh = data_mesh()
    DEVICE = mesh.device
    if torch.distributed.get_backend() != "nccl" or mesh.device.type != "cuda":
        raise AssertionError(f"phase 10: backend {torch.distributed.get_backend()}, {mesh}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[mesh] rank {mesh.rank} of {mesh.world} on {mesh.device} over NCCL "
        f"(torch {torch.__version__}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))})")
    multihost.barrier()
    parts, secs = {}, {}
    for key, fn, args in (("train", mesh_trainer_part, (mesh, card, out_dir)),
                          ("finetune", mesh_finetune_part, (mesh, card)),
                          ("engine", mesh_engine_part, (mesh, card))):
        t1 = time.perf_counter()
        parts[key] = fn(*args)
        secs[key] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    multihost.barrier()
    if mesh.rank == 0:
        counts = {k: sum(c[k] for c, _ in parts.values()) for k in parts["train"][0]}
        with open(os.path.join(out_dir, "phase10.json"), "w") as f:
            json.dump({"world": mesh.world, "counts": counts,
                       "parts": {k: r for k, (_, r) in parts.items()},
                       "part_counts": {k: c for k, (c, _) in parts.items()},
                       "secs": secs, "rank_secs": time.perf_counter() - t0}, f)
    multihost.shutdown()
    return 0


def launch_phase10(world, out_dir):
    """torchrun --standalone --nproc_per_node world chip_smoke.py --phase10:
    the ranks' output echoed, a non-zero exit or an overrun raised."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", os.path.abspath(__file__), "--phase10", out_dir]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MESH_TIMEOUT_S,
                              env=env)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"phase 10 world {world}: torchrun overran {MESH_TIMEOUT_S} s:\n"
                             f"{(e.stdout or '')[-4000:]}\n{(e.stderr or '')[-4000:]}") from e
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 10 world {world}: torchrun exited {proc.returncode}:\n"
                             f"{proc.stderr[-6000:]}")
    with open(os.path.join(out_dir, "phase10.json")) as f:
        res = json.load(f)
    if res["world"] != world:
        raise AssertionError(f"phase 10: ran world {res['world']}, launched {world}")
    res["launch_s"] = time.perf_counter() - t0
    return res


def phase_mesh(card):
    """Phase 10: the data-parallel trainer, fine-tuner and mesh engine as
    NCCL ranks under torchrun: world 1 on one card, worlds 2 and 4 where
    there are that many cards. Returns (launches of world 1's main paths,
    results)."""
    t0 = time.perf_counter()
    res = {}
    for world in (1, 2, 4):
        if world > torch.cuda.device_count():
            log(f"[phase10] world {world}: not run ({torch.cuda.device_count()} card"
                f"{'s' if torch.cuda.device_count() > 1 else ''})")
            continue
        tmp = tempfile.mkdtemp(prefix=f"leclip_phase10_world{world}_")
        try:
            res[world] = launch_phase10(world, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    r1 = res[1]
    log(f"[phase10] world 1 launches of rows 1-6: {r1['counts']}; parts {r1['secs']}; "
        f"torchrun {r1['launch_s']:.1f} s, the rank {r1['rank_secs']:.1f} s of it")
    log(f"[phase10] {time.perf_counter() - t0:.1f} s in all on {card}")
    return r1["counts"], res


KERNEL_SOURCES = {  # name: (source, file:line of the TPU kernel, its precision path)
    "attn_block_bf16": ("leclip_tpu_torch/csrc/attn_block_bf16.cu",
                        "leclip_tpu/ops/block_kernels.py:122", "bf16"),
    "mlp_bf16": ("leclip_tpu_torch/csrc/mlp_bf16.cu",
                 "leclip_tpu/ops/block_kernels.py:185", "bf16"),
    "ln_quant": ("leclip_tpu_torch/csrc/ln_quant.cu",
                 "leclip_tpu/ops/quant_kernels.py:65", "int8"),
    "attn_block_int8": ("leclip_tpu_torch/csrc/attn_block_int8.cu",
                        "leclip_tpu/ops/quant_kernels.py:160", "int8"),
    "mlp_int8": ("leclip_tpu_torch/csrc/mlp_int8.cu",
                 "leclip_tpu/ops/quant_kernels.py:238", "int8"),
}
# the unfused attention kernels: (source, TPU kernel, the path that launches
# them, the headers that hold their cores)
ATTN_SOURCES = {
    "resident_attention": ("leclip_tpu_torch/csrc/resident_attention.cu",
                           "leclip_tpu/ops/flash_attention.py:210",
                           "TEST.PREC fp32: image tower, every layer",
                           ["leclip_tpu_torch/csrc/attn_simt.cuh (fp32)",
                            "leclip_tpu_torch/csrc/attn_core.cuh (bf16)"]),
    "flash_attention": ("leclip_tpu_torch/csrc/flash_attention.cu",
                        "leclip_tpu/ops/flash_attention.py:257",
                        'TEST.PREC fp32 + DenseFlags(attention_impl="pallas"): prompt-feature '
                        "text pass and image tower, every layer",
                        ["leclip_tpu_torch/csrc/attn_simt.cuh (fp32)",
                         "leclip_tpu_torch/csrc/flash_mma.cuh (bf16)"]),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--phase10"]:  # one rank of phase 10, started by torchrun
        return phase10_rank(sys.argv[2])
    from leclip_tpu_torch.ops import _build
    from leclip_tpu_torch.ops import block_kernels as bk
    from leclip_tpu_torch.ops import flash_attention as fa
    from leclip_tpu_torch.ops import quant_kernels as qk

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

    check_sass(_build)
    if sys.argv[1:2] == ["--only-phase10"]:  # the build and phase 10 alone, no result line
        phase_mesh(card)
        return 0

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    kern = phase_kernels_bf16(bk, gen)
    kern8 = phase_kernels_int8(qk, gen)
    for tag in kern:
        kern[tag].update(kern8[tag])
    kern_attn = phase_kernels_attention(fa, gen)
    resize = phase_resize(card)
    pool = phase_avg_pool(card)
    launch_ms = phase_launch_times(card)
    inputs = main_inputs()
    total, bank_counts, score_counts, _, vit = phase_main_paths(card, inputs)
    total_attn, fp32_bank_counts, counts_a, counts_b = phase_unfused_paths(card, inputs)
    torch.cuda.empty_cache()
    total_rn, rn_bank_counts, _, rn, rn_conv, rn_conv32 = phase_rn50(card, inputs)
    for k, n in total_rn.items():
        total[k] = total.get(k, 0) + n
    # phase 7 runs on phases 3 and 5's engines, which are freed before phase 6
    total7, _ = phase_dump_bank_service(card, inputs, vit, rn)
    del vit, rn
    for k, n in total7.items():
        total[k] = total.get(k, 0) + n
    torch.cuda.empty_cache()
    train_counts, _, trained = phase_train(card, inputs)
    for k, n in train_counts.items():
        total[k] = total.get(k, 0) + n
    # phase 8 continues on phase 6's fp32 trainer
    flow, _ = phase_flow(card, inputs, trained)
    del trained
    flow_total = {k: sum(c[k] for c in flow.values()) for k in total}
    for k, n in flow_total.items():
        total[k] = total.get(k, 0) + n
    torch.cuda.empty_cache()
    ft_counts, ft = phase_finetune(card, fa)
    torch.cuda.empty_cache()
    mesh_counts, _ = phase_mesh(card)
    for k in KERNEL_SOURCES:
        total[k] += mesh_counts[k]

    line = {"kernels": []}
    for k, (src, replaces, prec) in KERNEL_SOURCES.items():
        vit, text, train = kern["vit"][k], kern["text"][k], kern["train"][k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": total[k],
            "max_abs_err": max(vit["max_abs_err"], text["max_abs_err"], train["max_abs_err"]),
            "ms": vit["ms"], "plain_ms": vit["plain_ms"], "bound_ms": vit["bound_ms"],
            "bound_by": vit["bound_by"], "library_ms": vit["library_ms"],
            "shape": f"ViT-B/16 image tower [{N_IMAGES * 305}, 200, 768]",
            "text_shape": "caption bank [256, 77, 512] causal",
            "text": {key: text[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by")},
            "train_shape": "trainer's caption branch [1024, 77, 512] causal",
            "train": {key: train[key] for key in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                                  "bound_ms", "bound_by")},
            "path": f"TEST.PREC {prec}" + (" (ViT-B/16); RN50 TEST.PREC auto, its caption bank"
                                           if prec == "bf16" else ""),
            "launches_bank": bank_counts[prec][k], "launches_scoring": score_counts[prec][k],
            **({"launches_rn50_bank": rn_bank_counts[k]} if prec == "bf16" else {}),
            "launches_train": train_counts[k],
            "launches_phase7": total7[k],
            "launches_phase10": mesh_counts[k],
            **{f"launches_{path}": flow[path][k] for path in ("validate", "adapter", "zeroshot",
                                                               "caption_eval")},
            **({"device_ms": vit["device_ms"], "text_device_ms": text["device_ms"]}
               if "device_ms" in vit else {}),
            **({"launch_ms": launch_ms[k]} if k in launch_ms else {}),
        })
    for k, (src, replaces, path, headers) in ATTN_SOURCES.items():
        variants = kern_attn[k]
        main_v = variants["vit fp32"]  # the shape and dtype the main path gives it
        line["kernels"].append({
            "name": k, "route": "cuda", "source": src, "headers": headers, "replaces": replaces,
            "launches": total_attn[k] + total7[k] + flow_total[k] + ft_counts[k] + mesh_counts[k],
            "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
            **{key: main_v[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")},
            "shape": f"ViT-B/16 image tower [{N_IMAGES * 305}, 200, 768], 12 heads, kv_len 197, "
                     "fp32",
            "variants": variants, "path": path,
            "launches_fp32_bank": fp32_bank_counts[k], "launches_path_a": counts_a[k],
            "launches_path_b": counts_b[k], "launches_phase7": total7[k],
            **{f"launches_{path}": flow[path][k] for path in ("validate", "adapter", "zeroshot",
                                                               "caption_eval")},
            "launches_finetune": ft_counts[k],
            "launches_phase10": mesh_counts[k],
            **({"finetune": ft["attention"],
                "finetune_path": "CLIPFineTuner.train_step / fit_pairs, ViT-B/16 fp32 image "
                                 "tower: 12 launches per image forward, the backward "
                                 "recomputes packed_attention_reference"}
               if k == "resident_attention" else {}),
        })
    main_r = resize[next(iter(RESIZE_SHAPES))]
    line["kernels"].append({
        "name": "resize_band", "route": "cuda", "source": "leclip_tpu_torch/csrc/resize_band.cu",
        "replaces": "XLA's dense products (leclip_tpu/ops/resize_matmul.py), no Pallas kernel",
        "launches": sum(c["resize_band"] for c in (total, counts_a, counts_b, ft_counts,
                                                   mesh_counts)),
        **{key: main_r[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        "shape": next(iter(RESIZE_SHAPES)), "variants": resize,
        "path": "every scored batch's crops (TTAEngine._crops), the train transform "
                "(preprocess_train_batch)",
    })
    line["kernels"].append({
        "name": "avg_pool_nhwc", "route": "cuda",
        "source": "leclip_tpu_torch/csrc/avg_pool_nhwc.cu",
        "replaces": "XLA's reduce_window (leclip_tpu/models/resnet.py avg_pool), no Pallas "
                    "kernel",
        "launches": sum(c["avg_pool"] for c in (total, counts_a, counts_b, ft_counts,
                                                mesh_counts)),
        **{key: pool["bf16"]["total"][key] for key in ("ms", "device_ms", "library_ms",
                                                        "bound_ms", "bound_by", "differ")},
        "plain_ms": pool["bf16"]["total"]["library_ms"],
        "shape": f"RN50 trunk: its {RN_POOLS} pools, summed, at {N_IMAGES * 305} crops of "
                 "224x224, bf16 (the plain version is the library's pool)",
        "variants": pool,
        "path": "every ResNet tower forward on the card (7 a forward), bf16 and fp32, and "
                "under autograd",
    })
    t = rn_conv["totals"]
    line["kernels"].append({
        "name": "conv_bf16", "route": "cuda", "source": "leclip_tpu_torch/csrc/conv_bf16.cu",
        "replaces": "XLA conv (leclip_tpu/models/resnet.py:30), no Pallas kernel",
        "launches": total["conv_bf16"], "max_abs_err": t["max_abs_err"],
        **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": f"RN50 trunk: its {RN50_CONVS} convolutions, summed, at {N_IMAGES * 305} "
                 "crops of 224x224 (the engine's own crops), the epilogue off",
        "library": "cuDNN bf16 (F.conv2d in bf16, resnet.conv2d_native)",
        "fused_ms": t["fused_ms"], "fused_library_ms": t["fused_library_ms"],
        "fused_bound_ms": t["fused_bound_ms"],
        "fused": "the 55 resnet.conv_bn calls with batch norm (+ residual) (+ ReLU) in the "
                 "epilogue; library: cuDNN bf16 + the unfused chain",
        "exact_share": t["exact"],
        "trunk_ms": rn_conv["trunk_ms"], "batch_ms": rn_conv["batch_ms"],
        "trunk_before_ms": rn_conv["trunk_before_ms"],
        "path": "RN50 TEST.PREC auto (bf16): the image tower, every convolution",
        "launches_scoring": rn_conv["counts"]["conv_bf16"], "launches_phase7": total7["conv_bf16"],
    })
    t = rn_conv32["totals"]
    launches32 = {"scoring": rn_conv32["counts"]["conv_fp32"],
                  **{path: flow[path]["conv_fp32"] for path in ("validate", "zeroshot")},
                  "finetune_rn101": ft_counts["conv_fp32"]}
    line["kernels"].append({
        "name": "conv_fp32", "route": "cuda", "source": "leclip_tpu_torch/csrc/conv_fp32.cu",
        "replaces": "XLA conv (leclip_tpu/models/resnet.py:30), no Pallas kernel",
        "launches": sum(launches32.values()), "max_abs_err": t["max_abs_err"],
        **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": f"RN50 trunk: its {RN50_CONVS} convolutions, summed, at {N_IMAGES * 305} "
                 "crops of 224x224 (the fp32 engine's own crops), the epilogue off",
        "library": "cuDNN fp32, TF32 off (F.conv2d, resnet.conv2d_native)",
        "fused_ms": t["fused_ms"], "fused_library_ms": t["fused_library_ms"],
        "fused_bound_ms": t["fused_bound_ms"],
        "fused": "the 55 resnet.conv_bn calls with batch norm (+ residual) (+ ReLU) in the "
                 "epilogue; library: cuDNN fp32 + the unfused chain",
        "worst_of_tolerance": t["worst"], "exact_share": t["exact"],
        "products": t["products"], "tile_witness": rn_conv32["tile_witness"],
        "trunk_ms": rn_conv32["trunk_ms"], "batch_ms": rn_conv32["batch_ms"],
        "trunk_before_ms": rn_conv32["trunk_before_ms"],
        "path": "RN50 TEST.PREC fp32, validate, zero-shot RN50, RN101 fine-tuning: every "
                f"convolution and pool product ({RN50_FP32} a dense RN50 forward: "
                f"{RN50_CONVS} convolutions, {POOL_PRODUCTS['dense']} products)",
        **{f"launches_{k}": v for k, v in launches32.items()},
    })
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
