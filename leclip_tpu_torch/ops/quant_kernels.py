"""W8A8 transformer sub-blocks (inference): hand-written Hopper kernels and
their plain PyTorch versions (counterpart of leclip_tpu/ops/quant_kernels.py).

* ``ln_quant`` — LayerNorm + per-row absmax + int8 round in one pass:
  (int8 [..., D], fp32 scale [..., 1]) with LN(x) ≈ x_i8 · s. Replaces
  ``ln_quant`` (``_ln_quant_kernel``). CUDA source: ``csrc/ln_quant.cu``.
* ``attn_block_int8`` — x + OutProj(MHA(int8 QKV(LN(x)))): LN → per-row int8
  → int8×int8→int32 QKV → ``acc·(s_row·s_col) + b`` → the bf16 attention core
  and out-projection of ``attn_block_bf16``. Replaces ``attn_block_int8``
  (``_attn_block_kernel``). CUDA source: ``csrc/attn_block_int8.cu``.
* ``mlp_int8`` — x + int8 proj(requantize(QuickGELU(int8 fc(LN(x))))), the
  hidden kept in fp32 and requantized per row over its whole 4D width.
  Replaces ``mlp_int8`` (``_mlp_int8_kernel``). CUDA source:
  ``csrc/mlp_int8.cu``. ``mlp_int8_with_hidden`` also returns the hidden
  codes and scales the proj product read.

Per-row quantization needs the absmax of a whole row before the first
product, so the LN cannot ride a GEMM's tile loads as it does in the bf16
kernels: the ``ln_quant`` kernel is the first launch of both blocks (their C
entries launch it, into scratch the block's wrapper already allocates, and
the block's wrapper counts it in ``ln_quant.launches``), and the int8 rows +
one scale per row go through HBM, half the bytes of bf16. The MLP's
requantization needs the absmax of the fp32 hidden row, 3072 wide at ViT-B/16: the fc product is
run twice — once for the row absmax, once to quantize with the known scale —
which is bit-identical to staging the fp32 hidden (integer sums are exact)
and moves a quarter of the bytes. Every int8 product of both blocks runs on
one GEMM, ``csrc/gemm_int8.cuh``: wgmma on the int8 tensor cores fed by TMA,
with the rescale, QuickGELU, quantizer and residual in the accumulator
registers in the TPU kernels' fp32 order; its epilogue and the ``ln_quant``
row pass use branch-free forms of the divisions that give the same values
(``csrc/quant.cuh``), which ``int8_exact_forms_check`` verifies on the card.
What bounds each kernel on the H100 is in the note at the top of its source.

Each wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. The kernels are
forward-only: an input that requires grad under grad mode raises on both
devices (``block_kernels.refuse_grad``). ``launches`` on each wrapper counts
the calls that launched the kernel. The CUDA kernels take
bf16 activations and parameters, int8 weights in the kernel layout of
ops/quant.py (``kernel_layout``), widths D % 128 == 0 up to 1024, hidden
% 128 == 0, head width 32, 64 or 128, and any row count."""

from __future__ import annotations

import torch

from . import _build
from .block_kernels import _check, _ln32, _raise_on, _stream, attention_plain, refuse_grad
from .quant import int_matmul, quantize_rows

# ------------------------------ plain versions -------------------------------


def ln_quant_plain(x, scale, bias, eps: float = 1e-5):
    """fp32 LayerNorm, then symmetric per-row int8 quantization (the
    quantizer of ops/quant.py: true division, round half to even, clip after
    the round)."""
    return quantize_rows(_ln32(x.float(), scale, bias, eps))


def attn_block_int8_plain(x, ln_scale, ln_bias, qkv_wi8, qkv_s, qkv_b, out_w, out_b,
                          n_heads: int, kv_len=None, causal: bool = False,
                          eps: float = 1e-5) -> torch.Tensor:
    """The TPU kernel's arithmetic, same rounding points: LN rows quantized,
    exact integer QKV product, ``acc·(s_row·s_col) + b`` in fp32 rounded to
    x.dtype, then the attention core, fp32 out-proj and the residual sum
    rounded once, exactly as the bf16 block."""
    b, t, d = x.shape
    if kv_len is None:
        kv_len = t
    dt = x.dtype
    x32 = x.float()
    yi, s = quantize_rows(_ln32(x32, ln_scale, ln_bias, eps))
    qkv = int_matmul(yi.reshape(b * t, d), qkv_wi8) * (s.reshape(b * t, 1) * qkv_s.float()[None])
    qkv = (qkv + qkv_b.float()[None]).to(dt)
    att = attention_plain(qkv, b, t, n_heads, kv_len, causal)
    out = (att.float() @ out_w.float()).reshape(b, t, d)
    return (x32 + out + out_b.float()).to(dt)


def mlp_int8_plain(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b,
                   eps: float = 1e-5) -> torch.Tensor:
    """The TPU kernel's arithmetic: LN rows quantized, exact integer fc,
    rescale + bias + QuickGELU in fp32 (never rounded to bf16), the whole
    hidden row requantized, exact integer proj, rescale + bias, the residual
    sum rounded once."""
    return _mlp_int8_parts_plain(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b,
                                 eps)[0]


def _mlp_int8_parts_plain(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b, eps):
    """(out, hidden codes [rows, H] int8, hidden scales [rows, 1] fp32)."""
    shape = x.shape
    d = shape[-1]
    x32 = x.reshape(-1, d).float()
    yi, s = quantize_rows(_ln32(x32, ln_scale, ln_bias, eps))
    h = int_matmul(yi, fc_wi8) * (s * fc_s.float()[None]) + fc_b.float()[None]
    h = h * torch.sigmoid(1.702 * h)
    hi, hs = quantize_rows(h)
    o = int_matmul(hi, pj_wi8) * (hs * pj_s.float()[None])
    o = o + pj_b.float()[None]
    return (x32 + o).to(x.dtype).reshape(shape), hi, hs


# --------------------------------- wrappers ----------------------------------


def check_kernel_widths(name: str, d: int, hidden: int) -> None:
    """Raise for a width the CUDA int8 kernels do not take."""
    if d % 128 or d > 1024 or hidden % 128:
        raise ValueError(f"{name}: the CUDA int8 kernels need D % 128 == 0, D <= 1024 and "
                         f"hidden % 128 == 0, got D={d}, hidden={hidden}")


def _check_weight(name: str, w: torch.Tensor, shape, device) -> None:
    """int8 [K, N] on ``device`` in the kernel layout (K contiguous)."""
    if w.dtype != torch.int8:
        raise TypeError(f"{name}: the CUDA kernel takes int8, got {w.dtype}")
    if w.device != device:
        raise ValueError(f"{name}: on {w.device}, expected {device}")
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(w.shape)}, expected {tuple(shape)}")
    if not w.t().is_contiguous():
        raise ValueError(f"{name}: int8 weights must be in the kernel layout (K contiguous "
                         "per output channel): ops.quant.quantize_weight returns it, "
                         "ops.quant.kernel_layout converts to it")


def ln_quant(x, scale, bias, eps: float = 1e-5):
    """LayerNorm + symmetric per-row int8 quantization over [..., D].
    Returns (x_i8 [..., D], s [..., 1] fp32) with LN(x) ≈ x_i8 · s."""
    refuse_grad("ln_quant", x, scale, bias)
    if x.device.type == "cpu":
        return ln_quant_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_quant: unsupported device {x.device}")
    d = x.shape[-1]
    if d % 128 or d > 1024:
        raise ValueError(f"ln_quant: CUDA kernel needs D % 128 == 0 and D <= 1024, got D={d}")
    dev = x.device
    for name, ten, shape in (("x", x, x.shape), ("scale", scale, (d,)), ("bias", bias, (d,))):
        _check(f"ln_quant {name}", ten, shape, dev)
    rows = x.numel() // d
    xi = torch.empty(x.shape, dtype=torch.int8, device=dev)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=dev)
    rc = _build.load("ln_quant").leclip_ln_quant(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), xi.data_ptr(), s.data_ptr(),
        rows, d, float(eps), _stream(dev))
    _raise_on(rc, "ln_quant")
    ln_quant.launches += 1
    return xi, s


ln_quant.launches = 0


def attn_block_int8(x, ln_scale, ln_bias, qkv_wi8, qkv_s, qkv_b, out_w, out_b,
                    n_heads: int, kv_len=None, causal: bool = False,
                    eps: float = 1e-5) -> torch.Tensor:
    """x + OutProj(Attention(int8 QKV(LN(x)))) over [B, T, D]; ``qkv_wi8``
    [D, 3D] int8 with per-channel scales ``qkv_s`` [3D], ``out_w`` [D, D] in
    [in, out] layout. ``kv_len`` masks trailing pad keys; ``causal`` adds
    the lower-triangular mask."""
    refuse_grad("attn_block_int8", x, ln_scale, ln_bias, qkv_wi8, qkv_s, qkv_b, out_w, out_b)
    if x.device.type == "cpu":
        return attn_block_int8_plain(x, ln_scale, ln_bias, qkv_wi8, qkv_s, qkv_b, out_w, out_b,
                                     n_heads, kv_len=kv_len, causal=causal, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"attn_block_int8: unsupported device {x.device}")
    b, t, d = x.shape
    kv_len = t if kv_len is None else int(kv_len)
    dh = d // n_heads
    if d % 128 or d > 1024 or dh * n_heads != d or dh not in (32, 64, 128):
        raise ValueError(f"attn_block_int8: CUDA kernel needs D % 128 == 0, D <= 1024 and "
                         f"head width 32/64/128, got D={d}, heads={n_heads}")
    if not 1 <= kv_len <= t:
        raise ValueError(f"attn_block_int8: kv_len {kv_len} outside [1, {t}]")
    dev = x.device
    for name, ten, shape in (("x", x, x.shape), ("ln_scale", ln_scale, (d,)),
                             ("ln_bias", ln_bias, (d,))):
        _check(f"attn_block_int8 {name}", ten, shape, dev)
    _check_weight("attn_block_int8 qkv_wi8", qkv_wi8, (d, 3 * d), dev)
    _check("attn_block_int8 qkv_s", qkv_s, (3 * d,), dev, torch.float32)
    for name, ten, shape in (("qkv_b", qkv_b, (3 * d,)), ("out_w", out_w, (d, d)),
                             ("out_b", out_b, (d,))):
        _check(f"attn_block_int8 {name}", ten, shape, dev)
    lib = _build.load("attn_block_int8")
    smem = lib.leclip_attn_core_smem(t, dh)
    if smem > 232448:
        raise ValueError(f"attn_block_int8: T={t} needs {smem} B of shared memory, "
                         "above the card's 227 KB")
    qkv = torch.empty((b * t, 3 * d), dtype=x.dtype, device=dev)
    att = torch.empty((b * t, d), dtype=x.dtype, device=dev)  # first holds the LN rows' codes
    out = torch.empty_like(x)
    rc = lib.leclip_attn_block_int8(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), qkv_wi8.data_ptr(),
        qkv_s.data_ptr(), qkv_b.data_ptr(), out_w.data_ptr(), out_b.data_ptr(), qkv.data_ptr(),
        att.data_ptr(), out.data_ptr(), b, t, d, n_heads, kv_len, int(bool(causal)), float(eps),
        _stream(dev))
    _raise_on(rc, "attn_block_int8")
    attn_block_int8.launches += 1
    ln_quant.launches += 1  # the block's first launch is the ln_quant kernel
    return out


attn_block_int8.launches = 0


def mlp_int8(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b,
             eps: float = 1e-5) -> torch.Tensor:
    """x + MLP(LN(x)) over [..., D] with int8 weight products; fc [D, H],
    proj [H, D] int8 with per-channel scales. Rows are independent, so any
    leading shape is flattened."""
    refuse_grad("mlp_int8", x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b)
    if x.device.type == "cpu":
        return mlp_int8_plain(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b,
                              eps=eps)
    return _mlp_int8_cuda(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b, eps)[0]


def mlp_int8_with_hidden(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b,
                         eps: float = 1e-5):
    """:func:`mlp_int8`, also returning the requantized hidden the proj
    product read: (out, codes [rows, H] int8, scales [rows, 1] fp32)."""
    refuse_grad("mlp_int8", x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b)
    if x.device.type == "cpu":
        return _mlp_int8_parts_plain(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s,
                                     pj_b, eps)
    out, hi, rowmax = _mlp_int8_cuda(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s,
                                     pj_b, eps)
    # the kernel's quant_scale, max(absmax / 127, 1e-12), by a true division
    # (a Python-number divisor may become a product with its reciprocal)
    return out, hi, (rowmax[:, None] / torch.full((1, 1), 127.0, device=x.device)).clamp_min(1e-12)


def _mlp_int8_cuda(x, ln_scale, ln_bias, fc_wi8, fc_s, fc_b, pj_wi8, pj_s, pj_b, eps):
    if x.device.type != "cuda":
        raise ValueError(f"mlp_int8: unsupported device {x.device}")
    d = x.shape[-1]
    hidden = fc_wi8.shape[-1]
    check_kernel_widths("mlp_int8", d, hidden)
    dev = x.device
    rows = x.numel() // d
    _check_weight("mlp_int8 fc_wi8", fc_wi8, (d, hidden), dev)
    _check_weight("mlp_int8 pj_wi8", pj_wi8, (hidden, d), dev)
    _check("mlp_int8 fc_s", fc_s, (hidden,), dev, torch.float32)
    _check("mlp_int8 pj_s", pj_s, (d,), dev, torch.float32)
    _check("mlp_int8 fc_b", fc_b, (hidden,), dev)
    _check("mlp_int8 pj_b", pj_b, (d,), dev)
    for name, ten, shape in (("x", x, x.shape), ("ln_scale", ln_scale, (d,)),
                             ("ln_bias", ln_bias, (d,))):
        _check(f"mlp_int8 {name}", ten, shape, dev)
    lib = _build.load("mlp_int8")
    rowmax = torch.empty((rows,), dtype=torch.float32, device=dev)
    hi = torch.empty((rows, hidden), dtype=torch.int8, device=dev)
    out = torch.empty_like(x)  # first holds the LN rows' codes
    rc = lib.leclip_mlp_int8(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), fc_wi8.data_ptr(),
        fc_s.data_ptr(), fc_b.data_ptr(), pj_wi8.data_ptr(), pj_s.data_ptr(), pj_b.data_ptr(),
        rowmax.data_ptr(), hi.data_ptr(), out.data_ptr(), rows, d, hidden, float(eps),
        _stream(dev))
    _raise_on(rc, "mlp_int8")
    mlp_int8.launches += 1
    ln_quant.launches += 1  # the block's first launch is the ln_quant kernel
    return out, hi, rowmax


mlp_int8.launches = 0


def int8_exact_forms_check(device, n_pairs: int = 120_000_000, seed: int = 7):
    """(reciprocals, codes): how often the int8 GEMM epilogue's division-free
    forms (csrc/gemm_int8.cuh) differ, on the card, from the divisions they
    replace — over every fp32 in [1, 2^126], and over ``n_pairs`` seeded
    quantizer pairs, three in four within 4 ulps of a .5 boundary. The fc
    passes of ``mlp_int8`` are its function only if both are 0."""
    bad = torch.empty(2, dtype=torch.int64, device=device)
    rc = _build.load("mlp_int8").leclip_int8_exact_forms_check(seed, n_pairs, bad.data_ptr(),
                                                               _stream(device))
    _raise_on(rc, "int8_exact_forms_check")
    return tuple(bad.tolist())
