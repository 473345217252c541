"""Int8 (W8A8) weight preparation and plain matmuls (counterpart of
leclip_tpu/ops/quant.py).

Scheme — W8A8 dynamic quantization, the JAX package's, number for number:
* weights: symmetric per-output-channel int8 (``quantize_weight``), prepared
  once at engine / bank build;
* activations: symmetric per-row (per-token) int8 computed on the fly
  (``quantize_rows``; inside the kernels of ops/quant_kernels.py);
* accumulation in int32, the rescale ``s_x[m] * s_w[n]`` in fp32 with the
  bias add.

The pytree of ``quantize_block_stack`` has the JAX package's keys, shapes and
``[in, out]`` layout, so the two compare leaf by leaf. One thing differs in
memory only: int8 weights come back in the *kernel layout* — the ``[in,
out]`` tensor is a transposed view of a contiguous ``[out, in]`` buffer, so
every output channel's K values lie together, which is how the tensor-core
int8 product reads its B operand. ``kernel_layout`` puts any int8 weight
(e.g. one carried over from JAX by models/convert.py) into that layout.

Integer products are exact here: float64 holds K·127² for any K below 2³⁹
(fp32 would not: at K = 3072 the sums pass 2²⁴)."""

from __future__ import annotations

from typing import Optional

import torch


def kernel_layout(w_i8: torch.Tensor) -> torch.Tensor:
    """Same values and shape ``[..., K, N]``, stored with K contiguous for each
    output channel (what the CUDA int8 kernels require). A no-op for a tensor
    already laid out so."""
    return w_i8.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of a [..., K, N] kernel
    (leading axes, e.g. layers, are independent).

    Returns (w_i8 [..., K, N] in the kernel layout, s_w [..., N] fp32) with
    w ≈ w_i8 · s_w."""
    w32 = w.float()
    s = (w32.abs().amax(-2) / 127.0).clamp_min(1e-12)
    w_i8 = torch.round(w32 / s.unsqueeze(-2)).clamp(-127, 127).to(torch.int8)
    return kernel_layout(w_i8), s


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row (per-token) int8 quantization of [..., K] activations.

    Returns (x_i8, s_x [..., 1] fp32) with x ≈ x_i8 · s_x."""
    x32 = x.float()
    s = (x32.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
    x_i8 = torch.round(x32 / s).clamp(-127, 127).to(torch.int8)
    return x_i8, s


def int_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """Exact int8 × int8 product [..., K] @ [K, N], returned as fp32 (the
    integer sum rounded once to nearest-even, as an int32 → fp32 cast)."""
    return (x_i8.double() @ w_i8.double()).float()


def int8_matmul_prequant(x_i8: torch.Tensor, s_x: torch.Tensor, w_i8: torch.Tensor,
                         s_w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """``(x_i8 · s_x) @ (w_i8 · s_w) + bias`` with the activations already
    quantized: exact integer product, then ``acc · (s_x · s_w) + bias`` in
    fp32."""
    y = int_matmul(x_i8, w_i8) * (s_x * s_w.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w`` with dynamic per-row activation quantization; w_i8 / s_w
    from :func:`quantize_weight`."""
    x_i8, s_x = quantize_rows(x)
    return int8_matmul_prequant(x_i8, s_x, w_i8, s_w, bias, out_dtype)


def _equilibrate(ln_scale: torch.Tensor, ln_bias: torch.Tensor, kernel: torch.Tensor):
    """SmoothQuant-style channel equilibration (exact in real arithmetic):
    divide LN-output channel c by m_c and multiply the following kernel's
    input row c by m_c, m_c = sqrt(|gain_c| / mean|gain|). CLIP ViTs carry a
    few high-magnitude LN channels; per-token activation quantization sets
    the whole row's scale from the outlier and crushes every other channel.
    The sqrt split shares the outlier between the activation and weight
    quantizers. The new LN affine is cast back to the parameters' dtype (in
    bf16 it is rounded before any kernel sees it, as in the JAX package)."""
    g = ln_scale.float()
    m = torch.sqrt(g.abs().clamp_min(1e-6) / g.abs().mean(-1, keepdim=True).clamp_min(1e-6))
    m = m.clamp(1e-2, 1e4)
    ln_q = ((g / m).to(ln_scale.dtype), (ln_bias.float() / m).to(ln_bias.dtype))
    return ln_q, kernel * m[..., None].to(kernel.dtype)


def quantize_block_stack(blocks: dict) -> dict:
    """Quantize a stacked transformer block pytree (leading layer axis) into
    int8 kernels + fp32 scales, per layer and per output channel.

    The two LN→matmul boundaries (ln_1→qkv, ln_2→fc) are channel-equilibrated
    (:func:`_equilibrate`): the returned ``ln1`` / ``ln2`` entries REPLACE the
    block's own LN affines on the int8 path. The attention out-projection is
    not quantized (its input is the bf16 attention mix)."""
    ln1, qkv_eq = _equilibrate(blocks["ln_1"]["scale"], blocks["ln_1"]["bias"],
                               blocks["attn"]["qkv_kernel"])
    ln2, fc_eq = _equilibrate(blocks["ln_2"]["scale"], blocks["ln_2"]["bias"],
                              blocks["mlp"]["fc_kernel"])
    return {
        "ln1": ln1,
        "ln2": ln2,
        "attn": {"qkv": quantize_weight(qkv_eq)},
        "mlp": {"fc": quantize_weight(fc_eq),
                "proj": quantize_weight(blocks["mlp"]["proj_kernel"])},
    }


def quantize_stack_on_device(blocks: dict) -> dict:
    """The int8 stack of a transformer block pytree, on the blocks' device:
    the single entry point of every int8 consumer (TTA engine, caption bank).
    On CUDA the width must be one the kernels take; it raises here, at build
    time, instead of at the first scored batch."""
    qkv = blocks["attn"]["qkv_kernel"]
    if qkv.device.type == "cuda":
        from .quant_kernels import check_kernel_widths

        check_kernel_widths("quantize_stack_on_device", int(qkv.shape[-2]),
                            int(blocks["mlp"]["fc_kernel"].shape[-1]))
    with torch.no_grad():
        return quantize_block_stack(blocks)
