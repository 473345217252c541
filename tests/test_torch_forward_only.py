"""The forward-only kernel wrappers refuse gradients: under grad mode, an
input that requires grad makes ``attn_block_bf16``, ``mlp_bf16``,
``ln_quant``, ``attn_block_int8``, ``mlp_int8`` (and
``mlp_int8_with_hidden``) and ``flash_attention`` raise, on the CPU as on the
card (where the launch on ``data_ptr()`` would otherwise return an output
with no gradient). Under ``no_grad``, or with no input requiring grad, they
run. ``resident_attention`` has a backward and is not refused."""

import pytest
import torch

from leclip_tpu_torch.models.transformer import init_block_stack, layer_params
from leclip_tpu_torch.ops import block_kernels as bk
from leclip_tpu_torch.ops import flash_attention as fa
from leclip_tpu_torch.ops import quant_kernels as qk
from leclip_tpu_torch.ops.quant import quantize_block_stack

torch.set_num_threads(2)

D = 128


def _calls():
    """(name, fn(x), x) for every forward-only wrapper, on tiny CPU inputs."""
    g = torch.Generator().manual_seed(0)
    blocks = init_block_stack(g, 1, D)
    p, q8 = layer_params(blocks, 0), layer_params(quantize_block_stack(blocks), 0)
    attn = (p["ln_1"]["scale"], p["ln_1"]["bias"], p["attn"]["qkv_kernel"],
            p["attn"]["qkv_bias"], p["attn"]["out_kernel"], p["attn"]["out_bias"])
    mlp = (p["ln_2"]["scale"], p["ln_2"]["bias"], p["mlp"]["fc_kernel"], p["mlp"]["fc_bias"],
           p["mlp"]["proj_kernel"], p["mlp"]["proj_bias"])
    mlp8 = (*q8["ln2"], *q8["mlp"]["fc"], p["mlp"]["fc_bias"], *q8["mlp"]["proj"],
            p["mlp"]["proj_bias"])
    attn8 = (*q8["ln1"], *q8["attn"]["qkv"], p["attn"]["qkv_bias"], p["attn"]["out_kernel"],
             p["attn"]["out_bias"])
    x = torch.randn(2, 8, D, generator=g)
    q = torch.randn(2, 2, 8, 64, generator=g)
    return [
        ("attn_block_bf16", lambda t: bk.attn_block_bf16(t, *attn, 2, causal=True), x),
        ("mlp_bf16", lambda t: bk.mlp_bf16(t, *mlp), x),
        ("ln_quant", lambda t: qk.ln_quant(t, *q8["ln1"]), x),
        ("attn_block_int8", lambda t: qk.attn_block_int8(t, *attn8, 2, causal=True), x),
        ("mlp_int8", lambda t: qk.mlp_int8(t, *mlp8), x),
        ("mlp_int8", lambda t: qk.mlp_int8_with_hidden(t, *mlp8), x),
        ("flash_attention", lambda t: fa.flash_attention(t, q, q), q),
    ]


@pytest.mark.parametrize("i", range(7))
def test_forward_only_wrapper_refuses_an_input_that_requires_grad(i):
    name, fn, x = _calls()[i]
    fn(x)  # no input requires grad: runs
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name}: the kernel is forward-only"):
        fn(xg)
    with torch.no_grad():
        fn(xg)  # under no_grad the caller asked for no gradient: runs


def test_a_weight_that_requires_grad_is_refused_too():
    g = torch.Generator().manual_seed(1)
    w = torch.randn(D, 4 * D, generator=g).requires_grad_(True)
    x = torch.randn(2, 8, D, generator=g)
    ones, zeros = torch.ones(D), torch.zeros(D)
    with pytest.raises(RuntimeError, match="mlp_bf16"):
        bk.mlp_bf16(x, ones, zeros, w, torch.zeros(4 * D), torch.randn(4 * D, D), zeros)


def test_resident_attention_keeps_its_gradient():
    q = torch.randn(2, 8, 128, requires_grad=True)
    out = fa.resident_attention(q, q, q, 2)
    (out.sum()).backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
