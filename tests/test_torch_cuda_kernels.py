"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card (marker ``cuda``) and skip without one. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance, bf16 kernels: kernel and plain version round to bf16 at the same
points and differ only in fp32 summation order, so |Δ| ≤ 4 bf16 ulps of
max(1, |ref|). int8 kernels: integer sums are exact and the fp32 epilogues
run the same operations in the same order, so the only difference comes from
the LayerNorm statistics (another summation order) tipping a value across a
.5 boundary: ``ln_quant`` codes equal but for at most 1e-4 of them, each off
by exactly 1, scales 1e-6 relative; block outputs within 4 bf16 ulps on all
but at most 1e-3 of the rows (those a flipped code touches) and nowhere
beyond 16 (measured at the ViT-B/16 shape on an NVIDIA H100 80GB HBM3 at
700.00 W: 4e-7 of the codes, 2.5e-5 of the MLP's rows, 6.5 ulps).
Attention kernels (``resident_attention``, ``flash_attention``) on
unit-scale inputs: fp32 within 2e-5 absolute (fp32 sums in another order,
no TF32). bf16: their outputs sit mostly at |x| ~ 0.1–0.3, so within 4 bf16
ulps of max(|ref|, 2⁻⁴) on all but 1e-5 of the outputs, and within 2 ulps of
max(1, |ref|) everywhere: a p rounded across a bf16 boundary (its fp32 score
summed in another order) moves o by 2⁻⁸·(p/l)·|v − o|, which scales with |v|
and not |o| and is largest in rows with few keys (early causal rows)."""

import os
import tempfile

import pytest
import torch

from leclip_tpu_torch.models.transformer import init_block_stack, layer_params
from leclip_tpu_torch.ops import block_kernels as bk
from leclip_tpu_torch.ops import flash_attention as fa
from leclip_tpu_torch.ops import quant_kernels as qk
from leclip_tpu_torch.ops.quant import kernel_layout, quantize_block_stack

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _weights(card, d, hidden, seed):
    g = torch.Generator(device=card).manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=card) * std).bfloat16()

    attn = [1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, 3 * d, std=d ** -0.5),
            rn(3 * d, std=0.02), rn(d, d, std=d ** -0.5), rn(d, std=0.02)]
    mlp = [1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, hidden, std=(2 * d) ** -0.5),
           rn(hidden, std=0.02), rn(hidden, d, std=d ** -0.5), rn(d, std=0.02)]
    return rn, attn, mlp


def _close(out, ref):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    diff = (out.float() - ref.float()).abs()
    assert (diff <= 4 * 2.0 ** -8 * ref.float().abs().clamp(min=1.0)).all(), diff.max().item()


@pytest.mark.parametrize("b,t,d,heads,kv_len,causal", [
    (5, 200, 768, 12, 197, False),   # ViT-B/16 crops
    (9, 77, 512, 8, 77, True),       # caption-bank text tower
    (3, 17, 128, 4, 13, False),      # ragged rows, short sequence, head width 32
    (2, 264, 1024, 16, 257, False),  # ViT-L/14 width
    (3, 40, 256, 2, 40, True),       # head width 128, causal
    (2, 50, 640, 10, 47, False),     # D = 640: N = 1920 and 640, no multiple of 256
    (1, 13, 512, 8, 13, True),       # 13 rows, below one 128-row tile
    (4, 32, 128, 2, 30, False),      # D = 128: K has fewer 64-deep steps than the GEMM's stages
])
def test_attn_block_kernel_matches_plain(card, b, t, d, heads, kv_len, causal):
    rn, attn, _ = _weights(card, d, 4 * d, 0)
    x = rn(b, t, d)
    before = bk.attn_block_bf16.launches
    out = bk.attn_block_bf16(x, *attn, heads, kv_len=kv_len, causal=causal)
    assert bk.attn_block_bf16.launches == before + 1
    _close(out, bk.attn_block_bf16_plain(x, *attn, heads, kv_len=kv_len, causal=causal))


@pytest.mark.parametrize("rows,d", [
    (1000, 768), (77 * 9, 512),
    (13, 128),     # below one row tile; K = 128 for fc
    (300, 1024),   # hidden 4096
    (700, 640),    # N = 2560 and 640 (no multiple of 256)
    (129, 1024),   # one row past a tile
])
def test_mlp_kernel_matches_plain(card, rows, d):
    rn, _, mlp = _weights(card, d, 4 * d, 1)
    x = rn(rows, d)
    before = bk.mlp_bf16.launches
    out = bk.mlp_bf16(x, *mlp)
    assert bk.mlp_bf16.launches == before + 1
    _close(out, bk.mlp_bf16_plain(x, *mlp))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    rn, attn, mlp = _weights(card, 128, 512, 2)
    x = rn(2, 8, 128)
    with pytest.raises(TypeError):
        bk.mlp_bf16(x.float(), *mlp)
    with pytest.raises(ValueError):
        bk.attn_block_bf16(x.transpose(0, 1), *attn, 2)
    with pytest.raises(ValueError):
        bk.attn_block_bf16(rn(2, 8, 96), *[a[..., :96] for a in attn], 2)
    shifted = rn(2 * 8 * 128 + 1)[1:].view(2, 8, 128)  # contiguous, 2 bytes past 16-byte alignment
    with pytest.raises(ValueError, match="16-byte"):
        bk.mlp_bf16(shifted, *mlp)


# ------------------------------ int8 kernels --------------------------------


def test_wrappers_refuse_an_input_that_requires_grad(card):
    """On the card, under grad mode, each forward-only wrapper raises for an
    input that requires grad, before it launches anything (the launch on
    ``data_ptr()`` would return an output with no ``grad_fn``: the gradient
    silently dropped). Under ``no_grad`` the same call launches."""
    from leclip_tpu_torch.ops import launches

    rn, attn, mlp = _weights(card, 128, 512, 70)
    _, ln1, attn8, mlp8 = _int8_layer(card, 128, 71)
    x = rn(4, 32, 128).requires_grad_(True)
    q = rn(2, 2, 32, 64).requires_grad_(True)
    calls = {
        "attn_block_bf16": lambda: bk.attn_block_bf16(x, *attn, 2, causal=True),
        "mlp_bf16": lambda: bk.mlp_bf16(x, *mlp),
        "ln_quant": lambda: qk.ln_quant(x, *ln1),
        "attn_block_int8": lambda: qk.attn_block_int8(x, *attn8, 2, causal=True),
        "mlp_int8": lambda: qk.mlp_int8(x, *mlp8),
        "flash_attention": lambda: fa.flash_attention(q, q, q),
    }
    launches.reset_launch_counts()
    for name, fn in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the kernel is forward-only"):
            fn()
    assert not any(launches.launch_counts().values())
    with torch.no_grad():
        out = calls["attn_block_bf16"]()
    torch.cuda.synchronize()
    assert out.grad_fn is None and launches.launch_counts()["attn_block_bf16"] == 1


def _int8_layer(card, d, seed):
    """One quantized layer from seeded bf16 blocks with outlier LN channels:
    (rn, ln1 affine, attention args, MLP args)."""
    g = torch.Generator(device=card).manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=card) * std).bfloat16()

    blocks = init_block_stack(g, 1, d, dtype=torch.bfloat16, device=card)
    gain = torch.ones(d, device=card)
    gain[[5, 17, 42]] = 10.0
    for ln in ("ln_1", "ln_2"):
        blocks[ln]["scale"] = ((1 + rn(1, d, std=0.1).float()) * gain).bfloat16()
        blocks[ln]["bias"] = rn(1, d, std=0.1)
    for grp, key, n in (("attn", "qkv_bias", 3 * d), ("attn", "out_bias", d),
                        ("mlp", "fc_bias", 4 * d), ("mlp", "proj_bias", d)):
        blocks[grp][key] = rn(1, n, std=0.02)
    q8, p = layer_params(quantize_block_stack(blocks), 0), layer_params(blocks, 0)
    attn = (*q8["ln1"], *q8["attn"]["qkv"], p["attn"]["qkv_bias"], p["attn"]["out_kernel"],
            p["attn"]["out_bias"])
    mlp = (*q8["ln2"], *q8["mlp"]["fc"], p["mlp"]["fc_bias"], *q8["mlp"]["proj"],
           p["mlp"]["proj_bias"])
    return rn, q8["ln1"], attn, mlp


def _close_int8(out, ref):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    d = out.shape[-1]
    ulps = ((out.float() - ref.float()).abs() * 2.0 ** 8
            / ref.float().abs().clamp(min=1.0)).reshape(-1, d)
    assert (ulps > 4).any(-1).float().mean().item() <= 1e-3 and ulps.max().item() <= 16, \
        ulps.max().item()


@pytest.mark.parametrize("shape,d", [((610, 200), 768), ((9, 77), 512), ((13,), 128),
                                     ((3, 100), 1024), ((1, 5), 640),
                                     # ragged row counts: one row, part of / one past
                                     # a warp-per-row block of 8, many blocks
                                     ((1,), 768), ((63,), 512), ((64,), 640),
                                     ((129,), 1024), ((129,), 512), ((17000,), 768),
                                     ((17000,), 1024)])
def test_ln_quant_kernel_matches_plain(card, shape, d):
    rn, ln1, _, _ = _int8_layer(card, d, 3)
    x = rn(*shape, d)
    before = qk.ln_quant.launches
    xi, xs = qk.ln_quant(x, *ln1)
    assert qk.ln_quant.launches == before + 1
    ri, rs = qk.ln_quant_plain(x, *ln1)
    torch.cuda.synchronize()
    assert xi.dtype == torch.int8 and xi.shape == x.shape and xs.shape == shape + (1,)
    diff = (xi.int() - ri.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() <= 1e-4
    torch.testing.assert_close(xs, rs, rtol=1e-6, atol=0)


@pytest.mark.parametrize("b,t,d,heads,kv_len,causal", [
    (5, 200, 768, 12, 197, False),   # ViT-B/16 crops
    (9, 77, 512, 8, 77, True),       # caption-bank text tower
    (3, 17, 128, 4, 13, False),      # ragged rows, short sequence, head width 32
    (2, 264, 1024, 16, 257, False),  # ViT-L/14 width
    (3, 40, 256, 2, 40, True),       # head width 128, causal
    (1, 1, 768, 12, 1, False),       # one row: every tile of the int8 GEMM ragged
    (1, 63, 512, 8, 63, True),       # 63 rows: one consumer group's rows only
    (1, 64, 768, 12, 64, False),     # 64 rows
    (3, 43, 768, 12, 43, False),     # 129 rows: one row past a 128-row tile
    (2, 50, 640, 10, 47, False),     # D = 640: N = 1920, a masked 128-wide last tile
    (85, 200, 768, 12, 197, False),  # 17,000 rows: 133 row tiles, the persistent walk wraps
])
def test_attn_block_int8_kernel_matches_plain(card, b, t, d, heads, kv_len, causal):
    rn, _, attn, _ = _int8_layer(card, d, 4)
    x = rn(b, t, d)
    before = qk.attn_block_int8.launches, qk.ln_quant.launches
    out = qk.attn_block_int8(x, *attn, heads, kv_len=kv_len, causal=causal)
    # the block's C entry launches the ln_quant kernel first, counted with it
    assert (qk.attn_block_int8.launches, qk.ln_quant.launches) == (before[0] + 1, before[1] + 1)
    _close_int8(out, qk.attn_block_int8_plain(x, *attn, heads, kv_len=kv_len, causal=causal))


@pytest.mark.parametrize("rows,d", [(1000, 768), (77 * 9, 512), (13, 128), (300, 1024),
                                    (129, 640),
                                    (1, 768), (63, 768), (64, 768), (129, 768),
                                    (129, 512), (129, 1024),
                                    (700, 640),     # H = 2560 and N = 640: masked last tiles
                                    (17000, 512)])  # 133 row tiles: the persistent walk wraps
def test_mlp_int8_kernel_matches_plain(card, rows, d):
    rn, _, _, mlp = _int8_layer(card, d, 5)
    x = rn(rows, d)
    before = qk.mlp_int8.launches, qk.ln_quant.launches
    out = qk.mlp_int8(x, *mlp)
    # one call: the block's C entry launches the ln_quant kernel first
    assert (qk.mlp_int8.launches, qk.ln_quant.launches) == (before[0] + 1, before[1] + 1)
    _close_int8(out, qk.mlp_int8_plain(x, *mlp))


@pytest.mark.parametrize("rows,d", [(1000, 768), (129, 640), (17000, 512)])
def test_mlp_int8_hidden_codes_match_plain(card, rows, d):
    """The int8 codes the fc passes write (absmax pass, then codes at the
    row's scale) are the plain version's, but where the LayerNorm statistics
    tip a value across a .5 boundary: at most 1e-4 of them, each by 1. The
    row scales agree to 1e-6 but on the rows such a flipped LN code moves
    (at most 1e-3 of them, as for the block outputs: measured 3 of 17,000
    rows at 5e-4 relative, NVIDIA H100 80GB HBM3, 700.00 W)."""
    rn, _, _, mlp = _int8_layer(card, d, 7)
    x = rn(rows, d)
    out, hi, hs = qk.mlp_int8_with_hidden(x, *mlp)
    ref_out, ref_hi, ref_hs = qk._mlp_int8_parts_plain(x, *mlp, 1e-5)
    torch.cuda.synchronize()
    assert hi.dtype == torch.int8 and hi.shape == ref_hi.shape and hs.shape == ref_hs.shape
    assert hi.abs().amax(-1).eq(127).all()  # each row's absmax (fc pass 1) codes to 127
    diff = (hi.int() - ref_hi.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() <= 1e-4, \
        ((diff != 0).float().mean().item(), diff.max().item())
    assert ((hs - ref_hs).abs() > 1e-6 * ref_hs).float().mean().item() <= 1e-3
    _close_int8(out, ref_out)


def test_int8_epilogue_exact_forms(card):
    """The int8 GEMM epilogue's branch-free forms give exactly the values of
    the divisions they replace: the sigmoid's reciprocal for every fp32 in
    [1, 2^126], the quantizer's codes over 1.2e8 seeded pairs, three in four
    within 4 ulps of a .5 boundary."""
    assert qk.int8_exact_forms_check(card) == (0, 0)


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(card):
    rn, ln1, attn, mlp = _int8_layer(card, 128, 6)
    x = rn(2, 8, 128)
    with pytest.raises(TypeError):                      # fp32 activations
        qk.mlp_int8(x.float(), *mlp)
    with pytest.raises(TypeError):
        qk.ln_quant(x.float(), *ln1)
    with pytest.raises(ValueError):                     # not contiguous
        qk.attn_block_int8(x.transpose(0, 1), *attn, 2)
    with pytest.raises(ValueError):                     # width no multiple of 128
        qk.ln_quant(rn(2, 8, 96), ln1[0][:96], ln1[1][:96])
    with pytest.raises(ValueError, match="kernel layout"):  # row-major int8 weight
        qk.mlp_int8(x, mlp[0], mlp[1], mlp[2].contiguous(), *mlp[3:])
    with pytest.raises(TypeError):                      # weight not int8
        qk.attn_block_int8(x, attn[0], attn[1], attn[2].bfloat16(), *attn[3:], 2)
    with pytest.raises(ValueError):                     # kv_len out of range
        qk.attn_block_int8(x, *attn, 2, kv_len=9)
    # the layout helper is what the refusal names
    fixed = kernel_layout(mlp[2].contiguous())
    torch.testing.assert_close(qk.mlp_int8(x, mlp[0], mlp[1], fixed, *mlp[3:]),
                               qk.mlp_int8(x, *mlp), rtol=0, atol=0)


# ---------------------------- attention kernels -----------------------------


def _close_attn(out, ref):
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and torch.isfinite(out).all()
    diff = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        assert diff.max().item() <= 2e-5, diff.max().item()
    else:
        rel = diff / (2.0 ** -8 * ref.float().abs().clamp(min=2.0 ** -4))
        assert (rel > 4).float().mean().item() <= 1e-5, rel.max().item()
        assert (diff <= 2 * 2.0 ** -8 * ref.float().abs().clamp(min=1.0)).all(), diff.max().item()


def _randn(card, shape, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=g, device=card).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,heads,kv_len", [
    (3, 24, 2, 24),      # short, no pad keys
    (5, 200, 12, 197),   # ViT-B/16 crops
    (2, 264, 16, 257),   # ViT-L/14
])
@pytest.mark.parametrize("packed", [True, False])
def test_resident_kernel_matches_plain(card, dtype, b, t, heads, kv_len, packed):
    w = 64 * heads
    if packed:  # the three thirds of one qkv buffer, as attention_from_qkv splits it
        q, k, v = _randn(card, (b, t, 3 * w), dtype, 7).split(w, dim=-1)
    else:
        q, k, v = (_randn(card, (b, t, w), dtype, 7 + i) for i in range(3))
    before = fa.resident_attention.launches
    out = fa.resident_attention(q, k, v, heads, kv_len)
    assert fa.resident_attention.launches == before + 1
    _close_attn(out, fa.resident_attention_plain(q, k, v, heads, kv_len))


def test_resident_gradient_on_card(card):
    q, k, v = (_randn(card, (2, 40, 128), torch.float32, 11 + i).requires_grad_()
               for i in range(3))
    cot = _randn(card, (2, 40, 128), torch.float32, 14)
    grads = torch.autograd.grad((fa.resident_attention(q, k, v, 2, 37) * cot).sum(), (q, k, v))
    refs = torch.autograd.grad((fa.packed_attention_reference(q, k, v, 2, 37) * cot).sum(),
                               (q, k, v))
    for g, r in zip(grads, refs):
        torch.testing.assert_close(g, r, rtol=0, atol=0)  # the backward IS the reference's


def _flash_mask(card, kind, t, seed):
    if kind == "none":
        return None
    if kind == "pad":
        return torch.where(torch.arange(t, device=card) < t - 3, 0.0, -1e30)
    if kind == "causal":
        return torch.full((t, t), float("-inf"), device=card).triu(1)
    m = _randn(card, (t, t), torch.float32, seed)  # any additive matrix
    if kind == "masked_row":  # row 5 sees no key: the TPU kernel's uniform p over its pad
        m[5] = float("-inf")
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,mask", [
    (2, 3, 24, "pad"),
    (4, 12, 200, "pad"),      # ViT-B/16 image tower, one key block
    (3, 8, 77, "causal"),     # text tower, one key block
    (2, 4, 264, "none"),      # ViT-L/14: two key blocks of 256
    (2, 4, 264, "causal"),
    (1, 2, 300, "matrix"),
    (2, 3, 13, "pad"),        # fewer keys than one chunk
    (1, 2, 77, "masked_row"),
    (1, 2, 300, "masked_row"),
    (1, 2, 1300, "causal"),   # fp32 too: softmax blocks of 256 keys (one no longer fits)
])
def test_flash_kernel_matches_plain(card, dtype, b, h, t, mask):
    q, k, v = (_randn(card, (b, h, t, 64), dtype, 20 + i) for i in range(3))
    m = _flash_mask(card, mask, t, 23)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, mask=m)
    assert fa.flash_attention.launches == before + 1
    _close_attn(out, fa.flash_attention_plain(q, k, v, mask=m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_head_views(card, dtype):
    """[B, H, T, D] views of a packed qkv buffer go in without a copy."""
    qkv = _randn(card, (3, 200, 3 * 256), dtype, 30)
    q, k, v = (y.reshape(3, 200, 4, 64).transpose(1, 2) for y in qkv.split(256, dim=-1))
    m = _flash_mask(card, "pad", 200, 0)
    _close_attn(fa.flash_attention(q, k, v, mask=m), fa.flash_attention_plain(q, k, v, mask=m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrapper_refuses_misaligned_views(card, dtype):
    """Views whose rows do not start on 16-byte boundaries raise: the kernels
    copy 16-byte rows, and the wrapper does not copy them quietly."""
    qkv = _randn(card, (2, 24, 3 * 128 + 4), dtype, 31)
    q, k, v = (y.reshape(2, 24, 2, 64).transpose(1, 2)
               for y in qkv[..., 1:1 + 3 * 128].split(128, dim=-1))
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, k, v)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, k, v = (_randn(card, (2, 24, 128), torch.float32, 40 + i) for i in range(3))
    with pytest.raises(ValueError, match="head width 64"):   # dh 32
        fa.resident_attention(q, k, v, 4)
    q2, k2, v2 = (y[:, :20] for y in (q, k, v))
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.resident_attention(q2, k2, v2, 2)
    with pytest.raises(ValueError, match="kv_len"):
        fa.resident_attention(q, k, v, 2, 25)
    big = _randn(card, (1, 1280, 3 * 64), torch.float32, 43).split(64, dim=-1)
    with pytest.raises(ValueError, match="shared memory"):   # fp32 scores of 1280 keys
        fa.resident_attention(*big, 1)
    with pytest.raises(TypeError):
        fa.resident_attention(q.half(), k.half(), v.half(), 2)
    x = _randn(card, (1, 2, 24, 32), torch.float32, 44)
    with pytest.raises(ValueError, match="head width 64"):
        fa.flash_attention(x, x, x)


# --------------------------- the RN50 image tower ----------------------------


def _random_bn(tree, g):
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape

            def u(lo, hi):
                return lo + (hi - lo) * torch.rand(c, generator=g)

            return {"scale": u(0.5, 1.0), "bias": 0.1 * torch.randn(c, generator=g),
                    "mean": 0.1 * torch.randn(c, generator=g), "var": u(0.5, 1.5)}
        return {k: _random_bn(v, g) for k, v in tree.items()}
    return tree


def test_rn50_fp32_tower_on_card_matches_cpu(card):
    """RN50's fp32 image tower (every batch norm random) on the card against
    the same function on the CPU, with TF32 switched on by the caller: the
    tower runs its cuDNN convolutions and products in full fp32 whatever the
    caller's setting, so the two differ only in summation order (1e-4 of
    the largest value through the 50 layers; TF32 would leave ~1e-3)."""
    from leclip_tpu_torch.device import tree_map
    from leclip_tpu_torch.models.clip import PRESETS
    from leclip_tpu_torch.models.resnet import encode_image_resnet, init_resnet_params

    cfg = PRESETS["RN50"]
    g = torch.Generator().manual_seed(0)
    vis = _random_bn(init_resnet_params(g, cfg.vision_layers, cfg.embed_dim,
                                        cfg.image_resolution, cfg.vision_width, device="cpu"), g)
    x = torch.randn(2, 224, 224, 3, generator=g)
    ref = encode_image_resnet(x, vis, cfg.vision_heads, dense=True, pool_map=False)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        out = encode_image_resnet(x.to(card), tree_map(lambda t: t.to(card), vis),
                                  cfg.vision_heads, dense=True, pool_map=False)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert out[1] is None and ref[1] is None
    for o, r in ((out[0], ref[0]), (out[2], ref[2])):
        scale = r.abs().max().item()
        assert torch.isfinite(o).all()
        assert (o.cpu() - r).abs().max().item() <= 1e-4 * scale


# precision: (trainer options, the caption branch's kernels per layer)
TRAIN_ROUTES = {
    "fp32": ([], {}),
    "bf16": (["TRAINER.PREC", "bf16"], {"attn_block_bf16": 1, "mlp_bf16": 1}),
    "int8": (["TRAIN.int8_captions", "True"],
             {"attn_block_int8": 1, "mlp_int8": 1, "ln_quant": 2}),
}


@pytest.mark.parametrize("prec", list(TRAIN_ROUTES))
def test_train_step_on_card_launches_its_caption_kernels(card, prec):
    """One training step of a small text tower (3 layers x 128, batch 16)
    on the card per precision: the caption branch launches its route's
    kernels once a layer (the fp32 route none), the prompt branch none, and
    the loss is finite."""
    import numpy as np

    from leclip_tpu_torch.data.datasets import CaptionDataset
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillTrainer
    from leclip_tpu_torch.models.clip import CLIPConfig, init_clip_params
    from leclip_tpu_torch.ops import launches

    cfg = CLIPConfig(64, 64, (1, 1, 1, 1), 8, None, transformer_width=128,
                     transformer_heads=2, transformer_layers=3)
    params = init_clip_params(torch.Generator(device=card).manual_seed(0), cfg, device=card)
    rng = np.random.default_rng(0)
    toks = np.zeros((32, 77), np.int32)
    for i, n in enumerate(rng.integers(3, 20, 32)):
        toks[i, 0], toks[i, 1:1 + n], toks[i, 1 + n] = 49406, rng.integers(1, 49406, n), 49407
    labels = (rng.random((32, 80)) < 0.05).astype(np.int8)
    opts, per_layer = TRAIN_ROUTES[prec]
    tcfg = setup_config(opts=["DATALOADER.BATCH_SIZE_TRAIN", "16", "TRAINER.N_CTX", "4",
                              "TRAIN.ema", "True", "TRAINER.use_evidence", "True",
                              "OUTPUT_DIR", ""] + opts)
    trainer = CaptionDistillTrainer(tcfg, params, cfg, device=card,
                                    dataset=CaptionDataset(toks, labels, [], ["x"] * 80))
    assert trainer.caption_route == ("plain" if prec == "fp32" else prec)
    launches.reset_launch_counts()
    state, aux = trainer.train_step(trainer.state, toks[:16], labels[:16])
    counts = launches.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update({k: 3 * n for k, n in per_layer.items()})
    assert counts == want
    assert np.isfinite(float(aux["loss"])) and state.step == 1
    assert all(v.grad_fn is None and torch.isfinite(v).all() for v in state.params.values())


# engine precision: (TTAEngine options, the image tower's kernels per layer)
DUMP_ROUTES = {
    "bf16": (dict(precision="bf16", bf16_fused=True), {"attn_block_bf16": 1, "mlp_bf16": 1}),
    "int8": (dict(precision="int8"), {"attn_block_int8": 1, "mlp_int8": 1, "ln_quant": 2}),
}


@pytest.mark.parametrize("prec", list(DUMP_ROUTES))
def test_dump_path_on_card_matches_fused_path(card, prec):
    """The per-member dump path of a small ViT (2 layers x 128, two members,
    one with co-occurrence, a caption bank) on the card, its image tower
    through the bf16 block kernels or the int8 kernels: the host fusion of
    its dumps equals the fused path within 1e-4 of max(1, max|fused|) (both
    fuse the same fp32 logits, in another order), run_batch equals
    run_batch_multidispatch within 1e-5, and each pass launches its route's
    kernels once a layer and resize_band once for the batch's crops."""
    import numpy as np

    from leclip_tpu_torch.inference.tta import TTAEngine, build_model_spec
    from leclip_tpu_torch.models.clip import CLIPConfig, init_clip_params
    from leclip_tpu_torch.models.dense_clip import DenseFlags
    from leclip_tpu_torch.models.prompt import build_prompt_learner
    from leclip_tpu_torch.ops import launches
    from leclip_tpu_torch.ops.ensemble import generate_final_answers

    cfg = CLIPConfig(64, 64, 2, 128, 16, transformer_width=128, transformer_heads=2,
                     transformer_layers=2)
    g = torch.Generator(device=card).manual_seed(0)
    params = init_clip_params(g, cfg, dtype=torch.bfloat16, device=card)
    classes = ["dog", "cat", "person", "pizza", "car", "bus"]
    specs = {}
    for name, evd, use_freq in (("best", True, True), ("ema", False, False)):
        tr, consts = build_prompt_learner(g, params, classes, n_ctx=4, dtype=torch.bfloat16)
        specs[name] = build_model_spec(params, cfg, tr, consts, DenseFlags(use_evidence=evd),
                                       use_freq=use_freq)
    rng = np.random.default_rng(0)
    bank = rng.standard_normal((64, 64)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    cooc = rng.random((6, 6)).astype(np.float32)
    cooc /= cooc.sum(-1, keepdims=True)
    opts, per_layer = DUMP_ROUTES[prec]
    engine = TTAEngine(params, cfg, specs, scales=(2,), crop_size=64,
                       caption_bank=torch.tensor(bank), cooccurrence=cooc, topk=5,
                       compute_dtype=torch.bfloat16, device=card, **opts)
    images = [rng.integers(0, 255, (72, 96, 3)).astype(np.uint8) for _ in range(2)]
    fused = engine.run_batch_fused(images)
    launches.reset_launch_counts()
    dumps = engine.run_batch(images)
    counts = launches.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update({k: 2 * n for k, n in per_layer.items()})
    want["resize_band"] = 1
    assert counts == want
    slow = engine.run_batch_multidispatch(images)
    for name in dumps:
        for k, v in dumps[name].items():
            assert v.dtype == np.float32 and np.isfinite(v).all()
            np.testing.assert_allclose(v, slow[name][k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name}/{k}")
    sims = dumps.pop("_sims")
    host = generate_final_answers(dumps, sims["sims_blocks_all"])
    assert host.shape == fused.shape == (2, 6)
    assert np.abs(host - fused).max() <= 1e-4 * max(1.0, np.abs(fused).max())


@pytest.mark.parametrize("method", ["cubic", "linear"])
def test_crop_and_resize_on_card_matches_cpu(card, method):
    """The gather sampler (ops/crops.py) on the card against the CPU: the
    same fp32 operations (1e-5 of max(1, max|ref|)), chunking and tensor
    content extents included."""
    from leclip_tpu_torch.ops.crops import crop_and_resize

    g = torch.Generator().manual_seed(0)
    img = torch.rand(480, 640, 3, generator=g)
    boxes = torch.tensor([[-20.0, -30.0, 200.0, 250.0], [100.5, 200.25, 420.0, 610.0],
                          [300.0, 500.0, 700.0, 900.0], [0.0, 0.0, 480.0, 640.0]])
    ref = crop_and_resize(img, boxes, 224, method, chunk=2, content_hw=(400, 600))
    out = crop_and_resize(img.to(card), boxes.to(card), 224, method, chunk=3,
                          content_hw=(torch.tensor(400, device=card), torch.tensor(600, device=card)))
    torch.cuda.synchronize()
    assert out.shape == (4, 224, 224, 3) and torch.isfinite(out).all()
    assert (out.cpu() - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


def test_validate_batch_on_card_matches_cpu(card):
    """One validate batch of a small RN trainer (2 JPEG val images, scales
    (2,)) on the card against the same trainer on the CPU: the evaluator's
    arrays within 1e-4 of max(1, max|ref|) (an fp32 engine, TF32 off), the
    images decoded by the native decoder."""
    import numpy as np
    from PIL import Image

    from leclip_tpu_torch.data.datasets import CaptionDataset
    from leclip_tpu_torch.device import tree_map
    from leclip_tpu_torch.engine import evaluator
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillTrainer
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
    from leclip_tpu_torch.runtime import jpeg

    cfg = PRESETS["RN-TEST"]
    params = init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(2):
            paths.append(os.path.join(d, f"{i}.jpg"))
            Image.fromarray(rng.integers(0, 255, (96, 128, 3)).astype(np.uint8)).save(paths[-1])
        toks = np.zeros((16, 77), np.int32)
        toks[:, 0], toks[:, 1], toks[:, 2] = 49406, rng.integers(1, 49406, 16), 49407
        ds = CaptionDataset(toks, (rng.random((16, 80)) < 0.1).astype(np.int8),
                            [p for p in paths for _ in range(100)], ["x"] * 80)
        tcfg = setup_config(opts=["DATALOADER.BATCH_SIZE_TRAIN", "16", "TRAINER.N_CTX", "4",
                                  "OUTPUT_DIR", "", "TEST.multi_scale", "(2,)"])
        got = {}
        for dev in ("cpu", card):
            trainer = CaptionDistillTrainer(tcfg, params, cfg, dataset=ds, device=dev)
            if dev != "cpu":
                trainer.state = trainer.state._replace(
                    params=tree_map(lambda t: t.to(card), got["state"].params))
            else:
                got["state"] = trainer.state
            calls = []
            orig = evaluator.MLClassificationEvaluator.process
            evaluator.MLClassificationEvaluator.process = \
                lambda self, o, lab, loc=None: (calls.append((o, loc)), orig(self, o, lab, loc))[1]
            try:
                jpeg.reset_decode_counts()
                trainer.validate()
            finally:
                evaluator.MLClassificationEvaluator.process = orig
            got[str(dev)] = calls
            assert jpeg.decode_counts()["pil_jpeg"] == 0
    for (o, loc), (ro, rloc) in zip(got[str(card)], got["cpu"]):
        for a, r in ((o, ro), (loc, rloc)):
            assert a.shape == (2, 80) and np.isfinite(a).all()
            assert np.abs(a - r).max() <= 1e-4 * max(1.0, np.abs(r).max())


@pytest.mark.parametrize("name", ["sgd", "adam", "amsgrad", "adamw", "rmsprop", "radam"])
def test_optimizer_step_on_card_matches_cpu(card, name):
    """One step of each optimizer of the menu on the card against the CPU
    (the same fp32 operations; 1e-6 of max(1, max|leaf|)), on a prompt tree
    with the adapter's nested subtree."""
    from leclip_tpu_torch.device import tree_map
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.train_state import build_optimizer, create_train_state

    opt = build_optimizer(setup_config(opts=["OPTIM.NAME", name, "OPTIM.WARMUP_EPOCH", "-1"])
                          .OPTIM, 4)
    g = torch.Generator().manual_seed(1)
    params = {"ctx": torch.randn(64, 512, generator=g), "temperature": torch.tensor(3.0),
              "_adapter": {"down_kernel": torch.randn(512, 128, generator=g)}}
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g), params)
    cpu = create_train_state(params, opt)
    ref, ref_os = opt.update(grads, cpu.opt_state, cpu.params)
    to_card = lambda t: t.to(card)  # noqa: E731
    out, out_os = opt.update(tree_map(to_card, grads), tree_map(to_card, cpu.opt_state),
                             tree_map(to_card, cpu.params))
    torch.cuda.synchronize()

    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] if isinstance(t, dict) else [t]

    for a, r in zip(leaves({"p": out, "s": out_os}), leaves({"p": ref, "s": ref_os})):
        assert a.device.type == "cuda" and a.dtype == r.dtype and a.shape == r.shape
        tol = 1e-6 * max(1.0, r.abs().max().item())
        assert (a.cpu().double() - r.double()).abs().max().item() <= tol


def _rn50_bf16(card, seed, dtype=torch.bfloat16):
    from leclip_tpu_torch.device import cast_floating, tree_map
    from leclip_tpu_torch.models.clip import PRESETS
    from leclip_tpu_torch.models.resnet import init_resnet_params

    cfg = PRESETS["RN50"]
    g = torch.Generator().manual_seed(seed)
    vis = _random_bn(init_resnet_params(g, cfg.vision_layers, cfg.embed_dim,
                                        cfg.image_resolution, cfg.vision_width, device="cpu"), g)
    return tree_map(lambda t: t.to(card), cast_floating(vis, dtype))


def test_rn50_bf16_trunk_ignores_the_batch_order_on_card(card):
    """RN50's bf16 trunk on one batch of 8 images x 305 crops (the witness's
    shape, where cuDNN's bf16 kernels for the 7x7-grid 3x3 convolutions sum
    an image's products differently at another place in the batch), as
    given and with the images reversed: each image's trunk map bit for bit
    the same (models/resnet.py conv2d runs every bf16 convolution on
    conv_bf16)."""
    from leclip_tpu_torch.models.resnet import resnet_features

    vis = _rn50_bf16(card, 3)
    x = torch.rand(8, 305, 224, 224, 3, generator=torch.Generator(device=card).manual_seed(4),
                   device=card).to(torch.bfloat16)
    with torch.inference_mode():
        given = resnet_features(x.flatten(0, 1), vis)
        rev = resnet_features(x.flip(0).flatten(0, 1), vis)
    rev = rev.reshape((8, 305) + tuple(rev.shape[1:])).flip(0).flatten(0, 1)
    assert torch.isfinite(given.float()).all()
    assert torch.equal(given, rev), (given.float() - rev.float()).abs().max().item()


def test_rn50_bf16_trunk_ignores_the_batch_size_on_card(card):
    """RN50's bf16 trunk over images of 305 crops each: every image's map in
    a batch of 1, 2 and 5 images, and of 5 padded to 8 by repeating the
    fifth (as the scoring service pads), bit for bit its map in the batch of
    8. cuDNN's bf16 kernels fail this (the stem's stride-2 convolution at 1,
    2 and 5 images, the 7x7-grid 3x3 ones at 5); conv_bf16 sums each output
    element in one order fixed by K."""
    from leclip_tpu_torch.models.resnet import resnet_features
    from leclip_tpu_torch.ops.conv_kernels import conv_bf16

    vis = _rn50_bf16(card, 3)
    x = torch.rand(8, 305, 224, 224, 3, generator=torch.Generator(device=card).manual_seed(5),
                   device=card).to(torch.bfloat16)
    before = conv_bf16.launches
    with torch.inference_mode():
        full = resnet_features(x.flatten(0, 1), vis)
        full = full.reshape((8, 305) + tuple(full.shape[1:]))
        assert conv_bf16.launches == before + 55
        for idx in ([0], [0, 1], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4, 4, 4, 4]):
            got = resnet_features(x[idx].flatten(0, 1), vis)
            got = got.reshape((len(idx), 305) + tuple(got.shape[1:]))
            assert torch.equal(got, full[idx]), (idx, (got.float() - full[idx].float()).abs()
                                                 .max().item())
    assert torch.isfinite(full.float()).all()


def test_rn50_fp32_trunk_ignores_the_batch_size_on_card(card):
    """RN50's fp32 trunk over images of 305 crops each: every image's map in
    a batch of 1, 2 and 5 images, and of 5 padded to 8 by repeating the
    fifth, bit for bit its map in the batch of 8, and in the batch reversed.
    cuDNN's fp32 kernels, chosen by shape, fail this; conv_fp32 sums each
    output element as one FMA chain over K in order, and launches once a
    convolution."""
    from leclip_tpu_torch.models.resnet import resnet_features
    from leclip_tpu_torch.ops.conv_kernels import conv_fp32

    vis = _rn50_bf16(card, 3, torch.float32)
    x = torch.rand(8, 305, 224, 224, 3, generator=torch.Generator(device=card).manual_seed(6),
                   device=card)
    before = conv_fp32.launches
    with torch.inference_mode():
        full = resnet_features(x.flatten(0, 1), vis)
        full = full.reshape((8, 305) + tuple(full.shape[1:]))
        assert torch.isfinite(full).all()
        for idx in ([0], [0, 1], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4, 4, 4, 4], list(range(7, -1, -1))):
            got = resnet_features(x[idx].flatten(0, 1), vis)
            got = got.reshape((len(idx), 305) + tuple(got.shape[1:]))
            assert torch.equal(got, full[idx]), (idx, (got - full[idx]).abs().max().item())
    assert conv_fp32.launches == before + 55 * 6


def _trunk_shapes():
    """(H, Cin, Cout, k, stride) of every distinct convolution of the RN50
    trunk at 224² crops."""
    out = [(224, 3, 32, 3, 2), (112, 32, 32, 3, 1), (112, 32, 64, 3, 1)]
    h, cin = 56, 64
    for i, n in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** i
        for b in range(n):
            stride = 2 if b == 0 and i > 0 else 1
            ho = h // stride
            out += [(h, cin, planes, 1, 1), (h, planes, planes, 3, 1),
                    (ho, planes, 4 * planes, 1, 1)]
            if b == 0:
                out.append((ho, cin, 4 * planes, 1, 1))
            h, cin = ho, 4 * planes
    return sorted(set(out))


@pytest.mark.parametrize("h,cin,cout,k,stride", _trunk_shapes())
def test_conv_bf16_kernel_matches_plain(card, h, cin, cout, k, stride):
    """conv_bf16 against conv_bf16_plain at each distinct trunk shape (3
    crops): within 1 bf16 ulp of max(|plain|, 2^-8 S), S = sum |a||w| the
    element's own scale (both round the same exact bf16 products once, after
    fp32 sums in another order, whose difference is a few fp32 ulps of S),
    and exactly equal on all but a small share."""
    from leclip_tpu_torch.device import no_tf32
    from leclip_tpu_torch.ops.conv_kernels import conv_bf16, conv_bf16_plain, conv_library

    g = torch.Generator(device=card).manual_seed(h + cin + cout)
    x = torch.randn(3, h, h, cin, generator=g, device=card).to(torch.bfloat16)
    w = (torch.randn(cout, k, k, cin, generator=g, device=card) * (k * k * cin) ** -0.5
         ).to(torch.bfloat16).permute(0, 3, 1, 2)
    before = conv_bf16.launches
    out = conv_bf16(x, w, stride)
    assert conv_bf16.launches == before + 1
    ref = conv_bf16_plain(x, w, stride)
    with no_tf32():
        scale = conv_library(x.float().abs(), w.float().abs(), stride)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (3, -(-h // stride), -(-h // stride), cout)
    d = (out.float() - ref.float()).abs()
    mag = torch.maximum(ref.float().abs(), 2.0 ** -8 * scale).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert (d <= ulp).all(), (d / ulp).max().item()
    assert (d == 0).float().mean().item() >= 0.99


def test_conv_bf16_failures_raise(card, monkeypatch):
    """No hidden fallback: a build that fails and a launch that returns an
    error both raise, and nothing is counted."""
    from leclip_tpu_torch.ops import _build
    from leclip_tpu_torch.ops.conv_kernels import conv_bf16

    x = torch.zeros(1, 8, 8, 16, dtype=torch.bfloat16, device=card)
    w = torch.zeros(32, 16, 3, 3, dtype=torch.bfloat16, device=card)
    before = conv_bf16.launches

    def no_build(name):
        raise RuntimeError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(RuntimeError, match="build failed"):
        conv_bf16(x, w)

    class _Refused:
        @staticmethod
        def leclip_conv_bf16(*args):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(_build, "load", lambda name: _Refused())
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        conv_bf16(x, w)
    assert conv_bf16.launches == before


def test_conv_bf16_gradient_on_card_matches_cpu(card):
    """Under autograd the forward launches the kernel and the backward is
    the library's convolution gradient: the input and kernel gradients of a
    bf16 3x3 convolution on the card within 2 bf16 epsilons of max(1,
    max|ref|) of the same function on the CPU."""
    from leclip_tpu_torch.ops.conv_kernels import conv_bf16

    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 14, 14, 64, generator=g).to(torch.bfloat16)
    w = (torch.randn(64, 64, 3, 3, generator=g) / 24).to(torch.bfloat16)
    cot = torch.randn(2, 14, 14, 64, generator=g).to(torch.bfloat16)
    grads = []
    for dev in ("cpu", card):
        xs = x.to(dev).detach().requires_grad_()
        ws = w.to(dev).detach().requires_grad_()
        before = conv_bf16.launches
        out = conv_bf16(xs, ws, 1)
        assert conv_bf16.launches == before + (dev != "cpu")
        out.backward(cot.to(dev))
        grads.append((xs.grad.cpu().float(), ws.grad.cpu().float()))
    for got, ref in zip(grads[1], grads[0]):
        assert (got - ref).abs().max().item() <= 2 * 2.0 ** -8 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("h,cin,cout,k,stride", _trunk_shapes())
def test_conv_fp32_kernel_matches_plain(card, h, cin, cout, k, stride):
    """conv_fp32 against conv_fp32_plain (the library's fp32 convolution,
    TF32 off) at each distinct trunk shape (3 crops): within 2^-16 S, S =
    sum |a||w| the element's own scale (fp32 sums of the same products in
    another order; the worst case of a sequential sum is K 2^-24 S)."""
    from leclip_tpu_torch.device import no_tf32
    from leclip_tpu_torch.ops.conv_kernels import conv_fp32, conv_fp32_plain, conv_library

    g = torch.Generator(device=card).manual_seed(h + cin + cout)
    x = torch.randn(3, h, h, cin, generator=g, device=card)
    w = (torch.randn(cout, k, k, cin, generator=g, device=card) * (k * k * cin) ** -0.5
         ).permute(0, 3, 1, 2)
    before = conv_fp32.launches
    out = conv_fp32(x, w, stride)
    assert conv_fp32.launches == before + 1
    ref = conv_fp32_plain(x, w, stride)
    with no_tf32():
        scale = conv_library(x.abs(), w.abs(), stride)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape == (
        3, -(-h // stride), -(-h // stride), cout)
    assert torch.isfinite(out).all()
    d = (out - ref).abs()
    assert (d <= 2.0 ** -16 * scale).all(), (d / scale.clamp(min=1e-30)).max().item()


# (H, Cin, Cout, k, stride) of the 3x3 convolutions of RN50x4 (288² crops,
# width 80) and RN50x16 (384², width 96) at their widest grids: the stem's
# three and layer1's; the stride-2 stem reads rows of 289 and 385 pixels
WIDE_SHAPES = {
    "RN50x4 stem conv1": (288, 3, 40, 3, 2), "RN50x4 stem conv2": (144, 40, 40, 3, 1),
    "RN50x4 stem conv3": (144, 40, 80, 3, 1), "RN50x4 layer1 3x3": (72, 80, 80, 3, 1),
    "RN50x16 stem conv1": (384, 3, 48, 3, 2), "RN50x16 stem conv3": (192, 48, 96, 3, 1),
    "RN50x16 layer1 3x3": (96, 96, 96, 3, 1),
}


@pytest.mark.parametrize("case", list(WIDE_SHAPES))
def test_conv_kernels_take_the_wider_presets(card, case):
    """Both kernels at the widest-grid convolutions of RN50x4 and RN50x16 (2
    crops): conv_bf16 within 1 bf16 ulp of max(|plain|, 2^-8 S) of
    conv_bf16_plain, conv_fp32 within 2^-16 S of conv_fp32_plain, one launch
    each."""
    from leclip_tpu_torch.device import no_tf32
    from leclip_tpu_torch.ops import conv_kernels as ck

    h, cin, cout, k, stride = WIDE_SHAPES[case]
    g = torch.Generator(device=card).manual_seed(h + cout)
    x = torch.randn(2, h, h, cin, generator=g, device=card)
    w = (torch.randn(cout, k, k, cin, generator=g, device=card) * (k * k * cin) ** -0.5
         ).permute(0, 3, 1, 2)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    before = ck.conv_bf16.launches, ck.conv_fp32.launches
    out16, out32 = ck.conv_bf16(xb, wb, stride), ck.conv_fp32(x, w, stride)
    assert (ck.conv_bf16.launches, ck.conv_fp32.launches) == (before[0] + 1, before[1] + 1)
    ref16, ref32 = ck.conv_bf16_plain(xb, wb, stride), ck.conv_fp32_plain(x, w, stride)
    with no_tf32():
        s16 = ck.conv_library(xb.float().abs(), wb.float().abs(), stride)
        s32 = ck.conv_library(x.abs(), w.abs(), stride)
    torch.cuda.synchronize()
    ho = -(-h // stride)
    assert out16.shape == out32.shape == (2, ho, ho, cout)
    d = (out16.float() - ref16.float()).abs()
    mag = torch.maximum(ref16.float().abs(), 2.0 ** -8 * s16).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert (d <= ulp).all(), (d / ulp).max().item()
    d = (out32 - ref32).abs()
    assert torch.isfinite(out32).all()
    assert (d <= 2.0 ** -16 * s32).all(), (d / s32.clamp(min=1e-30)).max().item()


# (rows, K, N) of the RN50 head's fp32 products at 2 crops: the pool's k / v
# (50 tokens a crop), its q and c (one), the dense projection's v and c
HEAD_PRODUCTS = [(100, 2048, 2048), (2, 2048, 2048), (2, 2048, 1024), (98, 2048, 2048),
                 (98, 2048, 1024)]


@pytest.mark.parametrize("rows,k,n", HEAD_PRODUCTS)
def test_matmul_fp32_matches_plain_on_card(card, rows, k, n):
    """conv_kernels.matmul_fp32 (conv_fp32 as a 1x1 convolution over the
    rows, one launch) against y @ w with TF32 off within 2^-16 S, S = |y| @
    |w|, with TF32 switched on around the call (the kernel ignores it); the
    rows of a 1-row call bitwise the same rows in a longer call."""
    from leclip_tpu_torch.ops import conv_kernels as ck

    g = torch.Generator(device=card).manual_seed(rows + n)
    y = torch.randn(rows, k, generator=g, device=card)
    w = torch.randn(k, n, generator=g, device=card) * k ** -0.5
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        before = ck.conv_fp32.launches
        out = ck.matmul_fp32(y, w)
        assert ck.conv_fp32.launches == before + 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ref = ck.matmul_fp32_plain(y, w)
    s = ck.matmul_fp32_plain(y.abs(), w.abs())
    torch.cuda.synchronize()
    assert out.shape == (rows, n) and torch.isfinite(out).all()
    assert ((out - ref).abs() <= 2.0 ** -16 * s).all()
    assert torch.equal(ck.matmul_fp32(y[:1], w), out[:1])


# (shape (H, Cin, Cout, k, stride), residual, relu): the fused calls of the trunk
FUSED_CASES = {
    "bn + relu (3x3 at 56²)": ((56, 64, 64, 3, 1), False, True),
    "bn + relu (3x3 at 14²)": ((14, 256, 256, 3, 1), False, True),
    "bn (downsample)": ((28, 256, 512, 1, 1), False, False),
    "bn + residual + relu (conv3)": ((7, 512, 2048, 1, 1), True, True),
    "bn + residual + relu (layer1 conv3)": ((56, 64, 256, 1, 1), True, True),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_conv_bf16_fused_epilogue_matches_unfused_chain(card, case):
    """conv_bf16 with the batch norm (and residual, ReLU) in its epilogue
    equal, by torch.equal, to the unfused chain over its own output:
    y * scale + offset, + residual, ReLU, each a bf16 PyTorch op."""
    from leclip_tpu_torch.models.resnet import bn_affine
    from leclip_tpu_torch.ops.conv_kernels import bn_chain, conv_bf16

    (h, cin, cout, k, stride), residual, relu = FUSED_CASES[case]
    g = torch.Generator(device=card).manual_seed(cout + cin)
    x = torch.randn(3, h, h, cin, generator=g, device=card).to(torch.bfloat16)
    w = (torch.randn(cout, k, k, cin, generator=g, device=card) * (k * k * cin) ** -0.5
         ).to(torch.bfloat16).permute(0, 3, 1, 2)
    bn = _random_bn({"scale": torch.zeros(cout), "bias": torch.zeros(cout),
                     "mean": torch.zeros(cout), "var": torch.zeros(cout)},
                    torch.Generator().manual_seed(cout))
    scale, offset = bn_affine({n: t.to(card) for n, t in bn.items()}, torch.bfloat16)
    res = (torch.randn(3, h, h, cout, generator=g, device=card).to(torch.bfloat16)
           if residual else None)
    fused = conv_bf16(x, w, stride, scale, offset, res, relu)
    want = bn_chain(conv_bf16(x, w, stride), scale, offset, res, relu)
    torch.cuda.synchronize()
    assert fused.dtype == torch.bfloat16 and torch.isfinite(fused.float()).all()
    assert torch.equal(fused, want), (fused.float() - want.float()).abs().max().item()
    if relu:
        assert (fused >= 0).all()


# (shape (H, Cin, Cout, k, stride), residual, relu): conv_fp32's fused calls; a
# stride-2 3x3, a 1x1 whose Cout (68) is no multiple of any tile's, and an M
# tail (3 x 9² rows: no multiple of 64 or 128)
FUSED32_CASES = {
    "bn + relu (3x3/2 at 28², 64->128)": ((28, 64, 128, 3, 2), False, True),
    "bn (1x1 at 14², Cout 68)": ((14, 64, 68, 1, 1), False, False),
    "bn + residual + relu (1x1 at 14², Cout 68)": ((14, 64, 68, 1, 1), True, True),
    "bn + residual (3x3 at 9², M tail)": ((9, 32, 256, 3, 1), True, False),
    "bn + residual + relu (3x3 at 9², M tail, Cout 32)": ((9, 16, 32, 3, 1), True, True),
    "bn + residual + relu (layer1 conv3, 1x1 at 56², 64->256)": ((56, 64, 256, 1, 1), True, True),
}


@pytest.mark.parametrize("case", list(FUSED32_CASES))
def test_conv_fp32_fused_epilogue_matches_unfused_chain(card, case):
    """conv_fp32 with the batch norm (and residual, ReLU) in its epilogue
    equal, by torch.equal, to the unfused chain over its own bare output:
    y * scale + offset, + residual, ReLU, each an fp32 PyTorch op (the
    epilogue rounds each step apart, with no FMA contraction); one launch."""
    from leclip_tpu_torch.models.resnet import bn_affine
    from leclip_tpu_torch.ops.conv_kernels import bn_chain, conv_fp32

    (h, cin, cout, k, stride), residual, relu = FUSED32_CASES[case]
    g = torch.Generator(device=card).manual_seed(cout + cin + k)
    x = torch.randn(3, h, h, cin, generator=g, device=card)
    w = (torch.randn(cout, k, k, cin, generator=g, device=card) * (k * k * cin) ** -0.5
         ).permute(0, 3, 1, 2)
    bn = _random_bn({"scale": torch.zeros(cout), "bias": torch.zeros(cout),
                     "mean": torch.zeros(cout), "var": torch.zeros(cout)},
                    torch.Generator().manual_seed(cout))
    scale, offset = bn_affine({n: t.to(card) for n, t in bn.items()}, torch.float32)
    ho = -(-h // stride)
    res = torch.randn(3, ho, ho, cout, generator=g, device=card) if residual else None
    before = conv_fp32.launches
    fused = conv_fp32(x, w, stride, scale, offset, res, relu)
    assert conv_fp32.launches == before + 1
    want = bn_chain(conv_fp32(x, w, stride), scale, offset, res, relu)
    torch.cuda.synchronize()
    assert fused.shape == (3, ho, ho, cout) and torch.isfinite(fused).all()
    assert torch.equal(fused, want), (fused - want).abs().max().item()
    if relu:
        assert (fused >= 0).all()


# (H, Cin, Cout, k, crops, few): a trunk call at a batch whose tile is wide
# and at a few crops, whose tile is 64 x 64
TILE_CASES = {
    "3x3 7x7x512->512, 200 crops / 1": (7, 512, 512, 3, 200, 1),
    "3x3 56x56x64->64, 12 crops / 2": (56, 64, 64, 3, 12, 2),
    "1x1 14x14x256->1024, 60 crops / 1": (14, 256, 1024, 1, 60, 1),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_conv_fp32_tiles_give_the_same_bits(card, case):
    """conv_fp32 chooses its tile by M (and Cout): the same images at two
    batch sizes whose tiles differ give the same output bit for bit, bare
    and with the fused chain (every tile sums an element as one FMA chain
    over K in order)."""
    from leclip_tpu_torch.ops import conv_kernels as ck

    h, cin, cout, k, crops, few = TILE_CASES[case]
    g = torch.Generator(device=card).manual_seed(h + cout)
    x = torch.randn(crops, h, h, cin, generator=g, device=card)
    w = (torch.randn(cout, k, k, cin, generator=g, device=card) * (k * k * cin) ** -0.5
         ).permute(0, 3, 1, 2)
    s = 0.5 + torch.rand(cout, generator=g, device=card)
    o = torch.randn(cout, generator=g, device=card) * 0.1
    r = torch.randn(crops, h, h, cout, generator=g, device=card)
    assert ck.conv_fp32_tile(crops * h * h, cout) != ck.conv_fp32_tile(few * h * h, cout)
    assert ck.conv_fp32_tile(few * h * h, cout) == (64, 64)
    for chain in ((), (s, o, r, True)):
        full = ck.conv_fp32(x, w, 1, *chain)
        part = ck.conv_fp32(x[:few], w, 1, *(chain[:2] + (r[:few], True) if chain else ()))
        torch.cuda.synchronize()
        assert torch.isfinite(full).all()
        assert torch.equal(part, full[:few]), (part - full[:few]).abs().max().item()


@pytest.mark.parametrize("rows,k,n", HEAD_PRODUCTS[:3])
def test_matmul_fp32_fused_bias_on_card(card, rows, k, n):
    """matmul_fp32 with its bias in conv_fp32's epilogue (one launch) equal
    to the bare product + bias, as models/resnet._proj computed it."""
    from leclip_tpu_torch.ops import conv_kernels as ck

    g = torch.Generator(device=card).manual_seed(rows + k)
    y = torch.randn(rows, k, generator=g, device=card)
    w = torch.randn(k, n, generator=g, device=card) * k ** -0.5
    bias = torch.randn(n, generator=g, device=card)
    before = ck.conv_fp32.launches
    got = ck.matmul_fp32(y, w, bias)
    assert ck.conv_fp32.launches == before + 1
    want = ck.conv_fp32(y[:, None, None, :], w.t()[:, :, None, None]).reshape(rows, n) + bias
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_conv_fp32_bad_chain_arguments_raise_on_card(card):
    """A residual of another shape or dtype, and a chain without its batch
    norm, raise before any launch."""
    from leclip_tpu_torch.ops.conv_kernels import conv_fp32

    x = torch.zeros(2, 8, 8, 16, device=card)
    w = torch.zeros(32, 16, 3, 3, device=card)
    s, o = torch.ones(32, device=card), torch.zeros(32, device=card)
    before = conv_fp32.launches
    for kw in (dict(scale=s, offset=o, residual=torch.zeros(2, 8, 8, 16, device=card)),
               dict(scale=s, offset=o, residual=torch.zeros(2, 8, 8, 32, device=card,
                                                            dtype=torch.bfloat16)),
               dict(residual=torch.zeros(2, 8, 8, 32, device=card)),
               dict(scale=s, offset=o[:8])):
        with pytest.raises(ValueError):
            conv_fp32(x, w, 1, **kw)
    assert conv_fp32.launches == before


def test_conv_fp32_failures_raise(card, monkeypatch):
    """No hidden fallback: a build that fails and a launch that returns an
    error both raise, and nothing is counted."""
    from leclip_tpu_torch.ops import _build
    from leclip_tpu_torch.ops.conv_kernels import conv_fp32

    x = torch.zeros(1, 8, 8, 16, device=card)
    w = torch.zeros(32, 16, 3, 3, device=card)
    before = conv_fp32.launches

    def no_build(name):
        raise RuntimeError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(RuntimeError, match="build failed"):
        conv_fp32(x, w)

    class _Refused:
        @staticmethod
        def leclip_conv_fp32(*args):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(_build, "load", lambda name: _Refused())
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        conv_fp32(x, w)
    assert conv_fp32.launches == before


def test_conv_fp32_gradient_on_card_matches_cpu(card):
    """Under autograd the forward launches conv_fp32 and the backward is the
    library's convolution gradient with TF32 off, whatever the caller's
    setting: the input and kernel gradients of an fp32 3x3 convolution on
    the card within 1e-5 of max(1, max|ref|) of the same function on the
    CPU (fp32 sums in another order; TF32 would leave ~1e-3)."""
    from leclip_tpu_torch.ops.conv_kernels import conv_fp32

    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 14, 14, 64, generator=g)
    w = torch.randn(64, 64, 3, 3, generator=g) / 24
    cot = torch.randn(2, 14, 14, 64, generator=g)
    grads = []
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        for dev in ("cpu", card):
            xs = x.to(dev).detach().requires_grad_()
            ws = w.to(dev).detach().requires_grad_()
            before = conv_fp32.launches
            out = conv_fp32(xs, ws, 1)
            assert conv_fp32.launches == before + (dev != "cpu")
            out.backward(cot.to(dev))
            grads.append((xs.grad.cpu(), ws.grad.cpu()))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for got, ref in zip(grads[1], grads[0]):
        assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


def test_resident_gradient_at_the_finetune_shape(card):
    """resident_attention under autograd at ViT-B/16's fine-tune shape
    ([64, 200, 768] fp32, kv_len 197), q/k/v the thirds of one packed leaf:
    the output within 2e-5 of its plain version, dq/dk/dv equal to autograd
    through packed_attention_reference (the backward recomputes it)."""
    w = 768
    qkv = _randn(card, (64, 200, 3 * w), torch.float32, 21).requires_grad_()
    cot = _randn(card, (64, 200, w), torch.float32, 22)
    before = fa.resident_attention.launches
    out, got, want = None, None, None
    for fn in (fa.resident_attention, fa.packed_attention_reference):
        q, k, v = qkv.split(w, dim=-1)
        o = fn(q, k, v, 12, 197)
        grads = torch.autograd.grad(o, (q, k, v), cot)
        if out is None:
            out, got = o, grads
        else:
            want = grads
    assert fa.resident_attention.launches == before + 1  # the backward launches nothing
    plain = fa.resident_attention_plain(*(y.detach() for y in qkv.split(w, dim=-1)), 12, 197)
    assert (out.detach() - plain).abs().max().item() <= 2e-5
    for g_, r in zip(got, want):
        torch.testing.assert_close(g_, r, rtol=0, atol=1e-6)


def _path_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _path_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_vit_finetune_step_on_card_matches_the_xla_route(card):
    """Two ViT-B/16 fp32 train_steps (batch 8, remat on the text tower) on
    the "auto" route, resident_attention in each of the 12 image layers,
    against the same steps with attention_impl="xla" (the kernel's fp32 sums
    in another order). Before each step, both routes' gradients at the same
    parameters within 1e-4 of each leaf's largest; after it, loss and
    gradient norm within 1e-4 relative, and the parameters' change from the
    start within 1e-3 in norm. The change is held in norm: an element whose
    gradient is near Adam's eps (1e-8) steps by lr·g/eps, so there a
    rounding of ~1e-9 in the gradient shows as a tenth of a step. The key
    third of each qkv_bias is left out of it: its gradient is 0 in exact
    arithmetic (a softmax ignores a shift of every logit of a row), so Adam
    turns each route's rounding noise there into a step of its own."""
    from leclip_tpu_torch.engine.finetune import CLIPFineTuner
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
    from leclip_tpu_torch.ops import launches

    cfg = PRESETS["ViT-B/16"]
    params = init_clip_params(torch.Generator(device=card).manual_seed(5), cfg, device=card)
    images = _randn(card, (8, 224, 224, 3), torch.float32, 6)
    toks = torch.zeros(8, 77, dtype=torch.int32, device=card)
    toks[:, 0], toks[:, 1:6], toks[:, 6] = 49406, 1000, 49407
    toks[:, 1] = torch.arange(8, device=card) + 300
    tuners = {impl: CLIPFineTuner(params, cfg, lr=1e-5, warmup_steps=0, total_steps=10,
                                  attention_impl=impl, device=card)
              for impl in ("auto", "xla")}
    start = dict(_path_leaves(tuners["xla"].state.params))
    for _ in range(2):
        ga, gx = (dict(_path_leaves(t._loss_and_grads(tuners["auto"].state.params, images,
                                                      toks)[2])) for t in tuners.values())
        for k in gx:
            assert (ga[k] - gx[k]).abs().max() <= 1e-4 * gx[k].abs().max(), k
        out = {}
        for impl, t in tuners.items():
            launches.reset_launch_counts()
            t.state, m = t.train_step(t.state, images, toks)
            torch.cuda.synchronize()
            out[impl] = (m, launches.launch_counts()["resident_attention"])
        (ma, na), (mx, nx) = out["auto"], out["xla"]
        assert (na, nx) == (12, 0)
        for key in ("loss", "grad_norm"):
            assert abs(ma[key].item() - mx[key].item()) <= 1e-4 * abs(mx[key].item()), key
        pa = dict(_path_leaves(tuners["auto"].state.params))
        px = dict(_path_leaves(tuners["xla"].state.params))
        gap, ref = 0.0, 0.0
        for k in px:
            d, dx = pa[k] - px[k], px[k] - start[k]
            if k.endswith("qkv_bias"):
                w = d.shape[-1] // 3
                d[..., w:2 * w] = 0
            gap += d.square().sum().item()
            ref += dx.square().sum().item()
        assert gap ** 0.5 <= 1e-3 * ref ** 0.5


# ------------------------------- resize_band -------------------------------
#
# The banded crop + resize kernel (ops/resize_kernels.py) against its plain
# version, the dense fp32 products of ops/resize_matmul.py, on the card. Both
# round at the same points (the scaled pixel, the weights, the rows pass, the
# columns pass) and differ in summation order only: the kernel sums a row's
# taps in index order, cuBLAS the whole bucket's (zeros included) in its
# own, and a row's normalising sum differs the same way. So the resize
# (normalize off) is within one bf16 ulp of the plain value on under 0.1% of
# the elements in bf16, within 1e-5 absolute in fp32; the fused scale and
# normalisation are held exactly (an identity crop gives the scaled pixel;
# the normalised output is clip_normalize of the kernel's own resize).


def _resize_inputs(card, sizes, bucket, seed=0, shared=False):
    """uint8 images of the given (h, w) zero-padded into ``bucket`` and the
    engine's boxes for them (the central square, then the 2/3/4 pyramid):
    the first image's [N, 4] where ``shared``, else [B, N, 4]."""
    import numpy as np

    from leclip_tpu_torch.ops.crops import tta_sampling_boxes

    rng = np.random.default_rng(seed)
    imgs, boxes = [], []
    for h, w in sizes:
        img = np.zeros(bucket + (3,), np.uint8)
        img[:h, :w] = rng.integers(0, 256, (h, w, 3))
        pyramid, _ = tta_sampling_boxes(h, w, (2, 3, 4))
        side = min(h, w)
        gy, gx = (h - side) / 2.0, (w - side) / 2.0
        boxes.append(np.concatenate([[[gy, gx, gy + side, gx + side]], pyramid]))
        imgs.append(img)
    boxes = torch.tensor(np.stack(boxes), dtype=torch.float32, device=card)
    return (torch.from_numpy(np.stack(imgs)).to(card), boxes[0] if shared else boxes,
            torch.tensor(sizes, dtype=torch.int32, device=card))


def _resize_close(out, ref, dtype):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    assert torch.isfinite(out).all()
    d = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert d.max().item() <= 1e-5, d.max().item()
        return
    mant, exp = torch.frexp(ref.float())
    ulp = torch.ldexp(torch.ones_like(mant), exp - 8)  # bf16's spacing at |ref|
    assert (d <= ulp).all(), (d / ulp).max().item()
    assert (d > 0).float().mean().item() < 1e-3, (d > 0).float().mean().item()


RESIZE_CELLS = {  # route: (content sizes (h, w), bucket, boxes shared)
    "shared 8 x 640x480 in 768x512": ([(640, 480)] * 8, (768, 512), True),
    "mixed 8 in 768x768": ([(480, 640), (640, 480), (427, 640), (640, 427), (640, 640),
                            (480, 640), (375, 500), (612, 612)], (768, 768), False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("cell", list(RESIZE_CELLS))
def test_resize_band_matches_plain_at_the_cells_geometry(card, cell, dtype):
    """The scoring cells' batches of 8 images and 305 crops each: the shared
    route (one box set, images of one size) and the per-image route (mixed
    sizes in the larger bucket), one launch each."""
    from leclip_tpu_torch.ops import resize_kernels as rk
    from leclip_tpu_torch.ops.preprocess import clip_normalize

    sizes, bucket, shared = RESIZE_CELLS[cell]
    images, boxes, content = _resize_inputs(card, sizes, bucket, shared=shared)
    before = rk.resize_band.launches
    out = rk.resize_band(images, boxes, content, 224, dtype=dtype, normalize=False)
    assert rk.resize_band.launches == before + 1
    _resize_close(out, rk.resize_band_plain(images, boxes, content, 224, dtype=dtype,
                                            normalize=False), dtype)
    normed = rk.resize_band(images, boxes, content, 224, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(normed, clip_normalize(out))


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_resize_band_edges_on_card(card, dtype, antialias):
    """Upscaled crops (side 72 < 224), boxes on every edge of the content
    (the reflected taps), a whole content shrunk 3.6x, a thin strip, an odd
    output size and an unaligned bucket width, each image its own boxes; an
    identity crop (64 pixels at integer offsets to 64: every centre on a
    pixel, one tap of weight 1) gives the scaled pixel itself."""
    import numpy as np

    from leclip_tpu_torch.ops import resize_kernels as rk

    rng = np.random.default_rng(1)
    sizes, bucket = [(200, 230), (256, 318), (97, 131)], (256, 318)
    imgs = np.zeros((3,) + bucket + (3,), np.uint8)
    boxes = []
    for i, (h, w) in enumerate(sizes):
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        boxes.append([[0, 0, 72, 72], [h - 72, w - 72, h, w], [0, w - 72, 72, w],
                      [0, 0, h, w], [h / 3, 1.5, h / 3 + 9.75, w - 0.5], [3.25, 7.5, h - 2, w - 5]])
    boxes[1][0] = [16.0, 40.0, 80.0, 104.0]  # the identity crop at 64
    images = torch.from_numpy(imgs).to(card)
    boxes = torch.tensor(boxes, dtype=torch.float32, device=card)
    content = torch.tensor(sizes, dtype=torch.int32, device=card)
    for out_size in (224, 61):
        out = rk.resize_band(images, boxes, content, out_size, antialias, dtype, normalize=False)
        ref = rk.resize_band_plain(images, boxes, content, out_size, antialias, dtype,
                                   normalize=False)
        _resize_close(out, ref, dtype)
    scaled = images[1, 16:80, 40:104].to(dtype) / 255.0
    out = rk.resize_band(images, boxes, content, 64, antialias, dtype, normalize=False)
    torch.cuda.synchronize()
    assert torch.equal(out[1, 0], scaled)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_resize_band_crop_bits_ignore_batch_and_route(card, dtype):
    """A crop's bits do not depend on its batch (alone or among 8) or on
    its route (the batch's boxes, or the same boxes as each image's own)."""
    from leclip_tpu_torch.ops import resize_kernels as rk

    images, boxes, content = _resize_inputs(card, [(480, 640)] * 8, (512, 768), seed=2,
                                            shared=True)
    whole = rk.resize_band(images, boxes, content, 224, dtype=dtype)
    own = rk.resize_band(images, boxes.expand(8, -1, -1), content, 224, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(whole, own)
    for k in (0, 5):
        alone = rk.resize_band(images[k:k + 1], boxes, content[k:k + 1], 224, dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], whole[k])


def test_resize_band_refuses_what_it_cannot_compute(card):
    """A content outside its bucket is written as NaN (no read past the
    image), and the wrapper raises on other image or output types."""
    from leclip_tpu_torch.ops import resize_kernels as rk

    images, boxes, content = _resize_inputs(card, [(64, 80)] * 2, (64, 80), shared=True)
    bad = rk.resize_band(images, boxes, torch.tensor([[64, 80], [65, 80]], device=card), 32)
    torch.cuda.synchronize()
    assert torch.isfinite(bad[0]).all() and torch.isnan(bad[1]).all()
    with pytest.raises(ValueError, match="uint8"):
        rk.resize_band(images.float(), boxes, content, 32)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        rk.resize_band(images, boxes, content, 32, dtype=torch.float16)


def test_train_transform_on_card_matches_the_plain_route(card, monkeypatch):
    """preprocess_train_batch on the card (fine-tuning: fp32, one box an
    image): one resize_band launch, within 1e-5 of the same transform on the
    plain route."""
    from leclip_tpu_torch.ops import preprocess
    from leclip_tpu_torch.ops import resize_kernels as rk

    images, _, content = _resize_inputs(card, [(384, 512), (512, 384), (448, 448), (480, 512)],
                                        (512, 512), seed=3)
    draws = preprocess.sample_train(torch.Generator(device=card).manual_seed(4), (4,),
                                    device=card)
    before = rk.resize_band.launches
    out = preprocess.preprocess_train_batch(images, content, draws)
    assert rk.resize_band.launches == before + 1
    monkeypatch.setattr(rk, "resize_band", rk.resize_band_plain)
    ref = preprocess.preprocess_train_batch(images, content, draws)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-5


# ------------------------------ average pool ---------------------------------

POOL_SHAPES = {  # name: (crops, H, W, C, k)
    "rn50 stem 112x112x64": (3, 112, 112, 64, 2),
    "rn50 layer2 conv3 56x56x128": (3, 56, 56, 128, 2),
    "rn50 layer2 downsample 56x56x256": (3, 56, 56, 256, 2),
    "rn50 layer3 conv3 28x28x256": (3, 28, 28, 256, 2),
    "rn50 layer3 downsample 28x28x512": (3, 28, 28, 512, 2),
    "rn50 layer4 conv3 14x14x512": (3, 14, 14, 512, 2),
    "rn50 layer4 downsample 14x14x1024": (3, 14, 14, 1024, 2),
    "rn50x4 stem 144x144x80": (2, 144, 144, 80, 2),
    "rn50x4 layer4 18x18x1280 (9 wide out)": (2, 18, 18, 1280, 2),
    "odd 15x17x80": (3, 15, 17, 80, 2),
    "k 3 on 20x23x96": (2, 20, 23, 96, 3),
    "k 4 on 9x13x16": (2, 9, 13, 16, 4),
}


def _library_pool(x, k):
    return torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(POOL_SHAPES))
def test_avg_pool_kernel_matches_the_library(card, case, dtype):
    """avg_pool_nhwc at RN50's seven pool shapes (a few crops each), wider
    presets' widths and grids, odd sizes and windows of 3 and 4: 0 values
    differ from F.avg_pool2d on the card (the fp32 sum in the library's
    order, an fp32 division, one rounding), one launch a call."""
    from leclip_tpu_torch.ops import pool_kernels as pk

    n, h, w, c, k = POOL_SHAPES[case]
    x = torch.randn(n, h, w, c, generator=torch.Generator(device=card).manual_seed(h + c),
                    device=card).to(dtype)
    before = pk.avg_pool_nhwc.launches
    out = pk.avg_pool_nhwc(x, k)
    assert pk.avg_pool_nhwc.launches == before + 1
    ref = _library_pool(x, k)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == dtype and out.is_contiguous()
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, pk.avg_pool_nhwc_plain(x, k))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_avg_pool_kernel_ignores_the_batch(card, dtype):
    """An image's pooled values are the same alone, in its batch, and in the
    batch reversed."""
    from leclip_tpu_torch.ops import pool_kernels as pk

    x = torch.randn(6, 56, 56, 256, generator=torch.Generator(device=card).manual_seed(1),
                    device=card).to(dtype)
    whole = pk.avg_pool_nhwc(x, 2)
    rev = pk.avg_pool_nhwc(x.flip(0).contiguous(), 2).flip(0)
    torch.cuda.synchronize()
    assert torch.equal(whole, rev)
    for i in (0, 3, 5):
        alone = pk.avg_pool_nhwc(x[i:i + 1], 2)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], whole[i])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,k", [((2, 28, 28, 256), 2), ((2, 15, 17, 80), 2),
                                     ((2, 20, 23, 96), 3)])
def test_avg_pool_gradient_on_card_matches_the_library(card, shape, k, dtype):
    """Under autograd the forward launches the kernel and the backward is
    the plain gradient: both bit for bit the library pool's, on the card."""
    from leclip_tpu_torch.ops import pool_kernels as pk

    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(*shape, generator=g, device=card).to(dtype)
    cot = torch.randn(shape[0], shape[1] // k, shape[2] // k, shape[3], generator=g,
                      device=card).to(dtype)
    xa = x.clone().requires_grad_(True)
    before = pk.avg_pool_nhwc.launches
    out = pk.avg_pool_nhwc(xa, k)
    assert pk.avg_pool_nhwc.launches == before + 1 and out.requires_grad
    out.backward(cot)
    xb = x.clone().requires_grad_(True)
    ref = _library_pool(xb, k)
    ref.backward(cot)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert xa.grad.dtype == dtype and torch.equal(xa.grad, xb.grad)


def test_avg_pool_refuses_what_it_cannot_compute(card):
    """The wrapper raises, launching nothing, on another dtype, a
    non-contiguous map, a pixel whose channels do not fill 16-byte vectors,
    a map that does not start on a 16-byte boundary and a window larger
    than the map."""
    from leclip_tpu_torch.ops import pool_kernels as pk

    x = torch.randn(2, 8, 8, 64, device=card)
    before = pk.avg_pool_nhwc.launches
    with pytest.raises(TypeError, match="bf16 or fp32"):
        pk.avg_pool_nhwc(x.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        pk.avg_pool_nhwc(x.transpose(1, 2), 2)
    with pytest.raises(ValueError, match="16-byte"):
        pk.avg_pool_nhwc(x[..., :4].contiguous().bfloat16(), 2)
    with pytest.raises(ValueError, match="16-byte"):
        pk.avg_pool_nhwc(torch.randn(1 + 2 * 8 * 8 * 64, device=card)[1:].view(2, 8, 8, 64), 2)
    with pytest.raises(ValueError, match="does not fit"):
        pk.avg_pool_nhwc(x, 9)
    assert pk.avg_pool_nhwc.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_rn50_trunk_pools_on_the_kernel_with_the_library_bits(card, dtype, monkeypatch):
    """resnet_features at RN50's geometry (16 crops of 224²), bf16 and
    fp32: seven pool launches a forward, and the layer4 map bit for bit
    that of the same forward with models/resnet.avg_pool patched back to the
    library pool."""
    from leclip_tpu_torch.models import resnet
    from leclip_tpu_torch.ops import pool_kernels as pk

    vis = _rn50_bf16(card, 3, dtype)
    x = torch.rand(16, 224, 224, 3, generator=torch.Generator(device=card).manual_seed(9),
                   device=card).to(dtype)
    before = pk.avg_pool_nhwc.launches
    with torch.inference_mode():
        got = resnet.resnet_features(x, vis)
        assert pk.avg_pool_nhwc.launches == before + 7
        monkeypatch.setattr(resnet, "avg_pool",
                            lambda y, k: y if k <= 1 else _library_pool(y, k))
        ref = resnet.resnet_features(x, vis)
    assert pk.avg_pool_nhwc.launches == before + 7
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, ref), (got.float() - ref.float()).abs().max().item()
