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
    kernels once a layer."""
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
