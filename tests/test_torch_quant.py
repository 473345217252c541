"""The port's int8 weight preparation (leclip_tpu_torch/ops/quant.py) against
leclip_tpu/ops/quant.py, leaf by leaf on the same numpy inputs, and the
precision rule (engine/config.py resolve_test_precision) against the JAX
package's over precisions × backbones × devices.

Tolerances: the codes of ``quantize_weight`` / ``quantize_rows`` equal (one
IEEE division and a round on the same floats); scales and equilibrated LN
affines 1e-6 relative (one fp32 ulp of a division / square root); the int8
leaves of ``quantize_block_stack`` equal except where the equilibrated
weight, an ulp apart on the two sides (mean and sqrt rounded in another
order), sits on a .5 boundary: at most 1e-4 of a leaf's codes, each off by
exactly 1 (measured: 1 of 98,304 in one of six fixtures, none in the rest);
the plain W8A8 matmul 1e-6 (exact integer sums on both sides, the same fp32
epilogue)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import block_stack, leaves, to_port
from leclip_tpu.engine import config as jconfig
from leclip_tpu.models import clip as jclip
from leclip_tpu.ops import quant as jq
from leclip_tpu_torch.engine import config as tconfig
from leclip_tpu_torch.models import clip as tclip
from leclip_tpu_torch.models.convert import from_jax_q8, to_jax_params
from leclip_tpu_torch.ops import quant as tq

torch.set_num_threads(2)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("shape,std", [((64, 128), 0.05), ((128, 384), 0.02),
                                       ((3, 64, 256), 0.05)])
def test_quantize_weight_matches_jax(shape, std):
    w = (np.random.default_rng(0).standard_normal(shape) * std).astype(np.float32)
    w[..., 3, 5] = 0.0
    w[..., :, 7] = 0.0  # an all-zero channel: the 1e-12 floor on its scale
    jfn = jq.quantize_weight if w.ndim == 2 else jax.vmap(jq.quantize_weight)
    ji8, js = jfn(jnp.asarray(w))
    ti8, ts = tq.quantize_weight(torch.tensor(w))
    assert ti8.dtype == torch.int8 and ts.dtype == torch.float32
    assert ti8.shape == tuple(ji8.shape) and ts.shape == tuple(js.shape)
    np.testing.assert_array_equal(ti8.numpy(), np.asarray(ji8))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert int(ti8.abs().max()) == 127 and int(ti8.min()) >= -127
    # the kernel layout: every output channel's K values lie together
    assert ti8.transpose(-1, -2).is_contiguous()
    assert tq.kernel_layout(ti8).data_ptr() == ti8.data_ptr()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_rows_matches_jax(dtype):
    x = (np.random.default_rng(1).standard_normal((4, 9, 64)) * 3).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.tensor(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    ji8, js = jq.quantize_rows(jx)
    ti8, ts = tq.quantize_rows(tx)
    assert ts.shape == (4, 9, 1)
    np.testing.assert_array_equal(ti8.numpy(), np.asarray(ji8))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("bias", [True, False])
def test_int8_matmul_matches_jax(bias):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 8, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 192)) * 0.03).astype(np.float32)
    b = (rng.standard_normal(192) * 0.1).astype(np.float32) if bias else None
    ji8, js = jq.quantize_weight(jnp.asarray(w))
    ti8, ts = tq.quantize_weight(torch.tensor(w))
    ref = jq.int8_matmul(jnp.asarray(x), ji8, js, bias=None if b is None else jnp.asarray(b),
                         out_dtype=jnp.float32)
    out = tq.int8_matmul(torch.tensor(x), ti8, ts, bias=None if b is None else torch.tensor(b),
                         out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    xi, sx = tq.quantize_rows(torch.tensor(x))
    pre = tq.int8_matmul_prequant(xi, sx, ti8, ts, bias=None if b is None else torch.tensor(b),
                                  out_dtype=torch.float32)
    torch.testing.assert_close(pre, out, rtol=0, atol=0)


def test_int_matmul_is_exact_where_fp32_is_not():
    """K = 3072 rows of ±127: the sums pass 2^24, which fp32 cannot hold."""
    k = 3072
    a = torch.full((2, k), 127, dtype=torch.int8)
    a[1, ::2] = -127
    w = torch.full((k, 3), 127, dtype=torch.int8)
    w[1, 0] = 126
    out = tq.int_matmul(a, w)
    exact = (a.to(torch.int64) @ w.to(torch.int64))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, exact.to(torch.float32), rtol=0, atol=0)
    assert int(exact[0, 0]) == 127 * 127 * k - 127 and int(exact[0, 0]) > 2 ** 24


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("outlier", [None, 10.0, 50.0])
def test_equilibrate_matches_jax(outlier, dtype):
    blocks = block_stack(64, 2, 3, dtype, outlier)
    tb = to_port(blocks)
    (jg, jb), jk = jq._equilibrate(*(jnp.asarray(blocks["ln_1"][k]) for k in ("scale", "bias")),
                                   jnp.asarray(blocks["attn"]["qkv_kernel"]))
    (tg, tbias), tk = tq._equilibrate(tb["ln_1"]["scale"], tb["ln_1"]["bias"],
                                      tb["attn"]["qkv_kernel"])
    assert tg.dtype == tb["ln_1"]["scale"].dtype and tk.dtype == tb["attn"]["qkv_kernel"].dtype
    # fp32: one ulp of sqrt / division; bf16: the cast back rounds both alike
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "fp32" else dict(rtol=2 ** -7, atol=1e-6)
    for t, j in ((tg, jg), (tbias, jb), (tk, jk)):
        np.testing.assert_allclose(_np(t), np.asarray(j.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("outlier", [None, 10.0, 50.0])
@pytest.mark.parametrize("width,layers", [(64, 3), (128, 2)])
def test_quantize_block_stack_matches_jax_leaf_by_leaf(width, layers, outlier):
    blocks = block_stack(width, layers, 4, "fp32", outlier)
    jq8 = jax.device_get(jq.quantize_block_stack(jax.tree.map(jnp.asarray, blocks)))
    tq8 = tq.quantize_block_stack(to_port(blocks))
    tl = dict(leaves(_as_dicts(to_jax_params(tq8))))
    jl = dict(leaves(_as_dicts(jq8)))
    assert sorted(tl) == sorted(jl) and len(tl) == 10
    for path, j in jl.items():
        t = tl[path]
        assert t.shape == j.shape and t.dtype == j.dtype, path
        if j.dtype == np.int8:
            d = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert d.max() <= 1 and (d != 0).mean() <= 1e-4, (path, int(d.sum()))
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7, err_msg=path)
    # int8 kernels come back [in, out] in the kernel layout, per layer
    qkv_i8 = tq8["attn"]["qkv"][0]
    assert qkv_i8.shape == (layers, width, 3 * width) and qkv_i8[0].t().is_contiguous()


def _as_dicts(tree):
    """Tuples → dicts keyed by position, so ``leaves`` names every leaf."""
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return {str(i): _as_dicts(v) for i, v in enumerate(tree)}
    return tree


def test_to_jax_params_keeps_tuples_and_int8():
    q8 = tq.quantize_block_stack(to_port(block_stack(64, 1, 5)))
    back = to_jax_params(q8)
    assert isinstance(back["attn"]["qkv"], tuple) and back["attn"]["qkv"][0].dtype == np.int8
    assert back["ln1"][0].shape == (1, 64)


def test_q8_bridge_round_trips_and_sets_the_kernel_layout():
    blocks = block_stack(64, 2, 6, "bf16", 10.0)
    jq8 = jax.device_get(jq.quantize_block_stack(jax.tree.map(jnp.asarray, blocks)))
    tq8 = from_jax_q8(jq8)
    assert tq8["ln1"][0].dtype == torch.bfloat16  # the LN affine keeps the params' dtype
    w = tq8["mlp"]["proj"][0]
    assert w.dtype == torch.int8 and w.shape == (2, 256, 64) and w[1].t().is_contiguous()
    import ml_dtypes

    back = to_jax_params(tq8, bf16_dtype=ml_dtypes.bfloat16)
    for (pj, j), (pt, t) in zip(leaves(_as_dicts(jq8)), leaves(_as_dicts(back))):
        assert pj == pt and t.dtype == j.dtype
        np.testing.assert_array_equal(np.asarray(t, np.float32), np.asarray(j, np.float32))


def test_quantize_stack_on_device_cpu_accepts_any_width():
    """The width guard belongs to the CUDA kernels; on the CPU (plain
    versions) toy widths pass, as JAX's interpret mode accepts them."""
    q8 = tq.quantize_stack_on_device(to_port(block_stack(48, 1, 7)))
    assert q8["attn"]["qkv"][0].shape == (1, 48, 144)
    assert not q8["attn"]["qkv"][1].requires_grad


# ------------------------------ precision rule ------------------------------

_BACKBONES = ["ViT-B/16", "ViT-L/14", "RN50"]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("backbone", _BACKBONES)
@pytest.mark.parametrize("prec", ["auto", "fp32", "bf16", "int8"])
def test_resolve_test_precision_matches_jax_rule(prec, backbone, device):
    """A CUDA device stands where the JAX rule says backend == 'tpu'. A
    torch.device("cuda") object resolves without a card."""
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        ref = jconfig.resolve_test_precision(prec, jclip.PRESETS[backbone],
                                             backend="tpu" if device == "cuda" else "cpu")
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        out = tconfig.resolve_test_precision(prec, tclip.PRESETS[backbone], torch.device(device))
    assert out == ref
    assert len(tw) == len(jw)
    assert tconfig.resolve_test_precision(prec, tclip.PRESETS[backbone], device) == out
    want = {"fp32": "fp32", "bf16": "bf16"}.get(prec)
    if want is None:
        vit, on_card = backbone.startswith("ViT"), device == "cuda"
        if prec == "auto":
            want = "int8" if backbone == "ViT-B/16" and on_card else "bf16"
        else:  # explicit int8: honoured on any ViT on the card, else bf16 + warning
            want = "int8" if vit and on_card else "bf16"
            assert len(tw) == (0 if want == "int8" else 1)
    assert out == want


def test_resolve_test_precision_rejects_unknown_and_keeps_the_gate():
    assert tconfig.GATE_VALIDATED_INT8_VISION_WIDTHS == jconfig.GATE_VALIDATED_INT8_VISION_WIDTHS
    with pytest.raises(ValueError, match="TEST.PREC"):
        tconfig.resolve_test_precision("fp16", tclip.PRESETS["ViT-B/16"], "cuda")
    assert tconfig.resolve_test_precision("auto", tclip.PRESETS["ViT-B/32"], "cuda:0") == "int8"
