"""The port's plain ``ln_quant`` / ``attn_block_int8`` / ``mlp_int8`` (what the
wrappers run on CPU tensors, and what the CUDA kernels are held against on
the card) against the JAX package's Pallas kernels, run in interpret mode on
the CPU and fed the very same quantized weights through the convert.py
bridge.

Tolerances (each at most ten times the measured gap; the JAX suite's own
kernel-vs-unfused bound is atol 5e-3 / rtol 1e-2):
* ln_quant: scales 1e-6 relative; codes equal except where LN(x)/s sits within
  an ulp of a .5 boundary — at most 1e-4 of them, each off by exactly 1
  (measured: none in these fixtures).
* fp32 inputs: attention 5e-5 (measured 1.1e-5), MLP 1e-5 (measured 1.9e-6):
  exact integer sums on both sides, so only fp32 summation order and one-ulp
  differences in exp / sigmoid remain.
* bf16 inputs: both sides round at the same points; at most 4 bf16 ulps:
  |Δ| ≤ 4·2⁻⁸·max(1, |ref|) (measured 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import block_stack, to_port
from leclip_tpu.models import transformer as jtf
from leclip_tpu.ops import quant as jq
from leclip_tpu.ops import quant_kernels as jqk
from leclip_tpu_torch.models import transformer as ttf
from leclip_tpu_torch.models.convert import from_jax_q8
from leclip_tpu_torch.ops import launches
from leclip_tpu_torch.ops import quant_kernels as tqk

torch.set_num_threads(2)

# (batch, tokens, width, heads, kv_len, causal)
CASES = {
    "vit_pad_keys": (3, 24, 64, 2, 17, False),
    "text_causal_77": (8, 77, 64, 2, 77, True),
    "four_heads": (2, 16, 128, 4, 16, False),
}


def _layer(width, dtype, seed=11):
    """One quantized layer on both sides: JAX's quantize_block_stack output
    (outlier LN channels ×10) carried into the port by the bridge, plus the
    block's own unquantized leaves."""
    blocks = block_stack(width, 1, seed, dtype, 10.0)
    jq8 = jax.device_get(jq.quantize_block_stack(jax.tree.map(jnp.asarray, blocks)))
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), jq8)
    jb = jax.tree.map(lambda a: jnp.asarray(a[0]), blocks)
    return jl, jb, ttf.layer_params(from_jax_q8(jq8), 0), ttf.layer_params(to_port(blocks), 0)


def _x(b, t, d, dtype, seed=5):
    x = np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.tensor(x)


def _attn_args(q8, blk):
    return (*q8["ln1"], *q8["attn"]["qkv"], blk["attn"]["qkv_bias"], blk["attn"]["out_kernel"],
            blk["attn"]["out_bias"])


def _mlp_args(q8, blk):
    return (*q8["ln2"], *q8["mlp"]["fc"], blk["mlp"]["fc_bias"], *q8["mlp"]["proj"],
            blk["mlp"]["proj_bias"])


def _close(out, ref, dtype, fp32_tol):
    out = out.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.shape == ref.shape and np.isfinite(out).all()
    if dtype == "fp32":
        np.testing.assert_allclose(out, ref, atol=fp32_tol, rtol=fp32_tol)
    else:
        tol = 4 * 2.0 ** -8 * np.maximum(1.0, np.abs(ref))
        assert (np.abs(out - ref) <= tol).all(), np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ln_quant_matches_jax_kernel(case, dtype):
    b, t, d, *_ = CASES[case]
    jl, _, tl, _ = _layer(d, dtype)
    jx, tx = _x(b, t, d, dtype)
    ji, js = jqk.ln_quant(jx, *jl["ln1"])
    ti, ts = tqk.ln_quant(tx, *tl["ln1"])
    assert ti.dtype == torch.int8 and ts.dtype == torch.float32
    assert ti.shape == (b, t, d) and ts.shape == (b, t, 1)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    diff = np.abs(ti.numpy().astype(np.int32) - np.asarray(ji, np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-4
    assert int(ti.abs().amax(-1).min()) == 127  # every row reaches full scale


def test_ln_quant_reconstructs_layer_norm():
    """x_i8 · s is LN(x) to half a quantization step, as the JAX suite holds
    its kernel."""
    _, _, tl, _ = _layer(64, "fp32")
    _, tx = _x(4, 16, 64, "fp32", seed=7)
    xi, s = tqk.ln_quant(tx, *tl["ln1"])
    y = ttf.layer_norm(tx, *tl["ln1"])
    assert ((xi.float() * s - y).abs() <= 0.5 * s + 1e-5).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attn_block_int8_matches_jax_kernel(case, dtype):
    b, t, d, h, kv, causal = CASES[case]
    jl, jb, tl, tb = _layer(d, dtype)
    jx, tx = _x(b, t, d, dtype)
    ref = jqk.attn_block_int8(jx, *_attn_args(jl, jb), h, kv_len=kv, causal=causal)
    out = tqk.attn_block_int8(tx, *_attn_args(tl, tb), h, kv_len=kv, causal=causal)
    assert out.dtype == tx.dtype
    _close(out, ref, dtype, 5e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mlp_int8_matches_jax_kernel(case, dtype):
    b, t, d, *_ = CASES[case]
    jl, jb, tl, tb = _layer(d, dtype, seed=12)
    jx, tx = _x(b, t, d, dtype, seed=6)
    ref = jqk.mlp_int8(jx, *_mlp_args(jl, jb))
    out = tqk.mlp_int8(tx, *_mlp_args(tl, tb))
    assert out.dtype == tx.dtype
    _close(out, ref, dtype, 1e-5)
    # rows are independent: any leading shape is taken
    flat = tqk.mlp_int8(tx.reshape(b * t, d), *_mlp_args(tl, tb))
    torch.testing.assert_close(flat.reshape(b, t, d), out, rtol=0, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mlp_int8_with_hidden_returns_the_codes_its_proj_reads(case):
    """The hidden codes and scales mlp_int8_with_hidden returns are the fc
    hidden QuickGELU(fc(LN(x))) requantized per row (within half a step of
    it, computed here in fp64), and the proj product reads exactly them."""
    b, t, d, *_ = CASES[case]
    jl, jb, tl, tb = _layer(d, "fp32", seed=12)
    jx, tx = _x(b, t, d, "fp32", seed=6)
    args = _mlp_args(tl, tb)
    out, hi, hs = tqk.mlp_int8_with_hidden(tx, *args)
    torch.testing.assert_close(out, tqk.mlp_int8(tx, *args), rtol=0, atol=0)
    _close(out, jqk.mlp_int8(jx, *_mlp_args(jl, jb)), "fp32", 1e-5)
    assert hi.dtype == torch.int8 and hi.shape == (b * t, 4 * d) and hs.shape == (b * t, 1)
    assert hi.abs().amax(-1).eq(127).all()  # every row's absmax maps to the end code
    xi, xs = tqk.ln_quant(tx, *tl["ln2"])
    (fc_w, fc_s), fc_b = tl["mlp"]["fc"], tb["mlp"]["fc_bias"]
    h = (xi.reshape(-1, d).double() @ fc_w.double()) * (xs.reshape(-1, 1).double()
                                                        * fc_s.double()) + fc_b.double()
    h = h * torch.sigmoid(1.702 * h)
    hs64 = hs.double()
    assert ((hi.double() * hs64 - h).abs() <= 0.5 * hs64 * (1 + 1e-4) + 1e-7).all()
    (pj_w, pj_s), pj_b = tl["mlp"]["proj"], tb["mlp"]["proj_bias"]
    o = (hi.double() @ pj_w.double()) * (hs64 * pj_s.double()) + pj_b.double()
    torch.testing.assert_close(out.reshape(-1, d).double(), tx.reshape(-1, d).double() + o,
                               rtol=0, atol=2e-6)


def test_int8_pad_keys_do_not_leak():
    """Changing a pad key row (col ≥ kv_len) leaves the real rows unchanged."""
    b, t, d, h, kv, _ = CASES["vit_pad_keys"]
    _, _, tl, tb = _layer(d, "fp32")
    _, x1 = _x(b, t, d, "fp32")
    x2 = x1.clone()
    x2[:, t - 1] += 3.0
    o1 = tqk.attn_block_int8(x1, *_attn_args(tl, tb), h, kv_len=kv)
    o2 = tqk.attn_block_int8(x2, *_attn_args(tl, tb), h, kv_len=kv)
    torch.testing.assert_close(o1[:, :kv], o2[:, :kv], rtol=0, atol=1e-6)


def test_int8_cpu_tensors_take_the_plain_path_and_count_no_launch():
    launches.reset_launch_counts()
    _, _, tl, tb = _layer(64, "fp32")
    _, tx = _x(1, 8, 64, "fp32")
    tqk.ln_quant(tx, *tl["ln1"])
    tqk.attn_block_int8(tx, *_attn_args(tl, tb), 2)
    tqk.mlp_int8(tx, *_mlp_args(tl, tb))
    assert launches.launch_counts() == {"attn_block_bf16": 0, "mlp_bf16": 0, "ln_quant": 0,
                                        "attn_block_int8": 0, "mlp_int8": 0,
                                        "resident_attention": 0, "flash_attention": 0,
                                        "conv_bf16": 0, "conv_fp32": 0, "resize_band": 0,
                                        "avg_pool": 0}
    tqk.mlp_int8.launches = 3
    launches.reset_launch_counts()
    assert tqk.mlp_int8.launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_residual_block_q8_matches_jax(causal):
    """The port's residual block through its q8 branch against JAX's, fp32."""
    b, t, d, h = 2, 24, 64, 2
    jl, jb, tl, tb = _layer(d, "fp32", seed=13)
    jx, tx = _x(b, t, d, "fp32", seed=4)
    if causal:
        jmask = jnp.asarray(np.triu(np.full((t, t), -np.inf, np.float32), 1))
        ref = jtf.residual_block(jx, jb, h, mask=jmask, q8=jl, causal=True)
        out = ttf.residual_block(tx, tb, h, mask=torch.tensor(np.asarray(jmask)), q8=tl,
                                 causal=True)
    else:
        ref = jtf.residual_block(jx, jb, h, kv_len=19, q8=jl)
        out = ttf.residual_block(tx, tb, h, kv_len=19, q8=tl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)


def test_q8_refuses_an_additive_mask_that_is_not_causal():
    _, _, tl, tb = _layer(64, "fp32")
    _, tx = _x(1, 8, 64, "fp32")
    mask = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="causal"):
        ttf.residual_block(tx, tb, 2, mask=mask, q8=tl)


def test_unquantized_affines_are_replaced_not_added():
    """q8's ln1/ln2 replace the block's LN affines: changing the block's own
    leaves nothing changed on the q8 path."""
    _, _, tl, tb = _layer(64, "fp32")
    _, tx = _x(2, 8, 64, "fp32")
    ref = ttf.residual_block(tx, tb, 2, q8=tl)
    tb2 = {**tb, "ln_1": {"scale": tb["ln_1"]["scale"] * 3, "bias": tb["ln_1"]["bias"] + 1}}
    torch.testing.assert_close(ttf.residual_block(tx, tb2, 2, q8=tl), ref, rtol=0, atol=0)


def test_build_hash_covers_every_included_header(tmp_path, monkeypatch):
    """A library's name carries a hash of its source and of every header it
    includes, directly or through another header: editing a header renames
    exactly the libraries built from it, so none is loaded stale."""
    import shutil

    from leclip_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert set(_build.source_files("mlp_int8.cu")) == {"mlp_int8.cu", "gemm_int8.cuh",
                                                       "gemm_sm90.cuh", "quant.cuh",
                                                       "layernorm.cuh", "gemm.cuh"}
    assert {"attn_core.cuh", "gemm_sm90.cuh", "layernorm.cuh"} <= set(
        _build.source_files("attn_block_bf16.cu"))
    # the quantizer's exact forms live in quant.cuh, which the ln_quant row
    # pass shares with the int8 GEMM: ln_quant builds from it without the GEMM
    assert set(_build.source_files("ln_quant.cu")) == {"ln_quant.cu", "quant.cuh",
                                                       "layernorm.cuh", "gemm.cuh"}
    assert "quant_code_rcp" in (csrc / "quant.cuh").read_text()
    assert "quant_code_rcp(float" not in (csrc / "gemm_int8.cuh").read_text()

    def names():
        return {k: _build._lib_path(k).name for k in _build.KERNELS}

    before = names()
    with open(csrc / "quant.cuh", "a") as f:
        f.write("// edited\n")
    after = names()
    changed = {k for k in before if before[k] != after[k]}
    assert changed == {"ln_quant", "attn_block_int8", "mlp_int8"}
    with open(csrc / "attn_core.cuh", "a") as f:
        f.write("// edited\n")
    again = names()
    assert {k for k in after if after[k] != again[k]} == {"attn_block_bf16", "attn_block_int8",
                                                          "resident_attention",
                                                          "flash_attention"}
    with open(csrc / "attn_simt.cuh", "a") as f:
        f.write("// edited\n")
    last = names()
    assert {k for k in again if again[k] != last[k]} == {"resident_attention", "flash_attention"}
    # the LN row pass is shared by the bf16 and int8 blocks; the Hopper GEMM's
    # TMA, mbarrier and wgmma helpers by every block (the int8 GEMM is built
    # on them); the int8 GEMM by the two int8 blocks; the bf16 flash core (on
    # attn_core.cuh's primitives) by flash_attention alone
    for header, users in (("layernorm.cuh", {"attn_block_bf16", "mlp_bf16", "ln_quant",
                                             "attn_block_int8", "mlp_int8"}),
                          ("gemm_sm90.cuh", {"attn_block_bf16", "mlp_bf16", "attn_block_int8",
                                             "mlp_int8", "conv_bf16"}),
                          ("gemm_int8.cuh", {"attn_block_int8", "mlp_int8"}),
                          ("flash_mma.cuh", {"flash_attention"})):
        prev = names()
        with open(csrc / header, "a") as f:
            f.write("// edited\n")
        now = names()
        assert {k for k in prev if prev[k] != now[k]} == users, header
