"""The port's ``resident_attention`` and ``flash_attention`` (what the wrappers
run on CPU tensors, and what the CUDA kernels are held against on the card)
against the JAX package's Pallas kernels, run in interpret mode on the CPU,
as tests/test_resident_attention.py and tests/test_flash_attention.py run
them.

Tolerances: fp32 2e-5 (the JAX kernel tests' own; summation order only);
gradients 3e-5 (the JAX custom-VJP test's own). bf16: both sides round p
and the output at the same points, so they differ by summation order
propagated through those roundings — at most 2 bf16 ulps of max(1, |ref|),
|Δ| ≤ 2·2⁻⁸·max(1, |ref|). Flash attention is checked in both rounding
regimes of the TPU kernel: one key block (T=24 → 128 keys) and two (T=300 →
512 keys in blocks of 256)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leclip_tpu.ops import flash_attention as jfa
from leclip_tpu.ops.attention import causal_mask as jcausal
from leclip_tpu_torch.ops import flash_attention as tfa
from leclip_tpu_torch.ops import launches

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.tensor(np.asarray(jnp.asarray(a, jdt), np.float32)).to(tdt) for a in arrays])


def _close(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    if dtype == "fp32":
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    else:
        tol = 2 * 2.0 ** -8 * np.maximum(1.0, np.abs(ref))
        assert (np.abs(out - ref) <= tol).all(), np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,t,heads,kv_len", [(3, 24, 2, 24), (2, 40, 2, 33)])
def test_resident_matches_jax(dtype, b, t, heads, kv_len):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((b, t, heads * 64), 0), dtype)
    ref = jfa.resident_attention(jq, jk, jv, heads, kv_len)
    before = launches.launch_counts()
    out = tfa.resident_attention(tq, tk, tv, heads, kv_len)
    assert out.dtype == tq.dtype
    assert launches.launch_counts() == before  # CPU tensors run the plain version
    _close(out, ref, dtype)


@pytest.mark.parametrize("kv_len", [16, 13])
def test_packed_reference_matches_jax(kv_len):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, 16, 2 * 8), 1), "fp32")
    ref = jfa._xla_packed_attention(jq, jk, jv, 2, kv_len)
    _close(tfa.packed_attention_reference(tq, tk, tv, 2, kv_len), ref, "fp32")


@pytest.mark.parametrize("kv_len", [None, 5])
def test_resident_gradients_match_jax(kv_len):
    b, t, heads = 2, 8, 2
    arrays = _qkv((b, t, heads * 8), 2)
    cot = np.random.default_rng(3).standard_normal((b, t, heads * 8)).astype(np.float32)

    def loss(q, k, v):
        return (jfa.resident_attention(q, k, v, heads, kv_len) * cot).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    qkv = [torch.tensor(a, requires_grad=True) for a in arrays]
    (tfa.resident_attention(*qkv, heads, kv_len) * torch.tensor(cot)).sum().backward()
    for a, r in zip(qkv, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), atol=3e-5, rtol=3e-5)


def _mask(kind, t):
    if kind == "none":
        return None, None
    if kind == "pad":  # the ViT's [T] pad-key row, as attention_from_qkv builds it
        m = np.where(np.arange(t) < t - 3, 0.0, -1e30).astype(np.float32)
    else:
        m = np.asarray(jcausal(t), np.float32)
        if kind == "masked_row":  # row 5 sees no key: p uniform over the padded key blocks
            m = m.copy()
            m[5] = -np.inf
    return jnp.asarray(m), torch.tensor(m)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mask", ["none", "pad", "causal", "masked_row"])
@pytest.mark.parametrize("t", [24, 300])
def test_flash_matches_jax(dtype, mask, t):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((1, 2, t, 64), 4), dtype)
    jm, tm = _mask(mask, t)
    ref = jfa.flash_attention(jq, jk, jv, mask=jm)
    before = launches.launch_counts()
    out = tfa.flash_attention(tq, tk, tv, mask=tm)
    assert launches.launch_counts() == before
    assert out.dtype == tq.dtype
    _close(out, ref, dtype)


@pytest.mark.parametrize("t,block_k", [(24, 128), (77, 128), (128, 128), (200, 256),
                                       (264, 256), (300, 256), (600, 256)])
def test_flash_block_sizes_and_rounding_regimes(t, block_k):
    """The TPU wrapper's key block (its default block_k of 256) picks the
    regime: T ≤ 256 is one key block (every CLIP length), ViT-L/14's 264
    two."""
    assert tfa.flash_block_k(t) == block_k
