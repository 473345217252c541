"""The port's plain ``attn_block_bf16`` / ``mlp_bf16`` (what the wrappers run
on CPU tensors, and what the CUDA kernels are held against on the card)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

Tolerances: fp32 inputs 1e-5 (the JAX kernel tests' own; only summation
order differs). bf16 inputs: both sides round at the same points, so the
outputs differ by summation order propagated through the bf16 roundings —
at most a few bf16 ulps: |Δ| ≤ 4·2⁻⁸·max(1, |ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leclip_tpu.models import transformer as jtf
from leclip_tpu.ops import block_kernels as jbk
from leclip_tpu_torch.models import transformer as ttf
from leclip_tpu_torch.ops import block_kernels as tbk
from leclip_tpu_torch.ops import launches

torch.set_num_threads(2)

# (batch, tokens, width, heads, kv_len, causal); rows = batch·tokens % 8 == 0
# so the JAX side really runs its kernels
CASES = {
    "vit_pad_keys": (3, 24, 64, 2, 17, False),
    "text_causal_77": (8, 77, 64, 2, 77, True),
    "four_heads": (2, 16, 128, 4, 16, False),
}


def _inputs(b, t, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    attn = [1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((d, 3 * d)) * d ** -0.5, 0.02 * rng.standard_normal(3 * d),
            rng.standard_normal((d, d)) * d ** -0.5, 0.02 * rng.standard_normal(d)]
    mlp = [1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
           rng.standard_normal((d, 4 * d)) * (2 * d) ** -0.5, 0.02 * rng.standard_normal(4 * d),
           rng.standard_normal((4 * d, d)) * d ** -0.5, 0.02 * rng.standard_normal(d)]
    return x, [a.astype(np.float32) for a in attn], [a.astype(np.float32) for a in mlp]


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrays], [torch.tensor(a).to(tdt) for a in arrays])


def _close(out, ref, dtype):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    if dtype == "fp32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        tol = 4 * 2.0 ** -8 * np.maximum(1.0, np.abs(ref))
        assert (np.abs(out - ref) <= tol).all(), np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attn_block_matches_jax_kernel(case, dtype):
    b, t, d, h, kv, causal = CASES[case]
    x, attn, _ = _inputs(b, t, d)
    (jx, *jw), (tx, *tw) = _both([x] + attn, dtype)
    ref = jbk.attn_block_bf16(jx, *jw, h, kv_len=kv, causal=causal)
    out = tbk.attn_block_bf16(tx, *tw, h, kv_len=kv, causal=causal)
    _close(out, np.asarray(ref.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mlp_matches_jax_kernel(case, dtype):
    b, t, d, *_ = CASES[case]
    x, _, mlp = _inputs(b, t, d, seed=1)
    (jx, *jw), (tx, *tw) = _both([x] + mlp, dtype)
    ref = jbk.mlp_bf16(jx, *jw)
    out = tbk.mlp_bf16(tx, *tw)
    _close(out, np.asarray(ref.astype(jnp.float32)), dtype)


def test_pad_keys_do_not_leak():
    """Changing a pad key row (col ≥ kv_len) leaves the real rows unchanged."""
    b, t, d, h, kv, _ = CASES["vit_pad_keys"]
    x, attn, _ = _inputs(b, t, d)
    tw = [torch.tensor(a) for a in attn]
    x1 = torch.tensor(x)
    x2 = x1.clone()
    x2[:, t - 1] += 3.0
    o1 = tbk.attn_block_bf16(x1, *tw, h, kv_len=kv)
    o2 = tbk.attn_block_bf16(x2, *tw, h, kv_len=kv)
    torch.testing.assert_close(o1[:, :kv], o2[:, :kv], rtol=0, atol=1e-6)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    launches.reset_launch_counts()
    x, attn, mlp = _inputs(1, 8, 64)
    tbk.attn_block_bf16(torch.tensor(x), *[torch.tensor(a) for a in attn], 2)
    tbk.mlp_bf16(torch.tensor(x), *[torch.tensor(a) for a in mlp])
    counts = launches.launch_counts()
    assert counts["attn_block_bf16"] == 0 and counts["mlp_bf16"] == 0


def _block(d, seed):
    _, attn, mlp = _inputs(1, 1, d, seed)
    names = [("ln_1", "scale"), ("ln_1", "bias"), ("attn", "qkv_kernel"), ("attn", "qkv_bias"),
             ("attn", "out_kernel"), ("attn", "out_bias")]
    names2 = [("ln_2", "scale"), ("ln_2", "bias"), ("mlp", "fc_kernel"), ("mlp", "fc_bias"),
              ("mlp", "proj_kernel"), ("mlp", "proj_bias")]
    p = {}
    for (g, k), a in zip(names + names2, attn + mlp):
        p.setdefault(g, {})[k] = a
    return p


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_residual_block_matches_jax(fused, causal):
    """The port's residual block (fused branch through the kernel wrappers,
    plain branch unfused) against JAX's, fp32 at 2e-5."""
    b, t, d, h = 2, 24, 64, 2
    p = _block(d, 3)
    x = np.random.default_rng(4).standard_normal((b, t, d)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.tensor, p)
    if causal:
        jmask = jnp.asarray(np.triu(np.full((t, t), -np.inf, np.float32), 1))
        ref = jtf.residual_block(jnp.asarray(x), jp, h, mask=jmask, causal=True, fused=fused)
        out = ttf.residual_block(torch.tensor(x), tp, h, mask=torch.tensor(np.asarray(jmask)),
                                 causal=True, fused=fused)
    else:
        ref = jtf.residual_block(jnp.asarray(x), jp, h, kv_len=19, fused=fused)
        out = ttf.residual_block(torch.tensor(x), tp, h, kv_len=19, fused=fused)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
