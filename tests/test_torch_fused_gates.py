"""Where the port's fused bf16 block runs its kernels: the JAX reference's
VMEM gates (``fits_vmem_attn`` / ``fits_vmem_mlp`` and rows % 8), held
against JAX's ``residual_block(fused=True)`` with its Pallas kernels in
interpret mode on the CPU, and the bf16 caption bank's batch-size rule.

Tolerance: both sides round at the same bf16 points and differ only in fp32
summation order, so |Δ| ≤ 4 bf16 ulps of max(1, |ref|) everywhere. Where the
port ran ``mlp_bf16`` while JAX ran its unfused bf16 MLP (D = 1024), the two
round at different points and the gap exceeded that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leclip_tpu.models import transformer as jtf
from leclip_tpu.ops import block_kernels as jbk
from leclip_tpu_torch.inference import pipeline as tpipe
from leclip_tpu_torch.models import transformer as ttf
from leclip_tpu_torch.ops import block_kernels as tbk

torch.set_num_threads(2)


def _params(d, seed):
    """One block's weights, drawn as tests/test_torch_block_kernels.py
    ``_inputs`` draws them."""
    rng = np.random.default_rng(seed)
    p = {
        "ln_1": {"scale": 1 + 0.1 * rng.standard_normal(d), "bias": 0.1 * rng.standard_normal(d)},
        "attn": {"qkv_kernel": rng.standard_normal((d, 3 * d)) * d ** -0.5,
                 "qkv_bias": 0.02 * rng.standard_normal(3 * d),
                 "out_kernel": rng.standard_normal((d, d)) * d ** -0.5,
                 "out_bias": 0.02 * rng.standard_normal(d)},
        "ln_2": {"scale": 1 + 0.1 * rng.standard_normal(d), "bias": 0.1 * rng.standard_normal(d)},
        "mlp": {"fc_kernel": rng.standard_normal((d, 4 * d)) * (2 * d) ** -0.5,
                "fc_bias": 0.02 * rng.standard_normal(4 * d),
                "proj_kernel": rng.standard_normal((4 * d, d)) * d ** -0.5,
                "proj_bias": 0.02 * rng.standard_normal(d)},
    }
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tbk, name)

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tbk, name, spy)
    return calls


@pytest.mark.parametrize("b,t,d,heads,kv_len,attn_kernel,mlp_kernel", [
    (2, 16, 1024, 16, 13, True, False),   # ViT-L/14 width: 4·D·4D bytes > 12 MiB
    (1, 7, 64, 2, 7, True, False),        # rows % 8 != 0
    (2, 12, 64, 2, 12, True, True),       # both gates pass
])
def test_fused_block_takes_the_reference_gates(monkeypatch, b, t, d, heads, kv_len,
                                               attn_kernel, mlp_kernel):
    p = _params(d, 5)
    x = np.random.default_rng(6).standard_normal((b, t, d)).astype(np.float32)
    assert jbk.fits_vmem_attn(d) == tbk.fits_vmem_attn(d)
    assert jbk.fits_vmem_mlp(d, 4 * d) == tbk.fits_vmem_mlp(d, 4 * d)
    ref = jtf.residual_block(jnp.asarray(x, jnp.bfloat16),
                             jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p),
                             heads, kv_len=kv_len, fused=True)
    attn_calls, mlp_calls = _spy(monkeypatch, "attn_block_bf16"), _spy(monkeypatch, "mlp_bf16")
    out = ttf.residual_block(torch.tensor(x).bfloat16(),
                             jax.tree.map(lambda a: torch.tensor(a).bfloat16(), p),
                             heads, kv_len=kv_len, fused=True)
    assert (len(attn_calls), len(mlp_calls)) == (int(attn_kernel), int(mlp_kernel))
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    diff = np.abs(out - ref)
    tol = 4 * 2.0 ** -8 * np.maximum(1.0, np.abs(ref))
    assert (diff <= tol).all(), (diff / (2.0 ** -8 * np.maximum(1.0, np.abs(ref)))).max()


def test_gates_match_the_reference_at_every_clip_width():
    for d in (256, 512, 640, 768, 886, 887, 1024, 1254, 1280):
        assert tbk.fits_vmem_attn(d) == jbk.fits_vmem_attn(d)
        assert tbk.fits_vmem_mlp(d, 4 * d) == jbk.fits_vmem_mlp(d, 4 * d)
    assert tbk.fits_vmem_mlp(768, 3072) and not tbk.fits_vmem_mlp(1024, 4096)


@pytest.mark.parametrize("device,batch_size,fuses", [
    ("cuda", 256, True), ("cuda", 8, True), ("cuda", 6, False), ("cpu", 256, False),
])
def test_bank_fuses_only_where_the_reference_does(device, batch_size, fuses):
    assert tpipe.bank_fuses(device, batch_size) is fuses


@pytest.mark.parametrize("batch_size,fused", [(6, False), (8, True)])
def test_bf16_bank_fuses_by_batch_size(monkeypatch, batch_size, fused):
    seen = []
    real = tpipe.encode_text

    def spy(*a, **k):
        seen.append(k["fused"])
        return real(*a, **k)

    rule = tpipe.bank_fuses
    monkeypatch.setattr(tpipe, "encode_text", spy)
    # the decision the card would take, on CPU tensors
    monkeypatch.setattr(tpipe, "bank_fuses", lambda device, batch_size: rule("cuda", batch_size))
    from leclip_tpu_torch.data.tokenizer import tokenize
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params

    cfg = PRESETS["ViT-TEST"]
    params = init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = tokenize(["a dog", "a cat on a couch", "two buses", "a red bicycle"])
    tpipe.build_caption_bank(params, cfg, toks, batch_size=batch_size, precision="bf16",
                             device="cpu")
    assert seen == [fused]
