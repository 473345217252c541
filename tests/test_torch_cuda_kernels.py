"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card (marker ``cuda``) and skip without one. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: kernel and plain version round to bf16 at the same points and
differ only in fp32 summation order, so |Δ| ≤ 4 bf16 ulps of max(1, |ref|)."""

import pytest
import torch

from leclip_tpu_torch.ops import block_kernels as bk

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
])
def test_attn_block_kernel_matches_plain(card, b, t, d, heads, kv_len, causal):
    rn, attn, _ = _weights(card, d, 4 * d, 0)
    x = rn(b, t, d)
    before = bk.attn_block_bf16.launches
    out = bk.attn_block_bf16(x, *attn, heads, kv_len=kv_len, causal=causal)
    assert bk.attn_block_bf16.launches == before + 1
    _close(out, bk.attn_block_bf16_plain(x, *attn, heads, kv_len=kv_len, causal=causal))


@pytest.mark.parametrize("rows,d", [(1000, 768), (77 * 9, 512), (13, 128), (300, 1024)])
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
