"""Text and ViT towers of the port against leclip_tpu's, same weights (moved
across with the bridge), fp32 at 2e-5 — plain and through the fused
(kernel-wrapper) branch, whose CPU path is the kernels' plain version; the
JAX side runs its Pallas kernels in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_port
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import text as jtext
from leclip_tpu.models import vit as jvit
from leclip_tpu_torch.models import text as ttext
from leclip_tpu_torch.models import vit as tvit

torch.set_num_threads(2)

CFG = jclip.PRESETS["ViT-TEST"]


@pytest.fixture(scope="module")
def towers():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    text = jtext.init_text_params(k1, 512, 77, CFG.transformer_width,
                                  CFG.transformer_layers, CFG.embed_dim)
    visual = jvit.init_vit_params(k2, 64, 16, CFG.vision_width, CFG.vision_layers, CFG.embed_dim)
    return text, visual


def _tokens(n, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, 77), np.int32)
    for i in range(n):
        length = int(rng.integers(3, 20))
        toks[i, :length] = rng.integers(1, 500, length)
        toks[i, length] = 511  # EOT: the highest id
    return toks


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("sequence", [False, True])
def test_text_tower_matches_jax(towers, sequence, fused):
    text, _ = towers
    toks = _tokens(8)  # 8·77 rows: the JAX fused MLP engages
    ref = jtext.encode_text(text, jnp.asarray(toks), CFG.transformer_heads,
                            sequence=sequence, fused=fused)
    out = ttext.encode_text(to_port(text), torch.tensor(toks), CFG.transformer_heads,
                            sequence=sequence, fused=fused)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_vit_dense_matches_jax(towers, fused):
    _, visual = towers
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    g_ref, d_ref = jvit.encode_image_vit(jnp.asarray(x), visual, CFG.vision_heads, 16,
                                         dense=True, fused=fused)
    g, d = tvit.encode_image_vit(torch.tensor(x), to_port(visual), CFG.vision_heads, 16,
                                 dense=True, fused=fused)
    assert tuple(d.shape) == (2, 16, CFG.embed_dim)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=2e-5, rtol=2e-5)


def test_patchify_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    k = rng.standard_normal((16 * 16 * 3, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tvit.patchify(torch.tensor(x), torch.tensor(k), 16).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(x), jnp.asarray(k), 16)), atol=2e-5, rtol=2e-5)
