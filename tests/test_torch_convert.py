"""Weight bridge: a leclip_tpu pytree goes into the port and back exactly,
and an OpenAI-layout ViT checkpoint gives the same port params through the
JAX converter + bridge as through the port's own loader."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port import leaves, openai_vit_state_dict, to_port
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import convert as jconvert
from leclip_tpu.models.text import init_text_params
from leclip_tpu_torch.models import clip as tclip
from leclip_tpu_torch.models import convert as tconvert

torch.set_num_threads(2)


def _assert_same_tree(a, b):
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8)), k


def _jax_tree(preset, tower):
    cfg = jclip.PRESETS[preset]
    if tower == "text":  # the text tower alone (RN-TEST's image tower is not ported)
        return jax.device_get(init_text_params(
            jax.random.PRNGKey(3), cfg.vocab_size, cfg.context_length, cfg.transformer_width,
            cfg.transformer_layers, cfg.embed_dim))
    return jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(3), cfg))


@pytest.mark.parametrize("preset,tower", [("ViT-TEST", None), ("RN-TEST", "text"),
                                          ("ViT-TEST", "text")])
def test_round_trip_is_exact(preset, tower):
    tree = _jax_tree(preset, tower)
    port = tconvert.from_jax_params(tree)
    assert all(isinstance(t, torch.Tensor) for _, t in leaves(port))
    _assert_same_tree(tree, tconvert.to_jax_params(port))


def test_round_trip_bf16_is_exact():
    params = jax.device_get(jclip.init_clip_params(
        jax.random.PRNGKey(4), jclip.PRESETS["ViT-TEST"], dtype=jnp.bfloat16))
    port = tconvert.from_jax_params(params["visual"])
    assert port["blocks"]["attn"]["qkv_kernel"].dtype == torch.bfloat16
    back = tconvert.to_jax_params(port, bf16_dtype=ml_dtypes.bfloat16)
    _assert_same_tree(params["visual"], back)


def test_round_trip_vit_b16_shapes():
    """Every leaf shape of a ViT-B/16 pytree, with distinct values per leaf."""
    shapes = jax.eval_shape(lambda k: jclip.init_clip_params(k, jclip.PRESETS["ViT-B/16"]),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape, np.float32), shapes)
    port = tconvert.from_jax_params(tree)
    assert tuple(port["visual"]["blocks"]["mlp"]["fc_kernel"].shape) == (12, 768, 3072)
    _assert_same_tree(tree, tconvert.to_jax_params(port))


def test_openai_state_dict_both_routes(tmp_path):
    params = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(5), jclip.PRESETS["ViT-TEST"]))
    sd = openai_vit_state_dict(params, patch=16)
    jcfg, jparams = jconvert.convert_state_dict(sd)
    tcfg, tparams = tconvert.convert_state_dict(sd)
    assert tcfg == tclip.CLIPConfig(**jcfg.__dict__) == tclip.config_from_state_dict(sd)
    _assert_same_tree(tconvert.to_jax_params(to_port(jparams)), tconvert.to_jax_params(tparams))
    # and through a checkpoint file, as --weights reads it
    path = tmp_path / "vit_test.pt"
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    _, fparams = tconvert.load_clip_weights(str(path))
    _assert_same_tree(tconvert.to_jax_params(fparams), tconvert.to_jax_params(tparams))
    # the round trip back to the JAX layout reproduces the JAX params
    _assert_same_tree(jax.device_get(jparams), tconvert.to_jax_params(tparams))


def test_rn_towers_wait_for_their_slice():
    """Their slice has come: a ResNet tower initialises, with JAX's tree, and
    crosses the bridge both ways (tests/test_torch_resnet.py holds it value
    for value against JAX's)."""
    port = tclip.init_clip_params(torch.Generator().manual_seed(0), tclip.PRESETS["RN-TEST"],
                                  device="cpu")
    shapes = jax.eval_shape(lambda k: jclip.init_clip_params(k, jclip.PRESETS["RN-TEST"]),
                            jax.random.PRNGKey(0))
    back = tconvert.to_jax_params(port)
    assert jax.tree.structure(back) == jax.tree.structure(shapes)
    assert jax.tree.leaves(jax.tree.map(lambda a, s: a.shape == s.shape, back, shapes)) \
        == [True] * len(jax.tree.leaves(shapes))
    _assert_same_tree(back, tconvert.to_jax_params(tconvert.from_jax_params(back)))


def test_load_prompt_checkpoint_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    sd = {"prompt_learner.ctx": torch.from_numpy(rng.standard_normal((4, 64), np.float32)),
          "prompt_learner.ctx_double": torch.from_numpy(rng.standard_normal((4, 64), np.float32)),
          "prompt_learner.ctx_evidence": torch.from_numpy(rng.standard_normal((4, 64), np.float32)),
          "prompt_learner.temperature": torch.tensor(3.0),
          "prompt_learner.spatial_T": torch.tensor(2.5),
          "prompt_learner.ranking_scale": torch.tensor(4.0),
          "prompt_learner.token_prefix": torch.zeros(2, 1, 64)}
    path = tmp_path / "model.pth.tar-3"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    jtr, jep = jconvert.load_prompt_checkpoint(str(path))
    ttr, tep = tconvert.load_prompt_checkpoint(str(path))
    assert jep == tep == 3 and set(jtr) == set(ttr)
    for k in jtr:
        np.testing.assert_array_equal(np.asarray(jtr[k]), ttr[k].numpy())
