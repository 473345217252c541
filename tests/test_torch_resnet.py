"""The port's ModifiedResNet (models/resnet.py) and attention_core against
leclip_tpu's, same weights and inputs (made with numpy, moved across with
the bridge), every batch norm's statistics and affine drawn at random.

Tolerance: fp32, 2e-5 on single layers and 1e-4 through a whole tower (fp32
sums in another order over up to 50 layers); the positional-embedding
resize 1e-6 (the same weights up to the cubic's evaluation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import openai_rn_state_dict, rn_clip_params, rn_visual_numpy, to_port
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import convert as jconvert
from leclip_tpu.models import dense_clip as jdc
from leclip_tpu.models import resnet as jres
from leclip_tpu.ops import attention as jattn
from leclip_tpu_torch.models import clip as tclip
from leclip_tpu_torch.models import convert as tconvert
from leclip_tpu_torch.models import dense_clip as tdc
from leclip_tpu_torch.models import resnet as tres
from leclip_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

CFG = jclip.PRESETS["RN-TEST"]


@pytest.fixture(scope="module")
def params():
    return rn_clip_params(CFG)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, ref, tol=2e-5):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol)


def _conv(shape_hwio, seed):
    fan_in = np.prod(shape_hwio[:3])
    return (_x(shape_hwio, seed) * (2.0 / fan_in) ** 0.5).astype(np.float32)


@pytest.mark.parametrize("hw,k,stride", [
    ((16, 16), 3, 2),   # the stem's stride-2 3x3 on an even input: JAX pads (0, 1)
    ((15, 17), 3, 2),   # odd input: (1, 1)
    ((16, 12), 3, 1),   # 3x3 stride 1: (1, 1)
    ((9, 9), 1, 1),     # 1x1
])
def test_conv2d_pads_as_jax(hw, k, stride):
    x, w = _x((2,) + hw + (3,)), _conv((k, k, 3, 5), 1)
    ref = jres.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride)
    out = tres.conv2d(torch.tensor(x), tres.from_hwio(torch.tensor(w)), stride=stride)
    assert tuple(out.shape) == ref.shape
    _close(out, ref)
    if hw == (16, 16):
        # OpenAI's ModifiedResNet pads the stem (1, 1): another function
        sym = torch.nn.functional.conv2d(torch.tensor(x).permute(0, 3, 1, 2),
                                         tres.from_hwio(torch.tensor(w)), stride=2, padding=1)
        assert np.abs(sym.permute(0, 2, 3, 1).numpy() - np.asarray(ref)).max() > 0.1


@pytest.mark.parametrize("case", ["identity", "downsample", "strided downsample"])
def test_bottleneck_matches_jax(params, case):
    """Without a downsample (a later block of an RN50 stage: the input's
    shape kept), with a stride-1 downsample (RN-TEST's layer1, the width
    changes) and with the anti-aliased stride-2 one (layer2)."""
    if case == "identity":
        blk = jax.tree.map(lambda a: a[0],
                           rn_visual_numpy(jclip.PRESETS["RN50"])["layer1"]["rest"])
        stride = 1
    else:
        stride = 2 if case == "strided downsample" else 1
        blk = params["visual"]["layer2" if stride == 2 else "layer1"]["block0"]
    assert ("downsample" in blk) == (case != "identity")
    x = _x((2, 8, 8, np.shape(blk["conv1"])[2]), 2)
    ref = jres.bottleneck(jnp.asarray(x), blk, stride)
    out = tres.bottleneck(torch.tensor(x), to_port(blk), stride)
    assert tuple(out.shape) == ref.shape
    _close(out, ref)


def test_resnet_features_matches_jax(params):
    x = _x((2, 64, 64, 3), 4)
    ref = jres.resnet_features(jnp.asarray(x), params["visual"])
    out = tres.resnet_features(torch.tensor(x), to_port(params["visual"]))
    assert tuple(out.shape) == ref.shape == (2, 2, 2, CFG.vision_width * 32)
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("global_only", [True, False])
@pytest.mark.parametrize("if_pos", [True, False])
def test_attention_pool_matches_jax(params, global_only, if_pos):
    ap = params["visual"]["attnpool"]
    feat = _x((3, 2, 2, CFG.vision_width * 32), 5)
    g_ref, m_ref = jres.attention_pool(jnp.asarray(feat), ap, CFG.vision_heads, if_pos=if_pos,
                                       global_only=global_only)
    g, m = tres.attention_pool(torch.tensor(feat), to_port(ap), CFG.vision_heads, if_pos=if_pos,
                               global_only=global_only)
    _close(g, g_ref)
    if global_only:
        assert m is None and m_ref is None
    else:
        _close(m, m_ref)


@pytest.mark.parametrize("side", [14, 5, 2])
def test_interpolate_pos_embedding_matches_jax(side):
    """7 → 14 upsamples; 7 → 5 and 7 → 2 shrink, where jax.image.resize
    antialiases (its support widened by the shrink factor)."""
    pos = _x((50, 16), 6)
    ref = jres.interpolate_pos_embedding(jnp.asarray(pos), side, side)
    out = tres.interpolate_pos_embedding(torch.tensor(pos), side, side)
    assert tuple(out.shape) == ref.shape == (side * side + 1, 16)
    _close(out, ref, 1e-6)
    # identity on the trained grid
    assert tres.interpolate_pos_embedding(torch.tensor(pos), 7, 7) is not None
    torch.testing.assert_close(tres.interpolate_pos_embedding(torch.tensor(pos), 7, 7),
                               torch.tensor(pos), rtol=0, atol=0)


def test_project_dense_matches_jax(params):
    ap = params["visual"]["attnpool"]
    fmap = _x((2, 3, 4, CFG.vision_width * 32), 7)
    ref = jres.project_dense(jnp.asarray(fmap), ap)
    out = tres.project_dense(torch.tensor(fmap), to_port(ap))
    assert tuple(out.shape) == ref.shape == (2, 12, CFG.embed_dim)
    _close(out, ref)


@pytest.mark.parametrize("mask", [False, True])
def test_attention_core_matches_jax(mask):
    q, k, v = (_x((2, 3, 10, 8), s) for s in (8, 9, 10))
    m = np.triu(np.full((10, 10), -np.inf, np.float32), 1) if mask else None
    ref = jattn.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               mask=None if m is None else jnp.asarray(m))
    out = tattn.attention_core(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                               mask=None if m is None else torch.tensor(m))
    _close(out, ref)
    # "pallas" runs the flash kernel's plain version on the CPU: the same function
    fl = tattn.attention_core(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              mask=None if m is None else torch.tensor(m), impl="pallas")
    _close(fl, ref)


def test_encode_image_features_matches_jax(params):
    x = _x((2, 64, 64, 3), 11)
    jflags, tflags = jdc.DenseFlags(), tdc.DenseFlags()
    ref = jdc.encode_image_features(params, CFG, jnp.asarray(x), jflags)
    out = tdc.encode_image_features(to_port(params), CFG, torch.tensor(x), tflags)
    assert tuple(out.spatial_feats.shape) == ref.spatial_feats.shape == (2, 4, CFG.embed_dim)
    _close(out.global_feat, ref.global_feat, 1e-4)
    _close(out.spatial_feats, ref.spatial_feats, 1e-4)


def test_rn50_widths_and_depths_match_jax():
    """RN50's whole tower, (3, 4, 6, 3) bottlenecks at width 64, embed 1024
    and 32 pool heads, on a 64x64 input: a 2x2 map, so ``if_pos`` resizes
    the 7x7 positional embedding to 2x2 (antialiased)."""
    cfg = jclip.PRESETS["RN50"]
    vis = rn_visual_numpy(cfg)
    x = _x((2, 64, 64, 3), 12)
    g_ref, m_ref, f_ref = jres.encode_image_resnet(jnp.asarray(x), vis, cfg.vision_heads,
                                                   dense=True, if_pos=True)
    g, m, f = tres.encode_image_resnet(torch.tensor(x), to_port(vis), cfg.vision_heads,
                                       dense=True, if_pos=True)
    assert tuple(g.shape) == (2, 1024) and tuple(f.shape) == (2, 2, 2, 2048)
    for out, ref in ((g, g_ref), (m, m_ref), (f, f_ref)):
        _close(out, ref, 1e-4)


def _assert_same_tree(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.shape(x) == np.shape(y), path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def test_rn_tree_round_trip(params):
    """JAX → port → JAX, value for value: stacked bottlenecks, BN
    {scale, bias, mean, var}, and HWIO conv kernels, which the port keeps in
    F.conv2d's [out, in, kh, kw] order with channels-last strides."""
    port = tconvert.from_jax_params(params)
    c = port["visual"]["layer1"]["block0"]["conv2"]
    assert tuple(c.shape) == tuple(np.shape(params["visual"]["layer1"]["block0"]["conv2"])[
        i] for i in (3, 2, 0, 1))
    assert c.is_contiguous(memory_format=torch.channels_last)
    rest = tconvert.from_jax_params(rn_visual_numpy(jclip.PRESETS["RN50"]))["layer3"]["rest"]
    assert tuple(rest["conv2"].shape) == (5, 256, 256, 3, 3)
    assert rest["conv2"][2].is_contiguous(memory_format=torch.channels_last)
    _assert_same_tree(params, tconvert.to_jax_params(port))


def test_openai_rn_state_dict_both_routes(params, tmp_path):
    sd = openai_rn_state_dict(params)
    jcfg, jparams = jconvert.convert_state_dict(sd)
    tcfg, tparams = tconvert.convert_state_dict(sd)
    assert tcfg == tclip.CLIPConfig(**jcfg.__dict__) == tclip.config_from_state_dict(sd)
    assert tcfg.vision_layers == CFG.vision_layers and not tcfg.is_vit
    _assert_same_tree(jax.device_get(jparams), tconvert.to_jax_params(tparams))
    _assert_same_tree(params["visual"], tconvert.to_jax_params(tparams)["visual"])
    path = tmp_path / "rn_test.pt"
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    _, fparams = tconvert.load_clip_weights(str(path))
    _assert_same_tree(tconvert.to_jax_params(fparams), tconvert.to_jax_params(tparams))


def test_seeded_rn_init_follows_the_jax_tree():
    """init_clip_params draws a ResNet tower with JAX's tree, shapes and
    dtypes (BN statistics in fp32), and the port's conv layout."""
    cfg = jclip.PRESETS["RN-TEST"]
    shapes = jax.eval_shape(lambda k: jclip.init_clip_params(k, cfg, dtype=jnp.bfloat16),
                            jax.random.PRNGKey(0))
    port = tclip.init_clip_params(torch.Generator().manual_seed(0), cfg,
                                  dtype=torch.bfloat16, device="cpu")
    back = tconvert.to_jax_params(port)
    ls, lb = (jax.tree_util.tree_leaves_with_path(t) for t in (shapes, back))
    assert [p for p, _ in ls] == [p for p, _ in lb]
    for (path, s), (_, b) in zip(ls, lb):
        assert s.shape == b.shape, path
    v = port["visual"]
    assert v["bn1"]["mean"].dtype == torch.float32 and v["bn1"]["scale"].dtype == torch.bfloat16
    assert (v["layer1"]["block0"]["bn3"]["scale"] == 0).all()
    assert v["conv1"].is_contiguous(memory_format=torch.channels_last)
