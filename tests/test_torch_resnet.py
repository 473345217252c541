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


def test_bf16_trunk_matches_jax_and_ignores_the_batch_order(params):
    """The bf16 trunk (RN-TEST at 64², every convolution on conv_bf16's
    plain version on the CPU) against JAX's bf16 trunk on the same bf16
    weights: within 8 bf16 epsilons (2^-8) of max(1, max|ref|), since each
    of the ~20 layers rounds its output to bf16 as JAX's does, after sums in
    another order. An image's trunk map is the same, bit for bit, with the
    batch reversed."""
    from leclip_tpu_torch.device import cast_floating

    x = _x((4, 64, 64, 3), 4)
    jv = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params["visual"])
    ref = np.asarray(jres.resnet_features(jnp.asarray(x, jnp.bfloat16), jv).astype(jnp.float32))
    tv = cast_floating(to_port(params["visual"]), torch.bfloat16)
    xt = torch.tensor(x).to(torch.bfloat16)
    out = tres.resnet_features(xt, tv)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 8 * 2.0 ** -8 * max(1.0, np.abs(ref).max()), err
    rev = tres.resnet_features(xt.flip(0), tv).flip(0)
    assert torch.equal(rev, out)


# (label, image indices) of the batches each image is held to its map in the
# batch of 8: the first image alone, the first five, and the first five
# padded to eight by repeating the fifth, as the scoring service pads
BATCHES = {"1 alone": [0], "5 alone": [0, 1, 2, 3, 4], "5 padded to 8": [0, 1, 2, 3, 4, 4, 4, 4]}
# the two trunks' distance, of max(1, max|ref|): bf16, 8 bf16 epsilons (the
# bound above); fp32, fp32 sums in another order through ~20 layers
TRUNK_TOL = {"bf16": 8 * 2.0 ** -8, "fp32": 1e-5}
# In fp32 neither CPU route is independent of the batch: XLA's CPU
# convolution (JAX) and oneDNN's (the port's conv_fp32_plain, the library's
# convolution) are chosen by shape, and an image alone reads up to 4.8e-7
# (JAX) and 7.2e-7 (port) off its map in the batch of 8, about an fp32 ulp
# of the map's largest values; held to 4 fp32 epsilons of max(1, max|ref|).
# On the card conv_fp32 reads 0 (tests/test_torch_cuda_kernels.py)
CPU_FP32_MOVE = 4 * 2.0 ** -23


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_bf16_trunk_ignores_the_batch_size_as_jax(params, dtype):
    """Each image's trunk map at batch sizes 1, 5 and 8 (5 padded to 8) is
    the same, bit for bit, as in a batch of 8, in the port (on the CPU the
    plain version of conv_bf16) as in JAX in bf16; in fp32 the two CPU
    routes move by about an fp32 ulp (CPU_FP32_MOVE); the two trunks within
    TRUNK_TOL of max(1, max|ref|) of each other."""
    from leclip_tpu_torch.device import cast_floating

    x = _x((8, 64, 64, 3), 9)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                         torch.float32)
    jv = jax.tree.map(lambda a: jnp.asarray(a, jdt), params["visual"])
    tv = cast_floating(to_port(params["visual"]), tdt)

    def jax_trunk(idx):
        return np.asarray(jres.resnet_features(jnp.asarray(x[idx], jdt), jv)
                          .astype(jnp.float32))

    def port_trunk(idx):
        return tres.resnet_features(torch.tensor(x[idx]).to(tdt), tv).float().numpy()

    full = list(range(8))
    ref, out = jax_trunk(full), port_trunk(full)
    scale = max(1.0, np.abs(ref).max())
    err = np.abs(out - ref).max()
    assert err <= TRUNK_TOL[dtype] * scale, err
    for label, idx in BATCHES.items():
        for side, trunk, full_map in (("JAX", jax_trunk, ref), ("port", port_trunk, out)):
            if dtype == "bf16":
                np.testing.assert_array_equal(trunk(idx), full_map[idx],
                                              err_msg=f"{side}, {label}")
            else:
                moved = np.abs(trunk(idx) - full_map[idx]).max()
                assert moved <= CPU_FP32_MOVE * scale, (side, label, moved)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_bf16_bottleneck_through_conv_bn_matches_the_unfused_chain_and_jax(params, dtype):
    """A bottleneck with a strided downsample (RN-TEST's layer2), in bf16
    and in fp32, runs each convolution with its batch norm through
    resnet.conv_bn: on the CPU bit for bit the unfused chain (conv2d,
    batch_norm, relu, + identity, relu), which the card's fused epilogues
    (conv_bf16, conv_fp32) also equal; against JAX's bottleneck in the same
    dtype within the bf16 trunk's bound (8 bf16 epsilons of max(1,
    max|ref|)), in fp32 within the file's fp32 tolerance."""
    from leclip_tpu_torch.device import cast_floating

    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    blk = params["visual"]["layer2"]["block0"]
    jb = jax.tree.map(lambda a: jnp.asarray(a, jdt), blk)
    tb = cast_floating(to_port(blk), tdt)
    x = _x((2, 8, 8, np.shape(blk["conv1"])[2]), 21)
    xt = torch.tensor(x).to(tdt)
    out = tres.bottleneck(xt, tb, 2)
    bn = tres.batch_norm
    ref = torch.relu(bn(tres.conv2d(xt, tb["conv1"]), tb["bn1"]))
    ref = torch.relu(bn(tres.conv2d(ref, tb["conv2"]), tb["bn2"]))
    ref = bn(tres.conv2d(tres.avg_pool(ref, 2), tb["conv3"]), tb["bn3"])
    ident = bn(tres.conv2d(tres.avg_pool(xt, 2), tb["downsample"]["conv"]),
               tb["downsample"]["bn"])
    ref = torch.relu(ref + ident)
    assert out.dtype == tdt and torch.equal(out, ref)
    jref = np.asarray(jres.bottleneck(jnp.asarray(x, jdt), jb, 2).astype(jnp.float32))
    if dtype == "fp32":
        _close(out, jref)
        return
    err = np.abs(out.float().numpy() - jref).max()
    assert err <= 8 * 2.0 ** -8 * max(1.0, np.abs(jref).max()), err


def test_conv_fp32_chain_arguments_are_checked_on_cpu():
    """conv_fp32's epilogue arguments are checked on every device, the CPU
    included, as conv_bf16's are: scale needs offset, residual and relu need
    the batch norm, scale / offset are [Cout], residual is fp32 in the
    output's shape; an offset alone is a bias add (conv_bf16 refuses it)."""
    from leclip_tpu_torch.ops import conv_kernels as ck

    x = torch.tensor(_x((2, 8, 8, 16), 30))
    w = torch.tensor(_x((32, 16, 3, 3), 31)) / 12
    s, o = torch.ones(32), torch.tensor(_x((32,), 32))
    r = torch.tensor(_x((2, 4, 4, 32), 33))
    bad = {
        "scale comes with offset": dict(scale=s),
        "residual and relu come after": dict(residual=r, stride=2),
        "residual and relu come after ": dict(relu=True),
        "scale must be": dict(scale=s[:16], offset=o),
        "offset must be": dict(scale=s, offset=o[:16]),
        "residual must be": dict(scale=s, offset=o, residual=r),  # the output is 8x8
        "residual must be ": dict(scale=s, offset=o, residual=r.double(), stride=2),
    }
    for match, kw in bad.items():
        stride = kw.pop("stride", 1)
        with pytest.raises(ValueError, match=match.strip()):
            ck.conv_fp32(x, w, stride, **kw)
    got = ck.conv_fp32(x, w, 2, s, o, r, True)
    assert torch.equal(got, ck.bn_chain(ck.conv_fp32_plain(x, w, 2), s, o, r, True))
    assert torch.equal(ck.conv_fp32(x, w, 1, offset=o), ck.conv_fp32_plain(x, w, 1) + o)
    with pytest.raises(ValueError, match="offset comes with scale"):
        ck.conv_bf16(x.to(torch.bfloat16), w, 1, offset=o)


def test_conv_fp32_on_cpu_runs_its_plain_version():
    """conv_fp32 on a CPU tensor is its plain version (the library's fp32
    convolution, TF32 off, the stem's (0, 1) pads) and counts no launch,
    also under autograd."""
    from leclip_tpu_torch.ops import conv_kernels as ck

    x = torch.tensor(_x((2, 16, 16, 3), 22))
    w = tres.from_hwio(torch.tensor(_conv((3, 3, 3, 8), 23)))
    before = ck.conv_fp32.launches
    got = ck.conv_fp32(x, w, 2)
    assert torch.equal(got, ck.conv_fp32_plain(x, w, 2))
    assert torch.equal(got, tres.conv2d(x, w, 2))
    xg = x.clone().requires_grad_()
    ck.conv_fp32(xg, w, 2).sum().backward()
    assert xg.grad is not None and ck.conv_fp32.launches == before


def test_conv_fp32_refuses_what_it_does_not_take():
    """conv_fp32 takes fp32 alone (a bf16 input raises), with every tensor
    on x's device."""
    from leclip_tpu_torch.ops.conv_kernels import conv_fp32

    x = torch.zeros(1, 8, 8, 16)
    w = torch.zeros(32, 16, 3, 3)
    with pytest.raises(TypeError, match="float32"):
        conv_fp32(x.to(torch.bfloat16), w)
    with pytest.raises(ValueError, match="meta"):
        conv_fp32(x, w.to("meta"))


def test_matmul_fp32_on_cpu_is_the_plain_product():
    """The head's fp32 products (models/resnet._proj through
    conv_kernels.matmul_fp32) on CPU tensors are ``y @ w`` bit for bit and
    count no launch; matmul_fp32 takes fp32 alone, with both tensors on one
    device."""
    from leclip_tpu_torch.ops import conv_kernels as ck

    y = torch.tensor(_x((2, 5, 64), 24))
    p = {"kernel": torch.tensor(_x((64, 32), 25)), "bias": torch.tensor(_x((32,), 26))}
    before = ck.conv_fp32.launches
    assert torch.equal(ck.matmul_fp32(y, p["kernel"]), y @ p["kernel"])
    assert torch.equal(tres._proj(y, p), y @ p["kernel"] + p["bias"])
    assert ck.conv_fp32.launches == before
    with pytest.raises(TypeError, match="float32"):
        ck.matmul_fp32(y.to(torch.bfloat16), p["kernel"])
    with pytest.raises(ValueError, match="meta"):
        ck.matmul_fp32(y, p["kernel"].to("meta"))


@pytest.mark.parametrize("grid,k,stride,cin,pads", [
    ((7, 7), 3, 1, 8, (1, 1)),     # the last stage's grid, 3x3
    ((8, 8), 3, 1, 8, (1, 1)),     # a larger grid, 3x3
    ((9, 9), 1, 1, 8, (0, 0)),     # 1x1
    ((16, 16), 3, 2, 3, (0, 1)),   # the stem: stride 2, 3 channels, JAX's (0, 1) pad
])
def test_bf16_small_grid_convs_run_in_fp32(grid, k, stride, cin, pads):
    """Every bf16 convolution on the CPU (conv_bf16's plain version) is the
    fp32 sum of the exactly widened bf16 values, rounded once to bf16, at
    every grid and shape; fp32 convolutions are conv2d_native's."""
    from leclip_tpu_torch.ops import conv_kernels

    x = torch.tensor(_x((3,) + grid + (cin,), 5)).to(torch.bfloat16)
    w = tres.from_hwio(torch.tensor(_conv((k, k, cin, 6), 6))).to(torch.bfloat16)
    lo, hi = pads
    xp = torch.nn.functional.pad(x.float().permute(0, 3, 1, 2), (lo, hi, lo, hi))
    want = torch.nn.functional.conv2d(xp, w.float(), stride=stride).permute(0, 2, 3, 1)
    before = conv_kernels.conv_bf16.launches
    got = tres.conv2d(x, w, stride)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    assert conv_kernels.conv_bf16.launches == before  # the CPU launches no kernel
    f32 = torch.tensor(_x((2,) + grid + (cin,), 8))
    assert torch.equal(tres.conv2d(f32, w.float(), stride),
                       tres.conv2d_native(f32, w.float(), stride))


# gradient tolerance, of max(1, max|ref|): bf16, 2 bf16 epsilons (each side a
# bf16 gradient convolution of the same bf16 values, its fp32 sum in another
# order, rounded once); fp32, fp32 sums in another order over K <= 144
GRAD_TOL = {"bf16": 2 * 2.0 ** -8, "fp32": 1e-5}


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("k,stride,hw", [(3, 1, (8, 8)), (3, 2, (16, 16)), (1, 1, (7, 7))])
def test_bf16_conv_gradient_matches_jax(k, stride, hw, dtype):
    """conv_bf16 and conv_fp32 under autograd (their torch.autograd.Function:
    the library's convolution gradient, TF32 off) against jax.grad of
    leclip_tpu's conv2d on the same values, for the input and the kernel:
    within GRAD_TOL of max(1, max|ref|)."""
    from leclip_tpu_torch.ops.conv_kernels import conv_bf16, conv_fp32

    jdt, tdt, conv = ((jnp.bfloat16, torch.bfloat16, conv_bf16) if dtype == "bf16"
                      else (jnp.float32, torch.float32, conv_fp32))
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2,) + hw + (16,)), jdt)
    w = jnp.asarray(_conv((k, k, 16, 8), 12), jdt)
    y_shape = jres.conv2d(x, w, stride=stride).shape
    g = jnp.asarray(rng.standard_normal(y_shape), jnp.bfloat16).astype(jnp.float32)

    def loss(x_, w_):
        return jnp.sum(jres.conv2d(x_, w_, stride=stride).astype(jnp.float32) * g)

    dx, dw = jax.grad(loss, argnums=(0, 1))(x, w)
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(tdt).requires_grad_()
    wt = tres.from_hwio(torch.tensor(np.asarray(w.astype(jnp.float32)))).to(
        tdt).requires_grad_()
    out = conv(xt, wt, stride)
    assert out.grad_fn is not None and out.dtype == tdt
    (out.float() * torch.tensor(np.asarray(g))).sum().backward()
    for got, ref in ((xt.grad, dx), (tres.to_hwio(wt.grad), dw)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert got.dtype == tdt and tuple(got.shape) == ref.shape
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= GRAD_TOL[dtype] * max(1.0, np.abs(ref).max()), err


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
