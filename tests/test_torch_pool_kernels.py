"""The Python around the trunk's average-pool kernel (ops/pool_kernels.py),
on the CPU: the plain route against the JAX package's ``avg_pool``, the
autograd path's gradient against the library pool's, the call site in
models/resnet.py, and the wrapper launching nothing for CPU tensors.

Tolerances against JAX. fp32: XLA:CPU picks the order of a window's four
additions by shape (at [2, 16, 16, 64] it adds the two rows' pairs, at the
others here row by row as the library does), so the two agree within 2
fp32 ulps of the window's mean magnitude; the port's values equal the
library's order, summed here in numpy, exactly. bf16: JAX's reduce_window
adds in bf16, rounding each partial sum, where the port sums in fp32 and
rounds once, so within 2 bf16 ulps of the window's mean magnitude
(measured: 2).

The kernel itself runs only on the card: tests/test_torch_cuda_kernels.py
holds it to F.avg_pool2d there, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leclip_tpu.models import resnet as jres
from leclip_tpu_torch.models import resnet as tres
from leclip_tpu_torch.ops import launches
from leclip_tpu_torch.ops import pool_kernels as pk

torch.set_num_threads(2)

SHAPES = [(2, 16, 16, 64), (3, 15, 17, 80), (2, 7, 9, 32), (2, 28, 28, 128)]
DTYPES = {"fp32": (torch.float32, jnp.float32, 24), "bf16": (torch.bfloat16, jnp.bfloat16, 8)}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _windows(x, k):
    """[B, H // k, W // k, k, k, C] view of x's whole windows."""
    b, h, w, c = x.shape
    ho, wo = h // k, w // k
    return x[:, :ho * k, :wo * k].reshape(b, ho, k, wo, k, c).transpose(0, 1, 3, 2, 4, 5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_route_matches_jax(shape, dtype):
    tdt, jdt, bits = DTYPES[dtype]
    xt = torch.tensor(_x(shape)).to(tdt)
    xf = xt.float().numpy()
    ref = np.asarray(jres.avg_pool(jnp.asarray(xf).astype(jdt), 2).astype(jnp.float32))
    out = pk.avg_pool_nhwc(xt, 2)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    out = out.float().numpy()
    mean_mag = np.abs(_windows(xf, 2)).sum((3, 4)) / 4
    ulp = np.ldexp(np.float32(1.0), np.frexp(mean_mag)[1] - bits)
    assert (np.abs(out - ref) <= 2 * ulp).all(), (np.abs(out - ref) / ulp).max()
    if dtype == "fp32":
        win = _windows(xf, 2)
        rows = ((np.float32(0) + win[..., 0, 0, :] + win[..., 0, 1, :]) + win[..., 1, 0, :]
                + win[..., 1, 1, :])
        np.testing.assert_array_equal(out, rows / np.float32(4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,k", [((2, 16, 16, 64), 2), ((3, 15, 17, 80), 2),
                                     ((2, 10, 11, 16), 3), ((1, 9, 9, 8), 3)])
def test_autograd_gradient_matches_the_library(shape, k, dtype):
    """The autograd Function's backward (its plain gradient) against the
    library pool's gradient, bit for bit, floor mode's dropped rows and
    columns included; its forward is the plain route on the CPU."""
    x = torch.tensor(_x(shape, 1)).to(dtype)
    g = torch.tensor(_x((shape[0], shape[1] // k, shape[2] // k, shape[3]), 2)).to(dtype)
    xa = x.clone().requires_grad_(True)
    out = pk._AvgPool.apply(xa, k)
    out.backward(g)
    xb = x.clone().requires_grad_(True)
    ref = F.avg_pool2d(xb.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)
    ref.backward(g)
    assert torch.equal(out, ref)
    assert xa.grad.dtype == dtype and torch.equal(xa.grad, xb.grad)
    if shape[1] % k:
        assert (xa.grad[:, -(shape[1] % k):] == 0).all()


def test_wrapper_takes_the_plain_route_on_the_cpu_and_launches_nothing():
    launches.reset_launch_counts()
    x = torch.tensor(_x((2, 9, 12, 24))).to(torch.bfloat16)
    for k in (2, 3):
        assert torch.equal(pk.avg_pool_nhwc(x, k), pk.avg_pool_nhwc_plain(x, k))
    xg = x.float().requires_grad_(True)
    pk.avg_pool_nhwc(xg, 2).sum().backward()
    assert xg.grad is not None
    assert launches.launch_counts()["avg_pool"] == 0


@pytest.mark.parametrize("window", [1, 0])
def test_window_of_one_or_less_is_the_identity(window):
    x = torch.tensor(_x((2, 5, 5, 8)))
    assert tres.avg_pool(x, window) is x


def test_the_trunk_pools_through_the_wrapper(monkeypatch):
    """resnet_features reaches avg_pool_nhwc seven times a forward: the stem,
    then layers 2-4's stride-2 bottlenecks before conv3 and the downsample."""
    from _torch_port import rn_clip_params, to_port

    from leclip_tpu.models import clip as jclip

    calls = []

    def counted(x, k):
        calls.append((tuple(x.shape), k))
        return pk.avg_pool_nhwc(x, k)

    monkeypatch.setattr(tres, "avg_pool_nhwc", counted)
    vis = to_port(rn_clip_params(jclip.PRESETS["RN-TEST"])["visual"])
    x = torch.tensor(_x((2, 64, 64, 3), 3))
    with torch.no_grad():
        tres.resnet_features(x, vis)
    assert len(calls) == 7 and all(k == 2 for _, k in calls)
    assert calls[0][0][1:3] == (32, 32)  # the stem's map at half the input
