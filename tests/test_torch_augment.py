"""The train-time augmentations (ops/preprocess.py train half,
ops/randaugment.py, ops/autoaugment.py) against leclip_tpu's.

torch and JAX generators cannot give the same numbers, so each port
function is split into a sampler and an apply: every apply is fed the draws
that the JAX function makes from its key (re-derived here from the same key
splits) and held to the JAX output within 1e-5 (fp32 products and
transcendental functions in another order); the samplers are held to their
distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leclip_tpu.ops import autoaugment as jaa
from leclip_tpu.ops import preprocess as jpre
from leclip_tpu.ops import randaugment as jra
from leclip_tpu_torch.ops import autoaugment as taa
from leclip_tpu_torch.ops import preprocess as tpre
from leclip_tpu_torch.ops import randaugment as tra

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _rrc_draws(key):
    """random_resized_crop_box's draws from its key."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return tpre.RRCDraws(
        _t(jax.random.uniform(k1, (10,), minval=0.6, maxval=1.0)),
        _t(jax.random.uniform(k2, (10,), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3))),
        _t(jax.random.uniform(k3, ())), _t(jax.random.uniform(k4, ())))


def _cutout_draws(key, h, w, proportion=0.4):
    k1, k2 = jax.random.split(key)
    ch, cw = int(h * proportion), int(w * proportion)
    return (_t(jax.random.randint(k1, (), 0, max(h - ch, 1))).long(),
            _t(jax.random.randint(k2, (), 0, max(w - cw, 1))).long())


def _train_draws(key, size):
    k_choice, k_rrc, k_cut, k_flip = jax.random.split(key, 4)
    cut_y, cut_x = _cutout_draws(k_cut, size, size)
    return tpre.TrainDraws(_t(jax.random.bernoulli(k_choice, 0.5)), _rrc_draws(k_rrc),
                           cut_y, cut_x, _t(jax.random.bernoulli(k_flip, 0.5)))


def _stack(draws):
    return type(draws[0])(*(torch.stack(x) if isinstance(x[0], torch.Tensor) else _stack(x)
                            for x in zip(*draws)))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max() if want.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("hw", [(40, 52), (30, 90), (64, 64)])
def test_rrc_box_matches_jax(hw):
    """Including a shape where no trial fits (30 x 90: the square fallback)."""
    for s in range(8):
        key = jax.random.PRNGKey(s)
        want = jpre.random_resized_crop_box(key, *hw)
        got = tpre.random_resized_crop_box(*hw, _rrc_draws(key))[None]
        _close(got, want)


def test_crop_flip_cutout_apply_match_jax():
    img = np.random.default_rng(0).random((37, 45, 3)).astype(np.float32)
    for s in range(4):
        key = jax.random.PRNGKey(10 + s)
        want = jpre.random_resized_crop(key, jnp.asarray(img), 24)
        _close(tpre.random_resized_crop(torch.tensor(img), _rrc_draws(key), 24), want)
        want = jpre.random_flip(key, jnp.asarray(img))
        _close(tpre.random_flip(torch.tensor(img), _t(jax.random.bernoulli(key, 0.5))), want)
        want = jpre.cutout(key, jnp.asarray(img), 0.4)
        _close(tpre.cutout(torch.tensor(img), *_cutout_draws(key, 37, 45)), want)


def test_preprocess_train_matches_jax():
    img = np.random.default_rng(1).integers(0, 255, (41, 33, 3)).astype(np.uint8)
    seen = set()
    for s in range(8):
        key = jax.random.PRNGKey(20 + s)
        want = jpre.preprocess_train(key, jnp.asarray(img), size=24)
        draws = _train_draws(key, 24)
        seen.add(bool(draws.use_rrc))
        _close(tpre.preprocess_train(torch.tensor(img), draws, size=24), want)
    assert seen == {True, False}


def test_preprocess_train_batch_matches_jax():
    """Bucket-padded images of several content sizes, both branches of the
    RandomChoice among them."""
    rng = np.random.default_rng(2)
    b, size = 8, 32
    imgs = np.zeros((b, 48, 56, 3), np.uint8)
    content = np.zeros((b, 2), np.int32)
    for i in range(b):
        h, w = int(rng.integers(20, 49)), int(rng.integers(20, 57))
        imgs[i, :h, :w] = rng.integers(0, 255, (h, w, 3))
        content[i] = (h, w)
    key = jax.random.PRNGKey(3)
    want = jpre.preprocess_train_batch(key, jnp.asarray(imgs), jnp.asarray(content), size=size)
    draws = _stack([_train_draws(k, size) for k in jax.random.split(key, b)])
    assert 0 < int(draws.use_rrc.sum()) < b
    got = tpre.preprocess_train_batch(torch.tensor(imgs), torch.tensor(content), draws, size=size)
    _close(got, want)


def test_samplers_follow_their_distributions():
    gen = torch.Generator().manual_seed(0)
    n = 2000
    h = torch.randint(40, 500, (n,), generator=gen).float()
    w = torch.randint(40, 500, (n,), generator=gen).float()
    draws = tpre.sample_rrc(gen, (n,))
    box = tpre.random_resized_crop_box(h, w, draws)
    bh, bw = box[:, 2] - box[:, 0], box[:, 3] - box[:, 1]
    eps = 1e-3
    assert (box[:, 0] >= -eps).all() and (box[:, 1] >= -eps).all()
    assert (box[:, 2] <= h + eps).all() and (box[:, 3] <= w + eps).all()
    fallback = ((bh - torch.minimum(h, w)).abs() < eps) & ((bw - bh).abs() < eps)
    area = bh * bw / (h * w)
    aspect = bw / bh
    ok = ((area >= 0.6 - eps) & (area <= 1 + eps) & (aspect >= 3 / 4 - eps)
          & (aspect <= 4 / 3 + eps))
    assert (ok | fallback).all()
    assert ok.float().mean() > 0.5
    flips = tpre.sample_flip(gen, (n,))
    assert abs(flips.float().mean().item() - 0.5) <= 0.05
    train = tpre.sample_train(gen, (n,), size=224)
    assert abs(train.use_rrc.float().mean().item() - 0.5) <= 0.05
    assert train.cut_y.min() >= 0 and train.cut_y.max() < 224 - int(224 * 0.4)


# ------------------------------ RandAugment ---------------------------------


def _img(seed=3, shape=(20, 26, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("op", range(len(jra.RANDAUGMENT_OPS)))
@pytest.mark.parametrize("level", [0.3, -0.7])
def test_each_randaugment_op_matches_jax(op, level):
    img = _img()
    key = jax.random.PRNGKey(op)
    k1, k2 = jax.random.split(key)
    args = torch.stack([_t(jax.random.uniform(k1)), _t(jax.random.uniform(k2))])
    want = jra.RANDAUGMENT_OPS[op](jnp.asarray(img), jnp.float32(level), key)
    got = tra.RANDAUGMENT_OPS[op](torch.tensor(img), torch.tensor(level), args)
    _close(got, want)


def _jax_randaugment_draws(key, num_ops):
    ops, signs, args = [], [], []
    k = key
    for _ in range(num_ops):
        k, k_op, k_sign, k_arg = jax.random.split(k, 4)
        ops.append(int(jax.random.randint(k_op, (), 0, len(jra.RANDAUGMENT_OPS))))
        signs.append(1.0 if bool(jax.random.bernoulli(k_sign)) else -1.0)
        a1, a2 = jax.random.split(k_arg)
        args.append([float(jax.random.uniform(a1)), float(jax.random.uniform(a2))])
    return tra.RandAugmentDraws(torch.tensor(ops), torch.tensor(signs),
                                torch.tensor(args, dtype=torch.float32))


def test_randaugment_matches_jax():
    img = _img(4)
    for s in range(6):
        key = jax.random.PRNGKey(100 + s)
        want = jra.randaugment(key, jnp.asarray(img), num_ops=2, magnitude=9.0)
        got = tra.randaugment_apply(torch.tensor(img), _jax_randaugment_draws(key, 2), 9.0)
        _close(got, want)
    d = tra.sample_randaugment(torch.Generator().manual_seed(0), 3)
    assert d.op.shape == (3,) and set(d.sign.tolist()) <= {-1.0, 1.0}


# ------------------------------ AutoAugment ---------------------------------


def _jax_autoaugment_draws(key, policy):
    tbl = jaa.compile_policy(policy)
    k_idx, k1, k2 = jax.random.split(key, 3)
    i = int(jax.random.randint(k_idx, (), 0, tbl["n"]))
    u_apply, u_sign, args = [], [], []
    for k in (k1, k2):
        k_p, k_s, k_arg = jax.random.split(k, 3)
        u_apply.append(float(jax.random.uniform(k_p)))
        u_sign.append(float(jax.random.uniform(k_s)))
        a1, a2 = jax.random.split(k_arg)
        args.append([float(jax.random.uniform(a1)), float(jax.random.uniform(a2))])
    return taa.AutoAugmentDraws(i, torch.tensor(u_apply), torch.tensor(u_sign),
                                torch.tensor(args, dtype=torch.float32))


def test_compiled_policies_match_jax():
    for policy in ("mlc", "imagenet", "cifar10", "svhn"):
        want, got = jaa.compile_policy(policy), taa.compile_policy(policy)
        assert got["n"] == want["n"]
        for k in ("op", "lvl", "p", "sg"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{policy} {k}")


@pytest.mark.parametrize("policy", ["mlc", "imagenet", "cifar10", "svhn"])
def test_autoaugment_matches_jax(policy):
    img = _img(5)
    for s in range(5):
        key = jax.random.PRNGKey(200 + s)
        want = jaa.autoaugment(key, jnp.asarray(img), policy)
        got = taa.autoaugment_apply(torch.tensor(img), _jax_autoaugment_draws(key, policy),
                                    policy)
        _close(got, want)
    d = taa.sample_autoaugment(torch.Generator().manual_seed(1), policy)
    assert 0 <= d.index < taa.compile_policy(policy)["n"]
