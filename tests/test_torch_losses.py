"""Every loss of leclip_tpu_torch/ops/losses.py against leclip_tpu/ops/losses.py
on the same seeded inputs: the value, and the gradient with respect to the
logits (``jax.grad`` against autograd).

Tolerance: 1e-6 relative (values) and 1e-6 of max(1, max|grad|) (gradients):
both sides compute in fp32 and differ only by summation order. One case
puts a ranking hinge exactly on its margin, where ``jnp.maximum``'s gradient
is ½ (JAX splits a tie) and ``torch.clamp``'s would be 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leclip_tpu.ops import losses as J
from leclip_tpu_torch.ops import losses as T

torch.set_num_threads(2)

B, C, LEN, D = 6, 10, 9, 16


def _data(seed):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((B, C))).astype(np.float32)
    labels = (rng.random((B, C)) < 0.3).astype(np.float32)
    labels[:, 0] = 1.0
    soft = rng.random((B, C)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    cooc = rng.random((C, C)).astype(np.float32)
    cooc /= cooc.sum(-1, keepdims=True)
    counts = rng.integers(5, 500, C).astype(np.float32)
    return dict(logits=logits, labels=labels, soft=soft, cooc=cooc, counts=counts,
                teacher=(logits + rng.standard_normal((B, C))).astype(np.float32),
                weights=rng.random(C).astype(np.float32),
                asl_y=rng.choice([-1.0, 0.0, 1.0], (B, C)).astype(np.float32),
                caps=rng.standard_normal((B, LEN + 2, D)).astype(np.float32),
                prompts=rng.standard_normal((C, LEN + 2, D)).astype(np.float32),
                hinge_x=rng.random((B, C, LEN)).astype(np.float32),
                hinge_y=rng.choice([-1.0, 1.0], (B, C, LEN)).astype(np.float32),
                neg_counts=(1000 - counts).astype(np.float32))


def _dbl(mod, d, **kw):
    return mod.make_resample_loss_params(d["counts"], d["neg_counts"], **kw)


# name: (fn(module, x, data) of the differentiated input x, the input's key)
CASES = {
    "ranking": (lambda m, x, d: m.ranking_loss(x, d["labels"], scale=1.5, margin=0.7), "logits"),
    "ranking_cooccurrence": (lambda m, x, d: m.ranking_loss_with_cooccurrence(
        x, d["labels"], d["cooc"]), "logits"),
    "ranking_reweighting": (lambda m, x, d: m.ranking_loss_reweighting(
        x, d["labels"], d["weights"]), "logits"),
    "soft_cross_entropy": (lambda m, x, d: m.soft_cross_entropy(x, d["soft"]), "logits"),
    "norm_logits_bce": (lambda m, x, d: m.norm_logits_bce(x, d["labels"]), "logits"),
    "softmax_sigmoid_bce": (lambda m, x, d: m.softmax_sigmoid_bce(x, d["labels"]), "logits"),
    "sigmoid_focal": (lambda m, x, d: m.sigmoid_focal_loss(x, d["soft"]), "logits"),
    "sigmoid_focal_alpha": (lambda m, x, d: m.sigmoid_focal_loss(x, d["soft"], alpha=0.25),
                            "logits"),
    "kl_distill": (lambda m, x, d: m.kl_distill_loss(x, d["teacher"]), "logits"),
    "asymmetric_partial": (lambda m, x, d: m.dualcoop_loss(x, d["asl_y"]), "logits"),
    "asymmetric_full": (lambda m, x, d: m.asl_loss(x, d["labels"]), "logits"),
    "resample_rebalance": (lambda m, x, d: m.resample_loss(x, d["labels"], _dbl(m, d)),
                           "logits"),
    "resample_focal_bias_neg": (lambda m, x, d: m.resample_loss(x, d["labels"], _dbl(
        m, d, focal=True, init_bias_factor=0.05, neg_scale=2.0)), "logits"),
    "resample_sqrt_inv": (lambda m, x, d: m.resample_loss(x, d["labels"], _dbl(
        m, d, reweight_func="sqrt_inv")), "logits"),
    "resample_none": (lambda m, x, d: m.resample_loss(x, d["labels"], _dbl(
        m, d, reweight_func="")), "logits"),
    "soft_margin_hinge": (lambda m, x, d: m.soft_margin_hinge_loss(x, d["hinge_y"], d["counts"]),
                          "hinge_x"),
    "lmpt_hinge": (lambda m, x, d: m.lmpt_hinge_from_embeddings(
        x, d["prompts"], d["labels"], d["counts"], m_ctx=2), "caps"),
}


def _to(d, conv):
    return {k: conv(v) for k, v in d.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradient_match_jax(name):
    fn, key = CASES[name]
    d = _data(sum(map(ord, name)))
    jd = _to(d, jnp.asarray)
    td = _to(d, torch.tensor)
    ref, jgrad = jax.value_and_grad(lambda x: fn(J, x, jd))(jd[key])
    x = td[key].clone().requires_grad_(True)
    out = fn(T, x, td)
    (grad,) = torch.autograd.grad(out, x)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6, atol=0)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(jgrad).max())))
    assert np.abs(jgrad).max() > 0


def test_hinge_on_its_margin_takes_jax_tie_gradient():
    """Pred gaps of exactly the margin: every (neg, pos) hinge sits at 0."""
    y = np.array([[1.0, 0.0, 1.0, 0.0]], np.float32)
    pred = np.array([[2.0, 1.0, 2.0, 1.0]], np.float32)
    jgrad = np.asarray(jax.grad(lambda p: J.ranking_loss(p, y))(jnp.asarray(pred)))
    x = torch.tensor(pred, requires_grad=True)
    (grad,) = torch.autograd.grad(T.ranking_loss(x, torch.tensor(y)), x)
    np.testing.assert_array_equal(grad.numpy(), jgrad)
    assert np.abs(jgrad).max() == 1.0  # two ties of ½ per class
