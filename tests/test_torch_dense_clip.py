"""Test-side DenseCLIP of the port against leclip_tpu's: prompt assembly,
prompt text features, exact top-k retrieval and test logits, with the same
weights and the same trainable prompts (made with numpy). fp32 at 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_port
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import dense_clip as jdc
from leclip_tpu.models import prompt as jprompt
from leclip_tpu_torch.models import dense_clip as tdc
from leclip_tpu_torch.models import prompt as tprompt

torch.set_num_threads(2)

CFG = jclip.PRESETS["ViT-TEST"]
CLASSES = ["dog", "cat", "traffic light", "person", "hot dog"]
TOL = dict(atol=2e-5, rtol=2e-5)


def _trainable(n_ctx, seed, csc=False):
    rng = np.random.default_rng(seed)
    shape = (len(CLASSES), n_ctx, 64) if csc else (n_ctx, 64)
    tr = {k: (0.02 * rng.standard_normal(shape)).astype(np.float32)
          for k in ("ctx", "ctx_double")}
    tr["ctx_evidence"] = (0.02 * rng.standard_normal((n_ctx, 64))).astype(np.float32)
    tr.update(temperature=np.float32(2.5), spatial_T=np.float32(3.5), ranking_scale=np.float32(4))
    return tr


@pytest.fixture(scope="module")
def params():
    p = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), CFG))
    return p, to_port(p)


def _learners(params, n_ctx, position):
    jp, tp = params
    _, jc = jprompt.build_prompt_learner(jax.random.PRNGKey(0), jp, CLASSES, n_ctx=n_ctx,
                                         class_token_position=position)
    _, tc = tprompt.build_prompt_learner(torch.Generator().manual_seed(0), tp, CLASSES,
                                         n_ctx=n_ctx, class_token_position=position)
    return jc, tc


@pytest.mark.parametrize("position,csc", [("end", False), ("middle", True), ("front", False)])
def test_assemble_prompts_matches_jax(params, position, csc):
    jc, tc = _learners(params, 4, position)
    for k in ("tokenized_prompts", "eot_idx"):
        np.testing.assert_array_equal(np.asarray(jc[k]), tc[k].numpy())
    assert jc["name_lens"] == tc["name_lens"]
    tr = _trainable(4, 1, csc)
    for neg_wcls in (True, False):
        ref = jprompt.assemble_prompts(jax.tree.map(jnp.asarray, tr), jc, neg_wcls)
        out = tprompt.assemble_prompts(jax.tree.map(torch.tensor, tr), tc, neg_wcls)
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("use_evidence", [False, True])
def test_prompt_text_features_match_jax(params, use_evidence):
    jc, tc = _learners(params, 4, "end")
    tr = _trainable(4, 2)
    flags_j = jdc.DenseFlags(use_evidence=use_evidence)
    flags_t = tdc.DenseFlags(use_evidence=use_evidence)
    ref = jdc.prompt_text_features(params[0], CFG, jax.tree.map(jnp.asarray, tr), jc, flags_j)
    out = tdc.prompt_text_features(params[1], CFG, jax.tree.map(torch.tensor, tr), tc, flags_t)
    assert set(ref) == set(out)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL)


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("bank_rows,topk", [(50, 10), (4, 10)])
def test_retrieval_exact_matches_jax(bank_rows, topk):
    rng = np.random.default_rng(3)
    g, bank = _unit(rng, 6, 32), _unit(rng, bank_rows, 32)
    ja, js = jdc.retrieval_augment(jnp.asarray(g), jnp.asarray(bank), topk, exact=True)
    ta, ts = tdc.retrieval_augment(torch.tensor(g), torch.tensor(bank), topk)
    assert tuple(ts.shape) == (6, topk)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("use_evidence,learn", [(False, False), (True, False), (True, True)])
def test_test_logits_match_jax(use_evidence, learn):
    rng = np.random.default_rng(4)
    n, p, c, e = 5, 7, 6, 32
    feats = (_unit(rng, n, e), _unit(rng, n, p, e))
    text = {k: _unit(rng, c, e) for k in ("pos", "neg", "evd")}
    bank = _unit(rng, 40, e)
    tr = {"temperature": np.float32(1.2), "spatial_T": np.float32(3.0)}
    kw = dict(use_evidence=use_evidence, learn_scale=learn, learn_spatial_scale=learn,
              spatial_scale_image=40.0)
    ref = jdc.test_logits_from_features(
        jax.tree.map(jnp.asarray, tr), jax.tree.map(jnp.asarray, text),
        jdc.ImageFeatures(*map(jnp.asarray, feats)), jdc.DenseFlags(**kw),
        caption_bank=jnp.asarray(bank), topk=5)
    out = tdc.test_logits_from_features(
        jax.tree.map(torch.tensor, tr), jax.tree.map(torch.tensor, text),
        tdc.ImageFeatures(*map(torch.tensor, feats)), tdc.DenseFlags(**kw),
        caption_bank=torch.tensor(bank), topk=5)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-4, rtol=1e-5, err_msg=name)


def test_member_axis_equals_per_member_calls():
    """A stacked member axis (the port's vmap) gives each member's logits."""
    rng = np.random.default_rng(5)
    feats = tdc.ImageFeatures(torch.tensor(_unit(rng, 4, 16)), torch.tensor(_unit(rng, 4, 3, 16)))
    members = [{k: torch.tensor(_unit(rng, 5, 16)) for k in ("pos", "neg", "evd")}
               for _ in range(3)]
    trs = [{"temperature": torch.tensor(0.5 * i), "spatial_T": torch.tensor(2.0 + i)}
           for i in range(3)]
    flags = tdc.DenseFlags(use_evidence=True, learn_scale=True, learn_spatial_scale=True)
    stacked = tdc.test_logits_from_features(
        {k: torch.stack([t[k] for t in trs]) for k in trs[0]},
        {k: torch.stack([m[k] for m in members]) for k in members[0]}, feats, flags)
    for i in range(3):
        one = tdc.test_logits_from_features(trs[i], members[i], feats, flags)
        torch.testing.assert_close(stacked.logits_global[i], one.logits_global)
        torch.testing.assert_close(stacked.logits_local[i], one.logits_local)
