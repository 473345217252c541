"""Dual-encoder fine-tuning (engine/finetune.py), the block stack's remat,
clip_encode_text / clip_similarity and PairBatcher against leclip_tpu's, on
the same numpy-made inputs and the same weights (moved across with the
bridge), at the ViT-TEST / RN-TEST presets.

Tolerances: the losses 1e-5 relative and their gradients 1e-4 of max(1,
max|g|) of each leaf (fp32 sums in another order through both towers);
the learning rate exact in float32 (the same float32 operations, libm's
cosf); the optimizer alone against the optax chain 1e-6 of each step's
largest change; the change of the parameters after each of three
train_steps 1e-3 of the largest change (see that test); checkpoints and
PairBatcher batches exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from _torch_port import to_port
from leclip_tpu.data.loader import PairBatcher as JPairBatcher
from leclip_tpu.engine import finetune as jft
from leclip_tpu.models import clip as jclip
from leclip_tpu_torch.data.loader import PairBatcher
from leclip_tpu_torch.engine import finetune as tft
from leclip_tpu_torch.models import clip as tclip
from leclip_tpu_torch.models import text as ttext
from leclip_tpu_torch.models.convert import to_jax_params

torch.set_num_threads(2)

VIT = jclip.PRESETS["ViT-TEST"]
RN = jclip.PRESETS["RN-TEST"]


@pytest.fixture(scope="module")
def vit_params():
    return jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), VIT))


def _tokens(n, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, 77), np.int32)
    for i, length in enumerate(rng.integers(3, 12, n)):
        toks[i, 0] = 49406
        toks[i, 1:1 + length] = rng.integers(1, 4000, length)
        toks[i, 1 + length] = 49407
    return toks


def _images(n, seed, res=64):
    return np.random.default_rng(seed).standard_normal((n, res, res, 3)).astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _grads_port(params, fn):
    leaves = []

    def live(t):
        leaves.append(t.detach().clone().requires_grad_())
        return leaves[-1]

    from leclip_tpu_torch.device import tree_map

    p = tree_map(live, params)
    loss = fn(p)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss, to_jax_params(tree_map(lambda _: next(grads), p))


def _assert_grads(got, want, tol=1e-4):
    for (path, g), (_, w) in zip(_flat(got), _flat(want)):
        err = np.abs(g - w).max()
        assert err <= tol * max(1.0, np.abs(w).max()), (path, err)


@pytest.mark.parametrize("remat", [False, True])
def test_contrastive_loss_and_gradients_match_jax(vit_params, remat):
    imgs, toks = _images(6, 1), _tokens(6, 2)
    (want, logits_j), gj = jax.value_and_grad(
        lambda p: jft.clip_contrastive_loss(p, VIT, jnp.asarray(imgs), jnp.asarray(toks),
                                            remat=remat), has_aux=True)(vit_params)
    logits = {}

    def fn(p):
        loss, logits["t"] = tft.clip_contrastive_loss(p, VIT, torch.tensor(imgs),
                                                      torch.tensor(toks), remat=remat)
        return loss

    loss, gt = _grads_port(to_port(vit_params), fn)
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(logits["t"].detach().numpy(), np.asarray(logits_j), rtol=1e-5,
                               atol=1e-5)
    _assert_grads(gt, jax.device_get(gj))


def test_remat_gradients_equal_plain_gradients(vit_params):
    """torch.utils.checkpoint recomputes the same blocks: the text tower's
    gradients with remat equal those without it (the same operations)."""
    toks = torch.tensor(_tokens(4, 3))
    out = {}
    for remat in (False, True):
        def fn(p):
            return ttext.encode_text(p, toks, VIT.transformer_heads, remat=remat).square().sum()

        out[remat] = _grads_port(to_port(vit_params["text"]), fn)[1]
    for (path, a), (_, b) in zip(_flat(out[False]), _flat(out[True])):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_logit_scale_is_clamped_at_log_100(vit_params):
    p = to_port(vit_params)
    p["logit_scale"] = torch.tensor(9.0)
    imgs, toks = torch.tensor(_images(4, 4)), torch.tensor(_tokens(4, 4))
    _, logits = tft.clip_contrastive_loss(p, VIT, imgs, toks)
    _, ref = tft.clip_contrastive_loss(dict(p, logit_scale=torch.tensor(np.log(100.0),
                                                                        dtype=torch.float32)),
                                       VIT, imgs, toks)
    torch.testing.assert_close(logits, ref, rtol=0, atol=0)


def test_multilabel_loss_matches_jax():
    params = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(1), RN))
    rng = np.random.default_rng(5)
    imgs = _images(4, 5)
    tf = rng.standard_normal((5, RN.embed_dim)).astype(np.float32)
    tf /= np.linalg.norm(tf, axis=-1, keepdims=True)
    labels = (rng.random((4, 5)) < 0.4).astype(np.float32)
    want, wl = jft.multilabel_finetune_loss(params, RN, jnp.asarray(imgs), jnp.asarray(tf),
                                            jnp.asarray(labels))
    got, gl = tft.multilabel_finetune_loss(to_port(params), RN, torch.tensor(imgs),
                                           torch.tensor(tf), torch.tensor(labels))
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5, atol=1e-5)


def test_clip_encode_text_and_similarity_match_jax(vit_params):
    imgs, toks = _images(3, 6), _tokens(5, 6)
    p = to_port(vit_params)
    for seq in (False, True):
        want = jclip.clip_encode_text(vit_params, VIT, jnp.asarray(toks), sequence=seq)
        got = tclip.clip_encode_text(p, VIT, torch.tensor(toks), sequence=seq)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    wi, wt = jclip.clip_similarity(vit_params, VIT, jnp.asarray(imgs), jnp.asarray(toks))
    gi, gt = tclip.clip_similarity(p, VIT, torch.tensor(imgs), torch.tensor(toks))
    assert gi.shape == (3, 5) and gt.shape == (5, 3)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(gt.numpy(), gi.numpy().T)


@pytest.mark.parametrize("warmup,total", [(3, 20), (0, 10)])
def test_schedule_is_optax_to_the_bit(warmup, total):
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total)
    got = tft.warmup_cosine_schedule(3e-4, warmup, total)
    mid = warmup + (total - warmup) // 2
    for count in sorted({0, warmup, 1, mid, total - 1, total, total + 5}):
        assert got(count) == np.float32(want(count)), count


def test_decay_mask_matches_jax_leaf_for_leaf():
    for cfg in (VIT, RN):
        params = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(2), cfg))
        want = dict(_flat(jft.CLIPFineTuner._decay_mask(params)))
        got = dict(_flat(tft.decay_mask(to_port(params))))
        assert got.keys() == want.keys()
        assert {k: bool(v) for k, v in got.items()} == {k: bool(v) for k, v in want.items()}
    assert got["/text/text_projection"] and not got["/text/token_embedding"]
    assert not got["/logit_scale"] and not got["/visual/bn1/var"]


def _opt_tree(rng, scale=0.5):
    """A small parameter tree whose paths meet every rule of the decay mask:
    kernels, a norm's scale and bias, an embedding and the logit scale."""
    shapes = {"visual": {"conv1": {"kernel": (6, 5)}, "ln_pre": {"scale": (5,), "bias": (5,)}},
              "text": {"token_embedding": (9, 5), "text_projection": (5, 4)},
              "logit_scale": ()}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return np.asarray(scale * rng.standard_normal(s), np.float32)

    return make(shapes)


def test_optimizer_matches_the_optax_chain():
    """finetune_optimizer against optax.chain(clip_by_global_norm(1),
    adamw(warmup_cosine, 0.2, mask=_decay_mask)) on the same parameters and
    gradients, five steps at a peak lr of 1e-2 whose gradient norms (5, 0.3,
    20, 2, 0.05) clip some steps and not others, through the warmup: each
    step's change of the parameters within 1e-6 of its own largest element
    (less one fp32 spacing of p, each side rounding p + update), and Adam's moments within 1e-6 of theirs. Weight decay moves a parameter
    by 0.2·|p|·lr a step (|p| ≈ 0.5), the mask decides it for norms, biases,
    embeddings and the logit scale, and clipping changes the ratio of one
    step's gradient to the next, so each is seen far above the tolerance."""
    from leclip_tpu_torch.device import tree_map

    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    mask = jft.CLIPFineTuner._decay_mask(params)
    schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    ox = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(schedule, weight_decay=0.2, mask=mask))
    tp = to_port(params)
    opt = tft.finetune_optimizer(1e-2, 0.2, 2, 10, tft.decay_mask(tp))
    jp, js, ts = params, ox.init(params), opt.init(tp)
    for norm in (5.0, 0.3, 20.0, 2.0, 0.05):
        g = _opt_tree(rng, 1.0)
        gn = np.sqrt(sum(np.square(v).sum() for _, v in _flat(g)))
        g = jax.tree_util.tree_map(lambda x: np.asarray(x * (norm / gn), np.float32), g)
        updates, js = ox.update(g, js, jp)
        jn = jax.device_get(optax.apply_updates(jp, updates))
        tn, ts = opt.update(to_port(g), ts, tp)
        want = {k: v - p for (k, v), (_, p) in zip(_flat(jn), _flat(jp))}
        got = {k: v - p for (k, v), (_, p) in zip(_flat(to_jax_params(tn)), _flat(jp))}
        assert got.keys() == want.keys()
        scale = max(np.abs(v).max() for v in want.values())
        for k, new in _flat(jn):  # less one spacing of p for each side's rounding of p + u
            d = np.abs(got[k] - want[k]) - np.spacing(np.abs(new))
            assert d.max() <= 1e-6 * scale, (norm, k)
        adam = jax.device_get(js[1][0])
        for name in ("mu", "nu"):
            w, t = dict(_flat(getattr(adam, name))), dict(_flat(to_jax_params(ts["1"]["0"][name])))
            top = max(np.abs(v).max() for v in w.values())
            for k in w:
                assert np.abs(t[k] - w[k]).max() <= 1e-6 * top, (norm, name, k)
        jp, tp = jn, tree_map(lambda x: x, tn)
    assert int(ts["1"]["0"]["count"]) == int(ts["1"]["2"]["count"]) == 5


def _key_bias_free(path, delta):
    """``delta`` with the key third of a qkv_bias leaf set to 0. The key bias
    gets no gradient in exact arithmetic (a softmax ignores a shift of every
    logit of a row), so Adam turns each side's rounding noise there into a
    step of its own; the rest of the tree is compared."""
    if not path.endswith("qkv_bias"):
        return delta
    w = delta.shape[-1] // 3
    out = delta.copy()
    out[..., w:2 * w] = 0
    return out


def test_three_train_steps_match_jax(vit_params):
    """Three steps of the full chain (global-norm clip, AdamW with the decay
    mask, warmup-cosine at a peak lr of 1e-3, so that every step moves the
    parameters far above their fp32 spacing), remat on the text tower, on
    three batches. After each step: the loss within 1e-5 relative, the
    accuracy equal, and each parameter's change from its start (p − p0)
    within 1e-3 of the largest change, less one fp32 spacing of p for each
    side's own rounding of p + update. An element whose gradient is near
    Adam's eps (1e-8) steps by lr·g/eps, so there the two packages' fp32
    rounding of the gradient shows in the step; measured 2.7e-4 here. The
    optimizer state is the optax chain's, leaf for leaf."""
    from flax import serialization

    imgs, toks = _images(24, 7).reshape(3, 8, 64, 64, 3), _tokens(24, 7).reshape(3, 8, 77)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, remat=True)
    j = jft.CLIPFineTuner(vit_params, VIT, **kw)
    t = tft.CLIPFineTuner(to_port(vit_params), VIT, device="cpu", **kw)
    js, ts = j.state, t.state
    p0 = dict(_flat(vit_params))
    for i in range(3):
        js, jm = j.train_step(js, jnp.asarray(imgs[i]), jnp.asarray(toks[i]))
        ts, tm = t.train_step(ts, imgs[i], toks[i])
        assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
        assert tm["acc"].item() == float(jm["acc"])
        got, want = dict(_flat(to_jax_params(ts.params))), dict(_flat(jax.device_get(js.params)))
        moved = max(np.abs(want[k] - p0[k]).max() for k in want)
        assert (moved > 0) == (i > 0)  # the warmup's first step has lr 0
        for k in want:
            d = np.abs(_key_bias_free(k, got[k] - want[k])) - np.spacing(np.abs(want[k]))
            assert d.max() <= 1e-3 * moved, (i, k)
    assert ts.step == int(js.step) == 3
    want = serialization.to_state_dict(jax.device_get(js.opt_state))
    got = to_jax_params(ts.opt_state)
    assert [p for p, _ in _flat(got)] == [p for p, _ in _flat(want)]
    assert int(got["1"]["0"]["count"]) == int(got["1"]["2"]["count"]) == 3


def test_prefetch_raises_and_cpu_tuner_needs_no_card(vit_params):
    """A CPU tuner needs no card, and ``fit(prefetch=2)`` (the batches
    uploaded by a producer thread) runs instead of raising: its two steps
    end on bitwise the parameters of the inline loop's."""
    t = tft.CLIPFineTuner(to_port(vit_params), VIT, device="cpu")
    assert t.device.type == "cpu" and t.state.step == 0
    batches = [{"image": _images(4, 10 + i), "tokens": _tokens(4, 20 + i)} for i in range(2)]
    finals = []
    for prefetch in (0, 2):
        tuner = tft.CLIPFineTuner(to_port(vit_params), VIT, lr=1e-3, warmup_steps=0,
                                  total_steps=10, device="cpu")
        finals.append(tuner.fit(iter(batches), log_every=10, prefetch=prefetch))
    assert finals[0].step == finals[1].step == 2
    for (k, a), (_, b) in zip(_flat(finals[0].params), _flat(finals[1].params)):
        np.testing.assert_array_equal(a, b, err_msg=k)


# ------------------------------ pairs pipeline ------------------------------


def _jpegs(tmp_path, n, seed=0):
    rng = np.random.default_rng(seed)
    d = tmp_path / "imgs"
    d.mkdir(exist_ok=True)
    paths, caps = [], []
    for i in range(n):
        p = str(d / f"p{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (40 + 4 * i, 56, 3)).astype(np.uint8)).save(p)
        paths.append(p)
        caps.append(f"a photo of sample {i}")
    return paths, caps


def test_pair_batcher_batches_equal_jax(tmp_path):
    paths, caps = _jpegs(tmp_path, 7)
    paths.append(str(tmp_path / "big.jpg"))  # larger than the bucket: downscaled into it
    Image.fromarray(np.full((90, 120, 3), 77, np.uint8)).save(paths[-1])
    caps.append("an oversized image")
    for kw in (dict(batch_size=3, seed=4), dict(batch_size=16, seed=0),
               dict(batch_size=2, seed=1, shard_index=1, num_shards=2)):
        want = JPairBatcher(paths, captions=caps, bucket=(64, 64), **kw)
        got = PairBatcher(paths, captions=caps, bucket=(64, 64), **kw)
        assert got.steps_per_epoch() == want.steps_per_epoch()
        for epoch in (0, 1):
            bw, bg = list(want.epoch(epoch)), list(got.epoch(epoch))
            assert len(bw) == len(bg) == want.steps_per_epoch()
            for a, b in zip(bg, bw):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == np.asarray(b[k]).dtype, k
                    np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    with pytest.raises(ValueError, match="captions OR tokens"):
        PairBatcher(paths)


def test_fit_pairs_and_cross_resume_with_jax(tmp_path):
    """JAX's fit_pairs writes epoch 0; the port resumes from that file (the
    same params and optimizer state, bitwise), trains epoch 1 with the
    augmentation in the step and writes JSONL metrics; JAX's
    CLIPFineTuner.resume reads the port's file back (bitwise)."""
    from flax import serialization

    paths, caps = _jpegs(tmp_path, 8)
    out = str(tmp_path / "run")
    kw = dict(lr=1e-4, warmup_steps=0, total_steps=20, remat=False)
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(3), RN))
    j = jft.CLIPFineTuner(jp, RN, **kw)
    j.fit_pairs(JPairBatcher(paths, captions=caps, batch_size=8, bucket=(64, 64)), epochs=1,
                output_dir=out, log_every=100)
    assert int(j.state.step) == 1

    fresh = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(4), RN))
    t = tft.CLIPFineTuner(to_port(fresh), RN, device="cpu", **kw)
    batcher = PairBatcher(paths, captions=caps, batch_size=8, bucket=(64, 64))
    assert t.resume(out) == 1 and t.state.step == 1
    for (path, a), (_, b) in zip(_flat(to_jax_params(t.state.params)),
                                 _flat(jax.device_get(j.state.params))):
        np.testing.assert_array_equal(a, b, err_msg=path)
    want_opt = serialization.to_state_dict(jax.device_get(j.state.opt_state))
    for (path, a), (_, b) in zip(_flat(to_jax_params(t.state.opt_state)),
                                 _flat(want_opt)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    t.fit_pairs(batcher, epochs=2, output_dir=out, log_every=100)
    assert t.state.step == 2
    ckpt = os.path.join(out, "clip_finetune")
    assert open(os.path.join(ckpt, "checkpoint")).read() == "model.ckpt-1"
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows if r["tag"] == "finetune/loss"] == [1, 2]

    j2 = jft.CLIPFineTuner(fresh, RN, **kw)
    assert j2.resume(out) == 2 and int(j2.state.step) == 2
    for (path, a), (_, b) in zip(_flat(jax.device_get(j2.state.params)),
                                 _flat(to_jax_params(t.state.params))):
        np.testing.assert_array_equal(a, b, err_msg=path)
    # and the port resumes its own file (0-d leaves such as logit_scale and
    # the step counts keep their shape)
    t2 = tft.CLIPFineTuner(to_port(fresh), RN, device="cpu", **kw)
    assert t2.resume(out) == 2 and t2.state.step == 2
    for (path, a), (_, b) in zip(_flat(to_jax_params(t2.state.params)),
                                 _flat(to_jax_params(t.state.params))):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_raw_step_draws_from_the_step_seed(tmp_path):
    """The raw-batch step's augmentation is a function of its seed: the same
    seed gives the same step, another seed another batch of crops."""
    paths, caps = _jpegs(tmp_path, 4, seed=2)
    b = next(iter(PairBatcher(paths, captions=caps, batch_size=4, bucket=(64, 64)).epoch(0)))
    params = to_port(jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(5), RN)))
    t = tft.CLIPFineTuner(params, RN, lr=1e-4, warmup_steps=0, total_steps=10, remat=False,
                          device="cpu")
    s0 = t.state
    _, m1 = t.raw_train_step(s0, 11, b["image_u8"], b["content"], b["tokens"])
    _, m2 = t.raw_train_step(s0, 11, b["image_u8"], b["content"], b["tokens"])
    _, m3 = t.raw_train_step(s0, 12, b["image_u8"], b["content"], b["tokens"])
    assert m1["loss"].item() == m2["loss"].item() != m3["loss"].item()
    assert np.isfinite(m1["grad_norm"].item())
