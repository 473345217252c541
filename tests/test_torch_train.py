"""The port's training step against leclip_tpu's, on the CPU with the same
tiny CLIP (2 text layers, width 64, 4 heads), prompt state (N_CTX 4, 8
classes) and CaptionBatcher batches (64 captions, batch 16): 5 fp32 steps of
``make_train_step`` in every ``ema`` x ``use_evidence`` case (and once with
learned logit and spatial scales, once with the LMPT hinge), each port step
taken from JAX's state before it, and its loss, params, EMA twin and
momentum trace held against JAX's step, and 2 steps of
each other loss branch; the frozen caption branch on its kernels' plain
versions (bf16 ``fused=True``, int8 ``q8``) against JAX's Pallas kernels in
interpret mode, at width 128; the train forwards, the EMA update (bitwise)
and the caption probe's validation.

Tolerances. fp32: loss 1e-5 relative; params and EMA twin 1e-5 of
max(1, max|leaf|); both sides compute in fp32 and differ only by summation
order. The momentum trace holds the step's gradients, whose fp32 rounding
scales with the largest of them (a float64 run of the first step puts each
side's spatial_T gradient within 2.5e-5 of the truth where the ctx gradient
reaches 84): 1e-5 of max(1, max|trace|). One exception, fixed in advance:
with the EMA teacher the loss carries 10000 x KL(teacher || student)
between two nearly equal distributions, a difference of nearly equal fp32
sums, so its value (``ema_loss`` and the total ``loss``) is held to 1e-4
relative. Measured on the CPU: the port against JAX 8.6e-5 at most over the
5 steps; JAX against its own run with x64 enabled 6.1e-5 (that run is not
float64 throughout: both packages compute LayerNorm, attention and the
logits in fp32 by design, so a float64 comparison does not remove this
rounding). bf16 caption branch:
the bound of test_torch_block_kernels.py, 4 bf16 ulps of max(1, |ref|) (the
same rounding points, other summation orders). int8: the bound of
test_torch_int8_path.py (rows within 2e-4 but for a tenth of them, whose
int8 code a last-ulp difference flipped; none beyond 2e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port import to_port
from leclip_tpu.data import loader as jloader
from leclip_tpu.data.tokenizer import tokenize
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.engine import train_state as jts
from leclip_tpu.engine import trainer as jtr
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import dense_clip as jdc
from leclip_tpu.models import prompt as jprompt
from leclip_tpu.ops import quant as jq
from leclip_tpu_torch.data import loader as tloader
from leclip_tpu_torch.engine import train_state as tts
from leclip_tpu_torch.engine.checkpoint import restore_train_state
from leclip_tpu_torch.engine import trainer as ttr
from leclip_tpu_torch.engine.config import setup_config as tsetup
from leclip_tpu_torch.models import dense_clip as tdc
from leclip_tpu_torch.models import prompt as tprompt
from leclip_tpu_torch.models.convert import from_jax_q8

torch.set_num_threads(2)

TINY = jclip.CLIPConfig(embed_dim=32, image_resolution=32, vision_layers=(1, 1, 1, 1),
                        vision_width=8, vision_patch_size=None, transformer_width=64,
                        transformer_heads=4, transformer_layers=2)
WIDE = dataclasses.replace(TINY, transformer_width=128, embed_dim=64)
CLASSES = list(COCO_OBJECT_CATEGORIES[:8])
OPTS = ["OPTIM.MAX_EPOCH", "6", "OPTIM.LR", "0.01", "OPTIM.WARMUP_EPOCH", "1",
        "OPTIM.WARMUP_TYPE", "constant", "OPTIM.WARMUP_CONS_LR", "0.001",
        "DATALOADER.BATCH_SIZE_TRAIN", "16", "TRAINER.N_CTX", "4"]


def captions(n=64, seed=0):
    """(tokens [n, 77], multi-hot labels [n, 8]) of "a photo of a X and a Y."."""
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for _ in range(n):
        present = rng.random(len(CLASSES)) < 0.3
        present[rng.integers(len(CLASSES))] = True
        texts.append("a photo of a " + " and a ".join(
            c for c, p in zip(CLASSES, present) if p) + ".")
        labels.append(present.astype(np.int8))
    return np.asarray(tokenize(texts)), np.stack(labels)


def state_dict(tree):
    return jax.device_get(serialization.to_state_dict(tree))


def setup(cfg_opts, clip_cfg=TINY, seed=0):
    """Both packages' params, prompt constants and train state from one JAX
    init, plus the batcher's tokens and labels."""
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(seed), clip_cfg))
    jtrain, jconst = jprompt.build_prompt_learner(jax.random.PRNGKey(seed + 1), jp, CLASSES,
                                                  n_ctx=4)
    rng = np.random.default_rng(seed + 2)  # non-trivial scalars, so their gradients show
    jtrain = dict(jax.device_get(jtrain), temperature=np.float32(2.5 + rng.random()),
                  spatial_T=np.float32(3.0 + rng.random()))
    tp = to_port(jp)
    _, tconst = tprompt.build_prompt_learner(torch.Generator().manual_seed(0), tp, CLASSES,
                                             n_ctx=4)
    return jp, jtrain, jconst, tp, to_port(jtrain), tconst


def flat(tree, prefix=""):
    """{path: float64 array} of a port tree or a JAX state (state-dict form)."""
    if not isinstance(tree, (dict, torch.Tensor, np.ndarray, np.generic, float)):
        tree = state_dict(tree)
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.double().numpy()}
    return {prefix: np.asarray(tree, np.float64)}


def assert_close(port, ref, rtol, what, tree_scale=False):
    """Each leaf of ``port`` within ``rtol`` of max(1, max|leaf|) of ``ref``'s
    (``tree_scale``: of max(1, max|tree|))."""
    port, ref = flat(port), flat(ref)
    assert set(port) == set(ref), (what, set(port) ^ set(ref))
    scale = max([1.0] + [float(np.abs(a).max(initial=0.0)) for a in ref.values()])
    for k, want in ref.items():
        tol = rtol * (scale if tree_scale else max(1.0, float(np.abs(want).max(initial=0.0))))
        np.testing.assert_allclose(port[k], want, atol=tol, rtol=0, err_msg=f"{what}{k}")


def test_caption_batcher_permutations_equal_jax():
    toks, labs = captions()
    jb = jloader.CaptionBatcher(toks, labs, batch_size=16, seed=3)
    tb = tloader.CaptionBatcher(toks, labs, batch_size=16, seed=3)
    assert jb.steps_per_epoch() == tb.steps_per_epoch() == 4
    for epoch in range(3):
        for a, b in zip(jb.epoch(epoch), tb.epoch(epoch), strict=True):
            np.testing.assert_array_equal(a["img"], b["img"])
            np.testing.assert_array_equal(a["label"], b["label"])


# the EMA teacher's loss terms (this file's docstring)
EMA_LOSS_RTOL = 1e-4

# (ema, use_evidence, learned logit / spatial scales, LMPT hinge): the four
# recipe cases (no recipe learns its scales or adds the hinge), the scales'
# own gradients, and the LMPT add-on
CASES = [(False, False, False, False), (False, True, False, False),
         (True, False, False, False), (True, True, False, False),
         (False, True, True, False), (True, False, False, True)]


def compare_steps(opts, n_steps, kwargs):
    """``n_steps`` steps of JAX's and the port's ``make_train_step`` on the
    same CaptionBatcher batches, each held to the bounds of this file's
    docstring. ``kwargs(side)`` gives the step's keyword arguments on each
    side ("jax" or "port")."""
    jcfg, tcfg = jsetup(opts=opts), tsetup(opts=opts)
    jp, jtrain, jconst, tp, ttrain, tconst = setup(opts)
    toks, labs = captions()
    batches = list(tloader.CaptionBatcher(toks, labs, 16, seed=1).epoch(0))
    batches = (batches + list(tloader.CaptionBatcher(toks, labs, 16, seed=1).epoch(1)))[:n_steps]
    # The EMA twin starts away from the params (as after a resume): with the
    # twin equal to them, the teacher equals the student, the ×10000 KL term
    # is zero, and its gradient is fp32 rounding noise times 10,000 (nonzero
    # in JAX, whose compiled step rounds the two heads differently)
    rng = np.random.default_rng(9)
    ema0 = {k: (np.asarray(v) + 0.01 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in jtrain.items()}

    jopt = jts.build_optimizer(jcfg.OPTIM, 4)
    jstep = jtr.make_train_step(jax.tree.map(jnp.asarray, jp), TINY, jconst, jopt,
                                jtr.flags_from_config(jcfg), **kwargs("jax"))
    jstate = jts.create_train_state(jax.tree.map(jnp.array, jtrain), jopt)
    jstate = jstate._replace(ema_params=jax.tree.map(jnp.array, ema0))
    topt = tts.build_optimizer(tcfg.OPTIM, 4)
    step = ttr.make_train_step(tp, TINY, tconst, topt, ttr.flags_from_config(tcfg),
                               **kwargs("port"))
    tstate = tts.create_train_state(ttrain, topt)
    tstate = tstate._replace(ema_params=to_port(ema0))
    assert_close(tstate.opt_state, jstate.opt_state, 0, "opt_state at init")
    loss_rtol = {"loss": EMA_LOSS_RTOL, "ema_loss": EMA_LOSS_RTOL} if jcfg.TRAIN.ema else {}

    for i, batch in enumerate(batches):
        # each port step starts from JAX's state, so every step is held to
        # the fixed bounds (free-running, the two trajectories part by fp32
        # rounding that each step's gradient amplifies)
        sd = state_dict(jstate)
        tstate = restore_train_state(tstate, {k: to_port(v) if isinstance(v, dict) else v
                                              for k, v in sd.items()})
        jstate, jaux = jstep(jstate, jnp.asarray(batch["img"]), jnp.asarray(batch["label"]))
        tstate, taux = step(tstate, batch["img"], batch["label"])
        assert set(taux) == set(jaux)
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=loss_rtol.get(k, 1e-5), atol=0,
                                       err_msg=f"step {i} {k}")
        assert tstate.step == int(jstate.step) == i + 1
        for part, tree_scale in (("params", False), ("ema_params", False),
                                 ("opt_state", True)):
            assert_close({part: getattr(tstate, part)}, {part: getattr(jstate, part)},
                         1e-5, f"step {i} ", tree_scale=tree_scale)
    # the run moved: the last step's params are not the first step's
    assert not torch.equal(tstate.params["ctx"], ttrain["ctx"])


@pytest.mark.parametrize("ema,evidence,scales,lmpt", CASES,
                         ids=["noema-noevd", "noema-evd", "ema-noevd", "ema-evd",
                              "noema-evd-scales", "ema-lmpt"])
def test_make_train_step_matches_jax_for_5_steps(ema, evidence, scales, lmpt):
    opts = OPTS + ["TRAIN.ema", str(ema), "TRAINER.use_evidence", str(evidence),
                   "TRAIN.IF_LEARN_SCALE", str(scales),
                   "TRAIN.IF_LEARN_spatial_SCALE", str(scales)]
    counts = np.arange(5, 5 + len(CLASSES), dtype=np.float32) * 7

    def kwargs(side):
        c = jnp.asarray(counts) if side == "jax" else torch.tensor(counts)
        return dict(ema=ema, lmpt=lmpt, m_ctx=2, lmpt_class_counts=c)

    compare_steps(opts, 5, kwargs)


@pytest.mark.parametrize("branch", ["soft_ce", "dbl", "ranking_with_cooccurrence",
                                    "CustomCLIP"])
def test_other_loss_branches_match_jax_for_2_steps(branch):
    """The loss switch's other branches (no shipped recipe runs them) and the
    global-only CustomCLIP head, 2 steps each."""
    from leclip_tpu.ops import losses as jlosses
    from leclip_tpu_torch.ops import losses as tlosses

    rng = np.random.default_rng(4)
    freq = rng.integers(3, 40, len(CLASSES)).astype(np.float32)
    cooc = rng.random((len(CLASSES), len(CLASSES))).astype(np.float32)
    cooc /= cooc.sum(-1, keepdims=True)

    def kwargs(side):
        if branch == "CustomCLIP":
            return dict(model_kind="CustomCLIP")
        if side == "jax":
            return dict(loss_name=branch, co_matrix=jnp.asarray(cooc),
                        resample_params=jlosses.make_resample_loss_params(freq, 64 - freq))
        return dict(loss_name=branch, co_matrix=torch.tensor(cooc),
                    resample_params=tlosses.make_resample_loss_params(freq, 64 - freq))

    compare_steps(OPTS + ["TRAINER.use_evidence", "True"], 2, kwargs)


def _caption_inputs(cfg, seed):
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(seed), cfg))
    return jp, captions(16, seed)[0]


def test_bf16_caption_branch_matches_jax_fused():
    """encode_captions(fused=True) on a bf16 tower: the port's plain versions
    of the block kernels against JAX's Pallas kernels (16 x 77 rows, so the
    JAX side really fuses)."""
    jp, toks = _caption_inputs(WIDE, 5)
    jp16 = jax.device_get(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                                       if a.dtype == np.float32 else a, jp))
    flags = jdc.DenseFlags()
    ref = jdc.encode_captions(jax.tree.map(jnp.asarray, jp16), WIDE, jnp.asarray(toks), flags,
                              fused=True)
    out = tdc.encode_captions(to_port(jp16), WIDE, torch.tensor(toks), tdc.DenseFlags(),
                              fused=True)
    for name, o, r in zip(ref._fields, out, ref):
        o, r = o.float().numpy(), np.asarray(r, np.float32)
        assert o.shape == r.shape and np.isfinite(o).all(), name
        tol = 4 * 2.0 ** -8 * np.maximum(1.0, np.abs(r))
        assert (np.abs(o - r) <= tol).all(), (name, np.abs(o - r).max())
    # the fused branch is not the unfused one: it rounds where the kernels do
    plain = tdc.encode_captions(to_port(jp16), WIDE, torch.tensor(toks), tdc.DenseFlags())
    assert not torch.equal(plain.spatial_feats, out.spatial_feats)


def test_int8_caption_branch_matches_jax_q8():
    jp, toks = _caption_inputs(WIDE, 6)
    jq8 = jax.device_get(jq.quantize_block_stack(jax.tree.map(jnp.asarray, jp["text"]["blocks"])))
    ref = jdc.encode_captions(jax.tree.map(jnp.asarray, jp), WIDE, jnp.asarray(toks),
                              jdc.DenseFlags(), q8=jq8)
    out = tdc.encode_captions(to_port(jp), WIDE, torch.tensor(toks), tdc.DenseFlags(),
                              q8=from_jax_q8(jq8))
    for name, o, r in zip(ref._fields, out, ref):
        o, r = o.numpy(), np.asarray(r, np.float32)
        assert o.shape == r.shape and np.isfinite(o).all(), name
        diff = np.abs(o - r).reshape(-1, o.shape[-1])
        over = diff > 2e-4 + 2e-4 * np.abs(r).reshape(diff.shape)
        assert over.any(-1).mean() <= 0.1 and diff.max() <= 2e-2 * max(1.0, np.abs(r).max()), name


def test_int8_caption_branch_on_a_bf16_stack():
    """The card's int8 caption branch on the CPU: codes and scales from the
    fp32 blocks (the trainer quantizes the tower as given, as JAX does), the
    stack in bf16 as ``int8_kernel_stack`` lays it out for the kernels,
    embeddings, ln_final and projection in fp32. Its output
    is fp32 and departs from JAX's fp32-residual q8 branch only by the bf16
    residual stream: min cosine >= 0.999 per row (a fixed bound; measured
    0.9996 at RN50's 12 x 512 text tower)."""
    from leclip_tpu_torch.data.datasets import CaptionDataset

    jp, toks = _caption_inputs(WIDE, 6)
    jq8 = jax.device_get(jq.quantize_block_stack(jax.tree.map(jnp.asarray, jp["text"]["blocks"])))
    ref = jdc.encode_captions(jax.tree.map(jnp.asarray, jp), WIDE, jnp.asarray(toks),
                              jdc.DenseFlags(), q8=jq8)
    tr = ttr.CaptionDistillTrainer(
        tsetup(opts=OPTS + ["OUTPUT_DIR", "", "TRAIN.int8_captions", "True"]), to_port(jp), WIDE,
        dataset=CaptionDataset(toks, captions(16, 6)[1], [], CLASSES), device="cpu")
    q8 = tr._step_kwargs["caption_q8"]
    want = from_jax_q8(jq8)
    for part in ("qkv", "fc", "proj"):
        grp = "attn" if part == "qkv" else "mlp"
        assert torch.equal(q8[grp][part][0], want[grp][part][0]), part
        np.testing.assert_allclose(q8[grp][part][1].numpy(), want[grp][part][1].numpy(),
                                   rtol=1e-6, err_msg=part)
    text = tr._step_kwargs["caption_text"]
    bf16, q8b = ttr.int8_kernel_stack(text, q8)
    out = tdc.encode_captions({"text": bf16}, WIDE, torch.tensor(toks), tdc.DenseFlags(), q8=q8b)
    fp32 = tdc.encode_captions({"text": text}, WIDE, torch.tensor(toks), tdc.DenseFlags(), q8=q8)
    assert out.spatial_feats.dtype == torch.float32
    assert not torch.equal(out.spatial_feats, fp32.spatial_feats)
    valid = np.asarray(ref.pos_mask) == 0
    for name, o, r in (("global_feat", out.global_feat, ref.global_feat),
                       ("spatial_feats", out.spatial_feats, ref.spatial_feats)):
        o, r = o.double().numpy(), np.asarray(r, np.float64)
        if name == "spatial_feats":
            o, r = o[valid], r[valid]
        cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
        assert cos.min() >= 0.999, (name, cos.min())


def test_trainer_routes_the_caption_branch():
    """On the CPU the trainer runs the caption branch plain (as JAX off the
    TPU) unless int8 is asked for; the bf16 PREC casts the frozen towers and
    keeps the prompt params fp32."""
    from leclip_tpu_torch.data.datasets import CaptionDataset

    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), TINY))
    toks, labs = captions()
    ds = CaptionDataset(toks, labs, [], CLASSES)
    base = OPTS + ["OUTPUT_DIR", ""]
    for extra, route, dtype in (([], "plain", torch.float32),
                                (["TRAINER.PREC", "bf16"], "plain", torch.bfloat16),
                                (["TRAIN.int8_captions", "True"], "int8", torch.float32)):
        tr = ttr.CaptionDistillTrainer(tsetup(opts=base + extra), to_port(jp), TINY,
                                       dataset=ds, device="cpu")
        assert tr.caption_route == route
        assert tr.clip_params["text"]["blocks"]["ln_1"]["scale"].dtype == dtype
        assert all(v.dtype == torch.float32 for v in tr.state.params.values())
        state, aux = tr.train_step(tr.state, toks[:16], labs[:16])
        assert np.isfinite(float(aux["loss"])) and state.step == 1


@pytest.mark.parametrize("opt", [["TRAIN.prefetch_batches", "2"]], ids=["prefetch_batches"])
def test_trainer_refuses_options_it_does_not_run(opt):
    """Options of the JAX trainer that the port does not run raise at
    construction instead of being ignored."""
    from leclip_tpu_torch.data.datasets import CaptionDataset

    toks, labs = captions(16)
    with pytest.raises(NotImplementedError, match=opt[0]):
        ttr.CaptionDistillTrainer(tsetup(opts=OPTS + ["OUTPUT_DIR", ""] + opt),
                                  to_port(jax.device_get(jclip.init_clip_params(
                                      jax.random.PRNGKey(0), TINY))),
                                  TINY, dataset=CaptionDataset(toks, labs, [], CLASSES),
                                  device="cpu")


def test_train_forwards_match_jax():
    """``dense_train_forward`` and ``custom_clip_train_forward`` (caption
    tokens to logits, the caption branch without gradients) on the same
    weights and prompts: fp32, 1e-5 of max(1, max|logit|)."""
    jp, jtrain, jconst, tp, ttrain, tconst = setup([])
    toks = captions(8, 3)[0]
    for evidence in (False, True):
        jflags, tflags = jdc.DenseFlags(use_evidence=evidence), tdc.DenseFlags(
            use_evidence=evidence)
        for jfn, tfn in ((jdc.dense_train_forward, tdc.dense_train_forward),
                         (jdc.custom_clip_train_forward, tdc.custom_clip_train_forward)):
            ref = jfn(jax.tree.map(jnp.asarray, jp), TINY, jax.tree.map(jnp.asarray, jtrain),
                      jconst, jnp.asarray(toks), jflags)
            out = tfn(tp, TINY, ttrain, tconst, torch.tensor(toks), tflags)
            for o, r in zip(out, ref):
                assert (o is None) == (r is None)
                if r is not None:
                    r = np.asarray(r)
                    np.testing.assert_allclose(o.detach().numpy(), r, rtol=0,
                                               atol=1e-5 * max(1.0, np.abs(r).max()))


def test_ema_update_rounds_as_the_jax_step():
    """The EMA update equals JAX's compiled one bitwise (one rounding, as
    XLA's FMA), so the teacher of a fresh twin equals the student and the
    first step's ×10000 KL term is exactly 0 on both sides."""
    from leclip_tpu.models.prompt import ema_update as jema

    rng = np.random.default_rng(0)
    p = (0.02 * rng.standard_normal(4096)).astype(np.float32)
    m = p + (1e-3 * rng.standard_normal(4096)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a, b: jema({"x": a}, {"x": b}, 0.995))(
        jnp.asarray(m), jnp.asarray(p))["x"])
    out = tprompt.ema_update({"x": torch.tensor(m)}, {"x": torch.tensor(p)}, 0.995)["x"]
    np.testing.assert_array_equal(out.numpy(), ref)
    same = tprompt.ema_update({"x": torch.tensor(p)}, {"x": torch.tensor(p)}, 0.995)["x"]
    np.testing.assert_array_equal(same.numpy(), p)


def test_validate_probe_matches_jax():
    """TRAIN.probe_holdout: both trainers hold out the same captions and,
    with the same prompt params, score them to the same mAP / F1."""
    from leclip_tpu.data.datasets import CaptionDataset as JDataset
    from leclip_tpu_torch.data.datasets import CaptionDataset as TDataset

    toks, labs = captions()
    opts = OPTS + ["TRAIN.probe_holdout", "4", "OUTPUT_DIR", ""]
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), TINY))
    jtrainer = jtr.CaptionDistillTrainer(jsetup(opts=opts), jp, TINY,
                                         dataset=JDataset(toks, labs, [], CLASSES))
    ttrainer = ttr.CaptionDistillTrainer(tsetup(opts=opts), to_port(jp), TINY,
                                         dataset=TDataset(toks, labs, [], CLASSES),
                                         device="cpu")
    np.testing.assert_array_equal(ttrainer.probe_tokens, jtrainer.probe_tokens)
    ttrainer.state = ttrainer.state._replace(
        params=to_port(jax.device_get(jtrainer.state.params)))
    ref, out = jtrainer.validate_probe(), ttrainer.validate()
    assert out.keys() == ref.keys() and ref["mAP"] > 0
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, err_msg=k)
