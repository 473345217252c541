"""The last four public functions of leclip_tpu to reach the port, each
against its JAX function on the CPU, with the same inputs made with numpy:

* ``ops/ensemble.learn_routing``: the routing table equal to JAX's, in the
  margin, base, no-positive, ``min_pos`` and ``confirm_splits`` cases of
  tests/test_ensemble_accuracy.py (host numpy on both sides: exact);
* ``models/dense_clip.custom_clip_test_forward``: the global-only test
  logits of an RN-TEST and a ViT-TEST tower, fp32, within 1e-5 (sums in
  another order through the tower);
* ``CaptionDistillTrainer.set_cooccurrence``: the next step under
  ranking_with_cooccurrence equal to JAX's trainer's with the same matrix,
  from the same state (loss and parameters within 1e-5 relative, the bound
  of tests/test_torch_train.py);
* ``models/prompt.sparse_token_embedding_stub``: the same rows as JAX's
  stub, and a prompt learner on it bitwise equal to one on the full table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_port
from leclip_tpu.engine import trainer as jtr
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import dense_clip as jdc
from leclip_tpu.models import prompt as jprompt
from leclip_tpu.ops import ensemble as jens
from leclip_tpu_torch.engine import trainer as ttr
from leclip_tpu_torch.engine.checkpoint import restore_train_state
from leclip_tpu_torch.engine.config import setup_config as tsetup
from leclip_tpu_torch.models import dense_clip as tdc
from leclip_tpu_torch.models import prompt as tprompt
from leclip_tpu_torch.ops import ensemble as tens

torch.set_num_threads(2)


def _guard_scores():
    rng = np.random.default_rng(1)
    labels = (rng.random((400, 6)) < 0.3).astype(np.float32)
    scores = {m: rng.normal(0, 1, labels.shape).astype(np.float32) for m in ("best", "ema")}
    return scores, labels


def _noise_scores(strong=False):
    rng = np.random.default_rng(2)
    n, c = 600, 30
    labels = (rng.random((n, c)) < 0.1).astype(np.float32)
    scores = {m: (2.0 * labels + rng.normal(0, 1.5, (n, c))).astype(np.float32)
              for m in ("best", "ema", "diff")}
    if strong:  # a real specialist: 'ema' has an edge on class 0
        scores["ema"][:, 0] += 3.0 * labels[:, 0]
    return scores, labels


def _no_positives():
    scores, labels = _guard_scores()
    labels[:, 3] = 0.0
    return scores, labels


ROUTING_CASES = {
    "impossible margin": (_guard_scores, dict(margin=10.0)),
    "negative margin": (_guard_scores, dict(margin=-10.0)),
    "class without positives": (_no_positives, dict(margin=-10.0)),
    "no guards": (_noise_scores, dict(margin=0.0)),
    "min_pos and confirm_splits": (_noise_scores, dict(margin=0.0, min_pos=30,
                                                       confirm_splits=3)),
    "specialist through the guards": (lambda: _noise_scores(True),
                                      dict(margin=0.02, min_pos=10, confirm_splits=3)),
    "single member": (lambda: ({"best": _guard_scores()[0]["best"]}, _guard_scores()[1]), {}),
}


@pytest.mark.parametrize("case", list(ROUTING_CASES))
def test_learn_routing_matches_jax(case):
    make, kwargs = ROUTING_CASES[case]
    scores, labels = make()
    ref = jens.learn_routing(scores, labels, base="best", **kwargs)
    out = tens.learn_routing({k: v.copy() for k, v in scores.items()}, labels.copy(),
                             base="best", **kwargs)
    assert out == ref
    assert all(isinstance(c, int) for cols in out.values() for c in cols)
    if case == "class without positives":
        assert not any(3 in cols for cols in out.values())


def test_learn_routing_refuses_a_missing_base():
    scores, labels = _guard_scores()
    for fn in (jens.learn_routing, tens.learn_routing):
        with pytest.raises(ValueError):
            fn(scores, labels, base="missing")


@pytest.mark.parametrize("preset", ["RN-TEST", "ViT-TEST"])
def test_custom_clip_test_forward_matches_jax(preset):
    cfg = jclip.PRESETS[preset]
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(3), cfg))
    tp = to_port(jp)
    rng = np.random.default_rng(4)
    images = rng.standard_normal((3, cfg.image_resolution, cfg.image_resolution, 3)
                                 ).astype(np.float32)
    pos = rng.standard_normal((7, cfg.embed_dim)).astype(np.float32)
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    ref, ref_none = jdc.custom_clip_test_forward(jax.tree.map(jnp.asarray, jp), cfg, {},
                                                 {"pos": jnp.asarray(pos)},
                                                 jnp.asarray(images), jdc.DenseFlags())
    out, none = tdc.custom_clip_test_forward(tp, cfg, {}, {"pos": torch.tensor(pos)},
                                             torch.tensor(images), tdc.DenseFlags())
    assert ref_none is None and none is None
    assert tuple(out.shape) == ref.shape == (3, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


CLASSES = ["dog", "cat", "traffic light", "person", "hot dog", "pizza", "car", "bus"]
TINY = jclip.CLIPConfig(embed_dim=32, image_resolution=32, vision_layers=(1, 1, 1, 1),
                        vision_width=8, vision_patch_size=None, transformer_width=64,
                        transformer_heads=4, transformer_layers=2)
OPTS = ["OPTIM.MAX_EPOCH", "2", "OPTIM.LR", "0.01", "DATALOADER.BATCH_SIZE_TRAIN", "16",
        "TRAINER.N_CTX", "4", "TRAIN.LOSSFUNC", "ranking_with_cooccurrence", "OUTPUT_DIR", ""]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().double().numpy()}
    return {prefix: np.asarray(tree, np.float64)}


def test_set_cooccurrence_step_matches_jax():
    """Both trainers built from the same weights and captions, the same
    matrix installed by set_cooccurrence, then one step from JAX's state."""
    from flax import serialization

    from leclip_tpu.data.datasets import CaptionDataset as JDataset
    from leclip_tpu.data.tokenizer import tokenize
    from leclip_tpu_torch.data.datasets import CaptionDataset as TDataset

    rng = np.random.default_rng(5)
    texts, labels = [], []
    for _ in range(32):
        present = rng.random(len(CLASSES)) < 0.3
        present[rng.integers(len(CLASSES))] = True
        texts.append("a photo of a " + " and a ".join(c for c, p in zip(CLASSES, present) if p))
        labels.append(present.astype(np.int8))
    toks, labs = np.asarray(tokenize(texts)), np.stack(labels)
    cooc = rng.random((len(CLASSES), len(CLASSES))).astype(np.float32)
    cooc /= cooc.sum(-1, keepdims=True)

    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), TINY))
    jt = jtr.CaptionDistillTrainer(jsetup(opts=OPTS), jp, TINY,
                                   dataset=JDataset(toks, labs, [], CLASSES))
    tt = ttr.CaptionDistillTrainer(tsetup(opts=OPTS), to_port(jp), TINY,
                                   dataset=TDataset(toks, labs, [], CLASSES), device="cpu")
    own = tt.train_step
    jt.set_cooccurrence(cooc)
    tt.set_cooccurrence(cooc)
    assert tt.train_step is not own
    assert tt._step_kwargs["co_matrix"].dtype == torch.float32
    sd = jax.device_get(serialization.to_state_dict(jt.state))
    state = restore_train_state(tt.state, {k: to_port(v) if isinstance(v, dict) else v
                                           for k, v in sd.items()})
    jstate, jaux = jt.train_step(jt.state, jnp.asarray(toks[:16]), jnp.asarray(labs[:16]))
    tstate, taux = tt.train_step(state, toks[:16], labs[:16])
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, atol=0, err_msg=k)
    want = _flat(jax.device_get(serialization.to_state_dict(jstate.params)))
    got = _flat(tstate.params)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=k)
    # the matrix is what the step used: the trainer's own one gives another loss
    _, own_aux = own(state, toks[:16], labs[:16])
    assert float(own_aux["loss"]) != float(taux["loss"])


@pytest.mark.parametrize("kwargs", [{"n_ctx": 16}, {"n_ctx": 4}, {"ctx_init": "a photo of a"}],
                         ids=["n_ctx16", "n_ctx4", "ctx_init"])
def test_sparse_token_embedding_stub_matches_jax(kwargs):
    cfg = jclip.PRESETS["ViT-TEST"]
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(2), cfg))
    tp = to_port(jp)
    table = np.asarray(jp["text"]["token_embedding"])
    ref = jprompt.sparse_token_embedding_stub(table, CLASSES, **kwargs)
    stub = tprompt.sparse_token_embedding_stub(tp["text"]["token_embedding"], CLASSES, **kwargs)
    assert isinstance(stub, torch.Tensor) and stub.device.type == "cpu"
    np.testing.assert_array_equal(stub.numpy(), ref)
    np.testing.assert_array_equal(
        tprompt.sparse_token_embedding_stub(table, CLASSES, **kwargs).numpy(), ref)
    assert (stub.abs().sum(-1) > 0).sum() < 200
    full_tr, full_cs = tprompt.build_prompt_learner(torch.Generator().manual_seed(1), tp,
                                                    CLASSES, **kwargs)
    tr, cs = tprompt.build_prompt_learner(torch.Generator().manual_seed(1),
                                          {"text": {"token_embedding": stub}}, CLASSES, **kwargs)
    for k, v in full_cs.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(cs[k], v), k
        else:
            assert cs[k] == v, k
    for k, v in full_tr.items():
        assert torch.equal(tr[k], v), k
