"""The adapter trainer of the port (leclip_tpu_torch/models/adapter.py and
``CaptionDistillAdapterTrainer`` in engine/trainer.py, registered as
``Caption_distill_double_adapter``) against leclip_tpu's, on the CPU with
test_torch_train.py's tiny CLIP (2 text layers, width 64) and captions.

* ``apply_adapter`` and the adapter-encoded prompt features on JAX's
  adapter params: 1e-5 of max(1, max|ref|) (fp32, summation order only).
* 3 steps of the adapter trainer, the adapter frozen and trainable, with and
  without the EMA teacher, each port step taken from the JAX trainer's
  state before it: loss 1e-5 relative (the EMA teacher's ×10000 KL term
  1e-4, as test_torch_train.py fixes it), params, EMA twin and optimizer
  state 1e-5 of max(1, max|leaf|) (the trace: of the tree's largest).
* The counterparts of tests/test_train.py's ``test_adapter_trainer`` (10
  steps lower the loss and move the trainable adapter) and
  ``test_adapter_frozen_variant`` (the adapter stays outside the state).
* The caption probe's ``validate`` scores through the adapter, as JAX's
  does: the evaluator's results within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_port
from test_torch_train import CLASSES, EMA_LOSS_RTOL, OPTS, TINY, assert_close, captions, \
    state_dict
from leclip_tpu.data.datasets import CaptionDataset as JDataset
from leclip_tpu.engine import trainer as jtr
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu.models import adapter as jadapter
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import dense_clip as jdc
from leclip_tpu.models import prompt as jprompt
from leclip_tpu_torch.data.datasets import CaptionDataset as TDataset
from leclip_tpu_torch.engine import trainer as ttr
from leclip_tpu_torch.engine.checkpoint import restore_train_state
from leclip_tpu_torch.engine.config import setup_config as tsetup
from leclip_tpu_torch.models import adapter as tadapter
from leclip_tpu_torch.models import dense_clip as tdc
from leclip_tpu_torch.models import prompt as tprompt
from leclip_tpu_torch.utils.registry import TRAINER_REGISTRY

torch.set_num_threads(2)


def _close(out, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def test_apply_adapter_matches_jax():
    params = jax.device_get(jadapter.init_adapter_params(jax.random.PRNGKey(3), 64, 4))
    x = np.random.default_rng(0).standard_normal((5, 7, 64)).astype(np.float32)
    ref = jadapter.apply_adapter(jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    out = tadapter.apply_adapter(torch.tensor(x), to_port(params))
    _close(out, ref)
    # the port's own init: JAX's shapes and He scales
    own = tadapter.init_adapter_params(torch.Generator().manual_seed(0), 512, 4)
    assert own["down_kernel"].shape == (512, 128) and own["up_kernel"].shape == (128, 512)
    for k, fan_in in (("down_kernel", 512), ("up_kernel", 128)):
        assert abs(float(own[k].std()) / (2 / fan_in) ** 0.5 - 1) < 0.1, k


def test_adapter_prompt_features_match_jax():
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), TINY))
    jtrain, jconst = jprompt.build_prompt_learner(jax.random.PRNGKey(1), jp, CLASSES, n_ctx=4)
    adp = jax.device_get(jadapter.init_adapter_params(jax.random.PRNGKey(2), 64, 4))
    tp = to_port(jp)
    _, tconst = tprompt.build_prompt_learner(torch.Generator().manual_seed(0), tp, CLASSES,
                                             n_ctx=4)
    for evidence in (False, True):
        ref = jdc.prompt_text_features(jax.tree.map(jnp.asarray, jp), TINY, jtrain, jconst,
                                       jdc.DenseFlags(use_evidence=evidence),
                                       adapter=jax.tree.map(jnp.asarray, adp))
        out = tdc.prompt_text_features(tp, TINY, to_port(jax.device_get(jtrain)), tconst,
                                       tdc.DenseFlags(use_evidence=evidence), adapter=to_port(adp))
        plain = tdc.prompt_text_features(tp, TINY, to_port(jax.device_get(jtrain)), tconst,
                                         tdc.DenseFlags(use_evidence=evidence))
        assert set(out) == set(ref)
        for k in ref:
            _close(out[k], ref[k])
            assert not torch.allclose(out[k], plain[k], atol=1e-3)  # the adapter acts


def _trainers(opts, n=64):
    """The JAX and the port adapter trainer on the same weights, captions,
    adapter and prompt state."""
    toks, labs = captions(n)
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), TINY))
    jtrainer = jtr.CaptionDistillAdapterTrainer(jsetup(opts=opts), jp, TINY,
                                                dataset=JDataset(toks, labs, [], CLASSES))
    ttrainer = ttr.CaptionDistillAdapterTrainer(
        tsetup(opts=opts), to_port(jp), TINY, dataset=TDataset(toks, labs, [], CLASSES),
        device="cpu", adapter=to_port(jtrainer.adapter))
    ttrainer.state = restore_train_state(ttrainer.state, {
        k: to_port(v) if isinstance(v, dict) else v
        for k, v in state_dict(jtrainer.state).items()})
    return jtrainer, ttrainer


CASES = {"frozen": [], "trainable": ["TRAINER.adapter_trainable", "True"],
         "trainable-ema": ["TRAINER.adapter_trainable", "True", "TRAIN.ema", "True"]}


@pytest.mark.parametrize("case", list(CASES))
def test_adapter_trainer_steps_match_jax(case):
    opts = OPTS + ["OUTPUT_DIR", ""] + CASES[case]
    jtrainer, ttrainer = _trainers(opts)
    assert ("_adapter" in ttrainer.state.params) == ("trainable" in case)
    assert set(state_dict(jtrainer.state)["params"]) == set(ttrainer.state.params)
    rng = np.random.default_rng(9)
    if "ema" in case:  # the twin away from the params, so the KL term is not 0
        jtrainer.state = jtrainer.state._replace(ema_params=jax.tree.map(
            lambda v: v + 0.01 * rng.standard_normal(np.shape(v)).astype(np.float32),
            jtrainer.state.ema_params))
    loss_rtol = {"loss": EMA_LOSS_RTOL, "ema_loss": EMA_LOSS_RTOL} if "ema" in case else {}
    jstate, tstate = jtrainer.state, ttrainer.state
    for i, batch in enumerate(list(ttrainer.batcher.epoch(0))[:3]):
        tstate = restore_train_state(tstate, {k: to_port(v) if isinstance(v, dict) else v
                                              for k, v in state_dict(jstate).items()})
        jstate, jaux = jtrainer.train_step(jstate, jnp.asarray(batch["img"]),
                                           jnp.asarray(batch["label"]))
        tstate, taux = ttrainer.train_step(tstate, batch["img"], batch["label"])
        assert set(taux) == set(jaux)
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=loss_rtol.get(k, 1e-5), atol=0,
                                       err_msg=f"step {i} {k}")
        for part, tree_scale in (("params", False), ("ema_params", False),
                                 ("opt_state", True)):
            assert_close({part: getattr(tstate, part)}, {part: getattr(jstate, part)},
                         1e-5, f"step {i} ", tree_scale=tree_scale)


def test_adapter_trainer_learns_and_moves_its_adapter():
    """tests/test_train.py::test_adapter_trainer on the port."""
    cfg = tsetup(opts=["OPTIM.MAX_EPOCH", "1", "DATALOADER.BATCH_SIZE_TRAIN", "16",
                       "OPTIM.LR", "0.05", "OPTIM.WARMUP_EPOCH", "-1", "TRAINER.N_CTX", "4",
                       "OUTPUT_DIR", "", "TRAINER.adapter_trainable", "True"])
    toks, labs = captions()
    tr = TRAINER_REGISTRY.get("Caption_distill_double_adapter")(
        cfg, to_port(jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), TINY))), TINY,
        dataset=TDataset(toks, labs, [], CLASSES), device="cpu")
    assert isinstance(tr, ttr.CaptionDistillAdapterTrainer) and "_adapter" in tr.state.params
    b = next(tr.batcher.epoch(0))
    state, first = tr.state, None
    for i in range(10):
        state, m = tr.train_step(state, b["img"], b["label"])
        if i == 0:
            first = float(m["loss"])
    assert float(m["loss"]) < first
    assert (state.params["_adapter"]["down_kernel"] - tr.adapter["down_kernel"]).abs().max() > 0
    assert set(state.ema_params["_adapter"]) == {"down_kernel", "up_kernel"}


def test_adapter_frozen_variant_keeps_the_adapter_outside_the_state():
    """tests/test_train.py::test_adapter_frozen_variant on the port."""
    cfg = tsetup(opts=["OPTIM.MAX_EPOCH", "1", "DATALOADER.BATCH_SIZE_TRAIN", "16",
                       "TRAINER.N_CTX", "4", "OUTPUT_DIR", ""])
    toks, labs = captions()
    tr = ttr.CaptionDistillAdapterTrainer(
        cfg, to_port(jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), TINY))), TINY,
        dataset=TDataset(toks, labs, [], CLASSES), device="cpu")
    assert "_adapter" not in tr.state.params
    b = next(tr.batcher.epoch(0))
    before = {k: v.clone() for k, v in tr.adapter.items()}
    _, m = tr.train_step(tr.state, b["img"], b["label"])
    assert np.isfinite(float(m["loss"]))
    assert all(torch.equal(before[k], tr.adapter[k]) for k in before)


@pytest.mark.parametrize("trainable", [False, True], ids=["frozen", "trainable"])
def test_probe_validate_scores_through_the_adapter_as_jax(trainable):
    opts = OPTS + ["OUTPUT_DIR", "", "TRAIN.probe_holdout", "4",
                   "TRAINER.adapter_trainable", str(trainable)]
    jtrainer, ttrainer = _trainers(opts)
    ref = jtrainer.validate()
    out = ttrainer.validate()
    assert set(out) == set(ref) and ref
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-4, err_msg=k)
