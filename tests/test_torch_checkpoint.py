"""Checkpoints cross between the packages: the port reads the JAX package's
``model.ckpt-{e}`` files and writes files the JAX package reads, through its
own msgpack codec (leclip_tpu_torch/engine/flax_msgpack.py; the port never
imports msgpack or flax).

* A JAX ``save_checkpoint`` file read by the port: params, EMA twin,
  optimizer state and step bitwise equal (plain SGD and dampened SGD, whose
  state holds a step counter).
* A port-written file: the same bytes flax writes for the same tree, read
  back bitwise by ``flax.serialization.msgpack_restore`` and by the JAX
  package's ``resume_if_exists`` and ``load_prompt_params``.
* A port trainer resumed from a JAX trainer's checkpoint takes the JAX
  trainer's next 2 steps (loss 1e-5 relative, params 1e-5 of max(1, |leaf|):
  fp32 summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port import to_port
from test_torch_train import CLASSES, OPTS, TINY, captions, flat
from leclip_tpu.data.datasets import CaptionDataset as JDataset
from leclip_tpu.engine import checkpoint as jck
from leclip_tpu.engine import train_state as jts
from leclip_tpu.engine import trainer as jtr
from leclip_tpu.engine.config import setup_config as jsetup
from leclip_tpu.models import clip as jclip
from leclip_tpu_torch.data.datasets import CaptionDataset as TDataset
from leclip_tpu_torch.engine import checkpoint as tck
from leclip_tpu_torch.engine import flax_msgpack
from leclip_tpu_torch.engine import train_state as tts
from leclip_tpu_torch.engine import trainer as ttr
from leclip_tpu_torch.engine.config import setup_config as tsetup

torch.set_num_threads(2)

SGD = {"sgd": [], "sgd_dampening": ["OPTIM.SGD_DAMPNING", "0.2"]}


def _jax_state(opts, seed):
    """A JAX TrainState a few updates in (every leaf non-trivial)."""
    opt = jts.build_optimizer(jsetup(opts=opts).OPTIM, 2)
    rng = np.random.default_rng(seed)
    params = {"ctx": rng.standard_normal((4, 64)).astype(np.float32),
              "ctx_double": rng.standard_normal((4, 64)).astype(np.float32),
              "temperature": np.float32(3.0)}
    state = jts.create_train_state(jax.tree.map(jnp.asarray, params), opt)
    for _ in range(3):
        g = {k: jnp.asarray(rng.standard_normal(np.shape(v)), jnp.float32)
             for k, v in params.items()}
        upd, opt_state = opt.update(g, state.opt_state, state.params)
        state = jts.TrainState(state.step + 1, jax.tree.map(lambda a, b: a + b, state.params, upd),
                               jax.tree.map(lambda a: a * 0.5, state.params), opt_state)
    return state


def _assert_bitwise(port_tree, jax_tree):
    a, b = flat(port_tree), flat(jax_tree)
    assert set(a) == set(b), set(a) ^ set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _zeros_like_params(state):
    return {k: torch.zeros(np.shape(v), dtype=torch.float32)
            for k, v in jax.device_get(state.params).items()}


@pytest.mark.parametrize("name", list(SGD))
def test_port_reads_a_jax_checkpoint_bitwise(tmp_path, name):
    state = _jax_state(SGD[name], 1)
    path = jck.save_checkpoint(state, str(tmp_path), "prompt_learner", 4)
    payload = tck.load_checkpoint(path)
    assert payload["step"] == 3 and payload["epoch"] == 4
    template = tts.create_train_state(_zeros_like_params(state),
                                      tts.build_optimizer(tsetup(opts=SGD[name]).OPTIM, 2))
    restored, start = tck.resume_if_exists(template, str(tmp_path), "prompt_learner")
    assert start == 5 and restored.step == 3
    for part in ("params", "ema_params", "opt_state"):
        _assert_bitwise({part: getattr(restored, part)}, {part: getattr(state, part)})
    ema = tck.load_prompt_params(str(tmp_path), "prompt_learner", use_ema=True)
    _assert_bitwise(ema, state.ema_params)


@pytest.mark.parametrize("name", list(SGD))
def test_jax_reads_a_port_checkpoint_bitwise(tmp_path, name):
    jstate = _jax_state(SGD[name], 2)
    state = tts.TrainState(int(jstate.step), to_port(jax.device_get(jstate.params)),
                           to_port(jax.device_get(jstate.ema_params)),
                           to_port(jax.device_get(serialization.to_state_dict(jstate.opt_state))))
    path = tck.save_checkpoint(state, str(tmp_path / "port"), "prompt_learner", 7)
    ref = jck.save_checkpoint(jstate, str(tmp_path / "jax"), "prompt_learner", 7)
    assert open(path, "rb").read() == open(ref, "rb").read()  # the same bytes
    back = serialization.msgpack_restore(open(path, "rb").read())
    assert back["step"] == 3 and back["epoch"] == 7
    template = jts.create_train_state(jax.tree.map(jnp.zeros_like, jstate.params),
                                      jts.build_optimizer(jsetup(opts=SGD[name]).OPTIM, 2))
    restored, start = jck.resume_if_exists(template, str(tmp_path / "port"), "prompt_learner")
    assert start == 8 and int(restored.step) == 3
    for part in ("params", "ema_params", "opt_state"):
        _assert_bitwise({part: getattr(state, part)}, {part: getattr(restored, part)})
    loaded = jck.load_prompt_params(str(tmp_path / "port"), "prompt_learner")
    _assert_bitwise(state.params, loaded)


def test_codec_round_trips_flax_subset():
    tree = {"a": torch.arange(6, dtype=torch.int64).reshape(2, 3), "b": torch.ones(3).bfloat16(),
            "c": {"x": -40000, "y": 2 ** 40, "z": 1.5, "s": "x" * 40, "w": -3},
            "l": [1, -2, 3], "e": torch.zeros(0), "u8": torch.arange(300, dtype=torch.int32)}
    data = flax_msgpack.packb(tree)
    back = flax_msgpack.unpackb(data)
    assert back["c"] == tree["c"] and back["l"] == tree["l"]
    for k in ("a", "b", "e", "u8"):
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k], tree[k])
    ref = serialization.msgpack_restore(data)
    np.testing.assert_array_equal(ref["a"], tree["a"].numpy())
    assert str(ref["b"].dtype) == "bfloat16" and ref["c"]["y"] == 2 ** 40
    for bad in (object(), None, True, 1 + 2j):  # outside flax's checkpoint subset
        with pytest.raises(TypeError):
            flax_msgpack.packb({"bad": bad})


def test_port_trainer_resumed_from_jax_continues_its_trajectory(tmp_path):
    opts = OPTS + ["OPTIM.MAX_EPOCH", "1", "TRAIN.PRINT_FREQ", "100",
                   "OUTPUT_DIR", str(tmp_path)]
    toks, labs = captions()
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(3), TINY))
    jtrainer = jtr.CaptionDistillTrainer(jsetup(opts=opts), jp, TINY,
                                         dataset=JDataset(toks, labs, [], CLASSES))
    jtrainer.train()  # one epoch, then model.ckpt-0
    tcfg = tsetup(opts=opts[:-2] + ["OUTPUT_DIR", "", "RESUME", str(tmp_path)])
    ttrainer = ttr.CaptionDistillTrainer(tcfg, to_port(jp), TINY,
                                         dataset=TDataset(toks, labs, [], CLASSES), device="cpu")
    state, start = tck.resume_if_exists(ttrainer.state, str(tmp_path), "prompt_learner")
    assert start == 1 and state.step == 4
    jstate = jtrainer.state
    _assert_bitwise({"p": state.params}, {"p": jstate.params})
    for i, batch in enumerate(list(ttrainer.batcher.epoch(1))[:2]):
        jstate, jaux = jtrainer.train_step(jstate, jnp.asarray(batch["img"]),
                                           jnp.asarray(batch["label"]))
        state, aux = ttrainer.train_step(state, batch["img"], batch["label"])
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
        a, b = flat(state.params), flat(jstate.params)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=1e-5 * max(1.0, float(np.abs(b[k]).max())),
                                       err_msg=f"step {i} {k}")


def test_codec_packs_numpy_leaves_as_flax_does():
    """numpy leaves (the fine-tuner's checkpoints pass its tree through
    ``to_jax_params``): a 0-d array keeps shape (), a transposed one is
    written in C order, the same bytes as flax writes."""
    tree = {"s": np.asarray(2.5, np.float32), "n": np.asarray(7, np.int32),
            "t": np.arange(6, dtype=np.float32).reshape(2, 3).T}
    data = flax_msgpack.packb(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = flax_msgpack.unpackb(data)
    assert tuple(back["s"].shape) == () and tuple(back["n"].shape) == ()
    np.testing.assert_array_equal(back["t"].numpy(), tree["t"])
