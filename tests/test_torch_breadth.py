"""The rest of the JAX package's host-side breadth in the port, each against
leclip_tpu's: the GCN head (models/gcn.py, 1e-5: fp32 products in another
order), the synthetic image renderer (data/synth_images.py), the outlier
stress of the int8 gates (ops/quant_stress.py), the offline caption
factory and its CLI (data/gen_captions.py, cli/gen_captions.py, with a
scripted chat) and the checkpoint zoo on a local file (models/zoo.py): all
of these exactly equal."""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import openai_vit_state_dict, to_port
from leclip_tpu.cli import gen_captions as jcli
from leclip_tpu.data import gen_captions as JG
from leclip_tpu.data import synth_images as jsynth
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import gcn as jgcn
from leclip_tpu.models import zoo as jzoo
from leclip_tpu.models.transformer import init_block_stack
from leclip_tpu.ops import quant_stress as jqs
from leclip_tpu_torch.cli import gen_captions as tcli
from leclip_tpu_torch.data import gen_captions as TG
from leclip_tpu_torch.data import synth_images as tsynth
from leclip_tpu_torch.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu_torch.models import gcn as tgcn
from leclip_tpu_torch.models import zoo as tzoo
from leclip_tpu_torch.models.convert import to_jax_params
from leclip_tpu_torch.ops import quant_stress as tqs

torch.set_num_threads(2)


def _same_tree(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ----------------------------------- GCN ------------------------------------


@pytest.mark.parametrize("layers,bias,init_prob", [(1, False, False), (2, True, False),
                                                   (2, False, True)])
def test_gcn_forward_matches_jax(layers, bias, init_prob):
    rng = np.random.default_rng(layers)
    n_cls, dim = 6, 16
    prob = rng.random((n_cls, n_cls)).astype(np.float32)
    jp = jax.device_get(jgcn.init_gcn_params(jax.random.PRNGKey(0), n_cls, dim, layers,
                                             count_prob=prob, init_prob=init_prob, bias=bias))
    tp = to_port(jp)
    x = rng.standard_normal((3, n_cls, dim)).astype(np.float32)
    want = jgcn.gcn_forward(jp, jnp.asarray(x))
    got = tgcn.gcn_forward(tp, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    adj = np.asarray(jgcn.gen_adj(jnp.asarray(prob)))
    np.testing.assert_allclose(tgcn.gen_adj(torch.tensor(prob)).numpy(), adj, rtol=1e-6)
    want = jgcn.gcn_forward(jp, jnp.asarray(x), adj=jnp.asarray(adj))
    got = tgcn.gcn_forward(tp, torch.tensor(x), adj=torch.tensor(adj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gcn_init_follows_the_jax_tree():
    prob = np.random.default_rng(0).random((5, 5)).astype(np.float32)
    jp = jax.device_get(jgcn.init_gcn_params(jax.random.PRNGKey(0), 5, 8, 2, count_prob=prob,
                                             init_prob=True, bias=True))
    tp = tgcn.init_gcn_params(torch.Generator().manual_seed(0), 5, 8, 2, count_prob=prob,
                              init_prob=True, bias=True)
    back = to_jax_params(tp)
    for a, b in zip(back["layers"], jp["layers"]):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["A"], b["A"])   # the near-identity prior
        assert a["weight"].shape == b["weight"].shape and np.abs(a["weight"]).max() <= 8 ** -0.5
    np.testing.assert_array_equal(back["adj"], jp["adj"])  # the thresholded seed
    with pytest.raises(ValueError):
        tgcn.init_gcn_params(torch.Generator(), 5, 8, 3)


# ------------------------------ synthetic images ----------------------------


def test_synth_images_equal_jax():
    names = COCO_OBJECT_CATEGORIES
    want = jsynth.make_labeled_images(6, names, seed=3, sizes=((48, 64), (40, 40)))
    got = tsynth.make_labeled_images(6, names, seed=3, sizes=((48, 64), (40, 40)))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    for c in (0, 17, 79):
        assert tsynth.class_attributes(c) == jsynth.class_attributes(c)
        for a, b in zip(tsynth.render_glyph(c, 12), jsynth.render_glyph(c, 12)):
            np.testing.assert_array_equal(a, b)


# -------------------------------- quant stress ------------------------------


def test_quant_stress_equals_jax():
    np.testing.assert_array_equal(tqs.fitted_channel_scales(3, 64),
                                  jqs.fitted_channel_scales(3, 64))
    blocks = jax.device_get(init_block_stack(jax.random.PRNGKey(0), 2, 64))
    m = jqs.fitted_channel_scales(2, 64)
    _same_tree(to_jax_params(tqs.apply_outlier_profile(to_port(blocks), m)),
               jax.device_get(jqs.apply_outlier_profile(blocks, m)))
    for heavy in (False, True):
        _same_tree(to_jax_params(tqs.inject_outliers(to_port(blocks), 40.0, heavy_tail=heavy)),
                   jax.device_get(jqs.inject_outliers(blocks, 40.0, heavy_tail=heavy)))


# ------------------------------ caption factory -----------------------------


def fake_chat(prompt: str) -> str:
    if "randomly select" in prompt:
        return "dog, cat, person, teapot"
    if "MUST contain" in prompt:
        cat = prompt.split("MUST contain a ")[1].split(".")[0]
        return f"1. A {cat} in a field. 2. Someone holding a {cat}. 3. 一个{cat}"
    if "Answer True or False" in prompt or "Provided caption" in prompt:
        return "True" if "dog" in prompt else "False"
    return ("1. A dog chasing a cat while a person watches. 2. Short. "
            "3. A knife and a spoon on a table at 11:59. 4. A bus.")


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.is_file()}


def test_gen_captions_equal_jax(tmp_path):
    jd, td = tmp_path / "j", tmp_path / "t"
    jd.mkdir()
    td.mkdir()
    comp = JG.generate_compositions(fake_chat, 4, seed=2, out_path=str(jd / "comp.json"))
    assert TG.generate_compositions(fake_chat, 4, seed=2, out_path=str(td / "comp.json")) == comp
    combos = TG.combos_from_compositions(comp)
    assert combos == JG.combos_from_compositions(comp)
    assert (TG.generate_caption_texts(fake_chat, combos, loops=2, save_root=str(td / "raw"))
            == JG.generate_caption_texts(fake_chat, combos, loops=2, save_root=str(jd / "raw")))
    assert _files(td / "raw") == _files(jd / "raw")
    raw = TG.read_raw_caption_texts(str(td / "raw"))
    assert raw == JG.read_raw_caption_texts(str(jd / "raw"))
    for judge in (None, fake_chat):
        assert (TG.filter_captions(raw, judge=judge, out_path=str(td / "f.json"))
                == JG.filter_captions(raw, judge=judge, out_path=str(jd / "f.json")))
    dumps = tmp_path / "dumps"
    dumps.mkdir()
    with open(dumps / "dump.json", "w") as f:
        json.dump({"0": ["1. A dog at 11:59. 2. A cat.", "一只狗 1. 一只猫"]}, f)
    (dumps / "raw.txt").write_bytes(next((td / "raw").iterdir()).read_bytes())
    assert TG.simple_filter_captions(str(dumps)) == JG.simple_filter_captions(str(dumps))
    for s in ("1. A dog. 2. A cat. 3. A bus.", "no marker", "1. at 11:59. 2. x"):
        assert TG.split_numbered_sentences(s) == JG.split_numbered_sentences(s)
        for colon in (False, True):
            assert (TG.reference_sentence_split(s, colon)
                    == JG.reference_sentence_split(s, colon))
    names = COCO_OBJECT_CATEGORIES[:3]
    assert (TG.generate_single_label_corpus(fake_chat, names, out_dir=str(td))
            == JG.generate_single_label_corpus(fake_chat, names, out_dir=str(jd)))
    assert (TG.generate_challenge_corpus(fake_chat, combos, ["dog", "cat"], str(td / "c.jsonl"))
            == JG.generate_challenge_corpus(fake_chat, combos, ["dog", "cat"],
                                            str(jd / "c.jsonl")))
    assert _files(td) == _files(jd)


def test_llm_backends_raise_without_importing(tmp_path):
    for call in (lambda: TG.chatglm_chat(), lambda: TG.hf_causal_chat(None, None)):
        with pytest.raises(RuntimeError, match="transformers"):
            call()
    with pytest.raises(RuntimeError, match="transformers"):
        tcli.main(["compositions", "--n", "1", "--out", str(tmp_path / "c.json")])


def test_gen_captions_cli_equals_jax(tmp_path, capsys):
    """The filter subcommand on files alone, and the chat subcommands with
    the chat passed in, write what the JAX CLI writes."""
    raw = tmp_path / "raw"
    JG.generate_caption_texts(fake_chat, [("cat", "dog")], loops=2, save_root=str(raw))
    jcli.main(["filter", "--captions", str(raw), "--out", str(tmp_path / "j.json")])
    tcli.main(["filter", "--captions", str(raw), "--out", str(tmp_path / "t.json")])
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    tcli.main(["compositions", "--n", "3", "--out", str(tmp_path / "comp.json")],
              chat=fake_chat)
    tcli.main(["challenge", "--compositions", str(tmp_path / "comp.json"), "--out",
               str(tmp_path / "ch.jsonl")], chat=fake_chat)
    want = JG.generate_challenge_corpus(
        fake_chat, JG.combos_from_compositions(json.load(open(tmp_path / "comp.json"))),
        JG.CHALLENGE_GEN_CLASSES)
    assert [json.loads(line) for line in open(tmp_path / "ch.jsonl")] == want
    assert "challenge lines" in capsys.readouterr().out


# ----------------------------------- zoo ------------------------------------


def test_zoo_loads_a_local_file_as_jax_does(tmp_path):
    params = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(6),
                                                   jclip.PRESETS["ViT-TEST"]))
    sd = openai_vit_state_dict(params, patch=16)
    path = tmp_path / "vit_test.pt"
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    jcfg, jparams = jzoo.load(str(path))
    tcfg, tparams = tzoo.load(str(path))
    assert tcfg.__dict__ == jcfg.__dict__
    _same_tree(to_jax_params(tparams), jax.device_get(jparams))
    assert tzoo.MODEL_URLS == jzoo.MODEL_URLS and tzoo.available_models == jzoo.available_models


def test_zoo_names_the_missing_cache_file_and_checks_sha256(tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "RN50.pt")):
        tzoo.load("RN50", cache_root=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="neither a file"):
        tzoo.load("RN51", cache_root=str(tmp_path))
    (tmp_path / "RN50.pt").write_bytes(b"not a checkpoint")
    assert hashlib.sha256(b"not a checkpoint").hexdigest() != tzoo.expected_sha256("RN50")
    with pytest.raises(RuntimeError, match="sha256"):
        tzoo.load("RN50", cache_root=str(tmp_path))
