"""The port's W8A8 path as a whole against leclip_tpu's, on the CPU with the
same weights: ``run_transformer(q8=)``, ``encode_text(q8=)`` (with the JAX
suite's causality check), the int8 caption bank and the int8 ``TTAEngine``.
The JAX side runs its Pallas kernels in interpret mode.

Tolerances (``_close_but_flips``): integer sums are exact on both sides, so
the two differ by fp32 summation order and one-ulp differences in exp /
sigmoid — 2e-4 through a few layers (measured below 3e-5) — except where
such a difference tips a value across a .5 boundary in a later layer's
quantizer: that token's int8 code flips and its row moves by about one
quantization step (measured: up to 5 rows of 64, max 5e-3 of the largest
activation). So: all rows within 2e-4 but at most a tenth of them, and
nowhere beyond 2e-2 of max(1, max|ref|). The int8 engine's
fused scores: 2e-3 with correlation > 0.9999 (bf16-free fp32 compute,
amplified by the gated block fusion), far inside the JAX suite's own
int8-vs-bf16 bound (corr > 0.99)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import block_stack, to_port
from leclip_tpu.data.tokenizer import tokenize
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.inference import pipeline as jpipe
from leclip_tpu.inference import tta as jtta
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import dense_clip as jdc
from leclip_tpu.models import prompt as jprompt
from leclip_tpu.models import text as jtext
from leclip_tpu.models import transformer as jtf
from leclip_tpu.ops import quant as jq
from leclip_tpu_torch.engine.config import setup_config
from leclip_tpu_torch.inference import pipeline as tpipe
from leclip_tpu_torch.inference import tta as ttta
from leclip_tpu_torch.models import clip as tclip
from leclip_tpu_torch.models import dense_clip as tdc
from leclip_tpu_torch.models import prompt as tprompt
from leclip_tpu_torch.models import text as ttext
from leclip_tpu_torch.models import transformer as ttf
from leclip_tpu_torch.models.convert import from_jax_q8
from leclip_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

CFG = jclip.PRESETS["ViT-TEST"]
TEXT_CFG = jclip.CLIPConfig(embed_dim=32, image_resolution=64, vision_layers=2, vision_width=64,
                            vision_patch_size=16, transformer_width=64, transformer_heads=2,
                            transformer_layers=3)
CAPTIONS = ["a dog and a cat", "pizza on a dining table", "a person on a bench", "two giraffes"]


def _close_but_flips(out, ref, tol=2e-4, rows=0.1, cap=2e-2):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    diff = np.abs(out - ref).reshape(-1, out.shape[-1])
    over = diff > tol + tol * np.abs(ref).reshape(diff.shape)
    worst = diff.max() / max(1.0, np.abs(ref).max())
    assert over.any(-1).mean() <= rows and worst <= cap, (over.any(-1).mean(), worst)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("outlier", [None, 10.0, 50.0])
def test_run_transformer_q8_matches_jax(outlier):
    """Three quantized layers, each side quantizing the same blocks itself;
    and the port's int8 stack tracks its own unquantized stack exactly as far
    as the JAX one tracks its own (per-token cosine, as tests/test_quant.py
    measures it)."""
    blocks = block_stack(64, 3, 30, "fp32", outlier)
    x = np.random.default_rng(31).standard_normal((4, 16, 64)).astype(np.float32)
    jb = jax.tree.map(jnp.asarray, blocks)
    ref = np.asarray(jtf.run_transformer(jnp.asarray(x), jb, 2, kv_len=13,
                                         q8=jq.quantize_block_stack(jb)))
    tb = to_port(blocks)
    out = ttf.run_transformer(torch.tensor(x), tb, 2, kv_len=13,
                              q8=tq.quantize_block_stack(tb)).numpy()
    _close_but_flips(out, ref)
    plain = ttf.run_transformer(torch.tensor(x), tb, 2, kv_len=13).numpy()
    jplain = np.asarray(jtf.run_transformer(jnp.asarray(x), jb, 2, kv_len=13))
    cos, jcos = _cos(out, plain)[:, :13], _cos(ref, jplain)[:, :13]
    np.testing.assert_allclose(cos, jcos, atol=2e-3)
    if outlier is None:  # with outliers the floor is the fixture's, the same on both sides
        assert cos.min() > 0.99


def test_encode_text_q8_matches_jax_and_is_causal():
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(40), TEXT_CFG))["text"]
    jq8 = jax.device_get(jq.quantize_block_stack(jax.tree.map(jnp.asarray, jp["blocks"])))
    tp, tq8 = to_port(jp), from_jax_q8(jq8)
    toks = np.asarray(tokenize(CAPTIONS))
    ref = np.asarray(jtext.encode_text(jp, jnp.asarray(toks), 2, q8=jq8), np.float32)
    out = ttext.encode_text(tp, torch.tensor(toks), 2, q8=tq8).numpy()
    _close_but_flips(out, ref)
    seq = ttext.encode_text(tp, torch.tensor(toks), 2, sequence=True, q8=tq8)
    jseq = jtext.encode_text(jp, jnp.asarray(toks), 2, sequence=True, q8=jq8)
    _close_but_flips(seq.numpy(), jseq)
    # the int8 tower tracks the unquantized one
    assert (_cos(out, ttext.encode_text(tp, torch.tensor(toks), 2).numpy()) > 0.995).all()
    # causality: flip the LAST pad position's token id (beyond every EOT);
    # argmax(EOT id) is unchanged and the features must be identical
    toks2 = toks.copy()
    toks2[:, -1] = 7
    out2 = ttext.encode_text(tp, torch.tensor(toks2), 2, q8=tq8).numpy()
    np.testing.assert_allclose(out, out2, atol=1e-6)


def test_caption_bank_int8_matches_jax():
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(41), TEXT_CFG))
    toks = np.asarray(tokenize(["a dog", "a cat", "a pizza"] * 3))
    ref = jpipe.build_caption_bank(jp, TEXT_CFG, toks, batch_size=4, precision="int8")
    out = tpipe.build_caption_bank(to_port(jp), TEXT_CFG, toks, batch_size=4, precision="int8",
                                   device="cpu")
    assert out.shape == ref.shape == (9, 32) and out.dtype == np.float32
    _close_but_flips(out, ref, tol=1e-4, cap=2e-3)
    plain = tpipe.build_caption_bank(to_port(jp), TEXT_CFG, toks, batch_size=4, device="cpu")
    assert ((plain * out).sum(-1) > 0.995).all()  # rows are L2-normalised


def test_caption_bank_int8_warns_above_512_wide_text():
    cfg = jclip.CLIPConfig(embed_dim=16, image_resolution=64, vision_layers=1, vision_width=64,
                           vision_patch_size=16, transformer_width=576, transformer_heads=9,
                           transformer_layers=1, vocab_size=64, context_length=8)
    tcfg = tclip.CLIPConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    params = tclip.init_clip_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    toks = np.zeros((2, 8), np.int32)
    toks[:, 3] = 63
    with pytest.warns(UserWarning, match="prefer precision='bf16'"):
        bank = tpipe.build_caption_bank(params, tcfg, toks, batch_size=2, precision="int8",
                                        device="cpu")
    assert bank.shape == (2, 16) and np.isfinite(bank).all()


def _engines(jdt, tdt, **kw):
    """Both sides' one-member engines from one JAX pytree."""
    jp = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(0), CFG))
    tp = to_port(jp)
    classes = COCO_OBJECT_CATEGORIES[:8]
    jtr, jcs = jprompt.build_prompt_learner(jax.random.PRNGKey(1), jp, classes, n_ctx=4)
    jtr = jax.device_get(jtr)
    _, tcs = tprompt.build_prompt_learner(torch.Generator().manual_seed(1), tp, classes, n_ctx=4)
    jspec = jtta.build_model_spec(jp, CFG, jtr, jcs, jdc.DenseFlags())
    tspec = ttta.build_model_spec(tp, CFG, to_port(jtr), tcs, tdc.DenseFlags())
    common = dict(scales=(2,), crop_size=CFG.image_resolution)
    jeng = jtta.TTAEngine(jp, CFG, {"best": jspec}, compute_dtype=jdt, **common, **kw)
    teng = ttta.TTAEngine(tp, CFG, {"best": tspec}, compute_dtype=tdt, device="cpu",
                          **common, **kw)
    return jeng, teng


def _images():
    return [np.random.default_rng(i).integers(0, 255, (96, 128, 3)).astype(np.uint8)
            for i in range(2)]


def test_tta_engine_int8_matches_jax_engine():
    jeng, teng = _engines(jnp.float32, torch.float32, precision="int8")
    assert teng.precision == "int8" and teng._q8 is not None and not teng._fused
    ref = jeng.run_batch_fused(_images())
    out = teng.run_batch_fused(_images())
    assert out.shape == ref.shape == (2, 8) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=2e-3)
    assert np.corrcoef(ref.ravel(), out.ravel())[0, 1] > 0.9999
    # and, as the JAX suite holds its own engine, int8 tracks bf16 precision
    _, tbf = _engines(jnp.float32, torch.float32)
    assert np.corrcoef(tbf.run_batch_fused(_images()).ravel(), out.ravel())[0, 1] > 0.99


def test_int8_engine_quantizes_once_and_turns_the_bf16_kernels_off():
    _, teng = _engines(jnp.bfloat16, torch.bfloat16, precision="int8", bf16_fused=True)
    assert not teng._fused
    q8 = teng._q8
    assert set(q8) == {"ln1", "ln2", "attn", "mlp"} and q8["mlp"]["proj"][0].dtype == torch.int8
    teng.run_batch_fused(_images()[:1])
    assert teng._q8 is q8


def test_int8_rejects_resnet():
    with pytest.raises(ValueError, match="ViT"):
        ttta.TTAEngine({}, tclip.PRESETS["RN-TEST"], {}, precision="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        ttta.TTAEngine({}, tclip.PRESETS["ViT-TEST"], {}, precision="fp8", device="cpu")


@pytest.mark.parametrize("prec,want", [("auto", "bf16"), ("int8", "bf16"), ("bf16", "bf16"),
                                       ("fp32", "bf16")])
def test_make_engine_passes_the_resolved_precision(prec, want):
    """On the CPU every TEST.PREC resolves to the bf16 engine (int8 with a
    warning): make_engine hands the resolved precision on, not a constant.
    The int8 branch of the same line is driven on the card by chip_smoke.py."""
    import warnings

    params = tclip.init_clip_params(torch.Generator().manual_seed(0), tclip.PRESETS["ViT-TEST"],
                                    device="cpu")
    cfg = setup_config(opts=["TEST.PREC", prec, "TEST.multi_scale", "(2,)"])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = tpipe.make_engine(cfg, params, tclip.PRESETS["ViT-TEST"], {}, device="cpu")
    assert eng.precision == want and eng._q8 is None
    assert eng.compute_dtype == (torch.float32 if prec == "fp32" else torch.bfloat16)
    assert len(w) == (1 if prec == "int8" else 0)
