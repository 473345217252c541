"""The labeled caption benchmark of the port
(leclip_tpu_torch/inference/caption_eval.py) against
leclip_tpu/inference/caption_eval.py, on the CPU with a tiny CLIP and a
six-member ensemble (both packages' members from one JAX init,
tests/_torch_port.py ``tta_ensemble``).

Each function on the same inputs: the windows and masks exactly; the member
scores, block retrieval sims and the whole ``score_caption_benchmark``
(with and without a bank, a ragged last batch) within 1e-4 of max(1,
max|ref|) (fp32 on both sides; the towers, softmaxes and window means
differ by summation order only). The outputs feed the port's
``ops.ensemble.model_result`` / ``route_ensemble`` unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_port, tta_ensemble
from test_torch_train import CLASSES, captions
from leclip_tpu.inference import caption_eval as jce
from leclip_tpu.models import clip as jclip
from leclip_tpu.models import dense_clip as jdc
from leclip_tpu.ops import ensemble as jens
from leclip_tpu_torch.inference import caption_eval as tce
from leclip_tpu_torch.models import dense_clip as tdc
from leclip_tpu_torch.ops import ensemble as tens

torch.set_num_threads(2)

GROUPS = [(["best", "diff"], False, False, 4), (["ema", "zema"], True, False, 4),
          (["zuan", "evidence"], True, True, 6)]


@pytest.fixture(scope="module")
def ensemble():
    return tta_ensemble("fp32", jclip.PRESETS["ViT-TEST"], CLASSES, GROUPS)


def _close(out, ref, tol=1e-4, what=""):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


@pytest.mark.parametrize("n_pos,scales", [(77, (2, 3, 4)), (77, (2,)), (20, (3, 5))])
def test_windows_and_masks_equal_jax(n_pos, scales):
    w = tce.caption_windows(n_pos, scales)
    np.testing.assert_array_equal(w, jce.caption_windows(n_pos, scales))
    np.testing.assert_array_equal(tce.window_masks(w, n_pos), jce.window_masks(w, n_pos))


def _features(jp, tp, toks):
    cfg = jclip.PRESETS["ViT-TEST"]
    jf = jdc.encode_captions(jax.tree.map(jnp.asarray, jp), cfg, jnp.asarray(toks),
                             jdc.DenseFlags())
    tf = tdc.CaptionFeatures(*(to_port(jax.device_get(a)) for a in jf))
    return jf, tf


def test_member_scores_and_block_sims_match_jax(ensemble):
    jp, tp, jspecs, tspecs, bank, _ = ensemble
    toks = captions(12, 4)[0]
    jf, tf = _features(jp, tp, toks)
    wm = jce.window_masks(jce.caption_windows(77, (2, 3, 4)), 77)
    for name in jspecs:
        ref = jce.member_caption_scores(jspecs[name], jf, jnp.asarray(wm))
        out = tce.member_caption_scores(tspecs[name], tf, torch.tensor(wm))
        assert set(out) == set(ref)
        for k in ref:
            _close(out[k], ref[k], what=f"{name} {k}")
    assert out["output_blocks"].shape == (12, 9, len(CLASSES))
    ref = jce.caption_sims_blocks(jf, jnp.asarray(bank), jnp.asarray(wm), topk=5)
    _close(tce.caption_sims_blocks(tf, torch.tensor(bank), torch.tensor(wm), topk=5), ref,
           what="sims_blocks")


@pytest.mark.parametrize("with_bank", [True, False], ids=["bank", "no-bank"])
def test_score_caption_benchmark_matches_jax(ensemble, with_bank):
    jp, tp, jspecs, tspecs, bank, _ = ensemble
    cfg = jclip.PRESETS["ViT-TEST"]
    toks = captions(20, 5)[0]
    jbank, tbank = (jnp.asarray(bank), torch.tensor(bank)) if with_bank else (None, None)
    ref, ref_sims = jce.score_caption_benchmark(jax.tree.map(jnp.asarray, jp), cfg, jspecs,
                                                toks, jbank, batch_size=8, topk=5)
    out, sims = tce.score_caption_benchmark(tp, cfg, tspecs, toks, tbank, batch_size=8, topk=5,
                                            device="cpu")
    assert set(out) == set(ref) == set(jspecs)
    for name in ref:
        assert set(out[name]) == set(ref[name])
        for k in ref[name]:
            assert out[name][k].dtype == np.float32
            _close(out[name][k], ref[name][k], what=f"{name} {k}")
    _close(sims, ref_sims, what="sims_blocks")
    assert sims.shape == (20, 9, 5)
    # the fusion and routing stage runs unchanged on top, as on JAX's outputs
    fused = tens.route_ensemble({m: tens.model_result(out[m], sims) for m in out})
    want = jens.route_ensemble({m: jens.model_result(ref[m], ref_sims) for m in ref})
    _close(fused, want, what="routed")
