"""The port's attention routing (ops/attention.py) against the JAX package's:
the ``auto`` rule as a pure function of (impl, T, head width, mask, device
type), each route of ``attention_from_qkv`` against JAX's with the same impl
(pad keys, causal, both), and the unfused slice as a whole —
``TTAEngine.run_batch_fused`` with ``DenseFlags(attention_impl="resident")``
and ``"pallas"``, port on the CPU against the JAX engine on the CPU (Pallas
in interpret mode).

Tolerances: one attention 2e-5 (the JAX kernel tests' own); the engine 1e-4
(summation order only, as tests/test_torch_tta.py holds the fp32 engine)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import tta_ensemble
from leclip_tpu.data.vocab import COCO_OBJECT_CATEGORIES
from leclip_tpu.inference import tta as jtta
from leclip_tpu.models import clip as jclip
from leclip_tpu.ops import attention as jatt
from leclip_tpu_torch.inference import tta as ttta
from leclip_tpu_torch.ops import attention as tatt
from leclip_tpu_torch.ops import launches

torch.set_num_threads(2)


@pytest.mark.parametrize("impl,t,hd,has_mask,device,route", [
    # the JAX rule on the card: resident for aligned unmasked T >= 128 at dh 64
    ("auto", 200, 64, False, "cuda", "resident"),     # ViT-B/16 image tower
    ("auto", 264, 64, False, "cuda", "resident"),     # ViT-L/14
    ("auto", 128, 64, False, "cuda", "resident"),
    ("auto", 120, 64, False, "cuda", "xla"),          # too short
    ("auto", 204, 64, False, "cuda", "xla"),          # T % 8 != 0
    ("auto", 200, 32, False, "cuda", "xla"),          # head width 32
    ("auto", 77, 64, True, "cuda", "xla"),            # causal text tower
    ("auto", 200, 64, True, "cuda", "xla"),           # any mask
    ("auto", 8192, 64, True, "cuda", "pallas"),       # flash at T >= 8192
    ("auto", 8200, 32, True, "cuda", "pallas"),
    ("auto", 8191, 32, True, "cuda", "xla"),
    # the CPU is always the plain math under auto
    ("auto", 200, 64, False, "cpu", "xla"),
    ("auto", 8192, 64, True, "cpu", "xla"),
    # forced routes are taken as given, on either device
    ("xla", 200, 64, False, "cuda", "xla"),
    ("resident", 77, 32, False, "cpu", "resident"),
    ("pallas", 77, 64, True, "cpu", "pallas"),
])
def test_route_rule(impl, t, hd, has_mask, device, route):
    assert tatt.attention_route(impl, t, hd, has_mask, device) == route


def test_route_rejects_an_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        tatt.attention_route("flash", 200, 64, False, "cuda")


def _params(d, rng):
    return {"qkv_kernel": rng.standard_normal((d, 3 * d)) * d ** -0.5,
            "qkv_bias": 0.02 * rng.standard_normal(3 * d),
            "out_kernel": rng.standard_normal((d, d)) * d ** -0.5,
            "out_bias": 0.02 * rng.standard_normal(d)}


@pytest.mark.parametrize("impl,case", [
    ("xla", "none"), ("xla", "pad"), ("xla", "causal"), ("xla", "causal_pad"),
    ("resident", "pad"), ("resident", "none"),
    ("pallas", "none"), ("pallas", "pad"), ("pallas", "causal"), ("pallas", "causal_pad"),
    ("auto", "pad"), ("auto", "causal"),
])
def test_attention_from_qkv_routes_match_jax(impl, case):
    rng = np.random.default_rng(0)
    b, t, heads, d = 2, 24, 2, 128
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    params = {k: v.astype(np.float32) for k, v in _params(d, rng).items()}
    mask = jatt.causal_mask(t) if case.startswith("causal") else None
    kv_len = 19 if case.endswith("pad") else None
    ref = jatt.multi_head_attention(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, heads,
        mask=None if mask is None else jnp.asarray(mask), impl=impl, kv_len=kv_len)
    before = launches.launch_counts()
    out = tatt.multi_head_attention(
        torch.tensor(x), {k: torch.tensor(v) for k, v in params.items()}, heads,
        mask=None if mask is None else torch.tensor(mask), impl=impl, kv_len=kv_len)
    assert launches.launch_counts() == before
    rows = slice(0, kv_len)  # pad query rows are garbage on both sides
    np.testing.assert_allclose(out.numpy()[:, rows], np.asarray(ref)[:, rows],
                               atol=2e-5, rtol=2e-5)


def test_forced_resident_with_a_mask_raises():
    """The JAX package drops the mask under impl="resident" (a causal text
    pass would silently lose its mask); the port refuses it."""
    rng = np.random.default_rng(1)
    d = 64
    params = {k: torch.tensor(v.astype(np.float32)) for k, v in _params(d, rng).items()}
    x = torch.tensor(rng.standard_normal((2, 16, d)).astype(np.float32))
    with pytest.raises(ValueError, match="resident"):
        tatt.multi_head_attention(x, params, 1, mask=tatt.causal_mask(16), impl="resident")


CFG = jclip.PRESETS["ViT-TEST"]
CLASSES = COCO_OBJECT_CATEGORIES[:8]
GROUPS = ((("best", "difft"), True, True, 16), (("zema", "diff", "diffh"), False, False, 16),
          (("ema",), False, False, 64))


@pytest.mark.parametrize("impl", ["resident", "pallas"])
def test_run_batch_fused_unfused_routes_match_jax(impl):
    """The fp32 engine with every member's ``attention_impl`` forced: the
    image tower (17 tokens padded to 24, kv_len 17) takes the route on both
    sides. Under "pallas" the prompt-feature text pass runs flash attention
    under its causal mask too; the resident kernel takes no mask, so there
    the members' prompt features come from the default route and only the
    engine's flags are forced."""
    build = "auto" if impl == "resident" else impl
    jp, tp, jspecs, tspecs, bank, cooc = tta_ensemble("fp32", CFG, CLASSES, GROUPS,
                                                      attention_impl=build)
    if impl == "resident":
        jspecs = {n: s._replace(flags=s.flags._replace(attention_impl=impl))
                  for n, s in jspecs.items()}
        tspecs = {n: s._replace(flags=s.flags._replace(attention_impl=impl))
                  for n, s in tspecs.items()}
    images = [np.random.default_rng(10 + i).integers(0, 255, (72, 96, 3)).astype(np.uint8)
              for i in range(2)]
    kw = dict(scales=(2,), cooccurrence=cooc, crop_size=CFG.image_resolution)
    ref = jtta.TTAEngine(jp, CFG, jspecs, caption_bank=jnp.asarray(bank),
                         compute_dtype=jnp.float32, **kw).run_batch_fused(images)
    eng = ttta.TTAEngine(tp, CFG, tspecs, caption_bank=torch.tensor(bank),
                         compute_dtype=torch.float32, device="cpu", **kw)
    out = eng.run_batch_fused(images)
    assert out.shape == ref.shape == (2, 8) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
