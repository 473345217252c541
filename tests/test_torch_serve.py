"""The port's scoring service (leclip_tpu_torch/cli/serve.py) against
leclip_tpu's: one counterpart of each test of tests/test_serve.py (a real
ThreadingHTTPServer on an ephemeral port, concurrent urllib clients), the
port's scores against the JAX service's on the same JPEG and weights, the
byte-level decoders against the JAX package's, and ``build_service`` from
reference-format checkpoints with a ``/reload`` under load.

Tolerances: the service against a direct engine call on the same decoded
image 1e-4 (the same engine; only batch padding differs), as
tests/test_serve.py; the port's service against the JAX service 1e-4 (fp32
end to end, summation order only, as tests/test_torch_tta.py)."""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from _torch_port import tta_engines
from leclip_tpu.cli import serve as jserve
from leclip_tpu.models.clip import CLIPConfig
from leclip_tpu.runtime.jpeg import decode_bytes_batch as jdecode
from leclip_tpu_torch.cli.serve import (STAGES, ScoringService, _Request, build_service,
                                        make_handler)
from leclip_tpu_torch.data.loader import declared_pixels, decode_bytes_batch
from leclip_tpu_torch.inference import tta as ttta

torch.set_num_threads(2)

CLASSNAMES = ["dog", "cat", "person", "pizza"]
TINY = CLIPConfig(
    embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1),
    vision_width=8, vision_patch_size=None, transformer_width=64,
    transformer_heads=2, transformer_layers=2,
)


def _jpeg_bytes(rng, h=96, w=128) -> bytes:
    from PIL import Image

    arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _ensembles(names):
    """Both packages' engines over the same weights and prompts."""
    return tta_engines(TINY, CLASSNAMES, ((tuple(names), False, False, 4),))


@pytest.fixture(scope="module")
def engines():
    return _ensembles(["best"])


@pytest.fixture(scope="module")
def service(engines):
    svc = ScoringService(engines[1], CLASSNAMES, batch_size=4, max_wait_ms=30.0)
    yield svc
    svc.close()


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(service):
    srv, url = _serve(make_handler(service, topk=2, max_body_bytes=1 << 20, max_images=4,
                                   max_pixels=1_000_000))
    yield url
    srv.shutdown()
    srv.server_close()


def _post(url, data, ctype, timeout=300):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_healthz_and_classes(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health == {"status": "ok", "models": ["best"], "crops_per_image": 41}
    with urllib.request.urlopen(f"{server}/classes", timeout=30) as r:
        assert json.loads(r.read())["classes"] == CLASSNAMES


def test_score_single_jpeg_matches_engine(server, service, rng):
    blob = _jpeg_bytes(rng)
    out = _post(f"{server}/score", blob, "image/jpeg")
    assert len(out["scores"]) == 1 and len(out["scores"][0]) == len(CLASSNAMES)
    assert len(out["topk"][0]) == 2 and out["topk"][0][0]["label"] in CLASSNAMES
    img = decode_bytes_batch([blob])[0]
    np.testing.assert_allclose(np.asarray(out["scores"]), service.score([img]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out["scores"]), service.engine.run_batch_fused([img]),
                               rtol=1e-4, atol=1e-4)


def test_score_json_batch(server, rng):
    blobs = [_jpeg_bytes(rng) for _ in range(3)]
    payload = json.dumps({"images": [base64.b64encode(b).decode() for b in blobs]}).encode()
    out = _post(f"{server}/score", payload, "application/json")
    assert len(out["scores"]) == 3 and np.isfinite(np.asarray(out["scores"])).all()


def test_microbatching_groups_concurrent_requests(service, rng):
    """Concurrent single-image requests inside the wait window are served in
    fewer dispatches than requests, each caller getting its own row."""
    imgs = [rng.integers(0, 255, (96, 128, 3)).astype(np.uint8) for _ in range(4)]
    singles = [service.score([im]) for im in imgs]
    calls = []
    real = service.engine.dispatch_staged_fused

    def counting(staged):
        calls.append(staged.batch)
        return real(staged)

    service.engine.dispatch_staged_fused = counting
    try:
        results = [None] * 4

        def worker(i):
            results[i] = service.score([imgs[i]])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        del service.engine.dispatch_staged_fused
    assert calls and sum(calls) <= 2 * 4
    assert len(calls) < 4, f"no micro-batching happened: {calls}"
    for i in range(4):
        np.testing.assert_allclose(results[i], singles[i], rtol=1e-5, atol=1e-5)


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/nope", timeout=30)
    assert e.value.code == 404


def test_request_limit_guards(server, service, rng):
    """Body-size (413), empty-batch, image-count and declared-dimension
    guards reject before any decode or dispatch."""
    from PIL import Image

    def code(data, ctype):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{server}/score", data, ctype, timeout=60)
        return e.value.code

    assert code(b"x" * (2 << 20), "image/jpeg") == 413
    assert code(json.dumps({"images": []}).encode(), "application/json") == 400
    blob = base64.b64encode(_jpeg_bytes(rng, 32, 32)).decode()
    assert code(json.dumps({"images": [blob] * 5}).encode(), "application/json") == 400
    buf = io.BytesIO()
    Image.new("RGB", (2000, 2000), (40, 90, 200)).save(buf, format="JPEG")
    assert buf.tell() < 1 << 20 and code(buf.getvalue(), "image/jpeg") == 400
    with pytest.raises(ValueError):
        service.score([])


def test_close_fails_queued_requests():
    class NeverEngine:
        n_blocks = 1
        models = {"m": None}

        def stage_batch_fused(self, images):
            raise AssertionError("should not dispatch")

    svc = ScoringService(NeverEngine(), CLASSNAMES, batch_size=2, max_wait_ms=1.0)
    svc._stop.set()
    svc._worker.join(timeout=10)
    req = _Request([np.zeros((8, 8, 3), np.uint8)])
    svc.queue.put(req)
    svc.close()
    assert req.event.is_set() and req.error == "service closed"


def test_swap_mid_microbatch_does_not_split_versions():
    """A swap racing a multi-chunk micro-batch leaves every chunk on the old
    engine, fetched from the old engine; the next micro-batch sees the new."""
    served, fetched = [], []

    class FakeEngine:
        n_blocks = 1
        models = {"m": None}

        def __init__(self, tag, on_dispatch=None):
            self.tag = tag
            self.on_dispatch = on_dispatch

        def stage_batch_fused(self, images):
            return images

        def dispatch_staged_fused(self, images):
            served.append(self.tag)
            if self.on_dispatch is not None:
                cb, self.on_dispatch = self.on_dispatch, None
                cb()
            return torch.full((len(images), len(CLASSNAMES)), float(self.tag == "new"))

        def _fetch(self, out):
            fetched.append(self.tag)
            return ttta.TTAEngine._fetch(out)

    svc = ScoringService(FakeEngine("old"), CLASSNAMES, batch_size=2, max_wait_ms=1.0)
    new = FakeEngine("new")
    svc.engine.on_dispatch = lambda: svc.swap_engine(new)
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        first = svc.score([img] * 4)
        assert served == ["old", "old"] and fetched == ["old", "old"], (served, fetched)
        np.testing.assert_array_equal(first, 0.0)
        second = svc.score([img])
        assert served[-1] == "new" and fetched[-1] == "new"
        np.testing.assert_array_equal(second, 1.0)
    finally:
        svc.close()


def _parse_prometheus(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def _metrics(url):
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        return _parse_prometheus(r.read().decode())


def test_metrics_endpoint(server, service, rng):
    before = _metrics(server)
    _post(f"{server}/score", _jpeg_bytes(rng), "image/jpeg", timeout=120)
    after = _metrics(server)
    # a request's stages are recorded once its response is written, which
    # its client can see first
    count = 'leclip_request_stage_seconds_count{stage="respond"}'
    deadline = time.monotonic() + 30
    while after[count] == before[count] and time.monotonic() < deadline:
        time.sleep(0.01)
        after = _metrics(server)
    assert after["leclip_requests_total"] == before["leclip_requests_total"] + 1
    assert after["leclip_images_total"] == before["leclip_images_total"] + 1
    d_disp = after["leclip_dispatches_total"] - before["leclip_dispatches_total"]
    d_real = after["leclip_dispatch_images_total"] - before["leclip_dispatch_images_total"]
    d_pad = after["leclip_dispatch_padding_total"] - before["leclip_dispatch_padding_total"]
    assert d_disp >= 1 and d_real >= 1 and d_real + d_pad == 4 * d_disp
    assert after["leclip_crops_scored_total"] == (after["leclip_dispatch_images_total"]
                                                  * (1 + service.engine.n_blocks))
    assert after["leclip_request_latency_seconds_count"] >= 1
    assert after['leclip_request_latency_seconds{quantile="0.5"}'] > 0
    assert after["leclip_uptime_seconds"] > 0
    # the answered request's server-side time by stage: one more of each, all
    # of them together at least its latency inside the service
    sums = {s: after[f'leclip_request_stage_seconds_sum{{stage="{s}"}}']
            - before[f'leclip_request_stage_seconds_sum{{stage="{s}"}}'] for s in STAGES}
    for s in STAGES:
        assert (after[f'leclip_request_stage_seconds_count{{stage="{s}"}}']
                == before[f'leclip_request_stage_seconds_count{{stage="{s}"}}'] + 1)
        assert sums[s] >= 0
    latency = (after["leclip_request_latency_seconds_sum"]
               - before["leclip_request_latency_seconds_sum"])
    assert sum(sums.values()) >= latency - 1e-4


def test_reload_not_configured_is_501(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(f"{server}/reload", data=b""), timeout=30)
    assert e.value.code == 501


def test_reload_endpoint_hot_swaps_engine(engines, rng):
    """POST /reload swaps the engine without a restart: the model list
    changes and later scores come from the new ensemble."""
    _, new_engine = _ensembles(["best", "ema"])
    svc = ScoringService(engines[1], CLASSNAMES, batch_size=2, max_wait_ms=5.0)
    srv, base = _serve(make_handler(svc, topk=2, reload_fn=lambda: new_engine))
    try:
        blob = _jpeg_bytes(rng)
        before = _post(f"{base}/score", blob, "image/jpeg")
        assert _post(f"{base}/reload", b"", "application/json") == {
            "reloaded": True, "models": ["best", "ema"]}
        after = _post(f"{base}/score", blob, "image/jpeg")
        img = decode_bytes_batch([blob])[0]
        np.testing.assert_allclose(np.asarray(after["scores"]), new_engine.run_batch_fused([img]),
                                   rtol=1e-4, atol=1e-4)
        assert not np.allclose(np.asarray(after["scores"]), np.asarray(before["scores"]),
                               atol=1e-3)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_service_matches_jax_service(engines, rng):
    """The same JPEG through both packages' services, on the same weights."""
    jeng, teng = engines
    jsvc = jserve.ScoringService(jeng, CLASSNAMES, batch_size=4, max_wait_ms=1.0)
    tsvc = ScoringService(teng, CLASSNAMES, batch_size=4, max_wait_ms=1.0)
    jsrv, jurl = _serve(jserve.make_handler(jsvc, topk=3))
    tsrv, turl = _serve(make_handler(tsvc, topk=3))
    try:
        blob = _jpeg_bytes(rng, 120, 90)
        want = _post(f"{jurl}/score", blob, "image/jpeg")
        got = _post(f"{turl}/score", blob, "image/jpeg")
        np.testing.assert_allclose(np.asarray(got["scores"]), np.asarray(want["scores"]),
                                   rtol=1e-4, atol=1e-4)
        assert [t["label"] for t in got["topk"][0]] == [t["label"] for t in want["topk"][0]]
        # the port's /metrics adds the server-side time by stage
        stage_keys = {f'leclip_request_stage_seconds_{k}{{stage="{s}"}}'
                      for k in ("sum", "count") for s in STAGES}
        assert _metrics(turl).keys() == _metrics(jurl).keys() | stage_keys
    finally:
        for srv, svc in ((jsrv, jsvc), (tsrv, tsvc)):
            srv.shutdown()
            srv.server_close()
            svc.close()


def test_decoders_match_jax(rng):
    from PIL import Image

    blobs = [_jpeg_bytes(rng, h, w) for h, w in ((96, 128), (33, 17), (480, 640))]
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (20, 30, 3)).astype(np.uint8)).save(buf, format="PNG")
    gray = io.BytesIO()
    Image.new("L", (40, 24), 90).save(gray, format="JPEG")
    blobs += [buf.getvalue(), gray.getvalue()]
    got, want = decode_bytes_batch(blobs), jdecode(blobs)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape and g.shape[-1] == 3
        np.testing.assert_array_equal(g, w)
    assert [declared_pixels(b) for b in blobs] == [jserve._declared_pixels(b) for b in blobs]


def test_build_service_reloads_under_load(tmp_path, rng):
    """build_service from reference-format checkpoints on the CPU; a /reload
    (engine_factory re-reading the model dir) while requests are in flight:
    every request succeeds, and /metrics counts them all."""
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.models.clip import init_clip_params

    gen = np.random.default_rng(1)
    for name in ("best", "ema"):
        sd = {f"prompt_learner.{k}": torch.tensor(0.02 * gen.standard_normal((4, 64)),
                                                  dtype=torch.float32)
              for k in ("ctx", "ctx_double", "ctx_evidence")}
        sd.update({f"prompt_learner.{k}": torch.tensor(v) for k, v in
                   (("temperature", 3.0), ("spatial_T", 3.0), ("ranking_scale", 4.0))})
        (tmp_path / name).mkdir()
        torch.save({"state_dict": sd, "epoch": 1}, tmp_path / name / "model.pth.tar")
    cfg = setup_config(opts=["TEST.multi_scale", "(2,)", "TEST.PREC", "fp32",
                             "TRAINER.N_CTX", "4"], eval_only=True)
    params = init_clip_params(torch.Generator().manual_seed(0), TINY, device="cpu")
    svc = build_service(cfg, params, TINY, str(tmp_path), classnames=CLASSNAMES, batch_size=4,
                        device="cpu")
    assert list(svc.engine.models) == ["best", "ema"] and svc.engine.device.type == "cpu"
    srv, url = _serve(make_handler(svc, topk=2, reload_fn=svc.engine_factory))
    blobs = [_jpeg_bytes(rng) for _ in range(4)]
    errors, codes = [], []

    def client(i):
        try:
            for j in range(3):
                _post(f"{url}/score", blobs[(i + j) % 4], "image/jpeg")
        except Exception as e:  # noqa: BLE001 — collected and asserted below
            errors.append(e)

    try:
        old = svc.engine
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        codes.append(_post(f"{url}/reload", b"", "application/json"))
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        assert codes == [{"reloaded": True, "models": ["best", "ema"]}] and svc.engine is not old
        m = _metrics(url)
        assert m["leclip_requests_total"] == 12 and m["leclip_request_errors_total"] == 0
        img = decode_bytes_batch(blobs[:1])
        np.testing.assert_allclose(_post(f"{url}/score", blobs[0], "image/jpeg")["scores"],
                                   old.run_batch_fused(img), rtol=1e-4, atol=1e-4)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
