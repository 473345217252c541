"""The port's instrumentation (leclip_tpu_torch/utils/tracing.py) on the CPU:
off it records nothing and makes no CUDA event; on, the engine's scores, a
train step and the scoring service's answers are bit for bit what they are
off; a span lies on torch.profiler's clock; a request's six server-side
stages partition its server time; the step's spans follow its ``mark``
calls; spans are on while a torch.profiler window is open, and kept for
:func:`tracing.profiled`. And the benchmark's four readers of these spans
(benchmark/metrics/, through benchmark/program_spans.py) against values
worked by hand on made-up spans, and None without them."""

import copy
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from benchmark import harness
from leclip_tpu_torch.cli.serve import STAGES, ScoringService, make_handler
from leclip_tpu_torch.engine.config import default_config
from leclip_tpu_torch.engine.train_state import build_optimizer, create_train_state
from leclip_tpu_torch.engine.trainer import STEP_PARTS, make_train_step
from leclip_tpu_torch.inference.pipeline import make_engine
from leclip_tpu_torch.inference.tta import build_model_spec
from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
from leclip_tpu_torch.models.dense_clip import DenseFlags
from leclip_tpu_torch.models.prompt import build_prompt_learner
from leclip_tpu_torch.utils import tracing

torch.set_num_threads(2)

CLASSES = ["dog", "cat", "person", "pizza", "car"]


def tiny_engine(preset: str):
    cfg = PRESETS[preset]
    params = init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    trainable, constants = build_prompt_learner(torch.Generator().manual_seed(1), params,
                                                CLASSES, n_ctx=4)
    conf = default_config()
    conf.TEST.PREC = "fp32"
    conf.TEST.multi_scale = (2,)
    spec = build_model_spec(params, cfg, trainable, constants, DenseFlags())
    bank = torch.nn.functional.normalize(
        torch.randn(64, cfg.embed_dim, generator=torch.Generator().manual_seed(2)), dim=-1)
    return make_engine(conf, params, cfg, {"best": spec}, caption_bank=bank, device="cpu",
                       mesh=None)


@pytest.fixture(scope="module")
def rn_engine():
    return tiny_engine("RN-TEST")


def images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (96 + 16 * (i % 2), 128, 3)).astype(np.uint8)
            for i in range(n)]


def jpeg(img) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


# ----------------------------------- off / on ---------------------------------------


class FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 2.0


def test_span_off_records_nothing_and_makes_no_cuda_event(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    FakeEvent.made = 0
    assert not tracing.enabled()
    off = tracing.span("test.off", device=True, request=1)
    assert off is tracing.span("test.other")  # one shared no-op
    with off:
        pass
    tracing.add_spans([("test.added", 0, 1, {})])
    assert FakeEvent.made == 0
    # on, the same span makes its pair of events, read when the recording closes
    with tracing.record() as rec:
        assert tracing.enabled()
        with tracing.span("test.on", device=True, request=1):
            pass
    assert not tracing.enabled()
    assert FakeEvent.made == 2
    (s,) = rec.spans
    assert (s.name, s.attrs, s.device_s) == ("test.on", {"request": 1}, 0.002)
    assert s.thread == threading.current_thread().name and s.end_ns >= s.start_ns
    with tracing.span("test.after", device=True):
        pass
    assert len(rec.spans) == 1 and FakeEvent.made == 2


def test_tracing_on_leaves_engine_scores_bit_identical(rn_engine):
    batch = images(3)
    off = rn_engine.run_batch_fused(batch)
    with tracing.record() as rec:
        on = rn_engine.run_batch_fused(batch)
    np.testing.assert_array_equal(on, off)
    names = [s.name for s in rec.spans]
    for name in ("score.stage", "score.dispatch", "score.resize", "score.image_tower",
                 "score.trunk", "score.retrieval", "score.score_fuse", "score.fetch"):
        assert names.count(name) == 1, (name, names)
    by = {s.name: s for s in rec.spans}

    def within(inner, outer):
        return by[outer].start_ns <= by[inner].start_ns <= by[inner].end_ns <= by[outer].end_ns

    assert within("score.trunk", "score.image_tower")
    for name in ("score.resize", "score.image_tower", "score.retrieval", "score.score_fuse"):
        assert within(name, "score.dispatch")
    assert by["score.stage"].end_ns <= by["score.dispatch"].start_ns
    assert by["score.dispatch"].end_ns <= by["score.fetch"].start_ns


def test_tracing_on_leaves_vit_scores_bit_identical():
    engine = tiny_engine("ViT-TEST")
    batch = images(2, seed=3)
    off = engine.run_batch_fused(batch)
    with tracing.record() as rec:
        on = engine.run_batch_fused(batch)
    np.testing.assert_array_equal(on, off)
    assert [s.name for s in rec.spans].count("score.blocks") == 1


def tiny_step():
    cfg = PRESETS["RN-TEST"]
    params = init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    trainable, constants = build_prompt_learner(torch.Generator().manual_seed(1), params,
                                                CLASSES, n_ctx=4)
    conf = default_config()
    optimizer = build_optimizer(conf.OPTIM, 4)
    state = create_train_state(trainable, optimizer)
    # the EMA twin away from the params, so the KL term is not nought
    state = state._replace(ema_params={k: v + 0.01 for k, v in state.ema_params.items()})
    step = make_train_step(params, cfg, constants, optimizer, DenseFlags(), ema=True)
    rng = np.random.default_rng(4)
    tokens = np.zeros((8, cfg.context_length), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:6] = rng.integers(1, 49406, (8, 5))
    tokens[:, 6] = 49407
    labels = (rng.random((8, len(CLASSES))) < 0.4).astype(np.float32)
    labels[:, 0] = 1.0
    return step, state, tokens, labels


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def test_tracing_on_leaves_train_step_bit_identical():
    step, state, tokens, labels = tiny_step()
    off_state, off_metrics = step(copy.deepcopy(state), tokens, labels)
    with tracing.record():
        on_state, on_metrics = step(copy.deepcopy(state), tokens, labels)
    assert float(on_metrics["loss"]) == float(off_metrics["loss"])
    for part in ("params", "ema_params", "opt_state"):
        got, want = flat(getattr(on_state, part)), flat(getattr(off_state, part))
        assert got.keys() == want.keys() and got
        for k in want:
            assert torch.equal(got[k], want[k]), (part, k)


def test_train_step_spans_follow_mark():
    step, state, tokens, labels = tiny_step()
    off_marks = []
    step(copy.deepcopy(state), tokens, labels, lambda name: off_marks.append(name))
    assert off_marks == list(STEP_PARTS)
    marks = []
    with tracing.record() as rec:
        step(state, tokens, labels, lambda name: marks.append((name, tracing.clock_ns())))
    assert [m for m, _ in marks] == list(STEP_PARTS)
    spans = sorted((s for s in rec.spans if s.name.startswith("train.")),
                   key=lambda s: s.start_ns)
    want = ["train.upload"] + ["train." + p.replace(" ", "_") for p in STEP_PARTS]
    assert [s.name for s in spans] == want
    # each part's span ends before its mark, and the next begins after it
    for i, (_, t) in enumerate(marks):
        assert spans[i + 1].end_ns <= t
        if i + 2 < len(spans):
            assert t <= spans[i + 2].start_ns


def test_span_lies_on_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, tracing.record() as rec:
        with tracing.span("test.clock"):
            torch.ones(64).sum()
            time.sleep(0.02)
    (s,) = rec.named("test.clock")
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "test.clock"]
    assert abs(e.start_ns() - s.start_ns) < 1_000_000
    assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1_000_000
    assert s.end_ns - s.start_ns >= 20_000_000


# ----------------------------------- service ----------------------------------------


def post(url, blob):
    req = urllib.request.Request(url + "/score", data=blob,
                                 headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def server(rn_engine):
    svc = ScoringService(rn_engine, CLASSES, batch_size=4, max_wait_ms=20.0)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc, topk=2))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield svc, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    svc.close()


def wait_for(rec, name, n):
    deadline = time.monotonic() + 30
    while len(rec.named(name)) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    return rec.named(name)


def test_tracing_on_leaves_service_answers_bit_identical(server):
    svc, url = server
    blobs = [jpeg(im) for im in images(3, seed=5)]
    off = [post(url, b)["scores"] for b in blobs]
    with tracing.record() as rec:
        on = [post(url, b)["scores"] for b in blobs]
        wait_for(rec, "serve.request", 3)
    assert on == off


def test_service_stages_partition_server_time(server):
    svc, url = server
    blobs = [jpeg(im) for im in images(6, seed=6)]
    before = svc.stats.snapshot()
    with tracing.record() as rec:
        threads = [threading.Thread(target=post, args=(url, b)) for b in blobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        requests = wait_for(rec, "serve.request", 6)
    assert not any(t.is_alive() for t in threads)
    assert len(requests) == 6
    for r in requests:
        stages = [s for s in rec.spans if s.attrs.get("request") == r.attrs["request"]
                  and s.name != "serve.request"]
        assert [s.name for s in stages] == ["serve." + s for s in STAGES]
        assert stages[0].start_ns == r.start_ns and stages[-1].end_ns == r.end_ns
        for a, b in zip(stages, stages[1:]):
            assert a.end_ns == b.start_ns and a.end_ns >= a.start_ns
        assert abs(sum(s.end_ns - s.start_ns for s in stages) - (r.end_ns - r.start_ns)) < 1e6
    after = svc.stats.snapshot()
    assert after["staged_requests"] - before["staged_requests"] == 6
    served = after["dispatches"] - before["dispatches"]
    assert served >= 2 and rec.counters["serve.dispatches"] == served
    assert rec.counters["serve.dispatch_images"] == 6
    assert rec.counters["launches.conv_fp32"] == 0  # the CPU runs the plain versions
    assert len(rec.named("score.dispatch")) == served


# ------------------------------ the benchmark's readers -----------------------------

NEW = ("dispatch_host_ms.score", "serve_queue_ms.serve", "serve_host_ms.serve",
       "serve_in_flight_ms.serve")


def profiler_window():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_spans_follow_a_profiler_window():
    assert not tracing.enabled()
    with profiler_window() as prof:
        assert tracing.enabled()
        with tracing.span("test.first"):
            torch.ones(8).sum()
        rec = tracing.profiled()
        assert rec.open and [s.name for s in rec.spans] == ["test.first"]
    # off once the window has closed: the next span is the shared no-op, and
    # the window's recording is closed with what it kept
    assert tracing.span("test.outside") is tracing.span("test.other")
    assert not tracing.enabled()
    assert tracing.profiled() is rec and not rec.open
    assert [s.name for s in rec.spans] == ["test.first"]
    assert [e.name() for e in prof.profiler.kineto_results.events()].count("test.first") == 1
    with profiler_window():
        tracing.add_spans([("test.second", 1, 2, {})])
    assert [s.name for s in tracing.profiled().spans] == ["test.second"]
    assert [s.name for s in rec.spans] == ["test.first"]


def test_readers_none_without_their_spans(monkeypatch):
    from benchmark import program_spans

    obs = harness.Obs(trace={"window_s": 1.0, "busy_s": 0.5})
    with profiler_window():
        tracing.add_spans([("test.unrelated", 0, 10, {"request": 1})])
    for name in NEW:
        assert harness.load_reader(name)(obs) is None, name
    # a program that keeps no spans (no utils/tracing): nothing, and no error
    monkeypatch.setitem(__import__("sys").modules, "leclip_tpu_torch.utils.tracing", None)
    assert program_spans.profiled() is None
    for name in NEW:
        assert harness.load_reader(name)(obs) is None, name


def test_reader_dispatch_host_by_hand():
    with profiler_window():
        tracing.add_spans([("score.dispatch", 0, 10_000_000, {}),
                           ("score.dispatch", 50_000_000, 80_000_000, {}),
                           ("score.stage", 0, 99_000_000, {})])
    assert harness.load_reader("dispatch_host_ms.score")(harness.Obs()) == pytest.approx(20.0)


def test_serve_readers_by_hand():
    # ten requests; the two of 10 s are at the 95th percentile (numpy's
    # "higher" of ten values is the largest), the tail; an eleventh, of
    # 20 s, lacks its in_flight span (kept after the window) and is left out
    total = [1.0, 2, 3, 4, 5, 6, 7, 8, 10, 10]
    queue = [0.5] * 8 + [4.0, 6.0]
    in_flight = [0.4] * 8 + [5.0, 3.0]
    ns = 1_000_000_000
    spans = []
    for i, (t, q, f) in enumerate(zip(total, queue, in_flight)):
        attrs = {"request": i}
        spans += [("serve.request", 0, int(t * ns), attrs), ("serve.queue", 0, int(q * ns), attrs),
                  ("serve.in_flight", 0, int(f * ns), attrs)]
        spans += [("serve." + n, 0, ns // 40, attrs)
                  for n in ("decode", "stage", "launch", "respond")]
    spans += [("serve.request", 0, 20 * ns, {"request": 10}),
              ("serve.queue", 0, 19 * ns, {"request": 10})]
    with profiler_window():
        tracing.add_spans(spans)
    obs = harness.Obs()
    assert harness.load_reader("serve_queue_ms.serve")(obs) == pytest.approx(5000.0)
    assert harness.load_reader("serve_in_flight_ms.serve")(obs) == pytest.approx(4000.0)
    assert harness.load_reader("serve_host_ms.serve")(obs) == pytest.approx(100.0)


def test_serve_readers_sum_to_the_tails_server_time(server):
    from benchmark import program_spans

    svc, url = server
    blobs = [jpeg(im) for im in images(6, seed=7)]
    with profiler_window():
        threads = [threading.Thread(target=post, args=(url, b)) for b in blobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        deadline = time.monotonic() + 30
        while (len([s for s in tracing.profiled().spans if s.name == "serve.request"]) < 6
               and time.monotonic() < deadline):
            time.sleep(0.01)
    assert not any(t.is_alive() for t in threads)
    rec = tracing.profiled()
    assert len(program_spans.by_request(rec, ("serve.request",) + tuple(
        "serve." + s for s in STAGES))) == 6
    parts = [harness.load_reader(n)(harness.Obs())
             for n in ("serve_queue_ms.serve", "serve_host_ms.serve", "serve_in_flight_ms.serve")]
    tail = program_spans.tail_mean_ms(rec, ("serve.request",))
    assert all(p is not None and p >= 0 for p in parts)
    assert sum(parts) == pytest.approx(tail, abs=1e-3)
