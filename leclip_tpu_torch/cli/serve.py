"""Scoring service (counterpart of leclip_tpu/cli/serve.py, same arguments
plus ``--device``): the competition scoring path (decode → crop pyramid →
image tower → ensemble fuse/route) over HTTP with request micro-batching.

Concurrent requests are grouped into one fused dispatch of up to
``--batch-size`` images, waiting at most ``--max-wait-ms`` after the first
arrival, so throughput under load approaches the engine's batch rate instead
of paying one dispatch per request.

Endpoints (stdlib http.server):
  GET  /healthz  → {"status": "ok", "models": [...], "crops_per_image": N}
  GET  /classes  → {"classes": [...80 names...]}
  GET  /metrics  → Prometheus text: request/image/dispatch/error counters,
                   crop-forward counter, batch-fill padding, queue depth,
                   latency quantiles (sliding window), and the server-side
                   time of the answered requests by stage,
                   leclip_request_stage_seconds_sum{stage="..."} and _count
  POST /score    → body: one image (Content-Type: image/jpeg), or JSON
                   {"images": ["<base64 image>", ...]}
                   → {"scores": [[...C floats...], ...],
                      "topk": [[{"label": ..., "score": ...}, ...], ...]}
  POST /reload   → re-read the prompt checkpoints from --model-dir and swap
                   the engine in place; batches already dispatched finish on
                   the engine they were dispatched to.

Images are decoded in the handler threads (``data/loader.decode_bytes_batch``:
JPEGs by the native libjpeg decoder when it is available, the rest by PIL). The worker thread alone dispatches to
the engine: its first dispatch builds the kernels, under ops/_build.py's
lock, and every dispatch enters ``torch.inference_mode`` itself (the mode
is per thread).

A request's server-side time, from its body read to its response written,
is six stages (:data:`STAGES`), timed for every answered request:
``decode`` (the handler parses and decodes the body), ``queue`` (waiting in
the queue, then in the micro-batch window until its batch closes),
``stage`` and ``launch`` (its micro-batch's ``stage_batch_fused`` and
``dispatch_staged_fused`` calls in the worker), ``in_flight`` (launched
until its scores are on the host: the device's work, the batch ahead of it,
the fetch) and ``respond`` (scores set until the response is written).
With spans on (utils/tracing.py) each request's stages are spans
``serve.<stage>``, inside a ``serve.request`` span, all with the request's
id; the worker's micro-batch window is a ``serve.window`` span.

Usage:
    python -m leclip_tpu_torch.cli.serve --weights RN50.pt --model-dir best_model \\
        [--caption-bank bank.pkl] [--port 8000] [--batch-size 8] [--topk 5] \\
        [--device cuda|cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import base64
import itertools
import json
import queue
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from ..utils.tracing import add_counters, add_spans, clock_ns, enabled, span

# a request's server-side stages, in order
STAGES = ("decode", "queue", "stage", "launch", "in_flight", "respond")
_IDS = itertools.count()


class _Request:
    """One request's images and answer, and its stage boundaries on
    ``clock_ns``: its start (``started``, else its submission), then the end
    of each stage of :data:`STAGES` as it passes it."""

    __slots__ = ("images", "event", "scores", "error", "id", "stamps")

    def __init__(self, images: List[np.ndarray], started: Optional[int] = None):
        self.images = images
        self.event = threading.Event()
        self.scores: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.id = next(_IDS)
        now = clock_ns()
        self.stamps = [now if started is None else started, now]


class ServiceStats:
    """Thread-safe serving counters and a sliding request-latency window,
    rendered as Prometheus text (GET /metrics)."""

    def __init__(self, latency_window: int = 1024):
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests = 0
        self.errors = 0
        self.images = 0
        self.dispatches = 0
        self.dispatch_images = 0   # real images sent to the device
        self.dispatch_padding = 0  # repetition-padding rows (batch fill loss)
        self.latency_sum = 0.0
        self._latencies = deque(maxlen=latency_window)
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self.staged_requests = 0
        add_counters("serve", self.dispatch_counters)

    def record_request(self, n_images: int, latency_s: float, error: bool):
        with self._lock:
            self.requests += 1
            self.images += n_images
            self.latency_sum += latency_s
            self._latencies.append(latency_s)
            if error:
                self.errors += 1

    def record_dispatch(self, n_real: int, n_padding: int):
        with self._lock:
            self.dispatches += 1
            self.dispatch_images += n_real
            self.dispatch_padding += n_padding

    def record_stages(self, seconds: Sequence[float]):
        """One answered request's server-side time, by stage (:data:`STAGES`)."""
        with self._lock:
            self.staged_requests += 1
            for stage, s in zip(STAGES, seconds):
                self.stage_seconds[stage] += s

    def dispatch_counters(self) -> dict:
        with self._lock:
            return {"dispatches": self.dispatches, "dispatch_images": self.dispatch_images,
                    "dispatch_padding": self.dispatch_padding}

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            out = {
                "uptime_seconds": time.time() - self.started,
                "requests": self.requests, "errors": self.errors,
                "images": self.images, "dispatches": self.dispatches,
                "dispatch_images": self.dispatch_images,
                "dispatch_padding": self.dispatch_padding,
                "latency_sum": self.latency_sum,
                "stage_seconds": dict(self.stage_seconds),
                "staged_requests": self.staged_requests,
            }
        for q in (0.5, 0.9, 0.99):
            out[f"latency_p{int(q * 100)}"] = (
                lat[min(int(q * len(lat)), len(lat) - 1)] if lat else 0.0)
        return out

    def prometheus(self, crops_per_image: int, queue_depth: int) -> str:
        s = self.snapshot()
        lines = []

        def emit(name, kind, help_, value):
            lines.append(f"# HELP leclip_{name} {help_}")
            lines.append(f"# TYPE leclip_{name} {kind}")
            lines.append(f"leclip_{name} {value}")

        emit("uptime_seconds", "gauge", "seconds since service start",
             f"{s['uptime_seconds']:.3f}")
        emit("requests_total", "counter", "scoring requests completed", s["requests"])
        emit("request_errors_total", "counter", "requests that errored", s["errors"])
        emit("images_total", "counter", "images received in requests", s["images"])
        emit("dispatches_total", "counter", "fused device dispatches", s["dispatches"])
        emit("dispatch_images_total", "counter", "real images sent to the device",
             s["dispatch_images"])
        emit("dispatch_padding_total", "counter", "repetition-padded rows (batch fill loss)",
             s["dispatch_padding"])
        emit("crops_scored_total", "counter", "crop forwards executed (images x crop pyramid)",
             s["dispatch_images"] * crops_per_image)
        emit("queue_depth", "gauge", "requests waiting in the micro-batch queue", queue_depth)
        lines.append("# HELP leclip_request_latency_seconds request latency "
                     "(sliding window quantiles)")
        lines.append("# TYPE leclip_request_latency_seconds summary")
        for q in (0.5, 0.9, 0.99):
            lines.append('leclip_request_latency_seconds{quantile="%s"} %.6f'
                         % (q, s[f"latency_p{int(q * 100)}"]))
        lines.append(f"leclip_request_latency_seconds_sum {s['latency_sum']:.6f}")
        lines.append(f"leclip_request_latency_seconds_count {s['requests']}")
        lines.append("# HELP leclip_request_stage_seconds server-side time of the answered "
                     "requests by stage, body read to response written")
        lines.append("# TYPE leclip_request_stage_seconds summary")
        for stage in STAGES:
            lines.append('leclip_request_stage_seconds_sum{stage="%s"} %.6f'
                         % (stage, s["stage_seconds"][stage]))
            lines.append('leclip_request_stage_seconds_count{stage="%s"} %d'
                         % (stage, s["staged_requests"]))
        return "\n".join(lines) + "\n"


class ScoringService:
    """Micro-batching wrapper around ``TTAEngine.stage_batch_fused`` and
    ``dispatch_staged_fused``.

    One worker thread drains the request queue, packs the images of waiting
    requests into fused dispatches of the engine's batch size (the tail
    padded by repetition), and fans the scores back out. Thread-safe; the
    HTTP layer below is one consumer of it."""

    def __init__(self, engine, classnames: Sequence[str], batch_size: int = 8,
                 max_wait_ms: float = 5.0, max_queue: int = 256):
        self.engine = engine
        self.classnames = list(classnames)
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self.stats = ServiceStats()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, name="scoring-worker", daemon=True)
        self._worker.start()

    # ------------------------------ client API ------------------------------
    def score(self, images: List[np.ndarray], timeout: float = 120.0) -> np.ndarray:
        return self.request(images, timeout).scores

    def request(self, images: List[np.ndarray], timeout: float = 120.0,
                started: Optional[int] = None) -> _Request:
        """:meth:`score`'s request, answered, with its stage boundaries;
        ``started`` (``clock_ns``) opens its decode stage. A caller that
        writes the answer out hands it to :meth:`answered` after."""
        if not images:
            raise ValueError("score() needs at least one image")
        req = _Request(images, started)
        t0 = time.perf_counter()
        try:
            self.queue.put(req, timeout=5.0)
            if not req.event.wait(timeout):
                raise TimeoutError("scoring timed out")
            if req.error:
                raise RuntimeError(req.error)
        except Exception:
            self.stats.record_request(len(images), time.perf_counter() - t0, error=True)
            raise
        self.stats.record_request(len(images), time.perf_counter() - t0, error=False)
        return req

    def answered(self, req: _Request) -> None:
        """Close a request's last stage (its response is written): its stage
        times go to the stats and, with spans on, to the recordings."""
        req.stamps.append(clock_ns())
        stamps = req.stamps
        self.stats.record_stages([(b - a) / 1e9 for a, b in zip(stamps, stamps[1:])])
        if enabled():
            attrs = {"request": req.id}
            add_spans([("serve.request", stamps[0], stamps[-1], attrs)]
                      + [("serve." + stage, a, b, attrs)
                         for stage, a, b in zip(STAGES, stamps, stamps[1:])])

    def swap_engine(self, engine) -> None:
        """Hot-swap the scoring engine (checkpoint reload). The worker takes
        the new engine at its next dispatch; micro-batches already
        dispatched to the old engine are still fetched from it."""
        self.engine = engine

    def close(self):
        self._stop.set()
        self._worker.join(timeout=10.0)
        # fail what is still queued so blocked callers wake at once
        while True:
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                break
            req.error = "service closed"
            req.event.set()

    # ------------------------------ worker ----------------------------------
    def _loop(self):
        """Micro-batch and a depth-2 pipeline: dispatch micro-batch i
        (queued on the device, not synchronised), then fetch and fan out
        micro-batch i - 1 while i runs."""
        pending: "deque" = deque()
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.02 if pending else 0.2)
            except queue.Empty:
                while pending:
                    self._finish(*pending.popleft())
                continue
            batch = [first]
            n_images = len(first.images)
            deadline = time.perf_counter() + self.max_wait
            # absorb whatever arrives within the window, up to the batch size
            with span("serve.window"):
                while n_images < self.batch_size:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self.queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    batch.append(nxt)
                    n_images += len(nxt.images)
            entry = self._dispatch_async(batch)
            if entry is not None:
                pending.append(entry)
            while len(pending) >= 2:
                self._finish(*pending.popleft())
        while pending:
            self._finish(*pending.popleft())

    def _dispatch_async(self, batch: List[_Request]):
        images: List[np.ndarray] = []
        for req in batch:
            images.extend(req.images)
        # one snapshot: a concurrent swap_engine must not split one
        # micro-batch across two model versions, and the batch is fetched
        # from the engine that dispatched it
        engine = self.engine
        closed = clock_ns()
        staging = 0
        try:
            outs = []
            for i in range(0, len(images), self.batch_size):
                chunk = images[i: i + self.batch_size]
                n0 = len(chunk)
                chunk = chunk + [chunk[-1]] * (self.batch_size - n0)
                t = clock_ns()
                staged = engine.stage_batch_fused(chunk)
                staging += clock_ns() - t
                outs.append((engine.dispatch_staged_fused(staged), n0))
                self.stats.record_dispatch(n0, len(chunk) - n0)
        except Exception as e:  # noqa: BLE001 — fanned back to each caller
            for req in batch:
                req.error = f"{type(e).__name__}: {e}"
                req.event.set()
            return None
        launched = clock_ns()
        for req in batch:
            req.stamps += [closed, closed + staging, launched]
        return batch, outs, engine

    def _finish(self, batch: List[_Request], outs, engine):
        try:
            flat = np.concatenate([engine._fetch(dev)[:n0] for dev, n0 in outs])
        except Exception as e:  # noqa: BLE001
            for req in batch:
                req.error = f"{type(e).__name__}: {e}"
                req.event.set()
            return
        fetched = clock_ns()
        off = 0
        for req in batch:
            req.stamps.append(fetched)
            req.scores = flat[off: off + len(req.images)]
            off += len(req.images)
            req.event.set()

    # ------------------------------ formatting ------------------------------
    def topk_labels(self, scores: np.ndarray, k: int = 5):
        out = []
        for row in scores:
            idx = np.argsort(-row)[:k]
            out.append([{"label": self.classnames[i], "score": float(row[i])} for i in idx])
        return out


def make_handler(service: ScoringService, topk: int, max_body_bytes: int = 64 << 20,
                 max_images: int = 64, max_pixels: int = 64_000_000, reload_fn=None):
    from http.server import BaseHTTPRequestHandler

    from ..data.loader import declared_pixels, decode_bytes_batch

    reload_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "models": list(service.engine.models),
                                 "crops_per_image": 1 + service.engine.n_blocks})
            elif self.path == "/classes":
                self._send(200, {"classes": service.classnames})
            elif self.path == "/metrics":
                body = service.stats.prometheus(1 + service.engine.n_blocks,
                                                service.queue.qsize()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/reload":
                if reload_fn is None:
                    self._send(501, {"error": "reload not configured"})
                    return
                try:
                    # one reload at a time; requests keep scoring on the
                    # current engine until the swap
                    with reload_lock:
                        service.swap_engine(reload_fn())
                    self._send(200, {"reloaded": True, "models": list(service.engine.models)})
                except Exception as e:  # noqa: BLE001 — surface to the client
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path != "/score":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > max_body_bytes:
                    # drain in bounded chunks so the client finishes sending
                    # and receives the 413 instead of a broken pipe
                    remaining = length
                    while remaining > 0:
                        chunk = self.rfile.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    self.close_connection = True
                    self._send(413, {"error": f"body exceeds {max_body_bytes} bytes"})
                    return
                body = self.rfile.read(length)
                started = clock_ns()
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    blobs = [base64.b64decode(s) for s in json.loads(body)["images"]]
                else:
                    blobs = [body]
                if not blobs:
                    self._send(400, {"error": "no images in request"})
                    return
                if len(blobs) > max_images:
                    self._send(400, {"error": f"too many images (> {max_images})"})
                    return
                for b in blobs:
                    if declared_pixels(b) > max_pixels:
                        self._send(400, {"error": f"image exceeds {max_pixels} pixels"})
                        return
                req = service.request(decode_bytes_batch(blobs), started=started)
                scores = req.scores
                self._send(200, {"scores": [[float(x) for x in row] for row in scores],
                                 "topk": service.topk_labels(scores, topk)})
                service.answered(req)
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet access log
            pass

    return Handler


def build_service(cfg, clip_params, clip_cfg, model_dir: str, caption_bank=None,
                  freq_stats=None, classnames: Optional[Sequence[str]] = None,
                  batch_size: int = 8, max_wait_ms: float = 5.0,
                  device=None) -> ScoringService:
    """The engine of cli/eval.py (inference.pipeline make_engine: the same
    precision resolution and co-occurrence) on ``device`` (the card unless
    the caller asks for the CPU), scoring ad-hoc images against the
    standard class list. ``service.engine_factory`` re-reads ``model_dir``
    (POST /reload)."""
    from ..data.vocab import COCO_OBJECT_CATEGORIES
    from ..device import resolve_device, tree_map
    from ..inference.pipeline import load_ensemble_specs, make_engine

    device = resolve_device(device)
    clip_params = tree_map(lambda t: t.to(device), clip_params)
    classnames = list(classnames or COCO_OBJECT_CATEGORIES)

    def engine_factory():
        specs = load_ensemble_specs(cfg, clip_params, clip_cfg, classnames, model_dir)
        return make_engine(cfg, clip_params, clip_cfg, specs, caption_bank=caption_bank,
                           freq_stats=freq_stats, device=device)

    service = ScoringService(engine_factory(), classnames, batch_size=batch_size,
                             max_wait_ms=max_wait_ms)
    service.engine_factory = engine_factory
    return service


def main(argv=None):
    ap = argparse.ArgumentParser(description="leclip_tpu_torch scoring service")
    ap.add_argument("--trainer-config", default="")
    ap.add_argument("--weights", default="")
    ap.add_argument("--backbone", default="")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--caption-bank", default="")
    ap.add_argument("--freq-stats", default="")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--max-body-mb", type=int, default=64)
    ap.add_argument("--max-images", type=int, default=64)
    ap.add_argument("--max-pixels", type=int, default=64_000_000,
                    help="reject images whose DECLARED WxH exceeds this")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    import os
    import pickle
    from http.server import ThreadingHTTPServer

    from ..device import resolve_device
    from ..engine.config import setup_config
    from .eval import load_clip

    device = resolve_device(args.device)
    cfg = setup_config(trainer_yaml=args.trainer_config, opts=args.opts, eval_only=True)
    clip_cfg, clip_params = load_clip(cfg, args, device)
    bank = freq = None
    if args.caption_bank and os.path.exists(args.caption_bank):
        with open(args.caption_bank, "rb") as f:
            bank = np.asarray(pickle.load(f), np.float32)
    if args.freq_stats and os.path.exists(args.freq_stats):
        with open(args.freq_stats, "rb") as f:
            freq = pickle.load(f)

    service = build_service(cfg, clip_params, clip_cfg, args.model_dir, caption_bank=bank,
                            freq_stats=freq, batch_size=args.batch_size,
                            max_wait_ms=args.max_wait_ms, device=device)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(service, args.topk, max_body_bytes=args.max_body_mb << 20,
                     max_images=args.max_images, max_pixels=args.max_pixels,
                     reload_fn=service.engine_factory))
    print(f"serving on http://{args.host}:{args.port} "
          f"(batch {args.batch_size}, max-wait {args.max_wait_ms} ms, {device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
        server.server_close()


if __name__ == "__main__":
    main()
