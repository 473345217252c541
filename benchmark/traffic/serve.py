"""The service cells' driver: an open loop against ``cli/serve.py``'s HTTP
server, in the same process.

Set-up builds the scoring cells' engine on the seed's weights, members and
bank, wraps it in ``ScoringService`` (the CLI's batch and micro-batch
window) behind ``make_handler`` on a ``ThreadingHTTPServer`` bound to
localhost, and warms the shapes a mix of request sizes can dispatch. The
load generator then POSTs one JPEG of the pool a request on a Poisson
schedule at the cell's fixed rate: the same arrival times every run, the
images in an order drawn from the seed. A request's latency runs
from when it was due to when its whole response has been read; one that
fails or is refused counts as missing every limit. Every request due inside
the window is waited for, a minute past its close at most."""

from __future__ import annotations

import gc
import http.client
import json
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from .. import harness, program
from ..reference.lowprec import CONTROLS
from . import score

FAILED_S = 60.0   # a failed request's latency: past any limit the cell sets
ARRIVALS = 20180  # the seed of the one arrival schedule every run offers
CLIENT_S = 4.0    # client threads: enough for the requests of this many seconds in flight


def schedule(rate: float, seconds: float, n_pool: int, seed: int):
    """(send times from the window's start, pool index a request): one
    realisation of a Poisson arrival process at ``rate``, the same for every
    seed, its count fixed by rate and window; the seed draws which image
    each request sends. Seeds then differ in weights and images, not in how
    bursty the load is."""
    n = int(round(rate * seconds))
    gaps = np.random.default_rng(ARRIVALS).exponential(1.0, n)
    scale = seconds / gaps.sum()
    times = (np.cumsum(gaps) - gaps[0]) * scale
    rng = np.random.default_rng(harness.sub_seed(seed, "arrivals"))
    images = rng.permutation(np.resize(np.arange(n_pool), n))
    return times, images


def setup(ctx, seed: int) -> dict:
    from http.server import ThreadingHTTPServer

    from leclip_tpu_torch.cli.serve import ScoringService, make_handler

    p = ctx.params
    t = time.perf_counter()
    split = {}
    st = {"build_s": program.build_kernels(p["route"], ctx.device), "split": split}
    split["kernel build"] = time.perf_counter() - t
    st.update(score.make_inputs(ctx, seed, ctx.device, split))
    t = time.perf_counter()
    engine = program.build_engine(ctx.config, st["weights"], st["members"], st["bank"],
                                  ctx.device)
    ctx.sync()
    split["engine"] = time.perf_counter() - t
    service = ScoringService(engine, ctx.config["classnames"], batch_size=p["batch_images"],
                             max_wait_ms=p["max_wait_ms"])
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service, topk=5))
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    st.update(engine=engine, service=service, server=server, thread=thread,
              port=server.server_address[1])
    t = time.perf_counter()
    warm(ctx, st)
    if ctx.trace:
        harness.warm_profiler(ctx.torch)
    split["warm-up"] = time.perf_counter() - t
    return st


def warm(ctx, st: dict) -> None:
    """Every bucket a dispatch can land in, with one size a batch and with
    sizes mixed, straight to the engine; then a few requests through HTTP."""
    from leclip_tpu_torch.data.loader import decode_bytes_batch

    images = decode_bytes_batch(st["blobs"])
    by_size = {}
    for im in images:
        by_size.setdefault(im.shape[:2], []).append(im)
    b = ctx.params["batch_images"]
    batches = [group[:b] for group in by_size.values()]
    mixed = [g[0] for g in by_size.values()]
    batches.append((mixed * b)[:b])
    for _ in st["engine"].run_batches_fused(batches):
        pass
    with ThreadPoolExecutor(b) as pool:
        list(pool.map(lambda i: post(st["port"], st["blobs"][i]), range(2 * b)))
    ctx.sync()


def post(port: int, blob: bytes):
    """POST one JPEG to /score → (status, scores or None)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=FAILED_S)
    try:
        conn.request("POST", "/score", body=blob, headers={"Content-Type": "image/jpeg"})
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            return resp.status, None
        return 200, np.asarray(json.loads(body)["scores"][0], np.float32)
    finally:
        conn.close()


def load(ctx, st: dict, rate: float, seconds: float, seed: int, prof=None) -> dict:
    """Offer the schedule; wait for every request due in the window."""
    times, images = schedule(rate, seconds, len(st["blobs"]), seed)
    n = len(times)
    latency = np.full(n, FAILED_S)
    lag = np.zeros(n)
    answers: List = [None] * n
    stats0 = st["service"].stats.snapshot()
    clients = ThreadPoolExecutor(max(8, int(rate * CLIENT_S)))

    def one(i, due):
        lag[i] = time.perf_counter() - due
        try:
            status, scores = post(st["port"], st["blobs"][images[i]])
        except OSError:
            return
        if status == 200:
            latency[i] = time.perf_counter() - due
            answers[i] = scores

    # the profiler starts and stops while the service is idle, around the
    # whole load: started or stopped while the service's worker thread
    # launches kernels, it crashed a run
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    futures = []
    for i, at in enumerate(times):
        due = t0 + at
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futures.append(clients.submit(one, i, due))
    t_sent = time.perf_counter()
    clients.shutdown(wait=True)
    if prof is not None:
        prof.__exit__(None, None, None)
    stats1 = st["service"].stats.snapshot()
    for f in futures:
        f.result()
    return {"latency": latency, "lag": lag, "answers": answers, "images": images,
            "times": times, "send_s": t_sent - t0, "stats": (stats0, stats1)}


def p95(values) -> float:
    return float(np.quantile(np.asarray(values), 0.95, method="higher"))


def stop(st: dict) -> None:
    st["server"].shutdown()
    st["server"].server_close()
    st["thread"].join(timeout=10)
    st["service"].close()


def sample(ctx, res: dict, seed: int):
    """(pool indices, the service's answers) of a sample of the window's
    answered requests, drawn from the seed, one a pool image."""
    first = {}
    for i, ans in enumerate(res["answers"]):
        if ans is not None:
            first.setdefault(int(res["images"][i]), ans)
    keys = sorted(first)
    rng = np.random.default_rng(harness.sub_seed(seed, "sample"))
    pick = sorted(rng.choice(len(keys), size=min(ctx.params["sample_images"], len(keys)),
                             replace=False))
    return [keys[i] for i in pick], np.stack([first[keys[i]] for i in pick])


def free_program(ctx, st: dict) -> None:
    for key in ("engine", "service", "server", "thread"):
        st.pop(key, None)
    gc.collect()
    ctx.torch.cuda.empty_cache()


def run(ctx) -> dict:
    p = ctx.params
    st = setup(ctx, ctx.seed)
    setup_s = time.perf_counter() - ctx.t0
    harness.log(f"set-up {setup_s:.3f} s (kernel builds {st['build_s']}); split: "
                + ", ".join(f"{k} {v:.3f} s" for k, v in st["split"].items()))
    prof = harness.ProfileWindow(ctx.torch, cpu=False) if ctx.trace else None
    res = load(ctx, st, p["rate"], ctx.seconds, ctx.seed, prof)
    memory = harness.device_info(ctx.torch, 1)
    stop(st)
    lat = res["latency"]
    failed = int((lat >= FAILED_S).sum())
    free_program(ctx, st)
    keys, got = sample(ctx, res, ctx.seed)
    t = time.perf_counter()
    name, gap, _ = score.compared(ctx, st, [score.decode(st["blobs"][k]) for k in keys], got)
    harness.log(f"reference {time.perf_counter() - t:.3f} s for {len(keys)} images")
    checks = {"failed_requests": harness.check(failed, 0),
              name: harness.check(gap, p["limits"][name])}
    out = {"attempted": len(lat), "failed": failed, "checks": checks, "device": memory,
           "e2e": {"serve_p95_ms": 1e3 * p95(lat), "setup_s": setup_s}}
    if ctx.trace:
        s0, s1 = res["stats"]
        obs = harness.Obs()
        real = s1["dispatch_images"] - s0["dispatch_images"]
        pad = s1["dispatch_padding"] - s0["dispatch_padding"]
        obs.counters.update(dispatch_images=real, dispatch_padding=pad,
                            dispatches=s1["dispatches"] - s0["dispatches"])
        obs.spans["send_lag"] = [float(v) for v in res["lag"]]
        obs.trace = prof.result or {}
        out["obs"], out["trace"] = obs, prof.result
    return out


# ----------------------------------- sweep ------------------------------------------


def sweep(ctx, rates: List[float], seconds: float) -> List[dict]:
    """The knee: at each offered rate, p95 and whether the backlog grew (the
    last third's median latency against the first third's)."""
    st = setup(ctx, ctx.seed)
    rows = []
    for rate in rates:
        res = load(ctx, st, rate, seconds, ctx.seed)
        lat = res["latency"]
        third = max(1, len(lat) // 3)
        row = {"rate": rate, "requests": len(lat), "p95_ms": 1e3 * p95(lat),
               "p50_ms": 1e3 * float(np.median(lat)),
               "first_third_ms": 1e3 * float(statistics.median(lat[:third])),
               "last_third_ms": 1e3 * float(statistics.median(lat[-third:])),
               "failed": int((lat >= FAILED_S).sum()), "lag_p95_ms": 1e3 * p95(res["lag"])}
        harness.log(f"sweep {row}")
        rows.append(row)
    stop(st)
    return rows


def readings(ctx, seeds: List[int], seconds: float) -> List[dict]:
    """As the scoring cells' readings, on the service's answers at the cell's
    rate."""
    control = CONTROLS[ctx.params["control"]]
    out = []
    for seed in seeds:
        st = setup(ctx, seed)
        res = load(ctx, st, ctx.params["rate"], seconds, seed)
        stop(st)
        free_program(ctx, st)
        keys, got = sample(ctx, res, seed)
        name, prog, low = score.compared(
            ctx, st, [score.decode(st["blobs"][k]) for k in keys], got, control)
        limit = ctx.params["limits"][name]
        row = {"seed": seed, "images": len(keys), "program": harness.check(prog, limit),
               "control": harness.check(low, limit)}
        harness.log(f"readings {row}")
        out.append(row)
        del st
        gc.collect()
        ctx.torch.cuda.empty_cache()
    return out
