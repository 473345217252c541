"""What every cell shares: the run's context, spans timed by CUDA events or
the host clock, the profiler window and its reduction to busy time, the
device's idle gaps and its busiest operations, the per-layer metric readers
(one file each under benchmark/metrics/, found by the metric's name), and
the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "leclip_tpu", "bench", "chip_smoke")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one input of a run, from the run's seed and the
    input's name."""
    words = [ord(c) for c in tag]
    return int(np.random.SeedSequence([seed & (2 ** 64 - 1)] + words).generate_state(
        1, dtype=np.uint64)[0] >> 1)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(rel: str) -> dict:
    with open(os.path.join(HERE, rel)) as f:
        return json.load(f)


# ----------------------------------- spans ------------------------------------------


@dataclass
class Obs:
    """What a traced run observed, for the metric readers: spans in seconds
    by name (one entry a unit: a batch, a step, a request), counters, the
    profiler window's reduction, and operation counts from shapes."""

    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Dict[str, object] = field(default_factory=dict)
    work: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def mean_ms(self, name: str) -> Optional[float]:
        vals = self.spans.get(name)
        return 1e3 * statistics.fmean(vals) if vals else None


# ---------------------------------- profiler ----------------------------------------


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(prof, window_ns: int, n_top: int = 10) -> dict:
    """Busy time (the union of every device operation's interval), the
    device's busiest operations by total time, and its longest idle gaps,
    each named by the innermost ``bench/`` annotation the host was inside
    when the gap began."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, notes = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("bench/"):
            # an annotation; its copy on the device's timeline is no operation
            if e.device_type() != cuda:
                notes.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[6:]))
        elif e.device_type() == cuda and e.duration_ns() > 0:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    if not dev:
        return {"busy_s": 0.0, "device_ops": [], "idle_gaps": []}
    busy = _union([(s, e) for s, e, _ in dev])
    by_name: Dict[str, int] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    dev.sort()
    gaps, end = [], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > end:
            gaps.append((s - end, end))
        end = max(end, e)
    gaps.sort(reverse=True)
    named = []
    for length, start in gaps[:n_top]:
        inside = [n for n in notes if n[0] <= start < n[1]]
        label = min(inside, key=lambda n: n[1] - n[0])[2] if inside else "outside any span"
        named.append([label, length / 1e9])
    return {"busy_s": busy / 1e9, "window_s": window_ns / 1e9,
            "device_ops": [[name, ns / 1e9] for name, ns in ops], "idle_gaps": named}


class ProfileWindow:
    """torch.profiler over a few units of the traced run (``cpu=False``: the
    device's activity alone, for a window long enough that the host's
    operations would flood the trace); ``result`` holds
    :func:`reduce_trace`'s reduction once it has closed."""

    def __init__(self, torch, cpu: bool = True):
        self.torch = torch
        self.cpu = cpu
        self.result: Optional[dict] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.cpu else [])
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        window = time.perf_counter_ns() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.result = reduce_trace(self.prof, window)
        return False


def warm_profiler(torch) -> None:
    """Start and stop the profiler once around a small operation, so that
    the traced window does not pay CUPTI's first start (seconds)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def annotate(name: str):
    """A ``bench/<name>`` range on the profiler's host timeline."""
    from torch.profiler import record_function

    return record_function("bench/" + name)


# ----------------------------------- metrics ----------------------------------------


def load_reader(name: str) -> Callable[[Obs], Optional[float]]:
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_metrics(bench: dict, cell: str, obs: Obs) -> Dict[str, dict]:
    """Every per-layer metric whose ``workloads`` list this cell, read by its
    reader; a reader that finds nothing returns None and the metric is left
    out."""
    out = {}
    for m in bench["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        value = load_reader(m["name"])(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ----------------------------------- result -----------------------------------------


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def banned_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def result_line(bench: dict, cell: str, out: dict, trace: bool) -> dict:
    """The run's result object from a driver's output: ``correct`` when every
    compared number is within its limit; the cell's end-to-end metrics, or
    with ``trace`` its per-layer metrics, busy time and breakdown; the
    compared numbers beside their limits last."""
    device = dict(out["device"])
    if trace:
        metrics = per_layer_metrics(bench, cell, out["obs"])
        tr = out.get("trace") or {}
        device["busy_s"] = tr.get("busy_s", 0.0)
        device["window_s"] = tr.get("window_s", 0.0)
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if cell in m.get("workloads", [cell]) and m["name"] in out["e2e"]}
    checks = out["checks"]
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace and out.get("trace"):
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                               "idle_gaps": out["trace"]["idle_gaps"]}
    result["compared"] = {k: {"value": c["value"], "limit": c["limit"]}
                          for k, c in checks.items()}
    return result


def check(value: float, limit: float) -> dict:
    """A compared number beside its limit: within it or not."""
    return {"value": value, "limit": limit, "ok": value <= limit}


def compared_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"compared {name}: {c['value']!r} limit {c['limit']!r} "
            f"({'within' if c['ok'] else 'BEYOND'})" for name, c in checks.items()]
