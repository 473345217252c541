"""The program's own spans, for the per-layer readers that read them
(``source: "program_span"``): the spans that leclip_tpu_torch kept while the
traced run's profiler window was open (``utils/tracing.profiled``), on the
profiler's clock. On a program without them every function here gives None,
so that its metric is left out of the result line."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np


def profiled():
    """The program's recording of the last profiler window, or None for a
    program that keeps none."""
    try:
        from leclip_tpu_torch.utils.tracing import profiled as program_profiled
    except ImportError:
        return None
    return program_profiled()


def host_ms(rec, name: str) -> Optional[float]:
    """The mean host time of the spans ``name``, ms."""
    vals = [s.host_s for s in rec.spans if s.name == name] if rec is not None else []
    return 1e3 * statistics.fmean(vals) if vals else None


def by_request(rec, names: Sequence[str]) -> Dict[object, Dict[str, float]]:
    """Each request whose spans ``names`` all closed in the window: its host
    time in each, seconds, by the spans' ``request`` attribute."""
    out: Dict[object, Dict[str, float]] = {}
    for s in rec.spans if rec is not None else []:
        if s.name in names and "request" in s.attrs:
            out.setdefault(s.attrs["request"], {})[s.name] = s.host_s
    return {r: v for r, v in out.items() if len(v) == len(names)}


def tail_mean_ms(rec, parts: Sequence[str], total: str = "serve.request") -> Optional[float]:
    """Over the requests whose span ``total`` and every stage's span closed
    in the window, and whose ``total`` is at or past its 95th percentile
    (numpy's ``method="higher"``), the mean of the sum of their spans
    ``parts``, ms."""
    if rec is None:
        return None
    from leclip_tpu_torch.cli.serve import STAGES

    names = tuple("serve." + s for s in STAGES) + (total,)
    reqs = list(by_request(rec, names).values())
    if not reqs:
        return None
    tot = np.asarray([r[total] for r in reqs])
    cut = np.quantile(tot, 0.95, method="higher")
    tail: List[float] = [sum(r[p] for p in parts) for r, t in zip(reqs, tot) if t >= cut]
    return 1e3 * statistics.fmean(tail)
