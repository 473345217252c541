"""The port's instrumentation in one place: spans and counters on the
profiler's clock, and :func:`profiler_trace`, the trace window of
``TRAIN.profile_dir`` (the JAX package's ``profiler_trace`` on
torch.profiler).

Turning spans on. An operator either wraps a region of a process in
``with record() as rec:``, after which ``rec.spans`` holds every span closed
inside it (name, thread, attributes such as a request id, start and end on
:func:`clock_ns`, and the device time of a ``device=True`` span) and
``rec.counters`` each counter's change over the region (the kernels' launch
counts of ``ops/launches.py``, a scoring service's dispatch counters); or
opens a torch.profiler window (``TRAIN.profile_dir`` opens one around
training): spans are on while any torch.profiler window is open, so that its
trace names the train step's parts, the loader's batches and a service's
request stages, and :func:`profiled` hands back the spans of the last such
window afterwards. With neither open, :func:`span` is two flag reads that
hand back a shared no-op: it records nothing, makes no CUDA event and opens
no profiler range.

The clock is the one torch.profiler's events carry
(``kineto_results.events()``' ``start_ns``): Unix-epoch nanoseconds, so a
span lines up with the device's activity in a trace taken meanwhile. A
span's profiler range is a function-scope ``RecordFunction``, which a trace
shows on the host's timeline; a user-scope one
(``torch.profiler.record_function``) also gets a copy on the device's
timeline over the kernels launched inside it, which a reader of the trace
would count as device work."""

from __future__ import annotations

import contextlib
import inspect
import os
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

from torch.autograd import profiler as _torch_profiler

clock_ns = time.time_ns

_ON = False         # any recording open
_RECORDINGS: tuple = ()
_PROFILED: Optional["Recording"] = None  # follows the last torch.profiler window
_PROFILED_LOCK = threading.Lock()
_SOURCES: list = []  # (prefix, callable or weak method) → {counter: value}
_SOURCES_LOCK = threading.Lock()
_NOOP = contextlib.nullcontext()


def _follow_profiler() -> bool:
    """Open a recording when a torch.profiler window has opened, close it
    when the window has closed; whether spans are on."""
    global _PROFILED
    if _torch_profiler._is_profiler_enabled != (_PROFILED is not None and _PROFILED.open):
        with _PROFILED_LOCK:
            on = _torch_profiler._is_profiler_enabled
            if on and (_PROFILED is None or not _PROFILED.open):
                _PROFILED = Recording()._start()
            elif not on and _PROFILED is not None and _PROFILED.open:
                _PROFILED._stop()
    return _ON


def enabled() -> bool:
    """Whether spans are on: a recording or a torch.profiler window open."""
    return (_ON or _torch_profiler._is_profiler_enabled) and _follow_profiler()


class Span:
    """One closed span: host start and end on :func:`clock_ns`, and with
    ``device=True`` the device time between its two CUDA events, seconds
    (None until its recording is collected, and off the card)."""

    __slots__ = ("name", "thread", "attrs", "start_ns", "end_ns", "device_s", "_events")

    def __init__(self, name: str, thread: str, attrs: dict, start_ns: int, end_ns: int,
                 events=None):
        self.name, self.thread, self.attrs = name, thread, attrs
        self.start_ns, self.end_ns = start_ns, end_ns
        self.device_s: Optional[float] = None
        self._events = events

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _keep(spans: List[Span]) -> None:
    for rec in _RECORDINGS:
        rec.spans.extend(spans)


def _cuda_events():
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    return start, end


class _Open:
    __slots__ = ("name", "device", "attrs", "start", "events", "range")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self):
        import torch

        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.events = _cuda_events() if self.device else None
        self.start = clock_ns()
        return self

    def __exit__(self, *exc):
        end = clock_ns()
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        _keep([Span(self.name, threading.current_thread().name, self.attrs, self.start, end,
                    self.events)])
        return False


def span(name: str, device: bool = False, **attrs):
    """A context manager around one unit of a layer's work. Off, the shared
    no-op. On, it opens a profiler range ``name`` and keeps a :class:`Span`
    in every open recording; ``device=True`` also times the work queued on
    the current CUDA stream inside it."""
    if not (_ON or _torch_profiler._is_profiler_enabled) or not _follow_profiler():
        return _NOOP
    return _Open(name, device, attrs)


def add_spans(spans: Sequence[tuple]) -> None:
    """Keep spans timed by their caller, ``(name, start_ns, end_ns, attrs)``
    each, on the calling thread: one call keeps all of them or none."""
    if enabled():
        thread = threading.current_thread().name
        _keep([Span(name, thread, attrs, s, e) for name, s, e, attrs in spans])


class Parts:
    """Consecutive spans over the parts of one region, named ``prefix`` +
    each of ``names`` with spaces as underscores, one open at a time: the
    first opens on entry, and a call ``parts(name)`` at the end of part
    ``name`` closes its span, calls ``mark(name)`` and opens the next part's.
    ``mark`` is the region's callback, called whether spans are on or off."""

    def __init__(self, prefix: str, names: Sequence[str], mark: Optional[Callable] = None,
                 device: bool = False):
        self.prefix, self.names, self.mark, self.device = prefix, tuple(names), mark, device
        self.current = None

    def _open(self, i: int) -> None:
        if i < len(self.names):
            self.current = span(self.prefix + self.names[i].replace(" ", "_"), self.device)
            self.current.__enter__()

    def _close(self, *exc) -> None:
        current, self.current = self.current, None
        if current is not None:
            current.__exit__(*exc)

    def __enter__(self):
        self._open(0)
        return self

    def __call__(self, name: str) -> None:
        self._close(None, None, None)
        if self.mark is not None:
            self.mark(name)
        self._open(self.names.index(name) + 1)

    def __exit__(self, *exc):
        self._close(*exc)
        return False


# ----------------------------------- counters ---------------------------------------


def add_counters(prefix: str, read: Callable[[], Dict[str, float]]) -> None:
    """Let every recording read ``read()`` (counter → value) at its start and
    end, as ``prefix.counter``; a bound method is held weakly, so its object
    leaves the recordings when it goes."""
    ref = weakref.WeakMethod(read) if inspect.ismethod(read) else (lambda: read)
    with _SOURCES_LOCK:
        _SOURCES.append((prefix, ref))


def read_counters() -> Dict[str, float]:
    """Every counter now: the kernels' launch counts and each live source's,
    summed over sources of one prefix."""
    from ..ops.launches import launch_counts

    with _SOURCES_LOCK:
        _SOURCES[:] = [(p, ref) for p, ref in _SOURCES if ref() is not None]
        sources = list(_SOURCES)
    out = {f"launches.{k}": v for k, v in launch_counts().items()}
    for prefix, ref in sources:
        read = ref()
        for k, v in (read() if read is not None else {}).items():
            out[f"{prefix}.{k}"] = out.get(f"{prefix}.{k}", 0) + v
    return out


# ----------------------------------- recording --------------------------------------


class Recording:
    """What :func:`record` yields: the spans closed while it was open, and
    each counter's change over it (a source that appeared meanwhile counts
    from 0). Device times are read when it closes, after a synchronise."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self.start_ns = self.end_ns = 0
        self.open = False
        self._before: Dict[str, float] = {}

    def _start(self) -> "Recording":
        global _RECORDINGS, _ON
        self._before = read_counters()
        self.start_ns = clock_ns()
        self.open = True
        _RECORDINGS = _RECORDINGS + (self,)
        _ON = True
        return self

    def _stop(self) -> None:
        global _RECORDINGS, _ON
        _RECORDINGS = tuple(r for r in _RECORDINGS if r is not self)
        _ON = bool(_RECORDINGS)
        self.open = False
        self.end_ns = clock_ns()
        after = read_counters()
        self.counters = {k: v - self._before.get(k, 0) for k, v in after.items()}

    def _device_times(self) -> None:
        timed = [s for s in self.spans if s._events is not None]
        if timed:
            import torch

            torch.cuda.synchronize()
            for s in timed:
                s.device_s = s._events[0].elapsed_time(s._events[1]) / 1e3
                s._events = None

    def __enter__(self):
        return self._start()

    def __exit__(self, *exc):
        self._stop()
        self._device_times()
        return False

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def record() -> Recording:
    """Turn spans on and keep them, with the counters' changes, in the
    returned recording while it is open (``with record() as rec:``)."""
    return Recording()


def profiled() -> Optional[Recording]:
    """The recording of the last torch.profiler window in which a span
    opened, closed and with its device times read once that window has
    closed; None before any. For a reader of a window that someone else
    opened (a benchmark's, an operator's)."""
    _follow_profiler()
    rec = _PROFILED
    if rec is not None and not rec.open:
        rec._device_times()
    return rec


# ----------------------------------- profiler ---------------------------------------


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A torch.profiler trace around a region, written into ``logdir`` as a
    TensorBoard-loadable ``*.pt.trace.json`` (the Chrome trace format that
    TensorBoard's PyTorch profiler plugin reads); host activity, the card's
    kernels where there is one, and the program's spans, on while it is
    open. A no-op when ``logdir`` is empty. The profiler is closed and its
    trace written if the region raises."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
