"""Stdout-tee logger, meters, and reproducible seeding (the port's own copy of
leclip_tpu/utils/logging.py; capability parity with dassl/utils/logger.py,
dassl/utils/meters.py and dassl/utils/tools.py:73-78), and
:func:`profiler_trace`, the trace window of the JAX package's
``profiler_trace`` on torch.profiler."""

from __future__ import annotations

import contextlib
import os
import random
import sys
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class _Tee:
    def __init__(self, path: str):
        self.console = sys.stdout
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.file = open(path, "a")

    def write(self, msg):
        self.console.write(msg)
        self.file.write(msg)

    def flush(self):
        self.console.flush()
        self.file.flush()
        os.fsync(self.file.fileno())

    def close(self):
        self.file.close()


def setup_logger(output_dir: Optional[str]) -> None:
    """Tee stdout into {output_dir}/log.txt (appends a timestamp suffix when
    the file already exists, like the reference logger)."""
    if not output_dir:
        return
    path = os.path.join(output_dir, "log.txt")
    if os.path.exists(path):
        path += time.strftime("-%Y-%m-%d-%H-%M-%S")
    sys.stdout = _Tee(path)


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (every device)."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class AverageMeter:
    """Running value/average, optionally exponentially smoothed."""

    def __init__(self, ema: bool = False, ema_rate: float = 0.9):
        self.ema = ema
        self.ema_rate = ema_rate
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        if self.ema and self.count > n:
            self.avg = self.avg * self.ema_rate + val * (1 - self.ema_rate)
        else:
            self.avg = self.sum / self.count


class MetricMeter:
    """Dict of AverageMeters with a compact string form."""

    def __init__(self, delimiter: str = " "):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{k} {m.val:.4f} ({m.avg:.4f})" for k, m in self.meters.items()
        )


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A torch.profiler trace around a region, written into ``logdir`` as a
    TensorBoard-loadable ``*.pt.trace.json`` (the Chrome trace format that
    TensorBoard's PyTorch profiler plugin reads); host activity, and the
    card's kernels where there is one. A no-op when ``logdir`` is empty. The
    profiler is closed and its trace written if the region raises."""
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
