"""Structured metrics writer — scalar logging to JSONL (and TensorBoard when
available), the observability parity for the reference's SummaryWriter
scalars (ref: dassl/engine/trainer.py:228-246,675-679). The port's own copy
of leclip_tpu/engine/metrics.py; the environment dump names torch, CUDA and
the card."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    """Append-only ``metrics.jsonl`` of {step, tag, value, time}; mirrors to
    a native TensorBoard event file (utils/tb_events.py — drop-in for the
    reference's SummaryWriter dashboards) unless ``tensorboard=False``."""

    def __init__(self, output_dir: str, tensorboard: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self._file = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            from ..utils.tb_events import EventFileWriter

            self._tb = EventFileWriter(os.path.join(output_dir, "tb"))

    def write_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"step": int(step), "tag": tag, "value": float(value), "time": time.time()}
        self._file.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def write_scalars(self, scalars: Dict[str, float], step: int, prefix: str = ""):
        for k, v in scalars.items():
            self.write_scalar(f"{prefix}{k}", v, step)

    def flush(self):
        self._file.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()


def collect_env_info() -> str:
    """Environment dump (reference collect_env_info analogue)."""
    import platform

    import numpy as np
    import torch

    lines = [
        f"python: {platform.python_version()}",
        f"platform: {platform.platform()}",
        f"torch: {torch.__version__}",
        f"numpy: {np.__version__}",
        f"cuda: {torch.version.cuda}",
        f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}",
    ]
    return "\n".join(lines)
