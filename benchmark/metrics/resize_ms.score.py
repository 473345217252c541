"""Crop, resize and normalise a batch, ms of device time by CUDA events
around TTAEngine._crops (ops/resize_matmul, ops/preprocess)."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('resize',)]
    if any(p is None for p in parts):
        return None
    return sum(parts)
