"""Scoring, fusion and routing a batch, ms by CUDA events around
TTAEngine._score (every member's logits, ops/ensemble fuse / fuse6, the
per-class routing)."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('score_fuse',)]
    if any(p is None for p in parts):
        return None
    return sum(parts)
