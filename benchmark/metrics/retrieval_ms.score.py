"""Retrieval a batch, ms by CUDA events around TTAEngine._retrieve: one
exact top-k search of every crop against the caption bank
(models/dense_clip.retrieval_augment)."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('retrieval',)]
    if any(p is None for p in parts):
        return None
    return sum(parts)
