"""The frozen caption branch a step, ms by CUDA events from the step's start
to its "caption" mark: the batch's upload and
models/dense_clip.encode_captions (the text tower over 1,024 captions,
every position projected)."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('caption_branch',)]
    if any(p is None for p in parts):
        return None
    return sum(parts)
