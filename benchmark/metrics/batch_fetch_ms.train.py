"""The feed a step, ms by the host clock: data/loader.CaptionBatcher's next
batch of 1,024 token rows and labels from the epoch's permutation (the
upload happens inside the step and is counted in its caption branch)."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('batch_fetch',)]
    if any(p is None for p in parts):
        return None
    return sum(parts)
