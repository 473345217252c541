"""Host prep a batch, ms by the host clock: the native decode of its JPEGs
(data/loader.ImageBatcher, in the producer thread) and
TTAEngine.stage_batch_fused (bucket padding, sampling boxes, upload)."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('decode', 'stage')]
    if any(p is None for p in parts):
        return None
    return sum(parts)
