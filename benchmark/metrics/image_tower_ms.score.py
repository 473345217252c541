"""The image tower a batch, ms by CUDA events around TTAEngine._features
(models/resnet or models/vit, with the dense features)."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('image_tower',)]
    if any(p is None for p in parts):
        return None
    return sum(parts)
