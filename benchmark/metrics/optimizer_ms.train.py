"""The optimizer a step, ms by CUDA events from the "backward" mark to the
"optimizer" mark: engine/train_state's SGD with momentum and weight decay
over the prompt leaves."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('optimizer',)]
    if any(p is None for p in parts):
        return None
    return sum(parts)
