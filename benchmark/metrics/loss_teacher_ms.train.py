"""The EMA teacher and the loss a step, ms by CUDA events: the EMA update and
the teacher's forward ("caption" to "teacher") and the recipe's loss
("prompt forward" to "loss", ops/losses)."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('loss_teacher',)]
    if any(p is None for p in parts):
        return None
    return sum(parts)
