"""The prompt branch a step, ms by CUDA events: the student's prompt features
and logits ("teacher" to "prompt forward") and the autograd backward to the
context vectors ("loss" to "backward"); models/prompt, models/text."""


def read(obs):
    parts = [obs.mean_ms(n) for n in ('prompt_branch',)]
    if any(p is None for p in parts):
        return None
    return sum(parts)
