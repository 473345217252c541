"""The whole scoring step's share of the card's peak, %: every operation of
the window's batches (resize at its taps, the tower, retrieval, every
member's logits; benchmark/work.py score_batch_ideal_s), each at the peak of
the dtype it runs in, over the window's wall time."""


def read(obs):
    ideal, wall = obs.work.get("ideal_s"), obs.work.get("wall_s")
    if not ideal or not wall:
        return None
    return 100.0 * ideal / wall
