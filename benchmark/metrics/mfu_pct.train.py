"""The training step's share of the card's fp32 peak, %: the operations of
the window's steps (benchmark/work.py train_step_flops) at 67 TFLOP/s (TF32
stays off) over the window's wall time."""


def read(obs):
    ideal, wall = obs.work.get("ideal_s"), obs.work.get("wall_s")
    if not ideal or not wall:
        return None
    return 100.0 * ideal / wall
