"""The device's idle share, %: the part of the profiler's window in which no
operation ran on the card (torch.profiler's device timeline, the union of
every kernel's and copy's interval)."""


def read(obs):
    busy, window = obs.trace.get("busy_s"), obs.trace.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
