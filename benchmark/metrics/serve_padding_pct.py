"""The service's batch fill loss, %: rows padded by repetition over all rows
dispatched during the window (cli/serve.ServiceStats' dispatch counters, read
before and after the window)."""


def read(obs):
    real, pad = obs.counters.get("dispatch_images"), obs.counters.get("dispatch_padding")
    if real is None or pad is None or real + pad == 0:
        return None
    return 100.0 * pad / (real + pad)
