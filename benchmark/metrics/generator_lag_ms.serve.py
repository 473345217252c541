"""How late the load generator sent, ms: the 95th percentile over the
window's requests of the time from a request's due time to the moment its
client thread began to send it (the benchmark's own generator)."""

import numpy as np


def read(obs):
    lag = obs.spans.get("send_lag")
    if not lag:
        return None
    return 1e3 * float(np.quantile(np.asarray(lag), 0.95, method="higher"))
