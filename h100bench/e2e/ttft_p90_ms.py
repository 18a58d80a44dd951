"""90th percentile, over every request due in the window (open loop), of its
first token's time less its due time; a request without a first token by the
window's end counts with the window's end less its due time."""

import numpy as np


def read(obs):
    if obs.loop != "open":
        return None
    _, end = obs.window_span()
    ttft = [min(r.first if r.first is not None else end, end) - r.due
            for r in obs.reqs.values() if obs.open_t <= r.due < obs.close_t]
    return float(np.percentile(ttft, 90)) * 1e3 if ttft else None
