"""90th percentile, over every request completed in the window, of (its
completion less its first token) over its tokens less one, as the engine
times them."""

import numpy as np


def read(obs):
    start, end = obs.window_span()
    tpot = [r.latency_s / (len(r.tokens) - 1) for r in obs.reqs.values()
            if r.tokens is not None and len(r.tokens) > 1 and start < r.end <= end]
    return float(np.percentile(tpot, 90)) * 1e3 if tpot else None
