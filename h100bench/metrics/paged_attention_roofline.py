"""Kernels: the least time of the profiled ``ops.paged_attention`` calls
(each visible key and value row, each query and output once, at the HBM
peak; ``h100bench.work.paged_bytes``) over their device time, in %."""

from h100bench.trace import roofline_share


def read(obs):
    if obs.trace is None:
        return None
    return roofline_share(obs.probe.paged, obs.trace["calls"])
