"""Kernels: the least time of the profiled ``ops.flash_attention`` calls (the
larger of their causal operations at the bf16 peak and their bytes at the
HBM peak; ``h100bench.work.flash_work``) over their device time, in %."""

from h100bench.trace import roofline_share


def read(obs):
    if obs.trace is None:
        return None
    return roofline_share(obs.probe.flash, obs.trace["calls"])
