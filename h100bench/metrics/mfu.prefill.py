"""Model step: the operations the window's prefills need (a causal pass over
each prompt's tokens past the longest run of full pages an earlier prompt
began with; no padding; one row of logits; ``h100bench.work``) over their
synchronised time at the bf16 peak, in %. Calls inside the profiled stretch
are left out."""

from h100bench.peaks import BF16_FLOPS


def read(obs):
    p = obs.probe
    if p is None:
        return None
    start, end = obs.window_span()
    calls = [(t1 - t0, f) for t0, t1, f, _, profiled in p.prefills if start <= t0 <= end and not profiled]
    secs = sum(s for s, _ in calls)
    return 100.0 * sum(f for _, f in calls) / (secs * BF16_FLOPS) if secs else None
