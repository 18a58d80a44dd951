"""Page bookkeeping: prompt tokens the allocator served from shared prefix
pages (its ``stats["shared"]`` pages, times the page's tokens) as a share of
the prompt tokens prefilled in the window, in %."""


def read(obs):
    p = obs.probe
    idx = obs.window_steps()
    if p is None or not p.shared_pages or not idx:
        return None
    start, end = obs.window_span()
    tokens = sum(real for t0, _, _, real, _ in p.prefills if start <= t0 <= end)
    if not tokens:
        return None
    pages = p.shared_pages[idx[-1] + 1][1] - p.shared_pages[idx[0]][1]
    return 100.0 * pages * p.T / tokens
