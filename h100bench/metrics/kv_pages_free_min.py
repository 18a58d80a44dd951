"""Page bookkeeping: the fewest free pages the allocator held before any of
the window's steps."""


def read(obs):
    p = obs.probe
    idx = obs.window_steps()
    if p is None or not p.pages_free or not idx:
        return None
    return min(p.pages_free[i][1] for i in idx)
