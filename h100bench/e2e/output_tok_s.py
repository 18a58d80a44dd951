"""Tokens the engine emitted in the window (each step's decoded rows plus the
first tokens of the requests it admitted) over the window's seconds."""


def read(obs):
    idx = obs.window_steps()
    if not idx:
        return None
    start, end = obs.window_span()
    return sum(obs.steps[i].rows + obs.admitted(i) for i in idx) / (end - start)
