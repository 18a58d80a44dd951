"""Engine: the mean number of rows the window's decode steps ran (``step()``'s
return, over the steps that decoded)."""


def read(obs):
    rows = [obs.steps[i].rows for i in obs.window_steps() if obs.steps[i].rows]
    return sum(rows) / len(rows) if rows else None
