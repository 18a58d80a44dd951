"""Process start to the window's opening: imports, the kernels built or
loaded, weights drawn on the card, the pool allocated, each prompt length
served once, and the warm-up or ramp of the traffic."""


def read(obs):
    return obs.setup_s
