"""The one traffic generator: turns a traffic file (``traffic/<name>.json``)
and a seed into requests.

Every seed gets the same work in another order. Lengths and inter-arrival
gaps are drawn in blocks of ``block`` requests: each block holds the same
``block`` quantiles of the distribution (at (i + 0.5) / block), in an order
drawn from the seed, so that any whole number of blocks holds the same
lengths whatever the seed. Token ids are drawn from the seed, uniform over
``[1, vocab)`` (id 0 is the engine's padding).

Keys of a traffic file:

* ``loop``: ``"closed"`` (``clients`` callers, each sending its next request
  when its last one completes; the first of them join one after another over
  ``stagger_s``, and the window opens ``ramp_s`` after the first) or
  ``"open"`` (arrivals at ``rate`` a second, due whether or not the engine
  keeps up; the window opens ``warmup_s`` after the first): exponential
  gaps, stratified as the lengths are, so a block's arrivals are as a
  Poisson process's within it and their count is the same in every block;
* ``prompt``, ``output``: a length distribution, ``{"dist": "uniform",
  "min", "max"}`` or ``{"dist": "lognormal", "median", "sigma", "min",
  "max"}`` (clipped), in tokens, rounded up to a multiple of ``multiple_of``
  where that is given (not past ``max``); with ``prefix`` the prompt length
  is that of the turn after the shared prefix;
* ``prefix`` (optional): ``{"count", "tokens", "shares"}``: ``count`` shared
  prompts of ``tokens`` tokens, drawn once from the seed; each request starts
  with one of them, chosen with ``shares`` (each block holds each prefix
  ``shares[i] * block`` times, rounded by largest remainder);
* ``block``: requests per block; ``requests`` (closed loop): how many to make;
* ``why``, ``sources``: what the mix stands for and where each parameter
  comes from (read by no code).

Every request is greedy (the engine's temperature 0).
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Item:
    rid: int
    prompt: List[int]
    max_new: int
    due: Optional[float] = None  # seconds after the schedule starts (open loop)
    prefix: Optional[int] = None  # which shared prefix it starts with


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The ``n`` quantiles at (i + 0.5) / n of a length distribution, as ints."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        x = dist["min"] + (dist["max"] - dist["min"]) * u
    elif dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    x = np.clip(np.rint(x), dist["min"], dist["max"])
    step = dist.get("multiple_of", 1)
    return np.minimum(np.ceil(x / step) * step, dist["max"] // step * step).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """The ``n`` quantiles of an exponential gap of mean 1 / ``rate``."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def share_counts(shares, n: int) -> List[int]:
    """``shares`` of ``n`` as whole counts summing to ``n`` (largest remainder)."""
    raw = [s * n / sum(shares) for s in shares]
    counts = [math.floor(r) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])[: n - sum(counts)]:
        counts[i] += 1
    return counts


def _blocks(rng: np.random.Generator, base: np.ndarray, n: int) -> np.ndarray:
    """``n`` values: whole blocks of ``base``, each in an order drawn from ``rng``."""
    reps = -(-n // len(base))
    return np.concatenate([rng.permutation(base) for _ in range(reps)])[:n]


def generate(traffic: dict, vocab: int, seed: int, n: int) -> List[Item]:
    """The first ``n`` requests of the mix for ``seed``; open-loop items carry
    their due time."""
    block = traffic["block"]
    rng = np.random.default_rng([seed, 1])
    tok = np.random.default_rng([seed, 2])
    lengths = _blocks(rng, quantiles(traffic["prompt"], block), n)
    outputs = _blocks(rng, quantiles(traffic["output"], block), n)
    pre = traffic.get("prefix")
    if pre:
        prefixes = [tok.integers(1, vocab, pre["tokens"]).tolist() for _ in range(pre["count"])]
        base = np.repeat(np.arange(pre["count"]), share_counts(pre["shares"], block))
        which = _blocks(rng, base, n)
    due = None
    if traffic["loop"] == "open":
        due = np.cumsum(_blocks(rng, exp_gaps(traffic["rate"], block), n))
        due -= due[0]  # the first request is due when the schedule starts
    items = []
    for i in range(n):
        prompt = tok.integers(1, vocab, int(lengths[i])).tolist()
        k = None
        if pre:
            k = int(which[i])
            prompt = prefixes[k] + prompt
        items.append(Item(i, prompt, int(outputs[i]), None if due is None else float(due[i]), k))
    return items


def open_count(traffic: dict, horizon_s: float) -> int:
    """How many open-loop requests to make so that the schedule outlasts ``horizon_s``."""
    return int(math.ceil(traffic["rate"] * horizon_s * 1.25)) + traffic["block"]
