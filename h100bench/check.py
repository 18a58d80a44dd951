"""Decides ``correct``: the served tokens of a sample of the window's
requests, held to the plain reference.

The sample is drawn from the seed among the requests completed since the
window opened, the one with the most served tokens always in it, until it
holds ``sample_tokens`` served tokens. The reference runs once over each
prompt followed by its served tokens, and each served token's gap is how far
its reference logit lies below the reference's best at that position, in
units of the standard deviation of the reference's logits there (0 for the
reference's own greedy choice; a unit that does not change with the
model's width). Every number is compared with its limit
in ``limits/<workload>.json``:

* ``gap_max``: the widest gap over the sample;
* ``gap_p90``: the 90th percentile of the gaps over the sample's served
  tokens (where bf16 rounding alone flips routes of a mixture of experts,
  the widest gap of a sound run comes near the control's; a sound run's
  flips are rare and near ties, the control's are common and wide, so the
  90th percentile separates them);
* ``gap_mean``: the mean gap over the sample's served tokens;
* ``wrong_lengths``: completed requests that did not serve exactly the
  tokens asked for (limit 0).

A cell's limits file names the numbers it compares; the others are printed.

The control (:func:`control_gaps`, run by ``control.py`` and the tests, not
by a benchmark run) puts the reference in fp8 in the program's place: at
each position of the same sequences, the gap of the token it puts first.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def sample(obs, limits: dict, seed: int) -> list:
    done = sorted((r for r in obs.reqs.values() if r.tokens is not None and r.end >= obs.open_t),
                  key=lambda r: r.item.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.item.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed, 3]).permutation(len(rest))
    picked, n = [longest], len(longest.tokens)
    for i in order:
        if n >= limits["sample_tokens"] or len(picked) >= limits["max_requests"]:
            break
        picked.append(rest[i])
        n += len(rest[i].tokens)
    return picked


def _sequences(picked, device):
    seqs, rows = [], []
    for r in picked:
        p = len(r.item.prompt)
        seqs.append(torch.tensor(r.item.prompt + r.tokens[:-1], dtype=torch.long, device=device))
        rows.append(slice(p - 1, p - 1 + len(r.tokens)))
    return seqs, rows


def reference_gaps(ref, params, model: dict, picked, device) -> List[np.ndarray]:
    """Each sampled request's served tokens' gaps under the float32 reference."""
    seqs, rows = _sequences(picked, device)
    out = []
    for r, lg in zip(picked, ref.logits(params, model, seqs, rows, "f32")):
        served = torch.tensor(r.tokens, dtype=torch.long, device=lg.device)
        out.append(_gap(lg, served))
    return out


def _gap(lg: torch.Tensor, tokens: torch.Tensor):
    """How far each token's logit lies below the row's best, in units of the row's spread."""
    return ((lg.max(dim=-1).values - lg.gather(1, tokens[:, None])[:, 0]) / lg.std(dim=-1)).cpu().numpy()


def control_gaps(ref, params, model: dict, picked, device, precision: str = "fp8") -> List[np.ndarray]:
    """The gaps, under the float32 reference, of the tokens the reference in
    ``precision`` (the control: fp8) puts first."""
    seqs, rows = _sequences(picked, device)
    exact = ref.logits(params, model, seqs, rows, "f32")
    low = ref.logits(params, model, seqs, rows, precision)
    return [_gap(e, l.argmax(dim=-1)) for e, l in zip(exact, low)]


def numbers(obs, gaps: List[np.ndarray]) -> Dict[str, float]:
    served = np.concatenate(gaps) if gaps else np.zeros(0)
    wrong = sum(1 for r in obs.reqs.values() if r.tokens is not None and len(r.tokens) != r.item.max_new)
    empty = not served.size
    return {"gap_max": float("inf") if empty else float(served.max()),
            "gap_p90": float("inf") if empty else float(np.percentile(served, 90)),
            "gap_mean": float("inf") if empty else float(served.mean()),
            "wrong_lengths": wrong, "tokens_compared": int(served.size)}


def verdict(nums: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """``{name: {"value", "limit"}}`` of every number compared."""
    return {k: {"value": nums[k], "limit": lim} for k, lim in limits["limits"].items()}


def passed(checked: Dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in checked.values())
