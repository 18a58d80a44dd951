"""AdamW, the counterpart of :mod:`repro.train.optimizer`, on one device.

Every number is computed as the JAX package computes it: the warm-up and
cosine schedule and the bias corrections in f32 tensors on the device, from
the 0-dim int32 ``step`` on the device (no host synchronisation, and no
Python doubles, which would round differently), the update in f32, the
params written back in their own dtype. The state is updated in place, as
the JAX launcher donates it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(x: float, device) -> torch.Tensor:
    """A 0-dim f32 constant on ``device``, filled there: a divisor must be a
    device tensor (CUDA divides by a Python scalar as a multiplication by
    its reciprocal, and ``scalar / tensor`` is a reciprocal times the
    scalar on every device)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of ``lr``: an f32
    0-dim tensor on ``step``'s device."""
    dev = step.device
    warm = (step / _f32(max(cfg.warmup_steps, 1), dev)).clamp_max(1.0)
    t = ((step - cfg.warmup_steps) / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev)).clamp(0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree) -> list:
    """The tensors of a tree of dicts, in the JAX package's order (sorted
    keys)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def adamw_init(params):
    """``{"m", "v"}``: f32 zeros shaped like each param; ``"step"``: a 0-dim
    int32 zero on the params' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    dev = leaves(params)[0].device
    return {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


def _chunks(*ts: torch.Tensor, size: int = 1 << 24):
    """Matching flat chunks of ``size`` elements of same-shaped tensors
    (views: writes reach the tensors); the tensors whole when one is not
    contiguous."""
    if not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for a in range(0, flat[0].numel(), size):
        yield tuple(t[a:a + size] for t in flat)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, gnorm: Optional[torch.Tensor] = None):
    """One AdamW step: gradients clipped to a global norm of
    ``grad_clip``, bias-corrected moments, decoupled weight decay. ``params``
    and ``state``'s moments are updated in place; returns (params, the new
    state, ``{"grad_norm", "lr"}``). ``gnorm``, when given, is the global
    norm of the whole gradient (across ranks, of which ``grads`` holds this
    rank's blocks); by default the norm of ``grads``."""
    step = state["step"] + 1
    dev = step.device
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (_f32(cfg.grad_clip, dev) / gnorm.clamp_min(1e-12)).clamp_max(1.0)
    lr = lr_at(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(_f32(b1, dev), step.float())
    bc2 = 1 - torch.pow(_f32(b2, dev), step.float())
    for leaf in zip(leaves(params), leaves(grads), leaves(state["m"]), leaves(state["v"])):
        # elementwise, so a chunk at a time gives the same numbers with a chunk's temporaries
        for p, g, m, v in _chunks(*leaf):
            g = g.float() * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gnorm, "lr": lr}
