"""The training step, the counterpart of :mod:`repro.train.trainer`, on one
device: loss, gradients (microbatches accumulated in f32), AdamW."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, leaves

_SHARDED = "sharded training is not ported yet (ROADMAP Queue 1, item 6)"


def _requires_grad(tree):
    """The params as leaves that autograd differentiates (views of the same
    storage, so nothing is copied)."""
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def make_train_step(model, cfg: ModelConfig, opt_cfg: AdamWConfig, axis_info=None, param_shardings=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` and the optimizer's moments are updated in place.

    ``cfg.grad_accum > 1`` splits the batch into ``A`` microbatches, ``A``
    the largest count up to ``grad_accum`` that divides the batch (as the
    JAX package's rule on one device): the first runs on its own, then the
    rest, their gradients summed in f32 and divided by ``A``, the loss and
    the metrics averaged. ``metrics`` holds the model's metrics, ``loss``,
    ``grad_norm`` and ``lr`` as 0-dim tensors on the device."""
    if axis_info is not None or param_shardings is not None:
        raise NotImplementedError(_SHARDED)

    def grad_of(params, batch):
        tracked = _requires_grad(params)
        loss, metrics = model.train_loss(tracked, batch)
        grads = torch.autograd.grad(loss, leaves(tracked))
        # contiguous f32 tensors of their own, so that later microbatches add into them
        return loss.detach(), {k: m.detach() for k, m in metrics.items()}, [g.float().contiguous() for g in grads]

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        B0 = next(iter(batch.values())).shape[0]
        A = max(1, min(cfg.grad_accum, B0))
        while A > 1 and B0 % A:
            A -= 1
        micro = [{k: v[i * (B0 // A):(i + 1) * (B0 // A)] for k, v in batch.items()} for i in range(A)]
        loss, metrics, grads = grad_of(params, micro[0])
        for mb in micro[1:]:
            l, m, g = grad_of(params, mb)
            for acc, gg in zip(grads, g):
                acc.add_(gg)
            loss = loss + l
            metrics = {k: metrics[k] + m[k] for k in metrics}
        if A > 1:
            a = torch.full((), A, dtype=torch.float32, device=loss.device)
            for acc in grads:
                acc.div_(a)
            loss = loss / a
            metrics = {k: v / a for k, v in metrics.items()}
        params, opt_state, opt_metrics = adamw_update(params, _unflatten(params, grads), opt_state, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def _unflatten(template, flat: list):
    """``flat`` (in :func:`leaves` order) as a tree shaped like ``template``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def init_train_state(model, seed: int = 0, device="cuda") -> Tuple[Any, Any]:
    """(params, opt_state) from ``model.init(seed, device)`` in the
    config's param dtype."""
    params = model.init(seed=seed, device=device)
    return params, adamw_init(params)
