"""The training step, the counterpart of :mod:`repro.train.trainer`: loss,
gradients (microbatches accumulated in f32), AdamW; on one device or
across the ranks of a mesh."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives
from repro_torch.parallel.axisinfo import AxisInfo
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, leaves

def _requires_grad(tree):
    """The params as leaves that autograd differentiates (views of the same
    storage, so nothing is copied)."""
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def n_microbatches(batch_rows: int, grad_accum: int, n_batch_shards: int = 1) -> int:
    """The JAX package's rule: the most microbatches up to ``grad_accum``
    that divide the batch into microbatches that divide over the batch
    shards; 1 when the batch is smaller than the shard count."""
    A = max(1, min(grad_accum, batch_rows // max(n_batch_shards, 1)))
    while A > 1 and (batch_rows % A or (batch_rows // A) % n_batch_shards):
        A -= 1
    return A


def reduce_gradients(grads: List[torch.Tensor], axis_info: AxisInfo, held: List[tuple]) -> None:
    """Sum this rank's f32 gradients over the batch axes, in place, in a few
    flat buffers (:func:`collectives.psum_`): each leaf over the batch axes
    it is not split over (``held``, from :func:`held_axes`). A leaf split
    over ``data`` was summed there by its FSDP gather's backward (the
    reduce-scatter), so it is summed over ``pod`` only, where the mesh has
    one; a second sum would double it. The sums are the ones GSPMD
    inserts."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for g, axes in zip(grads, held):
        groups.setdefault(tuple(a for a in axis_info.batch_axes if a not in axes), []).append(g)
    for axes, group in groups.items():
        if axes:
            collectives.psum_(group, axes, axis_info.mesh)


def held_axes(params, cfg: ModelConfig, axis_info: AxisInfo) -> List[tuple]:
    """For each leaf of ``params`` in :func:`leaves` order, the mesh axes it
    is split over on this rank (empty: replicated), in mesh order, read from
    its shape (:func:`repro_torch.parallel.sharding.held_specs`)."""
    from repro_torch.parallel.sharding import held_specs

    out = []
    for spec in leaves(held_specs(params, cfg, axis_info)):
        axes = []
        for e in spec:
            axes += [] if e is None else [e] if isinstance(e, str) else list(e)
        out.append(axis_info.mesh.ordered(axes))
    return out


def _global_norm(grads: List[torch.Tensor], split: List[tuple], axis_info: AxisInfo) -> torch.Tensor:
    """The norm of the whole gradient: each split leaf's sum of squares
    summed over the axes it is split over (one all-reduce for each such
    set of axes), the replicated leaves' counted once."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    parts: Dict[tuple, torch.Tensor] = {}
    for g, axes in zip(grads, split):
        sq = torch.sum(torch.square(g.float()))
        if axes:
            parts[axes] = parts.get(axes, 0) + sq
        else:
            total = total + sq
    for axes, sq in parts.items():
        total = total + collectives.psum(sq, axes, axis_info.mesh)
    return torch.sqrt(total)


def _rounds(batch: Dict[str, torch.Tensor], A: int, axis_info: AxisInfo) -> list:
    """This rank's rounds of a step on its block of rows (``batch``, of a
    global batch split into ``A`` microbatches over ``n`` batch shards):
    ``(rows, denom)`` a round. The global batch falls into ``A * n`` groups
    of ``B / (A n)`` rows, group ``a*n + j`` the rows the JAX step hands data
    shard ``j`` of microbatch ``a``; the rank's block is groups ``i*A ...
    i*A + A - 1``, so in round ``t`` it runs group ``i*A + t`` as that
    shard, and nothing moves. ``denom`` is the count of valid labels in the
    group's microbatch: each rank counts its groups', and one all-reduce
    of the ``A * n`` counts gives every microbatch's."""
    n, mesh = axis_info.n_batch_shards, axis_info.mesh
    i = mesh.axes_index(axis_info.batch_axes)
    g = next(iter(batch.values())).shape[0] // A
    groups = [{k: v[t * g:(t + 1) * g] for k, v in batch.items()} for t in range(A)]
    mine = torch.stack([(grp["labels"] >= 0).sum() for grp in groups]).float()  # exact: below 2**24 labels
    counts = collectives.regather(mine, axis_info.batch_axes, mesh).reshape(A, n).sum(dim=1)
    counts = counts.long().clamp_min(1)
    return [(grp, counts[(i * A + t) // n]) for t, grp in enumerate(groups)]


def make_train_step(model, cfg: ModelConfig, opt_cfg: AdamWConfig, axis_info: Optional[AxisInfo] = None,
                    param_shardings=None):
    """Returns ``train_step(params, opt_state, batch, global_rows=None) ->
    (params, opt_state, metrics)``; ``params`` and the optimizer's moments
    are updated in place. ``global_rows`` is the global batch's rows: by
    default ``batch``'s own, and required across batch shards.

    ``cfg.grad_accum > 1`` splits the batch into ``A`` microbatches
    (:func:`n_microbatches`): the first runs on its own, then the rest,
    their gradients summed in f32 and divided by ``A``, the loss and the
    metrics averaged. ``metrics`` holds the model's metrics, ``loss``,
    ``grad_norm`` and ``lr`` as 0-dim tensors on the device.

    Across ranks (``axis_info``), ``params`` are this rank's blocks in
    either layout of :mod:`repro_torch.parallel.sharding` (the JAX
    package's ``param_shardings``, or the experts alone split over the
    model axis); the moments are blocks of the same shapes. ``batch`` is
    this rank's ``batch_shardings`` block of the global batch of
    ``global_rows``: its rows over the batch axes. Each rank trains on the
    rows the JAX step hands its data shards, with no row moving
    (:func:`_rounds`): in round ``t`` rank ``i`` runs JAX's data shard ``j``
    of microbatch ``a``, ``a*n + j = i*A + t``, which are rows of its own
    block, its loss divided by the count of that microbatch's labels.
    ``batch`` may also be the global batch (``global_rows`` its own rows),
    as ``batch_shardings`` keeps a batch whose rows do not divide over the
    batch shards: then each microbatch is a slice of it and each rank
    computes on every row of it, or, where they divide, on its block of
    them (``train_loss(axis_info=)``: rows ``a*B/A + i*B/(A*n) ...``). A
    batch of any other size raises.
    Either way each layer's ``data`` blocks are gathered in the forward
    and their gradients reduce-scattered in the backward. After the
    accumulation each gradient is summed over the batch axes it is not
    split over (:func:`reduce_gradients`), the loss and metrics over every
    batch axis (one all-reduce); the norm that clips the update counts each
    block once. Leaves replicated over an axis then end the step equal over
    it, bit for bit. ``param_shardings`` is taken for the JAX package's
    signature, where it is a layout hint with no numeric effect; the port
    reads the layout from the leaves' shapes (:func:`held_axes`)."""
    n_shards = axis_info.n_batch_shards if axis_info is not None else 1

    def grad_of(params, batch, denom=None):
        tracked = _requires_grad(params)
        loss, metrics = model.train_loss(tracked, batch, axis_info=axis_info, denom=denom)
        grads = torch.autograd.grad(loss, leaves(tracked))
        # contiguous f32 tensors of their own, so that later microbatches add into them
        return loss.detach(), {k: m.detach() for k, m in metrics.items()}, [g.float().contiguous() for g in grads]

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor], global_rows: Optional[int] = None):
        B0 = next(iter(batch.values())).shape[0]
        if global_rows is None:
            if n_shards > 1:
                raise ValueError(f"across {n_shards} batch shards the step needs global_rows: a batch of {B0} "
                                 f"rows may be the global batch or this rank's block of it")
            global_rows = B0
        if global_rows not in (B0, B0 * n_shards):
            raise ValueError(f"a batch of {B0} rows is neither the global batch of {global_rows} rows nor a "
                             f"rank's block of it over {n_shards} batch shards")
        A = n_microbatches(global_rows, cfg.grad_accum, n_shards)
        if global_rows == B0:  # the global batch (or one batch shard): the microbatches as slices
            micro = [(mb, None) for mb in ({k: v[i * (B0 // A):(i + 1) * (B0 // A)] for k, v in batch.items()}
                                           for i in range(A))]
        else:
            micro = _rounds(batch, A, axis_info)
        loss, metrics, grads = grad_of(params, *micro[0])
        for mb in micro[1:]:
            l, m, g = grad_of(params, *mb)
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
        gnorm = None
        if axis_info is not None:
            split = held_axes(params, cfg, axis_info)
            reduce_gradients(grads, axis_info, split)
            names = sorted(metrics)
            total = collectives.psum(torch.stack([loss] + [metrics[k].float() for k in names]),
                                     axis_info.batch_axes, axis_info.mesh)
            loss, metrics = total[0], {k: total[i + 1] for i, k in enumerate(names)}
            gnorm = _global_norm(grads, split, axis_info)
        params, opt_state, opt_metrics = adamw_update(params, _unflatten(params, grads), opt_state, opt_cfg,
                                                      gnorm=gnorm)
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
