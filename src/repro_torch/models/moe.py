"""Top-k MoE with capacity-based gather dispatch, the single-device
counterpart of :mod:`repro.models.moe`.

Each token's top-k assignments are ranked within their expert by a stable
sort and placed into a bounded per-expert slot buffer of capacity ``C``
(assignments past it are dropped, as in the JAX package); the slots gather
their tokens' rows, the experts run as three batched products, and the
outputs are scattered back to the tokens weighted by their renormalised
gate. No step reads a tensor on the host: shapes, the capacity and every
index come from static shapes or stay on the device, so a decode step stays
capturable by a CUDA graph.

Under an ``axis_info`` (the JAX package's ``shard_map`` branch) the expert
weights are this rank's shard (:func:`repro_torch.parallel.sharding.shard_params`),
chosen by whether the experts divide the model axis:

* **EP** (``E % tp == 0``): the rank owns ``E/tp`` whole experts, the
  experts ``[axis_index(model) * E/tp, ...)``, with full ``d_ff``;
* **expert-TP**: the rank holds every expert's ``d_ff/tp`` columns.

Both run the same local dispatch; the partial outputs are summed over the
model axis. Tokens are split over the batch axes when they divide them
(else every rank routes all of them, as the JAX package's tiny decode
batches), and the output is regathered on every rank. In training
(``local_batch=True``) the tokens are already this rank's data shard: it
routes all of them, and the output is only summed over the model axis.
Either way the capacity counts the tokens the rank routes, and the aux
loss is averaged over the batch axes (the JAX package's ``shard_map``
body). Under autograd the collectives are those of
:mod:`repro_torch.parallel.collectives` that state their backward: the
tokens and gates entering this rank's experts get the other model ranks'
parts of their gradient (:func:`collectives.grad_psum`); the aux, computed
from the whole replicated gates, does not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import dense_init
from repro_torch.parallel import collectives
from repro_torch.parallel.axisinfo import AxisInfo


def moe_init(gen: torch.Generator, cfg: ModelConfig):
    """Router ``(d, E)`` in f32 (the gates are computed in f32), experts
    ``w1``/``wg`` ``(E, d, f)`` and ``w2`` ``(E, f, d)`` in ``param_dtype``,
    drawn expert by expert."""
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.pdtype()
    router = dense_init(gen, d, (E,), torch.float32)
    return {
        "router": router,
        "w1": torch.stack([dense_init(gen, d, (f,), dt) for _ in range(E)]),
        "wg": torch.stack([dense_init(gen, d, (f,), dt) for _ in range(E)]),
        "w2": torch.stack([dense_init(gen, f, (d,), dt) for _ in range(E)]),
    }


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens, from static shapes only."""
    return max(int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 4)


def _moe_local(
    x: torch.Tensor,  # (T, d)
    router: torch.Tensor,  # (d, E)
    w1: torch.Tensor,  # (E_loc, d, f)
    wg: torch.Tensor,
    w2: torch.Tensor,  # (E_loc, f, d)
    cfg: ModelConfig,
    *,
    first_expert: int = 0,
    n_local_experts: int,
    expert_inputs=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch -> expert products -> combine. Returns (out (T, d) in x's
    dtype, the Switch load-balance aux loss as an f32 scalar).
    ``expert_inputs(x, gates) -> (x, gates)``, when given, maps the tokens
    and gates that the experts' path reads (not the aux's)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    ct = cfg.cdtype()
    dev = x.device

    gates = x.float() @ router.float()  # (T, E)
    probs = torch.softmax(gates, dim=-1)
    if expert_inputs is not None:
        x, gates = expert_inputs(x, gates)
    top_w, top_e = torch.topk(gates, k, dim=-1)  # (T, k)
    top_w = torch.softmax(top_w, dim=-1)  # renormalised over the chosen experts

    flat_e = top_e.reshape(-1)  # (T*k,) expert of each assignment
    counts = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    aux = E * torch.sum(counts / (T * k) * probs.mean(dim=0))

    C = capacity(T, cfg)
    # rank of each assignment within its expert, in token order
    idx_sorted = torch.sort(flat_e, stable=True).indices
    start = torch.cumsum(counts, dim=0) - counts  # first sorted position of each expert
    rank_sorted = torch.arange(T * k, device=dev) - start[flat_e[idx_sorted]].long()
    pos_in_e = torch.empty_like(rank_sorted).scatter_(0, idx_sorted, rank_sorted)

    local_e = flat_e - first_expert
    keep = (pos_in_e < C) & (local_e >= 0) & (local_e < n_local_experts)
    n_slots = n_local_experts * C
    slot = torch.where(keep, local_e * C + pos_in_e, torch.full_like(pos_in_e, n_slots))

    # gather-style dispatch: slot -> source token (T = empty); a dropped
    # assignment lands in the extra last row, which is sliced off
    token_idx = torch.arange(T * k, device=dev) // k
    slot_token = torch.full((n_slots + 1,), T, dtype=torch.long, device=dev).scatter_(
        0, slot, token_idx)[:n_slots]
    slot_valid = slot_token < T
    src = slot_token.clamp(max=T - 1)
    xg = torch.where(slot_valid[:, None], x[src], torch.zeros((), dtype=x.dtype, device=dev))
    disp = xg.reshape(n_local_experts, C, d).to(ct)

    h = torch.bmm(disp, w1.to(ct))
    g = torch.bmm(disp, wg.to(ct))
    h = torch.nn.functional.silu(g) * h
    out_slots = torch.bmm(h, w2.to(ct)).reshape(n_slots, d)

    # combine: each slot's output back to its token, weighted by its gate
    slot_w = torch.zeros((n_slots + 1,), dtype=torch.float32, device=dev).scatter_(
        0, slot, top_w.reshape(-1))[:n_slots]
    weighted = out_slots.float() * (slot_w * slot_valid)[:, None]
    out = torch.zeros((T, d), dtype=torch.float32, device=dev).index_add_(0, src, weighted)
    return out.to(x.dtype), aux


def use_expert_parallel(cfg: ModelConfig, tp: int) -> bool:
    """EP when the experts divide the model axis, else per-expert ffn TP
    when ``d_ff`` does; neither raises."""
    if cfg.n_experts % tp == 0:
        return True
    if cfg.d_ff % tp == 0:
        return False
    raise ValueError(f"neither experts ({cfg.n_experts}) nor d_ff ({cfg.d_ff}) divide tp={tp}")


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo] = None,
            local_batch: bool = False):
    """MoE feed-forward. Returns (out (B, S, d), aux scalar).

    With ``axis_info``: this rank routes its block of the ``B*S`` tokens
    over the batch axes (all of them when they do not divide), through its
    experts (EP) or its ffn columns (expert-TP); the outputs are summed
    over the model axis and regathered over the batch axes in one
    all-reduce (:func:`collectives.gather_blocks`), and ``aux`` is averaged
    over the batch axes (it is the same on every model rank: the router is
    replicated). With ``local_batch`` the ``x`` given is this rank's data
    shard already (training): all of it is routed, and the output is only
    summed over the model axis."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    if axis_info is None:
        out, aux = _moe_local(
            xf, params["router"], params["w1"], params["wg"], params["w2"], cfg,
            first_expert=0, n_local_experts=cfg.n_experts,
        )
        return out.reshape(B, S, d), aux
    mesh, ma = axis_info.mesh, axis_info.model_axis
    tp = mesh.shape[ma]
    ep = use_expert_parallel(cfg, tp)
    n_local = cfg.n_experts // tp if ep else cfg.n_experts
    want = (n_local, d, cfg.d_ff if ep else cfg.d_ff // tp)
    if tuple(params["w1"].shape) != want:
        raise ValueError(f"moe_ffn: w1 {tuple(params['w1'].shape)} is not this rank's shard {want} "
                         "(repro_torch.parallel.sharding.shard_params)")
    batch_axes = axis_info.batch_axes
    n_batch = collectives.axis_size(batch_axes, mesh)
    if local_batch:
        gather_axes, rows, i = (), B * S, 0
    else:
        gather_axes = batch_axes if (B * S) % n_batch == 0 else ()  # tiny decode batches: replicate tokens
        rows = B * S // collectives.axis_size(gather_axes, mesh)
        i = collectives.axis_index(gather_axes, mesh) if gather_axes else 0
    first = collectives.axis_index(ma, mesh) * n_local if ep else 0
    out, aux = _moe_local(
        xf[i * rows:(i + 1) * rows], params["router"], params["w1"], params["wg"], params["w2"], cfg,
        first_expert=first, n_local_experts=n_local,
        expert_inputs=lambda xx, gates: collectives.grad_psum(ma, mesh, xx, gates),
    )
    out = collectives.gather_blocks(out, gather_axes, mesh, sum_names=(ma,))
    if local_batch or gather_axes:
        aux = collectives.mean_of_shares(aux, batch_axes, mesh)
    return out.reshape(B, S, d), aux
