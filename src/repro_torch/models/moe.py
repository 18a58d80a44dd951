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
batches), and the output is regathered on every rank. In training and
prefill (``local_batch=True``) the tokens are already this rank's data
shard: it routes all of them, and the output is only summed over the model
axis. There the ``"jax"`` layout's ``data`` blocks of the router and the
experts have been gathered with the layer, so the weights' ``embed`` dims
are whole.

In decode in the ``"jax"`` layout the expert weights' and the router's
``embed`` dims are this rank's block over ``data`` too, and no weight
leaves its rank: every rank routes every token, in the groups the JAX
package routes them in (one a batch shard: capacity and ranking count a
group's tokens), and each product is a partial over ``data``, summed (the
gates, then the experts' hidden activations) before the activation; the
output is summed over ``model`` and regathered over ``data``.
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
from repro_torch.models.layers import block_of
from repro_torch.models.modules import dense_init
from repro_torch.parallel import collectives
from repro_torch.parallel.axisinfo import AxisInfo
from repro_torch.parallel.sharding import FSDP_AXIS


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
    groups: int = 1,
    gates: Optional[torch.Tensor] = None,
    products=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch -> expert products -> combine. Returns (out (T, d_out) in
    x's dtype, the Switch load-balance aux loss as an f32 scalar).
    ``expert_inputs(x, gates) -> (x, gates)``, when given, maps the tokens
    and gates that the experts' path reads (not the aux's). ``groups``
    routes ``T / groups`` consecutive tokens at a time, each group with its
    own capacity and ranking, and averages their aux losses (the JAX
    package's batch shards, here on one rank). ``gates`` (T, E) f32 are the
    router's logits when computed by the caller; ``products(disp) ->
    out_slots`` the experts' products of the dispatched ``(E_loc, groups *
    C, d)`` tokens when not the local ones."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    ct = cfg.cdtype()
    dev = x.device
    G, Tg = groups, T // groups

    if gates is None:
        gates = x.float() @ router.float()  # (T, E)
    probs = torch.softmax(gates, dim=-1)
    if expert_inputs is not None:
        x, gates = expert_inputs(x, gates)
    top_w, top_e = torch.topk(gates, k, dim=-1)  # (T, k)
    top_w = torch.softmax(top_w, dim=-1)  # renormalised over the chosen experts

    flat_e = top_e.reshape(-1)  # (T*k,) expert of each assignment
    group = torch.arange(T * k, device=dev) // (Tg * k)
    key = group * E + flat_e  # (group, expert) of each assignment
    counts = torch.zeros((G * E,), dtype=torch.float32, device=dev).index_add_(
        0, key, torch.ones_like(key, dtype=torch.float32))
    aux = (E * torch.sum(counts.reshape(G, E) / (Tg * k) * probs.reshape(G, Tg, E).mean(dim=1), dim=-1)).mean()

    C = capacity(Tg, cfg)
    # rank of each assignment within its (group, expert), in token order
    idx_sorted = torch.sort(key, stable=True).indices
    start = torch.cumsum(counts, dim=0) - counts  # first sorted position of each (group, expert)
    rank_sorted = torch.arange(T * k, device=dev) - start[key[idx_sorted]].long()
    pos_in_e = torch.empty_like(rank_sorted).scatter_(0, idx_sorted, rank_sorted)

    local_e = flat_e - first_expert
    keep = (pos_in_e < C) & (local_e >= 0) & (local_e < n_local_experts)
    n_slots = n_local_experts * G * C
    slot = torch.where(keep, local_e * (G * C) + group * C + pos_in_e, torch.full_like(pos_in_e, n_slots))

    # gather-style dispatch: slot -> source token (T = empty); a dropped
    # assignment lands in the extra last row, which is sliced off
    token_idx = torch.arange(T * k, device=dev) // k
    slot_token = torch.full((n_slots + 1,), T, dtype=torch.long, device=dev).scatter_(
        0, slot, token_idx)[:n_slots]
    slot_valid = slot_token < T
    src = slot_token.clamp(max=T - 1)
    xg = torch.where(slot_valid[:, None], x[src], torch.zeros((), dtype=x.dtype, device=dev))
    disp = xg.reshape(n_local_experts, G * C, d).to(ct)

    if products is None:
        h = torch.bmm(disp, w1.to(ct))
        g = torch.bmm(disp, wg.to(ct))
        h = torch.nn.functional.silu(g) * h
        out_slots = torch.bmm(h, w2.to(ct))
    else:
        out_slots = products(disp)
    out_slots = out_slots.reshape(n_slots, -1)

    # combine: each slot's output back to its token, weighted by its gate
    slot_w = torch.zeros((n_slots + 1,), dtype=torch.float32, device=dev).scatter_(
        0, slot, top_w.reshape(-1))[:n_slots]
    weighted = out_slots.float() * (slot_w * slot_valid)[:, None]
    out = torch.zeros((T, out_slots.shape[-1]), dtype=torch.float32, device=dev).index_add_(0, src, weighted)
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
    shard already (training, prefill): all of it is routed, and the output
    is only summed over the model axis. Where the weights' ``embed`` dims
    are blocks over ``data`` (decode in the ``"jax"`` layout), every rank
    routes every token (:func:`_moe_embed_split`)."""
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
    d_held = params["router"].shape[0]
    want = (n_local, d_held, cfg.d_ff if ep else cfg.d_ff // tp)
    if tuple(params["w1"].shape) != want or d_held not in (d, d // mesh.shape.get(FSDP_AXIS, 1)):
        raise ValueError(f"moe_ffn: w1 {tuple(params['w1'].shape)}, router {tuple(params['router'].shape)} are "
                         f"not this rank's shard {want} (repro_torch.parallel.sharding.shard_params)")
    first = collectives.axis_index(ma, mesh) * n_local if ep else 0
    if d_held != d:
        out, aux = _moe_embed_split(params, xf, cfg, axis_info, first, n_local, local_batch)
        return out.reshape(B, S, d), aux
    batch_axes = axis_info.batch_axes
    n_batch = collectives.axis_size(batch_axes, mesh)
    if local_batch:
        gather_axes, rows, i = (), B * S, 0
    else:
        gather_axes = batch_axes if (B * S) % n_batch == 0 else ()  # tiny decode batches: replicate tokens
        rows = B * S // collectives.axis_size(gather_axes, mesh)
        i = collectives.axis_index(gather_axes, mesh) if gather_axes else 0
    out, aux = _moe_local(
        xf[i * rows:(i + 1) * rows], params["router"], params["w1"], params["wg"], params["w2"], cfg,
        first_expert=first, n_local_experts=n_local,
        expert_inputs=lambda xx, gates: collectives.grad_psum(ma, mesh, xx, gates),
    )
    out = collectives.gather_blocks(out, gather_axes, mesh, sum_names=(ma,))
    if local_batch or gather_axes:
        aux = collectives.mean_of_shares(aux, batch_axes, mesh)
    return out.reshape(B, S, d), aux


def _moe_embed_split(params, xf: torch.Tensor, cfg: ModelConfig, axis_info: AxisInfo, first: int, n_local: int,
                     local_batch: bool):
    """Decode's MoE in the ``"jax"`` layout (module docstring): ``xf`` (T, d) whole on
    every rank, the router ``(d/data, E)`` and the experts' ``embed`` dims
    blocks over ``data``. Returns (out (T, d), aux)."""
    if local_batch:
        raise ValueError("moe_ffn: a data shard's tokens need the experts' embed dims whole (regather them)")
    mesh, ma, da = axis_info.mesh, axis_info.model_axis, (FSDP_AXIS,)
    ct = cfg.cdtype()
    T = xf.shape[0]
    n_batch = collectives.axis_size(axis_info.batch_axes, mesh)
    groups = n_batch if T % n_batch == 0 else 1
    xl = block_of(xf, -1, da, mesh)
    gates = collectives.psum(xl.float() @ params["router"].float(), da, mesh)

    def products(disp):
        dl = block_of(disp, -1, da, mesh)
        h, g = collectives.regather_many([torch.bmm(dl, params["w1"].to(ct)), torch.bmm(dl, params["wg"].to(ct))],
                                         (), mesh, da)
        return torch.bmm(torch.nn.functional.silu(g) * h, params["w2"].to(ct))

    out, aux = _moe_local(xf, params["router"], params["w1"], params["wg"], params["w2"], cfg, first_expert=first,
                          n_local_experts=n_local, groups=groups, gates=gates, products=products)
    out = collectives.regather_many([out.movedim(-1, 0)], da, mesh, (ma,))[0].movedim(0, -1)
    return out, aux
