"""Mamba2 (SSD -- state-space duality, arXiv:2405.21060), the counterpart of
:mod:`repro.models.ssm`.

The chunked SSD formulation: within a chunk of L tokens the output is a
decay-weighted attention-like product; across chunks a small recurrent
state (H, N, P) per sequence is carried. The JAX package's ``lax.scan``
over chunks becomes a Python loop. Decode is the O(1) recurrent update.

Numerics follow the JAX code cast for cast. Where it asks an einsum of
compute-dtype operands for an f32 result (``preferred_element_type``), the
operands are upcast to f32 here: a product of two bf16 numbers is exact in
f32, so only the order of the sums differs. The causal conv is the same loop
of shifted multiply-adds (a depthwise ``conv1d`` would sum in another order
and, in f32 on a card, run in TF32 by default).

Under an ``axis_info`` the projections may be this rank's blocks (the
``"jax"`` layout: ``in_proj`` ``(embed -> data, ssm_proj -> model)``,
``out_proj`` ``(ssm_inner -> model, embed -> data)``). ``in_proj``'s
columns over the model axis cut across the z / x / B / C / dt pieces, so its
output is summed over ``data`` and regathered over ``model`` (one
all-reduce), and the conv and the scan then run on every head, replicated
over the model axis: the JAX package's GSPMD layout would split the scan
over heads only after a reshard of those pieces, and the scan is a small
share of a layer's work next to the projections. ``out_proj`` takes this
rank's block of the gated output: summed over ``model``, regathered over
``data``. The conv taps and bias and the gated norm's scale are used whole
(the caller regathers them). In training the ``data`` blocks are gathered
with the layer, and the same code differentiates: the regathered output's
backward takes this rank's block, the gated output's block regathers its
cotangent (:mod:`repro_torch.parallel.collectives`).

In decode the rows are replicated for the projections, and the states are
this rank's rows over the batch axes (``cache_shardings``' blocks; every
row where the batch does not divide): the conv, the scan, ``D`` and the
gated norm run on those rows alone, against their own states, and the
model-axis block of their gated output is regathered over the batch axes
before ``out_proj`` (one all-reduce of ``(B, d_inner / model)`` a layer).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import block_of, sharded_products, split
from repro_torch.models.modules import dense_init
from repro_torch.parallel import collectives
from repro_torch.parallel.axisinfo import AxisInfo
from repro_torch.parallel.sharding import FSDP_AXIS, row_block

SSMState = Dict[str, torch.Tensor]  # {"ssm": (B, H, N, P), "conv": (B, Kc-1, conv_dim)}


def ssm_init(gen: torch.Generator, cfg: ModelConfig):
    """One Mamba2 mixer's params in ``param_dtype``; ``A_log``, ``D`` and
    ``dt_bias`` are f32 whatever it is, as in the JAX package."""
    d, di, n, g = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    h, dconv, dt = cfg.ssm_heads, cfg.ssm_conv, cfg.pdtype()
    conv_dim = di + 2 * g * n
    dev = gen.device
    in_proj = dense_init(gen, d, (2 * di + 2 * g * n + h,), dt)
    conv_w = torch.empty((dconv, conv_dim), dtype=torch.float32, device=dev)
    conv_w.normal_(0.0, 1.0, generator=gen)
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w * 0.1).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, di, (d,), dt),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di : 2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n :]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (Kc, C): the last tap
    first, then each earlier tap on the input shifted right."""
    Kc, S = w.shape[0], xBC.shape[1]
    out = xBC * w[-1]
    for i in range(1, Kc):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return out + b


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise decay: out[..., i, j] = sum_{j<m<=i} a[..., m].

    a: (..., L) -> (..., L, L) with -inf above the diagonal.
    """
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, -math.inf)


def chunk_len(S: int, chunk: int) -> int:
    """The chunk :func:`ssd_chunked` runs: ``chunk`` (at most S), or the
    largest divisor of S below it when S is not a multiple of it."""
    L = min(chunk, S)
    return next(c for c in range(L, 0, -1) if S % c == 0)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus, f32
    A: torch.Tensor,  # (H,) negative decay rates, f32
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
    return_state: bool = False,
):
    """Chunked SSD scan. Returns y (B, S, H, P) f32 [, final_state (B, H, N, P) f32]."""
    Bb, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = chunk_len(S, chunk)
    nc = S // L
    rep = H // G

    xc = x.reshape(Bb, nc, L, H, Pd)
    dtc = dt.reshape(Bb, nc, L, H)
    Bc = Bm.reshape(Bb, nc, L, G, N)
    Cc = Cm.reshape(Bb, nc, L, G, N)

    a = dtc * A  # (B, nc, L, H) log decay per step (f32)
    cum_a = torch.cumsum(a, dim=2)  # within-chunk cumulative

    # ---- intra-chunk (quadratic in L) ----
    ct = xc.dtype
    seg = _segsum(a.movedim(-1, -2))  # (B, nc, H, L, L)
    decay = torch.exp(seg).to(ct)
    scores = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)  # (B, nc, G, L, L)
    scores = scores.to(ct).repeat_interleave(rep, dim=2)  # -> (B, nc, H, L, L)
    M = scores * decay
    xdt = (xc * dtc[..., None].to(ct)).to(ct)  # (B, nc, L, H, P)
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", M.float(), xdt.float())

    # ---- chunk states ----
    decay_to_end = torch.exp(cum_a[:, :, -1:, :] - cum_a)  # (B, nc, L, H)
    states = torch.einsum(
        "bclgn,bclh,bclhp->bchnp",
        Bc.float(), (decay_to_end * dtc).to(ct).float(), xc.float(),
    )

    # ---- inter-chunk recurrence over nc (small state) ----
    chunk_decay = torch.exp(cum_a[:, :, -1, :])  # (B, nc, H)
    s = (init_state if init_state is not None
         else torch.zeros((Bb, H, N, Pd), dtype=torch.float32, device=x.device)).float()
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # (B, nc, H, N, P)

    state_decay = torch.exp(cum_a)  # decay from chunk start to position
    Cr = Cc.repeat_interleave(rep, dim=3)  # (B, nc, L, H, N)
    y_inter = torch.einsum(
        "bclhn,bchnp,bclh->bclhp",
        Cr.float(), prev_states.to(ct).float(), state_decay.to(ct).float(),
    )

    y = (y_intra + y_inter).reshape(Bb, S, H, Pd)
    if return_state:
        return y, s
    return y


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, N, P)
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H) post-softplus
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, G, N)
    Cm: torch.Tensor,  # (B, G, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent update: returns (y (B, H, P), new_state)."""
    rep = x.shape[1] // Bm.shape[1]
    Br = Bm.repeat_interleave(rep, dim=1)  # (B, H, N)
    Cr = Cm.repeat_interleave(rep, dim=1)
    decay = torch.exp(dt * A)  # (B, H)
    upd = Br[..., :, None] * (x * dt[..., None])[..., None, :]  # (B, H, N, P)
    new_state = state * decay[:, :, None, None] + upd
    y = (Cr[..., None, :] @ new_state)[..., 0, :]
    return y, new_state


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf * scale.float()).to(y.dtype)


def _heads(xBC: torch.Tensor, cfg: ModelConfig):
    """Split the conv output (..., conv_dim) into x (..., H, P), B and C (..., G, N)."""
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    lead = xBC.shape[:-1]
    xs = xBC[..., :di].reshape(*lead, cfg.ssm_heads, cfg.ssm_headdim)
    Bm = xBC[..., di : di + g * n].reshape(*lead, g, n)
    Cm = xBC[..., di + g * n :].reshape(*lead, g, n)
    return xs, Bm, Cm


def _in_proj(params, x: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo]) -> torch.Tensor:
    """``x @ in_proj``, whole (module docstring)."""
    w = params["in_proj"].to(cfg.cdtype())
    if axis_info is None:
        return x @ w
    mesh = axis_info.mesh
    da = split(w.shape[0], cfg.d_model, FSDP_AXIS)
    pa = split(w.shape[1], 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads,
               axis_info.model_axis)
    return sharded_products(block_of(x, -1, da, mesh), [w], mesh, sum_axes=da, out_axes=pa)[0]


def _out_proj(params, y: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo],
              rows: Optional[slice] = None) -> torch.Tensor:
    """``y @ out_proj``, whole (module docstring). ``rows``: ``y`` holds
    only these rows of the batch, whose model-axis block is regathered over
    the batch axes first (decode)."""
    w = params["out_proj"].to(cfg.cdtype())
    if axis_info is None:
        return y @ w
    mesh = axis_info.mesh
    ia = split(w.shape[0], cfg.d_inner, axis_info.model_axis)
    da = split(w.shape[1], cfg.d_model, FSDP_AXIS)
    y = block_of(y, -1, ia, mesh)
    if rows is not None:
        y = collectives.regather(y.contiguous(), axis_info.batch_axes, mesh)
    return sharded_products(y, [w], mesh, sum_axes=ia, out_axes=da)[0]


def ssm_forward(params, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False,
                axis_info: Optional[AxisInfo] = None):
    """Full-sequence Mamba2 mixer (prefill). x (B, S, d) in the compute
    dtype. With ``return_state`` also returns the state handed to decode:
    the final SSM state and the conv tail (the last Kc-1 pre-conv inputs),
    both f32 (``lm._ssm_forward_with_state`` of the JAX package)."""
    ct = cfg.cdtype()
    Bb, S = x.shape[:2]
    zxbcdt = _in_proj(params, x, cfg, axis_info)
    z, xBC_pre, dt = _split_proj(zxbcdt, cfg)
    xBC = F.silu(_causal_conv(xBC_pre, params["conv_w"].to(ct), params["conv_b"].to(ct)))
    xs, Bm, Cm = _heads(xBC, cfg)
    dtv = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    out = ssd_chunked(xs, dtv, A, Bm, Cm, cfg.ssm_chunk, return_state=return_state)
    y, final = out if return_state else (out, None)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = _gated_norm(y.reshape(Bb, S, cfg.d_inner).to(ct), z, params["norm"])
    y = _out_proj(params, y, cfg, axis_info)
    if not return_state:
        return y
    conv_tail = xBC_pre[:, -(cfg.ssm_conv - 1):, :]
    return y, {"ssm": final.float(), "conv": conv_tail.float()}


def init_ssm_state(cfg: ModelConfig, batch: int, n_layers: int, dtype=torch.float32, *,
                   device) -> SSMState:
    h, n, p = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros((n_layers, batch, h, n, p), dtype=dtype, device=device),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def ssm_decode(
    params,
    x: torch.Tensor,  # (B, 1, d)
    state: SSMState,  # one layer's {"ssm": (B, H, N, P), "conv": (B, Kc-1, C)}
    cfg: ModelConfig,
    axis_info: Optional[AxisInfo] = None,
) -> Tuple[torch.Tensor, SSMState]:
    """One-token Mamba2 step: returns (out (B, 1, d), the layer's new state).
    Under ``axis_info`` ``state`` may hold this rank's rows alone (module
    docstring)."""
    ct = cfg.cdtype()
    zxbcdt = _in_proj(params, x, cfg, axis_info)[:, 0]
    B = zxbcdt.shape[0]
    rows = None
    if state["ssm"].shape[0] != B:  # this rank's rows: its block over the batch axes
        rows = row_block(B, axis_info)
        if rows.stop - rows.start != state["ssm"].shape[0]:
            raise ValueError(f"SSM states of {state['ssm'].shape[0]} rows are neither the batch's {B} "
                             f"nor this rank's block of it")
        zxbcdt = zxbcdt[rows]
    z, xBC, dt = _split_proj(zxbcdt, cfg)

    conv_hist = torch.cat([state["conv"].to(ct), xBC[:, None, :]], dim=1)  # (B, Kc, C)
    w = params["conv_w"].to(ct)  # (Kc, C)
    xBC = F.silu((conv_hist * w[None]).sum(dim=1) + params["conv_b"].to(ct))
    new_conv = conv_hist[:, 1:]

    xs, Bm, Cm = _heads(xBC, cfg)
    dtv = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, new_ssm = ssd_decode_step(state["ssm"].float(), xs.float(), dtv, A, Bm.float(), Cm.float())
    y = y + params["D"][None, :, None] * xs.float()
    y = _gated_norm(y.reshape(-1, cfg.d_inner).to(ct), z, params["norm"])
    out = _out_proj(params, y, cfg, axis_info, rows)[:, None]
    return out, {"ssm": new_ssm.to(state["ssm"].dtype), "conv": new_conv.to(state["conv"].dtype)}
