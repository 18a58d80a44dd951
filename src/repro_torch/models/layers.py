"""Shared layers, the counterparts of :mod:`repro.models.layers`: RMSNorm
(with the JAX package's custom VJP), half-split RoPE, gated SiLU MLP,
embeddings, the tied f32 unembedding and the training cross-entropy.

Under an ``axis_info`` a weight may be this rank's block
(:mod:`repro_torch.parallel.sharding`'s ``"jax"`` layout); which of its
dims are blocks is read from its shape (:func:`split`). The rule for a
product with a block (:func:`sharded_products`): a contracting dim held as
a block meets the matching block of the activation (:func:`block_of`), and
the partial products are summed over its axes; an output dim held as a
block is regathered, or kept local where the next op takes the local part.
The residual stream stays whole on every rank. Every collective is one of
:mod:`repro_torch.parallel.collectives`' autograd forms, so training
differentiates through the same code (a training step gathers each
layer's ``data`` blocks first, and runs the model axis tensor-parallel)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives
from repro_torch.parallel.axisinfo import AxisInfo, Mesh
from repro_torch.parallel.sharding import FSDP_AXIS

Axes = Tuple[str, ...]


def split(n_held: int, n_full: int, axis: str) -> Axes:
    """The axes a dim of ``n_held`` of ``n_full`` is split over: ``()``
    when it is whole, ``(axis,)`` when it is this rank's block (the layout
    was checked against ``param_shardings`` by
    :func:`repro_torch.parallel.sharding.held_specs`)."""
    return () if n_held == n_full else (axis,)


def block_of(x: torch.Tensor, dim: int, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes``, for an ``x``
    every rank there holds whole (``x`` itself when ``axes`` is empty);
    under autograd its backward regathers the cotangent
    (:func:`collectives.tp_block`)."""
    return collectives.tp_block(x, dim, axes, mesh)


def gather_last(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """The whole of ``x``'s last dim, of which ``x`` holds this rank's block
    over ``axes`` (backward: the block of the cotangent)."""
    if not axes:
        return x
    return collectives.tp_gather([x.movedim(-1, 0)], axes, mesh)[0].movedim(0, -1)


def sharded_products(x: torch.Tensor, ws, mesh: Optional[Mesh], sum_axes: Axes = (), out_axes: Axes = (),
                     gather: bool = True) -> list:
    """``[x @ w for w in ws]`` (``ws`` 2-D, one dtype), where each ``w``'s
    contracting dim is a block over ``sum_axes`` (``x`` the matching block:
    the products are partials, summed) and its output dim a block over
    ``out_axes`` (regathered unless not ``gather``): all of it in one
    all-reduce. Under autograd ``x`` meets a block of the output dims, so
    its cotangent is summed over ``out_axes`` (:func:`collectives.grad_psum`)."""
    if out_axes:
        x = collectives.grad_psum(out_axes, mesh, x)
    outs = [x @ w for w in ws]
    gather_axes = out_axes if gather else ()
    if not sum_axes and not gather_axes:
        return outs
    if not gather_axes:
        return collectives.tp_gather(outs, (), mesh, sum_axes)
    whole = collectives.tp_gather([o.movedim(-1, 0) for o in outs], gather_axes, mesh, sum_axes)
    return [o.movedim(0, -1) for o in whole]


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 statistics for bf16 and f32 activations; f64 ones keep f64 (for
    ``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


class _RMSNorm(torch.autograd.Function):
    """``_rmsnorm_fwd``/``_rmsnorm_bwd`` of the JAX package: statistics
    accumulate in f32, but every full tensor (the output, the saved input,
    the backward products) stays in ``x.dtype``; ``dscale`` is summed in f32
    and cast to the scale's dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
        var = torch.square(x).to(_stat_dtype(x.dtype)).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps)  # (..., 1): a per-token statistic only
        ctx.save_for_backward(x, scale, inv)
        return x * inv.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale, inv = ctx.saved_tensors
        st = inv.dtype
        gs = g * scale.to(g.dtype)  # stays in the activation dtype
        s = (gs * x).to(st).sum(dim=-1, keepdim=True)
        # a tensor divisor: CUDA divides by a Python scalar as a
        # multiplication by its reciprocal, which rounds differently
        n = torch.full((), x.shape[-1], dtype=st, device=x.device)
        coef = (s * inv**3 / n).to(x.dtype)
        dx = gs * inv.to(x.dtype) - x * coef
        dscale = ((g * x).to(st) * inv).sum(dim=tuple(range(x.ndim - 1)))
        return dx, dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32 (the square taken in ``x.dtype``, as the JAX
    version's ``jnp.mean(jnp.square(x), dtype=f32)`` does); every full tensor
    stays in ``x.dtype``, in the backward pass too."""
    return _RMSNorm.apply(x, scale, eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). The first and
    second halves of the head dimension are the rotated pair."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (half,)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(params, x: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo] = None) -> torch.Tensor:
    """Gated SiLU MLP. Under ``axis_info`` with blocks of ``wi``/``wg``
    ``(embed -> data, ffn -> model)`` and ``wo`` ``(ffn, embed)``: the
    hidden stays local over the model axis, the output whole."""
    ct = cfg.cdtype()
    wi, wg, wo = (params[k].to(ct) for k in ("wi", "wg", "wo"))
    if axis_info is None:
        h = x @ wi
        g = x @ wg
        return (torch.nn.functional.silu(g) * h) @ wo
    mesh = axis_info.mesh
    da = split(wi.shape[0], cfg.d_model, FSDP_AXIS)
    fa = split(wi.shape[1], cfg.d_ff, axis_info.model_axis)
    h, g = sharded_products(block_of(x, -1, da, mesh), [wi, wg], mesh, sum_axes=da, out_axes=fa, gather=False)
    h = torch.nn.functional.silu(g) * h
    return sharded_products(h, [wo], mesh, sum_axes=fa, out_axes=da)[0]


def embed(params, tokens: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo] = None) -> torch.Tensor:
    """Table rows of ``tokens`` in the compute dtype. Under ``axis_info``
    with the table's vocab block: the rows this rank holds, zeros for the
    rest, summed over the model axis (exact: one rank adds each row)."""
    table = params["table"]
    va = () if axis_info is None else split(table.shape[0], cfg.padded_vocab, axis_info.model_axis)
    if not va:
        return table[tokens].to(cfg.cdtype())
    mesh, n = axis_info.mesh, table.shape[0]
    local = tokens.long() - collectives.axis_index(va, mesh) * n
    hit = (local >= 0) & (local < n)
    rows = torch.where(hit[..., None], table[local.clamp(0, n - 1)], torch.zeros((), dtype=table.dtype,
                                                                                  device=table.device))
    return collectives.tp_gather([rows], (), mesh, va)[0].to(cfg.cdtype())


def vocab_axes(params, cfg: ModelConfig, axis_info: Optional[AxisInfo]) -> Axes:
    """The axes the embedding table's vocab dim is split over."""
    return () if axis_info is None else split(params["table"].shape[0], cfg.padded_vocab, axis_info.model_axis)


def unembed(params, x: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo] = None,
            gather: bool = True) -> torch.Tensor:
    """Tied unembedding -> logits over the padded vocab (float32); under
    ``axis_info`` computed on the table's vocab block and regathered (or,
    without ``gather``, this rank's block of them)."""
    va = vocab_axes(params, cfg, axis_info)
    if va:
        x = collectives.grad_psum(va, axis_info.mesh, x)
    logits = x.float() @ params["table"].float().T
    return gather_last(logits, va, axis_info.mesh) if va and gather else logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                  denom: Optional[torch.Tensor] = None, axes: Axes = (),
                  mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the labels that are not padding (label -1),
    with the padded vocab tail masked to -1e30. Returns (loss, accuracy),
    f32 scalars. ``denom``, when given, divides the sums in place of the
    count of these labels: a rank's rows of a batch give its share of the
    batch's mean when ``denom`` counts the whole batch's labels.

    The gold logit is gathered: the JAX version contracts with a one-hot so
    that the vocab axis can stay sharded, which on one device gives the same
    value and would cost a (B, S, V) f32 tensor.

    With ``axes`` the logits are this rank's block of the padded vocab over
    ``axes`` (the model axis, whose ranks hold one loss between them), and
    no logit leaves its rank: each token's largest logit is maximised over
    ``axes`` (the logsumexp's shift, a constant to the gradient), then each
    rank's sum of exponentials, gold logit (zero where the label lies in
    another block) and first largest index cross in one gather, are summed
    (every rank gets the whole cotangent of the sums) and the index reduced
    to the first of the largest (``argmax``'s rule). Three floats a token
    a rank cross, where the regathered logits would be the vocab's."""
    mask = labels >= 0
    labels = torch.where(mask, labels, torch.zeros_like(labels)).long()
    n = logits.shape[-1]
    first = collectives.axis_index(axes, mesh) * n if axes else 0
    V = n * collectives.axis_size(axes, mesh) if axes else n
    if vocab_size < V:
        vmask = torch.arange(first, first + n, device=logits.device) < vocab_size
        logits = torch.where(vmask, logits, torch.full((), -1e30, dtype=logits.dtype, device=logits.device))
    if denom is None:
        denom = mask.sum().clamp_min(1)
    if not axes:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        pred = logits.argmax(dim=-1)
    else:
        top = logits.detach().amax(dim=-1)
        shift = collectives.pmax(top, axes, mesh)
        local = labels - first
        hit = (local >= 0) & (local < n)
        mine = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        arg = (logits.detach().argmax(dim=-1) + first).to(logits.dtype)
        parts = [torch.exp(logits - shift[..., None]).sum(dim=-1),
                 torch.where(hit, mine, torch.zeros((), dtype=logits.dtype, device=logits.device)),
                 torch.where(top == shift, arg, torch.full((), V, dtype=logits.dtype, device=logits.device))]
        ranks = collectives.tp_gather([torch.stack(parts)[None]], axes, mesh)[0]  # (n_ranks, 3, ...)
        logz = shift + torch.log(ranks[:, 0].sum(dim=0))
        gold = ranks[:, 1].sum(dim=0)
        pred = ranks[:, 2].amin(dim=0).long()
    nll = (logz - gold) * mask
    acc = ((pred == labels) * mask).sum() / denom
    return nll.sum() / denom, acc
