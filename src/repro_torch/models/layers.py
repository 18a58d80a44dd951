"""Shared layers, the counterparts of :mod:`repro.models.layers`: RMSNorm
(with the JAX package's custom VJP), half-split RoPE, gated SiLU MLP,
embeddings, the tied f32 unembedding and the training cross-entropy."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig


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


def mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    ct = cfg.cdtype()
    h = x @ params["wi"].to(ct)
    g = x @ params["wg"].to(ct)
    h = torch.nn.functional.silu(g) * h
    return h @ params["wo"].to(ct)


def embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["table"][tokens].to(cfg.cdtype())


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied unembedding -> logits over the padded vocab (float32)."""
    return x.float() @ params["table"].float().T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                  denom: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the labels that are not padding (label -1),
    with the padded vocab tail masked to -1e30. Returns (loss, accuracy),
    f32 scalars. ``denom``, when given, divides the sums in place of the
    count of these labels: a rank's rows of a batch give its share of the
    batch's mean when ``denom`` counts the whole batch's labels.

    The gold logit is gathered: the JAX version contracts with a one-hot so
    that the vocab axis can stay sharded, which on one device gives the same
    value and would cost a (B, S, V) f32 tensor."""
    mask = labels >= 0
    labels = torch.where(mask, labels, torch.zeros_like(labels)).long()
    V = logits.shape[-1]
    if vocab_size < V:
        vmask = torch.arange(V, device=logits.device) < vocab_size
        logits = torch.where(vmask, logits, torch.full((), -1e30, dtype=logits.dtype, device=logits.device))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold) * mask
    if denom is None:
        denom = mask.sum().clamp_min(1)
    acc = ((logits.argmax(dim=-1) == labels) * mask).sum() / denom
    return nll.sum() / denom, acc
