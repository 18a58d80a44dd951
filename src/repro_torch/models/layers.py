"""Shared layers, the forward halves of :mod:`repro.models.layers`: RMSNorm,
half-split RoPE, gated SiLU MLP, embeddings and the tied f32 unembedding."""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32 (the square taken in ``x.dtype``, as the JAX
    version's ``jnp.mean(jnp.square(x), dtype=f32)`` does); every full tensor
    stays in ``x.dtype``."""
    var = torch.square(x).float().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)  # (..., 1) f32
    return x * inv.to(x.dtype) * scale.to(x.dtype)


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
