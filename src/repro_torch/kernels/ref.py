"""Quadratic oracles, the counterparts of :mod:`repro.kernels.ref`.

Small-shape, obviously-correct code: the ground truth that ``impl="ref"``
selects in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(..., K, D) -> (..., H, D) by repeating each kv head H/K times."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=-2)


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_start: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Quadratic-materialization attention. GQA via kv-head repetition.

    ``q_start`` is the absolute position of q[0]; ``window`` masks keys more
    than ``window-1`` positions behind the query; ``causal`` masks future keys.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = repeat_kv(k, H).float()
    v = repeat_kv(v, H).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    qpos = q_start + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.to(q.dtype)


def paged_attention_ref(
    q: torch.Tensor,  # (B, H, D) one query token per sequence
    pool_k: torch.Tensor,  # (P, T, K, D) page pool (pre-rotated keys)
    pool_v: torch.Tensor,  # (P, T, K, D)
    tables: torch.Tensor,  # (B, R) page ids into the pool
    page_pos: torch.Tensor,  # (B, R) absolute position of each page's slot 0
    lengths: torch.Tensor,  # (B,) tokens cached per sequence (incl. current)
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over the paged, possibly ring-buffered KV pool.

    A cached token in page-slot ``(r, t)`` of sequence ``b`` has absolute
    position ``page_pos[b, r] + t``; it participates iff
    ``lo <= pos < lengths[b]`` where ``lo = max(0, lengths[b]-window)``.
    Page ids outside ``[0, P)`` are clamped, as JAX's gather clamps them; a
    row whose tokens are all masked gets a meaningless (finite) output.
    """
    B, H, D = q.shape
    P, T, K, _ = pool_k.shape
    R = tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    idx = tables.long().clamp(0, P - 1)
    k = pool_k[idx]  # (B, R, T, K, D)
    v = pool_v[idx]
    pos = page_pos[:, :, None] + torch.arange(T, device=q.device)[None, None, :]
    lengths = lengths.to(pos.dtype)
    lo = (lengths - window).clamp_min(0) if window is not None else torch.zeros_like(lengths)
    valid = (pos >= lo[:, None, None]) & (pos < lengths[:, None, None])

    k = repeat_kv(k.reshape(B, R * T, K, D), H).float()
    v = repeat_kv(v.reshape(B, R * T, K, D), H).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    s = torch.where(valid.reshape(B, 1, R * T), s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v)
    return out.to(q.dtype)


def online_softmax_combine(
    o_parts: torch.Tensor,  # (N, ..., D) unnormalized sum exp(s-m)·v per part
    m_parts: torch.Tensor,  # (N, ...)   running max per part
    l_parts: torch.Tensor,  # (N, ...)   sum exp(s-m) per part
) -> torch.Tensor:
    """Reference combine of flash/paged partial results (split-K check)."""
    m = m_parts.max(dim=0).values
    alpha = torch.exp(m_parts - m[None])
    l = (l_parts * alpha).sum(dim=0)
    o = (o_parts * alpha[..., None]).sum(dim=0)
    return o / l.clamp_min(1e-30)[..., None]
