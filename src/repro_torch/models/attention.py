"""GQA attention: prefill (flash) and paged decode, the counterpart of
:mod:`repro.models.attention`.

Weight layouts are the JAX package's: ``wq (d, H, hd)``, ``wk``/``wv
(d, K, hd)``, ``wo (H, hd, d)``. Under an ``axis_info`` decode reads and
writes a page pool striped over every mesh axis (the paper's page
striping): each rank holds its stripe, writes only the pages it owns,
computes partial online-softmax statistics over them, and the partials are
combined with collectives; q, k, v, the tables and ``page_pos`` are
replicated, as in the JAX package's ``shard_map`` body.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.modules import dense_init
from repro_torch.parallel.axisinfo import AxisInfo, page_offset_in_shard


def attention_init(gen: torch.Generator, cfg: ModelConfig):
    d, H, K, hd, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.pdtype()
    return {
        "wq": dense_init(gen, d, (H, hd), dt),
        "wk": dense_init(gen, d, (K, hd), dt),
        "wv": dense_init(gen, d, (K, hd), dt),
        "wo": dense_init(gen, H * hd, (d,), dt).reshape(H, hd, d),
    }


def project(x: torch.Tensor, w: torch.Tensor, ct: torch.dtype) -> torch.Tensor:
    """(B, S, d) x (d, N, hd) -> (B, S, N, hd)."""
    d, n, hd = w.shape
    return (x @ w.to(ct).reshape(d, n * hd)).reshape(*x.shape[:-1], n, hd)


def qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: Optional[torch.Tensor], rope: bool = True):
    """Project + rotate (no rotation with ``rope=False``). x: (B, S, d) ->
    q (B,S,H,hd), k/v (B,S,K,hd)."""
    ct = cfg.cdtype()
    q = project(x, params["wq"], ct)
    k = project(x, params["wk"], ct)
    v = project(x, params["wv"], ct)
    if rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(params, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    wo = params["wo"].to(cfg.cdtype())
    H, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], H * hd) @ wo.reshape(H * hd, d)


def attention_train(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    kv_src: Optional[torch.Tensor] = None,
    rope: bool = True,
    return_kv: bool = False,
    impl: Optional[str] = None,
):
    """Full-sequence attention (training, prefill, encoder, cross). With
    ``return_kv`` also returns the (rotated) ``(k, v)`` for the paged cache.
    ``impl`` goes to :func:`ops.flash_attention`; training passes ``"xla"``.

    ``kv_src`` switches to cross-attention: keys and values projected from
    that sequence, no RoPE, non-causal. The sliding window applies only to
    causal attention."""
    if kv_src is not None:
        ct = cfg.cdtype()
        q = project(x, params["wq"], ct)
        k = project(kv_src, params["wk"], ct)
        v = project(kv_src, params["wv"], ct)
        causal = False
    else:
        q, k, v = qkv(params, x, cfg, None, rope=rope)
    window = cfg.sliding_window if causal else None
    o = ops.flash_attention(q, k, v, causal=causal, window=window, q_chunk=cfg.attn_chunk, impl=impl)
    out = out_proj(params, o, cfg)
    if return_kv:
        return out, (k, v)
    return out


# ------------------------------- paged decode --------------------------------

CacheLayer = Dict[str, torch.Tensor]  # pool_k, pool_v, tables, page_pos[, scale_k, scale_v]


def attention_decode(
    params,
    x: torch.Tensor,  # (B, 1, d)
    cache: CacheLayer,
    lengths: torch.Tensor,  # (B,) tokens already cached (new token position)
    cfg: ModelConfig,
    axis_info: Optional[AxisInfo] = None,
    *,
    update: bool = True,
    rope: bool = True,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, CacheLayer]:
    """One decode step: append this token's K/V (paper WRITE, in place into
    the cache's pools, and into its scales for an int8 pool), then attend
    over the paged pool (paper READ). ``update=False`` gives read-only
    attention over ``lengths`` cached tokens (cross-attention over a
    prefilled pool): nothing is written and the cache comes back as given.

    With ``axis_info`` the pools (and scales) are this rank's stripe over
    ``page_axes`` (:func:`repro_torch.parallel.sharding.shard_cache`): the
    write lands only if this rank owns the page, every rank computes the
    same new ``page_pos`` (it stays replicated), and the read combines the
    ranks' partial statistics."""
    positions = lengths[:, None] if rope else None
    quant = cache["pool_k"].dtype == torch.int8
    pool_k, pool_v, page_pos = cache["pool_k"], cache["pool_v"], cache["page_pos"]
    sk, sv = cache.get("scale_k"), cache.get("scale_v")
    if axis_info is None:
        offset, axes, mesh = 0, (), None
    else:
        axes, mesh = axis_info.page_axes, axis_info.mesh
        offset = page_offset_in_shard(axes, pool_k.shape[0], mesh)
    if update:
        q, k, v = qkv(params, x, cfg, positions, rope=rope)
        out = ops.paged_update(pool_k, pool_v, cache["tables"], page_pos, lengths, k[:, 0], v[:, 0],
                               scale_k=sk, scale_v=sv, page_offset=offset)
        if quant:
            pool_k, pool_v, page_pos, sk, sv = out
        else:
            pool_k, pool_v, page_pos = out
    else:  # only q is needed: the keys and values are already in the pool
        q = project(x, params["wq"], cfg.cdtype())
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
    o = ops.paged_attention(
        q[:, 0], pool_k, pool_v, cache["tables"], page_pos, lengths + (1 if update else 0),
        scale_k=sk, scale_v=sv, window=cfg.sliding_window, page_offset=offset, axis_names=axes, mesh=mesh,
        impl=impl,
    )
    new_cache = dict(cache, pool_k=pool_k, pool_v=pool_v, page_pos=page_pos)
    if quant:
        new_cache.update(scale_k=sk, scale_v=sv)
    return out_proj(params, o[:, None], cfg), new_cache


def init_decode_cache(
    cfg: ModelConfig,
    batch: int,
    seq_len: int,
    n_layers: int,
    dtype: Optional[torch.dtype] = None,
    pad_pages_to: int = 1,
    *,
    device,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Allocate an empty paged cache for ``n_layers`` attention layers.

    With a sliding window the per-sequence ring is only ``window/T + 1`` pages
    (rolling buffer); otherwise ``seq_len/T`` pages. ``pad_pages_to`` pads
    the pool's page count (unreferenced tail pages) so that it stripes
    evenly over the page axes. Returns (cache, lengths); each cache leaf is
    stacked over layers: pool_k (L, P, T, K, hd), and for int8 pools the f32
    dequant scales scale_k/scale_v (L, P, T, K).
    """
    T = cfg.kv_page_tokens
    dtype = dtype or cfg.kvdtype()
    if cfg.sliding_window is not None and cfg.sliding_window < seq_len:
        ring = cfg.sliding_window // T + 1
    else:
        ring = max(seq_len // T, 1)
    n_pages = -(-(batch * ring) // pad_pages_to) * pad_pages_to
    K, hd = cfg.n_kv_heads, cfg.head_dim
    tables = torch.arange(batch * ring, dtype=torch.int32, device=device).reshape(batch, ring)
    page_pos = (torch.arange(ring, dtype=torch.int32, device=device) * T)[None, :].repeat(batch, 1)
    cache = {
        "pool_k": torch.zeros((n_layers, n_pages, T, K, hd), dtype=dtype, device=device),
        "pool_v": torch.zeros((n_layers, n_pages, T, K, hd), dtype=dtype, device=device),
        "tables": tables[None].repeat(n_layers, 1, 1),
        "page_pos": page_pos[None].repeat(n_layers, 1, 1),
    }
    if dtype == torch.int8:  # per-(page, token, kv-head) dequant scales
        cache["scale_k"] = torch.zeros((n_layers, n_pages, T, K), dtype=torch.float32, device=device)
        cache["scale_v"] = torch.zeros((n_layers, n_pages, T, K), dtype=torch.float32, device=device)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache, lengths
