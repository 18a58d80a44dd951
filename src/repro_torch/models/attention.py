"""GQA attention: prefill (flash) and paged decode, the counterpart of
:mod:`repro.models.attention`.

Weight layouts are the JAX package's: ``wq (d, H, hd)``, ``wk``/``wv
(d, K, hd)``, ``wo (H, hd, d)``. Under an ``axis_info`` each may be this
rank's block (``embed`` over ``data``, heads over ``model``; see
:mod:`repro_torch.models.layers` for the rule of a product with a block):

* **training and prefill** (:func:`attention_train`; the layer's ``data``
  blocks are regathered first) run tensor-parallel over the model axis: the flash
  kernel on this rank's H/tp q heads and their K/tp kv heads (or, where
  the kv heads do not divide, the whole ``wk``/``wv`` with the kv heads
  this rank's q heads read sliced out), ``wo`` a partial summed over the
  model axis; the keys and values it returns for the cache are regathered
  to every kv head;
* **decode** (:func:`attention_decode`) reads and writes a page pool
  striped over every mesh axis (the paper's page striping): each rank
  holds its stripe, writes only the pages it owns, computes partial
  online-softmax statistics over them, and the partials are combined with
  collectives. q, k and v are partial products over ``data``, summed and
  regathered to every head in one all-reduce, because the stripe holds
  every head of its pages (the JAX package's ``shard_map`` takes them
  replicated); the tables and ``page_pos`` are replicated. The rank takes
  its own heads of the output into its block of ``wo``: a partial over
  ``model``, summed, with the output regathered over ``data``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, block_of, sharded_products, split
from repro_torch.models.modules import dense_init
from repro_torch.parallel import collectives
from repro_torch.parallel.axisinfo import AxisInfo, page_offset_in_shard
from repro_torch.parallel.sharding import FSDP_AXIS


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


def _kv_heads_read(cfg: ModelConfig, h_held: int, axis_info: AxisInfo) -> slice:
    """The kv heads this rank's ``h_held`` q heads read, where the q heads
    are split over the model axis and the kv heads are not: a slice that
    the flash kernel's GQA grouping takes (every local q head, in order,
    reads kv head ``j // (h_held / n_kv)``); raises where none does."""
    g = cfg.n_heads // cfg.n_kv_heads
    first = collectives.axis_index(axis_info.model_axis, axis_info.mesh) * h_held
    if h_held % g == 0:
        return slice(first // g, first // g + h_held // g)
    if g % h_held == 0:
        return slice(first // g, first // g + 1)
    raise ValueError(f"attn wk/wv: {cfg.n_heads} q heads split {h_held} a rank cannot read whole kv heads "
                     f"({cfg.n_kv_heads}, groups of {g})")


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
    axis_info: Optional[AxisInfo] = None,
):
    """Full-sequence attention (training, prefill, encoder, cross). With
    ``return_kv`` also returns the (rotated) ``(k, v)`` for the paged cache.
    ``impl`` goes to :func:`ops.flash_attention`; training passes ``"xla"``.

    ``kv_src`` switches to cross-attention: keys and values projected from
    that sequence, no RoPE, non-causal. The sliding window applies only to
    causal attention.

    Under ``axis_info`` the weights may hold this rank's heads (their
    ``embed`` dims whole): tensor-parallel over the model axis (module
    docstring); the ``(k, v)`` returned hold every kv head. Under autograd
    the inputs' cotangents are summed over the model axis (each rank's
    heads read all of them), and so are those of whole ``wk``/``wv``
    where the kv heads do not divide the axis (each rank's q heads read
    only some kv heads); the output's partials are summed with an identity
    backward."""
    ha = kv_ha = ()
    if axis_info is not None:
        ha = split(params["wq"].shape[1], cfg.n_heads, axis_info.model_axis)
        kv_ha = ha if params["wk"].shape[1] == cfg.n_kv_heads else ()
    if ha:  # the inputs meet this rank's heads: their cotangents are partials
        x = collectives.grad_psum(ha, axis_info.mesh, x)
        if kv_src is not None:
            kv_src = collectives.grad_psum(ha, axis_info.mesh, kv_src)
    if kv_ha:  # whole kv heads, of which this rank reads some
        params = dict(params, **dict(zip(("wk", "wv"), collectives.grad_psum(
            kv_ha, axis_info.mesh, params["wk"], params["wv"]))))
    if kv_src is not None:
        ct = cfg.cdtype()
        q = project(x, params["wq"], ct)
        k = project(kv_src, params["wk"], ct)
        v = project(kv_src, params["wv"], ct)
        causal = False
    else:
        q, k, v = qkv(params, x, cfg, None, rope=rope)
    window = cfg.sliding_window if causal else None
    ka = () if axis_info is None else split(k.shape[2], cfg.n_kv_heads, axis_info.model_axis)
    kf, vf = k, v
    if ka and return_kv:  # every kv head, for the cache
        kf, vf = (t.movedim(0, 2) for t in collectives.tp_gather(
            [k.movedim(2, 0), v.movedim(2, 0)], ka, axis_info.mesh))
    elif ha and not ka:  # whole kv heads: the ones this rank's q heads read
        read = _kv_heads_read(cfg, q.shape[2], axis_info)
        k, v = k[:, :, read], v[:, :, read]
    o = ops.flash_attention(q, k, v, causal=causal, window=window, q_chunk=cfg.attn_chunk, impl=impl)
    out = out_proj(params, o, cfg)
    if ha:
        out = collectives.tp_gather([out], (), axis_info.mesh, ha)[0]
    if return_kv:
        return out, (kf, vf)
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
        q, k, v = _decode_qkv(params, x, cfg, axis_info, update)
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        out = ops.paged_update(pool_k, pool_v, cache["tables"], page_pos, lengths, k[:, 0], v[:, 0],
                               scale_k=sk, scale_v=sv, page_offset=offset)
        if quant:
            pool_k, pool_v, page_pos, sk, sv = out
        else:
            pool_k, pool_v, page_pos = out
    else:  # only q is needed: the keys and values are already in the pool
        q = _decode_qkv(params, x, cfg, axis_info, update)[0]
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
    return _decode_out(params, o[:, None], cfg, axis_info), new_cache


def _decode_qkv(params, x: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo], update: bool):
    """The new token's q (and k, v with ``update``), every head, unrotated.
    Under ``axis_info`` the weights' blocks give partial products over
    ``data``, summed and regathered over the model axis: one all-reduce
    for the q, k and v that share their split (two where the kv heads do
    not divide the model axis)."""
    names = ("wq", "wk", "wv") if update else ("wq",)
    if axis_info is None:
        return [project(x, params[n], cfg.cdtype()) for n in names]
    mesh, ct = axis_info.mesh, cfg.cdtype()
    d = params["wq"].shape[0]
    da = split(d, cfg.d_model, FSDP_AXIS)
    xl = block_of(x, -1, da, mesh)
    groups = {}
    for n in names:
        w = params[n]
        full = cfg.n_heads if n == "wq" else cfg.n_kv_heads
        groups.setdefault(split(w.shape[1], full, axis_info.model_axis), []).append(n)
    out = {}
    for ha, group in groups.items():
        ws = [params[n].to(ct).reshape(d, -1) for n in group]
        for n, y in zip(group, sharded_products(xl, ws, mesh, sum_axes=da, out_axes=ha)):
            out[n] = y.reshape(*x.shape[:-1], -1, cfg.head_dim)
    return [out[n] for n in names]


def _decode_out(params, o: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo]) -> torch.Tensor:
    """``o`` (B, 1, H, hd), every head, through ``wo``; under ``axis_info``
    this rank's heads into its block: summed over the model axis and
    regathered over ``data`` in one all-reduce."""
    if axis_info is None:
        return out_proj(params, o, cfg)
    wo = params["wo"].to(cfg.cdtype())
    H_held, hd, d_held = wo.shape
    mesh = axis_info.mesh
    ha = split(H_held, cfg.n_heads, axis_info.model_axis)
    da = split(d_held, cfg.d_model, FSDP_AXIS)
    o = block_of(o.reshape(*o.shape[:-2], -1), -1, ha, mesh)
    return sharded_products(o, [wo.reshape(H_held * hd, d_held)], mesh, sum_axes=ha, out_axes=da)[0]


def init_decode_cache(
    cfg: ModelConfig,
    batch: int,
    seq_len: int,
    n_layers: int,
    dtype: Optional[torch.dtype] = None,
    pad_pages_to: int = 1,
    *,
    device,
    n_stripes: int = 1,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Allocate an empty paged cache for ``n_layers`` attention layers.

    With a sliding window the per-sequence ring is only ``window/T + 1`` pages
    (rolling buffer); otherwise ``seq_len/T`` pages. ``pad_pages_to`` pads
    the pool's page count (unreferenced tail pages) so that it stripes
    evenly over the page axes. Returns (cache, lengths); each cache leaf is
    stacked over layers: pool_k (L, P, T, K, hd), and for int8 pools the f32
    dequant scales scale_k/scale_v (L, P, T, K). With ``n_stripes`` the
    page count is padded on to a multiple of it and the pools (and scales)
    are one stripe of ``P / n_stripes`` pages (every stripe of an empty pool
    is zeros), the tables numbering the whole pool's pages.
    """
    T = cfg.kv_page_tokens
    dtype = dtype or cfg.kvdtype()
    if cfg.sliding_window is not None and cfg.sliding_window < seq_len:
        ring = cfg.sliding_window // T + 1
    else:
        ring = max(seq_len // T, 1)
    n_pages = -(-(batch * ring) // pad_pages_to) * pad_pages_to
    n_pages = -(-n_pages // n_stripes)  # one stripe's pages
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
