"""Attention ops with implementation dispatch, the counterpart of
:mod:`repro.kernels.ops`.

``impl``:
  * ``None`` (default) -- the hand-written CUDA kernel for CUDA tensors, its
    plain PyTorch version for CPU tensors (the wrappers in
    :mod:`repro_torch.kernels.flash_attention` / ``paged_attention`` decide
    from the tensors' device; a CUDA tensor never falls back);
  * ``"ref"`` -- the quadratic oracles of :mod:`repro_torch.kernels.ref`,
    for tests and for ``chip_smoke.py``'s comparisons only (a paged call
    sharded over ranks takes the plain version's partials of its stripe
    instead, as the JAX package's ``"ref"`` takes its XLA partials);
  * ``"xla"`` (flash attention only) -- the JAX package's own XLA path
    (``_causal_tiled_flash`` over ``_flash_xla``: q-chunks with an f32
    softmax) in plain PyTorch, so that autograd runs through it: the
    training loss's attention, as in the JAX package, whose Pallas kernel
    has no backward either.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain
from repro_torch.parallel import collectives
from repro_torch.parallel.axisinfo import Mesh

_IMPLS = (None, "ref", "xla")


def _check_impl(impl: Optional[str]) -> None:
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {_IMPLS}")


# =============================== flash attention ===============================
def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_start: int = 0,
    q_chunk: int = 1024,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """``q_chunk`` is the query chunk of ``impl="xla"`` (``cfg.attn_chunk``);
    the other paths take no chunk."""
    _check_impl(impl)
    if impl == "ref":
        return _ref.attention_ref(q, k, v, causal=causal, window=window, q_start=q_start)
    if impl == "xla":
        return _causal_tiled_flash(q, k, v, causal=causal, window=window, q_start=q_start, q_chunk=q_chunk)
    return flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        causal=causal, window=window, q_start=q_start,
    )


def _causal_tiled_flash(q, k, v, *, causal, window, q_start, q_chunk):
    """Binary causal tiling around :func:`_flash_xla`, as the JAX package's:
    the lower half of a causal square only needs the first half of the
    keys, so it recurses on that half-size square, (2/3)·S² scores instead
    of S², each query still seeing the same keys in the same chunk order."""
    Sq, Sk = q.shape[1], k.shape[1]
    if not causal or window is not None or Sq != Sk or q_start != 0 or Sq < 2 * q_chunk or Sq % 2:
        return _flash_xla(q, k, v, causal=causal, window=window, q_start=q_start, q_chunk=q_chunk)
    half = Sq // 2
    lo = _causal_tiled_flash(q[:, :half], k[:, :half], v[:, :half],
                             causal=True, window=None, q_start=0, q_chunk=q_chunk)
    hi = _flash_xla(q[:, half:], k, v, causal=True, window=None, q_start=half, q_chunk=q_chunk)
    return torch.cat([lo, hi], dim=1)


def _flash_xla(q, k, v, *, causal, window, q_start, q_chunk):
    """A loop over q-chunks with an f32 softmax (the JAX package's
    ``lax.scan``). With a sliding window each chunk sees a static slice of
    ``window + q_chunk`` keys. Scores are f32 (bf16 operands upcast: their
    products are exact in f32), p is cast to v's dtype before P·V, which
    sums in f32, and each chunk's output is cast to q's dtype."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k = _ref.repeat_kv(k, H)
    v = _ref.repeat_kv(v, H)
    q_chunk = min(q_chunk, Sq)
    if Sq % q_chunk:
        q_chunk = next(c for c in range(q_chunk, 0, -1) if Sq % c == 0)
    scale = 1.0 / (D ** 0.5)
    windowed = window is not None and Sk > window + q_chunk
    w_k = min(Sk, window + q_chunk) if windowed else Sk
    outs = []
    for i in range(Sq // q_chunk):
        chunk_start = q_start + i * q_chunk
        start = min(max(chunk_start - (w_k - q_chunk), 0), Sk - w_k) if windowed else 0
        ks, vs = k[:, start:start + w_k], v[:, start:start + w_k]
        qc = q[:, i * q_chunk:(i + 1) * q_chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), ks.float()) * scale
        qpos = chunk_start + torch.arange(q_chunk, device=q.device)
        kpos = start + torch.arange(w_k, device=q.device)
        mask = torch.ones((q_chunk, w_k), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, torch.full((), _ref.NEG_INF, device=q.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(vs.dtype).float(), vs.float())
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)


# =============================== paged decode attention ===============================
def paged_attention(
    q: torch.Tensor,  # (B, H, D) -- one query token per sequence
    pool_k: torch.Tensor,  # (P_local, T, K, D) -- bf16/f32, or int8 with scales
    pool_v: torch.Tensor,
    tables: torch.Tensor,  # (B, R) global page ids
    page_pos: torch.Tensor,  # (B, R) absolute position of slot 0 of each page
    lengths: torch.Tensor,  # (B,) tokens cached (incl. the one just written)
    *,
    scale_k: Optional[torch.Tensor] = None,  # (P_local, T, K) f32 for int8 pools
    scale_v: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    page_offset: int = 0,
    axis_names: Sequence[str] = (),
    mesh: Optional[Mesh] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Decode attention over the paged pool (the paper's striped-page READ):
    the kernel's unnormalised ``(o, m, l)`` become ``o / max(l, 1e-30)`` in
    q's dtype. An int8 pool (with its per-token scales) is dequantized to
    bf16 first, as the JAX wrapper does, and the kernel reads that.

    With ``axis_names`` (and the ``mesh`` that names them) the pool is this
    rank's stripe of a pool sharded over those axes, its first page the
    global page ``page_offset``: the kernel (or, for ``impl="ref"``, its
    plain version: the JAX rule, which never short-cuts a sharded call to
    the unsharded oracle) computes the partial statistics of this rank's
    pages, and :func:`combine_partials` merges them across the ranks
    (flash-decoding split-K over ranks, lock-free)."""
    _check_impl(impl)
    if pool_k.dtype == torch.int8:
        if scale_k is None or scale_v is None:
            raise ValueError("an int8 pool needs scale_k and scale_v")
        pool_k = dequantize_pool(pool_k, scale_k)
        pool_v = dequantize_pool(pool_v, scale_v)
    if impl == "ref" and not axis_names:
        return _ref.paged_attention_ref(
            q, pool_k, pool_v, tables, page_pos, lengths, window=window
        )
    local = paged_attention_plain if impl == "ref" else paged_attention_cuda
    o, m, l = local(
        q.contiguous(), pool_k, pool_v, tables.to(torch.int32).contiguous(),
        page_pos.to(torch.int32).contiguous(), lengths.to(torch.int32).contiguous(),
        window=window, page_offset=page_offset,
    )
    if axis_names:
        if mesh is None:
            raise ValueError("a sharded paged_attention (axis_names) needs the mesh that names its axes")
        o, l = combine_partials(o, m, l, tuple(axis_names), mesh)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def combine_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, axis_names: Tuple[str, ...],
                     mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge each rank's unnormalised ``(o (B,H,D), m (B,H), l (B,H))`` over
    ``axis_names``: ``m_g = pmax(m)``, then ``o`` and ``l`` scaled by
    ``exp(m - m_g)`` and summed, as the JAX package's ``shard_map`` body
    does. A rank with no page of a row has ``m = -1e30`` and ``o = l = 0``,
    so it adds exact zeros; a row with no token anywhere stays ``o = l = 0``.
    The two sums travel as one all-reduce of ``(B, H, D + 1)``. Returns the
    summed ``(o, l)``."""
    m_g = collectives.pmax(m, axis_names, mesh)
    scale = torch.exp(m - m_g)
    ol = collectives.psum(torch.cat([o * scale[..., None], (l * scale)[..., None]], dim=-1), axis_names, mesh)
    return ol[..., :-1], ol[..., -1]


INT8_MAX = 127.0


def quantize_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, kv-head) symmetric int8 quantization: x (..., K, D) ->
    (q int8 (..., K, D), scale f32 (..., K)); round half to even, as
    ``jnp.round``. Bit-equal to the JAX version, on the CPU and on a card."""
    xf = x.float()
    # a tensor divisor: CUDA divides by a Python scalar as a multiplication
    # by its reciprocal, which can round the scale differently
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / torch.full((), INT8_MAX, device=x.device)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_pool(pool: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(P, T, K, D) int8 x (P, T, K) f32 -> bf16."""
    return (pool.float() * scale[..., None]).to(torch.bfloat16)


# =============================== paged cache update ===============================
def paged_update(
    pool_k: torch.Tensor,  # (P_local, T, K, D)
    pool_v: torch.Tensor,
    tables: torch.Tensor,  # (B, R)
    page_pos: torch.Tensor,  # (B, R)
    lengths: torch.Tensor,  # (B,) tokens cached so far; new token lands at this position
    new_k: torch.Tensor,  # (B, K, D) -- pre-rotated
    new_v: torch.Tensor,
    *,
    scale_k: Optional[torch.Tensor] = None,  # (P_local, T, K) f32 for int8 pools
    scale_v: Optional[torch.Tensor] = None,
    page_offset: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Append one token per sequence (the paper's page WRITE).

    Unlike the JAX version, which returns new arrays, this writes ``pool_k``
    and ``pool_v`` IN PLACE and returns them with a new ``page_pos``: an
    int8 pool gets the token quantized, its scales written in place into
    ``scale_k``/``scale_v``, and returns ``(pool_k, pool_v, page_pos,
    scale_k, scale_v)``.

    Rows whose target page is not local to ``[0, P_local)`` are dropped, as
    the JAX version's scatter drops its out-of-bounds ids, with no host
    synchronisation and no shape that depends on the data (a torch index
    would wrap a negative id or fault on a large one): every row writes,
    but a dropped row writes the first kept row's bytes to the first kept
    row's ``(page, slot)``, so every write there is the same bytes and
    their order cannot matter. When no row is kept, every row writes back
    the bytes already at ``(0, 0)``.
    """
    quant = pool_k.dtype == torch.int8
    if quant and (scale_k is None or scale_v is None):
        raise ValueError("an int8 pool needs scale_k and scale_v")
    P_loc, T, K, D = pool_k.shape
    B, R = tables.shape
    pos = lengths.long()  # 0-indexed position of the incoming token
    r = torch.div(pos, T, rounding_mode="floor") % R
    slot = pos % T
    b_idx = torch.arange(B, device=tables.device)
    local = tables[b_idx, r].long() - page_offset
    keep = (local >= 0) & (local < P_loc)
    # the first kept row (0 when there is none), as a 1-element index: a 0-dim index syncs
    first = keep.int().argmax().reshape(1)
    any_kept = keep.any()
    page = torch.where(keep, local, torch.where(any_kept, local[first], 0))
    slot_w = torch.where(keep, slot, torch.where(any_kept, slot[first], 0))

    def write(pool: torch.Tensor, rows: torch.Tensor) -> None:
        src = torch.where(any_kept, rows[first], pool[0, 0])
        mask = keep.reshape(B, *([1] * (rows.dim() - 1)))
        pool[page, slot_w] = torch.where(mask, rows, src)

    if quant:
        qk, sk = quantize_token(new_k)
        qv, sv = quantize_token(new_v)
        for pool, rows in ((pool_k, qk), (pool_v, qv), (scale_k, sk), (scale_v, sv)):
            write(pool, rows)
    else:
        write(pool_k, new_k.to(pool_k.dtype))
        write(pool_v, new_v.to(pool_v.dtype))
    # recycling a ring page: its slot-0 absolute position becomes pos
    new_base = torch.where(slot == 0, pos.to(page_pos.dtype), page_pos[b_idx, r])
    page_pos = page_pos.clone()
    page_pos[b_idx, r] = new_base
    if quant:
        return pool_k, pool_v, page_pos, scale_k, scale_v
    return pool_k, pool_v, page_pos


def prefill_into_pages(
    k: torch.Tensor,  # (B, S, K, D) pre-rotated
    v: torch.Tensor,
    page_tokens: int,
    extra_pages: int = 1,
    pad_pages_to: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lay out freshly pref't K/V as pages: request b's page p is pool page
    ``b*R + p``. ``extra_pages`` empty pages per sequence give decode
    headroom; ``pad_pages_to`` pads the pool's page count. Returns
    (pool_k, pool_v, tables, page_pos)."""
    B, S, K, D = k.shape
    T = page_tokens
    if S % T:
        raise ValueError(f"sequence length {S} is not a multiple of the page size {T}")
    Rf = S // T
    R = Rf + extra_pages
    pk = k.reshape(B, Rf, T, K, D)
    pv = v.reshape(B, Rf, T, K, D)
    if extra_pages:
        pad = torch.zeros((B, extra_pages, T, K, D), dtype=k.dtype, device=k.device)
        pk = torch.cat([pk, pad], dim=1)
        pv = torch.cat([pv, pad], dim=1)
    pool_k = pk.reshape(B * R, T, K, D)
    pool_v = pv.reshape(B * R, T, K, D)
    n_pool = -(-(B * R) // pad_pages_to) * pad_pages_to
    if n_pool > B * R:
        tail = torch.zeros((n_pool - B * R, T, K, D), dtype=k.dtype, device=k.device)
        pool_k = torch.cat([pool_k, tail], dim=0)
        pool_v = torch.cat([pool_v, tail], dim=0)
    tables = torch.arange(B * R, dtype=torch.int32, device=k.device).reshape(B, R)
    page_pos = (torch.arange(R, dtype=torch.int32, device=k.device) * T)[None, :].repeat(B, 1)
    return pool_k, pool_v, tables, page_pos
