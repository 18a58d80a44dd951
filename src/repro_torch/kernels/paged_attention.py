"""Paged decode attention: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Counterpart of :func:`repro.kernels.paged_attention.paged_attention_pallas`.
Both functions here return the *unnormalised* ``(o (B,H,D), m (B,H),
l (B,H))`` in f32. :func:`paged_attention_cuda` launches the kernel for CUDA
tensors and takes the plain version only for CPU tensors.

The kernel splits each (sequence, kv-head) over its valid pages. How, is
mirrored here in plain Python for the CPU tests: :func:`launch_plan` (grid,
splits and scratch from static shapes), :func:`valid_pages` and
:func:`page_shares` (which pages a split takes) and :func:`merge_partials`
(how the splits' partial statistics are merged); :func:`padded_width` and
:func:`smem_bytes` give the row width the kernel is compiled for and the
shared memory it asks for.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128  # the kernels take head dims that are multiples of 8 up to this

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def paged_attention_plain(
    q: torch.Tensor,  # (B, H, D)
    pool_k: torch.Tensor,  # (P_local, T, K, D)
    pool_v: torch.Tensor,
    tables: torch.Tensor,  # (B, R) global page ids
    page_pos: torch.Tensor,  # (B, R)
    lengths: torch.Tensor,  # (B,)
    *,
    window: Optional[int] = None,
    page_offset: int = 0,
) -> Stats:
    """Same function as the kernel, in one vectorised pass: gather every
    table page, mask tokens outside ``[lo, length)`` and pages outside
    ``[0, P_local)``, f32 softmax statistics, p forced to 0 where masked."""
    B, H, D = q.shape
    P, T, K, _ = pool_k.shape
    R = tables.shape[1]
    G = H // K
    scale = 1.0 / math.sqrt(D)

    pid = tables.long() - page_offset
    in_range = (pid >= 0) & (pid < P)  # (B, R)
    idx = pid.clamp(0, P - 1)
    k = pool_k[idx].float()  # (B, R, T, K, D)
    v = pool_v[idx].float()
    pos = page_pos.long()[:, :, None] + torch.arange(T, device=q.device)  # (B, R, T)
    length = lengths.long()[:, None, None]
    lo = (length - window).clamp_min(0) if window is not None else torch.zeros_like(length)
    valid = (pos >= lo) & (pos < length) & in_range[:, :, None]
    valid = valid.reshape(B, 1, 1, R * T)

    qg = q.float().reshape(B, K, G, D)
    kk = k.reshape(B, R * T, K, D)
    vv = v.reshape(B, R * T, K, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg, kk) * scale  # (B, K, G, R*T)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)  # (B, K, G)
    p = torch.exp(s - m[..., None]) * valid
    l = p.sum(dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, vv)
    return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


class LaunchPlan(NamedTuple):
    """How the kernel is launched for one set of static shapes."""

    n_splits: int  # S: CTAs that share one (sequence, kv-head, head chunk)
    head_chunk: int  # query heads a CTA keeps in registers (divides H/K)
    grid: Tuple[int, int, int]  # (S, K * H/K/head_chunk, B)
    scratch_bytes: int  # f32 partial (o, m, l) of every split; 0 when S == 1


_HEAD_CHUNKS = (8, 4, 2, 1)
# CTAs of the kernel that fit on one SM at once: every instance uses at most
# 230 registers a thread (ptxas, sm_90a), so at least two CTAs of 128 fit
CTAS_PER_SM = 2


def launch_plan(B: int, H: int, K: int, D: int, R: int, n_sm: int,
                n_splits: Optional[int] = None) -> LaunchPlan:
    """Grid and scratch from static shapes only: batch rows, heads, head
    dim, table width and the card's SM count, never the lengths (they live
    on the device; reading them would be a host sync). S is the most splits
    whose grid still runs in one wave of ``CTAS_PER_SM`` CTAs per SM (a
    second wave would put a whole CTA's latency on the critical path), at
    least 1 and at most one per table entry. ``n_splits`` overrides S
    (``chip_smoke.py`` times other choices)."""
    G = H // K
    chunk = next(c for c in _HEAD_CHUNKS if G % c == 0)
    programs = B * K * (G // chunk)
    S = n_splits or max(1, min(R, CTAS_PER_SM * n_sm // programs))
    scratch = 0 if S == 1 else S * B * H * (D + 2) * 4
    return LaunchPlan(S, chunk, (S, K * (G // chunk), B), scratch)


def valid_pages(table: Sequence[int], pos: Sequence[int], length: int, *, T: int, P: int,
                window: Optional[int] = None, page_offset: int = 0) -> List[int]:
    """Table entries (in table order) that a row's CTAs read, as the kernel
    finds them: page id in ``[0, P)`` after ``page_offset``, and
    ``[page_pos, page_pos + T)`` meets ``[lo, length)``."""
    lo = max(0, length - window) if window else 0
    return [r for r, (pid, base) in enumerate(zip(table, pos))
            if 0 <= pid - page_offset < P and base + T > lo and base < length]


def page_shares(n_valid: int, n_splits: int) -> List[Tuple[int, int]]:
    """The contiguous share ``[start, end)`` of a row's valid pages that each
    split takes: ``[s*n/S, (s+1)*n/S)``; a share may be empty."""
    return [(s * n_valid // n_splits, (s + 1) * n_valid // n_splits) for s in range(n_splits)]


def split_tables(tables: torch.Tensor, page_pos: torch.Tensor, lengths: torch.Tensor, *,
                 T: int, P: int, n_splits: int, window: Optional[int] = None,
                 page_offset: int = 0) -> torch.Tensor:
    """(S, B, R) tables: split s keeps its share of each row's valid pages
    and has the out-of-range id ``page_offset + P`` everywhere else, so that
    the paged function over it computes that split's partial statistics."""
    B, R = tables.shape
    out = torch.full((n_splits, B, R), page_offset + P, dtype=tables.dtype)
    for b in range(B):
        rows = valid_pages(tables[b].tolist(), page_pos[b].tolist(), int(lengths[b]), T=T, P=P,
                           window=window, page_offset=page_offset)
        for s, (lo, hi) in enumerate(page_shares(len(rows), n_splits)):
            for r in rows[lo:hi]:
                out[s, b, r] = tables[b, r]
    return out


def merge_partials(o_parts: torch.Tensor, m_parts: torch.Tensor, l_parts: torch.Tensor) -> Stats:
    """Merge S partial ``(o (S,...,D), m (S,...), l (S,...))`` into one
    unnormalised ``(o, m, l)``: ``online_softmax_combine`` without its final
    division. Empty partials (m = -1e30, l = 0) drop out; all-empty stays
    ``(0, -1e30, 0)``."""
    m = m_parts.amax(dim=0)
    a = torch.exp(m_parts - m[None])
    return (o_parts * a[..., None]).sum(dim=0), m, (l_parts * a).sum(dim=0)


def padded_width(D: int, kv_itemsize: int) -> int:
    """The row width the kernel is instantiated for at head dim ``D``: a
    lane loads N = 16 / itemsize elements, a row takes the next power of two
    of lanes at or above ``ceil(D / N)`` (at least 16 / N), so the width is
    one of 16, 32, 64, 128. Lanes past ``D`` load nothing and add zero."""
    n = 16 // kv_itemsize
    lanes = 16 // n
    while lanes * n < D:
        lanes *= 2
    return lanes * n


def smem_bytes(R: int, head_chunk: int, width: int) -> int:
    """Dynamic shared memory of one CTA: the row's valid page ids and
    positions (2 int32 per table entry) and each warp's (o, m, l) partials
    of ``head_chunk`` heads, staged at the padded ``width``."""
    return 8 * R + 4 * 4 * head_chunk * (width + 2)


def check_head_dim(D: int, who: str) -> None:
    """Both kernels take head dims that are multiples of 8 up to 128 (whole
    16-byte bf16 rows); raise ``ValueError`` for any other."""
    if not (D % 8 == 0 and 8 <= D <= MAX_HEAD_DIM):
        raise ValueError(f"{who}: head_dim {D} is not a multiple of 8 in [8, {MAX_HEAD_DIM}]")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_tickets: Dict[int, torch.Tensor] = {}


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    """Per-device zeroed int32 tickets, kept zeroed by the kernel and grown
    (never shrunk) when a launch needs more; allocated once per size."""
    buf = _tickets.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device.index] = buf
    return buf


def _lib():
    lib = _build.library("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_float] + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    page_pos: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
    page_offset: int = 0,
) -> Stats:
    """Launch the paged decode kernel on CUDA tensors; CPU tensors go to
    :func:`paged_attention_plain`. Counts its launches in ``.launches``."""
    tensors = (q, pool_k, pool_v, tables, page_pos, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_plain(
            q, pool_k, pool_v, tables, page_pos, lengths, window=window, page_offset=page_offset
        )
    _check(all(t.device == q.device for t in tensors) and q.is_cuda,
           "all inputs must lie on one CUDA device")
    B, H, D = q.shape
    _check(pool_k.dim() == 4 and pool_k.shape == pool_v.shape, "pools must be (P, T, K, D)")
    P, T, K, Dk = pool_k.shape
    R = tables.shape[1] if tables.dim() == 2 else -1
    _check(Dk == D and H % K == 0, f"q {tuple(q.shape)} does not fit pool {tuple(pool_k.shape)}")
    _check(tables.shape == (B, R) and page_pos.shape == (B, R) and lengths.shape == (B,) and R > 0,
           "tables/page_pos must be (B, R) and lengths (B,)")
    _check(q.dtype in _DTYPE_CODE and pool_k.dtype in _DTYPE_CODE and pool_v.dtype == pool_k.dtype,
           f"unsupported dtypes q={q.dtype} pool={pool_k.dtype}/{pool_v.dtype}")
    _check(all(t.dtype == torch.int32 for t in (tables, page_pos, lengths)),
           "tables, page_pos and lengths must be int32")
    _check(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _check(window is None or window > 0, "window must be positive")
    check_head_dim(D, "paged_attention_cuda")
    _check(pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0,
           "pools must be 16-byte aligned")
    plan = launch_plan(B, H, K, D, R, _sm_count(q.device.index))
    smem = smem_bytes(R, plan.head_chunk, padded_width(D, pool_k.element_size()))
    _check(smem <= 227 * 1024, f"R={R}, D={D} need {smem} bytes of shared memory")
    out = launch(q, pool_k, pool_v, tables, page_pos, lengths, window, page_offset, plan)
    paged_attention_cuda.launches += 1
    return out


def launch(q, pool_k, pool_v, tables, page_pos, lengths, window, page_offset,
           plan: LaunchPlan) -> Stats:
    """Allocate the outputs and scratch and launch the kernel with ``plan``
    on inputs :func:`paged_attention_cuda` has checked; not counted."""
    B, H, D = q.shape
    P, T, K, _ = pool_k.shape
    R = tables.shape[1]
    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    S = plan.n_splits
    if S > 1:  # one f32 buffer: o_part (S,B,H,D), then m_part and l_part (S,B,H)
        part = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32, device=q.device)
        base, n = part.data_ptr(), S * B * H
        scratch = (base, base + 4 * n * D, base + 4 * n * (D + 1),
                   _ticket_buffer(q.device, plan.grid[1] * B).data_ptr())
    else:
        scratch = (None, None, None, None)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(),
            page_pos.data_ptr(), lengths.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            *scratch, B, H, K, D, T, R, P, window or 0, int(page_offset), 1.0 / math.sqrt(D),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[pool_k.dtype], S, plan.head_chunk, stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention_cuda: launch failed with CUDA error {err}")
    return o, m, l


paged_attention_cuda.launches = 0
