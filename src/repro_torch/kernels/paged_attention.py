"""Paged decode attention: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Counterpart of :func:`repro.kernels.paged_attention.paged_attention_pallas`.
Both functions here return the *unnormalised* ``(o (B,H,D), m (B,H),
l (B,H))`` in f32. :func:`paged_attention_cuda` launches the kernel for CUDA
tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

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


def _lib():
    lib = _build.library("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float] + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
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
    _check(tables.shape == (B, R) and page_pos.shape == (B, R) and lengths.shape == (B,),
           "tables/page_pos must be (B, R) and lengths (B,)")
    _check(q.dtype in _DTYPE_CODE and pool_k.dtype in _DTYPE_CODE and pool_v.dtype == pool_k.dtype,
           f"unsupported dtypes q={q.dtype} pool={pool_k.dtype}/{pool_v.dtype}")
    _check(all(t.dtype == torch.int32 for t in (tables, page_pos, lengths)),
           "tables, page_pos and lengths must be int32")
    _check(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _check(window is None or window > 0, "window must be positive")
    G = H // K
    smem = 4 * (2 * G * D + T * (D + 1) + T * D + G * T + 3 * G)
    _check(smem <= 227 * 1024, f"T={T}, D={D}, G={G} need {smem} bytes of shared memory")

    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(),
            page_pos.data_ptr(), lengths.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, H, K, D, T, R, P, window or 0, int(page_offset), 1.0 / math.sqrt(D),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[pool_k.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention_cuda: launch failed with CUDA error {err}")
    paged_attention_cuda.launches += 1
    return o, m, l


paged_attention_cuda.launches = 0
