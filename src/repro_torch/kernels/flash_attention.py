"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Counterpart of :func:`repro.kernels.flash_attention.flash_attention_pallas`,
without its divisibility assert: any ``Sq`` and ``Sk`` work.
:func:`flash_attention_cuda` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors. Both take head dims that are
multiples of 8 up to 128. bf16 runs on the tensor cores, compiled for the
padded widths 16, 32, 64, 128 (:func:`tc_width`); f32 on the CUDA cores;
:func:`launch_plan` gives the grid either path launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import check_head_dim

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BQ, _BK = 16, 64  # query rows per warp (bf16) or CTA (f32), keys per tile
_STAGES = 3  # K/V tiles in the bf16 kernel's shared-memory ring
_TC_WIDTHS = (16, 32, 64, 128)  # padded head dims the bf16 tensor-core path is compiled for


def flash_attention_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_start: int = 0,
) -> torch.Tensor:
    """Same function as the kernel, materialised: f32 scores, keys masked
    with the finite sentinel, p forced to 0 where masked, ``acc / max(l,
    1e-30)`` cast to q's dtype (a fully masked row gives 0)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale  # (B, K, G, Sq, Sk)
    qpos = q_start + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p / l.clamp_min(1e-30), v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


class LaunchPlan(NamedTuple):
    """How the kernel is launched for one set of static shapes."""

    heads_per_cta: int  # bf16: query heads of one kv-head per CTA, one warp each
    grid: Tuple[int, int, int]
    threads: int
    smem_bytes: int


def tc_width(D: int) -> int:
    """The padded width the bf16 kernel stages a row at: the least of 16,
    32, 64, 128 at or above ``D`` (columns past ``D`` are zero-filled)."""
    return next(w for w in _TC_WIDTHS if w >= D)


def launch_plan(B: int, Sq: int, H: int, K: int, D: int, dtype: torch.dtype,
                heads_per_cta: Optional[int] = None) -> LaunchPlan:
    """bf16: a CTA holds 16 query rows of ``heads_per_cta`` heads that share
    a kv-head, one warp each, so each K/V tile is staged once for all of
    them: the most heads, at most 4, that divide H/K. At the llama3.2-1b
    prefill shape that is 96 CTAs, fewer than the 132 SMs, and still the
    fastest choice measured (the kernel is bound by latency, not by SMs:
    PERF.md). ``heads_per_cta`` overrides that choice (``chip_smoke.py``
    times the others). f32: one CTA of 128 threads per (16 rows,
    head, batch row)."""
    nq = -(-Sq // _BQ)
    if dtype == torch.float32:
        smem = 4 * (2 * _BQ * D + _BK * (D + 1) + _BK * D + _BQ * _BK + 3 * _BQ)
        return LaunchPlan(1, (nq, H, B), 128, smem)
    hp = heads_per_cta or next(c for c in (4, 2, 1) if (H // K) % c == 0)
    smem = 2 * (tc_width(D) + 8) * (hp * _BQ + 2 * _STAGES * _BK)
    return LaunchPlan(hp, (nq, H // hp, B), 32 * hp, smem)


def _lib():
    fn = _build.library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float] + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_start: int = 0,
) -> torch.Tensor:
    """Launch the flash kernel on CUDA tensors; CPU tensors go to
    :func:`flash_attention_plain`. Counts its launches in ``.launches``."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window, q_start=q_start)
    _check(q.is_cuda and k.device == q.device and v.device == q.device,
           "q, k and v must lie on one CUDA device")
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape, "expected q (B,Sq,H,D), k/v (B,Sk,K,D)")
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    _check(k.shape[0] == B and k.shape[3] == D and H % K == 0,
           f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    _check(q.dtype in _DTYPE_CODE and k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k, v must share one dtype of {list(_DTYPE_CODE)}")
    _check(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(), "inputs must be contiguous")
    _check(window is None or window > 0, "window must be positive")
    _check(Sq > 0 and B > 0, "empty q")
    check_head_dim(D, "flash_attention_cuda")
    if q.dtype == torch.bfloat16:
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), "q, k, v must be 16-byte aligned")
    plan = launch_plan(B, Sq, H, K, D, q.dtype)
    _check(plan.smem_bytes <= 227 * 1024, f"head_dim {D} needs {plan.smem_bytes} bytes of shared memory")

    out = launch(q, k, v, causal, window, q_start, plan)
    flash_attention_cuda.launches += 1
    return out


def launch(q, k, v, causal, window, q_start, plan: LaunchPlan) -> torch.Tensor:
    """Allocate the output and launch the kernel with ``plan`` on inputs
    :func:`flash_attention_cuda` has checked; not counted."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, K, D, int(causal), window or 0, int(q_start),
            1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], plan.heads_per_cta, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with CUDA error {err}")
    return out


flash_attention_cuda.launches = 0
