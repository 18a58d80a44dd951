"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Counterpart of :func:`repro.kernels.flash_attention.flash_attention_pallas`,
without its divisibility assert: any ``Sq`` and ``Sk`` work.
:func:`flash_attention_cuda` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BQ, _BK = 16, 64  # tile sizes compiled into csrc/flash_attention.cu


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


def _lib():
    fn = _build.library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float] + [
            ctypes.c_int, ctypes.c_void_p,
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
    smem = 4 * (2 * _BQ * D + _BK * (D + 1) + _BK * D + _BQ * _BK + 3 * _BQ)
    _check(smem <= 227 * 1024, f"head_dim {D} needs {smem} bytes of shared memory")

    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, K, D, int(causal), window or 0, int(q_start),
            1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
