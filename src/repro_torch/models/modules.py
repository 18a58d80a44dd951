"""Parameter initialisers, the counterparts of :mod:`repro.models.modules`.

Parameters are nested dicts of tensors with the JAX package's layout.
Initialisers draw from an explicit ``torch.Generator`` and create the tensor
on the generator's device; they give other numbers than ``jax.random`` for
the same seed (weights cross from JAX only through
:func:`repro_torch.convert.params_from_jax`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Tuple[int, ...], dtype) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init for a projection ``(in_dim, *out_shape)``."""
    shape = (in_dim,) + tuple(out_shape)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    w = torch.empty((vocab, dim), dtype=torch.float32, device=gen.device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)
