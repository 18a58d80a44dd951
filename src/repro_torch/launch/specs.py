"""Input specs per (arch × shape), the counterpart of
:mod:`repro.launch.specs`: concrete tensors for smoke runs, or tensors on
the ``meta`` device (torch's stand-in for ``jax.ShapeDtypeStruct``: shape
and dtype, no storage) for the dry run."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_spec(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    if cfg.input_kind == "tokens":
        return {
            "tokens": _spec((batch, seq), torch.int32),
            "labels": _spec((batch, seq), torch.int32),
        }
    if cfg.input_kind == "embeds":
        return {
            "embeds": _spec((batch, seq, cfg.d_model), torch.bfloat16),
            "labels": _spec((batch, seq), torch.int32),
        }
    if cfg.input_kind == "encdec":
        return {
            "enc_embeds": _spec((batch, seq, cfg.d_model), torch.bfloat16),
            "tokens": _spec((batch, seq), torch.int32),
            "labels": _spec((batch, seq), torch.int32),
        }
    raise ValueError(cfg.input_kind)


def prefill_batch_spec(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    spec = train_batch_spec(cfg, batch, seq)
    spec.pop("labels", None)
    return spec


def concrete_batch(cfg: ModelConfig, batch: int, seq: int, mode: str, seed: int = 0, device="cuda"):
    """Materialize a random batch matching the spec: the JAX function's
    numpy draws (``rng.integers`` for int leaves, ``rng.normal`` for the
    others, in key order), cast to the spec's dtype on ``device``."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    spec = train_batch_spec(cfg, batch, seq) if mode == "train" else prefill_batch_spec(cfg, batch, seq)
    out: Dict[str, torch.Tensor] = {}
    for name, s in spec.items():
        if s.dtype == torch.int32:
            out[name] = torch.as_tensor(rng.integers(0, cfg.vocab_size, s.shape), dtype=torch.int32, device=dev)
        else:
            out[name] = torch.as_tensor(rng.normal(0, 1, s.shape), dtype=s.dtype, device=dev)
    return out


def decode_tokens_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return _spec((batch,), torch.int32)
