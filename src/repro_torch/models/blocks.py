"""Dense pre-norm transformer block, the counterpart of the dense branch of
:mod:`repro.models.blocks`. The JAX package's ``lax.scan`` over stacked
layers becomes a Python loop in :mod:`repro_torch.models.lm`."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, rmsnorm
from repro_torch.models.modules import dense_init


def block_init(gen: torch.Generator, cfg: ModelConfig):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype()
    return {
        "ln1": torch.ones((d,), dtype=dt, device=gen.device),
        "attn": attn.attention_init(gen, cfg),
        "ln2": torch.ones((d,), dtype=dt, device=gen.device),
        "ffn": {
            "wi": dense_init(gen, d, (f,), dt),
            "wg": dense_init(gen, d, (f,), dt),
            "wo": dense_init(gen, f, (d,), dt),
        },
    }


def block_apply(
    params, x: torch.Tensor, cfg: ModelConfig, *, return_kv: bool = False,
    impl: Optional[str] = None,
):
    """Full-sequence block (prefill). Returns x, or (x, (k, v))."""
    h = rmsnorm(x, params["ln1"])
    a, kv = attn.attention_train(params["attn"], h, cfg, return_kv=True, impl=impl)
    x = x + a
    x = x + mlp(params["ffn"], rmsnorm(x, params["ln2"]), cfg)
    return (x, kv) if return_kv else x


def block_decode(
    params, x: torch.Tensor, cache: attn.CacheLayer, lengths: torch.Tensor,
    cfg: ModelConfig, *, impl: Optional[str] = None,
):
    h = rmsnorm(x, params["ln1"])
    a, cache = attn.attention_decode(params["attn"], h, cache, lengths, cfg, impl=impl)
    x = x + a
    return x + mlp(params["ffn"], rmsnorm(x, params["ln2"]), cfg), cache
