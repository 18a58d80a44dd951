"""Top-level decoder LM, the serving half of :mod:`repro.models.lm`.

``build_model(cfg)`` returns a :class:`Model` of plain functions:

* ``init(seed=0, device="cuda") -> params`` -- nested dicts with the JAX
  package's layout, per-layer leaves stacked ``(L, ...)`` under ``"blocks"``;
* ``prefill(params, tokens, impl=None) -> (logits, cache)``;
* ``decode_step(params, cache, tokens, impl=None) -> (logits, cache)``, which
  writes the new token's K/V into the cache's pools in place;
* ``init_cache(batch, seq_len, device="cuda") -> cache``.

Serving only: no training loss and no autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed, rmsnorm, unembed
from repro_torch.models.modules import embed_init

_NOT_PORTED = ("moe", "ssm", "hybrid", "encdec", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class Model:
    init: Any
    prefill: Any
    decode_step: Any
    init_cache: Any


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam == "dense":
        return _decoder_lm(cfg)
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"family {fam!r} is not ported yet (ROADMAP Queue 1, item 8)")
    raise ValueError(f"unknown family {fam}")


def serving_params(params, cfg: ModelConfig):
    """The weights held for serving: every block weight and the final norm in
    the compute dtype (the JAX package casts them on every use, so the
    numbers are the same), the tied embedding table left in ``param_dtype``
    for the f32 unembedding."""
    ct = cfg.cdtype()
    cast = lambda t: t.to(ct)  # noqa: E731
    return {
        "embed": params["embed"],
        "blocks": _tree_map(cast, params["blocks"]),
        "ln_f": cast(params["ln_f"]),
    }


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(blocks, i: int):
    return _tree_map(lambda t: t[i], blocks)


def _pool_cache(cfg: ModelConfig, pool_k, pool_v, tables, page_pos) -> Dict[str, torch.Tensor]:
    dt = cfg.kvdtype()
    if dt == torch.int8:
        raise NotImplementedError("int8 KV pools are not ported yet (ROADMAP Queue 1, item 6)")
    return {"pool_k": pool_k.to(dt), "pool_v": pool_v.to(dt),
            "tables": tables, "page_pos": page_pos}


# ================================ decoder-only ================================
def _decoder_lm(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, device="cuda"):
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        table = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype())
        layers = [B.block_init(gen, cfg) for _ in range(cfg.n_layers)]
        blocks = _stack(layers)
        ln_f = torch.ones((cfg.d_model,), dtype=cfg.pdtype(), device=gen.device)
        return {"embed": {"table": table}, "blocks": blocks, "ln_f": ln_f}

    def init_cache(batch: int, seq_len: int, device="cuda"):
        cache, lengths = attn.init_decode_cache(
            cfg, batch, seq_len, cfg.n_layers, device=resolve_device(device)
        )
        return {"kv": cache, "lengths": lengths}

    @torch.no_grad()
    def prefill(params, tokens: torch.Tensor, impl: Optional[str] = None):
        """tokens (B, S), S a multiple of ``kv_page_tokens``. Returns the
        last position's f32 logits (B, padded_vocab) and a paged cache with
        one headroom page per sequence."""
        h = embed(params["embed"], tokens, cfg)
        Bb, S = h.shape[:2]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            h, (k, v) = B.block_apply(_layer(params["blocks"], i), h, cfg, return_kv=True, impl=impl)
            ks.append(k)
            vs.append(v)
        h = rmsnorm(h, params["ln_f"])
        logits = unembed(params["embed"], h[:, -1:], cfg)[:, 0]
        paged = [ops.prefill_into_pages(k, v, cfg.kv_page_tokens, extra_pages=1)
                 for k, v in zip(ks, vs)]
        pool_k, pool_v, tables, page_pos = (torch.stack(parts) for parts in zip(*paged))
        cache = {
            "kv": _pool_cache(cfg, pool_k, pool_v, tables, page_pos),
            "lengths": torch.full((Bb,), S, dtype=torch.int32, device=h.device),
        }
        return logits, cache

    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor, impl: Optional[str] = None):
        """tokens (B,). Appends each sequence's token to the pools in place."""
        h = embed(params["embed"], tokens[:, None], cfg)
        lengths = cache["lengths"]
        kv = cache["kv"]
        page_pos = []
        for i in range(cfg.n_layers):
            layer_cache = {name: t[i] for name, t in kv.items()}
            h, new = B.block_decode(_layer(params["blocks"], i), h, layer_cache, lengths, cfg, impl=impl)
            page_pos.append(new["page_pos"])
        h = rmsnorm(h, params["ln_f"])
        logits = unembed(params["embed"], h, cfg)[:, 0]
        new_kv = dict(kv, page_pos=torch.stack(page_pos))
        return logits, {"kv": new_kv, "lengths": lengths + 1}

    return Model(init, prefill, decode_step, init_cache)


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return torch.stack(layers)
