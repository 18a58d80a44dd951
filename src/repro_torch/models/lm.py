"""Top-level decoder LM, the serving half of :mod:`repro.models.lm`.

``build_model(cfg)`` returns a :class:`Model` of plain functions:

* ``init(seed=0, device="cuda", dtype=None) -> params`` -- nested dicts with
  the JAX package's layout, per-layer leaves stacked ``(L, ...)`` under
  ``"blocks"``;
* ``prefill(params, inputs, impl=None) -> (logits, cache)``, ``inputs``
  tokens ``(B, S)`` or embeddings ``(B, S, d)``;
* ``decode_step(params, cache, tokens, impl=None) -> (logits, cache)``, which
  writes the new token's K/V into the cache's pools in place;
* ``init_cache(batch, seq_len, device="cuda") -> cache``.

Families ``dense``, ``moe`` and ``vlm`` (the decoder with an embeddings
input). Serving only: no training loss and no autograd.
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

PORTED = ("dense", "moe", "vlm")  # the decoder families, all served by _decoder_lm
_NOT_PORTED = ("ssm", "hybrid", "encdec", "audio")


@dataclasses.dataclass(frozen=True)
class Model:
    init: Any
    prefill: Any
    decode_step: Any
    init_cache: Any


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in PORTED:
        return _decoder_lm(cfg)
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"family {fam!r} is not ported yet (ROADMAP Queue 1, item 8)")
    raise ValueError(f"unknown family {fam}")


def serving_params(params, cfg: ModelConfig):
    """The weights held for serving: every block weight and the final norm in
    the compute dtype (the JAX package casts them on every use, so the
    numbers are the same), except the MoE router, which stays f32 as the
    gates are computed from it in f32; the tied embedding table left in
    ``param_dtype`` for the f32 unembedding. A leaf already in its serving
    dtype is kept, not copied."""
    ct = cfg.cdtype()
    return {
        "embed": params["embed"],
        "blocks": _tree_map(lambda key, t: t.to(_serving_dtype(key, ct)), params["blocks"]),
        "ln_f": params["ln_f"].to(ct),
    }


def _serving_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if key == "router" else dtype


def _tree_map(fn, tree, key: str = ""):
    """Map ``fn(leaf_key, leaf)`` over a tree of dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k) for k, v in tree.items()}
    return fn(key, tree)


def _layer(blocks, i: int):
    return _tree_map(lambda _, t: t[i], blocks)


def _pool_cache(cfg: ModelConfig, pool_k, pool_v, tables, page_pos) -> Dict[str, torch.Tensor]:
    dt = cfg.kvdtype()
    if dt == torch.int8:
        raise NotImplementedError("int8 KV pools are not ported yet (ROADMAP Queue 1, item 6)")
    return {"pool_k": pool_k.to(dt), "pool_v": pool_v.to(dt),
            "tables": tables, "page_pos": page_pos}


# ================================ decoder-only ================================
def _decoder_lm(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, device="cuda", dtype: Optional[torch.dtype] = None):
        """Random weights from ``seed``. Each stacked block leaf is allocated
        once and filled layer by layer, so the peak is the stacked weights
        plus one layer as drawn. With ``dtype`` (for serving: the compute
        dtype) the block weights and the final norm are stored in it, the
        MoE router excepted, so that :func:`serving_params` copies nothing;
        the values are those of the default init cast to ``dtype``."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        table = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype())
        blocks = None
        for i in range(cfg.n_layers):
            layer = B.block_init(gen, cfg)
            if blocks is None:
                blocks = _tree_map(
                    lambda key, t: torch.empty((cfg.n_layers, *t.shape), device=t.device,
                                               dtype=_serving_dtype(key, dtype) if dtype else t.dtype),
                    layer)
            _copy_layer(blocks, layer, i)
            del layer
        ln_f = torch.ones((cfg.d_model,), dtype=dtype or cfg.pdtype(), device=gen.device)
        return {"embed": {"table": table}, "blocks": blocks, "ln_f": ln_f}

    def init_cache(batch: int, seq_len: int, device="cuda"):
        cache, lengths = attn.init_decode_cache(
            cfg, batch, seq_len, cfg.n_layers, device=resolve_device(device)
        )
        return {"kv": cache, "lengths": lengths}

    @torch.no_grad()
    def prefill(params, inputs: torch.Tensor, impl: Optional[str] = None):
        """``inputs``: tokens (B, S) or, as ``_inputs_to_h`` takes them,
        embeddings (B, S, d) (a floating tensor); S a multiple of
        ``kv_page_tokens``. Returns the last position's f32 logits
        (B, padded_vocab) and a paged cache with one headroom page per
        sequence."""
        if inputs.is_floating_point():
            h = inputs.to(cfg.cdtype())
        else:
            h = embed(params["embed"], inputs, cfg)
        Bb, S = h.shape[:2]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            h, _, (k, v) = B.block_apply(_layer(params["blocks"], i), h, cfg, return_kv=True, impl=impl)
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


def _copy_layer(stacked, layer, i: int) -> None:
    """stacked[...][i] = layer[...], leaf by leaf (casting to the stack's dtype)."""
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)
