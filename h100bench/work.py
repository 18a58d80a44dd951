"""The work that the inputs need, counted from the lengths the benchmark
generated, whatever an implementation does to serve them: the yardstick of
the MFU and roofline metrics.

A matrix product of (m, k) by (k, n) counts 2 m k n operations. Attention
counts 4 H hd operations for each (query, key) pair it must see: causal, and
no key more than ``sliding_window - 1`` positions behind its query. A MoE
layer counts its router and the ``top_k`` experts each token reaches. The
unembedding counts the ``vocab_size`` logits of each row that is sampled,
once per prefill. Bytes count each input read once and each output written
once, at the width the data is served in (bf16: 2 bytes).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

ELT = 2  # bytes of a bf16 element


def keys_seen(model: dict, start: int, end: int) -> int:
    """Keys seen by the queries at positions ``start .. end - 1``, causal and windowed."""
    p = np.arange(start, end, dtype=np.int64) + 1
    w = model.get("sliding_window")
    return int(np.minimum(p, w).sum() if w else p.sum())


def token_weight_flops(model: dict) -> int:
    """Operations one token needs in one layer, outside attention's scores."""
    d, H, K, hd, f = (model[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    proj = 2 * d * (H + 2 * K) * hd + 2 * H * hd * d
    E = model.get("n_experts", 0)
    ffn = 2 * d * E + model["top_k"] * 6 * d * f if E else 6 * d * f
    return proj + ffn


def attn_flops(model: dict, keys: int) -> int:
    """Operations of ``keys`` (query, key) pairs in every head of one layer."""
    return 4 * model["n_heads"] * model["head_dim"] * keys


def unembed_flops(model: dict) -> int:
    return 2 * model["d_model"] * model["vocab_size"]


def prefill_flops(model: dict, start: int, end: int) -> int:
    """A prefill that must compute positions ``start .. end - 1`` of a prompt
    of ``end`` tokens (the keys before ``start`` already cached), and one row
    of logits."""
    per_layer = (end - start) * token_weight_flops(model) + attn_flops(model, keys_seen(model, start, end))
    return model["n_layers"] * per_layer + unembed_flops(model)


def decode_flops(model: dict, contexts: Iterable[int]) -> int:
    """One decode step whose rows hold ``contexts`` tokens each, the new one included."""
    total = 0
    for c in contexts:
        keys = min(c, model["sliding_window"]) if model.get("sliding_window") else c
        total += model["n_layers"] * (token_weight_flops(model) + attn_flops(model, keys)) + unembed_flops(model)
    return total


def paged_bytes(model: dict, contexts: Iterable[int]) -> int:
    """One layer's paged attention over rows of ``contexts`` tokens: each
    visible key and value row read once, each query read and each output
    written once."""
    K, H, hd = model["n_kv_heads"], model["n_heads"], model["head_dim"]
    w = model.get("sliding_window")
    total = 0
    for c in contexts:
        total += (min(c, w) if w else c) * 2 * K * hd * ELT + 2 * H * hd * ELT
    return total


def flash_work(model: dict, start: int, end: int):
    """(operations, bytes) of one layer's causal attention for the queries at
    positions ``start .. end - 1`` over the keys up to ``end``: q, k, v read
    once, o written once."""
    K, H, hd = model["n_kv_heads"], model["n_heads"], model["head_dim"]
    flops = attn_flops(model, keys_seen(model, start, end))
    nbytes = ((end - start) * 2 * H + end * 2 * K) * hd * ELT
    return flops, nbytes
