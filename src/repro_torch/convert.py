"""The one way weights cross from the JAX package to the port.

:func:`params_from_jax` takes the JAX parameter pytree of a decoder (the
``dense``, ``moe`` and ``vlm`` families) -- as nested dicts of numpy arrays,
e.g. ``jax.tree.map(np.asarray, params)`` of
``build_model(cfg).init(PRNGKey(0))[0]`` -- and returns the port's params
with the same structure, shapes, dtypes and values. No JAX is imported here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import PORTED


def param_shapes(cfg: ModelConfig) -> Dict:
    """The shape tree of a decoder's params (layer leaves stacked). A MoE
    block's ffn is the f32 router ``(L, d, E)`` and the experts stacked
    ``(L, E, ...)``."""
    L, d, H, K = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, f, V, E = cfg.head_dim, cfg.d_ff, cfg.padded_vocab, cfg.n_experts
    if cfg.is_moe:
        ffn = {"router": (L, d, E), "w1": (L, E, d, f), "wg": (L, E, d, f), "w2": (L, E, f, d)}
    else:
        ffn = {"wi": (L, d, f), "wg": (L, d, f), "wo": (L, f, d)}
    return {
        "embed": {"table": (V, d)},
        "blocks": {
            "ln1": (L, d),
            "attn": {"wq": (L, d, H, hd), "wk": (L, d, K, hd), "wv": (L, d, K, hd),
                     "wo": (L, H, hd, d)},
            "ln2": (L, d),
            "ffn": ffn,
        },
        "ln_f": (d,),
    }


def _to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(x.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _convert(tree, shapes, device, path: Tuple[str, ...]):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"params{list(path)}: expected keys {sorted(shapes)}, got {got}")
        return {k: _convert(tree[k], shapes[k], device, path + (k,)) for k in shapes}
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(shapes):
        raise ValueError(f"params{list(path)}: expected shape {shapes}, got {arr.shape}")
    return _to_torch(arr).to(device)


def params_from_jax(params_np, cfg: ModelConfig, device="cuda"):
    """JAX param pytree (numpy leaves) -> the port's params on ``device``."""
    if cfg.family not in PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1, item 8)")
    device = resolve_device(device)
    return _convert(params_np, param_shapes(cfg), device, ())
