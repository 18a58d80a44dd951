"""The one way weights cross from the JAX package to the port.

:func:`params_from_jax` takes the JAX parameter pytree of a ported family
(every family: ``dense``, ``moe``, ``vlm``, ``ssm``, ``hybrid``,
``encdec``/``audio``) -- as nested dicts of numpy arrays,
e.g. ``jax.tree.map(np.asarray, params)`` of
``build_model(cfg).init(PRNGKey(0))[0]`` -- and returns the port's params
with the same structure, shapes, dtypes and values; :func:`opt_state_from_jax`
does the same for the AdamW state. Given an ``axis_info`` it returns this
rank's params instead, cut before they are copied: in the ``"jax"``
layout every leaf's ``param_shardings`` block (what serving and training
across ranks take), in the ``"experts"`` layout the expert weights cut to
the rank's shard (:func:`repro_torch.parallel.sharding.local_param_specs`).
No JAX is imported here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import PORTED
from repro_torch.parallel.axisinfo import AxisInfo
from repro_torch.parallel.sharding import param_specs, shard_leaf


def _attn_block_shapes(cfg: ModelConfig, *lead: int) -> Dict:
    """A transformer block's shapes, each leaf behind the ``lead`` axes. A
    MoE block's ffn is the f32 router ``(d, E)`` and the experts stacked
    ``(E, ...)``."""
    d, H, K, hd, f, E = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.n_experts
    if cfg.is_moe:
        ffn = {"router": (d, E), "w1": (E, d, f), "wg": (E, d, f), "w2": (E, f, d)}
    else:
        ffn = {"wi": (d, f), "wg": (d, f), "wo": (f, d)}
    block = {"ln1": (d,), "attn": {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd), "wo": (H, hd, d)},
             "ln2": (d,), "ffn": ffn}
    return _prefix(block, lead)


def _dec_block_shapes(cfg: ModelConfig, *lead: int) -> Dict:
    """An encoder-decoder's decoder block: self- and cross-attention and a
    dense MLP, each behind its norm, each leaf behind the ``lead`` axes."""
    d, f = cfg.d_model, cfg.d_ff
    block = _attn_block_shapes(cfg)
    block = {"ln1": (d,), "self": block["attn"], "ln2": (d,), "cross": block["attn"], "ln3": (d,),
             "mlp": {"wi": (d, f), "wg": (d, f), "wo": (f, d)}}
    return _prefix(block, lead)


def _ssm_block_shapes(cfg: ModelConfig, *lead: int) -> Dict:
    """A Mamba2 block's shapes, each leaf behind the ``lead`` axes."""
    d, di, n, g, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    ssm = {"in_proj": (d, 2 * di + 2 * g * n + h), "conv_w": (cfg.ssm_conv, conv_dim),
           "conv_b": (conv_dim,), "A_log": (h,), "D": (h,), "dt_bias": (h,), "norm": (di,),
           "out_proj": (di, d)}
    return _prefix({"ln": (d,), "ssm": ssm}, lead)


def _prefix(shapes, lead: Tuple[int, ...]):
    if isinstance(shapes, dict):
        return {k: _prefix(v, lead) for k, v in shapes.items()}
    return tuple(lead) + tuple(shapes)


def param_shapes(cfg: ModelConfig) -> Dict:
    """The shape tree of a model's params. Decoders (``dense``, ``moe``,
    ``vlm``) and ``ssm`` stack their blocks ``(L, ...)`` under ``"blocks"``;
    ``hybrid`` stacks its Mamba2 blocks ``(n_groups, per_group, ...)`` under
    ``"mamba"`` beside one ``"shared_attn"`` transformer block; the
    encoder-decoder stacks ``"encoder"`` blocks ``(L_enc, ...)`` and
    ``"decoder"`` blocks ``(L_dec, ...)`` beside the norms ``"ln_enc"`` and
    ``"ln_dec"``."""
    if cfg.family not in PORTED:
        raise ValueError(f"unknown family {cfg.family!r}")
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    top = {"embed": {"table": (V, d)}}
    if cfg.family in ("encdec", "audio"):
        top.update(encoder=_attn_block_shapes(cfg, cfg.n_enc_layers),
                   decoder=_dec_block_shapes(cfg, cfg.n_dec_layers), ln_enc=(d,), ln_dec=(d,))
        return top
    if cfg.family == "hybrid":
        top["mamba"] = _ssm_block_shapes(cfg, L // cfg.attn_every, cfg.attn_every)
        top["shared_attn"] = _attn_block_shapes(cfg)
    elif cfg.family == "ssm":
        top["blocks"] = _ssm_block_shapes(cfg, L)
    else:
        top["blocks"] = _attn_block_shapes(cfg, L)
    top["ln_f"] = (d,)
    return top


def _to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(x.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _convert(tree, shapes, device, path: Tuple[str, ...], take=lambda path, arr: arr):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"params{list(path)}: expected keys {sorted(shapes)}, got {got}")
        return {k: _convert(tree[k], shapes[k], device, path + (k,), take) for k in shapes}
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(shapes):
        raise ValueError(f"params{list(path)}: expected shape {shapes}, got {arr.shape}")
    return _to_torch(take(path, arr)).to(device)


def params_from_jax(params_np, cfg: ModelConfig, device="cuda", axis_info: Optional[AxisInfo] = None,
                    layout: str = "experts"):
    """JAX param pytree (numpy leaves) -> the port's params on ``device``;
    with ``axis_info``, this rank's in ``layout``: ``"jax"`` (every leaf's
    block) or ``"experts"`` (its experts or expert ffn columns)."""
    shapes = param_shapes(cfg)
    device = resolve_device(device)
    if axis_info is None:
        return _convert(params_np, shapes, device, ())
    specs = param_specs(cfg, axis_info, layout)

    def take(path, arr):
        spec = specs
        for k in path:
            spec = spec[k]
        return shard_leaf(arr, spec, axis_info)

    return _convert(params_np, shapes, device, (), take)


def opt_state_from_jax(opt_state_np, cfg: ModelConfig, device="cuda"):
    """JAX AdamW state (numpy leaves: ``{"m", "v", "step"}``, as
    ``jax.tree.map(np.asarray, adamw_init(params))``) -> the port's on
    ``device``: the moments mapped as :func:`params_from_jax` maps the
    params, ``step`` a 0-dim int32 tensor."""
    device = resolve_device(device)
    return {"m": params_from_jax(opt_state_np["m"], cfg, device),
            "v": params_from_jax(opt_state_np["v"], cfg, device),
            "step": torch.tensor(int(np.asarray(opt_state_np["step"])), dtype=torch.int32, device=device)}
