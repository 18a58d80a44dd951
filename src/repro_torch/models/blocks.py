"""Pre-norm blocks, the counterpart of :mod:`repro.models.blocks`: the
transformer block (dense or MoE), the encoder-decoder's decoder block (of
:func:`repro.models.lm._encdec_lm`) and the Mamba2 block, and the training
loop over stacked layers with remat (:func:`scan_apply`). The JAX package's
``lax.scan`` over stacked layers becomes a Python loop.

Across ranks the training loss gathers each layer's ``data`` blocks in the
body that :func:`scan_apply` and :func:`checkpoint_wrap` run under remat:
the checkpoint saves the blocks, the gathered copy is freed after the
forward and gathered again in the recomputation, and every rank issues
the same collectives in the same order, in the recomputation too."""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, rmsnorm
from repro_torch.models.modules import dense_init
from repro_torch.parallel.axisinfo import AxisInfo


def mlp_init(gen: torch.Generator, cfg: ModelConfig):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype()
    return {
        "wi": dense_init(gen, d, (f,), dt),
        "wg": dense_init(gen, d, (f,), dt),
        "wo": dense_init(gen, f, (d,), dt),
    }


def _norm_init(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=cfg.pdtype(), device=gen.device)


def block_init(gen: torch.Generator, cfg: ModelConfig):
    params = {"ln1": _norm_init(gen, cfg), "attn": attn.attention_init(gen, cfg), "ln2": _norm_init(gen, cfg)}
    params["ffn"] = moe_mod.moe_init(gen, cfg) if cfg.is_moe else mlp_init(gen, cfg)
    return params


def _ffn(params, h: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo] = None,
         local_batch: bool = False):
    """The feed-forward half: (out, aux loss), aux 0 for a dense block."""
    if cfg.is_moe:
        return moe_mod.moe_ffn(params, h, cfg, axis_info, local_batch=local_batch)
    return mlp(params, h, cfg, axis_info), torch.zeros((), dtype=torch.float32, device=h.device)


def block_apply(
    params, x: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo] = None, *, causal: bool = True,
    return_kv: bool = False, impl: Optional[str] = None, local_batch: bool = False,
):
    """Full-sequence block (prefill, encoder, training). Returns (x, aux),
    or (x, aux, (k, v)). Under ``axis_info`` the weights are whole or hold
    this rank's heads, ffn columns or experts (their ``embed`` dims whole:
    prefill and training regather them first), which run split over the model axis;
    the returned K/V hold every kv head. ``local_batch``: ``x`` is this
    rank's data shard (training, prefill; :func:`moe_mod.moe_ffn`)."""
    h = rmsnorm(x, params["ln1"])
    a = attn.attention_train(params["attn"], h, cfg, causal=causal, return_kv=return_kv, impl=impl,
                             axis_info=axis_info)
    a, kv = a if return_kv else (a, None)
    x = x + a
    f, aux = _ffn(params["ffn"], rmsnorm(x, params["ln2"]), cfg, axis_info, local_batch)
    x = x + f
    return (x, aux, kv) if return_kv else (x, aux)


def block_decode(
    params, x: torch.Tensor, cache: attn.CacheLayer, lengths: torch.Tensor,
    cfg: ModelConfig, axis_info: Optional[AxisInfo] = None, *, impl: Optional[str] = None,
):
    h = rmsnorm(x, params["ln1"])
    a, cache = attn.attention_decode(params["attn"], h, cache, lengths, cfg, axis_info, impl=impl)
    x = x + a
    f, _ = _ffn(params["ffn"], rmsnorm(x, params["ln2"]), cfg, axis_info)
    return x + f, cache


# ------------------------------ encoder-decoder's decoder block ------------------------------
def dec_block_init(gen: torch.Generator, cfg: ModelConfig):
    """Causal self-attention, cross-attention over the encoder, dense MLP,
    each behind its norm (the JAX package's ``_encdec_lm.dec_block_init``)."""
    return {"ln1": _norm_init(gen, cfg), "self": attn.attention_init(gen, cfg), "ln2": _norm_init(gen, cfg),
            "cross": attn.attention_init(gen, cfg), "ln3": _norm_init(gen, cfg), "mlp": mlp_init(gen, cfg)}


def dec_block_apply(params, x: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig, *,
                    impl: Optional[str] = None, axis_info: Optional[AxisInfo] = None, return_kv: bool = True):
    """Full-sequence decoder block (prefill, training). Returns (x, the
    self-attention's (k, v), or None without ``return_kv``)."""
    a = attn.attention_train(params["self"], rmsnorm(x, params["ln1"]), cfg, return_kv=return_kv, impl=impl,
                             axis_info=axis_info)
    a, kv = a if return_kv else (a, None)
    x = x + a
    x = x + attn.attention_train(params["cross"], rmsnorm(x, params["ln2"]), cfg, kv_src=enc_out, impl=impl,
                                 axis_info=axis_info)
    return x + mlp(params["mlp"], rmsnorm(x, params["ln3"]), cfg, axis_info), kv


def dec_block_decode(params, x: torch.Tensor, self_cache: attn.CacheLayer, cross_cache: attn.CacheLayer,
                     lengths: torch.Tensor, enc_len: torch.Tensor, cfg: ModelConfig,
                     axis_info: Optional[AxisInfo] = None, *, impl: Optional[str] = None):
    """One decode step of a decoder block: self-attention appends to
    ``self_cache`` (in place), cross-attention reads ``cross_cache`` (never
    written) over ``enc_len`` tokens; under ``axis_info`` both pools are
    striped. Returns (x, the new self cache)."""
    a, self_cache = attn.attention_decode(params["self"], rmsnorm(x, params["ln1"]), self_cache, lengths, cfg,
                                          axis_info, impl=impl)
    x = x + a
    a, _ = attn.attention_decode(params["cross"], rmsnorm(x, params["ln2"]), cross_cache, enc_len, cfg,
                                 axis_info, update=False, rope=False, impl=impl)
    x = x + a
    return x + mlp(params["mlp"], rmsnorm(x, params["ln3"]), cfg, axis_info), self_cache


# ------------------------------ ssm block ------------------------------
def ssm_block_init(gen: torch.Generator, cfg: ModelConfig):
    return {"ln": torch.ones((cfg.d_model,), dtype=cfg.pdtype(), device=gen.device),
            "ssm": ssm_mod.ssm_init(gen, cfg)}


def ssm_block_apply(params, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False,
                    axis_info: Optional[AxisInfo] = None):
    """x + mixer(norm(x)); with ``return_state`` also the mixer's state for decode."""
    if not return_state:
        return x + ssm_mod.ssm_forward(params["ssm"], rmsnorm(x, params["ln"]), cfg, axis_info=axis_info)
    y, state = ssm_mod.ssm_forward(params["ssm"], rmsnorm(x, params["ln"]), cfg, return_state=True,
                                   axis_info=axis_info)
    return x + y, state


def ssm_block_decode(params, x: torch.Tensor, state: ssm_mod.SSMState, cfg: ModelConfig,
                     axis_info: Optional[AxisInfo] = None):
    y, state = ssm_mod.ssm_decode(params["ssm"], rmsnorm(x, params["ln"]), state, cfg, axis_info)
    return x + y, state


# ------------------------------ remat and the layer loop ------------------------------
def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``dots_with_no_batch_dims_saveable``: keep the outputs of matrix
    products without batch dims (the 2-D ``mm`` a projection lowers to),
    recompute everything else (``bmm``, the attention einsums, included)."""
    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default else CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_wrap(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under the config's remat policy: ``"none"`` as it is,
    ``"full"`` saving only its inputs, ``"dots"`` also the outputs of
    matrix products without batch dims."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=context)
    raise ValueError(f"unknown remat {cfg.remat!r}")


def unstack(tree, n: int) -> List:
    """A tree of stacked ``(n, ...)`` leaves as ``n`` per-layer trees, each
    leaf taken by one ``unbind``: its backward stacks the layers' gradients
    once, where indexing each layer would allocate a zero tensor the size of
    the whole stack per layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def scan_apply(layers: List, x: torch.Tensor, body_fn: Callable, cfg: ModelConfig):
    """``body_fn(layer_params, x) -> (x, aux)`` over the per-layer trees
    ``layers`` (:func:`unstack`), each ``cfg.remat_group`` layers under one
    checkpoint when the group divides the depth (else each layer under its
    own); the aux losses summed in f32. Returns (x, aux)."""
    g = cfg.remat_group if cfg.remat_group > 1 and len(layers) % cfg.remat_group == 0 else 1

    def group_fn(x, *group):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in group:
            x, a = body_fn(lp, x)
            aux = aux + a
        return x, aux

    wrapped = checkpoint_wrap(group_fn, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, len(layers), g):
        x, a = wrapped(x, *layers[i:i + g])
        aux = aux + a
    return x, aux
