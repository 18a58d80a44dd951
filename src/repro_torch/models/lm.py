"""Top-level models, one constructor per family, the counterpart of
:mod:`repro.models.lm`.

``build_model(cfg)`` returns a :class:`Model` of plain functions:

* ``init(seed=0, device="cuda", dtype=None, axis_info=None) -> params`` --
  nested dicts with the JAX package's layout, per-layer leaves stacked
  ``(L, ...)`` (the hybrid's Mamba2 layers ``(n_groups, per_group, ...)``);
  with ``axis_info`` this rank's blocks of the ``"jax"`` layout, each layer
  drawn whole and cut, so that no more than one layer's full leaves are
  ever held (bit-equal to the blocks of the unsharded init);
* ``prefill(params, inputs, impl=None, axis_info=None) -> (logits, cache)``,
  ``inputs`` tokens ``(B, S)`` or embeddings ``(B, S, d)``, or for the
  encoder-decoder the JAX package's batch dict ``{"enc_embeds": (B, S_enc,
  d)[, "tokens": (B, S_dec)]}``;
* ``decode_step(params, cache, tokens, impl=None, axis_info=None) ->
  (logits, cache)``, which writes the new token's K/V (and an int8 pool's
  scales) into the cache's pools and the new SSM states into its state
  stacks, in place;
* ``init_cache(batch, seq_len, device="cuda", pad_pages_to=1, axis_info=None)
  -> cache``, with ``axis_info`` this rank's cache as
  :func:`repro_torch.parallel.sharding.shard_cache` cuts it (the pools'
  stripe, the SSM states' rows), no more allocated;
* ``train_loss(params, batch, impl="xla", axis_info=None, denom=None) -> (loss, metrics)``, ``batch``
  the JAX package's dict: ``tokens`` (or ``embeds`` for a ``vlm`` backbone;
  ``enc_embeds`` and ``tokens`` for the encoder-decoder) and ``labels``
  (-1 is padding). Differentiable: autograd runs through it, remat as
  ``cfg.remat`` says.

Families ``dense``, ``moe`` and ``vlm`` (the decoder with an embeddings
input), ``ssm`` (Mamba2), ``hybrid`` (Mamba2 groups with one shared
attention block after each), and ``encdec``/``audio`` (an encoder over
precomputed frame embeddings and a decoder with cross-attention): every
family of the JAX package. ``prefill`` and ``decode_step`` run without
autograd; the training loss's attention is ``ops.flash_attention``'s
``impl="xla"`` (the JAX package's XLA path in plain PyTorch), chosen by
``use_pallas=False`` as in the JAX package, whose Pallas kernel has no
backward; neither CUDA kernel runs in training.

Across ranks (``axis_info``, one process per rank; see
:mod:`repro_torch.parallel.sharding`), every path takes the params in the
JAX package's layout (each leaf its ``param_shardings`` block: FSDP over
``data``, heads, ffn, vocab, the SSM projections and the experts over
``model``); the layout the port trained in first (experts split, every
other leaf whole) is read too: the model code reads each leaf's split from
its shape:

* ``prefill`` takes the global batch and computes this rank's block of its
  rows over the batch axes (every row when they do not divide,
  :func:`_row_block`). Layer by layer it regathers the layer's ``data``
  blocks (FSDP, the gathered copy freed before the next layer) and runs
  the heads, ffn and experts split over the model axis. It returns this
  rank's rows of the logits (the vocab whole, as the JAX package's
  ``out_shardings``) and a decode cache without headroom pages (the JAX
  package's distributed rule: the engine's allocator owns headroom) whose
  pools are already this rank's stripe (:func:`_layer_pages`) and whose
  SSM states are those of this rank's rows (``cache_shardings``' blocks);
* ``decode_step`` keeps the rows replicated on every rank and the weights
  on their ranks: every product is a partial over the weight's block,
  summed, and only activations move (``layers.sharded_products``). It
  takes the pools striped and the SSM states as this rank's rows: each
  Mamba2 layer's conv and scan run on those rows alone, and their gated
  output is regathered over the batch axes before ``out_proj``
  (:func:`repro_torch.models.ssm.ssm_decode`);
* ``train_loss`` takes a global (micro)batch, as the JAX package's does,
  and computes on this rank's block of its rows (every row when they do
  not divide over the batch axes), or, with ``denom``, a batch that is
  already this rank's rows: its loss and metrics are the rank's shares,
  whose sums over the batch axes are the JAX package's values
  (:func:`_shard_batch`). Each layer's ``data`` blocks are gathered inside
  the remat region (their gradients reduce-scattered in the backward),
  the model axis runs tensor-parallel as in prefill, and the
  cross-entropy is vocab-parallel (``layers.cross_entropy(axes=)``); the
  collectives are the autograd forms of
  :mod:`repro_torch.parallel.collectives`.

The JAX package's layout hints (``constrain_batch``, ``_constrain_logits``)
have no effect on the numbers and no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import blocks as B
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cross_entropy, embed, rmsnorm, unembed, vocab_axes
from repro_torch.models.modules import embed_init
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axisinfo import AxisInfo
from repro_torch.parallel.sharding import FSDP_AXIS, WHOLE_AT_USE

PORTED = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec", "audio")
MOE_AUX_WEIGHT = 0.01

# leaves the JAX package uses in f32 whatever the compute dtype: the MoE
# router (gates in f32), the SSM decay, skip and dt bias (used uncast), and
# the gated norm's scale (applied in f32)
_F32_LEAVES = ("router", "A_log", "D", "dt_bias", "norm")


@dataclasses.dataclass(frozen=True)
class Model:
    init: Any
    prefill: Any
    decode_step: Any
    init_cache: Any
    train_loss: Any


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return _decoder_lm(cfg)
    if fam == "ssm":
        return _ssm_lm(cfg)
    if fam == "hybrid":
        return _hybrid_lm(cfg)
    if fam in ("encdec", "audio"):
        return _encdec_lm(cfg)
    raise ValueError(f"unknown family {fam}")


def _prefixed(axes, *lead: str):
    if isinstance(axes, dict):
        return {k: _prefixed(v, *lead) for k, v in axes.items()}
    return tuple(lead) + tuple(axes)


def _attn_axes():
    return {"wq": ("embed", "q_heads", "head"), "wk": ("embed", "kv_heads", "head"),
            "wv": ("embed", "kv_heads", "head"), "wo": ("q_heads", "head", "embed")}


_MLP_AXES = {"wi": ("embed", "ffn"), "wg": ("embed", "ffn"), "wo": ("ffn", "embed")}
_MOE_AXES = {"router": ("embed", "experts_router"), "w1": ("experts", "embed", "moe_ffn"),
             "wg": ("experts", "embed", "moe_ffn"), "w2": ("experts", "moe_ffn", "embed")}
_SSM_AXES = {"in_proj": ("embed", "ssm_proj"), "conv_w": ("conv", "ssm_conv_dim"), "conv_b": ("ssm_conv_dim",),
             "A_log": ("ssm_heads",), "D": ("ssm_heads",), "dt_bias": ("ssm_heads",), "norm": ("ssm_inner",),
             "out_proj": ("ssm_inner", "embed")}
_NORM = ("embed",)


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axis names of every parameter, a tree equal to the axes
    tree the JAX package's ``model.init`` returns beside its params (the
    port's own init returns params alone): stacked leaves get ``"layers"``
    in front, the hybrid's Mamba2 stack ``("groups", "layers")``."""
    if cfg.family not in PORTED:
        raise ValueError(f"unknown family {cfg.family}")
    block = {"ln1": _NORM, "attn": _attn_axes(), "ln2": _NORM, "ffn": _MOE_AXES if cfg.is_moe else _MLP_AXES}
    ssm_block = {"ln": _NORM, "ssm": _SSM_AXES}
    top = {"embed": {"table": ("vocab", "embed_table")}}
    if cfg.family in ("encdec", "audio"):
        dec = {"ln1": _NORM, "self": _attn_axes(), "ln2": _NORM, "cross": _attn_axes(), "ln3": _NORM,
               "mlp": _MLP_AXES}
        top.update(encoder=_prefixed(block, "layers"), decoder=_prefixed(dec, "layers"), ln_enc=_NORM,
                   ln_dec=_NORM)
        return top
    if cfg.family == "hybrid":
        top.update(mamba=_prefixed(ssm_block, "groups", "layers"), shared_attn=_prefixed(block))
    elif cfg.family == "ssm":
        top["blocks"] = _prefixed(ssm_block, "layers")
    else:
        top["blocks"] = _prefixed(block, "layers")
    top["ln_f"] = _NORM
    return top


def serving_params(params, cfg: ModelConfig):
    """The weights held for serving: every leaf but the embedding table in
    the compute dtype (the JAX package casts them on every use, so the
    numbers are the same), except the leaves it uses in f32
    (``_F32_LEAVES``), which stay f32; the tied embedding table left in
    ``param_dtype`` for the f32 unembedding. A leaf already in its serving
    dtype is kept, not copied."""
    ct = cfg.cdtype()
    return {k: v if k == "embed" else _tree_map(lambda key, t: t.to(_serving_dtype(key, ct)), v)
            for k, v in params.items()}


def _serving_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if key in _F32_LEAVES else dtype


def _tree_map(fn, tree, key: str = ""):
    """Map ``fn(leaf_key, leaf)`` over a tree of dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k) for k, v in tree.items()}
    return fn(key, tree)


def _layer(blocks, i: int):
    return _tree_map(lambda _, t: t[i], blocks)


def _stack_init(gen: torch.Generator, n_layers: int, init_one, dtype: Optional[torch.dtype], keep=None):
    """``n_layers`` draws of ``init_one(gen)`` stacked ``(n_layers, ...)``.
    Each stacked leaf is allocated once and filled layer by layer, so the
    peak is the stacked weights plus one layer as drawn; with ``dtype`` the
    leaves are stored in it (``_F32_LEAVES`` in f32); ``keep(layer)`` maps
    each layer as drawn to what is stored (this rank's blocks)."""
    stacked = None
    for i in range(n_layers):
        layer = init_one(gen)
        if keep is not None:
            layer = keep(layer)
        if stacked is None:
            stacked = _tree_map(
                lambda key, t: torch.empty((n_layers, *t.shape), device=t.device,
                                           dtype=_serving_dtype(key, dtype) if dtype else t.dtype),
                layer)
        _copy_layer(stacked, layer, i)
        del layer
    return stacked


def _copy_layer(stacked, layer, i: int) -> None:
    """stacked[...][i] = layer[...], leaf by leaf (casting to the stack's dtype)."""
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def _blocks(tree, specs, axis_info: Optional[AxisInfo], copy: bool = True):
    """This rank's blocks of ``tree`` under ``specs`` (copies unless not
    ``copy``); the tree itself without an ``axis_info``."""
    if axis_info is None:
        return tree
    return shd._map(lambda _, t, s: (shd.shard_leaf(t, s, axis_info).clone() if copy else
                                     shd.shard_leaf(t, s, axis_info)) if len(s) else t, tree, specs)


def _init_specs(axis_info: Optional[AxisInfo], cfg: ModelConfig):
    """The ``"jax"`` layout's specs for an init under ``axis_info``, else None."""
    return None if axis_info is None else shd.jax_specs(cfg, axis_info)


def _stack_keep(specs, axis_info: Optional[AxisInfo], lead: int = 1):
    """``_stack_init``'s ``keep``: a drawn layer's blocks (views, copied into the stack)."""
    if axis_info is None:
        return None
    layer = shd.layer_specs(specs, lead)
    return lambda tree: _blocks(tree, layer, axis_info, copy=False)


def _row_block(n_rows: int, axis_info: Optional[AxisInfo]) -> Optional[slice]:
    """The rows of a global batch this rank prefills: its block over the
    batch axes when they divide ``n_rows`` (``_shard_batch``'s rule), else
    None (every row)."""
    if axis_info is None or n_rows % axis_info.n_batch_shards:
        return None
    return shd.row_block(n_rows, axis_info)


def _take_rows(inputs, rows: Optional[slice]):
    """``inputs`` (a tensor or a dict of them) cut to ``rows``."""
    if rows is None:
        return inputs
    if isinstance(inputs, dict):
        return {k: v[rows] for k, v in inputs.items()}
    return inputs[rows]


def _held(params, cfg: ModelConfig, axis_info: Optional[AxisInfo]):
    """The specs ``params`` are held in (checked against the ``"jax"``
    layout), or None without an ``axis_info``."""
    return None if axis_info is None else shd.held_specs(params, cfg, axis_info)


def _gathered_layer(lp, specs, axis_info: Optional[AxisInfo]):
    """One layer's weights as a prefill or a training step under
    ``axis_info`` uses them: every ``data`` block regathered (FSDP: one
    all-reduce, freed with the layer; in training its backward is the
    reduce-scatter of the layer's gradients), and the leaves used whole
    regathered over the model axis too."""
    if axis_info is None:
        return lp
    lp, specs = shd.gather_over(lp, specs, axis_info, (FSDP_AXIS,))
    return shd.gather_over(lp, specs, axis_info, (axis_info.model_axis,), keys=WHOLE_AT_USE)[0]


def _decode_params(params, specs, axis_info: Optional[AxisInfo]):
    """The params a decode step under ``axis_info`` uses: the leaves used
    whole (norm scales, conv taps, gated norm: a few KB a layer)
    regathered once a step, every other leaf its block."""
    if axis_info is None:
        return params
    return shd.gather_over(params, specs, axis_info, (FSDP_AXIS, axis_info.model_axis), keys=WHOLE_AT_USE)[0]


def _whole_norm(x: torch.Tensor, axis_info: Optional[AxisInfo], cfg: ModelConfig) -> torch.Tensor:
    """A top-level norm scale, whole (an FSDP gather over ``data``)."""
    if axis_info is None or x.shape[-1] == cfg.d_model:
        return x
    return collectives.gather_blocks(x, FSDP_AXIS, axis_info.mesh)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


def _inputs_to_h(params, inputs: torch.Tensor, cfg: ModelConfig, axis_info: Optional[AxisInfo] = None):
    """Tokens (B, S), or embeddings (B, S, d) as a floating tensor."""
    if inputs.is_floating_point():
        return inputs.to(cfg.cdtype())
    return embed(params["embed"], inputs, cfg, axis_info)


def _train_impl(cfg: ModelConfig, impl: str) -> str:
    """The training loss's attention: ``"xla"``, or ``"ref"`` for checks.
    Neither CUDA kernel has a backward, nor has the JAX package's Pallas
    kernel, so ``use_pallas=True`` raises as it fails there."""
    if cfg.use_pallas:
        raise NotImplementedError(
            "use_pallas=True: the flash kernel has no backward; train with use_pallas=False (impl='xla')")
    if impl not in ("xla", "ref"):
        raise ValueError(f"training attention is impl='xla' (or 'ref'), not {impl!r}")
    return impl


def _batch_h(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
             axis_info: Optional[AxisInfo] = None) -> torch.Tensor:
    """A training batch's input: ``embeds`` in the compute dtype, or the
    embedded ``tokens``."""
    if "embeds" in batch:
        return batch["embeds"].to(cfg.cdtype())
    return embed(params["embed"], batch["tokens"], cfg, axis_info)


def _ce(params, h: torch.Tensor, shard: "_Shard", cfg: ModelConfig, axis_info: Optional[AxisInfo] = None):
    """(ce, acc) of the f32 tied unembedding of ``h`` against the shard's
    labels: the rank's shares of the batch's mean under an axis_info (with
    a vocab-split table, vocab-parallel: each rank's logits stay its own)."""
    va = vocab_axes(params["embed"], cfg, axis_info)
    logits = unembed(params["embed"], h, cfg, axis_info, gather=False)
    return cross_entropy(logits, shard.batch["labels"], cfg.vocab_size, shard.denom, va,
                         axis_info.mesh if va else None)


def _train_layers(specs, axis_info: Optional[AxisInfo], lead: int = 1):
    """``(specs of one layer, gather)`` for a stacked subtree of ``params``:
    ``gather(layer)`` is the layer's weights as the training body uses
    them (:func:`_gathered_layer`), called inside the remat region."""
    ls = specs and shd.layer_specs(specs, lead)
    return lambda lp: _gathered_layer(lp, ls, axis_info)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """What a rank trains on: ``batch`` its rows, ``denom`` the divisor of
    its label sums (None: its own count of labels), ``n`` the number of
    shares its loss is one of, ``local`` whether its rows are its data
    shard alone."""

    batch: Dict[str, torch.Tensor]
    denom: Optional[torch.Tensor] = None
    n: int = 1
    local: bool = False

    def share(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of a value that is the same on every rank (the
        aux loss, averaged over the batch axes)."""
        if self.n == 1:
            return x
        return x / torch.full((), self.n, dtype=x.dtype, device=x.device)


def _shard_batch(batch: Dict[str, torch.Tensor], axis_info: Optional[AxisInfo],
                 denom: Optional[torch.Tensor] = None) -> _Shard:
    """The rank's part of a global (micro)batch under ``axis_info``, the
    JAX package's ``constrain_batch``: its block of rows over the batch
    axes when they divide the batch, else every row (the JAX package then
    keeps the batch replicated). Its label sums are divided by the count of
    valid labels in the whole batch (times the number of shares when every
    rank holds every row), counted here: every rank holds the whole batch.
    With ``denom`` the batch is already this rank's rows, and ``denom`` the
    count of valid labels in the microbatch they are a data shard of. The
    shares, summed over the batch axes, are the JAX package's values."""
    if axis_info is None:
        return _Shard(batch)
    n = axis_info.n_batch_shards
    if denom is not None:
        return _Shard(batch, denom, n, True)
    count = (batch["labels"] >= 0).sum().clamp_min(1)
    rows = batch["labels"].shape[0]
    if rows % n:
        return _Shard(batch, count * n, n, False)
    block = shd.row_block(rows, axis_info)
    return _Shard({k: v[block] for k, v in batch.items()}, count, n, True)


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _pool_cache(cfg: ModelConfig, pool_k, pool_v, tables, page_pos) -> Dict[str, torch.Tensor]:
    """Assemble a paged-cache dict, quantizing the pools to int8 (per-token
    scales) when the config asks for it."""
    dt = cfg.kvdtype()
    if dt == torch.int8:
        qk, sk = ops.quantize_token(pool_k)
        qv, sv = ops.quantize_token(pool_v)
        return {"pool_k": qk, "pool_v": qv, "scale_k": sk, "scale_v": sv,
                "tables": tables, "page_pos": page_pos}
    return {"pool_k": pool_k.to(dt), "pool_v": pool_v.to(dt),
            "tables": tables, "page_pos": page_pos}


def _pages_extra(axis_info: Optional[AxisInfo]) -> int:
    """Decode-headroom pages a sequence gets at prefill: one on one device,
    none across ranks (the JAX package's rule: the engine's page allocator
    owns decode headroom there)."""
    return 0 if axis_info is not None else 1


def _layer_pages(cfg: ModelConfig, k, v, extra: int = 1, axis_info: Optional[AxisInfo] = None,
                 rows: Optional[slice] = None, n_rows: int = 0) -> Dict[str, torch.Tensor]:
    """One attention layer's prefill K/V (B, S, K, hd) laid out as pages
    with ``extra`` headroom pages per sequence (int8 pools quantized), row
    b's pages at ``b*R ...``. Under ``axis_info`` ``k``/``v`` are this
    rank's ``rows`` (of ``n_rows``; every row when None) and the pools come
    back as this rank's stripe over ``page_axes``, padded as
    :func:`repro_torch.parallel.sharding.shard_cache` pads them, beside the
    tables and ``page_pos`` of every row. Where the rows are this rank's
    data shard and the pages divide over ``page_axes`` (ordered batch axes
    first), that shard's pages are exactly the stripes of its model ranks,
    and the rank keeps its own; otherwise the rows are regathered and
    striped. Only the stripe outlives the call."""
    pool_k, pool_v, tables, page_pos = ops.prefill_into_pages(k, v, cfg.kv_page_tokens, extra_pages=extra)
    if axis_info is None:
        return _pool_cache(cfg, pool_k, pool_v, tables, page_pos)
    R = tables.shape[1]
    dev = pool_k.device
    tables = torch.arange(n_rows * R, dtype=torch.int32, device=dev).reshape(n_rows, R)
    page_pos = page_pos[:1].expand(n_rows, R).contiguous()
    n = axis_info.n_page_shards
    if rows is not None and (n_rows * R) % n == 0:
        stripe = n_rows * R // n
        m = collectives.axis_index(axis_info.model_axis, axis_info.mesh)
        layer = _pool_cache(cfg, pool_k, pool_v, tables, page_pos)
        return {k: t[m * stripe:(m + 1) * stripe].clone() if k in shd.POOL_LEAVES else t for k, t in layer.items()}
    if rows is not None:
        pool_k, pool_v = collectives.regather_many([pool_k, pool_v], axis_info.batch_axes, axis_info.mesh)
    layer = shd.shard_cache({k: t[None] for k, t in _pool_cache(cfg, pool_k, pool_v, tables, page_pos).items()},
                            cfg, axis_info)
    return {k: t[0] for k, t in layer.items()}


def _paged_cache(layers) -> Dict[str, torch.Tensor]:
    """The per-layer caches of :func:`_layer_pages` stacked over layers."""
    return {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}


def _stripes(axis_info: Optional[AxisInfo]) -> int:
    """The stripes a pool is cut into across ranks (1 on one device)."""
    return 1 if axis_info is None else axis_info.n_page_shards


def _init_states(cfg: ModelConfig, batch: int, axis_info: Optional[AxisInfo], dev):
    """Zero SSM states of the rows of ``batch`` this rank holds (all of
    them on one device: :func:`repro_torch.parallel.sharding.row_block`)."""
    rows = shd.row_block(batch, axis_info)
    return ssm_mod.init_ssm_state(cfg, rows.stop - rows.start, cfg.n_layers, device=dev)


def _lengths(Bb: int, S: int, device) -> torch.Tensor:
    return torch.full((Bb,), S, dtype=torch.int32, device=device)


def _attn_decode(params, h, kv, i: int, lengths, cfg: ModelConfig, impl, axis_info=None):
    """Attention layer ``i`` of a stacked paged cache, one decode step.
    Pools and int8 scales are written in place through the layer's views;
    returns (h, the layer's new page_pos)."""
    layer_cache = {name: t[i] for name, t in kv.items()}
    h, new = B.block_decode(params, h, layer_cache, lengths, cfg, axis_info, impl=impl)
    return h, new["page_pos"]


def _ssm_decode(params, h, states, i: int, cfg: ModelConfig, axis_info=None):
    """Mamba2 layer ``i`` one decode step, its new state written in place
    into the stacked ``states``."""
    h, new = B.ssm_block_decode(params, h, {name: t[i] for name, t in states.items()}, cfg, axis_info)
    for name, t in states.items():
        t[i].copy_(new[name])
    return h


# ================================ decoder-only ================================
def _decoder_lm(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, device="cuda", dtype: Optional[torch.dtype] = None,
             axis_info: Optional[AxisInfo] = None):
        """Random weights from ``seed``, drawn layer by layer (see
        :func:`_stack_init`). With ``dtype`` (for serving: the compute
        dtype) the block weights and the final norm are stored in it, the
        MoE router excepted, so that :func:`serving_params` copies nothing;
        the values are those of the default init cast to ``dtype``. With
        ``axis_info``, this rank's blocks of the ``"jax"`` layout."""
        gen = _generator(seed, device)
        specs = _init_specs(axis_info, cfg)
        table = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype())
        blocks = _stack_init(gen, cfg.n_layers, lambda g: B.block_init(g, cfg), dtype,
                             _stack_keep(specs and specs["blocks"], axis_info))
        ln_f = torch.ones((cfg.d_model,), dtype=dtype or cfg.pdtype(), device=gen.device)
        params = {"embed": {"table": table}, "blocks": blocks, "ln_f": ln_f}
        return params if specs is None else dict(params, embed=_blocks(params["embed"], specs["embed"], axis_info),
                                                 ln_f=_blocks(ln_f, specs["ln_f"], axis_info))

    def init_cache(batch: int, seq_len: int, device="cuda", pad_pages_to: int = 1,
                   axis_info: Optional[AxisInfo] = None):
        cache, lengths = attn.init_decode_cache(
            cfg, batch, seq_len, cfg.n_layers, pad_pages_to=pad_pages_to, device=resolve_device(device),
            n_stripes=_stripes(axis_info))
        return {"kv": cache, "lengths": lengths}

    @torch.no_grad()
    def prefill(params, inputs: torch.Tensor, impl: Optional[str] = None,
                axis_info: Optional[AxisInfo] = None):
        """``inputs``: tokens (B, S) or, as ``_inputs_to_h`` takes them,
        embeddings (B, S, d) (a floating tensor); S a multiple of
        ``kv_page_tokens``. Returns the last position's f32 logits
        (B, padded_vocab) and a paged cache with one headroom page per
        sequence (int8 pools quantized here, for an int8 config). Under
        ``axis_info``: this rank's rows of the logits and the striped cache
        without headroom (module docstring)."""
        specs = _held(params, cfg, axis_info)
        n_rows = inputs.shape[0]
        rows = _row_block(n_rows, axis_info)
        h = _inputs_to_h(params, _take_rows(inputs, rows), cfg, axis_info)
        S = h.shape[1]
        pages = []
        for i in range(cfg.n_layers):
            lp = _gathered_layer(_layer(params["blocks"], i), specs and shd.layer_specs(specs["blocks"]), axis_info)
            h, _, (k, v) = B.block_apply(lp, h, cfg, axis_info, return_kv=True, impl=impl,
                                         local_batch=rows is not None)
            del lp
            pages.append(_layer_pages(cfg, k, v, _pages_extra(axis_info), axis_info, rows, n_rows))
        h = rmsnorm(h, _whole_norm(params["ln_f"], axis_info, cfg))
        logits = unembed(params["embed"], h[:, -1:], cfg, axis_info)[:, 0]
        kv = _paged_cache(pages)
        return logits, {"kv": kv, "lengths": _lengths(n_rows, S, h.device)}

    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor, impl: Optional[str] = None,
                    axis_info: Optional[AxisInfo] = None):
        """tokens (B,). Appends each sequence's token to the pools in place
        (an int8 pool's scales too, so they come back updated in place); only
        ``page_pos`` is re-stacked. Under ``axis_info`` the pools are this
        rank's stripes and the params its blocks (every row on every rank)."""
        params = _decode_params(params, _held(params, cfg, axis_info), axis_info)
        h = embed(params["embed"], tokens[:, None], cfg, axis_info)
        lengths, kv = cache["lengths"], cache["kv"]
        page_pos = []
        for i in range(cfg.n_layers):
            h, pp = _attn_decode(_layer(params["blocks"], i), h, kv, i, lengths, cfg, impl, axis_info)
            page_pos.append(pp)
        h = rmsnorm(h, params["ln_f"])
        logits = unembed(params["embed"], h, cfg, axis_info)[:, 0]
        return logits, {"kv": dict(kv, page_pos=torch.stack(page_pos)), "lengths": lengths + 1}

    def train_loss(params, batch: Dict[str, torch.Tensor], impl: str = "xla", axis_info=None, denom=None):
        """``loss = ce + MOE_AUX_WEIGHT * aux``; metrics ``ce``, ``aux``
        (the MoE load-balance loss summed over layers, 0 for a dense model),
        ``acc``. Under ``axis_info`` the loss and metrics are this rank's
        shares (:func:`_shard_batch`; ``denom``: ``batch`` is the rank's
        rows): the MoE routes the rank's tokens and averages its aux over
        the batch axes, of which the rank takes its share, so that the sum
        over the batch axes counts it once."""
        impl = _train_impl(cfg, impl)
        specs = _held(params, cfg, axis_info)
        shard = _shard_batch(batch, axis_info, denom)
        h = _batch_h(params, shard.batch, cfg, axis_info)
        layer = _train_layers(specs and specs["blocks"], axis_info)
        body = lambda p, x: B.block_apply(layer(p), x, cfg, axis_info, impl=impl,  # noqa: E731
                                          local_batch=shard.local)
        h, aux = B.scan_apply(B.unstack(params["blocks"], cfg.n_layers), h, body, cfg)
        ce, acc = _ce(params, rmsnorm(h, _whole_norm(params["ln_f"], axis_info, cfg)), shard, cfg, axis_info)
        aux = shard.share(aux)
        return ce + MOE_AUX_WEIGHT * aux, {"ce": ce, "aux": aux, "acc": acc}

    return Model(init, prefill, decode_step, init_cache, train_loss)


# ================================ pure SSM (mamba2) ================================
def _ssm_gathered_layer(lp, h, states, i: int, cfg: ModelConfig, axis_info=None):
    """Mamba2 layer ``i`` over the whole sequence; its final state and conv
    tail (the JAX package's ``_ssm_forward_with_state``) go into the stacked
    ``states``."""
    h, st = B.ssm_block_apply(lp, h, cfg, return_state=True, axis_info=axis_info)
    for name, t in states.items():
        t[i].copy_(st[name])
    return h


def _ssm_lm(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, device="cuda", dtype: Optional[torch.dtype] = None,
             axis_info: Optional[AxisInfo] = None):
        """As the decoder's init: blocks drawn layer by layer, straight into
        ``dtype`` when given (``A_log``, ``D``, ``dt_bias`` and the gated
        norm's scale in f32); this rank's blocks with ``axis_info``."""
        gen = _generator(seed, device)
        specs = _init_specs(axis_info, cfg)
        table = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype())
        blocks = _stack_init(gen, cfg.n_layers, lambda g: B.ssm_block_init(g, cfg), dtype,
                             _stack_keep(specs and specs["blocks"], axis_info))
        ln_f = torch.ones((cfg.d_model,), dtype=dtype or cfg.pdtype(), device=gen.device)
        params = {"embed": {"table": table}, "blocks": blocks, "ln_f": ln_f}
        return params if specs is None else dict(params, embed=_blocks(params["embed"], specs["embed"], axis_info),
                                                 ln_f=_blocks(ln_f, specs["ln_f"], axis_info))

    def init_cache(batch: int, seq_len: int, device="cuda", pad_pages_to: int = 1,
                   axis_info: Optional[AxisInfo] = None):
        dev = resolve_device(device)
        return {"ssm": _init_states(cfg, batch, axis_info, dev),
                "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def prefill(params, inputs: torch.Tensor, impl: Optional[str] = None,
                axis_info: Optional[AxisInfo] = None):
        """Returns the last position's f32 logits and a cache of the f32
        SSM states ``{"ssm": (L, B, H, N, P), "conv": (L, B, Kc-1, C)}``.
        No attention: ``impl`` is taken for the common signature. Under
        ``axis_info`` this rank's rows of the logits and of the states."""
        specs = _held(params, cfg, axis_info)
        n_rows = inputs.shape[0]
        rows = _row_block(n_rows, axis_info)
        h = _inputs_to_h(params, _take_rows(inputs, rows), cfg, axis_info)
        Bb, S = h.shape[:2]
        states = ssm_mod.init_ssm_state(cfg, Bb, cfg.n_layers, device=h.device)
        for i in range(cfg.n_layers):
            lp = _gathered_layer(_layer(params["blocks"], i), specs and shd.layer_specs(specs["blocks"]), axis_info)
            h = _ssm_gathered_layer(lp, h, states, i, cfg, axis_info)
            del lp
        h = rmsnorm(h, _whole_norm(params["ln_f"], axis_info, cfg))
        logits = unembed(params["embed"], h[:, -1:], cfg, axis_info)[:, 0]
        return logits, {"ssm": states, "lengths": _lengths(n_rows, S, h.device)}

    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor, impl: Optional[str] = None,
                    axis_info: Optional[AxisInfo] = None):
        """tokens (B,). Updates the cache's SSM states in place (under
        ``axis_info`` this rank's rows of them)."""
        params = _decode_params(params, _held(params, cfg, axis_info), axis_info)
        h = embed(params["embed"], tokens[:, None], cfg, axis_info)
        states = cache["ssm"]
        for i in range(cfg.n_layers):
            h = _ssm_decode(_layer(params["blocks"], i), h, states, i, cfg, axis_info)
        h = rmsnorm(h, params["ln_f"])
        logits = unembed(params["embed"], h, cfg, axis_info)[:, 0]
        return logits, {"ssm": dict(states), "lengths": cache["lengths"] + 1}

    def train_loss(params, batch: Dict[str, torch.Tensor], impl: str = "xla", axis_info=None, denom=None):
        """The cross-entropy; metrics ``ce``, ``acc`` (the rank's shares
        under ``axis_info``). No attention: ``impl`` is checked for the
        common signature."""
        _train_impl(cfg, impl)
        specs = _held(params, cfg, axis_info)
        shard = _shard_batch(batch, axis_info, denom)
        h = _batch_h(params, shard.batch, cfg, axis_info)
        layer = _train_layers(specs and specs["blocks"], axis_info)
        body = lambda p, x: (B.ssm_block_apply(layer(p), x, cfg, axis_info=axis_info), _no_aux(x))  # noqa: E731
        h, _ = B.scan_apply(B.unstack(params["blocks"], cfg.n_layers), h, body, cfg)
        ce, acc = _ce(params, rmsnorm(h, _whole_norm(params["ln_f"], axis_info, cfg)), shard, cfg, axis_info)
        return ce, {"ce": ce, "acc": acc}

    return Model(init, prefill, decode_step, init_cache, train_loss)


# ================================ hybrid (zamba2) ================================
def _hybrid_lm(cfg: ModelConfig) -> Model:
    n_groups = cfg.n_layers // cfg.attn_every
    per_group = cfg.attn_every

    def init(seed: int = 0, device="cuda", dtype: Optional[torch.dtype] = None,
             axis_info: Optional[AxisInfo] = None):
        """The Mamba2 stack drawn layer by layer and viewed as
        ``(n_groups, per_group, ...)``, then ONE shared attention block;
        this rank's blocks with ``axis_info``."""
        gen = _generator(seed, device)
        specs = _init_specs(axis_info, cfg)
        table = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype())
        mamba = _stack_init(gen, cfg.n_layers, lambda g: B.ssm_block_init(g, cfg), dtype,
                            _stack_keep(specs and specs["mamba"], axis_info, lead=2))
        mamba = _tree_map(lambda _, t: t.reshape(n_groups, per_group, *t.shape[1:]), mamba)
        shared = B.block_init(gen, cfg)
        if dtype:
            shared = _tree_map(lambda key, t: t.to(_serving_dtype(key, dtype)), shared)
        ln_f = torch.ones((cfg.d_model,), dtype=dtype or cfg.pdtype(), device=gen.device)
        params = {"embed": {"table": table}, "mamba": mamba, "shared_attn": shared, "ln_f": ln_f}
        if specs is None:
            return params
        return dict(params, **{k: _blocks(params[k], specs[k], axis_info) for k in ("embed", "shared_attn", "ln_f")})

    def init_cache(batch: int, seq_len: int, device="cuda", pad_pages_to: int = 1,
                   axis_info: Optional[AxisInfo] = None):
        dev = resolve_device(device)
        kv, lengths = attn.init_decode_cache(cfg, batch, seq_len, n_groups, pad_pages_to=pad_pages_to,
                                             device=dev, n_stripes=_stripes(axis_info))
        return {"ssm": _init_states(cfg, batch, axis_info, dev), "kv": kv, "lengths": lengths}

    @torch.no_grad()
    def prefill(params, inputs: torch.Tensor, impl: Optional[str] = None,
                axis_info: Optional[AxisInfo] = None):
        """Each group's Mamba2 layers, then the shared block (flash
        attention), whose K/V become that group's paged KV layer. Returns
        the last position's f32 logits and ``{"ssm": (L, ...) states, "kv":
        n_groups paged layers, "lengths"}``; S a multiple of
        ``kv_page_tokens``; no headroom page under ``axis_info``, and the
        states of this rank's rows."""
        specs = _held(params, cfg, axis_info)
        n_rows = inputs.shape[0]
        rows = _row_block(n_rows, axis_info)
        h = _inputs_to_h(params, _take_rows(inputs, rows), cfg, axis_info)
        Bb, S = h.shape[:2]
        states = ssm_mod.init_ssm_state(cfg, Bb, cfg.n_layers, device=h.device)
        mamba_specs = specs and shd.layer_specs(specs["mamba"], lead=2)
        shared = _gathered_layer(params["shared_attn"], specs and specs["shared_attn"], axis_info)
        pages = []
        for g in range(n_groups):
            group = _layer(params["mamba"], g)
            for j in range(per_group):
                lp = _gathered_layer(_layer(group, j), mamba_specs, axis_info)
                h = _ssm_gathered_layer(lp, h, states, g * per_group + j, cfg, axis_info)
                del lp
            h, _, (k, v) = B.block_apply(shared, h, cfg, axis_info, return_kv=True, impl=impl,
                                         local_batch=rows is not None)
            pages.append(_layer_pages(cfg, k, v, _pages_extra(axis_info), axis_info, rows, n_rows))
        h = rmsnorm(h, _whole_norm(params["ln_f"], axis_info, cfg))
        logits = unembed(params["embed"], h[:, -1:], cfg, axis_info)[:, 0]
        return logits, {"ssm": states, "kv": _paged_cache(pages), "lengths": _lengths(n_rows, S, h.device)}

    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor, impl: Optional[str] = None,
                    axis_info: Optional[AxisInfo] = None):
        """tokens (B,). SSM states, pools (and int8 scales) updated in
        place; ``page_pos`` re-stacked. Under ``axis_info`` the pools are
        striped and the SSM states this rank's rows."""
        params = _decode_params(params, _held(params, cfg, axis_info), axis_info)
        h = embed(params["embed"], tokens[:, None], cfg, axis_info)
        lengths, kv, states = cache["lengths"], cache["kv"], cache["ssm"]
        page_pos = []
        for g in range(n_groups):
            group = _layer(params["mamba"], g)
            for j in range(per_group):
                h = _ssm_decode(_layer(group, j), h, states, g * per_group + j, cfg, axis_info)
            h, pp = _attn_decode(params["shared_attn"], h, kv, g, lengths, cfg, impl, axis_info)
            page_pos.append(pp)
        h = rmsnorm(h, params["ln_f"])
        logits = unembed(params["embed"], h, cfg, axis_info)[:, 0]
        return logits, {"ssm": dict(states), "kv": dict(kv, page_pos=torch.stack(page_pos)),
                        "lengths": lengths + 1}

    def train_loss(params, batch: Dict[str, torch.Tensor], impl: str = "xla", axis_info=None, denom=None):
        """Each group's Mamba2 layers (remat groups within it), then the
        shared block under its own checkpoint; metrics ``ce``, ``acc`` (the
        rank's shares under ``axis_info``)."""
        impl = _train_impl(cfg, impl)
        specs = _held(params, cfg, axis_info)
        shard = _shard_batch(batch, axis_info, denom)
        h = _batch_h(params, shard.batch, cfg, axis_info)
        flat = _tree_map(lambda _, t: t.reshape(cfg.n_layers, *t.shape[2:]), params["mamba"])
        mamba = B.unstack(flat, cfg.n_layers)
        layer = _train_layers(specs and specs["mamba"], axis_info, lead=2)
        ssm_body = lambda p, x: (B.ssm_block_apply(layer(p), x, cfg, axis_info=axis_info), _no_aux(x))  # noqa: E731
        shared_layer = _train_layers(specs and specs["shared_attn"], axis_info, lead=0)
        shared = B.checkpoint_wrap(lambda p, x: B.block_apply(shared_layer(p), x, cfg, axis_info, impl=impl,
                                                              local_batch=shard.local), cfg)
        for g in range(n_groups):
            h, _ = B.scan_apply(mamba[g * per_group:(g + 1) * per_group], h, ssm_body, cfg)
            h, _ = shared(params["shared_attn"], h)
        ce, acc = _ce(params, rmsnorm(h, _whole_norm(params["ln_f"], axis_info, cfg)), shard, cfg, axis_info)
        return ce, {"ce": ce, "acc": acc}

    return Model(init, prefill, decode_step, init_cache, train_loss)


# ================================ encoder-decoder ================================
def _encdec_lm(cfg: ModelConfig) -> Model:
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_dec_layers

    def init(seed: int = 0, device="cuda", dtype: Optional[torch.dtype] = None,
             axis_info: Optional[AxisInfo] = None):
        """The embedding, then the encoder's transformer blocks and the
        decoder blocks (self, cross, MLP), each stack drawn layer by layer
        straight into ``dtype`` when given; this rank's blocks with
        ``axis_info``."""
        gen = _generator(seed, device)
        specs = _init_specs(axis_info, cfg)
        table = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype())
        encoder = _stack_init(gen, n_enc, lambda g: B.block_init(g, cfg), dtype,
                              _stack_keep(specs and specs["encoder"], axis_info))
        decoder = _stack_init(gen, n_dec, lambda g: B.dec_block_init(g, cfg), dtype,
                              _stack_keep(specs and specs["decoder"], axis_info))
        norm = lambda: torch.ones((cfg.d_model,), dtype=dtype or cfg.pdtype(), device=gen.device)  # noqa: E731
        params = {"embed": {"table": table}, "encoder": encoder, "decoder": decoder,
                  "ln_enc": norm(), "ln_dec": norm()}
        if specs is None:
            return params
        return dict(params, **{k: _blocks(params[k], specs[k], axis_info) for k in ("embed", "ln_enc", "ln_dec")})

    def init_cache(batch: int, seq_len: int, device="cuda", pad_pages_to: int = 1,
                   axis_info: Optional[AxisInfo] = None):
        dev = resolve_device(device)
        self_kv, lengths = attn.init_decode_cache(cfg, batch, seq_len, n_dec, pad_pages_to=pad_pages_to,
                                                  device=dev, n_stripes=_stripes(axis_info))
        cross_kv, _ = attn.init_decode_cache(cfg, batch, seq_len, n_dec, pad_pages_to=pad_pages_to, device=dev,
                                             n_stripes=_stripes(axis_info))
        return {"self_kv": self_kv, "cross_kv": cross_kv, "lengths": lengths,
                "enc_len": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def prefill(params, inputs: Dict[str, torch.Tensor], impl: Optional[str] = None,
                axis_info: Optional[AxisInfo] = None):
        """Encode ``inputs["enc_embeds"]`` (B, S_enc, d), S_enc a multiple of
        ``kv_page_tokens`` (non-causal self-attention), and lay each decoder
        layer's cross K/V (no RoPE) out as pages with one headroom page.
        With ``inputs["tokens"]`` (B, S_dec) the decoder runs over them too:
        their self K/V become the self pools and the logits are the last
        position's. Without, the self cache is empty (``lengths`` 0) and the
        logits are zeros. The cache is ``{"self_kv", "cross_kv", "lengths",
        "enc_len"}``; under ``axis_info`` the prefilled pools have no
        headroom page, and the logits and pools are this rank's (module
        docstring)."""
        extra = _pages_extra(axis_info)
        specs = _held(params, cfg, axis_info)
        n_rows = inputs["enc_embeds"].shape[0]
        rows = _row_block(n_rows, axis_info)
        inputs = _take_rows(inputs, rows)
        h = inputs["enc_embeds"].to(cfg.cdtype())
        for i in range(n_enc):
            lp = _gathered_layer(_layer(params["encoder"], i), specs and shd.layer_specs(specs["encoder"]), axis_info)
            h, _ = B.block_apply(lp, h, cfg, axis_info, causal=False, impl=impl, local_batch=rows is not None)
            del lp
        enc_out = rmsnorm(h, _whole_norm(params["ln_enc"], axis_info, cfg))
        Bb, S_enc = enc_out.shape[:2]
        dev = enc_out.device
        tokens = inputs.get("tokens")
        if tokens is not None:
            h = embed(params["embed"], tokens, cfg, axis_info)
        cross, pages = [], []
        for i in range(n_dec):
            lp = _gathered_layer(_layer(params["decoder"], i), specs and shd.layer_specs(specs["decoder"]), axis_info)
            k, v = (attn.project(enc_out, lp["cross"][n], cfg.cdtype()) for n in ("wk", "wv"))
            if axis_info is not None and k.shape[2] != cfg.n_kv_heads:  # every kv head, for the cache
                k, v = (t.movedim(0, 2) for t in collectives.regather_many(
                    [k.movedim(2, 0), v.movedim(2, 0)], axis_info.model_axis, axis_info.mesh))
            cross.append(_layer_pages(cfg, k, v, extra, axis_info, rows, n_rows))
            if tokens is not None:
                h, (k, v) = B.dec_block_apply(lp, h, enc_out, cfg, impl=impl, axis_info=axis_info)
                pages.append(_layer_pages(cfg, k, v, extra, axis_info, rows, n_rows))
            del lp
        cross_kv = _paged_cache(cross)
        if tokens is None:
            self_kv, lengths = attn.init_decode_cache(cfg, n_rows, S_enc, n_dec, device=dev,
                                                      n_stripes=_stripes(axis_info))
            logits = torch.zeros((Bb, cfg.padded_vocab), dtype=torch.float32, device=dev)
        else:
            self_kv = _paged_cache(pages)
            h = rmsnorm(h, _whole_norm(params["ln_dec"], axis_info, cfg))
            logits = unembed(params["embed"], h[:, -1:], cfg, axis_info)[:, 0]
            lengths = _lengths(n_rows, tokens.shape[1], dev)
        return logits, {"self_kv": self_kv, "cross_kv": cross_kv, "lengths": lengths,
                        "enc_len": _lengths(n_rows, S_enc, dev)}

    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor, impl: Optional[str] = None,
                    axis_info: Optional[AxisInfo] = None):
        """tokens (B,). Appends each row's token to the self pools in place;
        the cross pools are only read. Only the self cache's ``page_pos`` is
        re-stacked. Under ``axis_info`` both pools are striped."""
        params = _decode_params(params, _held(params, cfg, axis_info), axis_info)
        h = embed(params["embed"], tokens[:, None], cfg, axis_info)
        lengths, self_kv, cross_kv = cache["lengths"], cache["self_kv"], cache["cross_kv"]
        page_pos = []
        for i in range(n_dec):
            h, new = B.dec_block_decode(
                _layer(params["decoder"], i), h, {n: t[i] for n, t in self_kv.items()},
                {n: t[i] for n, t in cross_kv.items()}, lengths, cache["enc_len"], cfg, axis_info, impl=impl)
            page_pos.append(new["page_pos"])
        h = rmsnorm(h, params["ln_dec"])
        logits = unembed(params["embed"], h, cfg, axis_info)[:, 0]
        return logits, dict(cache, self_kv=dict(self_kv, page_pos=torch.stack(page_pos)), lengths=lengths + 1)

    def train_loss(params, batch: Dict[str, torch.Tensor], impl: str = "xla", axis_info=None, denom=None):
        """Encode ``batch["enc_embeds"]``, then the decoder over
        ``batch["tokens"]``, each decoder layer under its own checkpoint;
        metrics ``ce``, ``acc`` (the rank's shares under ``axis_info``)."""
        impl = _train_impl(cfg, impl)
        specs = _held(params, cfg, axis_info)
        shard = _shard_batch(batch, axis_info, denom)
        batch = shard.batch
        enc_layer = _train_layers(specs and specs["encoder"], axis_info)
        dec_layer = _train_layers(specs and specs["decoder"], axis_info)
        enc = lambda p, x: B.block_apply(enc_layer(p), x, cfg, axis_info, causal=False, impl=impl)  # noqa: E731
        h, _ = B.scan_apply(B.unstack(params["encoder"], n_enc), batch["enc_embeds"].to(cfg.cdtype()), enc, cfg)
        enc_out = rmsnorm(h, _whole_norm(params["ln_enc"], axis_info, cfg))
        dec = B.checkpoint_wrap(lambda p, x: B.dec_block_apply(dec_layer(p), x, enc_out, cfg, impl=impl,
                                                               axis_info=axis_info, return_kv=False)[0], cfg)
        h = embed(params["embed"], batch["tokens"], cfg, axis_info)
        for p in B.unstack(params["decoder"], n_dec):
            h = dec(p, h)
        ce, acc = _ce(params, rmsnorm(h, _whole_norm(params["ln_dec"], axis_info, cfg)), shard, cfg, axis_info)
        return ce, {"ce": ce, "acc": acc}

    return Model(init, prefill, decode_step, init_cache, train_loss)
