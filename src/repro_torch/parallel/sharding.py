"""Logical-axis -> mesh-axis sharding rules, the counterpart of
:mod:`repro.parallel.sharding`.

Parameters carry logical axis names (:func:`repro_torch.models.lm.param_axes`);
this module resolves them to partition specs against a mesh, with fall-back
to replication when a dimension does not divide the mesh axes, exactly as
the JAX package does: ``logical_rules``, ``spec_for``, ``param_shardings``,
``batch_shardings`` and ``cache_shardings`` give the JAX package's specs
(tuples, :class:`P`, where it gives ``NamedSharding``\\ s of
``PartitionSpec``\\ s).

What the port does with them differs, by design. It runs one process per
rank and keeps parameters and activations replicated, where GSPMD keeps
the JAX package's values global outside its ``shard_map`` bodies. The state
it shards is what those bodies take split:

* the expert weights over the model axis (:func:`shard_params`: the model
  axis's entries of ``param_shardings``; the FSDP ``'data'`` entries are a
  GSPMD layout that ``shard_map`` gathers before the body runs);
* the KV page pools and int8 scales over every axis (:func:`shard_cache`:
  ``cache_shardings``' entries for them). The SSM states stay replicated,
  where ``cache_shardings`` shards them over the batch axes: each row's
  state is updated by its own row alone, so the numbers are the same.

:func:`shard_leaf` takes this rank's block of a value, which is what
``jax.device_put`` onto a ``NamedSharding`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.axisinfo import AxisInfo, Mesh

POOL_LEAVES = ("pool_k", "pool_v", "scale_k", "scale_v")


class P(tuple):
    """A partition spec: one entry per leading dim, ``None`` (replicated),
    an axis name or a tuple of names (sharded over their product, row-major
    in that order); trailing dims not named are replicated. A one-name tuple
    is stored as the name, as ``jax.sharding.PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


def logical_rules(cfg: ModelConfig, axis_info: AxisInfo) -> Dict[str, Any]:
    tp = axis_info.mesh.shape[axis_info.model_axis]
    moe_ep = cfg.is_moe and cfg.n_experts % tp == 0
    m = axis_info.model_axis
    return {
        "vocab": m,
        "embed": "data",  # FSDP within pod
        "embed_table": None,  # vocab-sharded only
        "q_heads": m,
        "kv_heads": m,
        "head": None,
        "ffn": m,
        "moe_ffn": None if moe_ep else m,
        "experts": m if moe_ep else None,
        "experts_router": None,
        "layers": None,
        "groups": None,
        "conv": None,
        "ssm_proj": m,
        "ssm_conv_dim": m,
        "ssm_heads": None,
        "ssm_inner": m,
        "batch": axis_info.batch_axes,
        "pages": axis_info.page_axes,
        "seq": None,
    }


def spec_for(shape: Tuple[int, ...], axes: Tuple[str, ...], rules, mesh: Mesh) -> P:
    """Resolve one param's logical axes to a spec, honoring divisibility and
    never assigning a mesh axis twice."""
    used = set()
    entries = []
    for dim, name in zip(shape, axes):
        mesh_axes = rules.get(name)
        if mesh_axes is None:
            entries.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        size = 1
        ok = True
        for a in mesh_axes:
            if a in used:
                ok = False
                break
            size *= mesh.shape[a]
        if not ok or dim % size:
            entries.append(None)
            continue
        used.update(mesh_axes)
        entries.append(mesh_axes[0] if len(mesh_axes) == 1 else tuple(mesh_axes))
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's or array's, or the leaf itself as a tuple of ints."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over nested dicts."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,)) for k, v in tree.items()}
    return fn(path, tree, *rest)


def param_shardings(params_shape, axes_tree, cfg: ModelConfig, axis_info: AxisInfo):
    """Spec tree for a params (or optimizer-state) tree; leaves are tensors,
    arrays or shape tuples."""
    rules = logical_rules(cfg, axis_info)
    return _map(lambda _, p, a: spec_for(_shape(p), a, rules, axis_info.mesh), params_shape, axes_tree)


def batch_shardings(batch_spec, cfg: ModelConfig, axis_info: AxisInfo):
    """Input batches: dim 0 (batch) over the DP axes when divisible."""
    n = axis_info.n_batch_shards

    def one(_, s):
        shape = _shape(s)
        return P(axis_info.batch_axes) if shape and shape[0] % n == 0 else P()

    return _map(one, batch_spec)


def cache_shardings(cache_shape, cfg: ModelConfig, axis_info: AxisInfo):
    """Decode-cache trees: page pools over all axes; small state replicated;
    SSM states over batch when divisible (the port keeps them replicated:
    :func:`shard_cache`)."""
    n_pages = axis_info.n_page_shards
    n_batch = axis_info.n_batch_shards

    def one(path, s):
        shape = _shape(s)
        if path[-1] in POOL_LEAVES:  # (L, P, T, K[, hd]): stripe pages over every axis
            return P(None, axis_info.page_axes) if shape[1] % n_pages == 0 else P()
        if path[-1] in ("ssm", "conv"):  # (L, B, ...)
            return P(None, axis_info.batch_axes) if shape[1] % n_batch == 0 else P()
        return P()  # tables, page_pos, lengths, enc_len

    return _map(one, cache_shape)


def shard_leaf(x, spec: P, axis_info: AxisInfo):
    """This rank's block of ``x`` (a tensor or an array) under ``spec``: a
    view, not a copy. Each named dim must divide by its axes' size: padding
    is the caller's job (``init_cache(pad_pages_to=)``, :func:`pad_pages`)."""
    mesh = axis_info.mesh
    index = []
    for dim, entry in enumerate(spec):
        if entry is None:
            index.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = mesh.axes_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not divide over {axes} ({n} ranks)")
        block = x.shape[dim] // n
        i = mesh.axes_index(axes)
        index.append(slice(i * block, (i + 1) * block))
    return x[tuple(index)]


def gather_leaf(x, spec: P, axis_info: AxisInfo):
    """The full value of which ``x`` is this rank's block under ``spec``,
    on every rank (the inverse of :func:`shard_leaf`): one all-reduce for
    each dim ``spec`` names (:func:`repro_torch.parallel.collectives.regather`)."""
    from repro_torch.parallel import collectives

    for dim, entry in enumerate(spec):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            x = collectives.regather(x.movedim(dim, 0).contiguous(), axes, axis_info.mesh).movedim(0, dim)
    return x


def gather_params(params, cfg: ModelConfig, axis_info: AxisInfo):
    """The full params (or moments) on every rank, from this rank's
    (:func:`shard_params`'s inverse: the expert weights regathered over the
    model axis); every rank calls it."""
    from repro_torch.convert import param_shapes

    specs = local_param_specs(param_shapes(cfg), cfg, axis_info)  # the full shapes decide the specs
    return _map(lambda _, x, s: gather_leaf(x, s, axis_info) if len(s) else x, params, specs)


def local_param_specs(params, cfg: ModelConfig, axis_info: AxisInfo):
    """The specs the port applies to a params tree: the model axis's entries
    of ``param_shardings`` on the expert weights (the leaves with an
    ``"experts"`` logical axis: EP over whole experts, or per-expert ffn TP
    when the experts do not divide the axis), ``P()`` everywhere else."""
    from repro_torch.models.lm import param_axes

    axes = param_axes(cfg)
    specs = param_shardings(params, axes, cfg, axis_info)
    m = axis_info.model_axis

    def one(_, spec, ax):
        if "experts" not in ax:
            return P()
        entries = [e if e == m else None for e in spec]
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    return _map(one, specs, axes)


def shard_params(params, cfg: ModelConfig, axis_info: AxisInfo, copy: bool = False):
    """This rank's params: every leaf replicated but the expert weights,
    which keep this rank's experts (or ffn columns); see
    :func:`local_param_specs`. Works on tensors and on numpy arrays. The
    blocks are views unless ``copy`` (a view keeps the whole leaf alive)."""
    specs = local_param_specs(params, cfg, axis_info)

    def one(_, x, s):
        if not len(s):
            return x
        block = shard_leaf(x, s, axis_info)
        return block.clone() if copy else block

    return _map(one, params, specs)


def pad_pages(cache, multiple: int):
    """A cache whose page pools (and int8 scales) hold a multiple of
    ``multiple`` pages: zero pages appended, referenced by no table (the
    JAX package's ``jnp.pad`` before ``device_put``, and
    ``init_decode_cache(pad_pages_to=)``)."""
    import torch

    def one(path, x):
        if path[-1] not in POOL_LEAVES or x.shape[1] % multiple == 0:
            return x
        extra = -x.shape[1] % multiple
        tail = torch.zeros((x.shape[0], extra, *x.shape[2:]), dtype=x.dtype, device=x.device)
        return torch.cat([x, tail], dim=1)

    return _map(one, cache)


def shard_cache(cache, cfg: ModelConfig, axis_info: AxisInfo):
    """This rank's decode cache: the page pools and int8 scales padded to a
    multiple of the page shards and striped over ``page_axes`` (the block
    ``cache_shardings`` gives them); tables, ``page_pos``, lengths and SSM
    states replicated (see the module docstring). The stripes are copies,
    so that a decode step's in-place writes never reach the full pool."""
    cache = pad_pages(cache, axis_info.n_page_shards)
    specs = cache_shardings(cache, cfg, axis_info)

    def one(path, x, s):
        if path[-1] not in POOL_LEAVES:
            return x
        return shard_leaf(x, s, axis_info).clone()

    return _map(one, cache, specs)
