"""Logical-axis -> mesh-axis sharding rules, the counterpart of
:mod:`repro.parallel.sharding`.

Parameters carry logical axis names (:func:`repro_torch.models.lm.param_axes`);
this module resolves them to partition specs against a mesh, with fall-back
to replication when a dimension does not divide the mesh axes, exactly as
the JAX package does: ``logical_rules``, ``spec_for``, ``param_shardings``,
``batch_shardings`` and ``cache_shardings`` give the JAX package's specs
(tuples, :class:`P`, where it gives ``NamedSharding``\\ s of
``PartitionSpec``\\ s).

The port runs one process per rank, and lays the parameters out in one of
two layouts (:func:`param_specs`):

* ``"jax"``: every leaf is this rank's block under ``param_shardings``, the
  JAX package's own layout (heads, ffn, vocab and the SSM projections over
  ``model``, ``embed`` over ``data``, the experts over ``model``), with its
  fall-back to replication where a dim does not divide. Serving, the
  training launcher and the dry run use it;
* ``"experts"``: the expert weights over the model axis, every other leaf
  replicated (:func:`local_param_specs`), the layout the port trained in
  first.

The model code, in training and serving alike, reads which dims a leaf
holds whole and which as a block from its shape (:func:`held_specs`), so
either layout (or a mix) runs through the same code.

A decode cache is laid out as ``cache_shardings`` lays it
(:func:`shard_cache`): the KV page pools and int8 scales striped over
every axis, the SSM states ``ssm`` and ``conv`` this rank's rows over the
batch axes (every row where the batch does not divide over them), the
tables, ``page_pos`` and lengths whole.

:func:`shard_leaf` takes this rank's block of a value, which is what
``jax.device_put`` onto a ``NamedSharding`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.axisinfo import AxisInfo, Mesh

POOL_LEAVES = ("pool_k", "pool_v", "scale_k", "scale_v")
STATE_LEAVES = ("ssm", "conv")  # a decode cache's SSM states, (L, B, ...)
FSDP_AXIS = "data"  # the mesh axis of the ``embed`` dims (FSDP within a pod)
# leaves used whole: the norm scales, the conv taps and bias, the gated norm's
# scale (a few KB a layer); regathered before use
WHOLE_AT_USE = ("ln1", "ln2", "ln3", "ln", "ln_f", "ln_enc", "ln_dec", "conv_w", "conv_b", "norm")


class P(tuple):
    """A partition spec: one entry per leading dim, ``None`` (replicated),
    an axis name or a tuple of names (sharded over their product, row-major
    in that order); trailing dims not named are replicated. A one-name tuple
    is stored as the name, as ``jax.sharding.PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __getnewargs__(self) -> tuple:
        """The entries as ``__new__`` takes them, one argument each, so that
        a spec survives ``pickle`` (and ``torch.save``) unchanged."""
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


def logical_rules(cfg: ModelConfig, axis_info: AxisInfo) -> Dict[str, Any]:
    tp = axis_info.mesh.shape[axis_info.model_axis]
    moe_ep = cfg.is_moe and cfg.n_experts % tp == 0
    m = axis_info.model_axis
    return {
        "vocab": m,
        "embed": FSDP_AXIS,  # FSDP within pod
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
    SSM states over batch when divisible."""
    n_pages = axis_info.n_page_shards
    n_batch = axis_info.n_batch_shards

    def one(path, s):
        shape = _shape(s)
        if path[-1] in POOL_LEAVES:  # (L, P, T, K[, hd]): stripe pages over every axis
            return P(None, axis_info.page_axes) if shape[1] % n_pages == 0 else P()
        if path[-1] in STATE_LEAVES:  # (L, B, ...)
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
    """The full params (or moments) on every rank, from this rank's blocks
    in either layout (:func:`held_specs`; :func:`shard_params`'s inverse);
    every rank calls it."""
    specs = held_specs(params, cfg, axis_info)
    return _map(lambda _, x, s: gather_leaf(x, s, axis_info) if len(s) else x, params, specs)


def jax_specs(cfg: ModelConfig, axis_info: AxisInfo):
    """The ``"jax"`` layout: ``param_shardings`` of the full param tree."""
    from repro_torch.convert import param_shapes
    from repro_torch.models.lm import param_axes

    return param_shardings(param_shapes(cfg), param_axes(cfg), cfg, axis_info)


LAYOUTS = ("jax", "experts")


def param_specs(cfg: ModelConfig, axis_info: AxisInfo, layout: str = "experts"):
    """The spec tree of a layout: ``"jax"`` (:func:`jax_specs`) or
    ``"experts"`` (:func:`local_param_specs`)."""
    from repro_torch.convert import param_shapes

    if layout == "jax":
        return jax_specs(cfg, axis_info)
    if layout == "experts":
        return local_param_specs(param_shapes(cfg), cfg, axis_info)
    raise ValueError(f"unknown layout {layout!r}: one of {LAYOUTS}")


def held_specs(params, cfg: ModelConfig, axis_info: AxisInfo):
    """The spec each leaf of ``params`` is held in, read from its shape
    against the full one: ``param_shardings``' entry on each dim that is
    this rank's block, ``None`` on each dim held whole. So both layouts
    (and any mix of them) are read; a dim of any other size raises, naming
    the leaf."""
    from repro_torch.convert import param_shapes

    mesh = axis_info.mesh

    def one(path, x, full, spec):
        entries = []
        for dim, n in enumerate(full):
            e = spec[dim] if dim < len(spec) else None
            got = x.shape[dim]
            if got == n:
                entries.append(None)
            elif e is not None and got * mesh.axes_size((e,) if isinstance(e, str) else e) == n:
                entries.append(e)
            else:
                raise ValueError(f"params{list(path)}: shape {tuple(x.shape)} is neither the full {tuple(full)} "
                                 f"nor this rank's block under {spec}")
        return P(*_trim(entries))

    return _map(one, params, param_shapes(cfg), jax_specs(cfg, axis_info))


def layer_specs(specs, lead: int = 1):
    """The specs of one layer of a stacked tree: ``lead`` leading entries dropped."""
    return _map(lambda _, s: P(*s[lead:]), specs)


def gather_over(tree, specs, axis_info: AxisInfo, axes, keys=None):
    """``(tree, specs)`` with each leaf (or each leaf whose key is in
    ``keys``) regathered over every mesh axis of ``axes`` that its spec
    names, and those entries cleared: one all-reduce per axis and dtype.
    Under autograd a batch axis gathers with
    :func:`~repro_torch.parallel.collectives.gather_blocks_many` (its
    backward sums the cotangents over the axis: FSDP's reduce-scatter) and
    the model axis with :func:`~repro_torch.parallel.collectives.tp_gather`
    (its backward takes this rank's block)."""
    from repro_torch.parallel import collectives

    leaves, held = {}, {}

    def collect(path, x, s):
        leaves[path], held[path] = x, list(s)

    _map(collect, tree, specs)
    for axis in axes:
        gather = collectives.gather_blocks_many if axis in axis_info.batch_axes else collectives.tp_gather
        jobs: Dict[Any, list] = {}
        for path, s in held.items():
            if (keys is None or path[-1] in keys) and axis in s:
                jobs.setdefault(leaves[path].dtype, []).append((path, s.index(axis)))
        for job in jobs.values():
            blocks = [leaves[p].movedim(d, 0) for p, d in job]
            for (p, d), whole in zip(job, gather(blocks, axis, axis_info.mesh)):
                leaves[p] = whole.movedim(0, d)
                held[p][d] = None
    return (_map(lambda path, _: leaves[path], tree),
            _map(lambda path, _: P(*_trim(held[path])), tree))


def _trim(entries) -> list:
    """The entries without the ``None`` entries at their end."""
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return entries


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


def shard_params(params, cfg: ModelConfig, axis_info: AxisInfo, copy: bool = False, layout: str = "experts"):
    """This rank's params in ``layout`` (:func:`param_specs`): for
    ``"experts"`` every leaf replicated but the expert weights, which keep
    this rank's experts (or ffn columns); for ``"jax"`` every leaf's
    ``param_shardings`` block. Works on tensors and on numpy arrays. The
    blocks are views unless ``copy`` (a view keeps the whole leaf alive)."""
    if layout == "experts":  # from the shapes given: a caller may hand in one layer's subtree
        specs = local_param_specs(params, cfg, axis_info)
    else:
        specs = param_specs(cfg, axis_info, layout)

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
    """This rank's decode cache, the blocks ``cache_shardings`` gives: the
    page pools and int8 scales padded to a multiple of the page shards and
    striped over ``page_axes``, the SSM states this rank's rows over the
    batch axes (all of them where the batch does not divide), the tables,
    ``page_pos`` and lengths whole. The blocks are copies, so that a decode
    step's in-place writes never reach the full cache."""
    cache = pad_pages(cache, axis_info.n_page_shards)
    specs = cache_shardings(cache, cfg, axis_info)

    def one(path, x, s):
        if path[-1] not in POOL_LEAVES + STATE_LEAVES or not len(s):
            return x
        return shard_leaf(x, s, axis_info).clone()

    return _map(one, cache, specs)


def row_block(batch: int, axis_info) -> slice:
    """The rows of a batch of ``batch`` rows this rank holds (its inputs
    under ``batch_shardings``, its SSM states under ``cache_shardings``):
    its block over the batch axes when they divide ``batch``, else every
    row."""
    n = 1 if axis_info is None else axis_info.n_batch_shards
    if batch % n:
        return slice(0, batch)
    i = axis_info.mesh.axes_index(axis_info.batch_axes) if n > 1 else 0
    return slice(i * (batch // n), (i + 1) * (batch // n))
