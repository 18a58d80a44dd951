"""Collectives over named mesh axes, the counterpart of
:mod:`repro.parallel.compat` and of the ``jax.lax`` collectives the JAX
package calls inside ``shard_map`` bodies.

The port has no ``shard_map``: each rank is its own process and runs the
body itself, so ``compat.shard_map`` has no counterpart here, and an axis
name is resolved to a process group through the :class:`Mesh`.
``psum``/``pmax``/``pmean`` are each one ``torch.distributed.all_reduce``
on the group of those axes, on a copy of the tensor that stays on its
device. Only ``all_reduce`` is used: with one card the ranks share it under
gloo, which carries ``all_reduce`` and ``broadcast`` for CUDA tensors and
little else, so a gather is written as a SUM over a zero-filled full buffer
(:func:`regather`; :func:`regather_many` packs several blocks into one
call). Over axes of total size 1 every function is the identity and
nothing is sent.

``stats`` counts the all-reduces issued and their bytes (plain integers, as
the kernels count their launches).

**Training.** ``dist.all_reduce`` is invisible to autograd: the functions
above run on a ``clone()``, so a backward pass through them is the identity.
The training path therefore uses the autograd functions below, each with
its backward written out for the port's SPMD model of a step: the loss is
summed over the batch axes (each rank holds its share of its rows, and the
gradients are summed over them) and held once over the model axis (its
ranks compute the same share, each with its block of the weights, so each
holds the whole cotangent of every value they all hold). So a gather over
a batch axis sums the cotangents in its backward, and one over the model
axis does not:

* :func:`gather_blocks` / :func:`gather_blocks_many` (the forward of
  :func:`regather`; backward: the cotangents summed over the gathered
  axes, this rank's block of them). Over ``data`` it is the FSDP gather,
  its backward the reduce-scatter;
* :func:`tp_gather` (the forward of :func:`regather_many`, also summing
  partial products over ``sum_names``; backward: this rank's block, no
  collective). Over ``model``: an output regathered from the ranks'
  blocks (the vocab-split logits), or partials summed (``names=()``);
* :func:`tp_block` (this rank's block of a value every rank holds;
  backward: the blocks' cotangents regathered), where a replicated
  activation meets a weight split on its contracting dim;
* :func:`grad_psum` (the identity; its backward sums the cotangents: the
  input of a product whose output dim is split, whose other parts the
  other ranks compute);
* :func:`mean_of_shares` (:func:`pmean`; its backward sums the cotangents
  and divides).

Decode keeps its rows replicated over every axis, so there every axis is
one of the model axis's kind; it runs without autograd.

:func:`psum_` sums a list of tensors in place, a few flat buffers at a
time: the gradient all-reduce.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.parallel.axisinfo import Mesh

AxisNames = Union[str, Sequence[str]]

stats = {"calls": 0, "bytes": 0}

# the most bytes :func:`psum_` packs into one flat buffer: few calls (gloo
# costs milliseconds a call) with one copy of a bucket at a time
BUCKET_BYTES = 1 << 28


def _axes(names: AxisNames) -> tuple:
    return (names,) if isinstance(names, str) else tuple(names)


def axis_size(names: AxisNames, mesh: Mesh) -> int:
    """The number of ranks over ``names``."""
    return mesh.axes_size(_axes(names))


def axis_index(names: AxisNames, mesh: Mesh) -> int:
    """This rank's row-major index over ``names`` (``jax.lax.axis_index``)."""
    return mesh.axes_index(_axes(names))


def _all_reduce(x: torch.Tensor, names: AxisNames, mesh: Mesh, op, fresh: bool = False) -> torch.Tensor:
    """The reduction over ``names`` of ``x``, on a copy unless ``fresh``
    (``x`` is a contiguous buffer the caller hands over)."""
    axes = _axes(names)
    if mesh.axes_size(axes) == 1:
        return x
    y = x if fresh else x.contiguous().clone()
    dist.all_reduce(y, op=op, group=mesh.group(axes))
    stats["calls"] += 1
    stats["bytes"] += y.numel() * y.element_size()
    return y


def psum(x: torch.Tensor, names: AxisNames, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``names``, on every one of them."""
    return _all_reduce(x, names, mesh, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, names: AxisNames, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the ranks of ``names``."""
    return _all_reduce(x, names, mesh, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, names: AxisNames, mesh: Mesh) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``names``: :func:`psum` over their count."""
    n = axis_size(names, mesh)
    if n == 1:
        return x
    return psum(x, names, mesh) / torch.full((), n, dtype=x.dtype, device=x.device)


def regather(block: torch.Tensor, names: AxisNames, mesh: Mesh, sum_names: AxisNames = ()) -> torch.Tensor:
    """The full tensor whose dim-0 blocks are the ranks' ``block`` over
    ``names`` (row-major over them), on every rank; with ``sum_names`` also
    summed over those axes. One all-reduce SUM over a zero-filled buffer:
    each rank writes its block at its index over ``names``, and adding the
    other ranks' zeros is exact, so the result is the gather (and the sum
    over ``sum_names``) bit for bit."""
    names, sum_names = _axes(names), _axes(sum_names)
    n = axis_size(names, mesh)
    if n == 1:
        return psum(block, sum_names, mesh)
    full = torch.zeros((n * block.shape[0], *block.shape[1:]), dtype=block.dtype, device=block.device)
    i = axis_index(names, mesh)
    full[i * block.shape[0]:(i + 1) * block.shape[0]] = block
    return _all_reduce(full, names + sum_names, mesh, dist.ReduceOp.SUM, fresh=True)


def regather_many(blocks: Sequence[torch.Tensor], names: AxisNames, mesh: Mesh,
                  sum_names: AxisNames = ()) -> List[torch.Tensor]:
    """:func:`regather` of several blocks (one dtype) in ONE all-reduce:
    each rank writes its blocks, flattened one after another, into its row
    of a zero-filled ``(n, total)`` buffer. Bit for bit the separate
    regathers (the other ranks add exact zeros)."""
    names, sum_names = _axes(names), _axes(sum_names)
    n = axis_size(names, mesh)
    if n * axis_size(sum_names, mesh) == 1:
        return list(blocks)
    sizes = [b.numel() for b in blocks]
    full = torch.zeros((n, sum(sizes)), dtype=blocks[0].dtype, device=blocks[0].device)
    row = full[axis_index(names, mesh) if names else 0]
    k = 0
    for b, size in zip(blocks, sizes):
        row[k:k + size] = b.reshape(-1)
        k += size
    full = _all_reduce(full, names + sum_names, mesh, dist.ReduceOp.SUM, fresh=True)
    out, k = [], 0
    for b, size in zip(blocks, sizes):
        out.append(full[:, k:k + size].reshape(n, *b.shape).reshape(n * b.shape[0], *b.shape[1:])
                   if names else full[0, k:k + size].view(b.shape))
        k += size
    return out


# ------------------------------ training: collectives with their backward ------------------------------
def _take(g: torch.Tensor, dim: int, names: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``g`` along ``dim`` over ``names`` (a view)."""
    if not names:
        return g
    b = g.shape[dim] // axis_size(names, mesh)
    return g.narrow(dim, axis_index(names, mesh) * b, b)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, names, sum_names, grad_sum, mesh, *blocks):
        ctx.names, ctx.grad_sum, ctx.mesh = names, grad_sum, mesh
        return tuple(regather_many(blocks, names, mesh, sum_names))

    @staticmethod
    def backward(ctx, *gs):  # an output that reached no loss arrives as zeros (materialized)
        if ctx.grad_sum and axis_size(ctx.grad_sum, ctx.mesh) > 1:
            flat = psum(torch.cat([g.reshape(-1) for g in gs]) if len(gs) > 1 else gs[0], ctx.grad_sum, ctx.mesh)
            out, k = [], 0
            for g in gs:
                out.append(flat.reshape(-1)[k:k + g.numel()].view(g.shape))
                k += g.numel()
            gs = out
        return (None, None, None, None, *(_take(g, 0, ctx.names, ctx.mesh) for g in gs))


def gather_blocks(block: torch.Tensor, names: AxisNames, mesh: Mesh, sum_names: AxisNames = ()) -> torch.Tensor:
    """:func:`regather` under autograd. Backward: the cotangents summed over
    ``names`` (every rank's loss share reads every block), this rank's block
    of them; over ``sum_names`` the identity (the ranks there hold one
    loss, each the whole cotangent)."""
    return gather_blocks_many([block], names, mesh, sum_names)[0]


def gather_blocks_many(blocks: Sequence[torch.Tensor], names: AxisNames, mesh: Mesh,
                       sum_names: AxisNames = ()) -> List[torch.Tensor]:
    """:func:`gather_blocks` of several blocks (one dtype) in one all-reduce,
    and their cotangents summed in one all-reduce in the backward: a
    layer's FSDP gather over ``data`` and its reduce-scatter."""
    names, sum_names = _axes(names), _axes(sum_names)
    if axis_size(names + sum_names, mesh) == 1:
        return list(blocks)
    return list(_Gather.apply(names, sum_names, names, mesh, *blocks))


def tp_gather(blocks: Sequence[torch.Tensor], names: AxisNames, mesh: Mesh,
              sum_names: AxisNames = ()) -> List[torch.Tensor]:
    """:func:`regather_many` under autograd, over axes whose ranks hold one
    loss between them (the model axis): the whole of each block's dim 0
    over ``names``, summed over ``sum_names`` (partial products), in one
    all-reduce. Backward: this rank's block of each cotangent, with no
    collective (every rank holds the whole cotangent)."""
    names, sum_names = _axes(names), _axes(sum_names)
    if axis_size(names + sum_names, mesh) == 1:
        return list(blocks)
    return list(_Gather.apply(names, sum_names, (), mesh, *blocks))


class _TpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, names, mesh):
        ctx.dim, ctx.names, ctx.mesh = dim, names, mesh
        return _take(x, dim, names, mesh)

    @staticmethod
    def backward(ctx, g):
        whole = regather_many([g.movedim(ctx.dim, 0)], ctx.names, ctx.mesh)[0]
        return whole.movedim(0, ctx.dim), None, None, None


def tp_block(x: torch.Tensor, dim: int, names: AxisNames, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``names``, for an ``x``
    that every rank over ``names`` holds whole (a replicated activation
    meeting a weight split on its contracting dim). Backward: each rank
    holds the cotangent of its block only, so the blocks are regathered
    (one all-reduce): every rank gets the whole cotangent of ``x``. ``x``
    itself when ``names`` is empty."""
    names = _axes(names)
    if not names or axis_size(names, mesh) == 1:
        return x
    return _TpBlock.apply(x, dim % x.ndim, names, mesh)


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, names, mesh, *xs):
        ctx.names, ctx.mesh = names, mesh
        out = tuple(x.view_as(x) for x in xs)
        return out if len(out) > 1 else out[0]

    @staticmethod
    def backward(ctx, *gs):
        live = [g for g in gs if g is not None]
        if live and axis_size(ctx.names, ctx.mesh) > 1:
            flat = psum(torch.cat([g.float().reshape(-1) for g in live]), ctx.names, ctx.mesh)
            out, k = [], 0
            for g in gs:
                if g is None:
                    out.append(None)
                    continue
                out.append(flat[k:k + g.numel()].reshape(g.shape).to(g.dtype))
                k += g.numel()
            gs = out
        return (None, None, *gs)


def grad_psum(names: AxisNames, mesh: Mesh, *xs: torch.Tensor):
    """The ``xs`` unchanged (a tuple when there are several). Backward:
    each cotangent summed over ``names``, all of them in one all-reduce, in
    f32 and cast back (with two ranks the same as a sum in the tensor's
    own dtype). Put it where a value enters a product whose parts lie on
    the ranks of ``names``: the tokens and gates that enter a rank's
    experts."""
    return _GradPsum.apply(_axes(names), mesh, *xs)


class _MeanOfShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names, mesh):
        ctx.names, ctx.mesh = names, mesh
        return pmean(x, names, mesh)

    @staticmethod
    def backward(ctx, g):
        return pmean(g, ctx.names, ctx.mesh), None, None


def mean_of_shares(x: torch.Tensor, names: AxisNames, mesh: Mesh) -> torch.Tensor:
    """:func:`pmean` under autograd for a value that every rank over
    ``names`` adds to its loss share. Backward: the cotangents averaged
    over ``names`` (summed, as the shares are, then divided as the
    forward divides)."""
    return _MeanOfShares.apply(x, _axes(names), mesh)


def psum_(tensors: List[torch.Tensor], names: AxisNames, mesh: Mesh) -> int:
    """Sum ``tensors`` (contiguous, one dtype) over ``names`` in place, in
    buckets: consecutive tensors are packed into one flat buffer of at most
    ``BUCKET_BYTES`` (a tensor larger than that goes alone, without a
    copy), each bucket one all-reduce. Returns the number of all-reduces."""
    axes = _axes(names)
    if mesh.axes_size(axes) == 1 or not tensors:
        return 0
    group = mesh.group(axes)
    calls = 0

    def reduce(bucket: List[torch.Tensor]) -> None:
        nonlocal calls
        if len(bucket) == 1:
            flat = bucket[0]
        else:
            flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        stats["calls"] += 1
        stats["bytes"] += flat.numel() * flat.element_size()
        calls += 1
        if len(bucket) > 1:
            k = 0
            for t in bucket:
                t.copy_(flat[k:k + t.numel()].view(t.shape))
                k += t.numel()

    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and size + nbytes > BUCKET_BYTES:
            reduce(bucket)
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        reduce(bucket)
    return calls
