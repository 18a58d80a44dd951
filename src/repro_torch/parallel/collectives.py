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
(:func:`regather`). Over axes of total size 1 every function is the
identity and nothing is sent.

``stats`` counts the all-reduces issued and their bytes (plain integers, as
the kernels count their launches).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.parallel.axisinfo import Mesh

AxisNames = Union[str, Sequence[str]]

stats = {"calls": 0, "bytes": 0}


def _axes(names: AxisNames) -> tuple:
    return (names,) if isinstance(names, str) else tuple(names)


def axis_size(names: AxisNames, mesh: Mesh) -> int:
    """The number of ranks over ``names``."""
    return mesh.axes_size(_axes(names))


def axis_index(names: AxisNames, mesh: Mesh) -> int:
    """This rank's row-major index over ``names`` (``jax.lax.axis_index``)."""
    return mesh.axes_index(_axes(names))


def _all_reduce(x: torch.Tensor, names: AxisNames, mesh: Mesh, op) -> torch.Tensor:
    axes = _axes(names)
    if mesh.axes_size(axes) == 1:
        return x
    y = x.contiguous().clone()
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
    return psum(full, names + sum_names, mesh)
