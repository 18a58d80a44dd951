"""Mesh axis bookkeeping shared by model code and the launcher, the
counterpart of :mod:`repro.parallel.axisinfo`.

The port runs one process per rank (SPMD by hand): every rank executes the
whole program, and a value is either replicated (the same on every rank) or
sharded (each rank holds its block). :class:`Mesh` lays the ranks out
row-major over named axes, as ``jax.make_mesh`` lays out devices, and holds
one process group per tuple of axes the collectives reduce over
(:mod:`repro_torch.parallel.collectives`).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

Axes = Tuple[str, ...]


class Mesh:
    """Ranks ``0 .. size-1`` laid out row-major over ``axis_names``.

    ``shape[name]`` is an axis's size, as on a ``jax.sharding.Mesh``;
    ``rank`` is this process's rank. ``groups`` maps each tuple of axes (in
    mesh order) to the process group of the ranks that share this rank's
    coordinates on every other axis; :func:`repro_torch.launch.mesh.make_mesh`
    creates them. A mesh without groups still answers layout questions
    (specs, blocks, offsets); a collective over an axis of size > 1 on it
    raises.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], rank: int = 0):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not fit axis names {tuple(axis_names)}")
        self.axis_names: Axes = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = 1
        for s in self.shape.values():
            self.size *= s
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        self.rank = rank
        self.groups: Dict[Axes, object] = {}

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """A rank's coordinate on every axis (this rank's by default)."""
        r = self.rank if rank is None else rank
        out = {}
        for name in reversed(self.axis_names):
            r, out[name] = divmod(r, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def ordered(self, axes: Sequence[str]) -> Axes:
        """``axes`` in mesh order (a group is a set of ranks)."""
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axes_size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in self.ordered(axes):
            n *= self.shape[a]
        return n

    def axes_index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """Row-major index of a rank over ``axes`` in the order given."""
        c = self.coords(rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def group_ranks(self, axes: Sequence[str]) -> list:
        """Every group over ``axes``: lists of ranks that differ only there."""
        axes = self.ordered(axes)
        others = [a for a in self.axis_names if a not in axes]
        groups: Dict[Tuple[int, ...], list] = {}
        for r in range(self.size):
            c = self.coords(r)
            groups.setdefault(tuple(c[a] for a in others), []).append(r)
        return list(groups.values())

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes``."""
        key = self.ordered(axes)
        if key not in self.groups:
            raise RuntimeError(f"mesh {self.shape} has no process group over {key}; "
                               "build it with repro_torch.launch.mesh.make_mesh")
        return self.groups[key]

    def axis_subsets(self):
        """Every non-empty tuple of axes, in mesh order."""
        for n in range(1, len(self.axis_names) + 1):
            yield from itertools.combinations(self.axis_names, n)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


@dataclasses.dataclass(frozen=True)
class AxisInfo:
    """Which mesh axes play which role.

    ``batch_axes`` shard the batch (pure DP): ``('data',)`` single-pod or
    ``('pod', 'data')`` multi-pod. ``model_axis`` is the TP/EP axis. The KV
    page pool is sharded over *all* axes (``page_axes``), the analogue of
    the paper's page striping across every data provider.
    """

    mesh: Mesh
    batch_axes: Axes
    model_axis: str = "model"

    @property
    def page_axes(self) -> Axes:
        return self.batch_axes + (self.model_axis,)

    @property
    def n_batch_shards(self) -> int:
        return self.mesh.axes_size(self.batch_axes)

    @property
    def n_page_shards(self) -> int:
        return self.mesh.axes_size(self.page_axes)

    def sharding(self, *spec):
        """The partition spec ``P(*spec)`` (the JAX package returns a
        ``NamedSharding`` of it; the port's mesh is implied)."""
        from repro_torch.parallel.sharding import P

        return P(*spec)


def single_device_axis_info() -> Optional[AxisInfo]:
    """None: model code treats None as 'run the local path directly'."""
    return None


def constrain(x, axis_info: Optional[AxisInfo], *spec):
    """Identity. In the JAX package a ``with_sharding_constraint``: a GSPMD
    layout hint with no numeric effect. The port keeps activations
    replicated on every rank, so there is no layout to hint."""
    return x


def constrain_batch(x, axis_info: Optional[AxisInfo]):
    """Identity, as :func:`constrain` (the JAX package shards dim 0 over the
    DP axes here, a layout hint with no numeric effect)."""
    return x


def page_offset_in_shard(axis_names: Sequence[str], pages_local: int, mesh: Mesh) -> int:
    """First global page id owned by this rank: its row-major index over
    ``axis_names`` times ``pages_local``."""
    return mesh.axes_index(axis_names) * pages_local
