"""Per-rank cost of one eager call, the counterpart of
:mod:`repro.launch.hlo_cost`.

The JAX package compiles a step and parses its post-SPMD HLO. The port runs
eagerly, one process per rank, so :func:`measure` runs the call itself under
a ``TorchDispatchMode`` that sees every aten op this rank executes, and
counts:

* **flops** -- matmul and convolution FLOPs, from the formulas of
  ``torch.utils.flop_counter`` (2·M·N·K for a matmul). Elementwise FLOPs are
  left out, as ``hlo_cost`` leaves them out. Eager torch runs every layer
  itself, so there are no loop trip counts to multiply by.
* **bytes** -- Σ (operand + result bytes) over every aten op that runs a
  kernel; views, ``detach``, ops that return no tensor (metadata) and
  factory ops (no tensor operand) are skipped, as ``_SKIP_BYTES_OPS`` skips
  bitcasts, parameters and constants. Eager torch fuses nothing and an
  in-place op counts the tensor it writes as read and written, so this is an
  upper bound on the call's HBM traffic, looser than the JAX count, whose
  fusions keep their internals in registers.
* **collective_bytes** and **collective_count** -- the port's collectives
  are all all-reduces (:mod:`repro_torch.parallel.collectives`), whose
  ``stats`` are diffed around the call; the JAX record's other kinds read 0.
* **peak_bytes** -- the most bytes of storage that the call's own ops had
  allocated and not yet freed at any moment: each new storage is tracked
  from the op that returns it until it is freed (``weakref.finalize``), so
  the peak is above the arguments, which the call did not allocate.

The counts are this rank's. :func:`measure` works on real tensors and on
fake ones (``FakeTensorMode``), where nothing is allocated: the dry run
(:mod:`repro_torch.launch.dryrun`) counts full-size cells that way.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.parallel import collectives

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# views the schema does not mark as views
_VIEWS = {torch.ops.aten._unsafe_view}


@dataclasses.dataclass
class Cost:
    flops: float
    bytes: float
    collective_bytes: Dict[str, float]
    collective_total: float
    collective_count: float
    peak_bytes: int


def tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments and
    results; faster than ``tree_flatten``, which runs for every op)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op run inside it, and the
    live bytes of the storages those ops allocate (see the module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._tracked: set = set()

    def _free(self, key: int, nbytes: int) -> None:
        self._tracked.discard(key)
        self.live -= nbytes

    def _track(self, storage) -> None:
        key = id(storage)
        if key in self._tracked:
            return
        nbytes = storage.nbytes()
        self._tracked.add(key)
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins, outs = tensors((args, kwargs)), tensors(out)
        if func.is_view or func._overloadpacket in _VIEWS or not ins or not outs:
            return out
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if not func._schema.is_mutable:  # an in-place or out= op allocates nothing
            known = {id(t.untyped_storage()) for t in ins}
            for t in outs:
                s = t.untyped_storage()
                if id(s) not in known:
                    self._track(s)
        return out


def measure(fn: Callable, *args, **kwargs) -> Tuple[Any, Cost]:
    """``fn(*args, **kwargs)`` and the :class:`Cost` of this rank's part of it."""
    before = dict(collectives.stats)
    mode = CostMode()
    with mode:
        out = fn(*args, **kwargs)
    calls = collectives.stats["calls"] - before["calls"]
    nbytes = collectives.stats["bytes"] - before["bytes"]
    coll = {k: float(nbytes if k == "all-reduce" else 0) for k in COLLECTIVE_OPS}
    return out, Cost(flops=float(mode.flops), bytes=float(mode.bytes), collective_bytes=coll,
                     collective_total=float(nbytes), collective_count=float(calls), peak_bytes=mode.peak)


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under the tensors of ``tree``: what a
    device holds for them (a view holds its whole storage)."""
    seen: Dict[int, int] = {}
    for t in tensors(tree):
        s = t.untyped_storage()
        seen[id(s)] = s.nbytes()
    return sum(seen.values())
