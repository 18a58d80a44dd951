"""Process groups and meshes over ranks, the counterpart of
:mod:`repro.launch.mesh`.

The JAX package builds a mesh over the devices one process sees; the port
runs one process per rank and builds the mesh over the ranks of the
initialised process group. :func:`init_distributed` is the entry point that
starts the group; :func:`spawn` runs a function on every rank of a new
group, each process under a deadline. Nothing here touches a device or a
process group when the module is imported.
"""

from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.parallel.axisinfo import AxisInfo, Mesh


@dataclasses.dataclass(frozen=True)
class Distributed:
    """What :func:`init_distributed` chose: the backend and this rank's device."""

    backend: str
    device: torch.device
    rank: int
    world_size: int

    def describe(self) -> str:
        n_cards = torch.cuda.device_count() if self.device.type == "cuda" else 0
        return (f"backend {self.backend}, {self.world_size} ranks, rank {self.rank} on {self.device}"
                f"{f' ({n_cards} card(s))' if self.device.type == 'cuda' else ''}")


def choose_backend(world_size: int, rank: int, device="cuda") -> Distributed:
    """NCCL with one card a rank when the host has a card for every rank;
    gloo when ranks share cards (NCCL refuses two ranks on one device),
    rank ``r`` on card ``r % count``; gloo on the CPU only when the caller
    passes ``device="cpu"``. A card asked for and absent raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Distributed("gloo", dev, rank, world_size)
    n = torch.cuda.device_count()
    backend = "nccl" if n >= world_size else "gloo"
    return Distributed(backend, torch.device("cuda", rank % n), rank, world_size)


def init_distributed(rank: int, world_size: int, init_method: str, *, device="cuda",
                     timeout_s: float = 600.0) -> Distributed:
    """Join the process group as ``rank`` of ``world_size`` at
    ``init_method`` (``file://<path>`` or ``tcp://localhost:<port>``), with
    the backend :func:`choose_backend` picks (returned, so the caller can
    say which). Every collective waits at most ``timeout_s``."""
    chosen = choose_backend(world_size, rank, device)
    if chosen.device.type == "cuda":
        torch.cuda.set_device(chosen.device)
    dist.init_process_group(chosen.backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return chosen


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the ranks of the process group (every rank calls it, in
    the same order), with one process group per tuple of axes of size > 1.
    Without an initialised group the mesh must hold one rank."""
    mesh = Mesh(shape, axis_names, rank=dist.get_rank() if dist.is_initialized() else 0)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh.size != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {mesh.size} ranks, the world has {world}")
    for axes in mesh.axis_subsets():
        size = mesh.axes_size(axes)
        if size == 1:
            continue
        if size == world:
            mesh.groups[axes] = dist.group.WORLD
        else:
            mesh.groups[axes], _ = dist.new_subgroups_by_enumeration(mesh.group_ranks(axes))
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 (256 ranks) or 2 x 16 x 16 (512 ranks), the JAX package's
    production shapes; raises ``ValueError`` on any other world size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_axis_info(mesh: Mesh) -> AxisInfo:
    if "pod" in mesh.axis_names:
        return AxisInfo(mesh, batch_axes=("pod", "data"), model_axis="model")
    return AxisInfo(mesh, batch_axes=("data",), model_axis="model")


def make_mesh_for_devices(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """Elastic ``(n // model_parallel, model_parallel)`` mesh over
    ``("data", "model")``; ``n`` defaults to the world size."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"))


# ------------------------------ running every rank ------------------------------
def _rank_main(rank: int, fn: Callable, world_size: int, model_parallel: int, device, timeout_s: float,
               workdir: str, args: tuple) -> None:
    # a rank still running at its deadline prints every thread's stack and exits
    faulthandler.dump_traceback_later(timeout_s, exit=True)
    chosen = init_distributed(rank, world_size, f"file://{workdir}/store", device=device, timeout_s=timeout_s)
    if chosen.device.type == "cpu":
        torch.set_num_threads(1)
    try:
        axis_info = make_axis_info(make_mesh_for_devices(world_size, model_parallel))
        result = fn(axis_info, chosen, *args)
        torch.save(result, Path(workdir) / f"rank{rank}.pt")
    except BaseException:
        # the parent reports one failed rank; every rank's own error is printed here
        print(f"rank {rank} of {world_size} failed:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()


def spawn(fn: Callable, world_size: int, args: tuple = (), *, model_parallel: int = 1, device="cuda",
          timeout_s: float = 60.0) -> List[Any]:
    """Run ``fn(axis_info, distributed, *args)`` on ``world_size`` new
    processes (``spawn``), ranks of one group over a ``FileStore`` in a
    fresh directory (no port to collide on) and of a ``(world_size //
    model_parallel, model_parallel)`` mesh; returns each rank's result
    (passed through ``torch.save``), by rank.

    ``fn`` must be importable by name from a new process. Every rank and
    every collective has ``timeout_s``: a rank still running then prints
    its stack and exits, and the others are killed a few seconds later.
    A rank that fails or is killed raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as workdir:
        ctx = mp.start_processes(_rank_main, args=(fn, world_size, model_parallel, str(device), timeout_s,
                                                   workdir, tuple(args)),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s + 5.0
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        # written by the ranks just spawned, into a directory made here
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(world_size)]
