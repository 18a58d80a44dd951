"""Multi-pod dry run on fake ranks, the counterpart of
:mod:`repro.launch.dryrun`: for every (arch × shape × mesh) cell, this
rank's memory, FLOPs, bytes and collective bytes, and a three-term roofline
on the NVIDIA H100's constants.

The JAX package lowers and compiles each cell over ``ShapeDtypeStruct``
inputs. The port runs its own step code instead, eagerly, on fake tensors
(``FakeTensorMode``: shapes and dtypes, nothing allocated) in a process
that joins a ``"fake"`` process group of 256 (16 x 16) or 512 (2 x 16 x 16)
ranks as rank 0, and counts what rank 0 runs with
:mod:`repro_torch.launch.cost`. The params come from
:func:`repro_torch.convert.param_shapes` (the real init draws from a
generator, which fake tensors cannot), laid out as the port lays them out
(:func:`repro_torch.parallel.sharding.shard_params`): every cell in the
``"jax"`` layout, every leaf its ``param_shardings`` block, the JAX
package's own layout (a train cell's AdamW moments too). A train step
takes this rank's block of the batch, and a prefill takes the global
batch and reads this rank's rows of it; the arguments of both count those
rows (the block ``batch_shardings`` gives the rank, as the JAX package's
``in_shardings``). A decode cache holds the pools' stripe and the SSM
states of the rank's rows (``cache_shardings``); decode rows are
replicated on every rank, and so are its tokens. Fake tensors are CPU tensors, so
every attention call takes a plain path: prefill and training the JAX
package's XLA path in PyTorch (``impl="xla"``), decode the paged kernel's
plain version, as the JAX dry run takes its XLA path (``use_pallas=False``).
The record says ``"device": "fake"``: nothing was allocated on any device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_results.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import param_shapes
from repro_torch.launch import cost as C
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_axis_info, make_production_mesh
from repro_torch.models.config import SHAPES, ModelConfig, get_shape
from repro_torch.models.lm import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axisinfo import AxisInfo
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step

# ------------------- hardware constants (NVIDIA H100 SXM5 80GB HBM3, 700 W) -------------------
# NVIDIA's H100 datasheet: dense bf16 tensor-core rate and HBM3 rate of the SXM5 part at its
# 700 W limit; one 400 Gb/s NDR InfiniBand link a GPU, since every axis of a 16 x 16 mesh of
# 8-GPU nodes crosses nodes
PEAK_FLOPS = 989e12  # bf16 FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
NET_BW = 50e9  # bytes/s per card

IMPL = "xla"  # the attention path every cell runs (see the module docstring)


def should_skip(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not cfg.supports_500k:
        return "pure full-attention arch: long_500k needs sub-quadratic attention (DESIGN.md §4)"
    return None


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``"fake"`` process group of
    ``world_size`` ranks: collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def abstract_params(cfg: ModelConfig, axis_info: Optional[AxisInfo]):
    """This rank's params in the ``"jax"`` layout as tensors of the current mode
    (fake or meta inside one), every leaf in ``cfg.pdtype()``; the blocks
    are copies, so that each holds only its own bytes."""
    params = shd._map(lambda _, shape: torch.empty(shape, dtype=cfg.pdtype()), param_shapes(cfg))
    if axis_info is None:
        return params
    return shd.shard_params(params, cfg, axis_info, copy=True, layout="jax")


def _materialize(spec: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Meta specs as tensors of the current mode."""
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in spec.items()}


def _prefill_inputs(cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """The JAX batch dict as the port's ``prefill`` takes it."""
    if cfg.input_kind == "encdec":
        return batch
    return batch["embeds"] if cfg.input_kind == "embeds" else batch["tokens"]


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> int:
    n = cfg.param_count(active_only=True)
    if kind == "train":
        return 6 * n * batch * seq
    if kind == "prefill":
        return 2 * n * batch * seq
    return 2 * n * batch


def build_step(cfg: ModelConfig, kind: str, batch: int, seq: int, axis_info: Optional[AxisInfo]):
    """``(fn, args, held)`` of one step of ``kind`` at the global ``batch``
    x ``seq``, its inputs made in the current mode: the train step (params,
    AdamW state and this rank's block of the batch), a prefill, or one
    decode step over an empty cache for ``seq`` tokens (this rank's: its
    pools' stripe, its rows' SSM states). ``held`` is what the rank holds of
    ``args``: a prefill's batch cut to its rows."""
    model = build_model(cfg)
    params = abstract_params(cfg, axis_info)
    if kind == "train":
        step = make_train_step(model, cfg, AdamWConfig(), axis_info)
        spec = S.train_batch_spec(cfg, batch, seq)
        data = _materialize(spec)
        if axis_info is not None:
            blocks = shd.batch_shardings(spec, cfg, axis_info)
            data = {k: shd.shard_leaf(v, blocks[k], axis_info).clone() for k, v in data.items()}
        args = (params, adamw_init(params), data)
        return (lambda p, o, d: step(p, o, d, batch)), args, args
    if kind == "prefill":
        spec = S.prefill_batch_spec(cfg, batch, seq)
        data = _prefill_inputs(cfg, _materialize(spec))
        held = data
        if axis_info is not None:
            blocks = shd.batch_shardings(spec, cfg, axis_info)
            held = _prefill_inputs(cfg, {k: shd.shard_leaf(v, blocks[k], axis_info).clone() for k, v in
                                         _materialize(spec).items()})
        return (lambda p, x: model.prefill(p, x, impl=IMPL, axis_info=axis_info)), (params, data), (params, held)
    cache = model.init_cache(batch, seq, device="cpu", axis_info=axis_info)
    tokens = torch.zeros(S.decode_tokens_spec(cfg, batch).shape, dtype=torch.int32)
    args = (params, cache, tokens)
    return (lambda p, c, t: model.decode_step(p, c, t, impl=IMPL, axis_info=axis_info)), args, args


def arguments(cfg: ModelConfig, kind: str, batch: int, seq: int, axis_info: Optional[AxisInfo] = None) -> int:
    """The argument bytes a rank holds for one step of ``kind`` (those
    :func:`plan` records), counted on fake tensors without running the
    step: no process group is needed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return C.storage_bytes(build_step(cfg, kind, batch, seq, axis_info)[2])


def plan(cfg: ModelConfig, kind: str, batch: int, seq: int,
         axis_info: Optional[AxisInfo] = None) -> Dict[str, Any]:
    """The record of one step on fake tensors: this rank's bytes, FLOPs,
    HBM bytes and collective bytes, and the roofline (one rank without an
    ``axis_info``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fn, args, counted = build_step(cfg, kind, batch, seq, axis_info)
        arg_bytes = C.storage_bytes(counted)
        held = {id(t.untyped_storage()) for t in C.tensors(args)}
        out, cost = C.measure(fn, *args)
        new_out = [t for t in C.tensors(out) if id(t.untyped_storage()) not in held]
        out_bytes = C.storage_bytes(new_out)
    mflops = model_flops(cfg, kind, batch, seq)
    terms = {"compute_s": cost.flops / PEAK_FLOPS, "memory_s": cost.bytes / HBM_BW,
             "collective_s": cost.collective_total / NET_BW}
    dominant = max(terms, key=lambda k: terms[k] or 0.0)
    n_devices = axis_info.mesh.size if axis_info is not None else 1
    return dict(
        kind=kind,
        n_devices=n_devices,
        model_flops=mflops,
        params=cfg.param_count(),
        active_params=cfg.param_count(active_only=True),
        ok=True,
        device="fake",
        bytes_per_device=dict(arguments=arg_bytes, outputs=out_bytes, temps=max(cost.peak_bytes - out_bytes, 0),
                              total=arg_bytes + max(cost.peak_bytes, out_bytes)),
        hlo_flops_per_device=cost.flops,
        hlo_bytes_per_device=cost.bytes,
        collectives=dict(cost.collective_bytes),
        collective_count=cost.collective_count,
        roofline=dict(**terms, dominant=dominant, model_flops=mflops,
                      useful_flops_ratio=mflops / (cost.flops * n_devices) if cost.flops > 0 else None),
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    cfg = get_config(arch)
    skip = should_skip(cfg, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if skip:
        return dict(base, ok=True, skipped=skip)
    shape = get_shape(shape_name)
    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            rec = plan(cfg, shape.kind, shape.global_batch, shape.seq_len, make_axis_info(mesh))
        rec.update(base, run_s=round(time.time() - t0, 1))
        return rec
    except Exception as e:  # a cell that raises is recorded, never dropped
        return dict(base, ok=False, error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default="all")
    ap.add_argument("--shape", choices=[s.name for s in SHAPES] + ["all"], default="all")
    ap.add_argument("--all", action="store_true", help="every arch and shape (the default)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape_name, mp)
                line = json.dumps(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
                slim = {k: v for k, v in rec.items() if k not in ("traceback", "collectives")}
                print(json.dumps(slim), flush=True)
                if not rec.get("ok"):
                    print(rec.get("traceback", ""), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
