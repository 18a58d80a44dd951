"""Where the time goes in one burst of the serving engine.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--out DIR]

Serves the serving cell that ``chip_smoke.py`` also drives (``cell_requests``:
16 requests, each a shared 128-token system prompt plus its own 64-token
tail, 32 new tokens, greedy) through full-width ``llama3_2-1b`` with
``SLOTS`` = 8 slots and ``PAGES`` = 512 pages, once untraced for the
wall time and once under ``torch.profiler``, and prints:

* wall time, tok/s, and the host time spent in admission (prefill) and in
  batched decode steps, each span ending in a device synchronisation;
* the device's busy time (union of kernel and copy intervals in the trace)
  and its idle share over the traced run;
* per decode step: PyTorch ops dispatched, host time, and device time;
* the ops with the most host (self CPU) time and the kernels with the most
  device time, and the port's own kernels' launches and device time per
  launch.

``--smoke --device cpu`` rehearses the script on the CPU with the smoke
config; it then reports host numbers only, under the CPU's name.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels._build import short_name
from repro_torch.models.lm import build_model
from repro_torch.serving.engine import Request, ServingEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# the hand-written kernels of csrc/, as their names appear in the trace
PORT_KERNELS = ("paged_split_kernel", "flash_fwd_tc_kernel", "flash_fwd_f32_kernel")

# The serving cell, shared with chip_smoke.py: 8 slots over 512 pages, and
# a burst of requests that share one system prompt.
SLOTS, PAGES = 8, 512


def prefix_requests(cfg, n: int, prefix_len: int, tail_len: int, new: int):
    """``n`` greedy requests of ``new`` tokens: one shared ``prefix_len``-token
    prompt prefix, then each request's own ``tail_len``-token tail, all drawn
    from one generator seeded with 0; ids 0 to n - 1."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len).tolist()
    return [Request(i, prefix + rng.integers(0, cfg.vocab_size, tail_len).tolist(), max_new_tokens=new)
            for i in range(n)]


def cell_requests(cfg, *, smoke: bool = False, bursts: int = 1):
    """The cell's burst: 16 requests, each a shared 128-token system prompt
    plus its own 64-token tail, 32 new tokens, greedy (``smoke``: 6 requests
    of 16 + 8 tokens, 4 new tokens); prompts drawn from seed 0. With
    ``bursts`` > 1, the tails of that many bursts in a row, drawn from the
    same generator behind the same system prompt, ids numbered on."""
    n, system_len, tail_len, new = (6, 16, 8, 4) if smoke else (16, 128, 64, 32)
    return prefix_requests(cfg, n * bursts, system_len, tail_len, new)


def warm_up(engine: ServingEngine) -> None:
    """Serve one 64-token request (id -1) so first-call set-up (cuBLAS
    handles, the caching allocator) stays out of the timed burst."""
    warm = np.random.default_rng(1).integers(0, engine.cfg.vocab_size, 64).tolist()
    engine.submit(Request(-1, warm, max_new_tokens=2))
    engine.run_until_drained()
    _sync(engine.device)


def _instrument(engine: ServingEngine, spans: dict, trace: bool) -> None:
    """Time every prefill and every batched decode step (host clock, ending
    in a synchronisation), labelled for the profiler."""
    dev = engine.device

    def timed(name, fn):
        def run(*args, **kw):
            label = record_function(f"engine.{name}") if trace else contextlib.nullcontext()
            t0 = time.perf_counter()
            with label:
                out = fn(*args, **kw)
                _sync(dev)
            spans[name].append(time.perf_counter() - t0)
            return out
        return run

    engine.model = dataclasses.replace(engine.model, prefill=timed("prefill", engine.model.prefill))
    engine._decode = timed("decode", engine._decode)


def _merged_device_intervals(events):
    """The device timeline's busy intervals (kernels, copies, sets), merged.
    The ``engine.*`` labels also appear on the device timeline as
    annotations spanning a whole step; they are not work and are left out."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and not e.name.startswith("engine."))
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_us(merged, lo: float, hi: float) -> float:
    """Device busy time inside the host interval [lo, hi]."""
    i = max(bisect.bisect_right([s for s, _ in merged], lo) - 1, 0)
    busy = 0.0
    for s, e in merged[i:]:
        if s >= hi:
            break
        busy += max(0.0, min(e, hi) - max(s, lo))
    return busy


def _decode_spans(events):
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == "engine.decode" and e.device_type == DeviceType.CPU)


def _per_decode_step(events, n_steps: int) -> dict:
    """Mean count, per decode step, of the host calls under the
    ``engine.decode`` spans: aten ops (nested ones included), kernel
    launches and host synchronisations."""
    spans = _decode_spans(events)
    starts = [s for s, _ in spans]
    counts = {"aten_ops": 0, "kernel_launches": 0, "syncs": 0}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0 or e.time_range.start > spans[i][1]:
            continue
        if e.name.startswith("aten::"):
            counts["aten_ops"] += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC"):
            counts["kernel_launches"] += 1
        elif "Synchronize" in e.name:
            counts["syncs"] += 1
    return {k: v / max(n_steps, 1) for k, v in counts.items()}


def run(cfg, dev: torch.device, *, requests, trace: bool):
    model = build_model(cfg)
    params = model.init(seed=0, device=dev, dtype=cfg.cdtype())
    engine = ServingEngine(cfg, params, max_slots=SLOTS, n_pages=PAGES, device=dev)
    del params
    warm_up(engine)
    spans = {"prefill": [], "decode": []}
    _instrument(engine, spans, trace)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=activities) if trace else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        for r in requests:
            engine.submit(dataclasses.replace(r))
        done = engine.run_until_drained()
        _sync(dev)
        wall = time.perf_counter() - t0
    done = {k: v for k, v in done.items() if k >= 0}
    if sorted(done) != [r.request_id for r in requests]:
        raise RuntimeError(f"completed {sorted(done)} of {len(requests)} requests")
    return dict(wall_s=wall, tokens=sum(len(c.tokens) for c in done.values()),
                prefill_s=spans["prefill"], decode_s=spans["decode"],
                prof=prof if trace else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="the smoke config (CPU rehearsal)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="directory for the full op tables")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("llama3_2-1b")
    if args.smoke:
        cfg = cfg.smoke()
    requests = cell_requests(cfg, smoke=args.smoke)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"

    plain = run(cfg, dev, requests=requests, trace=False)
    traced = run(cfg, dev, requests=requests, trace=True)
    prof = traced["prof"]
    events = prof.events()
    n_steps = len(traced["decode_s"])

    per_step = _per_decode_step(events, n_steps)
    busy_us = decode_busy_us = None
    if dev.type == "cuda":
        merged = _merged_device_intervals(events)
        busy_us = sum(e - s for s, e in merged)
        decode_busy_us = sum(_overlap_us(merged, lo, hi) for lo, hi in _decode_spans(events))
    wall_us = traced["wall_s"] * 1e6
    ka = prof.key_averages()
    dev_attr = "self_device_time_total"
    port_kernels = {short_name(e.key):
                    {"launches": e.count, "device_us_per_launch": getattr(e, dev_attr) / e.count}
                    for e in ka if any(k in e.key for k in PORT_KERNELS) and e.count}
    summary = {
        "device": kind, "arch": cfg.arch_id, "smoke": args.smoke, "slots": SLOTS,
        "requests": len(requests), "tokens": plain["tokens"],
        "untraced": {"wall_s": plain["wall_s"], "tok_per_s": plain["tokens"] / plain["wall_s"],
                     "prefill_s": sum(plain["prefill_s"]), "n_prefill": len(plain["prefill_s"]),
                     "decode_s": sum(plain["decode_s"]), "n_decode": len(plain["decode_s"]),
                     "decode_step_ms_median": 1e3 * float(np.median(plain["decode_s"]))},
        "traced": {"wall_s": traced["wall_s"], "prefill_s": sum(traced["prefill_s"]),
                   "decode_s": sum(traced["decode_s"]), "n_decode": n_steps,
                   "device_busy_s": None if busy_us is None else busy_us / 1e6,
                   "device_idle_share": None if busy_us is None else 1.0 - busy_us / wall_us,
                   "decode_device_busy_ms_per_step": (None if decode_busy_us is None
                                                      else decode_busy_us / 1e3 / n_steps),
                   "per_decode_step": per_step,
                   "port_kernels": port_kernels},
    }
    host_table = ka.table(sort_by="self_cpu_time_total", row_limit=25)
    dev_table = ka.table(sort_by=dev_attr, row_limit=15) if dev.type == "cuda" else ""
    print("top ops by host self time (traced run):\n" + host_table, flush=True)
    if dev_table:
        print("top ops by device self time (traced run):\n" + dev_table, flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "profile_serve_host.txt").write_text(ka.table(sort_by="self_cpu_time_total", row_limit=200))
        if dev_table:
            (out / "profile_serve_device.txt").write_text(ka.table(sort_by=dev_attr, row_limit=200))
        (out / "profile_serve.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
