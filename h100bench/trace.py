"""Reduces a ``torch.profiler`` trace of a short steady stretch of the window
to the numbers the per-layer metrics and the result line read.

The stretch is the CPU range ``bench.stretch``. Device work is every event
on the device timeline (kernels, copies, sets) except the ``bench.*``
annotations, which span work and are not work. The device's busy time is
the union of those intervals inside the stretch; an idle gap is a hole in
that union, labelled by what the host's main thread was doing at its
middle: the engine span (``bench.prefill``, ``bench.decode``, else
``step``) and the innermost operation there. A ``bench.paged#i`` or
``bench.flash#i`` range is one call of ``ops.paged_attention`` or
``ops.flash_attention``: its device time is the kernel time inside the
range's annotation on the device timeline.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

TOP = 10  # entries of each breakdown list


def short_name(name: str, limit: int = 80) -> str:
    """A kernel's name without parameter list, return type and namespaces."""
    name = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    name = name.removeprefix("void ").strip()
    return name[:limit]


def merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(merged, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in merged if e > lo and s < hi]


def _gap_labels(cpu, gaps) -> Dict[str, float]:
    """Seconds of idle gaps by the host's span and innermost operation at
    each gap's middle (a sweep over the main thread's nested ranges)."""
    by_label: Dict[str, float] = defaultdict(float)
    stack: list = []
    j = 0
    for s, e in gaps:  # in time order
        m = (s + e) / 2
        while j < len(cpu) and cpu[j][0] <= m:
            while stack and stack[-1][1] <= cpu[j][0]:
                stack.pop()
            stack.append(cpu[j])
            j += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        span = next((n[6:] for _, _, n in reversed(stack) if n in ("bench.prefill", "bench.decode")), "step")
        inner = next((n for _, _, n in reversed(stack) if not n.startswith("bench.")), "python")
        by_label[f"{span}: {inner}"] += (e - s) / 1e6
    return by_label


def summarize(prof) -> dict:
    """``busy_s``, ``window_s``, ``calls`` ({range name: device seconds}) and
    ``breakdown`` (``device_ops`` and ``idle_gaps``, at most ``TOP`` each)."""
    events = prof.events()
    stretch = next(e for e in events if e.name == "bench.stretch" and e.device_type == DeviceType.CPU)
    lo, hi = stretch.time_range.start, stretch.time_range.end
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith("bench.")]
    merged = merge([(e.time_range.start, e.time_range.end) for e in device])
    inside = _clip(merged, lo, hi)
    busy_us = sum(e - s for s, e in inside)

    ops: Dict[str, float] = defaultdict(float)
    for e in device:
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t > s:
            ops[short_name(e.name)] += (t - s) / 1e6

    # each call's device time: the kernel time inside its range's device-side
    # annotation (the kernel launched through ctypes is not linked to its CPU range)
    starts = [s for s, _ in merged]
    calls: Dict[str, float] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name.startswith(("bench.paged#", "bench.flash#")):
            s, t = e.time_range.start, e.time_range.end
            k = max(bisect.bisect_right(starts, s) - 1, 0)
            calls[e.name] = sum(max(0.0, min(b, t) - max(a, s))
                                for a, b in merged[k:bisect.bisect_left(starts, t)]) / 1e6

    edges = [lo] + [x for iv in inside for x in iv] + [hi]  # busy intervals' ends, framed by the stretch
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    cpu = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU and e.thread == stretch.thread),
                 key=lambda c: (c[0], -c[1]))  # a range before the ranges it holds
    idle = _gap_labels(cpu, gaps)
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6, "calls": calls,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}


def roofline_share(least: Dict[str, float], device: Dict[str, float]):
    """The profiled calls' least times over their device times, in %, over
    the calls the trace timed; None where it timed none."""
    names = [n for n in least if device.get(n, 0.0) > 0.0]
    secs = sum(device[n] for n in names)
    return 100.0 * sum(least[n] for n in names) / secs if secs else None


def idle_share(obs):
    """The share of the profiled stretch in which no kernel or copy ran, in %."""
    if obs.trace is None or not obs.trace["window_s"]:
        return None
    return 100.0 * (1.0 - obs.trace["busy_s"] / obs.trace["window_s"])
