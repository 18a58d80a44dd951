"""Drives ``ServingEngine`` through ``submit`` and ``step``, as a user of the
engine would, and records what the metrics read.

Time is the host's clock. The window opens at the first step that starts
once the warm-up (open loop) or the ramp (closed loop) is over, and closes
at the end of the last step that started before ``open + seconds``: every
token and every second of those steps counts. Each step's decoded rows are
``step()``'s return; the requests it admitted are its rows less those still
running from the step before (each admitted request is decoded in the step
that admits it, and emits its first token there too).

With ``trace`` a :class:`Probe` times each ``Model.prefill`` and
``Model.decode_step`` the engine calls (synchronised host clock), labels
each call of ``ops.paged_attention`` and ``ops.flash_attention`` with its
work for the profiler, and reads the page allocator before each step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from h100bench import trace as trace_mod
from h100bench import work
from h100bench.peaks import BF16_FLOPS, HBM_BYTES
from h100bench.traffic import Item

TRACE_STEPS = 32  # engine steps the profiler covers, from 30% into the window


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    rows: int  # step()'s return: rows decoded
    completed: int  # completions this step produced


@dataclasses.dataclass
class Req:
    item: Item
    submit: float
    due: Optional[float] = None  # absolute, open loop
    tokens: Optional[List[int]] = None
    first: Optional[float] = None  # time of the first token
    end: Optional[float] = None  # time of completion
    latency_s: Optional[float] = None  # the engine's first token to completion


@dataclasses.dataclass
class Obs:
    """What a run observed; every metric reader takes one."""

    model: dict
    loop: str
    open_t: float
    close_t: float  # nominal: open + seconds
    steps: List[Step]
    reqs: Dict[int, Req]
    setup_s: float = 0.0
    probe: Optional["Probe"] = None
    trace: Optional[dict] = None

    def window_steps(self) -> List[int]:
        return [i for i, s in enumerate(self.steps) if self.open_t <= s.t0 < self.close_t]

    def window_span(self):
        idx = self.window_steps()
        return self.steps[idx[0]].t0, self.steps[idx[-1]].t1

    def admitted(self, i: int) -> int:
        prev = self.steps[i - 1] if i else Step(0, 0, 0, 0)
        return self.steps[i].rows - (prev.rows - prev.completed)


class Probe:
    """Per-layer instruments of a traced run (module docstring)."""

    def __init__(self, engine, model: dict):
        from repro_torch.kernels import ops

        self.engine, self.model, self.ops = engine, model, ops
        self.T = engine.cfg.kv_page_tokens
        self.prefills: List[tuple] = []  # (t0, t1, needed flops, real tokens, profiled)
        self.decodes: List[tuple] = []  # (t0, t1, flops, profiled)
        self.paged: Dict[str, float] = {}  # range name -> least seconds
        self.flash: Dict[str, float] = {}
        self.pages_free: List[tuple] = []  # (t, free pages) before each step
        self.shared_pages: List[tuple] = []  # (t, the allocator's shared-page count)
        self.seen = set()  # full-page prefixes prefilled so far
        self.profiling = False
        self._contexts: List[int] = []
        self._prompt_len = 0  # real tokens of the prompt being prefilled (no padding)
        inner = engine.model
        self._inner_ops = (ops.paged_attention, ops.flash_attention)
        engine.model = dataclasses.replace(inner, prefill=self._wrap_prefill(inner.prefill),
                                           decode_step=self._wrap_decode(inner.decode_step))
        ops.paged_attention, ops.flash_attention = self._paged, self._flash

    def close(self) -> None:
        """Put the ops back; the allocator's state at the end closes its series."""
        self.ops.paged_attention, self.ops.flash_attention = self._inner_ops
        self.before_step(time.perf_counter())

    def _label(self, name: str):
        return record_function(name) if self.profiling else contextlib.nullcontext()

    def _sync(self):
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def before_step(self, t: float) -> None:
        alloc = self.engine.alloc
        if alloc is not None:
            self.pages_free.append((t, alloc.free_pages))
            self.shared_pages.append((t, alloc.stats["shared"]))

    def _prefix(self, toks: List[int]) -> int:
        """Tokens of ``toks`` in full pages that an earlier prompt began with."""
        T, key, first_miss = self.T, (), None
        for p in range(len(toks) // T):
            key = hash((key, tuple(toks[p * T:(p + 1) * T])))
            if first_miss is None and key not in self.seen:
                first_miss = p
            self.seen.add(key)
        hit = len(toks) // T if first_miss is None else first_miss
        return hit * T

    def _wrap_prefill(self, fn):
        def prefill(params, inputs, *a, **kw):
            flops, real = 0, 0
            for row in inputs.tolist():
                n = len(row)
                while n and row[n - 1] == 0:  # the engine pads with id 0; prompts never hold it
                    n -= 1
                start = min(self._prefix(row[:n]), n - 1)
                self._prompt_len = n
                flops += work.prefill_flops(self.model, start, n)
                real += n
            self._sync()
            t0 = time.perf_counter()
            with self._label("bench.prefill"):
                out = fn(params, inputs, *a, **kw)
                self._sync()
            self.prefills.append((t0, time.perf_counter(), flops, real, self.profiling))
            return out
        return prefill

    def _wrap_decode(self, fn):
        def decode_step(params, cache, tokens, *a, **kw):
            self._contexts = [n + 1 for n in cache["lengths"].tolist() if n > 0]
            flops = work.decode_flops(self.model, self._contexts)
            self._sync()
            t0 = time.perf_counter()
            with self._label("bench.decode"):
                out = fn(params, cache, tokens, *a, **kw)
                self._sync()
            self.decodes.append((t0, time.perf_counter(), flops, self.profiling))
            return out
        return decode_step

    def _paged(self, *a, **kw):
        if not self.profiling:
            return self._inner_ops[0](*a, **kw)
        name = f"bench.paged#{len(self.paged)}"
        self.paged[name] = work.paged_bytes(self.model, self._contexts) / HBM_BYTES
        with record_function(name):
            return self._inner_ops[0](*a, **kw)

    def _flash(self, q, k, v, *a, **kw):
        if not self.profiling:
            return self._inner_ops[1](q, k, v, *a, **kw)
        name = f"bench.flash#{len(self.flash)}"
        n = self._prompt_len
        q0 = kw.get("q_start", 0)
        lo, hi = q0, min(q0 + q.shape[1], n)
        flops, nbytes = work.flash_work(self.model, lo, hi) if hi > lo else (0, 0)
        self.flash[name] = q.shape[0] * max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
        with record_function(name):
            return self._inner_ops[1](q, k, v, *a, **kw)


def _completions(engine, reqs: Dict[int, Req], seen: set, now: float) -> int:
    """Record the completions not seen before; returns how many."""
    fresh = [c for rid, c in engine.run_until_drained(max_steps=0).items() if rid not in seen and rid in reqs]
    for c in fresh:
        seen.add(c.request_id)
        r = reqs[c.request_id]
        r.tokens, r.latency_s = list(c.tokens), c.latency_s
        r.first = r.submit + c.ttft_s
        r.end = now
    return len(fresh)


def run(engine, items: List[Item], traffic: dict, seconds: float, model: dict, *,
        trace: bool = False, t_process: float = 0.0) -> Obs:
    """Serve ``items`` as the traffic file says, for a window of ``seconds``."""
    from repro_torch.serving.engine import Request

    probe = Probe(engine, model) if trace else None
    gpu = [ProfilerActivity.CUDA] if engine.device.type == "cuda" else []
    if trace:  # the profiler's first start (CUPTI's set-up) takes seconds: pay it before the window
        with profile(activities=[ProfilerActivity.CPU, *gpu]):
            torch.ones(1, device=engine.device).add_(1)
            probe._sync()
    reqs: Dict[int, Req] = {}
    seen: set = set()
    steps: List[Step] = []
    closed = traffic["loop"] == "closed"
    start = time.perf_counter()
    lead = traffic["ramp_s"] if closed else traffic["warmup_s"]
    obs = Obs(model, traffic["loop"], start + lead, start + lead + seconds, steps, reqs, probe=probe)
    pending = iter(items)
    clients = traffic.get("clients", 0)
    joins = [start + i * traffic.get("stagger_s", 0.0) / max(clients, 1) for i in range(clients)]
    prof, trace_at, traced = None, None, 0

    def submit(item: Item, due: Optional[float] = None):
        t = time.perf_counter()
        reqs[item.rid] = Req(item, t, due)
        engine.submit(Request(item.rid, item.prompt, max_new_tokens=item.max_new))

    def step() -> Step:
        if probe:
            probe.before_step(time.perf_counter())
        t0 = time.perf_counter()
        rows = engine.step()
        t1 = time.perf_counter()
        s = Step(t0, t1, rows, _completions(engine, reqs, seen, t1))
        steps.append(s)
        return s

    nxt = next(pending, None)
    joined = 0
    while True:
        now = time.perf_counter()
        if now >= obs.close_t:
            break
        if obs.setup_s == 0.0 and now >= obs.open_t:
            obs.setup_s = now - t_process
            trace_at = obs.open_t + 0.3 * seconds if trace else None
        if closed:
            while joined < clients and joins[joined] <= now:
                submit(nxt)
                nxt, joined = next(pending), joined + 1
        else:
            while nxt is not None and start + nxt.due <= now:
                submit(nxt, start + nxt.due)
                nxt = next(pending, None)
        if trace_at is not None and prof is None and now >= trace_at:
            prof = profile(activities=[ProfilerActivity.CPU, *gpu])
            prof.__enter__()
            probe.profiling = True
            stretch = record_function("bench.stretch")
            probe._sync()
            stretch.__enter__()
        s = step()
        if prof is not None and probe.profiling:
            traced += 1
            if traced == TRACE_STEPS:
                probe._sync()
                stretch.__exit__(None, None, None)
                probe.profiling = False
                prof.__exit__(None, None, None)
        if closed:
            for _ in range(s.completed):
                submit(nxt)
                nxt = next(pending)
        elif s.rows == 0 and nxt is not None:
            time.sleep(max(0.0, min(start + nxt.due, obs.close_t) - time.perf_counter()))
    if prof is not None and probe.profiling:
        probe._sync()
        stretch.__exit__(None, None, None)
        probe.profiling = False
        prof.__exit__(None, None, None)
    if not closed:  # every request admitted by the close completes within its longest answer's steps
        for _ in range(traffic["output"]["max"] + 1):
            if not step().rows:
                break
    if probe:
        probe.close()
        obs.trace = trace_mod.summarize(prof) if prof is not None else None
    return obs
