#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a card and ``nvcc``. It
imports only ``torch``, ``numpy`` and ``src/repro_torch`` (never JAX or the
JAX package), and it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and
   prints ptxas's register, shared-memory and spill counts for each;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it plus edge cases (inactive sentinel rows,
   a ring ``page_pos``, a sliding window, rows of up to 4096 tokens, ragged
   and offset prompts, other head dims), and times the kernel, the plain
   version and, where one exists, the single PyTorch call that computes the
   same function, and the kernels under other launch plans (the paged
   kernel's split count, the flash kernel's heads per CTA);
4. serves 16 requests (a shared 128-token system prompt plus a 64-token tail
   each, 32 new tokens) through full-width ``llama3_2-1b`` (16 layers,
   d_model 2048, vocab 128256; random weights from seed 0) with 8 slots and
   512 pages of 64 tokens (the cell of ``repro_torch.launch.profile_serve``),
   counting every kernel launch; then compares the logits of one of the
   engine's own batched decode steps, captured mid-run, and of one prefill
   and one decode step with the ``impl="ref"`` oracles;
5. blob mode, on one ``Cluster`` with one ``BlobKVStore`` of 512 pages of
   2 MiB (one llama3_2-1b KV page: 2 x 16 layers x 64 tokens x 8 kv heads x
   64 x 2 bytes): engine A (its own client and device pool) serves the same
   16 requests and must decode the tokens of step 4; engine B (another
   client and device pool on the same store) serves 16 new tails behind the
   same system prompt with 80 new tokens each, must take the system
   prompt's pages from the cluster directory (fetching A's published
   pages) and publish each row's fourth page as it fills, and must decode
   the tokens of a host-allocator engine serving the same requests. It
   prints each engine's tok/s and TTFT, the pages published and fetched,
   the store's, clients' and cluster's counters, the host time of each
   client call and the time of one page's device-to-host and host-to-device
   copies;
6. prints a JSON line with each kernel's launches, error, times and grid at
   the main-path shape, and, as the last line, ``{"ok": true, "device": {...}}``.

Any failure exits nonzero before the last line is printed.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# one H100 SXM at its full 700 W (NVIDIA's data sheet): device memory rate
# and dense bf16 tensor-core rate, for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TOL = {"paged_attention": 3e-2, "flash_attention": 2e-2}  # bf16, tests/test_kernels.py
LOGITS_TOL = 3e-2  # max |kernel - ref| logits over max |ref logits|, bf16 over 16 layers


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


SPIN_CYCLES = 10_000_000  # about 5 ms at the H100's 1.98 GHz clock
MAX_SPIN_CYCLES = 32 * SPIN_CYCLES


def time_ms(fn, iters: int = 50, flush: torch.Tensor = None) -> float:
    """Mean device time of one call, from CUDA events around it. Each call
    is timed alone behind a device-side spin, which keeps the card busy
    while the host issues the events and the call, so host dispatch stays
    out of the reading. A sample counts only if the host had issued the
    whole call before the spin ended on the card (host issue time under the
    spin's device time); a sample that a host stall outlasted is dropped and
    taken again behind a spin twice as long. With ``flush``, the L2 cache is
    overwritten first."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    cycles, samples, dropped = SPIN_CYCLES, [], 0
    while len(samples) < iters:
        if flush is not None:
            flush.zero_()
        t0 = time.perf_counter()
        spun.record()  # reached on the card no earlier than t0
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if issue_ms < spun.elapsed_time(start):
            samples.append(start.elapsed_time(end))
            continue
        dropped += 1
        check(dropped <= iters, f"{dropped} samples outlasted by host issue ({issue_ms:.2f} ms), "
              f"spin now {cycles} cycles")
        cycles = min(2 * cycles, MAX_SPIN_CYCLES)
    if dropped:
        print(f"  (timer: {dropped} samples dropped for a host stall, spin raised to {cycles} cycles)",
              flush=True)
    return sum(samples) / iters


# ------------------------------ paged decode ------------------------------
def paged_case(gen, *, B=8, H=32, K=8, D=64, T=64, R=32, P=512, lengths, window=None, ring=None):
    """Inputs shaped as the engine gives them: each row's pages are distinct
    random pool pages, the rest of its table is the sentinel P; a length-0
    row is inactive (all sentinel). With ``ring`` pages, page_pos is the
    sliding-window ring layout (page r holds the newest block j = r mod R)."""
    dev = gen.device
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    pool_k = torch.randn((P, T, K, D), generator=gen, device=dev).to(torch.bfloat16)
    pool_v = torch.randn((P, T, K, D), generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(P, generator=gen, device=dev).cpu().numpy()
    tables = np.full((B, R), P, np.int32)
    page_pos = np.zeros((B, R), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        if n == 0:
            continue
        n_pages = min(R, n // T + 1) if ring is None else ring
        tables[b, :n_pages] = perm[used:used + n_pages]
        used += n_pages
        if ring is None:
            page_pos[b] = np.arange(R) * T
        else:
            last = (n - 1) // T
            for r in range(ring):
                j = last - ((last - r) % ring)
                page_pos[b, r] = j * T
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (q, pool_k, pool_v, to(tables), to(page_pos),
            torch.tensor(lengths, dtype=torch.int32, device=dev)), window


def paged_work(args, window):
    """Bytes and flops the function needs for these inputs: the K and V rows
    of each valid token read once for every kv-head (the (P, T, K, D) layout
    lets a reader fetch only those rows), q and the tables read once, o/m/l
    written once; 4 flops per (query head, valid token, dim)."""
    q, pool_k, _, tables, page_pos, lengths = args
    B, H, D = q.shape
    P, T, K, _ = pool_k.shape
    tables, page_pos, lengths = (t.cpu().numpy() for t in (tables, page_pos, lengths))
    tokens = 0
    for b in range(B):
        lo = max(0, lengths[b] - window) if window else 0
        for pid, base in zip(tables[b], page_pos[b]):
            if 0 <= pid < P:
                tokens += max(0, min(base + T, lengths[b]) - max(base, lo))
    nbytes = (q.numel() * q.element_size() + 2 * tokens * K * D * pool_k.element_size()
              + (tables.size + page_pos.size + lengths.size) * 4 + B * H * (D + 2) * 4)
    flops = 4 * tokens * H * D
    return nbytes, flops


def check_paged(args, window, name):
    from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain

    o, m, l = paged_attention_cuda(*args, window=window)
    po, pm, pl = paged_attention_plain(*args, window=window)
    torch.cuda.synchronize()
    for t in (o, m, l):
        check(bool(torch.isfinite(t).all()), f"paged {name}: non-finite output")
    lengths = args[5]
    dead = lengths == 0
    if dead.any():
        check(bool((o[dead] == 0).all() and (l[dead] == 0).all() and (m[dead] == -1e30).all()),
              f"paged {name}: an inactive row is not o=0, l=0, m=-1e30")
    live = ~dead
    err = (o[live] / l[live][..., None] - po[live] / pl[live][..., None]).abs().max().item()
    stat_err = max((m[live] - pm[live]).abs().max().item(),
                   ((l[live] - pl[live]).abs() / pl[live]).max().item())
    print(f"  paged_attention {name}: max abs err {err:.3e} (tol {TOL['paged_attention']}), "
          f"m/l err {stat_err:.3e}", flush=True)
    check(err <= TOL["paged_attention"] and stat_err <= 1e-3, f"paged {name} disagrees with plain")
    return err


# ------------------------------ flash prefill ------------------------------
def flash_case(gen, *, B=1, Sq=192, Sk=192, H=32, K=8, D=64, causal=True, window=None, q_start=0):
    dev = gen.device
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Sk, K, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Sk, K, D), generator=gen, device=dev).to(torch.bfloat16)
    return (q, k, v), dict(causal=causal, window=window, q_start=q_start)


def flash_work(args, kw):
    q, k, _ = args
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qpos = kw["q_start"] + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if kw["causal"]:
        mask &= kpos <= qpos
    if kw["window"]:
        mask &= kpos > qpos - kw["window"]
    nbytes = sum(t.numel() * t.element_size() for t in args) + q.numel() * q.element_size()
    return nbytes, 4 * B * H * D * int(mask.sum())


def check_flash(args, kw, name):
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    got = flash_attention_cuda(*args, **kw)
    want = flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    print(f"  flash_attention {name}: max abs err {err:.3e} (tol {TOL['flash_attention']})", flush=True)
    check(err <= TOL["flash_attention"], f"flash {name} disagrees with plain")
    return err


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------ launch sweep ------------------------------
MAIN_LENGTHS = [193, 200, 0, 210, 224, 196, 0, 208]  # the engine mid-decode, 2 slots idle
LONG_LENGTHS = [4096, 4000, 3900, 4096, 3500, 4096, 3000, 4096]


def sweep(gen, flush) -> None:
    """Time the kernels under launch plans other than the wrappers' own, at
    the main-path shapes (and paged rows of up to 4096 tokens): the paged
    kernel's split count S, the flash kernel's query heads per CTA. Each
    plan is checked against the plain version first; these launches go
    around the wrappers and are not counted."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    n_sm = torch.cuda.get_device_properties(gen.device).multi_processor_count
    for tag, lengths, R in (("main", MAIN_LENGTHS, 32), ("long", LONG_LENGTHS, 64)):
        args, window = paged_case(gen, R=R, lengths=lengths)
        q, pool_k, _, tables, _, lengths_t = args
        shape = (q.shape[0], q.shape[1], pool_k.shape[2], q.shape[2], tables.shape[1], n_sm)
        po, _, pl = pa.paged_attention_plain(*args, window=window)
        live = lengths_t > 0
        for S in (1, 2, 3, 4, 5, 8):
            plan = pa.launch_plan(*shape, n_splits=S)
            o, _, l = pa.launch(*args, window, 0, plan)
            err = (o[live] / l[live][..., None] - po[live] / pl[live][..., None]).abs().max().item()
            check(err <= TOL["paged_attention"], f"paged S={S} disagrees with plain ({err})")
            ms = time_ms(lambda: pa.launch(*args, window, 0, plan), flush=flush)
            mark = " (the wrapper's plan)" if S == pa.launch_plan(*shape).n_splits else ""
            print(f"  sweep paged_attention {tag}: S={S}, {int(np.prod(plan.grid))} CTAs: "
                  f"{ms:.4f} ms{mark}", flush=True)
    (q, k, v), kw = flash_case(gen)
    want = fa.flash_attention_plain(q, k, v, **kw)
    shape = (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], q.dtype)
    for hp in (1, 2, 4):
        plan = fa.launch_plan(*shape, heads_per_cta=hp)
        err = (fa.launch(q, k, v, kw["causal"], kw["window"], kw["q_start"], plan).float()
               - want.float()).abs().max().item()
        check(err <= TOL["flash_attention"], f"flash {hp} heads per CTA disagrees with plain ({err})")
        ms = time_ms(lambda: fa.launch(q, k, v, kw["causal"], kw["window"], kw["q_start"], plan))
        mark = " (the wrapper's plan)" if hp == fa.launch_plan(*shape).heads_per_cta else ""
        print(f"  sweep flash_attention: {hp} heads per CTA, {int(np.prod(plan.grid))} CTAs: "
              f"{ms:.4f} ms{mark}", flush=True)


# ------------------------------ engine ------------------------------
CAPTURE_STEP = 40  # a decode step of the second wave of 8 requests


def capture_decode(engine, step: int) -> dict:
    """Wrap ``engine._decode`` so that its ``step``-th call also keeps its
    inputs and logits. The pages the step reads are gathered into a compact
    pool (tables renumbered, the sentinel still out of range) so that the
    copy is tens of MB, not the whole pool; the call itself runs unchanged."""
    captured, calls, decode = {}, [0], engine._decode

    def run(tables, page_pos, lengths, tokens):
        calls[0] += 1
        if calls[0] != step:
            return decode(tables, page_pos, lengths, tokens)
        used = np.unique(tables[tables < engine.n_pool_pages])
        remap = np.full(engine.n_pool_pages + 1, len(used), np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        idx = torch.from_numpy(used).long().to(engine.device)
        pools = {n: getattr(engine, n).index_select(1, idx) for n in ("pool_k", "pool_v")}
        logits = decode(tables, page_pos, lengths, tokens)
        L, dev = engine.pool_k.shape[0], engine.device
        t, pp = (torch.from_numpy(a).to(dev).expand(L, *a.shape) for a in (remap[tables], page_pos))
        captured.update(
            cache={"kv": dict(pools, tables=t, page_pos=pp), "lengths": torch.from_numpy(lengths).to(dev)},
            tokens=torch.from_numpy(tokens).to(dev), logits=logits.clone(),
            live=torch.from_numpy(lengths > 0).to(dev))
        return logits

    engine._decode = run
    return captured


# ------------------------------ main ------------------------------
def record_logits(engine) -> dict:
    """Wrap ``engine._decode`` so that each live row's logits of every
    batched step stay on the card, keyed by (request id, index of the token
    they choose); read only when two runs' tokens differ."""
    rec, decode = {}, engine._decode

    def run(*args):
        logits = decode(*args)
        for i, st in enumerate(engine._slots):
            if st is not None:
                rec[(st["req"].request_id, len(st["generated"]))] = logits[i]
        return logits

    engine._decode = run
    return rec


def check_same_tokens(what, got, want, rec_got, rec_want, rids) -> None:
    """Fail at the first request whose greedy tokens differ, with the step
    and the logits there: the two runs' largest logit difference and each
    run's margin between the two tokens chosen."""
    for rid in rids:
        a, b = got[rid].tokens, want[rid].tokens
        if a == b:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        gap = "no decode logits (the prefill's token, or a length mismatch)"
        if (rid, k) in rec_got and (rid, k) in rec_want and k < min(len(a), len(b)):
            la, lb = rec_got[(rid, k)].float(), rec_want[(rid, k)].float()
            gap = (f"max |logits difference| {(la - lb).abs().max().item():.4e}; margin "
                   f"{(la[a[k]] - la[b[k]]).item():.4e} in {what}, {(lb[b[k]] - lb[a[k]]).item():.4e} "
                   f"in its reference")
        fail(f"{what}: request {rid} diverges at token {k} ({a[k:k + 4]} vs {b[k:k + 4]}): {gap}")


def timed_calls(client, names) -> dict:
    """Wrap ``client``'s methods ``names`` to keep each call's host time (and,
    for ``publish_prompt``/``fetch_pages``, the versions written or read)."""
    calls = {name: [] for name in names}
    for name in names:
        fn = getattr(client, name)

        def run(*args, _fn=fn, _name=name):
            t0 = time.perf_counter()
            out = _fn(*args)
            seconds = time.perf_counter() - t0
            if _name == "fetch_pages":
                calls[_name].append((seconds, [a.version for a in args[0]]))
            elif _name == "publish_prompt":
                calls[_name].append((seconds, list(out)))
            else:
                calls[_name].append((seconds, None))
            return out

        setattr(client, name, run)
    return calls


def traffic(cluster) -> dict:
    """The cluster's traffic counters: bytes written to and read from the
    data providers, RPCs, rounds and shared-cache hits."""
    st = cluster.stats
    return {"bytes_written": sum(st.write_bytes_snapshot().values()),
            "bytes_read": sum(st.read_bytes_snapshot().values()),
            **{k: getattr(st, k) for k in ("rpcs", "aggregated_rpcs", "data_rounds", "metadata_rounds",
                                           "cache_hits", "cache_misses")}}


def host_ms(fn, dev, iters: int = 20) -> tuple:
    """Median and least host time of ``fn`` (ending in a synchronisation)."""
    fn()
    samples = []
    for _ in range(iters):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples), min(samples)


def serve_burst(engine, requests) -> tuple:
    """Submit ``requests`` at once and drain: completions, wall seconds."""
    t0 = time.perf_counter()
    for r in requests:
        engine.submit(r)
    done = engine.run_until_drained()
    torch.cuda.synchronize(engine.device)
    return {r.request_id: done[r.request_id] for r in requests}, time.perf_counter() - t0


def engine_line(name, done, wall) -> str:
    n_tokens = sum(len(c.tokens) for c in done.values())
    ttft = sorted(c.ttft_s for c in done.values())
    return (f"{name}: {len(done)} requests, {n_tokens} tokens in {wall:.3f} s = {n_tokens / wall:.1f} tok/s; "
            f"TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms, max {ttft[-1] * 1e3:.1f} ms")


BLOB_CALLS = ("publish_prompt", "fetch_pages", "publish_page_async", "drain_publishes")


def blob_phase(cfg, host, host_done, host_rec, card, kernels) -> dict:
    """Step 5: blob mode at full width. ``host`` is step 4's engine (its
    completions ``host_done``, its logits ``host_rec``); it also serves B's
    requests as B's reference, outside the counted run. Returns the kernel
    launches of engines A and B."""
    from repro_torch.core import Cluster
    from repro_torch.launch.profile_serve import PAGES, SLOTS, cell_requests, warm_up
    from repro_torch.serving import BlobKVClient, BlobKVStore, ServingEngine
    from repro_torch.serving.engine import load_page, pack_page

    dev = host.device
    bursts = cell_requests(cfg, bursts=2)
    reqs_a = bursts[:16]
    reqs_b = [dataclasses.replace(r, max_new_tokens=80) for r in bursts[16:]]
    cluster = Cluster(n_data_providers=2, n_metadata_providers=2)
    try:
        store = BlobKVStore.for_kv(cluster, n_pages=PAGES, page_tokens=cfg.kv_page_tokens,
                                   n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                                   head_dim=cfg.head_dim, dtype=np.uint16)  # bf16 pages
        check(store.page_size == 2 ** 21, f"blob page of {store.page_size} bytes, expected 2 MiB")
        engines, calls, recs = {}, {}, {}
        for name in ("A", "B"):
            client = BlobKVClient(store)
            engines[name] = ServingEngine(cfg, host.params, max_slots=SLOTS, device=dev, kv_client=client)
            check(engines[name].pool_k.dtype == torch.bfloat16, "blob engine pool is not bf16")
            recs[name] = record_logits(engines[name])
        warm_up(engines["A"])  # the blob path's first calls (thread pools) too
        for name in ("A", "B"):
            calls[name] = timed_calls(engines[name].kv, BLOB_CALLS)
        store0, traffic0 = dict(store.stats), traffic(cluster)
        client0 = {name: dict(e.kv.stats) for name, e in engines.items()}
        for k in kernels:
            k.launches = 0
        done_a, wall_a = serve_burst(engines["A"], reqs_a)
        hits_a = store.stats["prefix_hits"]
        done_b, wall_b = serve_burst(engines["B"], reqs_b)
        launches = {k.__name__.removesuffix("_cuda"): k.launches for k in kernels}
        check(all(n > 0 for n in launches.values()), f"a kernel never ran in blob mode: {launches}")

        # B's reference: the host-allocator engine on the same requests
        done_ref, _ = serve_burst(host, reqs_b)
        check_same_tokens("blob engine A", done_a, host_done, recs["A"], host_rec, range(16))
        check_same_tokens("blob engine B", done_b, done_ref, recs["B"], host_rec, [r.request_id for r in reqs_b])
        for c in list(done_a.values()) + list(done_b.values()):
            check(all(0 <= t < cfg.vocab_size for t in c.tokens), f"request {c.request_id}: bad tokens")
        skipped = sorted({c.prefill_skipped_tokens for c in done_b.values()})
        check(skipped == [128], f"engine B skipped {skipped} prompt tokens, expected 128 for each request")
        check(store.stats["prefix_hits"] - hits_a >= 32, f"engine B took too few directory pages: {store.stats}")
        published_a = {v for _, versions in calls["A"]["publish_prompt"] for v in versions}
        fetched_b = [versions for _, versions in calls["B"]["fetch_pages"]]
        check(any(len(v) == 2 and set(v) <= published_a for v in fetched_b),
              f"engine B never fetched two of A's published pages: {fetched_b}")
        check(len(calls["B"]["publish_page_async"]) == 16 and not calls["A"]["publish_page_async"],
              f"decode-page publishes A {len(calls['A']['publish_page_async'])}, "
              f"B {len(calls['B']['publish_page_async'])}, expected 0 and 16")

        print(f"blob mode on {card}: store of {store.n_pages} pages of {store.page_size} bytes", flush=True)
        for name, done, wall in (("A", done_a, wall_a), ("B", done_b, wall_b)):
            c, kv = calls[name], engines[name].kv
            stats = {k: kv.stats[k] - client0[name][k] for k in kv.stats}
            print(f"  {engine_line('engine ' + name, done, wall)}; pages published {stats['published_pages']} "
                  f"({len(c['publish_page_async'])} of them decode pages), fetched "
                  f"{sum(len(v) for _, v in c['fetch_pages'])} in {len(c['fetch_pages'])} calls; "
                  f"client stats {stats}", flush=True)
            for call in BLOB_CALLS:
                ms = [sec * 1e3 for sec, _ in c[call]]
                print(f"    host time per {call}: {len(ms)} calls" + (
                      f", median {statistics.median(ms):.3f} ms, max {max(ms):.3f} ms, "
                      f"total {sum(ms):.1f} ms" if ms else ""), flush=True)
        store_delta = {k: store.stats[k] - store0[k] for k in store0}
        moved = {k: v - traffic0[k] for k, v in traffic(cluster).items()}
        print(f"  store stats over A and B {store_delta}; cluster traffic {moved}", flush=True)

        # one page across the host boundary, on engine B's pools
        b = engines["B"]
        sid = next(iter(b._resident))
        page = pack_page(b.pool_k[:, sid], b.pool_v[:, sid], store.page_size)
        raw = torch.from_numpy(page).to(dev)
        host_buf = np.empty_like(page)
        times = {
            "pack_page (device gather + device-to-host copy into a fresh buffer)":
                host_ms(lambda: pack_page(b.pool_k[:, sid], b.pool_v[:, sid], store.page_size), dev),
            "device-to-host copy alone": host_ms(lambda: torch.from_numpy(host_buf).copy_(raw), dev),
            "load_page (host-to-device copy + scatter into both pools)":
                host_ms(lambda: load_page(b.pool_k, b.pool_v, sid, page), dev),
            "host-to-device copy alone": host_ms(lambda: raw.copy_(torch.from_numpy(page)), dev),
        }
        check(np.array_equal(pack_page(b.pool_k[:, sid], b.pool_v[:, sid], store.page_size), page),
              "a page does not survive pack_page -> load_page")
        for what, (med, least) in times.items():
            print(f"  one 2 MiB page, {what}: median {med:.3f} ms, least {least:.3f} ms (host clock, "
                  f"synchronised)", flush=True)
        return launches
    finally:
        cluster.close()


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
        from repro_torch.kernels.flash_attention import launch_plan as flash_launch_plan
        from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain
        from repro_torch.kernels.paged_attention import launch_plan as paged_launch_plan
        from repro_torch.launch.profile_serve import PAGES, SLOTS, cell_requests, warm_up
        from repro_torch.models.lm import build_model
        from repro_torch.serving.engine import ServingEngine
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32 (the unembedding)
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {built or 'up to date'} in {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = {name: _build.ptxas_report(name) for name in ("paged_attention", "flash_attention")}
    for name, entries in ptxas.items():
        check(bool(entries) and all(e["registers"] is not None for e in entries),
              f"no ptxas report for {name}")
    print(json.dumps({"ptxas": ptxas}), flush=True)

    # 3. kernels vs plain on the card
    print("kernels vs plain:", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    paged_main = paged_case(gen, lengths=MAIN_LENGTHS)
    errs = {"paged_attention": check_paged(*paged_main, "main path shape (B=8, R=32, P=512)")}
    errs["paged_attention"] = max(errs["paged_attention"], check_paged(
        *paged_case(gen, lengths=[300, 0, 129, 64, 1, 512, 77, 191], window=128, ring=3),
        "ring page_pos + window 128"))
    errs["paged_attention"] = max(errs["paged_attention"], check_paged(
        *paged_case(gen, R=64, lengths=[4096, 1, 0, 3000, 2500, 4096, 64, 1000]),
        "long uneven rows (R=64, up to 4096 tokens)"))
    flash_main = flash_case(gen)
    errs["flash_attention"] = check_flash(*flash_main, "main path shape (Sq=Sk=192)")
    for kw, name in ((dict(window=64), "window 64"), (dict(Sq=203, Sk=203), "ragged Sq=Sk=203"),
                     (dict(Sq=64, Sk=192, q_start=128), "q_start 128"),
                     (dict(B=2, Sq=100, Sk=150, causal=False), "non-causal cross Sq != Sk"),
                     (dict(Sq=100, Sk=100, H=4, K=2, D=16, window=48), "head_dim 16, window 48"),
                     (dict(B=2, Sq=200, Sk=200, H=16, K=4, D=128), "head_dim 128")):
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(*flash_case(gen, **kw), name))

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB > 50 MB L2
    p_args, p_win = paged_main
    f_args, f_kw = flash_main
    times = {
        "paged_attention": dict(
            ms=time_ms(lambda: paged_attention_cuda(*p_args, window=p_win), flush=flush),
            plain_ms=time_ms(lambda: paged_attention_plain(*p_args, window=p_win), flush=flush),
            library_ms=None,
        ),
        "flash_attention": dict(
            ms=time_ms(lambda: flash_attention_cuda(*f_args, **f_kw)),
            plain_ms=time_ms(lambda: flash_attention_plain(*f_args, **f_kw)),
        ),
    }
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in f_args)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times["flash_attention"]["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    # yardstick only: SDPA over the same valid tokens laid out densely
    # (gathered beforehand, so not the same inputs as the paged kernel's)
    q, pool_k, pool_v, tables, _, lengths = p_args
    S = int(lengths.max())
    idx = tables.clamp(max=pool_k.shape[0] - 1).long()
    dk = pool_k[idx].flatten(1, 2)[:, :S].transpose(1, 2).contiguous()  # (B, K, S, D)
    dv = pool_v[idx].flatten(1, 2)[:, :S].transpose(1, 2).contiguous()
    dmask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    dq = q[:, :, None, :]
    dense_sdpa_ms = time_ms(lambda: sdpa(dq, dk, dv, attn_mask=dmask, enable_gqa=True), flush=flush)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    q, pool_k, _, tables, _, _ = p_args
    p_plan = paged_launch_plan(q.shape[0], q.shape[1], pool_k.shape[2], q.shape[2], tables.shape[1], n_sm)
    B_, Sq_, H_, D_ = f_args[0].shape
    f_plan = flash_launch_plan(B_, Sq_, H_, f_args[1].shape[2], D_, f_args[0].dtype)
    grids = {"paged_attention": dict(grid=list(p_plan.grid), ctas=int(np.prod(p_plan.grid)),
                                     threads=128, scratch_bytes=p_plan.scratch_bytes),
             "flash_attention": dict(grid=list(f_plan.grid), ctas=int(np.prod(f_plan.grid)),
                                     threads=f_plan.threads, scratch_bytes=0)}
    for name, g in grids.items():
        print(f"  {name} launch at the main-path shape: {g}", flush=True)
    work = {"paged_attention": paged_work(p_args, p_win), "flash_attention": flash_work(f_args, f_kw)}
    for name, (nbytes, flops) in work.items():
        b_ms, b_by = bound_ms(nbytes, flops)
        times[name].update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        print(f"  {name}: kernel {times[name]['ms']:.4f} ms, plain {times[name]['plain_ms']:.4f} ms, "
              f"library {times[name]['library_ms']} ms, bound {b_ms:.5f} ms ({b_by}: "
              f"{nbytes} bytes, {flops} flops)", flush=True)
    print(f"  paged_attention yardstick: SDPA over the dense gathered cache {dense_sdpa_ms:.4f} ms",
          flush=True)
    one = torch.zeros(1, device=dev)
    print(f"  timer floor: one kernel that adds 1 to one element {time_ms(lambda: one.add_(1)):.4f} ms, "
          f"L2 flushed {time_ms(lambda: one.add_(1), flush=flush):.4f} ms", flush=True)
    sweep(gen, flush)
    del flush, dk, dv

    # 4. the engine at full width
    cfg = get_config("llama3_2-1b")
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (16, 2048, 128256), f"unexpected config {cfg}")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    engine = ServingEngine(cfg, params, max_slots=SLOTS, n_pages=PAGES, device="cuda")
    del params  # the engine holds its own serving copy
    torch.cuda.synchronize()
    print(f"engine: llama3_2-1b {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"pool {tuple(engine.pool_k.shape)} x2 {engine.pool_k.dtype}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    warm_up(engine)

    requests = cell_requests(cfg)
    captured = capture_decode(engine, CAPTURE_STEP)
    host_rec = record_logits(engine)
    stats0 = dict(engine.alloc.stats)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    paged_attention_cuda.launches = 0
    t0 = time.perf_counter()
    for r in requests:
        engine.submit(r)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention_cuda.launches,
                "paged_attention": paged_attention_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    done = {k: v for k, v in done.items() if k >= 0}
    check(sorted(done) == list(range(16)), f"completed {sorted(done)}, expected 16 requests")
    for c in done.values():
        check(len(c.tokens) == 32 and all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"request {c.request_id}: bad tokens {c.tokens}")
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on the main path: {launches}")
    stats = {k: engine.alloc.stats[k] - stats0[k] for k in stats0}
    shared = sum(c.prefill_skipped_tokens for c in done.values())
    check(shared > 0 and stats["cow_copies"] > 0, f"no prefix sharing / COW forks: {stats}")
    n_tokens = sum(len(c.tokens) for c in done.values())
    ttft = sorted(c.ttft_s for c in done.values())
    print(f"engine run: {len(done)} requests, {n_tokens} tokens in {wall:.3f} s = "
          f"{n_tokens / wall:.1f} tok/s; TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms, "
          f"max {ttft[-1] * 1e3:.1f} ms (all 16 submitted at once, 8 slots); "
          f"prefix-shared prompt tokens {shared}; allocator {stats}; launches {launches}; "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)

    # the engine's own batched decode step, captured mid-run, against the
    # impl="ref" oracles on the same pages, tables, lengths and tokens
    check(bool(captured), f"decode step {CAPTURE_STEP} was never reached")
    cache, tokens, live = captured["cache"], captured["tokens"], captured["live"]
    want, _ = model.decode_step(engine.params, cache, tokens, impl="ref")
    got, want = captured["logits"][live], want[live]  # an idle slot's logits are never read
    rel_e = (got - want).abs().max().item() / want.abs().max().item()
    print(f"engine decode step {CAPTURE_STEP} ({int(live.sum())} live rows) vs ref: "
          f"max abs err / max |ref| = {rel_e:.3e} (tol {LOGITS_TOL})", flush=True)
    check(bool(torch.isfinite(got).all()) and rel_e <= LOGITS_TOL, "engine decode disagrees with ref")
    del captured, cache

    # the same model through the impl="ref" oracles: one prefill, one decode
    toks = torch.tensor([requests[0].prompt], dtype=torch.long, device=dev)
    lk, ck = model.prefill(engine.params, toks)
    lr, cr = model.prefill(engine.params, toks, impl="ref")
    rel = (lk - lr).abs().max().item() / lr.abs().max().item()
    print(f"prefill logits vs ref: max abs err / max |ref| = {rel:.3e} (tol {LOGITS_TOL})", flush=True)
    check(bool(torch.isfinite(lk).all()) and rel <= LOGITS_TOL, "prefill logits disagree with ref")
    nxt = lk.argmax(-1)
    clone = lambda c: {"kv": {k: v.clone() for k, v in c["kv"].items()}, "lengths": c["lengths"].clone()}  # noqa: E731
    dk_logits, _ = model.decode_step(engine.params, clone(ck), nxt)
    dr_logits, _ = model.decode_step(engine.params, clone(ck), nxt, impl="ref")
    rel_d = (dk_logits - dr_logits).abs().max().item() / dr_logits.abs().max().item()
    print(f"decode logits vs ref: max abs err / max |ref| = {rel_d:.3e} (tol {LOGITS_TOL})", flush=True)
    check(bool(torch.isfinite(dk_logits).all()) and rel_d <= LOGITS_TOL, "decode logits disagree with ref")

    # 5. blob mode
    launches_blob = blob_phase(cfg, engine, done, host_rec, card, (flash_attention_cuda, paged_attention_cuda))
    print(f"blob-mode launches {launches_blob}", flush=True)

    # 6. results
    sources = {"paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:79"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:86")}
    kernels = []
    for name in ("flash_attention", "paged_attention"):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": launches[name], "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "launches_blob": launches_blob[name], **grids[name],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
