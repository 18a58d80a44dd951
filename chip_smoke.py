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
   and offset prompts, head dims 16 to 128 and the padded 80 and 120 in bf16
   and f32, mixtral-8x7b's long windowed decode and prefill shapes, and
   zamba2-2.7b's (MHA, head dim 80) and mistral-large-123b's (96 heads over
   8 kv-heads) decode and prefill shapes, and seamless-m4t-medium's
   non-causal encoder, cross-attention prefill and read-only cross decode
   shapes), and times the kernel, the plain
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
6. serves 8 requests (a shared 64-token prefix plus a 64-token tail each,
   16 new tokens) through ``h2o-danube-3-4b`` at full width and depth (24
   layers, d_model 3840, head dim 120: both kernels at a padded width)
   with 8 slots and 256 pages, and holds a captured engine decode step, one
   prefill and one decode step to the ``impl="ref"`` oracles;
7. serves 8 requests (a shared 4096-token system prompt plus a 64-token
   tail each, 32 new tokens) through ``mixtral-8x7b`` at full width, cut to
   16 of its 32 layers (32 layers of bf16 weights are 93 GB, more than the
   card holds), with 8 slots and 1024 pages of 64 tokens: rows of 4160-4192
   tokens under its 4096-token sliding window. It prints the peak memory of
   the build and of the run, tok/s, TTFT, the median decode step and the
   device time of one decode step beside the expert weights' byte bound;
   holds every attention call of one engine decode step and of one prefill
   (each layer's kernel) to the plain version, and the logits of that step
   and of the prefill to ``impl="ref"`` when no router choice differs
   between the two runs (a flipped choice moves a row's logits by more than
   any kernel error; the flips are counted and printed);
8. drives ``mamba2-370m`` (the ``ssm`` family) at full width and depth,
   nothing cut (48 layers, d_model 1024, 32 SSM heads of 64, state 128),
   through the model API (no engine serves an SSM state): 8 rows of
   2048-token prompts, then 32 greedy decode steps; prints the prefill's
   ms, the median decode step, tok/s, peak memory, the SSM state's bytes,
   the time of the three f32 SSD einsums of one prefill layer and a traced
   decode step; then, in f32 compute, holds a 1984-token prefill plus 64
   teacher-forced decode steps to a 2048-token prefill and one 256-token
   row's prefill logits on the card to the CPU's;
9. drives ``zamba2-2.7b`` (the ``hybrid`` family: 54 Mamba2 layers in 9
   groups of 6, one shared attention block of 32 heads over 32 kv-heads of
   80 after each) at full width and depth, with the same traffic and
   measures, plus the KV pools' bytes; holds each of the 9 attention calls
   of one decode step and of one prefill to the plain version and their
   logits to ``impl="ref"``;
10. drives ``mistral-large-123b`` with int8 KV pools (quantized at prefill,
    each decode step writing int8 K/V and f32 scales; the paged kernel
    reads each layer's pool dequantized to bf16) at full width, cut to 16
    of its 88 layers (88 layers of bf16 weights are 243.6 GB), with the
    same traffic; prints the pools' bytes, the dequantize's time, tok/s,
    the median decode step, peak memory and the logit difference between
    one int8 decode step and the same step over bf16 pools; holds
    ``quantize_token`` on the card to the CPU's bit for bit, and each
    layer's attention call and the logits as step 9 does;
11. drives ``seamless-m4t-medium`` (the ``audio`` encoder-decoder: 12
    encoder and 12 decoder layers, d_model 1024, 16 heads over 16 kv-heads
    of 64, vocab 256206) at full width and depth, nothing cut, through the
    model API (the engine refuses it): 8 rows of 2048 encoder frames and a
    64-token decoder prompt, then 32 greedy decode steps; prints the
    prefill's ms (36 flash calls), the median decode step (24 paged calls:
    12 self, 12 read-only cross), tok/s, peak memory and the pools' bytes;
    checks the cross pools come out of decode unchanged, holds every kernel
    call of a one-row prefill and of a decode step to the plain version and
    their logits to ``impl="ref"``, and an encode-only prefill's eighth
    decode step to ``impl="ref"``;
12. trains, which launches neither kernel (the training attention is
    ``ops.flash_attention``'s ``impl="xla"``, the JAX package's own XLA
    path): (a) ``llama3_2-1b`` at full width and depth, nothing cut (f32
    params, AdamW, bf16 compute, ``grad_accum`` 4, full remat), 2 + 8 steps
    of 8 rows of 2048 tokens that ``TokenPipeline`` reads from the bigram
    corpus in a ``Cluster`` blob; prints the median step, tok/s, peak
    memory, the losses and grad norms, and a traced step's busy share and
    the ms of the f32 unembedding and of the attention einsums; holds one
    microbatch's loss to ``impl="ref"``; (b) one step of each family's smoke
    config on the card against the CPU; (c) the launcher
    (``repro_torch.launch.train``): the loss falls over 30 smoke steps, and
    a run crashed at step 14 and rerun with ``restore`` ends on the
    uninterrupted run's loss; (d) (a)'s whole state (params and moments)
    saved to and restored from a ``BlobCheckpointer`` at 1 MiB pages, bit
    for bit; and checks both kernels' counters read 0 across it;
13. runs the paper's application, which launches neither kernel
    (``repro_torch.launch.supernovae`` at the paper's deployment: 64
    regions of 2048 x 2048 f32, one 16 MiB segment each, so an epoch is the
    1 GiB hot window; 64 KiB pages, 20 data and 20 metadata providers, 8
    detector sessions, 8 epochs): the telescope streams each epoch into the
    versioned blob while the detectors read their regions' windows of each
    frame pair and difference-image them on the card; fails unless every
    detector's hits in every pair equal numpy's ``detect_transients`` on
    the same bytes, region by region, the supernovae found are the ground
    truth less those that ignite in the last epoch, each in the pair after
    it ignites, and the detectors' tensors lay on the card; prints the
    telescope's write ms and MB/s per epoch, each detector's read MB/s and
    the aggregate, the detection latency from publication (p50, max), each
    pair's H2D ms and GB/s and stream ms, one pair's detection replayed
    alone beside its byte bound, the device's busy share (at most), peak
    memory and the store's counters;
14. runs the same application over the paper's deployment of access nodes
    (``federated_sky_phase``): a ``Federation`` of 4 nodes on one substrate
    at the same deployment, pages replicated twice, leases of 50 ms, the
    telescope on node 0 and the 8 detectors round-robin on nodes 0-3, 5
    epochs; when epoch 3 is published node 3 is killed, node 1 partitioned
    from the GC coordinator, one federated GC pass waits out their leases
    and a probe fences node 1; when epoch 4 is published both recover, the
    detectors on them having retried their pins meanwhile; fails unless the
    hits equal numpy's, the supernovae are step 13's, a lease was waited
    out, a fence landed, pages were freed, every node is up, the kept frame
    reads back from another node as the detectors read it, no collected
    version stays cached after a final pass, and neither kernel ran; every
    thread is joined against a deadline, and a wait past it dumps every
    stack and fails; prints the telescope's MB/s per epoch, each node's
    detectors' read MB/s, the GC pass's ms and stall, H2D ms a pair, the
    card's busy share (at most), peak memory and the host's resident
    memory;
15. serves across ranks (``sharded_phase``), the weights in the serving
    layout (every leaf its ``param_shardings`` block: heads, ffn, vocab
    and experts over ``model``, ``embed`` over ``data``): the unsharded
    oracles first, in this process, one cell at a time (prefill of 8 rows,
    32 greedy decode steps, logits and tokens kept on the host, weights
    freed); then four spawned ranks of a ``(data 2, model 2)`` mesh, NCCL
    when the host has a card for each and else gloo with all four on the
    one card (the kernels are built once, in step 2; each rank and
    collective has a deadline). Each rank draws its blocks layer by layer
    (``init(axis_info=)``, the ranks in turn), prefills its 4 of the 8 rows
    (each layer's ``data`` blocks regathered, heads split over ``model``:
    the flash kernel on its local heads, layer 0's call held to the plain
    version), gets one headroom page a row (``add_headroom``), and takes
    32 decode steps fed the oracle's tokens (the paged kernel on its
    stripe, held to the plain version). (a) ``llama3_2-1b`` at full width
    and depth, 2048-token prompts; (b) ``mixtral-8x7b`` cut to 4 layers,
    4160-token prompts, held to the oracle where the router chose alike;
    (c) ``mistral-large-123b`` cut to 16 layers (step 10's depth), int8
    pools; (d) ``zamba2-2.7b`` at full width cut to 2 of its 9 groups (12
    layers), 2048-token prompts, in f32 compute and f32 pools
    (``SHARD_ZAMBA2_COMPUTE``: at full depth in bf16 its logits move by
    more than ``SHARD_LOGITS_TOL`` under any rounding difference), and (d')
    the same model in bf16, the users' dtype, cut to one group (6 layers,
    ``SHARD_ZAMBA2_BF16_LAYERS``), where bf16's spread stays inside the
    tolerance; in both each rank holds the SSM states of its 4 rows only
    (``cache_shardings``: the conv and the scan run on those rows, their
    output regathered over the batch axes before ``out_proj``), the flash
    kernel runs on its 16 local heads and the paged kernel on its stripe.
    Checks: each rank's weights
    are the layout's bytes, and its SSM states the layout's; logits
    bit-equal across the ranks that hold the same rows and within
    ``SHARD_LOGITS_TOL`` of the oracle's; greedy tokens the oracle's but at
    printed near-ties; one flash launch a layer in the prefill and one
    paged launch a layer a step. Prints each rank's weight bytes, its
    prefill arguments beside the dry run's count, its SSM state bytes
    beside the layout's, prefill ms, median
    decode step, time and bytes in the all-reduces, launches, peak memory
    and the card's free memory after the prefill (``mem_get_info``), and
    rank 1's flash kernel, plain version and SDPA on its local heads;
16. trains across ranks (``train_sharded_phase``): the oracles first, in
    this process, then four spawned ranks of a ``(data 2, model 2)`` mesh
    (gloo on the one card), the params and AdamW moments in the JAX
    package's layout (``param_shardings``: FSDP over ``data``, heads, ffn
    and vocab over ``model``), in f32 compute (``TRAIN_SHARD_COMPUTE``).
    (a) ``llama3_2-1b`` at full width and all 16 layers, 2 steps of 4 x
    2048 tokens from ``TokenPipeline`` (grad_accum 4: A = 2, one row a
    rank a microbatch; each rank handed its rows of the batch alone, as the
    JAX package's ``batch_shardings`` lays them), held to the same steps
    unsharded: the losses, the
    first step's gradients and the moments after it, leaf by leaf, and the
    state and batch a rank holds to the byte the dry run's count
    (``dryrun.arguments``); (b) ``mixtral-8x7b`` at full width cut to 1
    layer, capacity factor 4, 4 experts a rank, drawn one rank at a time,
    one step of 2 x 2048 tokens held to the JAX package's sharded rule run
    on one device (each data shard's rows routed alone); in both each
    leaf bit-equal on the ranks that hold the same block after every
    step; (c) ``compressed_pod_mean`` over a ``(pod 2, data 2)`` mesh on
    the leaf shapes of (a)'s model cut to 2 layers with pods that differ:
    each mean within one quantization step of the exact pod mean, each
    residual exactly ``g - q * scale`` rounded once, means bit-equal across
    ranks, 50 error-feedback steps converging; (d) the launcher with
    ``model_parallel=2`` on the smoke config (the JAX layout): the loss
    falls over 30 steps, a crash at step 14 and rerun ends on the
    uninterrupted run's loss, the step-30 checkpoint restored onto ``(data
    4, model 1)`` is the final state bit for bit. Prints each rank's steps,
    the gradient all-reduce's calls, bytes and ms a step, peak memory and
    the card's free memory (``mem_get_info``) after the first step, and
    the step's seconds; checks that neither kernel ran;
17. the dry run (``repro_torch.launch.dryrun``, fake tensors on fake
    ranks, nothing allocated), held to the card in about 40 s: (a) its
    CLI for ``llama3_2-1b`` at ``decode_32k`` and ``train_4k`` on the 16 x
    16 mesh, in subprocesses, printing each rank's memory, FLOPs and
    dominant roofline term; (b) beside them, the dry run of step 12's
    config on one rank for a prefill of 8 x 2048 tokens, one decode step
    over those rows' pages and step 12's training step: the predicted
    argument bytes must equal the bytes the card holds for the same
    params, cache and batch (``memory_allocated``) but for the
    allocator's rounding to 512 bytes a storage; prints the card's peak
    beside the predicted total and max(compute, memory) of the roofline
    over the measured time (the prefill and decode step timed here, both
    kernels launching; the training step from step 12);
18. prints a JSON line with each kernel's launches, error, times and grid at
    the main-path shape (and its times at the danube, mixtral, zamba2,
    mistral-large and seamless shapes, and its launches in steps 5-14, in
    step 15's sharded decode steps, in step 16, each rank's, and in step
    17) and the measures of steps 11-17, and, as the last line, ``{"ok":
    true, "device": {...}}``.

Any failure exits nonzero before the last line is printed.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import gc
import hashlib
import json
import os
import resource
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# one H100 SXM at its full 700 W (NVIDIA's data sheet): device memory rate,
# dense bf16 tensor-core rate and f32 rate outside the tensor cores (TF32 is
# off), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
TOL = {"flash_attention": 2e-2}  # bf16, tests/test_kernels.py
# f32, the same file; the paged kernel's (o, m, l) are f32 whatever the pool's dtype
TOL_F32 = {"paged_attention": 3e-5, "flash_attention": 2e-5}
# bf16 flash output: max |kernel - plain| in a (token, head) row over the
# row's max |plain|. Both sides round an f32 result to bf16, one step of
# which is at most 2^-7 = 7.8e-3 of the row's largest value; the rest of
# the limit covers the f32 differences before rounding.
ROW_TOL = 1e-2
MOE_TOL = 2e-2  # MoE layer in bf16 vs an f32 loop: max |d| over max |f32| per token
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
def paged_case(gen, *, B=8, H=32, K=8, D=64, T=64, R=32, P=512, lengths, window=None, ring=None,
               dtype=torch.bfloat16):
    """Inputs shaped as the engine gives them: each row's pages are distinct
    random pool pages, the rest of its table is the sentinel P; a length-0
    row is inactive (all sentinel). With ``ring`` pages, page_pos is the
    sliding-window ring layout (page r holds the newest block j = r mod R).
    q and the pools in ``dtype``."""
    dev = gen.device
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    pool_k = torch.randn((P, T, K, D), generator=gen, device=dev).to(dtype)
    pool_v = torch.randn((P, T, K, D), generator=gen, device=dev).to(dtype)
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


def paged_work(args, window, page_offset: int = 0):
    """Bytes and flops the function needs for these inputs: the K and V rows
    of each valid token read once for every kv-head (the (P, T, K, D) layout
    lets a reader fetch only those rows), q and the tables read once, o/m/l
    written once; 4 flops per (query head, valid token, dim). A stripe of a
    pool (``page_offset``) counts only its own pages' tokens."""
    q, pool_k, _, tables, page_pos, lengths = args
    B, H, D = q.shape
    P, T, K, _ = pool_k.shape
    tables, page_pos, lengths = (t.cpu().numpy() for t in (tables, page_pos, lengths))
    tokens = 0
    for b in range(B):
        lo = max(0, lengths[b] - window) if window else 0
        for pid, base in zip(tables[b], page_pos[b]):
            if 0 <= pid - page_offset < P:
                tokens += max(0, min(base + T, lengths[b]) - max(base, lo))
    nbytes = (q.numel() * q.element_size() + 2 * tokens * K * D * pool_k.element_size()
              + (tables.size + page_pos.size + lengths.size) * 4 + B * H * (D + 2) * 4)
    flops = 4 * tokens * H * D
    return nbytes, flops


def paged_errs(got, want, live) -> tuple:
    """Kernel (o, m, l) against plain (o, m, l) on the live rows: (max abs
    error of the normalised o, the same over 1 + |plain| (held to the f32
    tolerance: both sides read the same K/V and compute in f32, whatever
    the pool's dtype), max of m's abs and l's relative error)."""
    (o, m, l), (po, pm, pl) = got, want
    d = (o[live] / l[live][..., None] - po[live] / pl[live][..., None]).abs()
    scaled = (d / (1 + (po[live] / pl[live][..., None]).abs())).max().item()
    stat_err = max((m[live] - pm[live]).abs().max().item(),
                   ((l[live] - pl[live]).abs() / pl[live]).max().item())
    return d.max().item(), scaled, stat_err


def check_paged(args, window, name):
    from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain

    o, m, l = paged_attention_cuda(*args, window=window)
    want = paged_attention_plain(*args, window=window)
    torch.cuda.synchronize()
    for t in (o, m, l):
        check(bool(torch.isfinite(t).all()), f"paged {name}: non-finite output")
    lengths = args[5]
    dead = lengths == 0
    if dead.any():
        check(bool((o[dead] == 0).all() and (l[dead] == 0).all() and (m[dead] == -1e30).all()),
              f"paged {name}: an inactive row is not o=0, l=0, m=-1e30")
    err, scaled, stat_err = paged_errs((o, m, l), want, ~dead)
    tol = TOL_F32["paged_attention"]
    print(f"  paged_attention {name}: max abs err {err:.3e}, over 1 + |plain| {scaled:.3e} (tol {tol}), "
          f"m/l err {stat_err:.3e}", flush=True)
    check(scaled <= tol and stat_err <= 1e-3, f"paged {name} disagrees with plain")
    return err


# ------------------------------ flash prefill ------------------------------
def flash_case(gen, *, B=1, Sq=192, Sk=192, H=32, K=8, D=64, causal=True, window=None, q_start=0,
               dtype=torch.bfloat16):
    dev = gen.device
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Sk, K, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Sk, K, D), generator=gen, device=dev).to(dtype)
    return (q, k, v), dict(causal=causal, window=window, q_start=q_start)


def flash_mask(Sq, Sk, *, causal, window, q_start, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: the keys each query attends to."""
    qpos = q_start + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_work(args, kw):
    q, k, _ = args
    B, Sq, H, D = q.shape
    mask = flash_mask(Sq, k.shape[1], causal=kw["causal"], window=kw["window"], q_start=kw["q_start"])
    nbytes = sum(t.numel() * t.element_size() for t in args) + q.numel() * q.element_size()
    return nbytes, 4 * B * H * D * int(mask.sum())


def row_err(got, want) -> float:
    """max |got - want| in each row of the last dim over the row's max |want|,
    the largest over the rows."""
    d = (got.float() - want.float()).abs().amax(dim=-1)
    return (d / want.float().abs().amax(dim=-1).clamp_min(1e-30)).max().item()


def flash_ok(got, want) -> tuple:
    """(max abs error, row error, whether both are within the limits): bf16
    output also within ``ROW_TOL`` of each (token, head) row's largest."""
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype != torch.bfloat16:
        return err, None, err <= TOL_F32["flash_attention"]
    rel = row_err(got, want)
    return err, rel, err <= TOL["flash_attention"] and rel <= ROW_TOL


def check_flash(args, kw, name):
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    got = flash_attention_cuda(*args, **kw)
    want = flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite output")
    err, rel, ok = flash_ok(got, want)
    if rel is None:
        print(f"  flash_attention {name}: max abs err {err:.3e} (tol {TOL_F32['flash_attention']})", flush=True)
    else:
        print(f"  flash_attention {name}: max abs err {err:.3e} (tol {TOL['flash_attention']}), "
              f"row err {rel:.3e} (tol {ROW_TOL})", flush=True)
    check(ok, f"flash {name} disagrees with plain")
    return err


def bound_ms(nbytes, flops, dtype=torch.bfloat16):
    """The least time for ``nbytes`` moved and ``flops`` done on inputs of
    ``dtype``: the larger of the memory and the operations bound."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------ more shapes ------------------------------
DANUBE_LENGTHS = [129, 133, 137, 140, 144, 131, 135, 142]  # h2o-danube-3-4b's engine mid-decode
MIXTRAL_LENGTHS = [4161, 4165, 4170, 4174, 4179, 4183, 4188, 4192]  # mixtral-8x7b's rows in decode
MIXTRAL_PROMPT = 4160  # a 4096-token system prompt plus a 64-token tail
WINDOW = 4096  # mixtral-8x7b's (and h2o-danube-3-4b's) sliding window
PROMPT = 2048  # steps 8-10: 8 rows of 2048-token prompts, then 32 decode steps
N_DECODE = 32
SSM_HYBRID_LENGTHS = [2049, 2053, 2058, 2062, 2067, 2071, 2076, 2080]  # those rows in decode
ENC_FRAMES = 2048  # step 11: 8 rows of encoder frames, about 40 s of speech at 20 ms a frame
DEC_PROMPT = 64  # step 11: a one-page decoder prompt


def wide_head_cases(gen, errs) -> None:
    """Head dims that are not a power of two, in bf16 and f32: 120
    (h2o-danube-3-4b: 32 heads over 8 kv-heads) and 80 (zamba2-2.7b: 32
    heads, 32 kv-heads). Both kernels run them at a padded width."""
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for args, name in (
            (paged_case(gen, D=120, lengths=DANUBE_LENGTHS, dtype=dt), "head_dim 120"),
            (paged_case(gen, K=32, D=80, lengths=MAIN_LENGTHS, window=100, dtype=dt),
             "head_dim 80 (H=K=32), window 100"),
        ):
            errs["paged_attention"] = max(errs["paged_attention"], check_paged(*args, f"{name}, {tag} pool"))
        for args, name in (
            (flash_case(gen, Sq=128, Sk=128, D=120, dtype=dt), "head_dim 120 (Sq=Sk=128)"),
            (flash_case(gen, Sq=150, Sk=150, K=32, D=80, window=64, dtype=dt),
             "head_dim 80 (H=K=32), ragged Sq=Sk=150, window 64"),
        ):
            errs["flash_attention"] = max(errs["flash_attention"], check_flash(*args, f"{name}, {tag}"))


def paged_row(gen, flush, tag, pk, n_sm) -> dict:
    """The paged kernel's row of :func:`shape_rows` at the decode shape ``pk``."""
    from repro_torch.kernels import paged_attention as pa

    args, win = paged_case(gen, **pk)
    q, pool_k, _, tables, _, _ = args
    plan = pa.launch_plan(q.shape[0], q.shape[1], pool_k.shape[2], q.shape[2], tables.shape[1], n_sm)
    row = dict(max_abs_err=check_paged(args, win, f"{tag} decode shape {pk}"),
               ms=time_ms(lambda: pa.paged_attention_cuda(*args, window=win), flush=flush),
               plain_ms=time_ms(lambda: pa.paged_attention_plain(*args, window=win), flush=flush),
               library_ms=None, grid=list(plan.grid), head_chunk=plan.head_chunk,
               n_splits=plan.n_splits)
    row.update(zip(("bound_ms", "bound_by"), bound_ms(*paged_work(args, win))))
    return row


def shape_rows(gen, flush) -> dict:
    """Kernel, plain and library times, the bound and the launch plan at the
    shapes of steps 6, 7 and 9-11: h2o-danube-3-4b's (head dim 120, a
    padded width), mixtral-8x7b's (8 rows of 4161-4192 tokens over 72-entry
    tables, and a 4160-token prompt, both under the 4096-token window),
    zamba2-2.7b's (MHA, 32 heads of 80: 8 rows of 2049-2080 tokens, 8
    prompts of 2048), mistral-large-123b's (96 heads over 8 kv-heads of
    128; the paged kernel reads the bf16 pool an int8 pool dequantizes to)
    and seamless-m4t-medium's (MHA, 16 heads of 64: the encoder's
    non-causal 2048 x 2048 flash, the cross-attention prefill's 64 x 2048,
    and the cross-attention decode over rows of 2048 frames with an empty
    headroom page). Each is checked against the plain version first. The
    library call for flash is SDPA (with the causal window as an explicit
    boolean mask where there is one); the paged kernel has none (no single
    call reads a page table)."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_sm = torch.cuda.get_device_properties(gen.device).multi_processor_count
    rows = {"paged_attention": {}, "flash_attention": {}}
    long = dict(R=33, P=264, lengths=SSM_HYBRID_LENGTHS)
    cases = {
        "danube": (dict(D=120, lengths=DANUBE_LENGTHS), dict(Sq=128, Sk=128, D=120)),
        "mixtral": (dict(D=128, R=72, P=1024, lengths=MIXTRAL_LENGTHS, window=WINDOW),
                    dict(Sq=MIXTRAL_PROMPT, Sk=MIXTRAL_PROMPT, D=128, window=WINDOW)),
        "zamba2": (dict(H=32, K=32, D=80, **long), dict(B=8, Sq=PROMPT, Sk=PROMPT, H=32, K=32, D=80)),
        "mistral": (dict(H=96, K=8, D=128, **long), dict(B=8, Sq=PROMPT, Sk=PROMPT, H=96, K=8, D=128)),
        "seamless-encoder": (None, dict(B=8, Sq=ENC_FRAMES, Sk=ENC_FRAMES, H=16, K=16, D=64, causal=False)),
        "seamless-cross": (dict(H=16, K=16, D=64, R=ENC_FRAMES // 64 + 1, P=8 * (ENC_FRAMES // 64 + 1),
                                lengths=[ENC_FRAMES] * 8),
                           dict(B=8, Sq=DEC_PROMPT, Sk=ENC_FRAMES, H=16, K=16, D=64, causal=False)),
    }
    for tag, (pk, fk) in cases.items():
        if pk is not None:
            rows["paged_attention"][tag] = paged_row(gen, flush, tag, pk, n_sm)
        (q, k, v), kw = flash_case(gen, **fk)
        err = check_flash((q, k, v), kw, f"{tag} prefill shape {fk}")
        B, Sq, H, D = q.shape
        Sk, K = k.shape[1], k.shape[2]
        plan = fa.launch_plan(B, Sq, H, K, D, q.dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if kw["window"]:
            mask = flash_mask(Sq, Sk, causal=True, window=kw["window"], q_start=0, device=q.device)
            library = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=H != K)  # noqa: E731
        else:
            library = lambda: sdpa(qt, kt, vt, is_causal=kw["causal"], enable_gqa=H != K)  # noqa: E731
        lib_err = (library().transpose(1, 2).float() - fa.flash_attention_cuda(q, k, v, **kw).float()).abs().max().item()
        iters = 50 if B * Sq <= 1024 else 10  # the plain version materialises Sq x Sk scores
        row = dict(max_abs_err=err, ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), iters),
                   plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), min(iters, 5 if B > 1 else 10)),
                   library_ms=time_ms(library, iters), grid=list(plan.grid), heads_per_cta=plan.heads_per_cta)
        row.update(zip(("bound_ms", "bound_by"), bound_ms(*flash_work((q, k, v), kw))))
        rows["flash_attention"][tag] = row
        print(f"  SDPA at the {tag} prefill shape: max abs difference from the kernel {lib_err:.3e}", flush=True)
        del q, k, v, qt, kt, vt, library
        torch.cuda.empty_cache()
    for name, by_tag in rows.items():
        for tag, r in by_tag.items():
            plan = (f"grid {r['grid']}, {r['heads_per_cta']} heads per CTA" if "heads_per_cta" in r else
                    f"grid {r['grid']}, head chunk {r['head_chunk']}, {r['n_splits']} splits")
            print(f"  {name} at the {tag} shape: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}); {plan}",
                  flush=True)
    return rows


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
        want = pa.paged_attention_plain(*args, window=window)
        live = lengths_t > 0
        for S in (1, 2, 3, 4, 5, 8):
            plan = pa.launch_plan(*shape, n_splits=S)
            _, scaled, stat_err = paged_errs(pa.launch(*args, window, 0, plan), want, live)
            check(scaled <= TOL_F32["paged_attention"] and stat_err <= 1e-3,
                  f"paged S={S} disagrees with plain ({scaled}, m/l {stat_err})")
            ms = time_ms(lambda: pa.launch(*args, window, 0, plan), flush=flush)
            mark = " (the wrapper's plan)" if S == pa.launch_plan(*shape).n_splits else ""
            print(f"  sweep paged_attention {tag}: S={S}, {int(np.prod(plan.grid))} CTAs: "
                  f"{ms:.4f} ms{mark}", flush=True)
    (q, k, v), kw = flash_case(gen)
    want = fa.flash_attention_plain(q, k, v, **kw)
    shape = (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], q.dtype)
    for hp in (1, 2, 4):
        plan = fa.launch_plan(*shape, heads_per_cta=hp)
        err, rel, ok = flash_ok(fa.launch(q, k, v, kw["causal"], kw["window"], kw["q_start"], plan), want)
        check(ok, f"flash {hp} heads per CTA disagrees with plain ({err}, row {rel})")
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


def hold_to_ref(model, params, captured, step, prompt, dev, prefix="") -> None:
    """A captured engine decode step, then one prefill of ``prompt`` and one
    decode step from it, each against the same model through the
    ``impl="ref"`` oracles: max |logits difference| over max |ref logits|
    within ``LOGITS_TOL``."""
    check(bool(captured), f"{prefix}decode step {step} was never reached")
    cache, tokens, live = captured["cache"], captured["tokens"], captured["live"]
    want, _ = model.decode_step(params, cache, tokens, impl="ref")
    got, want = captured["logits"][live], want[live]  # an idle slot's logits are never read
    rel_e = (got - want).abs().max().item() / want.abs().max().item()
    print(f"{prefix}engine decode step {step} ({int(live.sum())} live rows) vs ref: "
          f"max abs err / max |ref| = {rel_e:.3e} (tol {LOGITS_TOL})", flush=True)
    check(bool(torch.isfinite(got).all()) and rel_e <= LOGITS_TOL, f"{prefix}engine decode disagrees with ref")
    captured.clear()
    del cache, got, want

    toks = torch.tensor([prompt], dtype=torch.long, device=dev)
    lk, ck = model.prefill(params, toks)
    lr, cr = model.prefill(params, toks, impl="ref")
    rel = (lk - lr).abs().max().item() / lr.abs().max().item()
    print(f"{prefix}prefill logits vs ref: max abs err / max |ref| = {rel:.3e} (tol {LOGITS_TOL})", flush=True)
    check(bool(torch.isfinite(lk).all()) and rel <= LOGITS_TOL, f"{prefix}prefill logits disagree with ref")
    nxt = lk.argmax(-1)
    dk_logits, _ = model.decode_step(params, clone_cache(ck), nxt)
    dr_logits, _ = model.decode_step(params, clone_cache(ck), nxt, impl="ref")
    rel_d = (dk_logits - dr_logits).abs().max().item() / dr_logits.abs().max().item()
    print(f"{prefix}decode logits vs ref: max abs err / max |ref| = {rel_d:.3e} (tol {LOGITS_TOL})", flush=True)
    check(bool(torch.isfinite(dk_logits).all()) and rel_d <= LOGITS_TOL, f"{prefix}decode logits disagree with ref")


def clone_cache(c) -> dict:
    """A copy of a cache (nested dicts of tensors): decode steps write the
    pools and SSM states in place."""
    return {k: clone_cache(v) if isinstance(v, dict) else v.clone() for k, v in c.items()}


def build_engine(cfg, name, dev, **engine_kw):
    """Random weights from seed 0, drawn on the card straight into the
    compute dtype (the MoE router in f32), and an engine on them; prints the
    build's peak device memory."""
    from repro_torch.models.lm import build_model
    from repro_torch.serving.engine import ServingEngine

    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev, dtype=cfg.cdtype())
    engine = ServingEngine(cfg, params, device=dev, **engine_kw)
    del params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(engine.params))
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(engine.params["blocks"]))
    print(f"engine: {name}, {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} kv-heads of {cfg.head_dim}, vocab {cfg.vocab_size}: {n_params} parameters "
          f"({w_bytes / 1e9:.2f} GB of block weights), pool {tuple(engine.pool_k.shape)} x2 "
          f"{engine.pool_k.dtype}; built in {time.perf_counter() - t0:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return model, engine


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def run_burst(engine, requests, kernels, name) -> tuple:
    """Serve ``requests`` at once with every kernel count at 0; check that all
    complete with in-range tokens and that every kernel ran. Returns
    (completions, wall seconds, launches, peak memory bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    done, wall = serve_burst(engine, requests)
    launches = {k.__name__.removesuffix("_cuda"): k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    for r in requests:
        c = done[r.request_id]
        check(len(c.tokens) == r.max_new_tokens and all(0 <= t < engine.cfg.vocab_size for t in c.tokens),
              f"{name}: request {r.request_id}: bad tokens {c.tokens}")
    check(all(n > 0 for n in launches.values()), f"{name}: a kernel never ran: {launches}")
    print(f"{engine_line(name, done, wall)} (all {len(requests)} submitted at once, {engine.max_slots} "
          f"slots); launches {launches}; peak memory {peak / 2**30:.2f} GiB", flush=True)
    return done, wall, launches, peak


DANUBE_CAPTURE_STEP = 8  # all 8 rows live


def danube_phase(cfg, dev, kernels) -> dict:
    """Step 6: h2o-danube-3-4b at full width and depth, head dim 120: 8
    requests of a shared 64-token prefix plus a 64-token tail, 16 new
    tokens, on 8 slots and 256 pages."""
    from repro_torch.launch.profile_serve import prefix_requests, warm_up

    model, engine = build_engine(cfg, cfg.arch_id, dev, max_slots=8, n_pages=256)
    warm_up(engine)
    requests = prefix_requests(cfg, 8, 64, 64, 16)
    captured = capture_decode(engine, DANUBE_CAPTURE_STEP)
    _, _, launches, _ = run_burst(engine, requests, kernels, "danube engine run")
    hold_to_ref(model, engine.params, captured, DANUBE_CAPTURE_STEP, requests[0].prompt, engine.device,
                prefix="danube ")
    return launches


MIXTRAL_LAYERS = 16  # of 32: 32 layers of bf16 weights (93 GB) exceed the card's 80 GB
MISTRAL_LAYERS = 16  # of 88: 88 layers of bf16 weights (243.6 GB) exceed the card's 80 GB
MIXTRAL_CAPTURE_STEP = 16  # rows of 4176 tokens: the window cuts in every row


def record_routes() -> dict:
    """Wrap the port's MoE dispatch so that, while ``state["on"]``, every
    call's router top-k choices (each token's experts, sorted) are kept, in
    call order, and the first call's inputs and output in ``state["first"]``;
    ``state["restore"]()`` puts the dispatch back."""
    from repro_torch.models import moe

    inner = moe._moe_local
    state = {"on": False, "calls": [], "first": None,
             "restore": lambda: setattr(moe, "_moe_local", inner)}

    def run(x, router, w1, wg, w2, cfg, **kw):
        out = inner(x, router, w1, wg, w2, cfg, **kw)
        if state["on"]:  # the gates a sharded decode sums over its router's blocks, else x's own
            gates = kw.get("gates")
            top = torch.topk(x.float() @ router.float() if gates is None else gates, cfg.top_k, dim=-1).indices
            state["calls"].append(top.sort(dim=-1).values)
            if state["first"] is None:
                state["first"] = (x, router, w1, wg, w2, out[0])
        return out

    moe._moe_local = run
    return state


def routed(state, fn):
    """Run ``fn`` with the router's choices recorded; returns (its result,
    the choices of each MoE call)."""
    state["on"], state["calls"], state["first"] = True, [], None
    try:
        return fn(), state["calls"]
    finally:
        state["on"] = False


def moe_plain(x, router, w1, wg, w2, cfg) -> tuple:
    """A MoE layer in f32, written out: each token's top-k experts by its
    own f32 gates, weights softmaxed over those k; each expert keeps its
    first ``C = max(int(T*k/E * capacity_factor), 4)`` assignments in
    (token, choice) order and drops the rest; a kept assignment adds
    gate * w2(silu(x wg) * (x w1)). Returns (out (T, d) f32, assignments
    dropped)."""
    T, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(int(T * k / E * cfg.capacity_factor), 4)
    xf = x.float()
    top_w, top_e = torch.topk(xf @ router.float(), k, dim=-1)
    top_w = torch.softmax(top_w, dim=-1)
    kept = [[] for _ in range(E)]
    dropped = 0
    for t, experts in enumerate(top_e.tolist()):
        for j, e in enumerate(experts):
            if len(kept[e]) < C:
                kept[e].append((t, j))
            else:
                dropped += 1
    out = torch.zeros_like(xf)
    for e, pairs in enumerate(kept):
        if not pairs:
            continue
        t, j = (torch.tensor(c, device=x.device) for c in zip(*pairs))
        a = xf[t]
        y = (torch.nn.functional.silu(a @ wg[e].float()) * (a @ w1[e].float())) @ w2[e].float()
        out.index_add_(0, t, y * top_w[t, j][:, None])
    return out, dropped


def hold_moe(first, cfg, what) -> None:
    """The port's first MoE call of a run (layer 0) against :func:`moe_plain`
    on the same inputs: max |d| over max |f32| per token within ``MOE_TOL``."""
    x, router, w1, wg, w2, got = first
    want, dropped = moe_plain(x, router, w1, wg, w2, cfg)
    rel = row_err(got, want)
    print(f"  mixtral {what}, layer 0's MoE ({x.shape[0]} tokens, capacity "
          f"{max(int(x.shape[0] * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 4)}, {dropped} of "
          f"{x.shape[0] * cfg.top_k} assignments dropped) vs an f32 loop over the chosen experts: "
          f"max abs err {(got.float() - want).abs().max().item():.3e}, row err {rel:.3e} (tol {MOE_TOL})",
          flush=True)
    check(rel <= MOE_TOL, f"mixtral {what}: the MoE layer disagrees with the f32 loop")


def route_flips(a, b) -> tuple:
    """(token, layer) pairs whose chosen experts differ between two runs, of all."""
    check(len(a) == len(b) and all(x.shape == y.shape for x, y in zip(a, b)), "runs of different shapes")
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b)), sum(x.shape[0] for x in a)


def checked_attention(errs) -> callable:
    """Route ``ops.flash_attention`` and ``ops.paged_attention`` through
    wrappers that hold each kernel-path call against the plain version on
    the very same inputs (the layer's own q, k, v, pools, tables and
    lengths) and keep the errors: flash's (max abs, row error, within the
    limits of :func:`flash_ok`), and paged's :func:`paged_errs` of the kernel's own (o, m, l),
    from one more launch on the same inputs (an int8 pool dequantized, as
    the kernel read it); returns the function that restores them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain

    flash, paged = ops.flash_attention, ops.paged_attention

    def flash_checked(q, k, v, *, causal=True, window=None, q_start=0, impl=None, **kw):
        out = flash(q, k, v, causal=causal, window=window, q_start=q_start, impl=impl, **kw)
        if impl is None:
            want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                                         window=window, q_start=q_start)
            err, _, ok = flash_ok(out, want)
            errs["flash_attention"].append((err, row_err(out, want), ok))
        return out

    def paged_checked(q, pool_k, pool_v, tables, page_pos, lengths, *, window=None, impl=None, **kw):
        out = paged(q, pool_k, pool_v, tables, page_pos, lengths, window=window, impl=impl, **kw)
        if impl is None:
            if pool_k.dtype == torch.int8:  # what the kernel read: the pool dequantized to bf16
                pool_k, pool_v = (ops.dequantize_pool(p, kw[s]) for p, s in ((pool_k, "scale_k"), (pool_v, "scale_v")))
            args = (q.contiguous(), pool_k, pool_v, tables.to(torch.int32).contiguous(),
                    page_pos.to(torch.int32).contiguous(), lengths.to(torch.int32).contiguous())
            got = paged_attention_cuda(*args, window=window)
            errs["paged_attention"].append(
                paged_errs(got, paged_attention_plain(*args, window=window), lengths > 0))
        return out

    ops.flash_attention, ops.paged_attention = flash_checked, paged_checked

    def restore():
        ops.flash_attention, ops.paged_attention = flash, paged
    return restore


def step_ms(fn, dev, reps: int = 3) -> tuple:
    """Median span of one synchronised call between CUDA events (the device
    waits on the host inside it too); the device's busy time in one more
    call from a ``torch.profiler`` trace (the union of its kernel and copy
    intervals), that call's six ops with the most device time, as
    (name, ms, calls), and its host calls (:func:`host_calls`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import _merged_device_intervals

    spans = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        spans.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    merged = _merged_device_intervals(prof.events())
    top = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda t: -t[1])[:6]
    return statistics.median(spans), sum(e - s for s, e in merged) / 1e3, top, host_calls(prof.events())


def host_calls(events) -> dict:
    """Host calls in a trace: aten ops (nested ones included), kernel
    launches and synchronisations, as ``profile_serve`` counts them."""
    from torch.autograd import DeviceType

    counts = {"aten_ops": 0, "kernel_launches": 0, "syncs": 0}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            continue
        if e.name.startswith("aten::"):
            counts["aten_ops"] += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC"):
            counts["kernel_launches"] += 1
        elif "Synchronize" in e.name:
            counts["syncs"] += 1
    return counts


def mixtral_phase(cfg, dev, kernels) -> dict:
    """Step 7: a MoE model with a sliding window, served with rows longer
    than the window: 8 requests of a shared window-long system prompt plus
    a one-page tail (4096 + 64 tokens for mixtral-8x7b), 32 new tokens, on 8
    slots and 1024 pages, at most 72 a row."""
    from repro_torch.launch.profile_serve import prefix_requests, warm_up

    window = cfg.sliding_window
    model, engine = build_engine(cfg, f"{cfg.arch_id} ({cfg.n_layers} layers)", dev, max_slots=8,
                                 n_pages=1024, max_pages_per_seq=72)
    warm_up(engine)
    routes = record_routes()
    requests = prefix_requests(cfg, 8, window, cfg.kv_page_tokens, 32)
    decode_s, decode = [], engine._decode

    def timed_decode(*args):
        t0 = time.perf_counter()
        out = decode(*args)
        torch.cuda.synchronize(dev)
        decode_s.append(time.perf_counter() - t0)
        return out

    engine._decode = timed_decode
    captured = capture_decode(engine, MIXTRAL_CAPTURE_STEP)
    done, wall, launches, peak = run_burst(engine, requests, kernels, "mixtral engine run")
    check(bool(captured), f"mixtral decode step {MIXTRAL_CAPTURE_STEP} was never reached")
    lengths = captured["cache"]["lengths"]
    check(bool(captured["live"].all()) and int(lengths.min()) > window,
          f"the captured step's rows are not all live and longer than the window: {lengths.tolist()}")
    # expert weights every decode step reads: the capacity dispatch multiplies
    # every expert's w1, wg and w2 (bf16) on every step
    expert_bytes = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * 2
    bound = expert_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  mixtral decode steps: {len(decode_s)}, median {statistics.median(decode_s) * 1e3:.2f} ms, "
          f"least {min(decode_s) * 1e3:.2f} ms (host clock, synchronised); expert-weight bytes per step "
          f"{expert_bytes} = {bound:.2f} ms at {HBM_BYTES_PER_S / 1e12} TB/s", flush=True)

    # every attention call of the captured step, kernel path, held to the plain version
    cache, tokens, live = captured["cache"], captured["tokens"], captured["live"]
    layer_errs = {"flash_attention": [], "paged_attention": []}
    restore = checked_attention(layer_errs)
    try:
        (got, _), routes_k = routed(routes, lambda: model.decode_step(engine.params, cache, tokens))
    finally:
        restore()
    check(len(layer_errs["paged_attention"]) == cfg.n_layers, f"{len(layer_errs['paged_attention'])} paged calls")
    worst, scaled, stat_err = (max(e) for e in zip(*layer_errs["paged_attention"]))
    print(f"  mixtral decode step {MIXTRAL_CAPTURE_STEP} (rows of {lengths.min().item()}-{lengths.max().item()} "
          f"tokens, window {window}): paged kernel (o, m, l) vs plain on each of its {cfg.n_layers} layers' "
          f"inputs, normalised o max abs err {worst:.3e}, over 1 + |plain| {scaled:.3e} "
          f"(tol {TOL_F32['paged_attention']}), m/l err {stat_err:.3e} (tol 1e-3); replayed logits vs the "
          f"engine's: max abs difference {(got - captured['logits']).abs().max().item():.3e}", flush=True)
    check(scaled <= TOL_F32["paged_attention"] and stat_err <= 1e-3,
          "mixtral: a layer's paged kernel disagrees with plain")
    hold_moe(routes["first"], cfg, f"decode step {MIXTRAL_CAPTURE_STEP}")

    span_ms, busy_ms, top, calls = step_ms(lambda: model.decode_step(engine.params, cache, tokens), dev)
    print(f"  one mixtral decode step (8 rows): {span_ms:.3f} ms between CUDA events around the synchronised "
          f"step, device busy {busy_ms:.3f} ms of it (profiler); expert-weight byte bound {bound:.2f} ms; "
          f"host calls {calls}; most device time: " + "; ".join(f"{name} {ms:.3f} ms in {n} calls" for name, ms, n in top),
          flush=True)

    (want, _), routes_r = routed(routes, lambda: model.decode_step(engine.params, cache, tokens, impl="ref"))
    flips, n_choices = route_flips(routes_k, routes_r)
    rel = (got[live] - want[live]).abs().max().item() / want[live].abs().max().item()
    print(f"  mixtral decode step logits vs ref: max abs err / max |ref| = {rel:.3e} (tol {LOGITS_TOL}); "
          f"router choices that differ: {flips} of {n_choices} (token, layer) pairs", flush=True)
    check(bool(torch.isfinite(got).all()), "mixtral: non-finite decode logits")
    check(flips > 0 or rel <= LOGITS_TOL, "mixtral decode logits disagree with ref with the same routing")
    captured.clear()
    del cache, got, want

    # one prefill of a 4160-token prompt: every flash call held to the plain version
    toks = torch.tensor([requests[0].prompt], dtype=torch.long, device=dev)
    restore = checked_attention(layer_errs)
    try:
        (lk, _), routes_k = routed(routes, lambda: model.prefill(engine.params, toks))
    finally:
        restore()
    check(len(layer_errs["flash_attention"]) == cfg.n_layers, f"{len(layer_errs['flash_attention'])} flash calls")
    worst, rel, ok = (max(e) for e in zip(*layer_errs["flash_attention"]))
    print(f"  mixtral prefill (Sq=Sk={toks.shape[1]}, window {window}): flash kernel vs plain on each of its "
          f"{cfg.n_layers} layers' inputs, max abs err {worst:.3e}, row err {rel:.3e} (tol {ROW_TOL} in bf16)",
          flush=True)
    check(all(e[2] for e in layer_errs["flash_attention"]), "mixtral: a layer's flash kernel disagrees with plain")
    hold_moe(routes["first"], cfg, "prefill")
    (lr, _), routes_r = routed(routes, lambda: model.prefill(engine.params, toks, impl="ref"))
    flips, n_choices = route_flips(routes_k, routes_r)
    rel = (lk - lr).abs().max().item() / lr.abs().max().item()
    print(f"  mixtral prefill logits vs ref: max abs err / max |ref| = {rel:.3e} (tol {LOGITS_TOL}); "
          f"router choices that differ: {flips} of {n_choices} (token, layer) pairs", flush=True)
    check(bool(torch.isfinite(lk).all()), "mixtral: non-finite prefill logits")
    check(flips > 0 or rel <= LOGITS_TOL, "mixtral prefill logits disagree with ref with the same routing")
    routes["restore"]()  # the recorded first call holds views of the expert weights
    routes.clear()
    n_tokens = sum(len(c.tokens) for c in done.values())
    return dict(launches=launches, tok_s=n_tokens / wall, peak_gib=peak / 2**30,
                decode_step_ms=statistics.median(decode_s) * 1e3, step_span_ms=span_ms,
                step_busy_ms=busy_ms, expert_bound_ms=bound)


# ------------------------------ steps 8-10: the model API ------------------------------
F32_FLOPS_PER_S = 67e12  # one H100 SXM's f32 rate outside the tensor cores (NVIDIA's data sheet)
SSM_TOL = 1e-3  # card vs CPU prefill logits in f32: max |d| over 1 + |cpu| (summation order only)
CONTINUATION_TOL = 2e-2  # tests/test_arch_smoke.py's teacher-forced continuation


def prompt_tokens(cfg, B: int, S: int, dev, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)


def build_model_params(cfg, name, dev, dtype):
    """Random weights from seed 0, drawn on the card straight into ``dtype``
    (the leaves the model uses in f32 kept f32); prints the build's peak
    device memory."""
    from repro_torch.models.lm import build_model

    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev, dtype=dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"model: {name}: {n_params} parameters, {w_bytes / 1e9:.3f} GB in {dtype}; built in "
          f"{time.perf_counter() - t0:.2f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return model, params


def _rows(inputs) -> tuple:
    """(rows, device, a description) of a prefill input: tokens (B, S), or
    an encoder-decoder's ``{"enc_embeds", "tokens"}``."""
    if not isinstance(inputs, dict):
        return inputs.shape[0], inputs.device, f"{inputs.shape[1]} tokens"
    names = {"enc_embeds": "encoder frames", "tokens": "decoder tokens"}
    first = next(iter(inputs.values()))
    return first.shape[0], first.device, " and ".join(f"{v.shape[1]} {names[k]}" for k, v in inputs.items())


def _head(inputs, n: int):
    """The first ``n`` positions of every prefill input."""
    if isinstance(inputs, dict):
        return {k: v[:, :n] for k, v in inputs.items()}
    return inputs[:, :n]


def drive(model, params, cfg, inputs, kernels, name, on_prefill=None) -> dict:
    """The traffic of steps 8-11 through the model API, every kernel count
    at 0 first: one prefill of ``inputs`` (tokens, or an encoder-decoder's
    dict), then ``N_DECODE`` greedy decode steps, each timed on the host
    clock and synchronised; ``on_prefill(cache)`` runs between the two,
    untimed. Checks the logits are finite; returns the measures (the
    launches of the prefill and of the whole run among them), the last
    logits and the last cache."""
    B, dev, desc = _rows(inputs)
    model.prefill(params, _head(inputs, cfg.kv_page_tokens))  # first-call set-up (cuBLAS handles)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, inputs)
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    prefill_launches = {k.__name__.removesuffix("_cuda"): k.launches for k in kernels}
    if on_prefill is not None:
        on_prefill(cache)
    steps = []
    for _ in range(N_DECODE):
        check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
        nxt = logits[:, :cfg.vocab_size].argmax(-1)
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, nxt)
        torch.cuda.synchronize(dev)
        steps.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
    check(tuple(logits.shape) == (B, cfg.padded_vocab), f"{name}: logits {tuple(logits.shape)}")
    launches = {k.__name__.removesuffix("_cuda"): k.launches for k in kernels}
    out = dict(prefill_ms=prefill_s * 1e3, decode_step_ms=statistics.median(steps) * 1e3,
               decode_step_least_ms=min(steps) * 1e3, decode_tok_s=B * N_DECODE / sum(steps),
               tok_s=B * (N_DECODE + 1) / (prefill_s + sum(steps)),
               run_peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
               prefill_launches=prefill_launches)
    print(f"  {name}: {B} rows of {desc}, prefill {out['prefill_ms']:.2f} ms; {N_DECODE} "
          f"greedy decode steps, median {out['decode_step_ms']:.3f} ms, least {min(steps) * 1e3:.3f} ms (host "
          f"clock, synchronised): {out['decode_tok_s']:.1f} tok/s in decode, {out['tok_s']:.1f} tok/s with the "
          f"prefill ({B * (N_DECODE + 1)} tokens); peak memory {out['run_peak_gib']:.2f} GiB; launches {launches}",
          flush=True)
    return out, logits, cache


def state_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache["ssm"].values())


def kv_pool_bytes(kv) -> int:
    return sum(kv[n].numel() * kv[n].element_size() for n in ("pool_k", "pool_v"))


def ssd_einsum_ms(cfg, B: int, S: int, dev) -> dict:
    """The three f32 einsums of one prefill layer's SSD scan
    (``ssd_chunked``'s ``y_intra``, chunk ``states`` and ``y_inter``), timed
    at that layer's shapes on random operands, beside their f32 flops."""
    from repro_torch.models.ssm import chunk_len

    L = chunk_len(S, cfg.ssm_chunk)
    nc, H, P, N, G = S // L, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    r = lambda *shape: torch.randn(shape, device=dev)  # noqa: E731
    cases = {
        "y_intra": ("bchlm,bcmhp->bclhp", (r(B, nc, H, L, L), r(B, nc, L, H, P)), 2 * B * nc * H * L * L * P),
        "states": ("bclgn,bclh,bclhp->bchnp", (r(B, nc, L, G, N), r(B, nc, L, H), r(B, nc, L, H, P)),
                   2 * B * nc * L * H * N * P),
        "y_inter": ("bclhn,bchnp,bclh->bclhp", (r(B, nc, L, H, N), r(B, nc, H, N, P), r(B, nc, L, H)),
                    2 * B * nc * L * H * N * P),
    }
    out = {}
    for name, (eq, ops_, flops) in cases.items():
        ms = time_ms(lambda: torch.einsum(eq, *ops_), 10)
        out[name] = dict(ms=ms, gflop=flops / 1e9, tflop_s=flops / ms / 1e9)
    print(f"  SSD einsums of one prefill layer (B={B}, chunks {nc} x {L}, H={H}, P={P}, N={N}; f32, TF32 off; "
          f"f32 peak {F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s): " + "; ".join(
              f"{n} {v['ms']:.4f} ms ({v['gflop']:.2f} GFLOP, {v['tflop_s']:.1f} TFLOP/s)" for n, v in out.items()),
          flush=True)
    return out


def profile_step(model, params, cache, cfg, dev, name) -> dict:
    """Decode steps on a copy of ``cache`` (each writes the same position
    again), one under the profiler: span, device busy time and the ops with
    the most device time."""
    c = clone_cache(cache)
    nxt = torch.zeros((cache["lengths"].shape[0],), dtype=torch.long, device=dev)
    span_ms, busy_ms, top, calls = step_ms(lambda: model.decode_step(params, c, nxt), dev)
    print(f"  one {name} decode step: {span_ms:.3f} ms between CUDA events around the synchronised step, "
          f"device busy {busy_ms:.3f} ms of it ({100 * busy_ms / span_ms:.1f}%; "
          f"profiler); host calls {calls}; most device time: " + "; ".join(f"{n} {ms:.3f} ms in {k} calls" for n, ms, k in top),
          flush=True)
    return dict(step_span_ms=span_ms, step_busy_ms=busy_ms, step_host_calls=calls)


def mamba2_phase(cfg, dev, kernels) -> dict:
    """Step 8: mamba2-370m at full width and depth through the model API: 8
    rows of 2048-token prompts (8 SSD chunks each), 32 greedy decode steps.
    Then, in f32 compute: (a) a 1984-token prefill (chunks of 248) and 64
    teacher-forced decode steps reach a 2048-token prefill's logits and
    SSM states; (b) one 256-token row's prefill logits on the card are the
    CPU's."""
    model, params = build_model_params(cfg, cfg.arch_id, dev, cfg.cdtype())
    tokens = prompt_tokens(cfg, 8, PROMPT, dev)
    res, _, cache = drive(model, params, cfg, tokens, kernels, "mamba2 run")
    res["ssm_state_bytes"] = state_bytes(cache)
    print(f"  mamba2 SSM state: {res['ssm_state_bytes']} bytes (f32 ssm {tuple(cache['ssm']['ssm'].shape)}, "
          f"conv {tuple(cache['ssm']['conv'].shape)})", flush=True)
    res["einsums"] = ssd_einsum_ms(cfg, 8, PROMPT, dev)
    res.update(profile_step(model, params, cache, cfg, dev, "mamba2"))
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32, params32 = build_model_params(cfg32, f"{cfg.arch_id} in f32", dev, torch.float32)
    toks = tokens[:2]
    want, wcache = model32.prefill(params32, toks)
    cut = PROMPT - 64
    logits, cache = model32.prefill(params32, toks[:, :cut])
    for i in range(cut, PROMPT):
        logits, cache = model32.decode_step(params32, cache, toks[:, i])
    d = (logits - want).abs()
    ok = bool(torch.isfinite(logits).all()) and bool((d <= CONTINUATION_TOL * (1 + want.abs())).all())
    sd = {n: ((cache["ssm"][n] - wcache["ssm"][n]).abs().max().item(), wcache["ssm"][n].abs().max().item())
          for n in ("ssm", "conv")}
    print(f"  (a) continuation, f32: prefill {cut} tokens (chunks of {cut // 8}) + 64 teacher-forced decode "
          f"steps vs a {PROMPT}-token prefill: logits max abs err {d.max().item():.3e} (tol rtol = atol = "
          f"{CONTINUATION_TOL}); SSM state max abs err {sd['ssm'][0]:.3e} (max |state| {sd['ssm'][1]:.3e}), "
          f"conv tail {sd['conv'][0]:.3e}", flush=True)
    check(ok, "mamba2: decode after prefill does not continue the longer prefill")
    res["continuation_err"] = d.max().item()

    row = toks[:1, :256]
    got, _ = model32.prefill(params32, row)
    cpu_params = _tree_to(params32, "cpu")
    del params32
    torch.cuda.empty_cache()
    want, _ = model32.prefill(cpu_params, row.cpu())
    rel = ((got.cpu() - want).abs() / (1 + want.abs())).max().item()
    print(f"  (b) card vs CPU, f32: one 256-token row's prefill logits, max |d| / (1 + |cpu|) = {rel:.3e} "
          f"(tol {SSM_TOL})", flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= SSM_TOL, "mamba2: the card's prefill disagrees with the CPU's")
    res["card_vs_cpu"] = rel
    return res


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _copy_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _copy_to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def hold_attention_layers(model, params, cfg, cache, prompt, dev, name, n_flash, n_paged) -> dict:
    """One decode step from a copy of ``cache`` (``n_paged`` paged calls)
    and one prefill of ``prompt`` (one row: tokens, or an encoder-decoder's
    dict; ``n_flash`` flash calls), each kernel call held to the plain
    version on its own inputs (as step 7), and their logits held to
    ``impl="ref"`` from the same starting point."""
    nxt = torch.zeros((cache["lengths"].shape[0],), dtype=torch.long, device=dev)
    errs = {"flash_attention": [], "paged_attention": []}
    restore = checked_attention(errs)
    try:
        got, _ = model.decode_step(params, clone_cache(cache), nxt)
    finally:
        restore()
    want, _ = model.decode_step(params, clone_cache(cache), nxt, impl="ref")
    check(len(errs["paged_attention"]) == n_paged, f"{name}: {len(errs['paged_attention'])} paged calls")
    worst, scaled, stat_err = (max(e) for e in zip(*errs["paged_attention"]))
    rel_d = (got - want).abs().max().item() / want.abs().max().item()
    lengths = cache["lengths"]
    print(f"  {name} decode step (rows of {lengths.min().item() + 1}-{lengths.max().item() + 1} tokens): paged "
          f"kernel (o, m, l) vs plain on the inputs of each of its {n_paged} calls, normalised o max abs err "
          f"{worst:.3e}, over 1 + |plain| {scaled:.3e} (tol {TOL_F32['paged_attention']}), m/l err {stat_err:.3e} "
          f"(tol 1e-3); logits vs ref: max abs err / max |ref| = {rel_d:.3e} (tol {LOGITS_TOL})", flush=True)
    check(scaled <= TOL_F32["paged_attention"] and stat_err <= 1e-3, f"{name}: a layer's paged kernel disagrees")
    check(bool(torch.isfinite(got).all()) and rel_d <= LOGITS_TOL, f"{name}: decode logits disagree with ref")

    restore = checked_attention(errs)
    try:
        lk, ck = model.prefill(params, prompt)
    finally:
        restore()
    lr, _ = model.prefill(params, prompt, impl="ref")
    check(len(errs["flash_attention"]) == n_flash, f"{name}: {len(errs['flash_attention'])} flash calls")
    worst, rel, _ = (max(e) for e in zip(*errs["flash_attention"]))
    rel_p = (lk - lr).abs().max().item() / lr.abs().max().item()
    print(f"  {name} prefill (one row of {_rows(prompt)[2]}): flash kernel vs plain on the inputs of each of its "
          f"{n_flash} calls, max abs err {worst:.3e}, row err {rel:.3e} (tol {ROW_TOL} in bf16); logits vs ref: "
          f"max abs err / max |ref| = {rel_p:.3e} (tol {LOGITS_TOL})", flush=True)
    check(all(e[2] for e in errs["flash_attention"]), f"{name}: a layer's flash kernel disagrees with plain")
    check(bool(torch.isfinite(lk).all()) and rel_p <= LOGITS_TOL, f"{name}: prefill logits disagree with ref")
    return dict(paged_scaled_err=scaled, flash_row_err=rel, decode_vs_ref=rel_d, prefill_vs_ref=rel_p,
                one_row_prefill=(lk, ck))


def zamba2_phase(cfg, dev, kernels) -> dict:
    """Step 9: zamba2-2.7b at full width and depth through the model API:
    54 Mamba2 layers in 9 groups of 6, the shared attention block (32 heads
    over 32 kv-heads of 80) after each group; 8 rows of 2048-token prompts
    (32 pages of 64 plus one headroom page), 32 greedy decode steps."""
    model, params = build_model_params(cfg, cfg.arch_id, dev, cfg.cdtype())
    tokens = prompt_tokens(cfg, 8, PROMPT, dev)
    res, _, cache = drive(model, params, cfg, tokens, kernels, "zamba2 run")
    check(all(n > 0 for n in res["launches"].values()), f"zamba2: a kernel never ran: {res['launches']}")
    n_attn = cfg.n_layers // cfg.attn_every
    kv_bytes = kv_pool_bytes(cache["kv"])
    res.update(ssm_state_bytes=state_bytes(cache), kv_pool_bytes=kv_bytes)
    print(f"  zamba2 state: SSM {res['ssm_state_bytes']} bytes (ssm {tuple(cache['ssm']['ssm'].shape)}, conv "
          f"{tuple(cache['ssm']['conv'].shape)}); KV pools {kv_bytes} bytes ({tuple(cache['kv']['pool_k'].shape)} "
          f"x2 {cache['kv']['pool_k'].dtype})", flush=True)
    res["einsums"] = ssd_einsum_ms(cfg, 8, PROMPT, dev)
    res.update(profile_step(model, params, cache, cfg, dev, "zamba2"))
    held = hold_attention_layers(model, params, cfg, cache, tokens[:1], dev, "zamba2", n_attn, n_attn)
    held.pop("one_row_prefill")
    res.update(held)
    return res


def mistral_phase(cfg, dev, kernels) -> dict:
    """Step 10: mistral-large-123b (16 of its 88 layers) with int8 KV pools
    through the model API: 8 rows of 2048-token prompts quantized into the
    pools at prefill, 32 decode steps each writing int8 K/V and f32 scales;
    the paged kernel reads each layer's pool dequantized to bf16."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import build_model

    model, params = build_model_params(cfg, f"{cfg.arch_id} ({cfg.n_layers} layers)", dev, cfg.cdtype())
    tokens = prompt_tokens(cfg, 8, PROMPT, dev)
    res, _, cache = drive(model, params, cfg, tokens, kernels, "mistral-large run")
    check(all(n > 0 for n in res["launches"].values()), f"mistral-large: a kernel never ran: {res['launches']}")
    kv = cache["kv"]
    check(kv["pool_k"].dtype == torch.int8 and kv["scale_k"].dtype == torch.float32, "mistral-large: pools not int8")
    pool_bytes = sum(kv[n].numel() for n in ("pool_k", "pool_v"))
    scale_bytes = sum(kv[n].numel() * 4 for n in ("scale_k", "scale_v"))
    pk, sk, pv, sv = kv["pool_k"][0], kv["scale_k"][0], kv["pool_v"][0], kv["scale_v"][0]
    deq_ms = time_ms(lambda: (ops.dequantize_pool(pk, sk), ops.dequantize_pool(pv, sv)), 20)
    deq_bytes = 2 * (pk.numel() * (1 + 2) + sk.numel() * 4)  # int8 read, bf16 written, scales read
    res.update(pool_bytes=pool_bytes, scale_bytes=scale_bytes, dequantize_ms=deq_ms)
    print(f"  mistral-large pools: {pool_bytes} bytes int8 + {scale_bytes} bytes of f32 scales "
          f"({tuple(kv['pool_k'].shape)} x2), against {2 * pool_bytes} in bf16; dequantizing one layer's K and V "
          f"{deq_ms:.4f} ms a step (bound {deq_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms: {deq_bytes} bytes)",
          flush=True)
    res.update(profile_step(model, params, cache, cfg, dev, "mistral-large"))
    held = hold_attention_layers(model, params, cfg, cache, tokens[:1], dev, "mistral-large", cfg.n_layers,
                                 cfg.n_layers)
    lk, ck = held.pop("one_row_prefill")
    res.update(held)

    # the same prompt over bf16 pools: the int8 pools are its K/V quantized,
    # and one decode step differs by the quantization error alone
    model16 = build_model(dataclasses.replace(cfg, kv_cache_dtype="bfloat16"))
    _, c16 = model16.prefill(params, tokens[:1])
    k16 = c16["kv"]["pool_k"][0]
    q_card, s_card = ops.quantize_token(k16)
    q_cpu, s_cpu = ops.quantize_token(k16.cpu())
    check(torch.equal(q_card.cpu(), q_cpu) and torch.equal(s_card.cpu(), s_cpu),
          "mistral-large: quantize_token on the card differs from the CPU's")
    if k16.dtype == cfg.cdtype():  # K is stored unrounded: the int8 pool is exactly its quantization
        check(torch.equal(ck["kv"]["pool_k"][0], q_card) and torch.equal(ck["kv"]["scale_k"][0], s_card),
              "mistral-large: the prefill's int8 pool is not quantize_token of its K")
    nxt = lk.argmax(-1)
    d8, _ = model.decode_step(params, ck, nxt)
    d16, _ = model16.decode_step(params, c16, nxt)
    res["int8_vs_bf16_logits"] = (d8 - d16).abs().max().item()
    print(f"  quantize_token of layer 0's K ({tuple(k16.shape)} {k16.dtype}) on the card equals the CPU's bit "
          f"for bit (and the prefill's int8 pool where K is not rounded first); one decode step over int8 vs bf16 pools: max |logits difference| "
          f"{res['int8_vs_bf16_logits']:.4e} (max |logit| {d16.abs().max().item():.4e}; quantization error, "
          f"not held)", flush=True)
    return res


ENCODE_ONLY_STEPS = 8


def seamless_phase(cfg, dev, kernels) -> dict:
    """Step 11: seamless-m4t-medium (the encoder-decoder) at full width and
    depth through the model API: 8 rows of 2048 encoder frames (N(0, 1) in
    bf16 from seed 0, as the JAX package's ``concrete_batch``), a 64-token
    decoder prompt, 32 greedy decode steps inside the headroom page. Then
    an encode-only prefill with 8 decode steps from token 0, its last step
    held to ``impl="ref"``; every kernel call of a one-row prefill and of a
    decode step held to the plain version; the cross pools unchanged by
    decode."""
    model, params = build_model_params(cfg, cfg.arch_id, dev, cfg.cdtype())
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    enc = torch.randn((8, ENC_FRAMES, cfg.d_model), generator=gen, device=dev).to(cfg.cdtype())
    inputs = {"enc_embeds": enc, "tokens": prompt_tokens(cfg, 8, DEC_PROMPT, dev)}
    n_flash, n_paged = cfg.n_enc_layers + 2 * cfg.n_dec_layers, 2 * cfg.n_dec_layers
    cross0 = {}  # the cross pools after the prefill, on the host

    def keep_cross(c):
        cross0.update({n: c["cross_kv"][n].cpu() for n in ("pool_k", "pool_v")})

    res, _, cache = drive(model, params, cfg, inputs, kernels, "seamless run", on_prefill=keep_cross)
    check(res["prefill_launches"] == {"flash_attention": n_flash, "paged_attention": 0}
          and res["launches"] == {"flash_attention": n_flash, "paged_attention": n_paged * N_DECODE},
          f"seamless: launches {res['prefill_launches']} in the prefill, {res['launches']} in the run; expected "
          f"{n_flash} flash calls in the prefill and {n_paged} paged calls a decode step")
    check(all(torch.equal(cache["cross_kv"][n].cpu(), t) for n, t in cross0.items()),
          "seamless: a decode step wrote the cross-attention pools")
    del cross0
    res.update(build_peak_gib=build_peak, cross_pool_bytes=kv_pool_bytes(cache["cross_kv"]),
               self_pool_bytes=kv_pool_bytes(cache["self_kv"]))
    print(f"  seamless pools: cross {res['cross_pool_bytes']} bytes ({tuple(cache['cross_kv']['pool_k'].shape)} x2 "
          f"{cache['cross_kv']['pool_k'].dtype}), unchanged by {N_DECODE} decode steps; self "
          f"{res['self_pool_bytes']} bytes ({tuple(cache['self_kv']['pool_k'].shape)} x2); launches "
          f"{res['prefill_launches']['flash_attention']} flash in the prefill, {n_paged} paged a decode step",
          flush=True)
    res.update(profile_step(model, params, cache, cfg, dev, "seamless"))
    held = hold_attention_layers(model, params, cfg, cache, {k: v[:1] for k, v in inputs.items()}, dev,
                                 "seamless", n_flash, n_paged)
    held.pop("one_row_prefill")
    res.update(held)
    del cache

    # encode-only: decoding starts at position 0 from token 0
    _, cache = model.prefill(params, {"enc_embeds": enc})
    check(not cache["lengths"].any(), "seamless: an encode-only prefill left decoder tokens in the cache")
    nxt = torch.zeros((enc.shape[0],), dtype=torch.long, device=dev)
    for _ in range(ENCODE_ONLY_STEPS - 1):
        logits, cache = model.decode_step(params, cache, nxt)
        nxt = logits[:, :cfg.vocab_size].argmax(-1)
    got, _ = model.decode_step(params, clone_cache(cache), nxt)
    want, _ = model.decode_step(params, cache, nxt, impl="ref")
    res["encode_only_vs_ref"] = (got - want).abs().max().item() / want.abs().max().item()
    print(f"  seamless encode-only prefill, then {ENCODE_ONLY_STEPS} decode steps from token 0: the last step's "
          f"logits vs ref: max abs err / max |ref| = {res['encode_only_vs_ref']:.3e} (tol {LOGITS_TOL})", flush=True)
    check(bool(torch.isfinite(got).all()) and res["encode_only_vs_ref"] <= LOGITS_TOL,
          "seamless: encode-only decode logits disagree with ref")
    return res


# ------------------------------ step 12: training ------------------------------
TRAIN_ROWS, TRAIN_SEQ = 8, 2048  # 16384 tokens a step, in 4 microbatches of 2 rows
TRAIN_WARMUP, TRAIN_TIMED = 2, 8
TRAIN_LR = 3e-4
XLA_REF_TOL = 1e-3  # one microbatch's bf16 loss, impl="xla" against impl="ref", relative
TRAIN_LOSS_TOL = 1e-5  # a smoke step's loss, card against CPU (f32), relative to max(1, |cpu|)
TRAIN_GRAD_TOL = 1e-4  # each leaf of the step's moments and parameter deltas, over its largest
# AdamW's first step divides each gradient element by its own magnitude, so
# an element whose gradient is near zero gets a delta of about lr with a
# sign set by rounding: one f32 step of the torch port on the CPU against
# the JAX package moved wk's deltas 0.14 of the largest apart. So the card's
# step is held in two parts: its moments (linear in the gradient) to the
# CPU's, and its parameter deltas to AdamW's formula applied on the CPU to
# the card's own moments.
TRAIN_FAMILIES = ("llama3_2-1b", "mixtral-8x7b", "chameleon-34b", "mamba2-370m", "zamba2-2.7b",
                  "seamless-m4t-medium")


def _paths(tree, path=()) -> dict:
    """{path: leaf} of a tree of dicts, keys sorted."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _paths(tree[k], path + (k,)).items()}
    return {path: tree}


def train_batch(pipe, step: int, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}


def traced_train_step(run, cfg, dev) -> dict:
    """One training step under ``torch.profiler`` with shapes: its span
    between CUDA events, the device's busy time (the union of kernel and
    copy intervals), the device ms of the f32 unembedding (every ``mm`` with
    the padded vocab among its input shapes: the forward and both backward
    products) and of the attention einsums (every ``bmm``: QK^T and P.V,
    their recompute and backward), and the six ops with the most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import _merged_device_intervals

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        torch.cuda.synchronize(dev)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize(dev)
    span = start.elapsed_time(end)
    events = prof.events()
    busy = sum(e - s for s, e in _merged_device_intervals(events)) / 1e3
    unembed = attention = 0.0
    for e in events:
        if e.name == "aten::mm" and any(cfg.padded_vocab in s for s in e.input_shapes if s):
            unembed += e.self_device_time_total / 1e3
        elif e.name == "aten::bmm":
            attention += e.self_device_time_total / 1e3
    top = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda t: -t[1])[:6]
    return {"span_ms": span, "busy_ms": busy, "busy_share": busy / span, "unembed_ms": unembed,
            "attention_einsum_ms": attention, "top": top}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def llama_training(cfg, dev) -> dict:
    """Step 12 (a) and (d): ``llama3_2-1b`` at full width and depth trained
    through ``make_train_step`` on batches that ``TokenPipeline`` reads from
    the bigram corpus in a ``Cluster`` blob; then its whole state (f32
    params, AdamW moments) saved to and restored from a ``BlobCheckpointer``
    at the class default page size."""
    from repro_torch.core import Cluster
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline, write_token_corpus
    from repro_torch.launch.train import bigram_corpus, corpus_tokens
    from repro_torch.models.lm import build_model
    from repro_torch.storage.checkpoint import BlobCheckpointer
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = init_train_state(model, seed=0, device=dev)
    n_params = sum(t.numel() for t in _paths(params).values())
    steps = TRAIN_WARMUP + TRAIN_TIMED
    step_fn = make_train_step(model, cfg, AdamWConfig(lr=TRAIN_LR, total_steps=steps,
                                                      warmup_steps=max(steps // 10, 1)))
    res = {"params": n_params, "tokens_per_step": TRAIN_ROWS * TRAIN_SEQ}
    cluster = Cluster(n_data_providers=4, n_metadata_providers=4)
    try:
        session = cluster.session()
        n_tokens = corpus_tokens(TRAIN_ROWS, TRAIN_SEQ)
        t0 = time.perf_counter()
        corpus = bigram_corpus(cfg.vocab_size, n_tokens, np.random.default_rng(0))
        pipe = TokenPipeline(write_token_corpus(session, corpus), n_tokens,
                             PipelineConfig(batch_per_rank=TRAIN_ROWS, seq_len=TRAIN_SEQ, n_ranks=1, rank=0))
        print(f"  corpus: {n_tokens} tokens made and stored as one blob in {time.perf_counter() - t0:.2f} s",
              flush=True)
        losses, gnorms, step_s, read_s = [], [], [], []
        for step in range(steps):
            t0 = time.perf_counter()
            batch = train_batch(pipe, step, dev)
            t1 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            if step >= TRAIN_WARMUP:
                step_s.append(t2 - t0)
                read_s.append(t1 - t0)
        check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
              f"llama3_2-1b training: non-finite losses {losses} or grad norms {gnorms}")
        res.update(step_ms=statistics.median(step_s) * 1e3, step_ms_min=min(step_s) * 1e3,
                   step_ms_max=max(step_s) * 1e3, batch_read_ms=statistics.median(read_s) * 1e3,
                   tok_s=TRAIN_ROWS * TRAIN_SEQ / statistics.median(step_s),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, first_loss=losses[0],
                   last_loss=losses[-1], losses=losses, grad_norms=gnorms)
        print(f"  llama3_2-1b training ({n_params} parameters, {cfg.param_dtype} params, {cfg.compute_dtype} compute, grad_accum "
              f"{cfg.grad_accum}, remat {cfg.remat}): median step {res['step_ms']:.1f} ms (host clock, "
              f"synchronised; {res['step_ms_min']:.1f}-{res['step_ms_max']:.1f} over {TRAIN_TIMED} steps; "
              f"batch read from the blob {res['batch_read_ms']:.2f} ms of it), {res['tok_s']:.0f} tok/s, "
              f"peak memory {res['peak_gib']:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad norm "
              f"{gnorms[0]:.4f} -> {gnorms[-1]:.4f}", flush=True)

        trace = traced_train_step(lambda: step_fn(params, opt_state, train_batch(pipe, steps, dev)), cfg, dev)
        res["trace"] = {k: v for k, v in trace.items() if k != "top"}
        res["trace"]["busy_share_of_median_step"] = trace["busy_ms"] / res["step_ms"]
        print(f"  traced step: {trace['span_ms']:.1f} ms between CUDA events (the profiler's host cost "
              f"included), device busy {trace['busy_ms']:.1f} ms ({trace['busy_share']:.1%} of the span, "
              f"{res['trace']['busy_share_of_median_step']:.1%} of the median untraced step); f32 unembedding "
              f"{trace['unembed_ms']:.1f} ms, attention einsums {trace['attention_einsum_ms']:.1f} ms; top "
              + ", ".join(f"{k} {ms:.1f} ms/{n}" for k, ms, n in trace["top"]), flush=True)

        # the training attention against the quadratic oracle, one microbatch
        mb = {k: v[:TRAIN_ROWS // cfg.grad_accum] for k, v in train_batch(pipe, 0, dev).items()}
        with torch.no_grad():
            l_xla = float(model.train_loss(params, mb, impl="xla")[0])
            l_ref = float(model.train_loss(params, mb, impl="ref")[0])
        rel = abs(l_xla - l_ref) / abs(l_ref)
        res.update(xla_loss=l_xla, ref_loss=l_ref, xla_ref_rel=rel)
        print(f"  one microbatch's loss: impl='xla' {l_xla:.6f}, impl='ref' {l_ref:.6f}, relative "
              f"difference {rel:.3e} (tol {XLA_REF_TOL})", flush=True)
        check(rel <= XLA_REF_TOL, f"training attention: impl='xla' loss {l_xla} vs ref {l_ref}")
        del mb, batch, metrics
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the whole state through the versioned blob store, 1 MiB pages
        state = {"params": params, "opt": opt_state}
        t0 = time.perf_counter()
        ck = BlobCheckpointer(session, state)
        rec = ck.save(steps, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = ck.restore(device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        nbytes = sum(i.size for i in ck.layout)
        same = all(bits_equal(a, b) for a, b in zip(_paths(restored).values(), _paths(state).values()))
        res["checkpoint"] = {"bytes": nbytes, "pages": rec.total_pages, "dirty_pages": rec.dirty_pages,
                             "page_size": ck.page_size, "save_ms": save_s * 1e3, "restore_ms": restore_s * 1e3}
        print(f"  checkpoint of the whole state: {nbytes} bytes in {len(ck.layout)} leaves, {rec.total_pages} "
              f"pages of {ck.page_size} bytes ({rec.dirty_pages} dirty); save {save_s * 1e3:.0f} ms, restore "
              f"to the card {restore_s * 1e3:.0f} ms; restored state bit-equal: {same}", flush=True)
        check(same, "the restored checkpoint differs from the saved state")
        del restored, state, ck
    finally:
        cluster.close()
    return res


def smoke_train_batch(cfg, rows: int = 4, seq: int = 64, seed: int = 0) -> dict:
    """The JAX package's batch dict for ``cfg``: tokens and labels (a few -1),
    ``embeds`` for a vlm backbone, ``enc_embeds`` for the encoder-decoder."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal((rows, seq, cfg.d_model)).astype(np.float32)
        del batch["tokens"]
    if cfg.family in ("encdec", "audio"):
        batch["enc_embeds"] = rng.standard_normal((rows, seq, cfg.d_model)).astype(np.float32)
    return batch


def adamw_first_step(p0, m, v, cfg) -> torch.Tensor:
    """The params after AdamW's first step with moments ``m`` and ``v``, in
    f32 on the CPU: ``p0 - lr * (m̂ / (sqrt(v̂) + eps) + wd * p0)``."""
    from repro_torch.train.optimizer import lr_at

    one = torch.ones((), dtype=torch.int32)
    lr = lr_at(one, cfg)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), one.float())
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), one.float())
    p0 = p0.float()
    return p0 - lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p0)


def family_steps(dev) -> dict:
    """Step 12 (b): one train step of each family's smoke config on the card
    against the same step on the CPU, from the same weights (drawn on the
    CPU) and batch: the loss, the moments, and the card's parameter deltas
    against AdamW's formula on its own moments."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch).smoke()
        model = build_model(cfg)
        batch = smoke_train_batch(cfg)
        params0 = model.init(seed=0, device="cpu")
        runs = {}
        for d in ("cpu", dev):
            params = _copy_to(params0, d)  # a copy: the step updates its params in place
            opt_state = adamw_init(params)
            step = make_train_step(model, cfg, opt_cfg)
            params, opt_state, metrics = step(params, opt_state, {k: torch.from_numpy(v).to(d) for k, v in batch.items()})
            runs[str(d)] = (float(metrics["loss"]), _paths(_tree_to(params, "cpu")),
                            _paths(_tree_to(opt_state["m"], "cpu")), _paths(_tree_to(opt_state["v"], "cpu")))
        (l_cpu, p_cpu, m_cpu, v_cpu), (l_card, p_card, m_card, v_card) = runs["cpu"], runs[str(dev)]
        p0 = _paths(params0)
        loss_err = abs(l_card - l_cpu) / max(1.0, abs(l_cpu))
        worst = {"m": 0.0, "v": 0.0, "delta": 0.0, "delta_vs_cpu": 0.0}
        for path in p0:
            for name, a, b in (("m", m_card, m_cpu), ("v", v_card, v_cpu)):
                worst[name] = max(worst[name], float((a[path] - b[path]).abs().max() / b[path].abs().max().clamp_min(1e-30)))
            d_card = p_card[path].float() - p0[path].float()
            scale = d_card.abs().max().clamp_min(1e-30)
            want = adamw_first_step(p0[path], m_card[path], v_card[path], opt_cfg)
            worst["delta"] = max(worst["delta"], float((p_card[path].float() - want).abs().max() / scale))
            worst["delta_vs_cpu"] = max(worst["delta_vs_cpu"], float(
                (p_card[path].float() - p_cpu[path].float()).abs().max() / scale))
        out[arch] = {"loss_cpu": l_cpu, "loss_card": l_card, "loss_err": loss_err, **worst}
        print(f"  {arch} smoke train step, card vs CPU: loss {l_card:.7f} / {l_cpu:.7f} (relative {loss_err:.2e}, "
              f"tol {TRAIN_LOSS_TOL}); moments m {worst['m']:.2e}, v {worst['v']:.2e}; parameter deltas against "
              f"AdamW on the card's moments {worst['delta']:.2e} (tol {TRAIN_GRAD_TOL} of each leaf's largest; "
              f"against the CPU's deltas {worst['delta_vs_cpu']:.2e}, not held)", flush=True)
        check(loss_err <= TRAIN_LOSS_TOL, f"{arch}: card loss {l_card} vs CPU {l_cpu}")
        check(max(worst["m"], worst["v"], worst["delta"]) <= TRAIN_GRAD_TOL,
              f"{arch}: card train step differs from the CPU's: {worst}")
    return out


def launcher_runs(dev) -> dict:
    """Step 12 (c): ``repro_torch.launch.train.train`` on the card, on the
    smoke config: the loss falls over 30 steps at lr 1e-2, and a run that
    crashes at step 14 (a checkpoint at step 10), rerun with ``restore`` on
    the same session, ends on the uninterrupted run's final loss."""
    from repro_torch.core import Cluster
    from repro_torch.launch.train import train

    t0 = time.perf_counter()
    out = train("llama3_2-1b", smoke=True, steps=30, batch=8, seq=64, checkpoint_every=100, lr=1e-2, device=dev)
    losses = out["losses"]
    drop = float(np.mean(losses[:5]) - np.mean(losses[-5:]))
    print(f"  launcher, 30 smoke steps at lr 1e-2: mean loss of the first 5 {np.mean(losses[:5]):.4f}, of the "
          f"last 5 {np.mean(losses[-5:]):.4f} (drop {drop:.4f}, at least 0.5 asked); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(drop >= 0.5, f"the launcher's loss did not fall: {losses}")
    kw = dict(smoke=True, steps=20, batch=4, seq=64, checkpoint_every=10, seed=3, device=dev)
    a = train("llama3_2-1b", **kw)
    cluster = Cluster(n_data_providers=4, n_metadata_providers=4, shared_cache_bytes=0)
    try:
        session = cluster.session()
        try:
            train("llama3_2-1b", session=session, fail_at_step=14, **kw)
            fail("the injected failure at step 14 did not raise")
        except RuntimeError as e:
            check("injected failure" in str(e), f"unexpected error: {e}")
        b = train("llama3_2-1b", session=session, restore=True, **kw)
    finally:
        cluster.close()
    rel = abs(a["losses"][-1] - b["losses"][-1]) / abs(a["losses"][-1])
    print(f"  launcher crash at step 14 and rerun with restore: final loss {b['losses'][-1]:.6f} against the "
          f"uninterrupted run's {a['losses'][-1]:.6f} (relative {rel:.2e}, tol 1e-4)", flush=True)
    check(rel <= 1e-4, f"the resumed run ends on {b['losses'][-1]}, the uninterrupted on {a['losses'][-1]}")
    return {"loss_drop": drop, "resume_rel": rel}


def training_phase(dev, kernels) -> dict:
    """Step 12: the training path, which launches neither CUDA kernel (its
    attention is ``impl="xla"``): (a) and (d) ``llama3_2-1b`` at full width
    and depth, (b) one step of each family's smoke config against the CPU,
    (c) the launcher. The kernels' counters are read across all of it."""
    cfg = get_train_config()
    for k in kernels:
        k.launches = 0
    res = llama_training(cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    res["families"] = family_steps(dev)
    res["launcher"] = launcher_runs(dev)
    res["launches"] = {"flash_attention": kernels[0].launches, "paged_attention": kernels[1].launches}
    print(f"  kernel launches across step 12: {res['launches']}", flush=True)
    check(all(n == 0 for n in res["launches"].values()), f"a CUDA kernel ran in training: {res['launches']}")
    return res


def get_train_config():
    from repro_torch.configs import get_config

    cfg = get_config("llama3_2-1b")
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.param_dtype, cfg.compute_dtype, cfg.grad_accum,
           cfg.remat, cfg.use_pallas) == (16, 2048, 128256, "float32", "bfloat16", 4, "full", False),
          f"unexpected config {cfg}")
    return cfg


# ------------------------------ step 13: the sky application ------------------------------
SKY_DEVICE_TYPE = "cuda"  # where the detectors' tensors must lie (a CPU rehearsal sets "cpu")


def sky_pair_times(res) -> dict:
    """Per frame pair (by its later epoch), over its detectors' CUDA-event
    spans: the summed H2D ms and the rate, and the summed stream ms from the
    copy's end to the hits (the device's work plus its waits for the host
    between ops, which the detector threads' contention for the interpreter
    stretches); ``None`` where no span was recorded (no card)."""
    dep = res["deployment"]
    pair_bytes = 2 * dep["n_regions"] * dep["region_px"] ** 2 * 4
    rows = {}
    for epoch in range(2, dep["epochs"] + 1):
        spans = [s for s in res["device_spans"] if s["epoch"] == epoch]
        h2d = sum(s["copied_ms"] - s["start_ms"] for s in spans) if spans else None
        rows[epoch] = dict(bytes=pair_bytes, h2d_ms=h2d, h2d_GBps=pair_bytes / h2d / 1e6 if spans else None,
                           stream_ms=sum(s["done_ms"] - s["copied_ms"] for s in spans) if spans else None)
    return rows


def sky_replay(dep, dev, threshold: float, iters: int = 10) -> dict:
    """One frame pair's detection replayed alone on the card, at the run's
    shapes: each detector's ``hit_rows`` over its block of regions in turn
    (its ``nonzero`` syncing the host), between CUDA events, mean of
    ``iters`` after a warm-up. Frames of unit noise, one hit a region. The
    bound: both frames read once at the card's memory rate."""
    from repro_torch.data.detect import hit_rows

    n, px, n_det = dep["n_regions"], dep["region_px"], dep["n_detectors"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    before = torch.randn((n, px, px), generator=gen, device=dev)
    after = before + torch.randn((n, px, px), generator=gen, device=dev)
    after[:, 0, 0] += 1000.0
    per = -(-n // n_det)
    blocks = [slice(k * per, (k + 1) * per) for k in range(n_det)]
    hits = []

    def pair():
        hits.append(sum(int(hit_rows(before[b], after[b], threshold).shape[0]) for b in blocks))

    pair()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        pair()
    end.record()
    torch.cuda.synchronize()
    check(hits == [n] * (iters + 1), f"replayed pair found {hits[:3]} hits, expected {n}")
    nbytes = 2 * n * px * px * 4
    return {"device_ms": start.elapsed_time(end) / iters, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "calls": n_det}


def sky_phase(dev, card, kernels, smoke: bool = False) -> dict:
    """Step 13: ``repro_torch.launch.supernovae`` at the paper's deployment
    (or the example's, with ``smoke``). Fails unless (a) every detector's
    hits in every frame pair equal numpy's ``detect_transients`` on the same
    ``readv`` bytes, region by region; (b) each supernova is found in the
    pair that ends one epoch after it ignites, and nowhere else (one that
    ignites in the last epoch is not found); (c) the detectors' tensors lay
    on the card. Neither CUDA kernel may run."""
    from repro_torch.data.sky import detect_transients
    from repro_torch.launch.supernovae import THRESHOLD, Deployment, run

    dep = Deployment.smoke() if smoke else Deployment.paper()
    if not smoke:
        check((dep.n_regions, dep.region_px, dep.page_size, dep.n_data_providers, dep.n_metadata_providers,
               dep.n_detectors, dep.epochs, THRESHOLD) == (64, 2048, 64 << 10, 20, 20, 8, 8, 150.0),
              f"not the paper's deployment: {dep}")
    px = dep.region_px
    lock, checked, mismatches = threading.Lock(), [], []

    def on_pair(k, epoch, regions, before, after, hits):
        for r, b, a, got in zip(regions, before, after, hits):
            img_b = b[: px * px * 4].view(np.float32).reshape(px, px)
            img_a = a[: px * px * 4].view(np.float32).reshape(px, px)
            want = detect_transients(img_b, img_a, threshold=THRESHOLD)
            with lock:
                checked.append((k, epoch, r))
                if got != want:
                    mismatches.append((k, epoch, r, got[:3], want[:3]))

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = run(smoke, device=dev, on_pair=on_pair)
    peak = torch.cuda.max_memory_allocated()
    launches = {"flash_attention": kernels[0].launches, "paged_attention": kernels[1].launches}
    dep = res["deployment"]
    n_pairs = dep["n_detectors"] * (dep["epochs"] - 1)
    # (c)
    check(res["detector_device"] == [SKY_DEVICE_TYPE], f"detector tensors on {res['detector_device']}")
    check(dev.type != "cuda" or len(res["device_spans"]) == n_pairs, "a frame pair recorded no device span")
    # (a)
    check(len(checked) == dep["n_regions"] * (dep["epochs"] - 1),
          f"{len(checked)} region pairs checked against numpy, expected {dep['n_regions'] * (dep['epochs'] - 1)}")
    check(not mismatches, f"device detections differ from numpy's: {mismatches[:4]}")
    # (b)
    last = dep["epochs"]
    want = {(ign + 1, r, x, y) for r, x, y, ign in res["truth"] if ign < last}
    got = {(e, r, x, y) for e, lst in res["detections"].items() for r, hs in lst for x, y, _ in hs}
    check(got == want and want, f"detections {sorted(got)} != ground truth {sorted(want)}")
    check(all(n == 0 for n in launches.values()), f"a CUDA kernel ran in the sky phase: {launches}")

    writes = [(w["write_s"] * 1e3, w["bytes"] / w["write_s"] / 1e6) for w in res["writes"]]
    lat = sorted(res["latency_ms"].values())
    pairs = sky_pair_times(res)
    store = res["store"]
    print(f"sky on {card}: {dep['n_regions']} regions of {dep['region_px']}^2 f32, {dep['page_size'] >> 10} KiB "
          f"pages, {dep['n_data_providers']} + {dep['n_metadata_providers']} providers, "
          f"{dep['n_detectors']} detectors, {dep['epochs']} epochs in {res['wall_s']:.2f} s", flush=True)
    print(f"  telescope write per epoch (ms, MB/s): {[(round(a, 1), round(b, 1)) for a, b in writes]}", flush=True)
    print(f"  detector read MB/s: {[round(d['read_MBps'], 1) for d in res['per_detector']]}, aggregate "
          f"{res['aggregate_read_MBps']:.1f} MB/s", flush=True)
    print(f"  detection latency from publication: p50 {statistics.median(lat):.1f} ms, max {lat[-1]:.1f} ms",
          flush=True)
    for epoch, p in pairs.items():
        times = ("not measured" if p["h2d_ms"] is None else
                 f"H2D {p['h2d_ms']:.2f} ms ({p['h2d_GBps']:.2f} GB/s), stream {p['stream_ms']:.3f} ms")
        print(f"  frame pair ({epoch - 1}, {epoch}) on {card}: {p['bytes']} bytes, {times}, summed over "
              f"{dep['n_detectors']} detectors' streams", flush=True)
    replay = sky_replay(dep, dev, THRESHOLD)
    print(f"  one frame pair's detection replayed alone on {card}: {replay['device_ms']:.3f} ms in "
          f"{replay['calls']} calls, bound {replay['bound_ms']:.4f} ms (bytes: {replay['bytes']})", flush=True)
    busy = None if res["busy_ms"] is None else res["busy_ms"] / res["span_ms"]
    print(f"  device busy at most {'not measured' if busy is None else f'{busy:.2%}'} of the phase on {card} "
          f"(the union of the streams' spans); peak "
          f"memory {peak / 2**30:.2f} GiB; store {store['storage_bytes']} bytes, {store['data_rounds']} RPC "
          f"rounds, cache hit rate {store['hit_rate']:.1%}, first reads {store['first_read_hit_rate']:.1%} warm; "
          f"found {len(got)} of {len(res['truth'])} supernovae; kernel launches {launches}", flush=True)
    return {"launches": launches, "deployment": dep, "wall_s": res["wall_s"],
            "write_ms": [w[0] for w in writes], "write_MBps": [w[1] for w in writes],
            "read_MBps": [d["read_MBps"] for d in res["per_detector"]],
            "aggregate_read_MBps": res["aggregate_read_MBps"],
            "latency_p50_ms": statistics.median(lat), "latency_max_ms": lat[-1],
            "pairs": pairs, "replay": replay, "busy_share": busy, "peak_gib": peak / 2**30,
            "store": store, "first_read_hit_rates": [d["first_read_hit_rate"] for d in res["per_detector"]],
            "hit_rates": [d["hit_rate"] for d in res["per_detector"]],
            "truth": res["truth"], "found": res["found"]}


# ------------------------------ step 14: the sky over a federation ------------------------------
FED_NODES = 4  # access nodes over one substrate, as benchmarks/concurrent_throughput.py's degraded-node
FED_EPOCHS = 5  # four frame pairs
FED_REPLICATION = 2
FED_LEASE_S = 0.05
FED_DEAD_AFTER = 10**6  # downed nodes are waited out, never declared dead
FED_KILLED, FED_PARTITIONED = 3, 1
FED_FAULT_EPOCH, FED_RECOVER_EPOCH = 3, 4
FED_RETRY_S = 60.0  # a detector whose node is down retries its pin and reads this long (the benchmark's loop)
FED_WAIT_S = 300.0  # every wait and every join of the step ends by this deadline


def dump_and_fail(msg: str) -> None:
    """Every thread's stack to stderr, then exit 1 at once: a wait that
    outlasts its deadline is a hang, the stacks say where, and the hung
    threads may hold locks that an orderly exit (closing the federation,
    joining its pools) would wait on for ever."""
    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    print(f"chip_smoke: FAILED: {msg} (every thread's stack above)", file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(1)


def join_within(threads, seconds: float, what: str) -> None:
    end = time.perf_counter() + seconds
    for t in threads:
        t.join(max(0.0, end - time.perf_counter()))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        dump_and_fail(f"{what}: {alive} still running after {seconds:.0f} s")


def host_memory() -> dict:
    """This process's resident memory now and at its peak so far, in GiB
    (Linux: ``/proc/self/status`` and ``getrusage``, both in KiB)."""
    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return {"rss_gib": rss / 2**20, "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}


def read_pair(handle, v0: int, v1: int, segs):
    """Pin both frames, read the windows of each, release both pins."""
    before = handle.at(v0)
    try:
        after = handle.at(v1)
    except BaseException:
        before.release()
        raise
    try:
        return before.readv(segs), after.readv(segs)
    finally:
        before.release()
        after.release()


def federated_sky_phase(dev, card, kernels, dep) -> dict:
    """Step 14: the paper's application over the paper's deployment of
    access nodes (§VI): a ``Federation`` of 4 nodes on one substrate (pages
    replicated twice, leases of 50 ms, downed nodes waited out), the
    telescope's session on node 0 (the home node, which runs GC), the
    detector sessions round-robin on nodes 0-3, each with its own
    ``DeviceDetector``. Five epochs. When epoch 3 is published and every
    detector is done with pair (2, 3), node 3 is killed, node 1 partitioned
    from the coordinator, one federated GC pass keeps every frame a detector
    has not finished with, and a cache-less read probes node 1 so its fence
    lands; when epoch 4 is published and each detector on a downed node has
    been refused at least once, both nodes recover. A detector whose node is
    down retries its pins and reads for up to ``FED_RETRY_S``.

    Fails unless every detector's hits equal numpy's on the same bytes,
    region by region; the supernovae found are step 13's rule; the GC pass
    stalled on a lease, a fence landed and pages were freed; every node is
    up at the end; every frame the pass kept reads back, through a fresh
    cache-less session on another node, as the detectors read it; after a
    final pass no node's shared tier holds a collected version; and neither
    kernel ran. Every thread is joined against a deadline."""
    from repro_torch.core import Federation, HealthConfig, ProviderFailed
    from repro_torch.data.detect import DeviceDetector
    from repro_torch.data.sky import SkyLayout, SkySimulator, detect_transients
    from repro_torch.launch.supernovae import MAX_WORKERS, SEED, SN_RATE, THRESHOLD, WATCH_TIMEOUT_S, busy_ms

    layout = SkyLayout(n_regions=dep.n_regions, region_px=dep.region_px, page_size=dep.page_size)
    n, px, n_det = dep.n_regions, dep.region_px, dep.n_detectors
    img_bytes = px * px * 4
    windows = [(r * layout.region_bytes, img_bytes + layout.page_size) for r in range(n)]
    shares = [list(range(k, n, n_det)) for k in range(n_det)]
    node_of = [k % FED_NODES for k in range(n_det)]
    downed = [k for k in range(n_det) if node_of[k] in (FED_KILLED, FED_PARTITIONED)]

    progress = threading.Condition()
    finished = [1] * n_det  # the later epoch of each detector's last finished pair
    refused = [0] * n_det  # pins or reads refused because the detector's node was down
    pairs, failures, mismatches, checked = [], [], [], []
    digests: dict = {}  # (frame epoch, region) -> digest of the window a detector read, and who read it
    detections: dict = {}

    def wait_for(pred, what: str) -> None:
        with progress:
            ok = progress.wait_for(lambda: failures or pred(), timeout=FED_WAIT_S)
        if failures:
            raise failures[0]
        if not ok:
            dump_and_fail(f"federated sky: {what} not within {FED_WAIT_S:.0f} s")

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    fed = Federation(n_nodes=FED_NODES, n_data_providers=dep.n_data_providers,
                     n_metadata_providers=dep.n_metadata_providers, page_replication=FED_REPLICATION,
                     max_workers=MAX_WORKERS, shared_cache_bytes=dep.shared_cache_bytes,
                     lease_seconds=FED_LEASE_S, health=HealthConfig(dead_after=FED_DEAD_AFTER))
    try:
        stall_s = [0.0]
        wait_out = fed._wait_out_lease

        def timed_wait_out(i, epoch):  # the GC pass's time waiting out leases
            t0 = time.perf_counter()
            try:
                return wait_out(i, epoch)
            finally:
                stall_s[0] += time.perf_counter() - t0

        fed._wait_out_lease = timed_wait_out
        sim = SkySimulator(fed.node(0).session(max_inflight_writes=8), layout, seed=SEED, sn_rate=SN_RATE)
        blob = sim.blob_id
        sessions = [fed.node(node_of[k]).session(cache_bytes=0) for k in range(n_det)]
        detectors = [DeviceDetector(len(shares[k]), px, dev) for k in range(n_det)]
        print(f"federated sky: {FED_NODES} nodes, {n} regions of {px}x{px} f32, {layout.page_size >> 10} KiB "
              f"pages x{FED_REPLICATION}, {dep.n_data_providers} + {dep.n_metadata_providers} providers, lease "
              f"{FED_LEASE_S} s; telescope on node 0, {n_det} detectors on nodes {node_of}", flush=True)

        def on_pair(k, epoch, regions, before, after, hits) -> None:
            for f, frame in ((epoch - 1, before), (epoch, after)):
                for r, w in zip(regions, frame):
                    d = hashlib.blake2b(w, digest_size=16).digest()
                    with progress:
                        seen = digests.setdefault((f, r), (d, k))
                    if seen[0] != d:
                        mismatches.append(f"frame {f} region {r}: detector {k} read other bytes than detector "
                                          f"{seen[1]}")
            for r, b, a, got in zip(regions, before, after, hits):
                img_b = b[:img_bytes].view(np.float32).reshape(px, px)
                img_a = a[:img_bytes].view(np.float32).reshape(px, px)
                want = detect_transients(img_b, img_a, threshold=THRESHOLD)
                with progress:
                    checked.append((k, epoch, r))
                    if got != want:
                        mismatches.append(f"detector {k} pair {epoch} region {r}: {got[:3]} != numpy {want[:3]}")

        def detector(k: int) -> None:
            try:
                handle = sessions[k].open(blob)
                watch = handle.watch(start_version=0)
                segs = [windows[r] for r in shares[k]]
                for epoch in range(2, FED_EPOCHS + 1):
                    target = epoch * n
                    while True:
                        v = watch.next(timeout=WATCH_TIMEOUT_S)
                        if v is None:
                            raise RuntimeError(f"detector {k}: the telescope stalled before v{target}")
                        if v >= target:
                            break
                    woke = time.perf_counter()
                    give_up = woke + FED_RETRY_S
                    while True:
                        t0 = time.perf_counter()
                        try:
                            before_w, after_w = read_pair(handle, target - n, target, segs)
                            break
                        except ProviderFailed as e:  # the node is down or cut off from the coordinator
                            with progress:
                                refused[k] += 1
                                progress.notify_all()
                            if time.perf_counter() > give_up:
                                raise RuntimeError(f"detector {k}: node {node_of[k]} not back within "
                                                   f"{FED_RETRY_S:.0f} s") from e
                            time.sleep(0.005)
                    read = time.perf_counter()
                    hits = detectors[k].detect(before_w, after_w, THRESHOLD)
                    on_pair(k, epoch, shares[k], before_w, after_w, hits)
                    with progress:
                        pairs.append(dict(detector=k, node=node_of[k], epoch=epoch, wait_s=t0 - woke,
                                          read_s=read - t0, bytes=2 * sum(size for _, size in segs)))
                        for r, h in zip(shares[k], hits):
                            if h:
                                detections.setdefault(epoch, []).append((r, h))
                        finished[k] = epoch
                        progress.notify_all()
            except Exception as e:  # raised in the telescope's thread
                with progress:
                    failures.append(e)
                    progress.notify_all()

        def touch(i: int) -> None:
            """One cache-less page read through node ``i``: its lease guard
            renews (or fences and rejoins) it, as a detector's read would."""
            probe = fed.node(i).session(cache_bytes=0)
            try:
                probe.open(blob).read(0, layout.page_size)
            finally:
                probe.close()

        on_card = dev.type == "cuda"
        if on_card:
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
        t_start = time.perf_counter()
        threads = [threading.Thread(target=detector, args=(k,), name=f"detector-{k}", daemon=True)
                   for k in range(n_det)]
        for t in threads:
            t.start()
        writes, gc_pass = [], {}
        for epoch in range(1, FED_EPOCHS + 1):
            t0 = time.perf_counter()
            v = sim.observe_epoch_stream()
            t1 = time.perf_counter()
            writes.append(dict(epoch=epoch, version=v, write_s=t1 - t0, bytes=n * layout.region_bytes))
            print(f"  epoch {epoch}: published v{v} in {(t1 - t0) * 1e3:.1f} ms "
                  f"({n * layout.region_bytes / (t1 - t0) / 1e6:.1f} MB/s at replication {FED_REPLICATION})",
                  flush=True)
            if epoch == FED_FAULT_EPOCH:
                wait_for(lambda: min(finished) >= epoch, f"every detector done with pair ({epoch - 1}, {epoch})")
                # both nodes hold live leases when they go down, as mid-pair nodes would
                touch(FED_PARTITIONED)
                touch(FED_KILLED)
                fed.apply_node_fault(FED_KILLED, "kill")
                fed.apply_node_fault(FED_PARTITIONED, "partition")
                keep = [e * n for e in range(min(finished), epoch + 1)]
                stalls0, fences0 = fed.stats.epoch_stalls, fed.stats.lease_fences
                g0 = time.perf_counter()
                nodes_freed, pages_freed = fed.gc(blob, keep_versions=keep)
                gc_ms = (time.perf_counter() - g0) * 1e3
                touch(FED_PARTITIONED)  # past its waited-out lease: the fence lands, then it reads through
                gc_pass = dict(keep=keep, gc_ms=gc_ms, stall_ms=stall_s[0] * 1e3, nodes_freed=nodes_freed,
                               pages_freed=pages_freed, epoch_stalls=fed.stats.epoch_stalls - stalls0,
                               lease_fences=fed.stats.lease_fences - fences0,
                               fenced=fed.node_fenced(FED_PARTITIONED))
                print(f"  node {FED_KILLED} killed, node {FED_PARTITIONED} partitioned; federated GC keeping "
                      f"{keep}: {gc_ms:.1f} ms, {gc_pass['stall_ms']:.1f} ms of it waiting out leases "
                      f"({gc_pass['epoch_stalls']} stalls), freed {nodes_freed} nodes and {pages_freed} pages; "
                      f"probe of node {FED_PARTITIONED}: {gc_pass['lease_fences']} fence", flush=True)
            if epoch == FED_RECOVER_EPOCH:
                wait_for(lambda: all(refused[k] >= 1 for k in downed),
                         f"a refusal for every detector on nodes {FED_KILLED} and {FED_PARTITIONED}")
                fed.apply_node_fault(FED_KILLED, "recover")
                fed.apply_node_fault(FED_PARTITIONED, "recover")
                print(f"  nodes {FED_KILLED} and {FED_PARTITIONED} recovered; refusals so far {refused}", flush=True)
        join_within(threads, FED_WAIT_S, "federated sky detectors")
        if failures:
            raise failures[0]
        wall_s = time.perf_counter() - t_start
        spans = []
        if on_card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            for k, det in enumerate(detectors):
                for epoch, (e0, e1, e2) in enumerate(det.spans, start=2):
                    spans.append(dict(detector=k, epoch=epoch, start_ms=ref.elapsed_time(e0),
                                      copied_ms=ref.elapsed_time(e1), done_ms=ref.elapsed_time(e2)))
            span_ms = ref.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        launches = {"flash_attention": kernels[0].launches, "paged_attention": kernels[1].launches}
        modes = [fed.node_mode(i) for i in range(FED_NODES)]

        # every frame the GC kept, read back through a fresh cache-less session on another node
        readback: list = []

        def read_back(k: int) -> None:
            try:
                other = fed.node((node_of[k] + 1) % FED_NODES).session(cache_bytes=0)
                try:
                    handle = other.open(blob)
                    for v in gc_pass["keep"]:
                        for r in shares[k]:
                            off, size = windows[r]
                            d = hashlib.blake2b(handle.read(off, size, version=v).data,
                                                digest_size=16).digest()
                            with progress:
                                readback.append((v // n, r, d == digests[(v // n, r)][0]))
                finally:
                    other.close()
            except Exception as e:
                with progress:
                    failures.append(e)

        rb = [threading.Thread(target=read_back, args=(k,), name=f"read-back-{k}", daemon=True)
              for k in range(n_det)]
        r0 = time.perf_counter()
        for t in rb:
            t.start()
        join_within(rb, FED_WAIT_S, "federated sky read-back")
        readback_s = time.perf_counter() - r0
        if failures:
            raise failures[0]
        latest = fed.version_manager.latest_published(blob)
        fed.gc(blob, keep_versions=[latest])
        stale = {i: [v for v in fed.node(i).shared_cache.cached_versions(blob) if v != 0 and v < latest]
                 for i in range(FED_NODES)}
        host = host_memory()
        stats = dict(epoch_stalls=fed.stats.epoch_stalls, lease_fences=fed.stats.lease_fences,
                     storage_bytes=fed.node(0).storage_bytes())
        truth = [(sn.region, sn.x, sn.y, sn.ignite_epoch) for sn in sim.supernovae]
    finally:
        fed.close()

    check(sorted({d.tensor_device.type for d in detectors}) == [SKY_DEVICE_TYPE],
          f"detector tensors on {sorted({d.tensor_device.type for d in detectors})}")
    check(not on_card or len(spans) == n_det * (FED_EPOCHS - 1), "a frame pair recorded no device span")
    check(len(checked) == n * (FED_EPOCHS - 1),
          f"{len(checked)} region pairs checked against numpy, expected {n * (FED_EPOCHS - 1)}")
    check(not mismatches, f"federated sky: {mismatches[:4]}")
    want = {(ign + 1, r, x, y) for r, x, y, ign in truth if ign < FED_EPOCHS}
    got = {(e, r, x, y) for e, lst in detections.items() for r, hs in lst for x, y, _ in hs}
    check(got == want and want, f"federated detections {sorted(got)} != ground truth {sorted(want)}")
    check(gc_pass["epoch_stalls"] >= 1 and gc_pass["lease_fences"] >= 1 and gc_pass["fenced"],
          f"the GC pass waited out no lease, or the probe did not fence node {FED_PARTITIONED}: {gc_pass}")
    check(gc_pass["pages_freed"] > 0, f"the federated GC pass freed no pages: {gc_pass}")
    check(all(m == "up" for m in modes), f"nodes not up at the end: {modes}")
    check(len(readback) == len(gc_pass["keep"]) * n and all(ok for *_, ok in readback),
          f"kept frames read back from another node differ: {[x for x in readback if not x[2]][:4]}")
    check(not any(stale.values()), f"collected versions still cached after the final pass: {stale}")
    check(all(c == 0 for c in launches.values()), f"a CUDA kernel ran in the federated sky: {launches}")

    node_read = {}
    for i in range(FED_NODES):
        mine = [p for p in pairs if p["node"] == i]
        read_s = sum(p["read_s"] for p in mine)
        node_read[i] = dict(read_MBps=sum(p["bytes"] for p in mine) / read_s / 1e6,
                            retry_wait_s=sum(p["wait_s"] for p in mine),
                            pair_MBps={p["epoch"]: p["bytes"] / p["read_s"] / 1e6
                                       for p in sorted(mine, key=lambda p: p["epoch"])})
    write_MBps = [w["bytes"] / w["write_s"] / 1e6 for w in writes]
    pair_times = sky_pair_times({"deployment": {"n_regions": n, "region_px": px, "epochs": FED_EPOCHS},
                                 "device_spans": spans})
    busy = busy_ms([(s["start_ms"], s["done_ms"]) for s in spans]) / span_ms if on_card else None
    print(f"federated sky on {card}: {FED_EPOCHS} epochs in {wall_s:.2f} s", flush=True)
    print(f"  telescope write MB/s per epoch at replication {FED_REPLICATION}: {[round(x, 1) for x in write_MBps]}",
          flush=True)
    for i, r in node_read.items():
        print(f"  node {i}'s detectors: read {r['read_MBps']:.1f} MB/s (pairs: "
              f"{ {e: round(x, 1) for e, x in r['pair_MBps'].items()} }), {r['retry_wait_s'] * 1e3:.1f} ms "
              f"waiting for their node", flush=True)
    print(f"  GC pass {gc_pass['gc_ms']:.1f} ms, stall {gc_pass['stall_ms']:.1f} ms; federation: "
          f"{stats['epoch_stalls']} epoch stalls, {stats['lease_fences']} lease fences; refusals {refused}",
          flush=True)
    for epoch, p in pair_times.items():
        times = "not measured" if p["h2d_ms"] is None else f"H2D {p['h2d_ms']:.2f} ms ({p['h2d_GBps']:.2f} GB/s)"
        print(f"  frame pair ({epoch - 1}, {epoch}): {times}, summed over {n_det} detectors' streams", flush=True)
    print(f"  kept frames read back from other nodes in {readback_s:.2f} s; device busy at most "
          f"{'not measured' if busy is None else f'{busy:.2%}'} of the phase on {card}; peak memory "
          f"{peak / 2**30:.2f} GiB; host resident {host['rss_gib']:.2f} GiB (peak {host['peak_rss_gib']:.2f}); "
          f"found {len(got)} of {len(truth)} supernovae; kernel launches {launches}", flush=True)
    return {"launches": launches, "wall_s": wall_s, "write_MBps": write_MBps, "node_read": node_read,
            "gc": gc_pass, "stats": stats, "refused": refused, "pairs": pair_times, "busy_share": busy,
            "peak_gib": peak / 2**30, "host": host, "readback_s": readback_s, "truth": truth,
            "found": sorted({(r, x, y) for _, r, x, y in got})}


# ------------------------------ step 15: serving across ranks ------------------------------
RANKS, RANKS_MODEL = 4, 2  # a (data 2, model 2) mesh: the JAX package's (4, 2) test mesh, halved
SHARD_DEADLINE_S = 600.0  # every rank and every collective of step 15 ends by this deadline
SHARD_MIXTRAL_LAYERS = 4  # of 32: the unsharded oracle runs first, alone on the card
SHARD_MISTRAL_LAYERS = MISTRAL_LAYERS  # of 88: step 10's depth; the oracle's 42.0 GB run alone and are freed
# (d)'s depth: the script's 1200 s leave room for 2 of zamba2-2.7b's 9 groups of 6 Mamba2 layers (a
# cut takes whole groups); at all 54 the script took 1237.1 s on a machine 1.2-1.5x slower in every
# step than another, where it took 883.9 s with (d) at 36 (PERF.md §6)
SHARD_ZAMBA2_LAYERS = 12
# (d)'s compute and KV dtype. zamba2 in bf16 at full depth lands 6.3% (prefill) and 8.1% (decode)
# of max |logit| off the same model in f32, and 4 rows against 8 of one bf16 model move its decode
# logits 4.6% (PERF.md §6): any bf16 rounding difference, the sharded partial sums' among
# them (6.0% and 8.8%), grows past SHARD_LOGITS_TOL through the 54 Mamba2 layers. In f32 the
# sharded run is within 1.4e-5 of the oracle, so the tolerance still tells a wrong block or factor
SHARD_ZAMBA2_COMPUTE = "float32"
# (d'): the same model in bf16 (its config's dtype, the users' path: the tensor-core flash kernel,
# bf16 pools and activations, the SSM states f32), one group deep, where bf16's own spread stays inside
# SHARD_LOGITS_TOL: unsharded, 2.1% (prefill) and 2.3% (decode) off f32, sharded 1.7% and 2.5% off the
# bf16 oracle (PERF.md §6, tools/sharded_precision.py serve --layers 6)
SHARD_ZAMBA2_BF16_LAYERS = 6
# every capacity is the layer's whole token count, as in the smoke configs: the sharded
# MoE counts capacity over each data shard's tokens (the JAX package's rule), so with
# drops the two runs would drop different assignments and compute different functions
SHARD_MOE_CAPACITY = 4.0
# sharded against unsharded logits, max |d| over max |oracle|: each rank's products
# with its weight blocks are partial sums, rounded to bf16 before they are summed over
# the ranks (the MLP's and the attention's outputs over the model axis; in decode also
# q, k, v and the MLP's hidden over the data axis), and the ranks' partial (o, l) are f32
# sums merged in another order than the kernel's own splits: each moves a bf16 value by
# at most one bf16 step where it sits on a rounding boundary. Through the bf16 layers
# such steps grow as in step 7's kernel-vs-oracle comparison, by the same mechanism, so
# its bound LOGITS_TOL holds
SHARD_LOGITS_TOL = LOGITS_TOL
SHARD_DEVICE = "cuda"  # "cpu" rehearses step 15 without a card


def shard_cells() -> tuple:
    """Step 15's cells: (name, config, prompt tokens a row)."""
    from repro_torch.configs import get_config

    mixtral = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=SHARD_MIXTRAL_LAYERS,
                                  capacity_factor=SHARD_MOE_CAPACITY)
    mistral = dataclasses.replace(get_config("mistral-large-123b"), n_layers=SHARD_MISTRAL_LAYERS)
    zamba2 = get_config("zamba2-2.7b")
    zamba2_f32 = dataclasses.replace(zamba2, n_layers=SHARD_ZAMBA2_LAYERS, compute_dtype=SHARD_ZAMBA2_COMPUTE,
                                     kv_cache_dtype=SHARD_ZAMBA2_COMPUTE)
    zamba2_bf16 = dataclasses.replace(zamba2, n_layers=SHARD_ZAMBA2_BF16_LAYERS)
    return (("llama", get_config("llama3_2-1b"), PROMPT), ("mixtral", mixtral, MIXTRAL_PROMPT),
            ("mistral", mistral, PROMPT), ("zamba2", zamba2_f32, PROMPT), ("zamba2_bf16", zamba2_bf16, PROMPT))


def attention_layers(cfg) -> int:
    """The attention layers a prefill or a decode step runs: the hybrid's
    shared block once a group, every layer otherwise."""
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


def layout_state_bytes(cfg, rows: int) -> int:
    """The f32 SSM states (``ssm`` and ``conv``) of ``rows`` rows, from the
    config alone: what ``cache_shardings`` leaves a rank of a batch of
    ``rows`` times the batch shards."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return 4 * cfg.n_layers * rows * (cfg.ssm_heads * cfg.ssm_state * cfg.ssm_headdim + (cfg.ssm_conv - 1) * conv_dim)


def _oracle_decode(model, params, cache, logits, cfg) -> tuple:
    """The unsharded model's greedy decode from ``cache``: the tokens it
    feeds (N_DECODE, B) and its logits (N_DECODE, B, V)."""
    fed, out = [], []
    for _ in range(N_DECODE):
        nxt = logits[:, :cfg.vocab_size].argmax(-1)
        logits, cache = model.decode_step(params, cache, nxt)
        fed.append(nxt)
        out.append(logits)
    return torch.stack(fed), torch.stack(out)


def _recorded_routes(state):
    """The recorded calls' router choices on the CPU; recording off, and the
    first call's tensors let go (they are views of the expert weights)."""
    state["on"], state["first"] = False, None
    return [c.cpu() for c in state["calls"]]


def _rows_prefill(model, params, prompt, cfg) -> tuple:
    """The unsharded prefill one row at a time (a MoE's dispatch buffers
    scale with the tokens of a call), its caches laid out as one batched
    prefill lays them: row b's pages at b * R + p."""
    outs = [model.prefill(params, prompt[b:b + 1]) for b in range(prompt.shape[0])]
    logits = torch.cat([o[0] for o in outs])
    kv = {n: torch.cat([o[1]["kv"][n] for o in outs], dim=1) for n in ("pool_k", "pool_v")}
    R = outs[0][1]["kv"]["tables"].shape[-1]
    kv["tables"] = torch.cat([o[1]["kv"]["tables"] + b * R for b, o in enumerate(outs)], dim=1)
    kv["page_pos"] = torch.cat([o[1]["kv"]["page_pos"] for o in outs], dim=1)
    lengths = torch.cat([o[1]["lengths"] for o in outs])
    return logits, {"kv": kv, "lengths": lengths}


def shard_oracle(cfg, name, prompt_len, dev) -> dict:
    """The unsharded model on this process's card, before the ranks start:
    one prefill of 8 rows of ``prompt_len`` tokens (a MoE's one row at a
    time, its router choices recorded), then N_DECODE greedy decode steps.
    Its logits and tokens come back on the host; its weights are freed."""
    from repro_torch.models.lm import build_model

    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev, dtype=cfg.cdtype())
    out = {"weight_bytes": sum(t.numel() * t.element_size() for t in _leaves(params))}
    prompt = prompt_tokens(cfg, 8, prompt_len, dev)
    if cfg.is_moe:
        routes = record_routes()
        routes["on"], routes["calls"] = True, []
        logits, cache = _rows_prefill(model, params, prompt, cfg)
        out["prefill_routes"] = _recorded_routes(routes)
        routes["on"], routes["calls"] = True, []
        tokens, decoded = _oracle_decode(model, params, cache, logits, cfg)
        out["decode_routes"] = _recorded_routes(routes)
        routes["restore"]()
    else:
        logits, cache = model.prefill(params, prompt)
        tokens, decoded = _oracle_decode(model, params, cache, logits, cfg)
    out.update(prefill=logits.cpu(), tokens=tokens.cpu(), decode=decoded.cpu(),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    del model, params, cache, logits, decoded, prompt
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  oracle {name}: {cfg.n_layers} layers unsharded, {out['weight_bytes'] / 2**30:.2f} GiB of weights, "
          f"prefill of 8 x {prompt_len} and {N_DECODE} greedy steps in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def add_headroom(cache, ai) -> dict:
    """The striped cache a sharded prefill returns, with one decode-headroom
    page a row, as an engine's page allocator hands pages out (a sharded
    prefill keeps none: the JAX package's rule): every stripe grows by
    ceil(B / n) zero pages at its end, row b's new page is the (b // n)-th
    of stripe b % n, and the tables are renumbered to the grown stripes."""
    from repro_torch.parallel import sharding as shd

    kv = cache["kv"]
    L, P_loc, T = kv["pool_k"].shape[:3]
    B, R = kv["tables"].shape[1:]
    n = ai.n_page_shards
    extra = -(-B // n)
    grown = P_loc + extra
    dev = kv["tables"].device
    t = kv["tables"].long()
    b = torch.arange(B, device=dev)
    new = ((b % n) * grown + P_loc + b // n)[None, :, None].expand(L, B, 1)
    out = dict(kv, tables=torch.cat([t // P_loc * grown + t % P_loc, new], dim=-1).to(kv["tables"].dtype),
               page_pos=torch.cat([kv["page_pos"], torch.full((L, B, 1), R * T, dtype=kv["page_pos"].dtype,
                                                               device=dev)], dim=-1))
    for name in shd.POOL_LEAVES:
        if name in kv:
            x = kv[name]
            out[name] = torch.cat([x, torch.zeros((L, extra, *x.shape[2:]), dtype=x.dtype, device=dev)], dim=1)
    return dict(cache, kv=out)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()


def _sharded_decode(model, params, cache, tokens, ai, dev, kernels) -> tuple:
    """N_DECODE decode steps with ``axis_info`` fed ``tokens``, each timed on
    the host clock (synchronised), every count at 0 first; returns (logits
    (N, B, V), step seconds, launches, all-reduces, bytes all-reduced,
    cache)."""
    from repro_torch.parallel import collectives

    torch.cuda.synchronize(dev)
    for k in kernels:
        k.launches = 0
    collectives.stats.update(calls=0, bytes=0)
    out, steps = [], []
    for t in tokens:
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, t, axis_info=ai)
        torch.cuda.synchronize(dev)
        steps.append(time.perf_counter() - t0)
        out.append(logits)
    launches = {k.__name__.removesuffix("_cuda"): k.launches for k in kernels}
    return torch.stack(out), steps, launches, collectives.stats["calls"], collectives.stats["bytes"], cache


def _collective_ms(model, params, cache, tokens, ai, dev, steps: int = 3) -> float:
    """Host time inside the all-reduces of a decode step, each synchronised
    before and after (a replay on a copy of the cache, not the timed run)."""
    import types

    import torch.distributed as dist

    from repro_torch.parallel import collectives

    spent = [0.0]

    def timed(t, op=dist.ReduceOp.SUM, group=None):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=group)
        torch.cuda.synchronize(dev)
        spent[0] += time.perf_counter() - t0

    collectives.dist = types.SimpleNamespace(all_reduce=timed, ReduceOp=dist.ReduceOp)
    try:
        cache = clone_cache(cache)
        for t in tokens[:steps]:
            model.decode_step(params, cache, t, axis_info=ai)
    finally:
        collectives.dist = dist
    return spent[0] * 1e3 / steps


def _logit_errs(got, want) -> torch.Tensor:
    """(steps, rows) max |got - want| over the vocabulary, over each step's max |want|."""
    return (got - want).abs().amax(-1) / want.abs().amax((-2, -1))[:, None]


def _near_tie_misses(got, want) -> list:
    """(step, row, sharded token, oracle token, oracle's top-2 gap over max
    |logit|) wherever the greedy tokens differ."""
    g, w = got.argmax(-1), want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]) / want.abs().amax((-2, -1))[:, None]
    return [(s, b, int(g[s, b]), int(w[s, b]), float(gap[s, b])) for s, b in (g != w).nonzero().tolist()]


def _shard_kernel_check(model, params, cache, token, ai, dev, flush) -> dict:
    """One more decode step on a copy of the cache with layer 0's paged call
    held to the plain version on the same stripe and ``page_offset``
    (step 3's tolerances); rank 1 then times the kernel and the plain
    version on that call's inputs (the other ranks wait) against its byte
    bound."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_plain

    inner, seen = ops.paged_attention_cuda, []

    def wrapped(q, pool_k, pool_v, tables, page_pos, lengths, *, window=None, page_offset=0):
        got = inner(q, pool_k, pool_v, tables, page_pos, lengths, window=window, page_offset=page_offset)
        if not seen:
            args = (q, pool_k, pool_v, tables, page_pos, lengths)
            seen.append((args, window, page_offset, got,
                         paged_attention_plain(*args, window=window, page_offset=page_offset)))
        return got

    ops.paged_attention_cuda = wrapped
    try:
        model.decode_step(params, clone_cache(cache), token, axis_info=ai)
    finally:
        ops.paged_attention_cuda = inner
    args, window, off, got, want = seen[0]
    torch.cuda.synchronize(dev)
    live = want[2].amax(-1) > 0  # rows with a valid token on this stripe
    dead_ok = bool((got[0][~live] == 0).all() and (got[2][~live] == 0).all() and (got[1][~live] == -1e30).all())
    err, scaled, stat_err = paged_errs(got, want, live) if live.any() else (0.0, 0.0, 0.0)
    check(dead_ok and scaled <= TOL_F32["paged_attention"] and stat_err <= 1e-3,
          f"rank {ai.mesh.rank}: the paged kernel on its stripe (page_offset {off}) disagrees with plain: "
          f"{scaled:.3e}, {stat_err:.3e}, empty rows ok {dead_ok}")
    res = {"page_offset": off, "pages_local": args[1].shape[0], "live_rows": int(live.sum()),
           "max_abs_err": err, "scaled_err": scaled, "stat_err": stat_err}
    if flush is not None:  # rank 1
        nbytes, flops = paged_work(args, window, off)
        b_ms, b_by = bound_ms(nbytes, flops, args[0].dtype)
        res.update(ms=time_ms(lambda: inner(*args, window=window, page_offset=off), flush=flush),
                   plain_ms=time_ms(lambda: paged_attention_plain(*args, window=window, page_offset=off),
                                    iters=10, flush=flush),
                   bound_ms=b_ms, bound_by=b_by, bytes=int(nbytes), flops=int(flops))
    dist.barrier()
    return res


def capture_flash() -> dict:
    """Wrap the flash kernel's wrapper so that the first call's inputs,
    options and output are kept in ``state["first"]`` (layer 0 of a
    prefill); ``state["restore"]()`` puts it back. The launch is the
    wrapper's own, counted once."""
    from repro_torch.kernels import ops

    inner = ops.flash_attention_cuda
    state = {"first": None, "restore": lambda: setattr(ops, "flash_attention_cuda", inner)}

    def run(q, k, v, **kw):
        out = inner(q, k, v, **kw)
        if state["first"] is None:
            state["first"] = ((q, k, v), dict(kw), out)
        return out

    ops.flash_attention_cuda = run
    return state


def _shard_flash_check(first, ai, dev, flush, name) -> dict:
    """Layer 0's flash call of a rank's prefill (its rows, its local heads)
    held to the plain version on its first row and first kv head's group
    of q heads (step 3's tolerances; the plain version materialises the
    scores, and four ranks share the card); rank 1 then times the kernel on
    the whole call's inputs, and the plain version row by row, and SDPA
    (row by row where the window needs a boolean mask, which SDPA
    materialises), the other ranks waiting, against the bound."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    (q, k, v), kw, got = first
    B, Sq, H, D = q.shape
    K = k.shape[2]
    want = flash_attention_plain(q[:1, :, :H // K], k[:1, :, :1], v[:1, :, :1], **kw)
    err, rel, ok = flash_ok(got[:1, :, :H // K], want)
    check(ok and bool(torch.isfinite(got).all()),
          f"{name}: rank {ai.mesh.rank}'s flash call on its local heads disagrees with plain: {err:.3e}, {rel}")
    res = {"shape": {"B": B, "Sq": Sq, "Sk": k.shape[1], "H": H, "K": K, "D": D, "window": kw.get("window")},
           "max_abs_err": err, "row_err": rel}
    del want
    if flush is not None:
        torch.cuda.empty_cache()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if kw.get("window"):
            mask = flash_mask(Sq, k.shape[1], causal=True, window=kw["window"], q_start=0, device=dev)
            library = lambda: [sdpa(qt[b:b + 1], kt[b:b + 1], vt[b:b + 1], attn_mask=mask,  # noqa: E731
                                    enable_gqa=H != K) for b in range(B)]
        else:
            library = lambda: sdpa(qt, kt, vt, is_causal=kw.get("causal", True), enable_gqa=H != K)  # noqa: E731
        plain = lambda: [flash_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw) for b in range(B)]  # noqa: E731
        res.update(ms=time_ms(lambda: flash_attention_cuda(q, k, v, **kw), 10, flush=flush),
                   plain_ms=time_ms(plain, 3, flush=flush), library_ms=time_ms(library, 10, flush=flush))
        res.update(zip(("bound_ms", "bound_by"), bound_ms(*flash_work((q, k, v), kw), q.dtype)))
        del qt, kt, vt, library
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def _held_weights(cfg, ai) -> tuple:
    """(the bytes of a rank's weights in the serving layout as an init with
    ``dtype=cfg.cdtype()`` stores them: the leaves used in f32 in f32, the
    embedding table in ``param_dtype``, the rest in the compute dtype; the
    dry run's argument bytes for a prefill of this rank's rows with every
    leaf in the compute dtype), both from the specs alone."""
    from repro_torch.convert import param_shapes
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import _F32_LEAVES
    from repro_torch.parallel import sharding as shd

    def size(path, shape, spec) -> int:
        n = int(np.prod(shape)) // ai.mesh.axes_size([e for e in spec if e is not None])
        item = 4 if path[-1] in _F32_LEAVES else (cfg.pdtype() if path[-1] == "table" else cfg.cdtype()).itemsize
        return n * item

    sizes = []
    shd._map(lambda *a: sizes.append(size(*a)), param_shapes(cfg), shd.jax_specs(cfg, ai))
    rows = MIXTRAL_PROMPT if cfg.is_moe else PROMPT
    return sum(sizes), dryrun.arguments(dataclasses.replace(cfg, param_dtype=cfg.compute_dtype), "prefill", 8, rows, ai)


def _serve_sharded(name, cfg, prompt_len, ai, dev, kernels, flush, tokens) -> dict:
    """One cell on this rank: its blocks of the weights in the serving
    layout (drawn layer by layer, the ranks one after another, each holding
    one whole layer as drawn); a prefill of this rank's 4 of the 8 rows with
    ``axis_info`` (layer 0's flash call held to the plain version), one
    headroom page a row (:func:`add_headroom`), then N_DECODE decode steps
    fed the oracle's ``tokens``. Returns the measures, the logits' digests,
    and the logits the parent holds to the oracle's (rank 0's decode, the
    prefill rows of each data shard's model rank 0)."""
    import torch.distributed as dist

    from repro_torch.launch import cost
    from repro_torch.models.lm import build_model
    from repro_torch.parallel import collectives

    rank = ai.mesh.rank
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    params = None
    t0 = time.perf_counter()
    for r in range(ai.mesh.size):
        if r == rank:
            params = model.init(seed=0, device=dev, dtype=cfg.cdtype(), axis_info=ai)
            torch.cuda.synchronize(dev)
        dist.barrier()
    build_s = time.perf_counter() - t0
    weight_bytes = cost.storage_bytes(params)
    reckoned, dry_args = _held_weights(cfg, ai)
    check(weight_bytes == reckoned, f"{name}: rank {rank} holds {weight_bytes} bytes of weights, "
                                    f"the serving layout {reckoned}")
    prompt = prompt_tokens(cfg, 8, prompt_len, dev).to(torch.int32)
    held_args = weight_bytes + prompt.numel() * prompt.element_size() // ai.n_batch_shards
    routes = record_routes() if cfg.is_moe else None
    if routes is not None:
        routes["on"], routes["calls"] = True, []
    flash = capture_flash()
    for k in kernels:
        k.launches = 0
    collectives.stats.update(calls=0, bytes=0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        p_logits, cache = model.prefill(params, prompt, axis_info=ai)
        torch.cuda.synchronize(dev)
    finally:
        flash["restore"]()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {k.__name__.removesuffix("_cuda"): k.launches for k in kernels}
    prefill_calls, prefill_bytes = collectives.stats["calls"], collectives.stats["bytes"]
    free, total = torch.cuda.mem_get_info(dev)
    prefill_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    res = {"prefill_routes": _recorded_routes(routes)} if routes is not None else {}
    n_attn = attention_layers(cfg)
    check(prefill_launches["flash_attention"] == n_attn and prefill_launches["paged_attention"] == 0,
          f"{name}: rank {rank} launched {prefill_launches} in the sharded prefill")
    held_states = cost.storage_bytes(cache.get("ssm", {}))
    layout_states = layout_state_bytes(cfg, prompt.shape[0] // ai.n_batch_shards)
    check(held_states == layout_states, f"{name}: rank {rank} holds {held_states} bytes of SSM states after the "
                                        f"prefill, the layout {layout_states}")
    res["flash_check"] = _shard_flash_check(flash["first"], ai, dev, flush, name)
    flash["first"] = None
    cache = add_headroom(cache, ai)
    tokens = tokens.to(dev)
    if routes is not None:
        routes["on"], routes["calls"] = True, []
    got, steps, launches, calls, nbytes, cache = _sharded_decode(model, params, cache, tokens, ai, dev, kernels)
    if routes is not None:
        res["decode_routes"] = _recorded_routes(routes)
        routes["restore"]()
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(p_logits).all()),
          f"{name}: non-finite sharded logits on rank {rank}")
    check(launches["paged_attention"] == n_attn * N_DECODE and launches["flash_attention"] == 0,
          f"{name}: rank {rank} launched {launches} in {N_DECODE} sharded decode steps")
    check(cost.storage_bytes(cache.get("ssm", {})) == layout_states,
          f"{name}: rank {rank}'s SSM states after decode are not the layout's {layout_states} bytes")
    res.update(digests=[_digest(g) for g in got], prefill_digest=_digest(p_logits), steps_ms=[s * 1e3 for s in steps],
               prefill_ms=prefill_ms, build_s=build_s, launches=launches, prefill_launches=prefill_launches,
               prefill_allreduces=prefill_calls, prefill_allreduce_bytes=prefill_bytes,
               allreduces_per_step=calls / N_DECODE, allreduce_bytes_per_step=nbytes / N_DECODE,
               collective_ms_per_step=_collective_ms(model, params, cache, tokens, ai, dev),
               pool_pages_local=cache["kv"]["pool_k"].shape[1], weight_bytes=weight_bytes,
               reckoned_weight_bytes=reckoned, prefill_args=held_args, dryrun_prefill_args=dry_args,
               state_bytes=held_states, layout_state_bytes=layout_states,
               state_bytes_after_decode=cost.storage_bytes(cache.get("ssm", {})),
               prefill_peak_gib=prefill_peak, free_after_prefill_gib=free / 2**30, card_gib=total / 2**30)
    res["kernel_check"] = _shard_kernel_check(model, params, cache, tokens[0], ai, dev, flush)
    if rank == 0:
        res["decode"] = got.cpu()
    if ai.mesh.coords()[ai.model_axis] == 0:
        res["prefill"] = p_logits.cpu()
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    res["free_at_end_gib"] = torch.cuda.mem_get_info(dev)[0] / 2**30
    del params, cache, got
    return res


def sharded_rank(ai, chosen, card, oracle_tokens):
    """Step 15 on one rank: (a), (b), (c), (d), (d') in turn; every rank
    returns its measures (see :func:`_serve_sharded`)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = chosen.device
    kernels = (flash_attention_cuda, paged_attention_cuda)
    rank = ai.mesh.rank
    if rank == 0:
        print(f"  {chosen.describe()}; mesh {ai.mesh.shape}, pages over {ai.page_axes}", flush=True)
    out = {"backend": chosen.backend, "device": str(dev)}
    for name, cfg, prompt_len in shard_cells():
        flush = torch.empty(64 << 20, dtype=torch.int32, device=dev) if rank == 1 else None
        t0 = time.perf_counter()
        out[name] = _serve_sharded(name, cfg, prompt_len, ai, dev, kernels, flush, oracle_tokens[name])
        del flush
        gc.collect()
        torch.cuda.empty_cache()
        r = out[name]
        print(f"  [rank {rank}] {name} in {time.perf_counter() - t0:.1f} s: weights {r['weight_bytes'] / 2**30:.3f} "
              f"GiB (the layout's {r['reckoned_weight_bytes'] / 2**30:.3f}); prefill arguments {r['prefill_args']} "
              f"bytes, the dry run's at the compute dtype {r['dryrun_prefill_args']}; prefill {r['prefill_ms']:.1f} ms, peak "
              f"{r['prefill_peak_gib']:.2f} GiB, card free after it {r['free_after_prefill_gib']:.2f} of "
              f"{r['card_gib']:.2f} GiB (mem_get_info); median decode step {statistics.median(r['steps_ms']):.2f} "
              f"ms; peak {r['peak_gib']:.2f} GiB"
              + (f"; SSM states {r['state_bytes']} bytes (the layout's {r['layout_state_bytes']})"
                 if r["layout_state_bytes"] else ""), flush=True)
    return out


def _route_flips(oracle, res) -> tuple:
    """Rows whose token's router choice differs between the sharded run and
    the oracle in some layer: (prefill rows (8,), decode (N_DECODE, 8))
    flags. The sharded prefill routes of data block d come from rank
    (d, model 0), each decode step's from rank 0 (every rank routes every
    row); the oracle's prefill ran one row at a time."""
    L, S = SHARD_MIXTRAL_LAYERS, MIXTRAL_PROMPT
    blocks = [res[d * RANKS_MODEL]["mixtral"] for d in range(RANKS // RANKS_MODEL)]
    rows = 8 // len(blocks)
    prefill = torch.zeros(8, dtype=torch.bool)
    decode = torch.zeros((N_DECODE, 8), dtype=torch.bool)
    mine_d = res[0]["mixtral"]["decode_routes"]
    for b in range(8):
        mine = blocks[b // rows]
        for layer in range(L):
            last = (b % rows) * S + S - 1
            prefill[b] |= bool((oracle["prefill_routes"][b * L + layer][-1] != mine["prefill_routes"][layer][last]).any())
            for s in range(N_DECODE):
                decode[s, b] |= bool((oracle["decode_routes"][s * L + layer][b] != mine_d[s * L + layer][b]).any())
    return prefill, decode


def sharded_phase(card) -> dict:
    """Step 15: serving across ranks, the weights in the serving layout.
    The unsharded oracles first, in this process, one cell at a time, each
    freed; then four ranks of a (data 2, model 2) mesh, spawned, each with
    its own deadline; NCCL when the host has a card for every rank, else
    gloo with every rank on the one card. The parent holds the ranks'
    logits to the oracles'."""
    from repro_torch.launch import mesh as launch_mesh

    dev = torch.device(SHARD_DEVICE)
    t0 = time.perf_counter()
    oracles = {name: shard_oracle(cfg, name, prompt_len, dev) for name, cfg, prompt_len in shard_cells()}
    oracle_s = time.perf_counter() - t0
    plan = launch_mesh.choose_backend(RANKS, 0, SHARD_DEVICE)
    # four processes' caching allocators on one card: segments that grow
    # in place leave less of it stranded between them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    print(f"  backend {plan.backend}, world size {RANKS} ({RANKS // RANKS_MODEL} data x {RANKS_MODEL} model), "
          f"{torch.cuda.device_count()} card(s); {card}", flush=True)
    t1 = time.perf_counter()
    res = launch_mesh.spawn(sharded_rank, RANKS, (card, {n: o["tokens"] for n, o in oracles.items()}),
                            model_parallel=RANKS_MODEL, device=SHARD_DEVICE, timeout_s=SHARD_DEADLINE_S)
    ranks_s = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    check(all(r["backend"] == plan.backend for r in res), f"ranks chose {[r['backend'] for r in res]}")
    out = {"backend": plan.backend, "ranks": RANKS, "cards": torch.cuda.device_count(), "wall_s": wall,
           "oracle_s": oracle_s, "ranks_s": ranks_s, "card": card}
    n_data = RANKS // RANKS_MODEL
    for (name, cfg, prompt_len), tag in zip(shard_cells(), ("a", "b", "c", "d", "d'")):
        rs = [r[name] for r in res]
        oracle = oracles[name]
        for r in rs[1:]:
            check(r["digests"] == rs[0]["digests"], f"{name}: the ranks' decode logits are not bit-equal")
        for i, r in enumerate(rs):
            check(r["prefill_digest"] == rs[i - i % RANKS_MODEL]["prefill_digest"],
                  f"{name}: the prefill logits of one data shard's ranks are not bit-equal")
        prefill = torch.cat([rs[d * RANKS_MODEL]["prefill"] for d in range(n_data)])
        med = [statistics.median(r["steps_ms"]) for r in rs]
        row = {"layers": cfg.n_layers, "prompt": prompt_len, "decode_step_ms": med,
               "collective_ms_per_step": [r["collective_ms_per_step"] for r in rs],
               "allreduces_per_step": rs[0]["allreduces_per_step"],
               "allreduce_bytes_per_step": rs[0]["allreduce_bytes_per_step"],
               "prefill_ms": [r["prefill_ms"] for r in rs], "build_s": [r["build_s"] for r in rs],
               "prefill_allreduces": rs[0]["prefill_allreduces"],
               "prefill_allreduce_bytes": rs[0]["prefill_allreduce_bytes"],
               "launches": [r["launches"] for r in rs], "prefill_launches": [r["prefill_launches"] for r in rs],
               "weight_bytes": [r["weight_bytes"] for r in rs], "oracle_weight_bytes": oracle["weight_bytes"],
               "prefill_args": [r["prefill_args"] for r in rs],
               "dryrun_prefill_args": [r["dryrun_prefill_args"] for r in rs],
               "prefill_peak_gib": [r["prefill_peak_gib"] for r in rs],
               "free_after_prefill_gib": [r["free_after_prefill_gib"] for r in rs],
               "free_at_end_gib": [r["free_at_end_gib"] for r in rs],
               "peak_gib": [r["peak_gib"] for r in rs], "oracle_peak_gib": oracle["peak_gib"],
               "pool_pages_local": rs[0]["pool_pages_local"],
               "state_bytes": [r["state_bytes"] for r in rs], "layout_state_bytes": rs[0]["layout_state_bytes"],
               "state_bytes_after_decode": [r["state_bytes_after_decode"] for r in rs],
               "kernel_check": [r["kernel_check"] for r in rs], "flash_check": [r["flash_check"] for r in rs]}
        perr = _logit_errs(prefill[None], oracle["prefill"][None])[0]
        derr = _logit_errs(rs[0]["decode"], oracle["decode"])
        misses = _near_tie_misses(rs[0]["decode"], oracle["decode"])
        if cfg.is_moe:
            flips_p, flips_d = _route_flips(oracle, res)
            clean_p, clean_d = perr[~flips_p], derr[~flips_d]
            row.update(prefill_err=float(clean_p.max()) if clean_p.numel() else None,
                       max_err=float(clean_d.max()) if clean_d.numel() else None,
                       prefill_flip_rows=int(flips_p.sum()), decode_flip_rows=int(flips_d.sum()))
            check(row["max_err"] is not None, f"{name}: every decode row's routing differs")
            misses = [m for m in misses if not flips_d[m[0], m[1]]]
        else:
            row.update(prefill_err=float(perr.max()), max_err=float(derr.max()), step_errs=derr.amax(-1).tolist())
        print(f"  ({tag}) {name} ({cfg.n_layers} layers, 8 x {prompt_len} tokens): weights a rank "
              f"{[round(b / 2**30, 3) for b in row['weight_bytes']]} GiB of the unsharded "
              f"{oracle['weight_bytes'] / 2**30:.2f} GiB; prefill arguments a rank {row['prefill_args']} bytes, the "
              f"dry run's count with every leaf in the compute dtype {row['dryrun_prefill_args']}; logits vs the unsharded model, max |d| over max "
              f"|oracle|: prefill {row['prefill_err']}, decode {row['max_err']} (tol {SHARD_LOGITS_TOL})"
              + (f"; SSM states a rank {row['state_bytes']} bytes after the prefill, "
                 f"{row['state_bytes_after_decode']} after decode (the layout's {row['layout_state_bytes']} for "
                 f"{8 // n_data} rows)" if row["layout_state_bytes"] else "")
              + (f"; rows whose router choice differs: prefill {row['prefill_flip_rows']} of 8, decode "
                 f"{row['decode_flip_rows']} of {N_DECODE * 8}" if cfg.is_moe else ""), flush=True)
        for err in (row["prefill_err"], row["max_err"]):
            check(err is None or err <= SHARD_LOGITS_TOL, f"{name}: sharded logits disagree with the unsharded model")
        for s, b, got, want, gap in misses:
            print(f"    greedy token differs at step {s}, row {b}: sharded {got}, oracle {want}; the oracle's "
                  f"top-2 gap {gap:.3e} of max |logit|", flush=True)
            check(gap <= SHARD_LOGITS_TOL, f"{name}: a greedy token differs where the oracle is no near-tie")
        row["greedy_misses"] = len(misses)
        print(f"    {name} per rank: prefill {[round(x, 1) for x in row['prefill_ms']]} ms "
              f"({row['prefill_allreduces']} all-reduces, {row['prefill_allreduce_bytes']} bytes); median decode "
              f"step {[round(x, 3) for x in med]} ms (host clock, synchronised); {row['allreduces_per_step']:.0f} "
              f"all-reduces a step, {row['allreduce_bytes_per_step']:.0f} bytes; inside them "
              f"{[round(x, 3) for x in row['collective_ms_per_step']]} ms a step; launches {row['launches']} "
              f"(prefill {row['prefill_launches']}); peak {[round(x, 2) for x in row['peak_gib']]} GiB, card free "
              f"after the prefill {[round(x, 2) for x in row['free_after_prefill_gib']]} GiB; "
              f"{row['pool_pages_local']} pool pages a rank; paged on each stripe vs plain: " + "; ".join(
                  f"offset {k['page_offset']} ({k['live_rows']} rows live) {k['scaled_err']:.2e}/{k['stat_err']:.2e}"
                  for k in row["kernel_check"]) + "; flash on each rank's heads vs plain: " + "; ".join(
                  f"{f['max_abs_err']:.2e}/{f['row_err']}" for f in row["flash_check"]) + f"; {card}", flush=True)
        fl = row["flash_check"][1]
        print(f"    flash on rank 1's local heads {fl['shape']}: kernel {fl['ms']:.4f} ms, plain {fl['plain_ms']:.4f} "
              f"ms, SDPA {fl['library_ms']:.4f} ms, bound {fl['bound_ms']:.5f} ms ({fl['bound_by']}); {card}",
              flush=True)
        out[name] = row
    shard = res[1]["llama"]["kernel_check"]
    print(f"  paged kernel on rank 1's stripe (llama, page_offset {shard['page_offset']}, "
          f"{shard['pages_local']} pages): {shard['ms']:.4f} ms, plain {shard['plain_ms']:.4f} ms, bound "
          f"{shard['bound_ms']:.5f} ms ({shard['bound_by']}: {shard['bytes']} bytes); {card}", flush=True)
    out["paged_shard"] = shard
    print(f"  step 15 in {wall:.1f} s ({oracle_s:.1f} s of it the oracles)", flush=True)
    return out


# ------------------------------ step 16: training across ranks ------------------------------
TRAIN_SHARD_LAYERS = 16  # all of llama3_2-1b's: in the JAX package's layout a rank holds 374.6 M of its
# 1235.8 M parameters (the blocks over both axes, the table over model), f32 params, AdamW moments and
# gradients about 6.0 GB, beside one 2048-token row's activations; four ranks share the card
TRAIN_SHARD_ROWS, TRAIN_SHARD_STEPS = 4, 2  # 4 x 2048 tokens a step; grad_accum 4 over 2 data shards: A = 2
POD_MEAN_LAYERS = 2  # (c)'s leaf shapes: llama3_2-1b cut to 2 layers (four f32 trees of them a rank)
MOE_TRAIN_LAYERS = 1  # of mixtral-8x7b's 32: one layer's f32 experts are 5.6 GB, 2.8 GB a model rank
MOE_TRAIN_ROWS = 2  # 2 x 2048 tokens, one row a data shard (A = 1): a rank's state is about 14 GB
MOE_TRAIN_CAPACITY = 4.0  # as step 15 (b): every assignment gets a slot, so no run drops any
# the compute dtype of step 16's cells. In the JAX layout a rank's products with its weight blocks
# over the model axis are partial sums, each rounded to the compute dtype before they are summed:
# in bf16 the 16-layer step's leaves then land 2.0-3.4% (of a leaf's largest) off the unsharded
# oracle, whose own spread over another microbatch split is 0.5-1.0%, and mixtral's routes flip
# (24% on its table), so a wrong factor or block below a few percent would not show. In f32 both
# cells agree with their oracles to about 1e-5 (PERF.md §6, tools/sharded_precision.py train)
TRAIN_SHARD_COMPUTE = "float32"
# the sharded loss against the unsharded (or, for the MoE, the shard-by-shard single-device)
# oracle, relative; a leaf's gradient (and moment), max |d| over max |oracle|
TRAIN_SHARD_LOSS_TOL = 2e-3
TRAIN_SHARD_GRAD_TOL = 2e-2
TRAIN_SHARD_DEADLINE_S = 600.0  # every rank and every collective of step 16 ends by this deadline
POD_EF_STEPS, POD_EF_VALUES, POD_EF_RTOL = 50, (0.3017, 0.2), 2e-3  # tests/test_grad_compress.py's rule
TRAIN_SHARD_DIR = ROOT / "build" / "train_sharded"  # the oracles' gradients, read by the ranks, then removed
TRAIN_SHARD_DEVICE = "cuda"  # "cpu" rehearses step 16 without a card


def device_digest(t: torch.Tensor, chunk: int = 1 << 24) -> tuple:
    """Two integer sums of a tensor's bit patterns (plain and weighted by
    position), on the device, a chunk at a time: equal tensors give equal
    digests, and a differing bit changes them."""
    words = t.detach().contiguous().reshape(-1).view(torch.int32 if t.element_size() == 4 else torch.int16)
    plain = weighted = 0
    for a in range(0, words.numel(), chunk):
        part = words[a:a + chunk].long()
        w = torch.arange(a, a + part.numel(), device=part.device) % 65521 + 1
        plain += int(part.sum())
        weighted += int((part * w).sum())
    return plain, weighted


def _state_digests(params, opt_state) -> list:
    return [device_digest(t) for t in _paths(params).values()] + [
        device_digest(t) for part in ("m", "v") for t in _paths(opt_state[part]).values()]


def _leaf_err(got: torch.Tensor, want: torch.Tensor, dev) -> float:
    """max |got - want| over max |want|, on ``dev``."""
    got, want = got.to(dev, torch.float32), want.to(dev, torch.float32)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _pipeline_batches(vocab: int, rows: int, steps: int, seed: int = 0) -> list:
    """``steps`` global batches of ``rows`` x 2048 tokens that
    ``TokenPipeline`` reads from the bigram corpus in a ``Cluster`` blob."""
    from repro_torch.core import Cluster
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline, write_token_corpus
    from repro_torch.launch.train import bigram_corpus, corpus_tokens

    cluster = Cluster(n_data_providers=4, n_metadata_providers=4)
    try:
        n = corpus_tokens(rows, TRAIN_SEQ)
        pipe = TokenPipeline(write_token_corpus(cluster.session(), bigram_corpus(vocab, n, np.random.default_rng(seed))),
                             n, PipelineConfig(batch_per_rank=rows, seq_len=TRAIN_SEQ, n_ranks=1, rank=0, seed=seed))
        return [pipe.batch_at(s) for s in range(steps)]
    finally:
        cluster.close()


def _train_shard_configs() -> tuple:
    from repro_torch.configs import get_config

    llama = dataclasses.replace(get_config("llama3_2-1b"), n_layers=TRAIN_SHARD_LAYERS,
                                compute_dtype=TRAIN_SHARD_COMPUTE)
    mixtral = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=MOE_TRAIN_LAYERS,
                                  capacity_factor=MOE_TRAIN_CAPACITY, compute_dtype=TRAIN_SHARD_COMPUTE)
    return llama, mixtral


def _shard_opt_cfg():
    from repro_torch.train import AdamWConfig

    return AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_SHARD_STEPS, warmup_steps=1)


class _GradTap:
    """Wraps the trainer's AdamW so that each step's gradients (the f32
    tensors the update reads) are kept; ``restore()`` puts it back."""

    def __init__(self):
        from repro_torch.train import trainer

        self.trainer, self.inner, self.grads = trainer, trainer.adamw_update, []
        trainer.adamw_update = self

    def __call__(self, params, grads, state, cfg, gnorm=None):
        self.grads.append(grads)
        return self.inner(params, grads, state, cfg, gnorm=gnorm)

    def restore(self):
        self.trainer.adamw_update = self.inner


def llama_train_oracle(cfg, dev, batches, path) -> list:
    """Step 16 (a)'s oracle: the same steps unsharded, on this process's
    card, in the sharded run's microbatches; the first step's gradients and
    the moments after it saved to ``path`` on the host; returns the losses."""
    from repro_torch.models.lm import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.trainer import n_microbatches

    cfg = dataclasses.replace(cfg, grad_accum=n_microbatches(len(batches[0]["labels"]), cfg.grad_accum,
                                                             RANKS // RANKS_MODEL))
    model = build_model(cfg)
    params, opt_state = init_train_state(model, seed=0, device=dev)
    step = make_train_step(model, cfg, _shard_opt_cfg())
    tap = _GradTap()
    losses = []
    try:
        for i, b in enumerate(batches):
            params, opt_state, metrics = step(params, opt_state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            losses.append(float(metrics["loss"]))
            if i == 0:  # the moments after step 1 are a fixed function of the gradients
                saved = {"grads1": {"/".join(p): t.cpu() for p, t in _paths(tap.grads[0]).items()}}
                saved.update({part: {"/".join(p): t.cpu() for p, t in _paths(opt_state[part]).items()}
                              for part in ("m", "v")})
            tap.grads.clear()
    finally:
        tap.restore()
    torch.save(saved, path)
    return losses


def moe_train_oracle(cfg, dev, batch, path) -> float:
    """Step 16 (b)'s oracle, the JAX package's sharded rule on one device:
    the single-device loss of each data shard's rows of each microbatch
    (its own capacity and aux), the shares averaged over the shards and the
    microbatches as the ranks sum them; the gradients saved to ``path``."""
    from repro_torch.models.lm import build_model
    from repro_torch.train.trainer import _requires_grad, n_microbatches
    from repro_torch.train.optimizer import leaves

    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    n_data = RANKS // RANKS_MODEL
    A = n_microbatches(MOE_TRAIN_ROWS, cfg.grad_accum, n_data)
    rows = MOE_TRAIN_ROWS // (A * n_data)
    names = ["/".join(p) for p in _paths(params)]
    total, loss = None, 0.0
    for a in range(A):
        for i in range(n_data):
            lo = (a * n_data + i) * rows
            part = {k: torch.from_numpy(v[lo:lo + rows]).to(dev) for k, v in batch.items()}
            tracked = _requires_grad(params)
            l, _ = model.train_loss(tracked, part)
            g = torch.autograd.grad(l, leaves(tracked))
            loss += float(l.detach()) / (A * n_data)
            total = [x.float() for x in g] if total is None else [t.add_(x.float()) for t, x in zip(total, g)]
            del g, tracked
    k = torch.full((), A * n_data, dtype=torch.float32, device=dev)
    torch.save({"grads1": {n: (t / k).cpu() for n, t in zip(names, total)}}, path)
    return loss


def _timed_reduce(dev, out: dict):
    """Wrap ``trainer.reduce_gradients``: each call's host ms, synchronised
    before and after, appended to ``out["ms"]``, and its all-reduces and
    their bytes (``collectives.stats`` before and after) added to
    ``out["calls"]`` and ``out["bytes"]``."""
    from repro_torch.parallel import collectives
    from repro_torch.train import trainer

    inner = trainer.reduce_gradients

    def run(grads, axis_info, held):
        before = dict(collectives.stats)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        inner(grads, axis_info, held)
        torch.cuda.synchronize(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("calls", "bytes"):
            out[k] += collectives.stats[k] - before[k]

    trainer.reduce_gradients = run
    return lambda: setattr(trainer, "reduce_gradients", inner)


def _sharded_train_cell(cfg, ai, dev, batches, oracle_path, in_turn: bool) -> dict:
    """Train ``cfg`` across the ranks, in the JAX package's layout, each
    rank on its ``batch_shardings`` block of the global ``batches`` (its
    rows alone): each step's host ms (synchronised), loss, gradient
    all-reduce calls, bytes and ms, the state's digests after each step,
    the memory after the first step, the bytes of the state and batch the
    rank holds beside the dry run's count, and each leaf's error against
    the oracle's first-step gradients (and the moments after that step,
    when saved)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.models.lm import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import adamw_init, make_train_step, trainer

    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    for r in range(ai.mesh.size if in_turn else 1):  # ranks in turn: each draws one layer whole at a time
        if not in_turn or r == ai.mesh.rank:
            params = model.init(seed=0, device=dev, axis_info=ai)  # the layout's blocks
            gc.collect()
            torch.cuda.empty_cache()
        if in_turn:
            dist.barrier()
    specs = _paths(shd.held_specs(params, cfg, ai))
    opt_state = adamw_init(params)
    step = make_train_step(model, cfg, _shard_opt_cfg(), axis_info=ai)
    oracle = torch.load(oracle_path, mmap=True)  # read leaf by leaf after the steps
    reduce = {"ms": [], "calls": 0, "bytes": 0}
    untime = _timed_reduce(dev, reduce)
    tap = _GradTap()
    out = {"steps_ms": [], "losses": [], "digests": [], "grad_calls": [], "grad_bytes": []}
    try:
        for i, whole in enumerate(batches):
            rows = len(whole["labels"])
            b = {k: shd.shard_leaf(v, spec, ai) for (k, v), spec in
                 zip(whole.items(), shd.batch_shardings(whole, cfg, ai).values())}
            reduce.update(calls=0, bytes=0)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()},
                                              rows)
            torch.cuda.synchronize(dev)
            out["steps_ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(float(metrics["loss"]))
            out["grad_calls"].append(reduce["calls"])
            out["grad_bytes"].append(reduce["bytes"])
            if i == 0:
                held = [*_paths(params).values(), *_paths(opt_state).values()]
                out["state_bytes"] = sum(t.numel() * t.element_size() for t in held) + sum(
                    v.nbytes for v in b.values())  # the rank's rows of the batch
                free, total = torch.cuda.mem_get_info(dev)
                out.update(peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card_free_gib=free / 2**30,
                           card_total_gib=total / 2**30)
                # the card holds the state only; the moments after step 1 are a fixed function of the gradients
                mine = {"grads1": {p: t.cpu() for p, t in _paths(tap.grads[0]).items()}}
                mine.update({part: {p: t.cpu() for p, t in _paths(opt_state[part]).items()}
                             for part in ("m", "v") if part in oracle})
            tap.grads.clear()
            out["digests"].append(_state_digests(params, opt_state))
    finally:
        tap.restore()
        untime()
    out["reduce_ms"] = reduce["ms"]
    out["dry_run_bytes"] = dryrun.arguments(cfg, "train", len(batches[0]["labels"]), TRAIN_SEQ, ai)
    leaf_errs = {part: {"/".join(p): _leaf_err(t, shd.shard_leaf(oracle[part]["/".join(p)], specs[p], ai), dev)
                        for p, t in mine[part].items()} for part in mine}
    errs = {part: max(e.values()) for part, e in leaf_errs.items()}
    worst = {part: max(e, key=e.get) for part, e in leaf_errs.items()}
    out.update(errs=errs, worst_leaf=worst, leaf_errs=leaf_errs)
    print(f"  [rank {ai.mesh.rank}] steps {[round(x, 1) for x in out['steps_ms']]} ms, losses {out['losses']}, "
          f"gradient all-reduce {[round(x, 1) for x in out['reduce_ms']]} ms, state and batch {out['state_bytes']} "
          f"bytes (dry run {out['dry_run_bytes']}), peak {out['peak_gib']:.2f} GiB, card free "
          f"{out['card_free_gib']:.2f} GiB, errors {errs} (worst {worst})", flush=True)
    del params, opt_state, mine, oracle
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pod_mean_cell(cfg, dev) -> dict:
    """Step 16 (c): ``compressed_pod_mean`` over a (pod 2, data 2) mesh of
    the same four ranks, on a gradient tree with ``cfg``'s leaf shapes whose
    values differ between the pods (the same within a pod, as after the
    data-parallel sum)."""
    from repro_torch.convert import param_shapes
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.train.grad_compress import compressed_pod_mean, ef_init

    ai = launch_mesh.make_axis_info(launch_mesh.make_mesh((2, 2, 1), ("pod", "data", "model")))
    pod = ai.mesh.coords()["pod"]
    shapes = list(_paths(param_shapes(cfg)).items())

    def grad(p: int, j: int) -> torch.Tensor:
        gen = torch.Generator(device=dev).manual_seed(1000 * p + j)
        return torch.randn(shapes[j][1], generator=gen, device=dev) * (1e-3 * (1 + j % 5))

    g = {"/".join(path): grad(pod, j) for j, (path, _) in enumerate(shapes)}
    err = ef_init(g)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mean, new_err = compressed_pod_mean(g, err, ai, None)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    inv127 = torch.full((), 1 / 127, dtype=torch.float32, device=dev)
    worst_step, residual_exact = 0.0, True
    for j, (path, _) in enumerate(shapes):
        name = "/".join(path)
        g0, g1 = grad(0, j), grad(1, j)
        scale = torch.maximum(g0.abs().max(), g1.abs().max()) * inv127
        mine = g0 if pod == 0 else g1
        q = torch.clamp(torch.round(mine / scale), -127, 127)
        residual_exact &= bool(torch.equal(_rounded_once(mine, q, scale), new_err[name]))
        worst_step = max(worst_step, float(((mean[name] - (g0 + g1) / 2).abs().max() / scale)))
        del g0, g1, q
    digests = [device_digest(t) for t in _paths(mean).values()]
    err_digests = [device_digest(t) for t in _paths(new_err).values()]
    nbytes = sum(t.numel() for t in g.values()) * 4
    del g, err, mean, new_err
    gc.collect()
    torch.cuda.empty_cache()
    # error feedback over steps: a constant gradient a pod, the mean of the outputs
    c = POD_EF_VALUES[pod]
    small = {"a": torch.full((2048,), c, device=dev), "b": torch.full((4096,), 2 * c, device=dev)}
    e, outs = ef_init(small), []
    for _ in range(POD_EF_STEPS):
        m, e = compressed_pod_mean(small, e, ai, None)
        outs.append(m)
    ef = {k: float((torch.stack([o[k] for o in outs]).mean(0) / (1 if k == "a" else 2)).sub(
        sum(POD_EF_VALUES) / 2).abs().max() / (sum(POD_EF_VALUES) / 2)) for k in small}
    return {"ms": ms, "elements": nbytes // 4, "max_err_in_steps": worst_step, "residual_exact": residual_exact,
            "digests": digests, "err_digests": err_digests, "pod": pod, "ef_rel_err": max(ef.values())}


def _rounded_once(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
    """``x - q * scale`` rounded once to f32 (exact in f64: ``q * scale``
    has at most 31 significant bits, and ``x`` lies within a step of it),
    a chunk at a time."""
    out = torch.empty_like(x).reshape(-1)
    xf, qf, s = x.reshape(-1), q.reshape(-1), scale.double()
    for a in range(0, xf.numel(), chunk):
        out[a:a + chunk] = (xf[a:a + chunk].double() - qf[a:a + chunk].double() * s).float()
    return out.view(x.shape)


def _launcher_cell(dev) -> dict:
    """Step 16 (d): ``repro_torch.launch.train.train`` with
    ``model_parallel=2`` over the four ranks, on the smoke config."""
    from repro_torch.core import Cluster
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch.train import state_specs, train
    from repro_torch.parallel import sharding as shd
    from repro_torch.storage.checkpoint import restore_onto_mesh

    cfg = get_config("llama3_2-1b").smoke()
    cluster = Cluster(n_data_providers=4, n_metadata_providers=4, shared_cache_bytes=0)
    try:
        run = train("llama3_2-1b", smoke=True, steps=30, batch=8, seq=64, checkpoint_every=10, lr=1e-2,
                    model_parallel=2, session=cluster.session(), device=dev)
        ai2 = launch_mesh.make_axis_info(launch_mesh.make_mesh((4, 1), ("data", "model")))
        state = restore_onto_mesh(run["checkpointer"], state_specs(cfg, ai2), ai2, step=30, device=dev)
        final = shd.gather_params(run["params"], cfg, run["axis_info"])
        got = shd.gather_params(state["params"], cfg, ai2)  # the (data 4, model 1) blocks, regathered
        restored = all(bits_equal(a, b) for a, b in zip(_paths(got).values(), _paths(final).values()))
        restored &= all(bits_equal(a, b) for a, b in zip(_paths(shd.gather_params(state["opt"]["m"], cfg, ai2)).values(),
                                                         _paths(shd.gather_params(run["opt_state"]["m"], cfg,
                                                                                  run["axis_info"])).values()))
    finally:
        cluster.close()
    losses = run["losses"]
    kw = dict(smoke=True, steps=20, batch=4, seq=64, checkpoint_every=10, seed=3, model_parallel=2, device=dev)
    a = train("llama3_2-1b", **kw)
    cluster = Cluster(n_data_providers=4, n_metadata_providers=4, shared_cache_bytes=0)
    try:
        session = cluster.session()
        crashed = False
        try:
            train("llama3_2-1b", session=session, fail_at_step=14, **kw)
        except RuntimeError as e:
            crashed = "injected failure" in str(e)
        b = train("llama3_2-1b", session=session, restore=True, **kw)
    finally:
        cluster.close()
    return {"loss_drop": float(np.mean(losses[:5]) - np.mean(losses[-5:])), "losses": losses,
            "restored_bit_equal": restored, "crashed": crashed,
            "resume_rel": abs(a["losses"][-1] - b["losses"][-1]) / abs(a["losses"][-1])}


def train_sharded_rank(ai, chosen, card, batches, oracle_paths):
    """Step 16 on one rank: (a), (b), (c), (d) in turn."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, rank = chosen.device, ai.mesh.rank
    kernels = (flash_attention_cuda, paged_attention_cuda)
    for k in kernels:
        k.launches = 0
    llama, mixtral = _train_shard_configs()
    out = {"backend": chosen.backend}
    for name, run in (("llama", lambda: _sharded_train_cell(llama, ai, dev, batches["llama"], oracle_paths["llama"],
                                                             in_turn=False)),
                      ("mixtral", lambda: _sharded_train_cell(mixtral, ai, dev, batches["mixtral"],
                                                               oracle_paths["mixtral"], in_turn=True)),
                      ("pod_mean", lambda: _pod_mean_cell(dataclasses.replace(llama, n_layers=POD_MEAN_LAYERS), dev)),
                      ("launcher", lambda: _launcher_cell(dev))):
        t0 = time.perf_counter()
        out[name] = run()
        out[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            print(f"  [rank 0] {name} in {out[name]['seconds']:.1f} s", flush=True)
    out["launches"] = {k.__name__.removesuffix("_cuda"): k.launches for k in kernels}
    return out


def train_sharded_phase(card) -> dict:
    """Step 16: training across ranks. The oracles run first, in this
    process, and are freed; then four spawned ranks of a (data 2, model 2)
    mesh (gloo: NCCL refuses two ranks on one card) run (a)-(d)."""
    import shutil

    from repro_torch.launch import mesh as launch_mesh

    t_start = time.perf_counter()
    dev = torch.device(TRAIN_SHARD_DEVICE)
    llama, mixtral = _train_shard_configs()
    TRAIN_SHARD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {"llama": str(TRAIN_SHARD_DIR / "llama.pt"), "mixtral": str(TRAIN_SHARD_DIR / "mixtral.pt")}
    print(f"  disk free beside the checkout: {shutil.disk_usage(TRAIN_SHARD_DIR).free / 2**30:.1f} GiB", flush=True)
    batches = {"llama": _pipeline_batches(llama.vocab_size, TRAIN_SHARD_ROWS, TRAIN_SHARD_STEPS),
               "mixtral": _pipeline_batches(mixtral.vocab_size, MOE_TRAIN_ROWS, 1)}
    try:
        t0 = time.perf_counter()
        oracle_losses = llama_train_oracle(llama, dev, batches["llama"], paths["llama"])
        gc.collect()
        torch.cuda.empty_cache()
        moe_loss = moe_train_oracle(mixtral, dev, batches["mixtral"][0], paths["mixtral"])
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  oracles in {time.perf_counter() - t0:.1f} s: llama3_2-1b ({llama.n_layers} layers) unsharded "
              f"losses {oracle_losses}; mixtral-8x7b ({mixtral.n_layers} layer) shard by shard loss {moe_loss:.6f}; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated here", flush=True)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        t0 = time.perf_counter()
        res = launch_mesh.spawn(train_sharded_rank, RANKS, (card, batches, paths), model_parallel=RANKS_MODEL,
                                device=TRAIN_SHARD_DEVICE, timeout_s=TRAIN_SHARD_DEADLINE_S)
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(TRAIN_SHARD_DIR, ignore_errors=True)
    out = {"backend": res[0]["backend"], "spawn_s": spawn_s, "card": card}
    for name, oracle in (("llama", oracle_losses), ("mixtral", [moe_loss])):
        rs = [r[name] for r in res]
        replica = _first_replicas(name)
        for i in range(len(rs[0]["digests"])):  # each leaf as the first rank's that holds the same block
            for rank in range(1, RANKS):
                for j, mine in enumerate(rs[rank]["digests"][i]):
                    check(mine == rs[replica[j][rank]]["digests"][i][j],
                          f"step 16 {name}: rank {rank}'s state after step {i + 1} differs from its replicas")
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"], oracle)]
        row = {"steps_ms": [r["steps_ms"] for r in rs], "median_step_ms": [statistics.median(r["steps_ms"]) for r in rs],
               "losses": rs[0]["losses"], "oracle_losses": oracle, "loss_rel": loss_rel,
               "grad_allreduce_calls": rs[0]["grad_calls"], "grad_allreduce_bytes": rs[0]["grad_bytes"],
               "grad_allreduce_ms": [statistics.median(r["reduce_ms"]) for r in rs],
               "peak_gib": [r["peak_gib"] for r in rs], "card_free_gib": [r["card_free_gib"] for r in rs],
               "errs": [r["errs"] for r in rs], "worst_leaf": rs[0]["worst_leaf"],
               "state_bytes": [r["state_bytes"] for r in rs], "dry_run_bytes": [r["dry_run_bytes"] for r in rs]}
        tag = "a" if name == "llama" else "b"
        print(f"  ({tag}) {name}: losses {row['losses']} vs oracle {oracle} (relative {max(loss_rel):.2e}, tol "
              f"{TRAIN_SHARD_LOSS_TOL}); worst leaf vs oracle, over its max: "
              + "; ".join(f"rank {i} " + ", ".join(f"{k} {v:.2e}" for k, v in e.items()) for i, e in enumerate(row["errs"]))
              + f" (tol {TRAIN_SHARD_GRAD_TOL}); replicas bit-equal after every step", flush=True)
        print(f"    median step {[round(x, 1) for x in row['median_step_ms']]} ms (host clock, synchronised); "
              f"gradient all-reduce {row['grad_allreduce_calls']} calls, {row['grad_allreduce_bytes']} bytes, "
              f"{[round(x, 1) for x in row['grad_allreduce_ms']]} ms a step; peak {[round(x, 2) for x in row['peak_gib']]} "
              f"GiB a rank, card free after step 1 {[round(x, 2) for x in row['card_free_gib']]} GiB "
              f"(mem_get_info); state and batch a rank {row['state_bytes']} bytes, the dry run's "
              f"{row['dry_run_bytes']}; {card}", flush=True)
        check(max(loss_rel) <= TRAIN_SHARD_LOSS_TOL, f"step 16 {name}: sharded loss off the oracle: {loss_rel}")
        if name == "llama":  # the router's dtype is f32 in a model whose other leaves are not: (a) only
            check(row["state_bytes"] == row["dry_run_bytes"],
                  f"step 16 (a): the ranks hold {row['state_bytes']} bytes, the dry run counts {row['dry_run_bytes']}")
        check(all(max(e.values()) <= TRAIN_SHARD_GRAD_TOL for e in row["errs"]),
              f"step 16 {name}: gradients or moments off the oracle: {row['errs']}")
        out[name] = row
    pods = [r["pod_mean"] for r in res]
    out["pod_mean"] = {"ms": [p["ms"] for p in pods], "elements": pods[0]["elements"],
                       "max_err_in_steps": max(p["max_err_in_steps"] for p in pods),
                       "ef_rel_err": max(p["ef_rel_err"] for p in pods)}
    print(f"  (c) compressed_pod_mean over (pod 2, data 2), {pods[0]['elements']} elements in "
          f"{len(pods[0]['digests'])} leaves: {[round(p['ms'], 1) for p in pods]} ms; mean within "
          f"{out['pod_mean']['max_err_in_steps']:.3f} quantization steps of the exact pod mean (at most 1); "
          f"residual exact: {[p['residual_exact'] for p in pods]}; {POD_EF_STEPS} EF steps: relative error "
          f"{out['pod_mean']['ef_rel_err']:.2e} (tol {POD_EF_RTOL}); {card}", flush=True)
    check(out["pod_mean"]["max_err_in_steps"] <= 1.0, "step 16 (c): a pod mean is off by more than one step")
    check(all(p["residual_exact"] for p in pods), "step 16 (c): a residual is not g + e - q * scale")
    check(all(p["digests"] == pods[0]["digests"] for p in pods), "step 16 (c): the means differ across ranks")
    check(all(p["err_digests"] == q["err_digests"] for p in pods for q in pods if p["pod"] == q["pod"]),
          "step 16 (c): the residuals differ within a pod")
    check(out["pod_mean"]["ef_rel_err"] <= POD_EF_RTOL, "step 16 (c): error feedback did not converge")
    ls = [r["launcher"] for r in res]
    out["launcher"] = {k: ls[0][k] for k in ("loss_drop", "resume_rel", "restored_bit_equal")}
    print(f"  (d) launcher, model_parallel 2 over 4 ranks: loss drop over 30 smoke steps {ls[0]['loss_drop']:.4f} "
          f"(at least 0.5); crash at step 14 and rerun: final loss relative {ls[0]['resume_rel']:.2e} (tol 1e-4); "
          f"step-30 checkpoint onto (data 4, model 1) bit-equal: {[x['restored_bit_equal'] for x in ls]}", flush=True)
    check(all(x["losses"] == ls[0]["losses"] for x in ls), "step 16 (d): the ranks' losses differ")
    check(ls[0]["loss_drop"] >= 0.5, f"step 16 (d): the loss did not fall: {ls[0]['losses']}")
    check(all(x["crashed"] for x in ls), "step 16 (d): the injected failure did not raise on every rank")
    check(all(x["resume_rel"] <= 1e-4 for x in ls), "step 16 (d): the rerun ends off the uninterrupted run")
    check(all(x["restored_bit_equal"] for x in ls), "step 16 (d): the restored state differs from the final")
    out["launches"] = [r["launches"] for r in res]
    check(all(n == 0 for r in res for n in r["launches"].values()), f"a kernel ran in step 16: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_start
    out["rank_seconds"] = {k: [r[k]["seconds"] for r in res] for k in ("llama", "mixtral", "pod_mean", "launcher")}
    print(f"  step 16 in {out['seconds']:.1f} s ({card})", flush=True)
    return out


def _first_replicas(name: str) -> list:
    """For each digest of a cell's state (params, then m, then v, leaves in
    order), the first rank that holds the same block as each rank."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.axisinfo import AxisInfo, Mesh

    llama, mixtral = _train_shard_configs()
    cfg = llama if name == "llama" else mixtral
    mesh = Mesh((RANKS // RANKS_MODEL, RANKS_MODEL), ("data", "model"))
    out = []
    for spec in _paths(shd.jax_specs(cfg, AxisInfo(mesh, ("data",)))).values():
        axes = [(e,) if isinstance(e, str) else e for e in spec if e is not None]
        key = [tuple(mesh.axes_index(a, r) for a in axes) for r in range(mesh.size)]
        out.append([key.index(k) for k in key])
    return out * 3


# ------------------------------ step 17: the dry run against the card ------------------------------
DRYRUN_CLI_SHAPES = ("decode_32k", "train_4k")  # llama3_2-1b on the 16 x 16 mesh of fake ranks
DRYRUN_BUDGET_S = 60.0  # what step 17 should take; the CLI's cells are killed at twice that
ALLOC_ROUND = 512  # the caching allocator rounds every block up to a multiple of 512 bytes


def held_bytes(build) -> tuple:
    """``build()``, the bytes the card holds for it (``memory_allocated``
    diffed around it) and its number of distinct storages."""
    from repro_torch.launch.cost import tensors

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = build()
    torch.cuda.synchronize()
    n = len({id(t.untyped_storage()) for t in tensors(out)})
    return out, torch.cuda.memory_allocated() - before, n


def check_held(kind: str, plan: dict, parts) -> dict:
    """The dry run's argument bytes against the bytes the card holds for
    the same arguments (``parts``: ``held_bytes``' counts): equal but for
    the allocator's rounding of each storage."""
    held, n = sum(p[1] for p in parts), sum(p[2] for p in parts)
    predicted = plan["bytes_per_device"]["arguments"]
    print(f"  {kind}: predicted argument bytes {predicted}, the card holds {held} in {n} storages "
          f"(difference {held - predicted}, at most {ALLOC_ROUND} a storage)", flush=True)
    check(0 <= held - predicted < ALLOC_ROUND * n, f"dry run {kind}: predicted {predicted} argument bytes, "
          f"the card holds {held}")
    return {"predicted_arguments": predicted, "held_arguments": held, "storages": n}


def synced_ms(fn, reps: int) -> float:
    """Median of ``reps`` synchronised calls between CUDA events: what the
    caller waits, host dispatch included."""
    spans = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    return statistics.median(spans)


def dryrun_cli(shape: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3_2-1b",
                             "--shape", shape], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def cli_records(procs: dict, t0: float) -> dict:
    """Each CLI cell's record, read as its process exits (killed at twice
    the step's budget)."""
    out = {}
    for shape, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=max(1.0, 2 * DRYRUN_BUDGET_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail(f"the dry run of llama3_2-1b {shape} did not end within {2 * DRYRUN_BUDGET_S:.0f} s")
        check(p.returncode == 0, f"the dry run of {shape} exited {p.returncode}: {stderr[-2000:]}")
        rec = json.loads(stdout.strip().splitlines()[-1])
        check(rec.get("ok") is True and "error" not in rec, f"the dry run of {shape} failed: {rec}")
        mem, roof = rec["bytes_per_device"], rec["roofline"]
        print(f"  (a) CLI llama3_2-1b {shape} on {rec['mesh']} ({rec['n_devices']} fake ranks, {rec['run_s']} s): "
              f"{mem['total'] / 2**30:.2f} GiB a rank (arguments {mem['arguments'] / 2**30:.2f}, temps "
              f"{mem['temps'] / 2**30:.2f}), {rec['hlo_flops_per_device']:.4g} FLOPs, "
              f"{rec['hlo_bytes_per_device']:.4g} bytes, {rec['collective_count']:.0f} all-reduces; "
              f"dominant {roof['dominant']} (compute {roof['compute_s']:.4g} s, memory {roof['memory_s']:.4g} s, "
              f"collective {roof['collective_s']:.4g} s)", flush=True)
        out[shape] = {k: rec[k] for k in ("bytes_per_device", "hlo_flops_per_device", "hlo_bytes_per_device",
                                          "collective_count", "roofline", "run_s")}
    return out


def dryrun_phase(dev, card, kernels, training) -> dict:
    """Step 17: (a) ``python -m repro_torch.launch.dryrun`` for two
    llama3_2-1b cells on the 16 x 16 mesh of fake ranks, in subprocesses
    beside (b): the dry run of step 12's config on one rank (no group) for
    a prefill of 8 x 2048 tokens, one decode step over those rows' pages
    (33 a row: 32 full and a headroom page) and step 12's training step,
    held to the card: the predicted argument bytes against the bytes the
    card holds for the same params, cache and batch, the card's peak beside
    the predicted total, and max(compute_s, memory_s) over the measured
    time (synchronised calls: the prefill and the decode step timed here,
    the training step in step 12)."""
    from repro_torch.launch import dryrun, specs
    from repro_torch.models.lm import build_model
    from repro_torch.train.optimizer import adamw_init

    t0 = time.perf_counter()
    procs = {shape: dryrun_cli(shape) for shape in DRYRUN_CLI_SHAPES}
    try:
        cfg = get_train_config()
        B, S = TRAIN_ROWS, TRAIN_SEQ
        S_dec = S + cfg.kv_page_tokens  # the prefill's pages and its headroom page
        plans = {"prefill": dryrun.plan(cfg, "prefill", B, S), "decode": dryrun.plan(cfg, "decode", B, S_dec),
                 "train": dryrun.plan(cfg, "train", B, S)}
        print(f"  (b) dry runs of llama3_2-1b on one rank in {time.perf_counter() - t0:.1f} s", flush=True)
        model = build_model(cfg)
        params = held_bytes(lambda: model.init(seed=0, device=dev))
        batch = held_bytes(lambda: specs.concrete_batch(cfg, B, S, "prefill", device=dev))
        tok = held_bytes(lambda: torch.zeros((B,), dtype=torch.int32, device=dev))
        res = {"prefill": check_held("prefill", plans["prefill"], (params, batch))}
        empty = held_bytes(lambda: model.init_cache(B, S_dec, device=dev))
        res["decode"] = check_held("decode", plans["decode"], (params, empty, tok))
        del empty
        opt = held_bytes(lambda: adamw_init(params[0]))
        train_batch = held_bytes(lambda: specs.concrete_batch(cfg, B, S, "train", device=dev))
        res["train"] = check_held("train", plans["train"], (params, opt, train_batch))
        del opt, train_batch
        gc.collect()
        torch.cuda.empty_cache()

        for k in kernels:
            k.launches = 0
        p, tokens, t = params[0], batch[0]["tokens"], tok[0]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, cache = model.prefill(p, tokens)
        torch.cuda.synchronize()
        res["prefill"]["card_peak"] = res["prefill"]["held_arguments"] + torch.cuda.max_memory_allocated() - base
        res["prefill"]["ms"] = synced_ms(lambda: model.prefill(p, tokens), reps=3)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.decode_step(p, cache, t)  # the token lands at position S, in the headroom page
        torch.cuda.synchronize()
        res["decode"]["card_peak"] = res["decode"]["held_arguments"] + torch.cuda.max_memory_allocated() - base
        res["decode"]["ms"] = synced_ms(lambda: model.decode_step(p, cache, t), reps=10)
        res["launches"] = {"flash_attention": kernels[0].launches, "paged_attention": kernels[1].launches}
        check(all(n > 0 for n in res["launches"].values()), f"a kernel did not run in step 17: {res['launches']}")
        res["train"]["card_peak"] = int(training["peak_gib"] * 2**30)
        res["train"]["ms"] = training["step_ms"]
        del cache, params, batch, tok, p, tokens, t
        gc.collect()
        torch.cuda.empty_cache()
        for kind in ("prefill", "decode", "train"):
            plan, r = plans[kind], res[kind]
            roof = plan["roofline"]
            r.update(predicted_total=plan["bytes_per_device"]["total"], flops=plan["hlo_flops_per_device"],
                     hbm_bytes=plan["hlo_bytes_per_device"], compute_s=roof["compute_s"], memory_s=roof["memory_s"],
                     roofline_share=max(roof["compute_s"], roof["memory_s"]) / (r["ms"] / 1e3))
            print(f"  {kind}: predicted total {r['predicted_total'] / 2**30:.2f} GiB, the card's peak "
                  f"{r['card_peak'] / 2**30:.2f} GiB (arguments held plus the peak above them"
                  f"{'; step 12' if kind == 'train' else ''}); {r['flops']:.4g} FLOPs and {r['hbm_bytes']:.4g} "
                  f"bytes of the plain path: compute {roof['compute_s'] * 1e3:.4g} ms, memory "
                  f"{roof['memory_s'] * 1e3:.4g} ms; measured {r['ms']:.4g} ms"
                  f"{' (step 12)' if kind == 'train' else ''}: max(compute, memory) / measured "
                  f"{r['roofline_share']:.4g} ({card})", flush=True)
        res["cli"] = cli_records(procs, t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    res["seconds"] = time.perf_counter() - t0
    print(f"  step 17 in {res['seconds']:.1f} s (budget {DRYRUN_BUDGET_S:.0f} s; {card})", flush=True)
    return res


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    start = time.perf_counter()

    def stamp(n: int) -> None:
        """Where the script's time goes: when step ``n`` starts."""
        print(f"-- step {n} at {time.perf_counter() - start:.1f} s", flush=True)

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
    stamp(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. build
    stamp(2)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {built or 'up to date'} in {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = {name: _build.ptxas_report(name) for name in ("paged_attention", "flash_attention")}
    for name, entries in ptxas.items():
        check(bool(entries) and all(e["registers"] is not None for e in entries),
              f"no ptxas report for {name}")
    print(json.dumps({"ptxas": ptxas}), flush=True)

    # 3. kernels vs plain on the card
    stamp(3)
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
    wide_head_cases(gen, errs)

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
    rows = shape_rows(gen, flush)
    for name in errs:
        errs[name] = max([errs[name]] + [r["max_abs_err"] for r in rows[name].values()])
    del flush, dk, dv

    # 4. the engine at full width
    stamp(4)
    cfg = get_config("llama3_2-1b")
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (16, 2048, 128256), f"unexpected config {cfg}")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda", dtype=cfg.cdtype())
    engine = ServingEngine(cfg, params, max_slots=SLOTS, n_pages=PAGES, device="cuda")
    del params  # the engine holds the serving weights
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
    # impl="ref" oracles on the same pages, tables, lengths and tokens; then
    # the same model through the oracles: one prefill, one decode
    hold_to_ref(model, engine.params, captured, CAPTURE_STEP, requests[0].prompt, dev)

    # 5. blob mode
    stamp(5)
    kernels = (flash_attention_cuda, paged_attention_cuda)
    launches_blob = blob_phase(cfg, engine, done, host_rec, card, kernels)
    print(f"blob-mode launches {launches_blob}", flush=True)
    del engine, model, done, host_rec, captured
    gc.collect()
    torch.cuda.empty_cache()

    # 6. h2o-danube-3-4b: head dim 120
    stamp(6)
    danube = get_config("h2o-danube-3-4b")
    check((danube.n_layers, danube.d_model, danube.head_dim, danube.d_ff) == (24, 3840, 120, 10240),
          f"unexpected config {danube}")
    launches_danube = danube_phase(danube, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()

    # 7. mixtral-8x7b: the MoE family and the sliding window at full width
    stamp(7)
    mixtral = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=MIXTRAL_LAYERS)
    check((mixtral.d_model, mixtral.n_heads, mixtral.n_kv_heads, mixtral.head_dim, mixtral.d_ff,
           mixtral.n_experts, mixtral.top_k, mixtral.vocab_size, mixtral.sliding_window, mixtral.rope_theta,
           mixtral.kv_page_tokens) == (4096, 32, 8, 128, 14336, 8, 2, 32000, WINDOW, 1e6, 64),
          f"unexpected config {mixtral}")
    check(MIXTRAL_PROMPT == WINDOW + mixtral.kv_page_tokens, "the prompt is the window plus one page")
    mixtral = mixtral_phase(mixtral, dev, kernels)
    print(f"mixtral: {json.dumps(mixtral)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 8. mamba2-370m: the ssm family at full width and depth, model API
    stamp(8)
    mamba = get_config("mamba2-370m")
    check((mamba.n_layers, mamba.d_model, mamba.d_inner, mamba.ssm_heads, mamba.ssm_headdim, mamba.ssm_state,
           mamba.ssm_conv, mamba.ssm_chunk, mamba.vocab_size, mamba.padded_vocab)
          == (48, 1024, 2048, 32, 64, 128, 4, 256, 50280, 50432), f"unexpected config {mamba}")
    mamba = mamba2_phase(mamba, dev, kernels)
    print(f"mamba2: {json.dumps(mamba)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 9. zamba2-2.7b: the hybrid family at full width and depth, model API
    stamp(9)
    zamba = get_config("zamba2-2.7b")
    check((zamba.n_layers, zamba.attn_every, zamba.d_model, zamba.d_inner, zamba.ssm_heads, zamba.ssm_state,
           zamba.n_heads, zamba.n_kv_heads, zamba.head_dim, zamba.d_ff, zamba.vocab_size)
          == (54, 6, 2560, 5120, 80, 64, 32, 32, 80, 10240, 32000), f"unexpected config {zamba}")
    zamba = zamba2_phase(zamba, dev, kernels)
    print(f"zamba2: {json.dumps(zamba)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. mistral-large-123b: int8 KV pools, cut to 16 of its 88 layers
    stamp(10)
    mistral = dataclasses.replace(get_config("mistral-large-123b"), n_layers=MISTRAL_LAYERS)
    check((mistral.d_model, mistral.n_heads, mistral.n_kv_heads, mistral.head_dim, mistral.d_ff,
           mistral.vocab_size, mistral.rope_theta, mistral.kv_cache_dtype, mistral.param_dtype)
          == (12288, 96, 8, 128, 28672, 32768, 1e6, "int8", "bfloat16"), f"unexpected config {mistral}")
    mistral = mistral_phase(mistral, dev, kernels)
    print(f"mistral-large: {json.dumps(mistral)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 11. seamless-m4t-medium: the encoder-decoder at full width and depth, model API
    stamp(11)
    seamless = get_config("seamless-m4t-medium")
    check((seamless.family, seamless.n_enc_layers, seamless.n_dec_layers, seamless.d_model, seamless.n_heads,
           seamless.n_kv_heads, seamless.head_dim, seamless.d_ff, seamless.vocab_size, seamless.padded_vocab,
           seamless.kv_page_tokens) == ("audio", 12, 12, 1024, 16, 16, 64, 4096, 256206, 256256, 64),
          f"unexpected config {seamless}")
    print(f"before step 11: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated", flush=True)
    seamless = seamless_phase(seamless, dev, kernels)
    print(f"seamless: {json.dumps(seamless)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 12. training: llama3_2-1b at full width and depth, every family's smoke step, the launcher
    stamp(12)
    print("training:", flush=True)
    training = training_phase(dev, kernels)
    print(f"training: {json.dumps(training)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 13. the sky application at the paper's deployment
    stamp(13)
    print("sky:", flush=True)
    sky = sky_phase(dev, card, kernels)
    gc.collect()

    # 14. the sky application over a federation of 4 access nodes, under node faults
    stamp(14)
    print("federated sky:", flush=True)
    from repro_torch.launch.supernovae import Deployment

    fed_sky = federated_sky_phase(dev, card, kernels, Deployment.paper())
    gc.collect()

    # 15. serving across ranks: four spawned ranks, the KV pools striped over them
    stamp(15)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serving across ranks ({torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated here):",
          flush=True)
    sharded = sharded_phase(card)

    # 16. training across ranks: four spawned ranks, the experts over the model axis
    stamp(16)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"training across ranks ({torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated here):",
          flush=True)
    train_sharded = train_sharded_phase(card)

    # 17. the dry run on fake ranks, and held to the card
    stamp(17)
    gc.collect()
    torch.cuda.empty_cache()
    print("dry run:", flush=True)
    dry = dryrun_phase(dev, card, kernels, training)

    # 18. results
    stamp(18)
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
            "library_ms": t["library_ms"], "launches_blob": launches_blob[name],
            "launches_danube": launches_danube[name], "launches_mixtral": mixtral["launches"][name],
            "launches_mamba2": mamba["launches"][name], "launches_zamba2": zamba["launches"][name],
            "launches_mistral": mistral["launches"][name], "launches_seamless": seamless["launches"][name],
            "launches_train": training["launches"][name], "launches_sky": sky["launches"][name],
            "launches_federated_sky": fed_sky["launches"][name],
            "launches_sharded": {cell: [n[name] for n in sharded[cell]["launches"]]
                                 for cell in ("llama", "mixtral", "mistral", "zamba2", "zamba2_bf16")},
            "launches_train_sharded": [n[name] for n in train_sharded["launches"]],
            "launches_dryrun": dry["launches"][name],
            "shapes": rows[name], **grids[name],
        })
    measures = ("prefill_ms", "decode_step_ms", "decode_step_least_ms", "decode_tok_s", "build_peak_gib",
                "run_peak_gib", "cross_pool_bytes", "self_pool_bytes", "step_span_ms", "step_busy_ms",
                "prefill_launches", "launches")
    train_measures = ("step_ms", "tok_s", "peak_gib", "first_loss", "last_loss", "xla_ref_rel", "trace",
                      "checkpoint")
    sky_measures = ("deployment", "wall_s", "write_ms", "write_MBps", "read_MBps", "aggregate_read_MBps",
                    "latency_p50_ms", "latency_max_ms", "pairs", "replay", "busy_share", "peak_gib", "store",
                    "hit_rates", "first_read_hit_rates")
    fed_measures = ("wall_s", "write_MBps", "node_read", "gc", "stats", "refused", "pairs", "busy_share",
                    "peak_gib", "host", "readback_s")
    print(json.dumps({"kernels": kernels, "seamless": {k: seamless[k] for k in measures},
                      "training": {k: training[k] for k in train_measures},
                      "sky": {"card": card, **{k: sky[k] for k in sky_measures}},
                      "federated_sky": {"card": card, **{k: fed_sky[k] for k in fed_measures}},
                      "sharded": sharded, "train_sharded": train_sharded, "dryrun": dry}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
