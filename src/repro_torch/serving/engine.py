"""Continuous-batching serving engine on the paged KV pool, the host-allocator
mode of :class:`repro.serving.engine.ServingEngine`.

* requests are admitted when a batch slot AND pool pages are available
  (provider-manager placement via :class:`PagedKVAllocator`), else they wait
  in the queue (backpressure);
* prompt prefixes matching cached pages are SHARED (COW snapshots -- no
  extra storage), and a page that another live row of the batch schedules is
  COW-forked on the device first (``fork_for_batch``);
* each step appends one token per live row (page WRITE) and attends over the
  striped pages (page READ).

The pools are ``(L, P, T, K, hd)`` tensors updated in place: COW copies are
``index_copy_`` along the page axis, and decode steps write the new token's
K/V straight into them.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Model, build_model, serving_params
from repro_torch.storage.kvcache import PagedKVAllocator


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: List[int]
    prefill_skipped_tokens: int  # prefix-cache savings
    latency_s: float  # first token to completion
    ttft_s: float = 0.0  # submit to first token


class ServingEngine:
    """Greedy/temperature sampling, fixed slot count, paged pool."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_slots: int = 4,
        n_pages: int = 256,
        max_pages_per_seq: int = 32,
        rng_seed: int = 0,
        kv_client=None,
        device="cuda",
    ) -> None:
        if kv_client is not None:
            raise NotImplementedError(
                "blob mode (kv_client) is not ported yet (ROADMAP Queue 1, item 4)"
            )
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine runs on {self.device}")
        self.cfg = cfg
        self.model: Model = build_model(cfg)
        self.params = serving_params(params, cfg)
        self.T = cfg.kv_page_tokens
        self.max_slots = max_slots
        self.Rmax = max_pages_per_seq
        self.alloc = PagedKVAllocator(n_pages, self.T)
        self._rng = np.random.default_rng(rng_seed)

        L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        dt = cfg.kvdtype()
        if dt == torch.int8:
            # the engine scatters raw prefill pages; int8 pools would need a
            # quantizing scatter here -- keep bf16, as the JAX engine does
            dt = torch.bfloat16
        self.n_pool_pages = n_pages
        self.pool_k = torch.zeros((L, n_pages, self.T, K, hd), dtype=dt, device=self.device)
        self.pool_v = torch.zeros((L, n_pages, self.T, K, hd), dtype=dt, device=self.device)
        self._slots: List[Optional[dict]] = [None] * max_slots
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._submitted: Dict[int, float] = {}
        self._done: Dict[int, Completion] = {}

    # ------------------------------ device steps ------------------------------
    def _copy_pages(self, copies: List[Tuple[int, int]]) -> None:
        """COW: pool[:, dst] = pool[:, src] for every (src, dst), all layers.
        The sources are gathered before any write, as the JAX copy is."""
        if not copies:
            return
        src = torch.tensor([c[0] for c in copies], dtype=torch.long, device=self.device)
        dst = torch.tensor([c[1] for c in copies], dtype=torch.long, device=self.device)
        for pool in (self.pool_k, self.pool_v):
            pool.index_copy_(1, dst, pool.index_select(1, src))

    def _decode(self, tables, page_pos, lengths, tokens) -> torch.Tensor:
        L = self.pool_k.shape[0]
        dev = self.device
        cache = {
            "kv": {
                "pool_k": self.pool_k,
                "pool_v": self.pool_v,
                # all layers share one table (the pools are stacked per layer)
                "tables": torch.from_numpy(tables).to(dev).expand(L, *tables.shape),
                "page_pos": torch.from_numpy(page_pos).to(dev).expand(L, *page_pos.shape),
            },
            "lengths": torch.from_numpy(lengths).to(dev),
        }
        logits, _ = self.model.decode_step(
            self.params, cache, torch.from_numpy(tokens).to(dev)
        )
        return logits

    # ------------------------------ lifecycle ------------------------------
    def submit(self, req: Request) -> None:
        self._submitted[req.request_id] = time.perf_counter()
        self._queue.put(req)

    def _admit(self) -> None:
        while not self._queue.empty() and None in self._slots:
            req = self._queue.get()
            prompt = list(req.prompt)
            pad = (-len(prompt)) % self.T
            padded = prompt + [0] * pad
            need_pages = len(padded) // self.T + 1
            # pages every live row already schedules: a new row sharing a page
            # with a live row COW-forks it on device (see fork_for_batch)
            busy = set()
            for s in self._slots:
                if s is not None:
                    busy.update(s["seq"].pages)
            if self.alloc.free_pages < need_pages:
                # not enough pages: requeue, stop admitting (backpressure)
                self._queue.put(req)
                return
            seq, shared_tokens, cow = self.alloc.admit(prompt)
            try:
                cow = cow + self.alloc.fork_for_batch(seq.seq_id, busy)
            except MemoryError:
                self.alloc.finish(seq.seq_id)
                self._queue.put(req)
                return
            pages = seq.pages
            # partial-page prefix reuse + batch-conflict forks: copy donor
            # pages on device before anything writes the pool
            self._copy_pages(cow)
            slot = self._slots.index(None)

            # prefill the whole (padded) prompt for its last-position logits;
            # only the pages not shared are written into the pool
            toks = torch.tensor([padded], dtype=torch.long, device=self.device)
            logits, cache = self.model.prefill(self.params, toks)
            pk, pv = cache["kv"]["pool_k"], cache["kv"]["pool_v"]
            n_prompt_pages = len(padded) // self.T
            # ceil: a partially-shared (COW-forked) final page already holds
            # every prompt token this request needs
            first_new = -(-shared_tokens // self.T)
            if first_new < n_prompt_pages:
                dst = torch.tensor(pages[first_new:n_prompt_pages], dtype=torch.long, device=self.device)
                self.pool_k.index_copy_(1, dst, pk[:, first_new:n_prompt_pages].to(self.pool_k.dtype))
                self.pool_v.index_copy_(1, dst, pv[:, first_new:n_prompt_pages].to(self.pool_v.dtype))

            next_tok = self._sample(logits[0].cpu().numpy(), req.temperature)
            now = time.perf_counter()
            self._slots[slot] = dict(
                req=req, seq=seq, generated=[int(next_tok)], t0=now,
                ttft=now - self._submitted.pop(req.request_id, now),
                shared=shared_tokens, length=len(prompt),
            )

    def _sample(self, logits: np.ndarray, temperature: float) -> int:
        logits = logits[: self.cfg.vocab_size]
        if temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / temperature)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def step(self) -> int:
        """One engine iteration: admit + one batched decode step. Returns the
        number of active sequences."""
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return 0

        # COW-fork / grow head pages before writing this step's token
        copies: List[Tuple[int, int]] = []
        for i in active:
            copies.extend(self.alloc.append_token(self._slots[i]["seq"].seq_id))
        self._copy_pages(copies)

        B = self.max_slots
        # inactive rows keep the out-of-range sentinel: they own no pages
        tables = np.full((B, self.Rmax), self.n_pool_pages, np.int32)
        page_pos = np.zeros((B, self.Rmax), np.int32)
        lengths = np.zeros((B,), np.int32)
        tokens = np.zeros((B,), np.int64)
        for i in active:
            st = self._slots[i]
            tables[i] = self.alloc.table(st["seq"].seq_id, self.Rmax)
            page_pos[i] = np.arange(self.Rmax) * self.T  # positional pages (no ring)
            lengths[i] = st["length"] + len(st["generated"]) - 1
            tokens[i] = st["generated"][-1]

        logits = self._decode(tables, page_pos, lengths, tokens).cpu().numpy()

        for i in active:
            st = self._slots[i]
            tok = self._sample(logits[i], st["req"].temperature)
            st["generated"].append(tok)
            if len(st["generated"]) >= st["req"].max_new_tokens:
                self._finish(i)
        return len(active)

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        self.alloc.finish(st["seq"].seq_id)
        self._done[st["req"].request_id] = Completion(
            st["req"].request_id,
            st["generated"],
            st["shared"],
            time.perf_counter() - st["t0"],
            st["ttft"],
        )
        self._slots[slot] = None

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, Completion]:
        for _ in range(max_steps):
            n = self.step()
            if n == 0 and self._queue.empty():
                break
        return dict(self._done)
