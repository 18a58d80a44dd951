"""Continuous-batching serving engine on the paged KV pool, the port of
:class:`repro.serving.engine.ServingEngine` in both of its modes.

* requests are admitted when a batch slot AND pool pages are available
  (provider-manager placement via :class:`PagedKVAllocator`), else they wait
  in the queue (backpressure);
* prompt prefixes matching cached pages are SHARED (COW snapshots -- no
  extra storage), and a page that another live row of the batch schedules is
  COW-forked on the device first (``fork_for_batch``);
* each step appends one token per live row (page WRITE) and attends over the
  striped pages (page READ).

In blob mode (``kv_client``, a :class:`BlobKVClient`) the page pool is a
blob on a :class:`~repro_torch.core.Cluster` and the prefix index is the
cluster-wide :class:`~repro_torch.core.PageDirectory`: full prompt pages are
published as one ``writev`` version at admission, a decode page that fills is
published through the session's async write window, and a shared prefix
page that this engine's device pool does not hold at its published version
is fetched with one vectored read per version. So engines with their own
device pools (two users) share a system prompt without storing it twice.

The pools are ``(L, P, T, K, hd)`` tensors updated in place: COW copies are
``index_copy_`` along the page axis, and decode steps write the new token's
K/V straight into them. A page crosses to the blob store as the bytes of
:func:`repro_torch.serving.blob_kv.pack_kv_page` (:func:`pack_page`, one
device-to-host copy) and comes back with one host-to-device copy
(:func:`load_page`).
"""

from __future__ import annotations

import dataclasses
import queue
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Model, build_model, serving_params
from repro_torch.serving.blob_kv import BlobKVClient
from repro_torch.storage.kvcache import PagedKVAllocator


def pack_page(k: torch.Tensor, v: torch.Tensor, page_size: int) -> np.ndarray:
    """One page's K and V (``(L, T, K, hd)`` each, any strides, any device)
    as a fresh ``page_size``-byte host buffer, byte-identical to
    :func:`~repro_torch.serving.blob_kv.pack_kv_page`: K of all layers, then
    V, each in C order, zero-padded. The bytes are copied as they are (bf16
    stays bf16) with one device-to-host copy; the buffer owns its memory, so
    the blob write plane freezes it instead of copying it, and no later
    write to the pool can reach it."""
    raw = torch.stack([k, v]).view(-1).view(torch.uint8)
    if raw.numel() > page_size:
        raise ValueError(f"KV page payload ({raw.numel()}B) exceeds blob page ({page_size}B)")
    buf = np.zeros(page_size, np.uint8)
    torch.from_numpy(buf[: raw.numel()]).copy_(raw)
    return buf


def load_page(pool_k: torch.Tensor, pool_v: torch.Tensor, page: int, buf: np.ndarray) -> None:
    """Inverse of :func:`pack_page`: write a fetched page buffer into page
    ``page`` of both ``(L, P, T, K, hd)`` pools, in the pools' dtype, with one
    host-to-device copy."""
    L, _, T, K, hd = pool_k.shape
    nbytes = 2 * L * T * K * hd * pool_k.element_size()
    with warnings.catch_warnings():
        # fetched pages are frozen (read-only) arrays; the tensor is only
        # the source of one copy, never written
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(np.asarray(buf[:nbytes], np.uint8))
    kv = host.to(pool_k.device).view(pool_k.dtype).view(2, L, T, K, hd)
    pool_k[:, page].copy_(kv[0])
    pool_v[:, page].copy_(kv[1])


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
        kv_client: Optional[BlobKVClient] = None,
        device="cuda",
    ) -> None:
        if cfg.family in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"family {cfg.family!r} is served through the model API only (build_model): the "
                "engine's decode cache carries no SSM state, as the JAX package's engine's does not"
            )
        if cfg.family in ("encdec", "audio"):
            # the JAX engine takes such a config and fails at the first admit
            # (its prefill gets no encoder input); refuse it here instead
            raise NotImplementedError(
                f"family {cfg.family!r} is served through the model API only (build_model: prefill "
                "of {'enc_embeds', 'tokens'}, then decode_step): the engine's requests carry no "
                "encoder input and its decode cache no cross-attention pools"
            )
        if cfg.kvdtype() == torch.int8:
            # the engine scatters raw prefill pages, so it keeps bf16 pools,
            # as the JAX engine does; its model must then hand it the K/V
            # unquantized (int8 codes written into a bf16 pool would be read
            # as values)
            cfg = dataclasses.replace(cfg, kv_cache_dtype="bfloat16")
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
        #: blob mode: the page pool is a blob on a Cluster and the prefix
        #: index is the cluster-wide PageDirectory -- slot ids come from the
        #: shared BlobKVStore, so the device pool mirrors the blob geometry
        self.kv = kv_client
        if kv_client is not None:
            if kv_client.store.page_tokens != self.T:
                raise ValueError("BlobKVStore page_tokens != model kv_page_tokens")
            n_pages = kv_client.store.n_pages
            self.alloc = None
            #: slot -> published version currently resident in the device
            #: pool (a stale entry just causes a refetch: versions are
            #: monotone, so a reused slot republishes at a higher version)
            self._resident: Dict[int, int] = {}
        else:
            self.alloc = PagedKVAllocator(n_pages, self.T)
        self._rng = np.random.default_rng(rng_seed)

        L = self._n_attn_layers()
        K, hd = cfg.n_kv_heads, cfg.head_dim
        dt = cfg.kvdtype()
        self.n_pool_pages = n_pages
        self.pool_k = torch.zeros((L, n_pages, self.T, K, hd), dtype=dt, device=self.device)
        self.pool_v = torch.zeros((L, n_pages, self.T, K, hd), dtype=dt, device=self.device)
        self._slots: List[Optional[dict]] = [None] * max_slots
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._submitted: Dict[int, float] = {}
        self._done: Dict[int, Completion] = {}

    def _n_attn_layers(self) -> int:
        """Attention layers, one paged KV layer each (the JAX engine's count)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return cfg.n_layers // cfg.attn_every
        return cfg.n_layers

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
                    busy.update(s["seq"].pages if self.kv is None else s["seq"].slots)
            if self.kv is None:
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
            else:
                try:
                    seq, shared_tokens, fetches = self.kv.admit(prompt)
                except MemoryError:
                    # blob pool exhausted (directory had nothing evictable):
                    # same backpressure as the host allocator path
                    self._queue.put(req)
                    return
                pages = seq.slots
                # make shared prefix pages device-resident (one vectored
                # read through the shared cache tier per version group)
                self._load_shared_pages(fetches)
                try:
                    forks = self.kv.fork_for_batch(seq, busy)
                except MemoryError:
                    self.kv.finish(seq)
                    self._queue.put(req)
                    return
                self._copy_pages(forks)
                for _, d in forks:
                    # forked bytes are local-only: no published version is
                    # resident in that slot anymore
                    self._resident.pop(d, None)
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
            if self.kv is not None:
                for p in range(first_new, n_prompt_pages):
                    self._resident.pop(pages[p], None)  # local bytes now newer
                # publish the fresh FULL prompt pages as one writev (one
                # version) and register them in the cluster prefix directory
                full_pages = len(prompt) // self.T
                payloads = {p: pack_page(pk[:, p], pv[:, p], self.kv.store.page_size)
                            for p in range(first_new, full_pages)}
                self.kv.publish_prompt(seq, payloads)
                for p in range(first_new, full_pages):
                    addr = seq.page_addr[p]
                    self._resident[addr.page] = addr.version

            next_tok = self._sample(logits[0].cpu().numpy(), req.temperature)
            now = time.perf_counter()
            self._slots[slot] = dict(
                req=req, seq=seq, generated=[int(next_tok)], t0=now,
                ttft=now - self._submitted.pop(req.request_id, now),
                shared=shared_tokens, length=len(prompt),
            )

    def _load_shared_pages(self, fetches) -> None:
        """Fetch shared prefix pages this device pool doesn't hold at their
        published version and write them in (admit-time gather)."""
        stale = [a for _, a in fetches if self._resident.get(a.page) != a.version]
        if not stale:
            return
        for addr, buf in zip(stale, self.kv.fetch_pages(stale)):
            load_page(self.pool_k, self.pool_v, addr.page, buf)
            self._resident[addr.page] = addr.version

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
            seq = self._slots[i]["seq"]
            if self.kv is not None:
                self.kv.append_token(seq)  # head always fresh: no COW
            else:
                copies.extend(self.alloc.append_token(seq.seq_id))
        self._copy_pages(copies)

        B = self.max_slots
        # inactive rows keep the out-of-range sentinel: they own no pages
        tables = np.full((B, self.Rmax), self.n_pool_pages, np.int32)
        page_pos = np.zeros((B, self.Rmax), np.int32)
        lengths = np.zeros((B,), np.int32)
        tokens = np.zeros((B,), np.int64)
        for i in active:
            st = self._slots[i]
            if self.kv is not None:
                tables[i] = self.kv.table(st["seq"], self.Rmax)
            else:
                tables[i] = self.alloc.table(st["seq"].seq_id, self.Rmax)
            page_pos[i] = np.arange(self.Rmax) * self.T  # positional pages (no ring)
            lengths[i] = st["length"] + len(st["generated"]) - 1
            tokens[i] = st["generated"][-1]

        logits = self._decode(tables, page_pos, lengths, tokens).cpu().numpy()

        if self.kv is not None:
            # a head page that just FILLED becomes a published blob version
            # (write_async: the publish pipeline overlaps the next steps)
            for i in active:
                seq = self._slots[i]["seq"]
                if seq.length and seq.length % self.T == 0:
                    idx = seq.length // self.T - 1
                    if seq.page_addr[idx] is None and idx not in self.kv.pending_pages(seq):
                        sid = seq.slots[idx]
                        self.kv.publish_page_async(
                            seq, idx,
                            pack_page(self.pool_k[:, sid], self.pool_v[:, sid], self.kv.store.page_size),
                        )

        for i in active:
            st = self._slots[i]
            tok = self._sample(logits[i], st["req"].temperature)
            st["generated"].append(tok)
            if len(st["generated"]) >= st["req"].max_new_tokens:
                self._finish(i)
        return len(active)

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        if self.kv is not None:
            self.kv.finish(st["seq"])
        else:
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
