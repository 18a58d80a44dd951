"""Host-side paged-KV allocator: the paper's provider-manager + metadata
control plane, applied to serving. A copy of :mod:`repro.storage.kvcache`
(pure Python), kept in the port so that it imports nothing of ``repro``.

The device holds the page pools (torch tensors); this allocator owns the
*page-id space* and implements:

* **placement** — pages for a request come from a free list (the provider
  manager's load-balanced allocation; ids map to shards by range, so a
  request's pages land device-local when possible);
* **prefix sharing** — full pages of a prompt are content-addressed by the
  token chain hash; matching prefixes share pages read-only (the paper's
  "sharing common parts of snapshots" — space efficiency across snapshots);
* **COW** — a shared page is never written: the engine gets a
  ``(src, dst)`` copy list to fork the page before a request appends into it
  (exactly the paper's WRITE: fresh pages, old versions stay readable);
* **versioning** — a sequence snapshot is its immutable page-table tuple +
  length; snapshots taken at any point remain valid until released
  (read/write concurrency: a snapshot reader is never invalidated by the
  writer's progress).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


def chain_hash(prev: int, tokens: Tuple[int, ...]) -> int:
    """Content address of a token run given its prefix hash. Module-level so
    that every prefix index addresses pages identically -- int/tuple hashing
    is deterministic within a process, which is the sharing domain."""
    return hash((prev, tokens))


@dataclasses.dataclass
class SeqState:
    seq_id: int
    length: int  # tokens written so far
    pages: List[int]  # page ids, in positional order (no ring here: engine decode grows)
    shared_prefix_pages: int  # first N pages are shared (read-only)


@dataclasses.dataclass
class Snapshot:
    seq_id: int
    length: int
    pages: Tuple[int, ...]


class PagedKVAllocator:
    """Page bookkeeping for one pool (all layers share the id space; the
    device pools are stacked (L, P, ...) so one id addresses all layers)."""

    def __init__(self, n_pages: int, page_tokens: int) -> None:
        self.n_pages = n_pages
        self.T = page_tokens
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        #: prefix hash -> page id (content-addressed full pages)
        self._prefix_index: Dict[int, int] = {}
        self._page_prefix: Dict[int, int] = {}  # reverse map for eviction
        #: full-page-prefix hash -> {pid: tokens written so far in that page}
        #: for PARTIAL final pages; unlike _prefix_index these entries hold no
        #: reference — they live exactly as long as their owner's page does
        self._ext_index: Dict[int, Dict[int, Tuple[int, ...]]] = {}
        self._page_ext: Dict[int, int] = {}  # reverse map for cleanup
        self._seqs: Dict[int, SeqState] = {}
        self._next_seq = 0
        self.stats = {
            "alloc": 0, "shared": 0, "cow_copies": 0, "freed": 0,
            "partial_shared_tokens": 0,
        }

    # -- low-level ----------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def _alloc_page(self) -> int:
        if not self._free:
            # evict an unreferenced prefix-cache page if any (_release_page
            # drops the prefix-index entry when the last ref is the cache's)
            for h, pid in list(self._prefix_index.items()):
                if self._ref.get(pid, 0) == 1 and self._page_prefix.get(pid) == h:
                    self._release_page(pid)
                    break
            if not self._free:
                raise MemoryError("KV pool exhausted")
        pid = self._free.pop()
        self._ref[pid] = 1
        self.stats["alloc"] += 1
        return pid

    def _retain(self, pid: int) -> None:
        self._ref[pid] += 1

    def _release_page(self, pid: int) -> None:
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            del self._ref[pid]
            h = self._page_prefix.pop(pid, None)
            if h is not None:
                self._prefix_index.pop(h, None)
            eh = self._page_ext.pop(pid, None)
            if eh is not None:
                bucket = self._ext_index.get(eh)
                if bucket is not None:
                    bucket.pop(pid, None)
                    if not bucket:
                        del self._ext_index[eh]
            self._free.append(pid)
            self.stats["freed"] += 1

    # -- prefix hashing --------------------------------------------------------------
    _chain = staticmethod(chain_hash)

    # -- request lifecycle --------------------------------------------------------------
    def admit(self, tokens: Sequence[int]) -> Tuple[SeqState, int, List[Tuple[int, int]]]:
        """Admit a prompt. Returns (seq, n_shared_tokens, cow_copies).

        ``n_shared_tokens`` tokens are already present in shared pages (the
        engine can skip prefill WRITES for them); ``cow_copies`` is a list of
        (src_page, dst_page) the engine must copy on device BEFORE its next
        allocator call (COW fork of a partially-reused page).

        Partial-page reuse: when the prompt *ends* inside its final page and
        another live sequence's final page starts with those same tokens
        (under the same full-page prefix), that page is COW-forked into the
        new sequence and the whole prompt counts as shared — the fork's
        positions beyond the prompt are stale KV from the donor, masked by
        this sequence's length and overwritten as decode appends. A prompt
        whose tail spans past the matched page gets no partial reuse: the
        engine would have to scatter recomputed KV over the fork anyway.
        """
        tokens = tuple(int(t) for t in tokens)
        T = self.T
        pages: List[int] = []
        shared = 0
        h = 0
        # longest shared full-page prefix
        while (shared + 1) * T <= len(tokens):
            h2 = self._chain(h, tokens[shared * T : (shared + 1) * T])
            pid = self._prefix_index.get(h2)
            if pid is None:
                break
            self._retain(pid)
            pages.append(pid)
            shared += 1
            h = h2
        n_shared_tokens = shared * T

        cow: List[Tuple[int, int]] = []
        rest = len(tokens) - n_shared_tokens
        tail = tokens[n_shared_tokens:]
        if 0 < rest < T:
            # the prompt ends in this page: a donor page whose first `rest`
            # tokens match lets us fork instead of prefilling the page
            for src, src_tokens in self._ext_index.get(h, {}).items():
                if len(src_tokens) >= rest and src_tokens[:rest] == tail:
                    dst = self._alloc_page()
                    cow.append((src, dst))
                    pages.append(dst)
                    n_shared_tokens = len(tokens)
                    rest = 0
                    self.stats["cow_copies"] += 1
                    self.stats["partial_shared_tokens"] += len(tail)
                    break

        # fresh pages for the rest of the prompt (+ the decode head page)
        n_fresh = (rest + T - 1) // T
        for i in range(n_fresh):
            pid = self._alloc_page()
            pages.append(pid)
        # register newly-written full pages in the prefix index
        hh = h
        for i in range(shared, len(tokens) // T):
            hh = self._chain(hh, tokens[i * T : (i + 1) * T])
            pid = pages[i]
            if hh not in self._prefix_index:
                self._prefix_index[hh] = pid
                self._page_prefix[pid] = hh
                self._retain(pid)  # the index holds a reference
        # index a partial final page as a COW donor for later admits (no
        # reference held: the entry dies with the page)
        if len(tokens) % T and pages:
            head = pages[-1]
            if head not in self._page_ext:
                self._page_ext[head] = hh
                self._ext_index.setdefault(hh, {})[head] = tokens[
                    (len(tokens) // T) * T:
                ]

        seq = SeqState(self._next_seq, len(tokens), pages, shared)
        self._next_seq += 1
        self._seqs[seq.seq_id] = seq
        self.stats["shared"] += shared
        return seq, n_shared_tokens, cow

    def fork_for_batch(self, seq_id: int, busy) -> List[Tuple[int, int]]:
        """COW-fork any of this sequence's pages whose id is in ``busy`` (the
        pages of every OTHER live row of the same decode batch). The JAX
        package's owner-indexed decode path assigns each pool page to exactly
        one row per batch, so two live rows must never alias a page id there;
        the port keeps the same rule so that both engines schedule the same
        pages: prefix sharing is storage-level across time, and concurrent
        readers of a shared page each get a device copy.
        Returns the (src, dst) device copies; raises ``MemoryError`` with the
        sequence still internally consistent (caller rolls back via
        ``finish``)."""
        seq = self._seqs[seq_id]
        copies: List[Tuple[int, int]] = []
        for i, pid in enumerate(seq.pages):
            if pid in busy:
                dst = self._alloc_page()
                copies.append((pid, dst))
                seq.pages[i] = dst
                self._release_page(pid)
                self.stats["cow_copies"] += 1
        return copies

    def ensure_writable_head(self, seq_id: int) -> List[Tuple[int, int]]:
        """Before decode appends to the head page, COW-fork it if shared.
        Returns device copies (src, dst) to perform."""
        seq = self._seqs[seq_id]
        copies: List[Tuple[int, int]] = []
        head = seq.length // self.T
        if head >= len(seq.pages):
            seq.pages.append(self._alloc_page())
            return copies
        pid = seq.pages[head]
        if self._ref.get(pid, 1) > 1:
            fresh = self._alloc_page()
            copies.append((pid, fresh))
            self._release_page(pid)
            seq.pages[head] = fresh
            self.stats["cow_copies"] += 1
        return copies

    def append_token(self, seq_id: int) -> List[Tuple[int, int]]:
        """Account one decoded token; returns required COW copies / growth."""
        copies = self.ensure_writable_head(seq_id)
        self._seqs[seq_id].length += 1
        return copies

    def snapshot(self, seq_id: int) -> Snapshot:
        """Immutable snapshot (the paper's published version): retains every
        page so later writes/frees cannot disturb readers."""
        seq = self._seqs[seq_id]
        for pid in seq.pages:
            self._retain(pid)
        return Snapshot(seq_id, seq.length, tuple(seq.pages))

    def release_snapshot(self, snap: Snapshot) -> None:
        for pid in snap.pages:
            self._release_page(pid)

    def finish(self, seq_id: int) -> None:
        seq = self._seqs.pop(seq_id)
        for pid in seq.pages:
            self._release_page(pid)

    def table(self, seq_id: int, max_pages: int) -> List[int]:
        """Page table row padded to ``max_pages`` (device shape). Padding uses
        the out-of-bounds sentinel ``n_pages`` so ownership scatters drop it
        (a 0 pad would falsely claim page 0)."""
        seq = self._seqs[seq_id]
        pad = [self.n_pages] * (max_pages - len(seq.pages))
        return list(seq.pages) + pad

    def used_pages(self) -> int:
        return self.n_pages - len(self._free)
