# Copy of src/repro/serving/blob_kv.py; only the package name in imports differs.
"""Blob-backed KV serving plane: the paged KV-cache hosted ON the
Cluster/Session blob store.

`storage/kvcache.py` keeps its bookkeeping in one process; this module puts
the same page pool on the versioned blob plane, which buys exactly the
paper's properties:

* **each KV page pool is a blob** — page *i* of the pool is the blob's page
  *i*, so a sequence's page table is a list of blob page indices ("slots");
* **a page table compiles to a readv plan** — :meth:`BlobKVClient.gather`
  groups a sequence's published pages by version and issues ONE vectored
  read per version group (usually one: a prompt publishes as one contiguous
  ``writev`` patch = one version), hitting the node's shared cache tier and
  deduplicating pages across concurrent sessions;
* **appended / COW-forked pages are writev/write_async patches** — each
  filled decode page is published as its own version, pipelined through the
  session's bounded async window;
* **published sequence versions are real VersionManager versions** — the
  host allocator's ad-hoc refcounts become snapshot pins
  (:meth:`Cluster.pin_published`), so GC, chaos and repair all see serving
  state as ordinary blob state;
* **the prefix index becomes cluster-wide** — full prompt pages are
  content-addressed (token chain hash, same function as the host allocator)
  into :class:`repro.core.page_directory.PageDirectory`, mapping hash →
  ``(blob_id, version, page)``. Any session of any user on the cluster that
  admits a prompt with the same prefix resolves the same triple and reads
  the bytes from the shared cache tier: N sessions share a system prompt
  with zero recompute and zero duplicate storage.

Coherence is the publish-frontier invariant, not invalidation: only
*published* versions can enter the directory (``pin_published`` validates
the frontier before the entry becomes visible) and only published versions
can be read through ``Session.read_pages`` — so a cross-session read of an
unpublished KV page is impossible by construction. Published pages are
immutable, so cache entries never need invalidating.

Locking: ``BlobKVStore._lock`` (level 3) guards the slot free-list and
refcounts only. Directory calls (which pin under the level-1 GC guard) are
always made with the store lock RELEASED; the directory's eviction hook
re-enters the store lock from outside the directory lock. ``BlobKVClient``
and :class:`KVSeq` are single-threaded per engine (like the host
allocator); the shared state is the store + directory + cluster.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.lockwatch import make_lock
from repro_torch.core.cluster import Cluster, Session
from repro_torch.core.page_directory import PageAddress
from repro_torch.storage.kvcache import chain_hash


# ------------------------------ page packing ------------------------------
def kv_page_nbytes(
    n_layers: int, page_tokens: int, n_kv_heads: int, head_dim: int, dtype
) -> int:
    """Payload bytes of one packed KV page: K and V for all layers of
    ``page_tokens`` positions."""
    return 2 * n_layers * page_tokens * n_kv_heads * head_dim * np.dtype(dtype).itemsize


def pack_kv_page(pk_page, pv_page, page_size: int) -> np.ndarray:
    """Flatten one page's K and V (shape ``(L, T, K, hd)`` each) into a
    zero-padded ``page_size``-byte buffer for the blob write plane."""
    k = np.ascontiguousarray(np.asarray(pk_page)).reshape(-1)
    v = np.ascontiguousarray(np.asarray(pv_page)).reshape(-1)
    raw = np.concatenate([k, v]).view(np.uint8)
    if raw.size > page_size:
        raise ValueError(
            f"KV page payload ({raw.size}B) exceeds blob page ({page_size}B)"
        )
    buf = np.zeros(page_size, np.uint8)
    buf[: raw.size] = raw
    return buf


def unpack_kv_page(
    buf: np.ndarray, shape: Tuple[int, int, int, int], dtype
) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`pack_kv_page`; ``shape`` is ``(L, T, K, hd)``."""
    count = int(np.prod(shape))
    nbytes = count * np.dtype(dtype).itemsize
    flat = np.ascontiguousarray(buf[: 2 * nbytes]).view(dtype)
    return flat[:count].reshape(shape), flat[count:].reshape(shape)


# --------------------------------- store ----------------------------------
class BlobKVStore:
    """One KV page pool hosted as one blob, shared by every client on the
    cluster. Owns the *slot* (blob page index) space: a free list plus
    refcounts, where the cluster's :class:`PageDirectory` holds a reference
    for every prefix entry it advertises and each sequence holds references
    for the slots it uses — a slot returns to the free list only when the
    last reference drops, so a republished slot can never clobber a page
    someone still addresses *at an older version* (old versions stay
    readable regardless: blob writes are COW)."""

    def __init__(
        self,
        cluster: Cluster,
        n_pages: int,
        page_bytes: int,
        page_tokens: int,
        kv_shape: Optional[Tuple[int, int, int, int]] = None,
        kv_dtype=None,
    ) -> None:
        if n_pages <= 0 or page_bytes <= 0:
            raise ValueError("n_pages and page_bytes must be positive")
        self.cluster = cluster
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        #: blob pages are power-of-two sized; the KV payload is zero-padded
        self.page_size = 1 << (max(page_bytes, 1) - 1).bit_length()
        self.kv_shape = kv_shape
        self.kv_dtype = kv_dtype
        self.blob_id = cluster.alloc(n_pages * self.page_size, self.page_size)
        self.directory = cluster.page_directory
        self.directory.add_evict_hook(self._on_directory_evict)
        self._lock = make_lock("BlobKVStore._lock")
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        #: directory key -> slot the index's reference is parked on
        self._key_slot: Dict[int, int] = {}
        self.stats = {
            "slot_alloc": 0, "slot_freed": 0, "prefix_hits": 0,
            "prefix_misses": 0, "prefix_registered": 0, "evictions": 0,
        }

    @classmethod
    def for_kv(
        cls,
        cluster: Cluster,
        n_pages: int,
        page_tokens: int,
        n_layers: int,
        n_kv_heads: int,
        head_dim: int,
        dtype,
    ) -> "BlobKVStore":
        """Size the pool for a model's KV geometry (one slot holds K+V for
        all layers of one page of positions)."""
        return cls(
            cluster,
            n_pages,
            kv_page_nbytes(n_layers, page_tokens, n_kv_heads, head_dim, dtype),
            page_tokens,
            kv_shape=(n_layers, page_tokens, n_kv_heads, head_dim),
            kv_dtype=np.dtype(dtype),
        )

    # -- slot space ---------------------------------------------------------
    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_slots(self) -> int:
        return self.n_pages - self.free_slots

    def alloc_slots(self, n: int) -> List[int]:
        """Allocate ``n`` slots (each ref=1, owned by the caller). Under
        pressure, reclaims one directory-advertised slot of this pool per
        retry — the cluster-wide analogue of the host allocator's
        prefix-cache eviction — and raises ``MemoryError`` once the
        directory holds nothing evictable (everything pinned by live
        sequences)."""
        got: List[int] = []
        while True:
            with self._lock:
                while self._free and len(got) < n:
                    slot = self._free.pop()
                    self._ref[slot] = 1
                    got.append(slot)
                if len(got) == n:
                    self.stats["slot_alloc"] += n
                    return got
            # pool dry: ask the directory to drop an unreferenced prefix
            # entry of THIS blob (its evict hook frees the slot). Called with
            # the store lock released — the hook re-enters it.
            if not self.directory.evict_unreferenced(1, blob_id=self.blob_id):
                with self._lock:
                    for slot in got:
                        self._release_locked(slot)
                raise MemoryError("blob KV pool exhausted")
            self.stats["evictions"] += 1

    def retain_slot(self, slot: int) -> None:
        with self._lock:
            self._ref[slot] += 1

    def release_slot(self, slot: int) -> None:
        with self._lock:
            self._release_locked(slot)

    def _release_locked(self, slot: int) -> None:
        self._ref[slot] -= 1
        if self._ref[slot] == 0:
            del self._ref[slot]
            self._free.append(slot)
            self.stats["slot_freed"] += 1

    # -- cluster-wide prefix index -------------------------------------------
    def register_prefix(self, key: int, slot: int, version: int) -> PageAddress:
        """Advertise ``key`` → this pool's ``slot`` at ``version`` in the
        cluster directory. The index parks a slot reference (dropped by the
        eviction hook); on a registration race the first publisher wins and
        our reference is returned. The directory validates+pins the version
        — registering an unpublished page raises."""
        with self._lock:
            self._ref[slot] += 1
            self._key_slot[key] = slot
        try:
            winner = self.directory.publish(key, self.blob_id, version, slot)
        except Exception:
            with self._lock:
                if self._key_slot.get(key) == slot:
                    del self._key_slot[key]
                self._release_locked(slot)
            raise
        if winner.page != slot or winner.version != version:
            with self._lock:
                if self._key_slot.get(key) == slot:
                    del self._key_slot[key]
                self._release_locked(slot)
        else:
            self.stats["prefix_registered"] += 1
        return winner

    def lookup_prefix(self, key: int) -> Optional[PageAddress]:
        """Resolve a prefix page: takes a directory entry refcount (blocks
        eviction) AND a slot reference for the caller; both are returned by
        :meth:`release_prefix`."""
        addr = self.directory.acquire(key)
        if addr is None:
            self.stats["prefix_misses"] += 1
            return None
        if addr.blob_id != self.blob_id:
            self.directory.release(key)
            self.stats["prefix_misses"] += 1
            return None
        self.retain_slot(addr.page)
        self.stats["prefix_hits"] += 1
        return addr

    def release_prefix(self, key: int, addr: PageAddress) -> None:
        self.release_slot(addr.page)
        self.directory.release(key)

    def _on_directory_evict(self, key: int, address: PageAddress) -> None:
        if address.blob_id != self.blob_id:
            return
        with self._lock:
            slot = self._key_slot.pop(key, None)
            if slot is not None:
                self._release_locked(slot)


# -------------------------------- sequences --------------------------------
@dataclasses.dataclass
class KVSeq:
    """One sequence's view of the pool: slot table plus, per page, the
    published address (``None`` while the page is local-only — device
    resident, not yet a blob version — which is exactly the set of pages no
    other session can see)."""

    seq_id: int
    length: int  # tokens accounted so far
    slots: List[int]  # blob page indices, positional
    shared_tokens: int  # first shared_tokens came from the cluster directory
    page_addr: List[Optional[PageAddress]]  # publish address per page
    hashes: List[Optional[int]]  # chain hash per FULL prompt page
    shared: List[Tuple[int, PageAddress]]  # (directory key, addr) we hold
    owned: List[int] = dataclasses.field(default_factory=list)  # slots to free
    pinned_versions: List[int] = dataclasses.field(default_factory=list)
    pending: List[Tuple[int, int, object]] = dataclasses.field(
        default_factory=list
    )  # (page_index, slot, Future[version]) of in-flight publishes

    @property
    def n_shared_pages(self) -> int:
        return len(self.shared)


class BlobKVClient:
    """Per-engine façade: the :class:`PagedKVAllocator` lifecycle
    (admit/append/finish/table) re-expressed as blob operations through ONE
    session. Not thread-safe (one client per engine loop, like the host
    allocator); any number of clients share one :class:`BlobKVStore`."""

    def __init__(
        self,
        store: BlobKVStore,
        session: Optional[Session] = None,
        use_prefix_cache: bool = True,
    ) -> None:
        self.store = store
        self.session = session if session is not None else store.cluster.session()
        self.handle = self.session.open(store.blob_id)
        #: opt out of the cluster-wide prefix directory (benchmark A/B: a
        #: client that neither shares nor advertises prompt pages)
        self.use_prefix_cache = use_prefix_cache
        self._seqs: Dict[int, KVSeq] = {}
        self._next_seq = 0
        self.stats = {"admitted": 0, "shared_tokens": 0, "published_pages": 0,
                      "gathers": 0, "gather_reads": 0}

    # -- lifecycle -----------------------------------------------------------
    def admit(self, tokens: Sequence[int]) -> Tuple[KVSeq, int, List[Tuple[int, PageAddress]]]:
        """Admit a prompt. Returns ``(seq, n_shared_tokens, fetches)`` where
        ``fetches`` lists the shared pages as ``(page_index, PageAddress)``
        — the engine reads any it doesn't hold device-resident via
        :meth:`fetch_pages` (shared cache tier → usually free). Only FULL
        prompt pages are shared cluster-wide; the partial tail page is
        always fresh (cross-user COW of a mutable head has no meaning on an
        immutable blob). Raises ``MemoryError`` (with all acquisitions
        rolled back) when the pool is exhausted."""
        tokens = tuple(int(t) for t in tokens)
        T = self.store.page_tokens
        slots: List[int] = []
        page_addr: List[Optional[PageAddress]] = []
        hashes: List[Optional[int]] = []
        shared: List[Tuple[int, PageAddress]] = []
        h = 0
        while self.use_prefix_cache and (len(shared) + 1) * T <= len(tokens):
            h2 = chain_hash(h, tokens[len(shared) * T : (len(shared) + 1) * T])
            addr = self.store.lookup_prefix(h2)
            if addr is None:
                break
            slots.append(addr.page)
            page_addr.append(addr)
            hashes.append(h2)
            shared.append((h2, addr))
            h = h2
        n_shared = len(shared) * T

        # chain hashes of the remaining FULL pages (fresh, publishable)
        n_full = len(tokens) // T
        for i in range(len(shared), n_full):
            h = chain_hash(h, tokens[i * T : (i + 1) * T])
            hashes.append(h)
        rest = len(tokens) - n_shared
        n_fresh = (rest + T - 1) // T
        if len(tokens) % T:
            hashes.append(None)  # the partial tail page has no full-page hash
        try:
            fresh = self.store.alloc_slots(n_fresh)
        except MemoryError:
            for key, addr in shared:
                self.store.release_prefix(key, addr)
            raise
        slots.extend(fresh)
        page_addr.extend([None] * n_fresh)

        seq = KVSeq(
            self._next_seq, len(tokens), slots, n_shared, page_addr, hashes,
            shared, owned=list(fresh),
        )
        self._next_seq += 1
        self._seqs[seq.seq_id] = seq
        self.stats["admitted"] += 1
        self.stats["shared_tokens"] += n_shared
        return seq, n_shared, list(enumerate(page_addr[: len(shared)]))

    def fork_for_batch(self, seq: KVSeq, busy) -> List[Tuple[int, int]]:
        """Fork any slot of ``seq`` that another live row of the same decode
        batch already schedules (``busy``): the owner-indexed attention kernel
        gives each pool page exactly one owner row per batch, so concurrent
        rows must be page-disjoint. The fork is a device copy into a fresh
        slot — the shared bytes were already fetched, nothing is recomputed
        and the directory entry (still advertising the donor's published page)
        is untouched; this sequence's directory refs are dropped at
        ``finish`` as usual. Returns (src, dst) device copies; on
        ``MemoryError`` the sequence stays consistent (roll back via
        :meth:`finish`)."""
        copies: List[Tuple[int, int]] = []
        for i, slot in enumerate(seq.slots):
            if slot not in busy:
                continue
            fresh = self.store.alloc_slots(1)[0]
            copies.append((slot, fresh))
            seq.slots[i] = fresh
            seq.owned.append(fresh)
            seq.page_addr[i] = None  # local-only: never republished
        return copies

    def append_token(self, seq: KVSeq) -> Optional[int]:
        """Account one decoded token; returns a freshly allocated slot when
        the head page grew (the engine writes device-side only — blob
        publication happens per *filled* page via
        :meth:`publish_page_async`)."""
        head = seq.length // self.store.page_tokens
        grown: Optional[int] = None
        if head >= len(seq.slots):
            grown = self.store.alloc_slots(1)[0]
            seq.slots.append(grown)
            seq.owned.append(grown)
            seq.page_addr.append(None)
            seq.hashes.append(None)
        else:
            # writing into a published page would desynchronize the device
            # copy from the immutable blob bytes — the table construction
            # above guarantees the head is always a fresh local page
            assert seq.page_addr[head] is None, "decode write into published page"
        seq.length += 1
        return grown

    def finish(self, seq: KVSeq) -> None:
        """Drain publishes, drop every pin/reference this sequence holds.
        Published pages remain readable by anyone who pinned them (directory
        entries, other sequences' snapshots) — exactly the paper's 'old
        versions stay readable'."""
        self.drain_publishes(seq)
        for version in seq.pinned_versions:
            self.store.cluster.unpin_version(self.store.blob_id, version)
        seq.pinned_versions.clear()
        for key, addr in seq.shared:
            self.store.release_prefix(key, addr)
        for slot in seq.owned:
            self.store.release_slot(slot)
        seq.shared = []
        seq.owned = []
        seq.slots = []
        self._seqs.pop(seq.seq_id, None)

    def table(self, seq: KVSeq, max_pages: int) -> List[int]:
        """Device page-table row, padded with the out-of-bounds sentinel."""
        pad = [self.store.n_pages] * (max_pages - len(seq.slots))
        return list(seq.slots) + pad

    # -- publish (scatter) ---------------------------------------------------
    def publish_prompt(self, seq: KVSeq, payloads: Dict[int, np.ndarray]) -> List[int]:
        """Publish the fresh FULL prompt pages (``payloads``: page index →
        packed page buffer) as ONE ``writev``: contiguous slot runs coalesce
        into single patches, so the whole prompt usually publishes as one
        version — which is what lets :meth:`gather` compile the page table
        into a single readv plan. Each page is then content-registered in
        the cluster directory."""
        if not payloads:
            return []
        items = sorted(payloads.items())
        page_size = self.store.page_size
        runs: List[List[Tuple[int, np.ndarray]]] = [[items[0]]]
        for idx, buf in items[1:]:
            last_idx, _ = runs[-1][-1]
            if idx == last_idx + 1 and seq.slots[idx] == seq.slots[last_idx] + 1:
                runs[-1].append((idx, buf))
            else:
                runs.append([(idx, buf)])
        patches = [
            (
                seq.slots[run[0][0]] * page_size,
                np.concatenate([np.asarray(buf, np.uint8) for _, buf in run]),
            )
            for run in runs
        ]
        versions = self.handle.writev(patches)
        for run, version in zip(runs, versions):
            # writev success means durable; publication is IN-ORDER behind
            # concurrent writers' versions — wait for the frontier to reach
            # us, then pin (the paper's ordered publication, per §IV)
            self.handle.wait_for_version(version)
            self.store.cluster.pin_published(self.store.blob_id, version)
            seq.pinned_versions.append(version)
            for idx, _ in run:
                addr = PageAddress(self.store.blob_id, version, seq.slots[idx])
                seq.page_addr[idx] = addr
                self.stats["published_pages"] += 1
                if self.use_prefix_cache and seq.hashes[idx] is not None:
                    self.store.register_prefix(
                        seq.hashes[idx], seq.slots[idx], version
                    )
        return versions

    def publish_page_async(self, seq: KVSeq, page_index: int, payload: np.ndarray) -> None:
        """Queue one filled decode page into the session's bounded async
        write window (the paper's overlapped write pipeline); resolved by
        :meth:`drain_publishes`."""
        slot = seq.slots[page_index]
        fut = self.handle.write_async(
            np.asarray(payload, np.uint8), slot * self.store.page_size
        )
        seq.pending.append((page_index, slot, fut))

    def drain_publishes(self, seq: KVSeq) -> None:
        pending, seq.pending = seq.pending, []
        for page_index, slot, fut in pending:
            version = fut.result()
            self.handle.wait_for_version(version)  # in-order publication
            self.store.cluster.pin_published(self.store.blob_id, version)
            seq.pinned_versions.append(version)
            seq.page_addr[page_index] = PageAddress(
                self.store.blob_id, version, slot
            )
            self.stats["published_pages"] += 1

    def pending_pages(self, seq: KVSeq) -> List[int]:
        return [idx for idx, _, _ in seq.pending]

    # -- gather (the readv plan) ---------------------------------------------
    def gather(
        self, seq: KVSeq, page_indices: Optional[Sequence[int]] = None
    ) -> List[Tuple[int, np.ndarray]]:
        """Compile the sequence's page table into a readv plan and execute
        it: published pages grouped by version, ONE vectored page read per
        group (full-page segments are zero-copy views of cached pages).
        Local-only (unpublished) pages are skipped — they exist solely in
        the owning engine's device pool, which is why no other session can
        ever observe them. Returns ``(page_index, bytes)`` pairs."""
        idxs = range(len(seq.slots)) if page_indices is None else page_indices
        plan: Dict[int, List[Tuple[int, int]]] = {}
        for i in idxs:
            addr = seq.page_addr[i]
            if addr is None:
                continue
            plan.setdefault(addr.version, []).append((i, addr.page))
        out: List[Tuple[int, np.ndarray]] = []
        self.stats["gathers"] += 1
        for version in sorted(plan):
            group = plan[version]
            data = self.session.read_pages(
                self.store.blob_id, version, [s for _, s in group], pinned=True
            )
            self.stats["gather_reads"] += 1
            out.extend((i, buf) for (i, _), buf in zip(group, data))
        return out

    def fetch_pages(self, addrs: Sequence[PageAddress]) -> List[np.ndarray]:
        """Read arbitrary published page addresses (grouped by version, one
        vectored read per group), preserving input order — the admit-time
        fetch of shared prefix pages into a device pool."""
        plan: Dict[int, List[Tuple[int, int]]] = {}
        for i, addr in enumerate(addrs):
            plan.setdefault(addr.version, []).append((i, addr.page))
        out: List[Optional[np.ndarray]] = [None] * len(addrs)
        for version, group in plan.items():
            data = self.session.read_pages(
                self.store.blob_id, version, [p for _, p in group], pinned=True
            )
            for (i, _), buf in zip(group, data):
                out[i] = buf
        return out  # type: ignore[return-value]
