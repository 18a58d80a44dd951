# Copy of src/repro/core/page_cache.py (the JAX package's storage core); only the package name in imports differs.
"""Client-side versioned page cache (scaling layer over the paper's design).

The paper's key property — a *published* version is immutable, its metadata
tree and data pages can never change (§III.C) — makes client-side caching
trivially coherent: a page keyed by ``(blob_id, version, page_index)`` is
valid forever, so the cache needs no invalidation protocol at all. Snapshot
re-reads (the supernovae detector differencing overlapping sky windows) then
hit RAM instead of issuing provider RPCs.

Two mechanisms live here:

* a thread-safe, byte-budgeted LRU over immutable pages;
* *single-flight* miss handling: when many concurrent readers miss on the
  same page, exactly one of them (the *leader*) fetches it from the provider
  while the others wait on the in-flight entry — N concurrent readers of a
  cold hot-window cost one provider fetch per page, not N.

Pages enter the cache from two directions, both coherent for the same
reason — a version's page content is fixed the moment its data is stored,
before it even publishes:

* the read path caches fetched pages of *published* versions (reads of
  unpublished versions are rejected before the cache is consulted);
* the write path **writes through**: a successful ``writev`` inserts its own
  just-stored pages under its freshly assigned versions, so a writer's
  re-reads of its own data are RAM hits with no provider round-trip. Readers
  still cannot *see* those versions until the version manager publishes
  them — visibility is gated upstream, never by the cache.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.lockwatch import make_lock
from repro_torch.core.dht import TrafficStats

#: Cache key: (blob_id, version, page_index).
CacheKey = Tuple[int, int, int]

#: Budget charge for an implicit zero page: all zero-page entries share one
#: read-only buffer, so their marginal memory cost is just the LRU slot —
#: caching them skips the metadata re-traversal on repeat sparse reads
#: without letting them evict genuinely expensive provider-fetched pages.
ZERO_PAGE_CHARGE = 64


class _Flight:
    """An in-flight fetch: leader fulfills/aborts, followers wait.

    ``gen`` stamps the cache generation the flight was planned under: a
    purge (:meth:`PageCache.clear` / :meth:`PageCache.drop_versions`)
    advances the generation, so a fill that was already in flight when GC
    purged its version wakes its waiters but is NOT inserted — without this,
    the stale insert would silently resurrect a collected version in the
    cache the purge just scrubbed."""

    __slots__ = ("event", "page", "error", "gen")

    def __init__(self, gen: int = 0) -> None:
        self.event = threading.Event()
        self.page: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.gen = gen


@dataclasses.dataclass
class FetchPlan:
    """Partition of a lookup batch: RAM hits, keys this caller must fetch
    (it is the single-flight leader for them), and keys being fetched by
    concurrent leaders (wait on the flight)."""

    hits: Dict[CacheKey, np.ndarray]
    owned: List[CacheKey]
    waits: Dict[CacheKey, "_Flight"]


class PageCache:
    """Byte-budgeted LRU of immutable published pages, with single-flight."""

    def __init__(self, capacity_bytes: int, stats: Optional[TrafficStats] = None) -> None:
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive")
        self.capacity_bytes = capacity_bytes
        self.stats = stats or TrafficStats()
        self._lock = make_lock("PageCache._lock")
        #: key -> (page, budget charge); the charge is usually page.nbytes
        #: but nominal for entries sharing a buffer (zero pages)
        self._lru: "OrderedDict[CacheKey, Tuple[np.ndarray, int]]" = OrderedDict()
        self._inflight: Dict[CacheKey, _Flight] = {}
        self._used_bytes = 0
        self.evictions = 0
        #: purge generation — bumped by clear()/drop_versions() so in-flight
        #: fills planned before a purge cannot re-insert after it
        self._gen = 0

    # -- bulk lookup (the readv path) ------------------------------------------
    def plan(self, keys: Sequence[CacheKey], record: bool = True) -> FetchPlan:
        """Classify ``keys`` in one lock pass. The caller MUST eventually
        :meth:`fulfill` or :meth:`abort` every key in ``plan.owned`` — even on
        error paths — or concurrent waiters block forever.

        ``record=False`` skips the hit/miss stats recording — a session
        composing this cache into a multi-tier stack attributes hits and
        misses itself (per-session AND cluster-aggregate), so the cache must
        not double-count them here."""
        hits: Dict[CacheKey, np.ndarray] = {}
        owned: List[CacheKey] = []
        owned_set: set = set()
        waits: Dict[CacheKey, _Flight] = {}
        with self._lock:
            for key in keys:
                # a duplicate key must not land in waits for a flight this
                # very call created (self-deadlock for callers that drain
                # waits before fulfilling owned)
                if key in hits or key in waits or key in owned_set:
                    continue
                entry = self._lru.get(key)
                if entry is not None:
                    self._lru.move_to_end(key)
                    hits[key] = entry[0]
                    continue
                flight = self._inflight.get(key)
                if flight is not None:
                    waits[key] = flight
                else:
                    self._inflight[key] = _Flight(self._gen)
                    owned.append(key)
                    owned_set.add(key)
        if record:
            self.stats.record_cache(hits=len(hits), misses=len(owned) + len(waits))
        return FetchPlan(hits=hits, owned=owned, waits=waits)

    def fulfill(self, key: CacheKey, page: np.ndarray, charge: Optional[int] = None) -> None:
        """Leader completed the fetch: cache the page, wake waiters.

        ``charge`` overrides the budget accounting for this entry (default:
        ``page.nbytes``) — pass :data:`ZERO_PAGE_CHARGE` for implicit zero
        pages, whose buffer is shared across all entries."""
        page = page.view()
        page.flags.writeable = False  # cached pages are immutable
        with self._lock:
            flight = self._inflight.pop(key, None)
            # a fill planned before a purge must not re-insert after it: the
            # waiters still get their page (they validated the version before
            # the purge, like any read already in progress at GC time), but
            # the cache stays scrubbed
            if flight is None or flight.gen == self._gen:
                self._insert(
                    key, page, page.nbytes if charge is None else charge
                )
        if flight is not None:
            flight.page = page
            flight.event.set()

    def abort(self, key: CacheKey, error: BaseException) -> None:
        """Leader failed: propagate the error to waiters, cache nothing."""
        with self._lock:
            flight = self._inflight.pop(key, None)
        if flight is not None:
            flight.error = error
            flight.event.set()

    def wait(self, key: CacheKey, flight: _Flight, timeout: Optional[float] = None) -> np.ndarray:
        """Follower path: block until the leader resolves ``key``."""
        if not flight.event.wait(timeout):
            raise TimeoutError(f"page fetch for {key} did not complete")
        if flight.error is not None:
            raise flight.error
        assert flight.page is not None
        return flight.page

    def get_many(self, keys: Sequence[CacheKey]) -> Dict[CacheKey, np.ndarray]:
        """Bulk hit-only lookup in ONE lock pass (no single-flight, no stats):
        the private-tier probe of a session's multi-tier read path — misses
        simply fall through to the shared tier."""
        hits: Dict[CacheKey, np.ndarray] = {}
        with self._lock:
            for key in keys:
                entry = self._lru.get(key)
                if entry is not None:
                    self._lru.move_to_end(key)
                    hits[key] = entry[0]
        return hits

    # -- simple single-page API (tests, boundary merges) -----------------------
    def get(self, key: CacheKey) -> Optional[np.ndarray]:
        with self._lock:
            entry = self._lru.get(key)
            if entry is None:
                return None
            self._lru.move_to_end(key)
            return entry[0]

    def put(self, key: CacheKey, page: np.ndarray) -> None:
        page = page.view()
        page.flags.writeable = False
        with self._lock:
            self._insert(key, page, page.nbytes)

    def put_many(self, items: Sequence[Tuple[CacheKey, np.ndarray]]) -> None:
        """Bulk insert under ONE lock acquisition — the write-through path of
        ``writev`` inserts every page of a patch batch in one pass."""
        frozen = []
        for key, page in items:
            page = page.view()
            page.flags.writeable = False
            frozen.append((key, page))
        with self._lock:
            for key, page in frozen:
                self._insert(key, page, page.nbytes)

    # -- internals --------------------------------------------------------------
    def _insert(self, key: CacheKey, page: np.ndarray, charge: int) -> None:
        if charge > self.capacity_bytes:
            return  # entry can never fit; don't wipe the whole cache for it
        old = self._lru.pop(key, None)
        if old is not None:
            self._used_bytes -= old[1]
        self._lru[key] = (page, charge)
        self._used_bytes += charge
        while self._used_bytes > self.capacity_bytes:
            _, (_, evicted_charge) = self._lru.popitem(last=False)
            self._used_bytes -= evicted_charge
            self.evictions += 1

    # -- introspection -----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def __contains__(self, key: CacheKey) -> bool:
        with self._lock:
            return key in self._lru

    def used_bytes(self) -> int:
        with self._lock:
            return self._used_bytes

    def cached_versions(self, blob_id: int) -> List[int]:
        """Distinct versions of ``blob_id`` with at least one cached page."""
        with self._lock:
            return sorted({k[1] for k in self._lru if k[0] == blob_id})

    def drop_versions(
        self, blob_id: int, keep: set, max_version: Optional[int] = None
    ) -> int:
        """GC coherence hook: purge cached pages of ``blob_id`` whose version
        is not in ``keep``. ``max_version`` (the publish frontier at GC time)
        protects versions above it — in-flight write-through entries whose
        backing pages GC never touches. Returns the number of pages
        dropped."""
        with self._lock:
            # invalidate in-flight fills too: a leader that planned a doomed
            # version's page before this purge may fulfill after it
            self._gen += 1
            doomed = [
                k
                for k in self._lru
                if k[0] == blob_id
                and k[1] not in keep
                and (max_version is None or k[1] <= max_version)
            ]
            for key in doomed:
                self._used_bytes -= self._lru.pop(key)[1]
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._gen += 1  # fence in-flight fills out of the emptied cache
            self._lru.clear()
            self._used_bytes = 0
