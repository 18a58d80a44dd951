# Copy of src/repro/core/page_directory.py (the JAX package's storage core); only the package name in imports differs.
"""Cluster-wide content-addressed page directory (the serving plane's
cross-user prefix cache, kept storage-generic).

The paper's snapshot model makes *published* pages immutable, so a page's
identity can be its content: this directory maps an integer content key (the
KV plane uses a token-chain hash) to the ``(blob_id, version, page)`` triple
where those bytes live. Any session on the cluster that resolves the same
key reads the same stored page — through the node's shared cache tier — so N
clients sharing a prompt prefix cost one stored copy and (at most) one
provider fetch, the paper's "sharing common parts of snapshots" applied to
inference serving.

GC safety is snapshot pinning, not refcounts on bytes: publishing an entry
pins its version via :meth:`Cluster.pin_published` (which *validates the
publish frontier first* — an unpublished version can never be registered, so
a cross-session read through the directory is impossible before the writer
publishes). Eviction drops the pin; readers that still hold the entry's
refcount keep it alive, and readers that pinned their own covering version
keep the *bytes* alive even after eviction, because a pinned version's tree
reaches every page written at-or-before it.

Locking: ``PageDirectory._lock`` (level 3) guards only dict/LRU state. Pins
are taken *before* the lock (they serialize against GC on the cluster's
level-1 guard) and dropped *after* it; eviction hooks fire outside the lock.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, TYPE_CHECKING, Tuple

from repro_torch.analysis.lockwatch import make_lock

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (cluster owns us)
    from repro_torch.core.cluster import Cluster


@dataclasses.dataclass(frozen=True)
class PageAddress:
    """Where one published page's bytes live: immutable forever (the paper's
    versioned-WRITE guarantee), so the triple can be shared freely across
    sessions and cached under a stable key."""

    blob_id: int
    version: int
    page: int


class _Entry:
    __slots__ = ("address", "refcount")

    def __init__(self, address: PageAddress) -> None:
        self.address = address
        self.refcount = 0


class PageDirectory:
    """Content key → :class:`PageAddress` registry with per-entry refcounts,
    LRU eviction of unreferenced entries, and version pinning.

    ``on_evict`` hooks (see :meth:`add_evict_hook`) let a page-pool owner
    (e.g. the blob-backed KV store) return slot bookkeeping when the
    directory drops an entry; hooks run outside the directory lock."""

    def __init__(self, cluster: "Cluster", capacity: int = 4096) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.cluster = cluster
        self.capacity = capacity
        self._lock = make_lock("PageDirectory._lock")
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._evict_hooks: List[Callable[[int, PageAddress], None]] = []
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- eviction hooks -------------------------------------------------------
    def add_evict_hook(self, hook: Callable[[int, PageAddress], None]) -> None:
        with self._lock:
            self._evict_hooks.append(hook)

    def _fire_evictions(self, victims: List[Tuple[int, PageAddress]]) -> None:
        """Unpin + notify for evicted entries — NEVER under ``_lock`` (hooks
        take their owners' locks; the unpin takes the cluster pin table)."""
        with self._lock:
            hooks = list(self._evict_hooks)
        for key, address in victims:
            self.cluster.unpin_version(address.blob_id, address.version)
            for hook in hooks:
                hook(key, address)

    # -- registration ---------------------------------------------------------
    def publish(
        self, key: int, blob_id: int, version: int, page: int
    ) -> PageAddress:
        """Register ``key`` → ``(blob_id, version, page)``. The version is
        validated against the publish frontier and snapshot-pinned *before*
        the entry becomes visible — registering an unpublished (or abandoned)
        version raises, which is what makes a cross-session read of
        unpublished data through the directory impossible by construction.

        Returns the winning address: on a registration race the FIRST entry
        for ``key`` is kept (its pages are already shared) and the loser's
        pin is dropped."""
        # pin first (validates published + serializes against GC); only then
        # expose the entry — a reader can never resolve an unpinned address
        self.cluster.pin_published(blob_id, version)
        address = PageAddress(blob_id, version, page)
        victims: List[Tuple[int, PageAddress]] = []
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                self._entries.move_to_end(key)
                winner = existing.address
            else:
                self._entries[key] = _Entry(address)
                winner = address
                # soft capacity: evict unreferenced LRU entries; referenced
                # entries may push the directory over budget until released
                over = len(self._entries) - self.capacity
                if over > 0:
                    for k in list(self._entries):
                        if over <= 0:
                            break
                        if k != key and self._entries[k].refcount == 0:
                            victims.append((k, self._entries.pop(k).address))
                            over -= 1
        if winner is not address:
            self.cluster.unpin_version(blob_id, version)
        if victims:
            self.evictions += len(victims)
            self._fire_evictions(victims)
        return winner

    # -- lookup ---------------------------------------------------------------
    def acquire(self, key: int) -> Optional[PageAddress]:
        """Resolve ``key`` and take a refcount on the entry (it cannot be
        evicted until :meth:`release`); ``None`` on miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            entry.refcount += 1
            self._entries.move_to_end(key)
            self.hits += 1
            return entry.address

    def peek(self, key: int) -> Optional[PageAddress]:
        """Resolve without refcounting or LRU side effects (introspection)."""
        with self._lock:
            entry = self._entries.get(key)
            return entry.address if entry is not None else None

    def release(self, key: int) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.refcount > 0:
                entry.refcount -= 1

    # -- eviction under pressure ---------------------------------------------
    def evict_unreferenced(
        self, n: int = 1, blob_id: Optional[int] = None
    ) -> int:
        """Drop up to ``n`` unreferenced entries, LRU-first (optionally only
        entries of ``blob_id`` — a page pool reclaiming its own slots).
        Returns how many were evicted; 0 means every entry is in use."""
        victims: List[Tuple[int, PageAddress]] = []
        with self._lock:
            for key in list(self._entries):
                if len(victims) >= n:
                    break
                entry = self._entries[key]
                if entry.refcount:
                    continue
                if blob_id is not None and entry.address.blob_id != blob_id:
                    continue
                victims.append((key, self._entries.pop(key).address))
        if victims:
            self.evictions += len(victims)
            self._fire_evictions(victims)
        return len(victims)

    # -- introspection --------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: int) -> bool:
        with self._lock:
            return key in self._entries

    def addresses(self) -> Dict[int, PageAddress]:
        """Snapshot of the full mapping (tests / invariant checks)."""
        with self._lock:
            return {k: e.address for k, e in self._entries.items()}

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
