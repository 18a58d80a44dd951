# Copy of src/repro/core/cluster.py (the JAX package's storage core); only the package name in imports
# differs, apart from Cluster._gc_locked, which always keeps the newest published version.
"""Cluster / Session / BlobHandle: the layered client API (paper §III).

The paper's architecture separates the *shared infrastructure* — version
manager, metadata providers, data providers — from the *client library* each
concurrent reader/writer embeds (§III.A vs §III.B). This module makes that
split explicit in the API, the way BlobSeer exposes its versioned
``create/read/write/clone`` client interface:

* :class:`Cluster` owns the shared plane: the :class:`VersionManager` (the
  system's only serialization point), the :class:`MetadataDHT`, the
  :class:`ProviderManager` and its :class:`DataProvider`\\ s, the
  :class:`ReplicaBalancer`, the data-plane thread pool, and a **node-level
  shared page-cache tier** (many detector threads on one node, one cache).
* :class:`Session` (``cluster.session()``) owns per-client state: a private
  write-through page cache in front of the shared tier, its own
  :class:`TrafficStats`, the ``write_async`` bounded in-flight window, and
  replica-choice randomness. N sessions on one cluster model the paper's
  N-concurrent-clients topology in-process without N copies of the providers.
* :class:`BlobHandle` (``session.open(blob_id)``) carries the fine-grain data
  ops — ``read``/``readv``/``write``/``writev``/``write_async`` — plus
  :meth:`BlobHandle.snapshot`/:meth:`BlobHandle.at` returning an immutable
  :class:`Snapshot` that pins a published version for lock-free repeated
  reads (no version-manager round-trip per read, and GC will not collect a
  pinned version), and :meth:`BlobHandle.watch`, a publish-subscription built
  on ``VersionManager.wait_published`` so readers react to newly published
  versions instead of polling.

Cache coherence across sessions is the publish frontier: a session's private
cache is write-through under the versions the manager assigned to it, so the
moment one of its writes publishes, its own re-reads are RAM hits (reads of
still-unpublished versions are rejected at the frontier for everyone,
including the writer). The shared tier is filled exclusively by the read
path, which resolves and validates the version against the publish frontier
first — so an unpublished page can never enter the shared tier, and a
cross-session read of an unpublished version is impossible by construction.

The write path is the overlapped pipeline of the write-plane PR (data puts
launched first; version assignment, tree weaving and per-shard node puts all
run while data is in flight; one join before success is reported; failures
clean up after themselves via ``VersionManager.abandon``), and transport is
zero-copy end to end. See :mod:`repro.core.blob` for the deprecated
single-object facade.
"""

from __future__ import annotations

import dataclasses
import functools
import random
import threading
import time
from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.analysis.lockwatch import make_lock
from repro_torch.core.dht import (
    MetadataDHT,
    ProviderFailed,
    RetryPolicy,
    TrafficStats,
    page_checksum,
)
from repro_torch.core.page_cache import PageCache, ZERO_PAGE_CHARGE
from repro_torch.core.page_directory import PageDirectory
from repro_torch.core.prefetch import PrefetchConfig, StridePrefetcher, WatchWarmer
from repro_torch.core.provider import DataProvider, HealthConfig, ProviderManager
from repro_torch.core.repair import RepairService
from repro_torch.core.replica_balancer import BalancerConfig, ReplicaBalancer
from repro_torch.core.segment_tree import (
    NodeKey,
    PageRef,
    TreeNode,
    ZERO_VERSION,
    build_write_tree,
    traverse_batch,
)
from repro_torch.core.version_manager import VersionAbandoned, VersionManager

#: Default per-session (private) page-cache budget in bytes; ``cache_bytes=0``
#: disables the private tier.
DEFAULT_CACHE_BYTES = 64 << 20
#: Default node-level shared cache tier budget in bytes;
#: ``shared_cache_bytes=0`` disables the shared tier (each session then runs
#: a standalone private cache, the pre-split topology).
DEFAULT_SHARED_CACHE_BYTES = 256 << 20


# NOTE: RetryPolicy lives in repro.core.dht now (both planes share it); the
# import above keeps ``from repro.core.cluster import RetryPolicy`` working.


@dataclasses.dataclass
class ReadResult:
    latest_published: int
    data: np.ndarray


@functools.lru_cache(maxsize=8)
def _zero_page(page_size: int) -> np.ndarray:
    page = np.zeros(page_size, dtype=np.uint8)
    page.flags.writeable = False
    return page


def _merge_ranges(pages: Sequence[int]) -> List[Tuple[int, int]]:
    """Collapse a sorted page-index list into (offset, size) runs."""
    ranges: List[Tuple[int, int]] = []
    for p in pages:
        if ranges and ranges[-1][0] + ranges[-1][1] == p:
            ranges[-1] = (ranges[-1][0], ranges[-1][1] + 1)
        else:
            ranges.append((p, 1))
    return ranges


class _PageFetchStream:
    """Incremental data-plane fetcher — the streaming half of the read
    pipeline.

    :meth:`submit` may be called concurrently from metadata-RPC workers as
    traversal levels resolve leaves: each call immediately launches one
    aggregated ``get_pages`` future per serving provider for the batch's NEW
    pages (replica-spread exactly like the phased path), so data transfer is
    in flight while deeper metadata rounds are still running. :meth:`join`
    is the pipeline's single barrier: it collects every launched future,
    runs per-page replica fallback for failed provider batches, feeds the
    balancer's heat counters once, and returns the assembled
    ``{page_index: page_or_None}`` map."""

    __slots__ = ("_session", "_page_size", "_lock", "_seen", "_read_load",
                 "_queues", "_scheduled", "_futures", "_result")

    def __init__(self, session: "Session", page_size: int) -> None:
        self._session = session
        self._page_size = page_size
        self._lock = make_lock("_PageFetchStream._lock")
        self._seen: Set[int] = set()
        self._read_load: Optional[Dict[int, int]] = None
        #: pending items per provider, drained by at most one in-flight
        #: drain task per provider — emissions that land while a provider's
        #: drain is still queued MERGE into its batch, so near-simultaneous
        #: leaf deliveries (the common case: one level's shard RPCs complete
        #: together) keep the one-aggregated-RPC-per-provider shape
        self._queues: Dict[int, List[Tuple[int, int, TreeNode]]] = {}
        self._scheduled: Set[int] = set()
        self._futures: List[Future] = []
        self._result: Dict[int, Optional[np.ndarray]] = {}

    def submit(self, leaves: Dict[int, Optional[TreeNode]]) -> None:
        """Launch fetches for every not-yet-seen page of ``leaves`` (pages
        are deduplicated across calls, so the level-end catch-all emission
        can safely re-deliver leaves a streaming ``get_nodes`` already
        handed over). ``None`` leaves (implicit zero pages) are recorded as
        results directly — nothing to fetch."""
        session = self._session
        with self._lock:
            for page_index, leaf in leaves.items():
                if page_index in self._seen:
                    continue
                self._seen.add(page_index)
                if leaf is None:
                    self._result[page_index] = None
                    continue
                if session.replica_spread and len(leaf.all_page_refs()) > 1:
                    # stats snapshot deferred until a leaf actually has a
                    # choice — single-replica reads skip the global lock
                    if self._read_load is None:
                        self._read_load = session.cluster.stats.read_bytes_snapshot()
                    pid, key = session._choose_ref(
                        leaf, self._read_load, self._page_size
                    )
                else:
                    pid, key = leaf.page  # type: ignore[misc]
                self._queues.setdefault(pid, []).append((page_index, key, leaf))
                if pid not in self._scheduled:
                    self._scheduled.add(pid)
                    self._futures.append(
                        session._pool.submit(self._drain, pid)
                    )

    def _drain(
        self, pid: int
    ) -> Tuple[int, List[Tuple[int, int, TreeNode]], Optional[Dict[int, np.ndarray]]]:
        """One aggregated ``get_pages`` RPC covering everything queued for
        ``pid`` at execution time."""
        with self._lock:
            items = self._queues.pop(pid, [])
            self._scheduled.discard(pid)
        if not items:
            return pid, items, {}
        return pid, items, self._session._get_batch(pid, items)

    def submit_partial(self, nodes: Dict[NodeKey, TreeNode]) -> None:
        """Adapter for :meth:`MetadataDHT.get_nodes`'s ``on_partial`` hook:
        every leaf in a shard's partial result is a wanted page (the
        traversal only ever asks for wanted keys), so fetch it right away."""
        leaves = {
            key.offset: node for key, node in nodes.items() if node.is_leaf
        }
        if leaves:
            self.submit(leaves)

    def join(self) -> Dict[int, Optional[np.ndarray]]:
        session = self._session
        #: (page, leaf, skip_pid, corrupt_refs): pages needing per-page
        #: replica fallback — the whole batch when the provider failed, or
        #: individual pages whose fetched bytes failed checksum verification
        #: (those also carry the corrupt copy's ref so it gets repaired)
        fallback: List[Tuple[int, TreeNode, int, Tuple]] = []
        fetched_leaves: List[TreeNode] = []
        # drain futures may schedule no successors, so a single pass over
        # the (append-only) future list until it stops growing joins all
        done = 0
        while True:
            with self._lock:
                futures = list(self._futures)
            if done == len(futures):
                break
            for f in futures[done:]:
                pid, items, got = f.result()
                fetched_leaves.extend(leaf for _, _, leaf in items)
                if got is None:
                    fallback.extend((p, leaf, pid, ()) for p, _, leaf in items)
                else:
                    self._result.update(got)
                    # pages absent from a successful batch failed their
                    # checksum: fall back AND repair the corrupt copy
                    fallback.extend(
                        (p, leaf, pid, ((pid, key),))
                        for p, key, leaf in items
                        if p not in got
                    )
            done = len(futures)
        if fallback:
            # replica fallback in parallel, skipping the observed-dead choice;
            # tracked in _futures so quiesce() covers a fallback that raises
            # mid-join (all replicas dead) with siblings still in flight.
            # This read is DEGRADED: it completed, but only via surviving
            # replicas — count it so operators see reads running on
            # reduced redundancy before repair restores the factor
            session._record_fallback(len(fallback))
            session._record_degraded(1)
            fb = [
                session._pool.submit(
                    session._fetch_single, p, leaf, skip, corrupt
                )
                for p, leaf, skip, corrupt in fallback
            ]
            with self._lock:
                self._futures.extend(fb)
            for (p, _, _, _), f in zip(fallback, fb):
                self._result[p] = f.result()
        if session.cluster.replica_balancer is not None and fetched_leaves:
            session.cluster.replica_balancer.note_fetches(fetched_leaves)
        return self._result

    def quiesce(self) -> None:
        """Error path: wait out every in-flight fetch without raising, so an
        aborted read leaves no future scribbling into shared state."""
        done = 0
        while True:
            with self._lock:
                futures = list(self._futures)
            if done == len(futures):
                break
            for f in futures[done:]:
                f.exception()
            done = len(futures)


class Cluster:
    """The shared plane: the five actors of the paper's architecture plus the
    node-level shared cache tier, wired once and shared by every
    :class:`Session`."""

    def __init__(
        self,
        n_data_providers: int = 4,
        n_metadata_providers: int = 4,
        page_replication: int = 1,
        metadata_replication: int = 1,
        max_workers: int = 8,
        shared_cache_bytes: int = DEFAULT_SHARED_CACHE_BYTES,
        hot_replicas: bool = True,
        balancer_config: Optional[BalancerConfig] = None,
        page_service_seconds: float = 0.0,
        metadata_latency_seconds: float = 0.0,
        retry_policy: Optional[RetryPolicy] = None,
        health: Optional[HealthConfig] = None,
        metadata_timeout_seconds: Optional[float] = None,
        page_directory_capacity: int = 4096,
        version_manager: Optional[VersionManager] = None,
        provider_manager: Optional[ProviderManager] = None,
        metadata: Optional[MetadataDHT] = None,
    ) -> None:
        #: cluster-wide aggregate traffic (every session records here too)
        self.stats = TrafficStats()
        #: RPC retry/backoff policy, shared by BOTH planes (injectable for
        #: chaos tests); ``health`` likewise configures both health machines
        self.retry_policy = retry_policy or RetryPolicy()
        #: federated mode (``Federation``): the three shared-plane actors are
        #: INJECTED — this cluster is one access node over a substrate it does
        #: not own, so it must not register providers, wire repair hooks, or
        #: tear the substrate down on close
        self._owns_substrate = (
            version_manager is None
            and provider_manager is None
            and metadata is None
        )
        self.version_manager = version_manager or VersionManager()
        self.provider_manager = provider_manager or ProviderManager(
            replication=page_replication, stats=self.stats, health=health
        )
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self.metadata = metadata or MetadataDHT(
            n_metadata_providers,
            replication=metadata_replication,
            stats=self.stats,
            executor=self._pool,
            rpc_latency_seconds=metadata_latency_seconds,
            retry_policy=self.retry_policy,
            health=health,
            rpc_timeout_seconds=metadata_timeout_seconds,
        )
        #: shared intra-node cache tier: filled ONLY by the read path (whose
        #: versions are validated against the publish frontier), hit by every
        #: session — the coherence argument is published-version immutability
        #: plus frontier gating, never an invalidation protocol
        self.shared_cache: Optional[PageCache] = (
            PageCache(shared_cache_bytes) if shared_cache_bytes else None
        )
        self.page_service_seconds = page_service_seconds
        if self._owns_substrate:
            for i in range(n_data_providers):
                self.provider_manager.register(
                    DataProvider(i, page_service_seconds)
                )
        self.replica_balancer: Optional[ReplicaBalancer] = (
            ReplicaBalancer(
                self.provider_manager, self.metadata, self.stats, balancer_config
            )
            if hot_replicas
            else None
        )
        #: self-healing: when the health machine declares a provider dead the
        #: manager's ``on_dead`` hook queues a background re-replication pass
        #: on the aux pool (the hook fires OUTSIDE the manager lock, so the
        #: level-4 ``_aux_lock`` acquisition below it is legal)
        self.repair_service = RepairService(self)
        if self._owns_substrate:
            self.provider_manager.on_dead = self.repair_service.schedule
            #: the metadata plane gets the same treatment: a shard death
            #: verdict queues a repair pass, whose metadata half re-replicates
            #: the dead replica's node set from survivors once it rejoins
            self.metadata.on_dead = self.repair_service.schedule
            self._next_provider_id = n_data_providers
        else:
            # the Federation wires ONE repair service (the home node's) to the
            # shared substrate's death verdicts — per-node hooks would race
            # concurrent repair passes over the same providers
            self._next_provider_id = (
                max(
                    (p.provider_id for p in self.provider_manager.providers()),
                    default=-1,
                )
                + 1
            )
        self._membership_lock = make_lock("Cluster._membership_lock")
        #: registered sessions (GC must purge every private cache tier)
        self._sessions: List["Session"] = []
        self._sessions_lock = make_lock("Cluster._sessions_lock")
        #: snapshot pins: blob_id -> version -> refcount; GC keeps pinned
        #: versions alive no matter what ``keep_versions`` says
        self._pins: Dict[int, Dict[int, int]] = {}
        self._pins_lock = make_lock("Cluster._pins_lock")
        #: linearizes snapshot creation against GC: a pin is taken either
        #: strictly before a GC pass reads the pin set (and is honored) or
        #: strictly after the pass completes — never mid-sweep, where the
        #: just-pinned version could still be collected (``_pins_lock`` alone
        #: cannot give that guarantee; it is held only for the dict ops)
        self._gc_guard = make_lock("Cluster._gc_guard")
        #: cluster-wide content-addressed page registry (the serving plane's
        #: cross-user prefix cache): published pages keyed by content, each
        #: entry snapshot-pinning its version so GC never collects a page the
        #: directory still advertises
        self.page_directory = PageDirectory(self, capacity=page_directory_capacity)
        #: monotonically numbers sessions (diversifies their RNG streams)
        self._session_counter = 0
        self._max_workers = max_workers
        #: auxiliary pool for background cache fills (stride prefetch): a
        #: fill task joins nested fan-out futures that run on the MAIN pool,
        #: and a main-pool worker doing that join could deadlock a saturated
        #: pool — so background fills get their own lane (lazily spawned)
        self._aux_pool: Optional[ThreadPoolExecutor] = None
        self._aux_lock = make_lock("Cluster._aux_lock")
        self._aux_closed = False
        self._closed = False
        #: live watch-warmers, stopped on close
        self._warmers: List[WatchWarmer] = []
        self._warmers_lock = make_lock("Cluster._warmers_lock")
        # -- federation plumbing (set by repro.core.federation.Federation) --
        #: back-reference when this cluster is one node of a Federation
        self._federation = None
        self._node_id: Optional[int] = None
        #: lease guard: returns True when this node's GC lease is valid (the
        #: cache tiers may serve); returning False means the node is FENCED —
        #: the read path falls through to the providers with no cache fills
        self._lease_guard: Optional[Callable[[], bool]] = None
        #: node gate: raises ``ProviderFailed`` when the node itself is down
        #: (killed/wedged by the chaos harness) — data ops fail at the door
        self._node_gate: Optional[Callable[[], None]] = None
        #: snapshot-pin forwarding to the federation's GC coordinator (pins
        #: must be visible to GC passes initiated from ANY node)
        self._pin_sink: Optional[Callable[[int, int], None]] = None
        self._unpin_sink: Optional[Callable[[int, int], None]] = None

    # -- sessions ------------------------------------------------------------
    def session(
        self,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        replica_spread: bool = True,
        sync_write: bool = False,
        sync_read: bool = False,
        max_inflight_writes: int = 8,
        prefetch: Optional[PrefetchConfig] = None,
    ) -> "Session":
        """Create one client :class:`Session` on this cluster. Every
        concurrent reader/writer of the paper's topology is one session.

        ``sync_read=True`` keeps the pre-pipeline *phased* read plane (full
        metadata traversal before the first page fetch — the ``sync-read``
        benchmark baseline); ``prefetch`` attaches a
        :class:`~repro.core.prefetch.StridePrefetcher` with the given config
        so sequential readers get bounded readahead into the shared tier."""
        with self._sessions_lock:
            index = self._session_counter
            self._session_counter += 1
        sess = Session(
            self,
            cache_bytes=cache_bytes,
            replica_spread=replica_spread,
            sync_write=sync_write,
            sync_read=sync_read,
            max_inflight_writes=max_inflight_writes,
            prefetch=prefetch,
            _index=index,
        )
        with self._sessions_lock:
            self._sessions.append(sess)
        return sess

    def _forget_session(self, sess: "Session") -> None:
        with self._sessions_lock:
            try:
                self._sessions.remove(sess)
            except ValueError:
                pass

    def sessions(self) -> List["Session"]:
        with self._sessions_lock:
            return list(self._sessions)

    # -- background fills (prefetch / warming) --------------------------------
    def _aux_submit(self, fn, *args) -> Future:
        """Run a background cache-fill task on the auxiliary pool — never on
        the main data-plane pool, whose workers must stay join-free. Raises
        ``RuntimeError`` once the cluster is closed (callers drop the fill)
        instead of silently resurrecting a pool nothing would shut down."""
        with self._aux_lock:
            if self._aux_closed:
                raise RuntimeError("cluster is closed")
            if self._aux_pool is None:
                self._aux_pool = ThreadPoolExecutor(
                    max_workers=max(4, self._max_workers // 2),
                    thread_name_prefix="prefetch",
                )
            return self._aux_pool.submit(fn, *args)

    def warm_on_publish(
        self,
        blob_id: int,
        top_pages: int = 256,
        frame_versions: Optional[int] = None,
    ) -> WatchWarmer:
        """Start a :class:`~repro.core.prefetch.WatchWarmer` for ``blob_id``:
        every freshly published version (every ``frame_versions``-th, if set)
        gets its hottest pages pulled into the shared tier before detector
        sessions ask. The warmer is stopped automatically on :meth:`close`;
        call :meth:`WatchWarmer.stop` to retire it earlier."""
        warmer = WatchWarmer(
            self, blob_id, top_pages=top_pages, frame_versions=frame_versions
        )
        with self._warmers_lock:
            self._warmers.append(warmer)
        return warmer

    # -- elasticity ----------------------------------------------------------
    def add_data_provider(self) -> int:
        with self._membership_lock:
            pid = self._next_provider_id
            self._next_provider_id += 1
        self.provider_manager.register(DataProvider(pid, self.page_service_seconds))
        return pid

    # -- ALLOC ---------------------------------------------------------------
    def alloc(self, size_bytes: int, page_size: int) -> int:
        if page_size & (page_size - 1):
            raise ValueError("page_size must be a power of two")
        if size_bytes % page_size:
            raise ValueError("blob size must be a multiple of page_size")
        total_pages = size_bytes // page_size
        return self.version_manager.alloc(total_pages, page_size)

    # -- snapshot pins --------------------------------------------------------
    def pin_version(self, blob_id: int, version: int) -> None:
        if version == ZERO_VERSION:
            return  # the implicit zero version has nothing to collect
        sink = self._pin_sink
        if sink is not None:
            # federated: register the pin at the GC coordinator FIRST — if the
            # node is partitioned from the coordinator this raises, and
            # refusing the pin is the safe failure (a locally-recorded pin the
            # coordinator cannot see would not protect the version from a GC
            # initiated on another node)
            sink(blob_id, version)
        with self._pins_lock:
            blob_pins = self._pins.setdefault(blob_id, {})
            blob_pins[version] = blob_pins.get(version, 0) + 1

    def unpin_version(self, blob_id: int, version: int) -> None:
        with self._pins_lock:
            blob_pins = self._pins.get(blob_id)
            if not blob_pins or version not in blob_pins:
                return
            blob_pins[version] -= 1
            if blob_pins[version] <= 0:
                del blob_pins[version]
            if not blob_pins:
                del self._pins[blob_id]
        sink = self._unpin_sink
        if sink is not None:
            try:  # best-effort: a dead node's pins are reclaimed with its lease
                sink(blob_id, version)
            except ProviderFailed:
                pass

    def pinned_versions(self, blob_id: int) -> Set[int]:
        with self._pins_lock:
            return set(self._pins.get(blob_id, ()))

    def local_pins(self) -> Dict[Tuple[int, int], int]:
        """Snapshot of every live snapshot pin on this node, keyed
        ``(blob_id, version)`` — the rejoin-time resync payload for the
        federated GC coordinator (unpins issued while the node was
        unreachable never made it there)."""
        with self._pins_lock:
            return {
                (blob_id, version): count
                for blob_id, blob_pins in self._pins.items()
                for version, count in blob_pins.items()
            }

    def pin_published(self, blob_id: int, version: Optional[int] = None) -> int:
        """Validate ``version`` against the publish frontier and snapshot-pin
        it, atomically with respect to GC passes (``None`` pins the latest
        published version). Raises ``ValueError`` for versions beyond the
        frontier or abandoned ones — this is the gate that makes registering
        (and therefore cross-session reading) unpublished data impossible.
        Returns the version actually pinned."""
        with self._gc_guard:
            _, _, resolved, _ = self.version_manager.resolve_read_version(
                blob_id, version
            )
            self.pin_version(blob_id, resolved)
        return resolved

    # -- fencing (federated mode) ----------------------------------------------
    def caches_servable(self) -> bool:
        """True when the cache tiers may serve frontier-validated reads.

        Standalone clusters always serve. A federated node consults its lease
        guard: an expired lease means a remote ``Federation.gc`` may already
        have reclaimed versions this node's tiers still hold, so the node is
        *fenced* — reads fall through to the providers (always correct: GC
        never collects a version another node still needs) until the node
        rejoins at the current epoch."""
        guard = self._lease_guard
        return True if guard is None else guard()

    def fence_caches(self) -> None:
        """Drop every cache tier on this node (shared + all session privates).
        Called when the node's lease lapses or it rejoins an advanced GC
        epoch: anything cached may be stale relative to reclaims it never
        acked, so the conservative purge is everything."""
        if self.shared_cache is not None:
            self.shared_cache.clear()
        for sess in self.sessions():
            if sess.cache is not None:
                sess.cache.clear()

    def _check_node_up(self) -> None:
        gate = self._node_gate
        if gate is not None:
            gate()

    # -- GC (paper future work) ----------------------------------------------
    def gc(
        self,
        blob_id: int,
        keep_versions: Sequence[int],
        _local: bool = False,
    ) -> Tuple[int, int]:
        """Drop all tree nodes / pages unreachable from ``keep_versions``
        (plus every snapshot-pinned version — a live :class:`Snapshot` keeps
        its version readable no matter what the GC caller asks for).

        Must be invoked only when no concurrent accesses target the dropped
        versions (the paper's "ordered by the client" semantics). Dropped
        versions are purged from the shared cache tier AND from every
        registered session's private cache, so no client on this node can
        serve a collected version from RAM — the local half of GC↔cache
        coherence (a *distributed* deployment still needs a GC epoch/lease
        protocol before remote nodes' caches can be trusted). Promotion
        passes are paused for the duration, and snapshot creation serializes
        against the pass (``_gc_guard``), so a pin can never land mid-sweep
        and lose its version. Returns (nodes_freed, pages_freed).

        On a federated node this delegates to ``Federation.gc`` — versions
        are reclaimed only under the epoch/lease protocol, after every live
        node acked the purge or its lease expired (``_local=True`` is the
        federation's internal re-entry for the home node's storage sweep)."""
        fed = self._federation
        if fed is not None and not _local:
            return fed.gc(blob_id, keep_versions)
        with self._gc_guard:
            keep = set(keep_versions) | self.pinned_versions(blob_id)
            if fed is not None:
                # the coordinator's sweep window opens INSIDE this node's
                # gc guard: coordinator pins are snapshotted here, and pin
                # requests from other nodes block until the sweep closes —
                # the federated analog of the single-node pin linearization
                # (pinners on THIS node block on the gc guard itself)
                keep |= fed.coordinator.begin_sweep(blob_id)
            try:
                if self.replica_balancer is not None:
                    # repair_service aliases the balancer's _rebalance_lock,
                    # so pausing the balancer excludes repair passes too
                    with self.replica_balancer.paused():
                        return self._gc_locked(blob_id, keep)
                with self.repair_service.paused():
                    return self._gc_locked(blob_id, keep)
            finally:
                if fed is not None:
                    fed.coordinator.end_sweep()

    def _gc_locked(self, blob_id: int, keep_versions: Set[int]) -> Tuple[int, int]:
        vm = self.version_manager
        total_pages, _ = vm.blob_info(blob_id)
        latest = vm.latest_published(blob_id)
        # the newest published version is kept whatever the caller listed:
        # every later write's border links point into its tree, so a caller
        # that chose its keep list before a concurrent publish would
        # otherwise have the pass corrupt every version written after it
        keep = sorted(v for v in keep_versions | {latest} if v != ZERO_VERSION)
        aborted = vm.aborted_view(blob_id)
        reachable_nodes: Set[NodeKey] = set()
        reachable_pages: Set[PageRef] = set()

        def mark(version: int, offset: int, size: int) -> None:
            if version in aborted:
                # dangling link into an abandoned write: resolve it the same
                # way the read path does, so marking neither crashes on the
                # missing node nor roots the hole's wreckage
                version = vm.redirect_read_link(blob_id, version, offset, size)
            if version == ZERO_VERSION:
                return
            key = NodeKey(blob_id, version, offset, size)
            if key in reachable_nodes:
                return
            node = self.metadata.get_node(key)
            reachable_nodes.add(key)
            if node.is_leaf:
                reachable_pages.update(node.all_page_refs())
                return
            half = size // 2
            mark(node.left_version, offset, half)
            mark(node.right_version, offset + half, half)

        for v in keep:
            mark(v, 0, total_pages)

        # Enumerate every stored node of this blob and drop unreachable ones.
        doomed_nodes: List[NodeKey] = []
        doomed_pages: Set[PageRef] = set()
        for key, node in self.metadata.iter_nodes(blob_id):
            if key.version > latest and key.version not in aborted:
                continue  # never GC in-flight (unpublished) versions
            if key not in reachable_nodes:
                doomed_nodes.append(key)
                if node.is_leaf:
                    doomed_pages.update(ref for ref in node.all_page_refs())
        doomed_pages -= reachable_pages
        self.metadata.delete_nodes(doomed_nodes)
        if self.replica_balancer is not None:
            # demote-on-GC: the promoted copies die with the doomed leaves
            # (they are in the rewritten nodes' all_page_refs above); drop the
            # balancer's heat/promotion records so they can't be re-targeted
            self.replica_balancer.forget(doomed_nodes)
        by_provider: Dict[int, List[int]] = {}
        for pid, key in doomed_pages:
            by_provider.setdefault(pid, []).append(key)
        for pid, keys in by_provider.items():
            self.provider_manager.get_provider(pid).delete_pages(keys)
        self.provider_manager.release(sorted(doomed_pages))
        # cache coherence: purge the dropped versions from the shared tier
        # and from EVERY session's private cache. In-flight (unpublished)
        # versions stay cached — their pages were not collected above, and a
        # concurrent writer's write-through entries must survive another
        # session's GC call.
        keep_cached = set(keep) | {ZERO_VERSION}
        caches = [self.shared_cache] + [s.cache for s in self.sessions()]
        for cache in caches:
            if cache is not None:
                cache.drop_versions(blob_id, keep_cached, max_version=latest)
        return len(doomed_nodes), len(doomed_pages)

    # -- introspection --------------------------------------------------------
    def storage_bytes(self) -> int:
        return sum(p.used_bytes() for p in self.provider_manager.providers())

    def close(self) -> None:
        """Tear the shared plane down. Idempotent: concurrent/repeated calls
        after the first are no-ops. Warmer threads are joined with a bounded
        timeout so a wedged warmer cannot hang the close (and a watchdog-
        enabled test run cannot leak instrumented threads between tests)."""
        with self._aux_lock:
            if self._closed:
                return
            self._closed = True
        with self._warmers_lock:
            warmers, self._warmers = self._warmers, []
        for warmer in warmers:
            # warmers own sessions + fill tasks: stop them first
            warmer.stop(timeout=5.0)
        with self._aux_lock:
            aux, self._aux_pool = self._aux_pool, None
            self._aux_closed = True
        if aux is not None:
            aux.shutdown(wait=True)
        for sess in self.sessions():
            sess.close()
        if self._owns_substrate:
            self.metadata.close()  # federated nodes: the Federation owns it
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Session:
    """One client of the cluster: private cache tier, private traffic stats,
    private async-write window. Create via :meth:`Cluster.session`; get data
    ops via :meth:`Session.open` / :meth:`Session.create`.

    The fine-grain data plane (the paper's §III.B client protocol — the
    overlapped write pipeline and the batched, cache-fronted read path) lives
    here as ``_readv``/``_writev``; :class:`BlobHandle` is its public face.
    """

    def __init__(
        self,
        cluster: Cluster,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        replica_spread: bool = True,
        sync_write: bool = False,
        sync_read: bool = False,
        max_inflight_writes: int = 8,
        prefetch: Optional[PrefetchConfig] = None,
        _index: int = 0,
    ) -> None:
        self.cluster = cluster
        #: this session's traffic only; the cluster's ``stats`` aggregates all
        self.stats = TrafficStats()
        #: private tier: write-through under the session's own assigned
        #: versions (a writer's re-reads are RAM hits before anyone else can
        #: even see the version); ALSO serves as the read-fill cache when the
        #: cluster runs without a shared tier
        self.cache: Optional[PageCache] = (
            PageCache(cache_bytes) if cache_bytes else None
        )
        #: pick the least-read-loaded replica per page instead of always the
        #: primary (the knob the skew-read benchmark flips)
        self.replica_spread = replica_spread
        #: run writes with the pre-pipeline full barriers + per-page copies
        #: (the A/B baseline for the ``sync-write`` benchmark mode)
        self.sync_write = sync_write
        #: run reads with the pre-pipeline phased plane — the full metadata
        #: traversal completes before the first ``get_pages`` RPC leaves the
        #: node (the A/B baseline for the ``sync-read`` benchmark mode)
        self.sync_read = sync_read
        #: optional stride readahead into the shared tier (off by default)
        self.prefetcher: Optional[StridePrefetcher] = (
            StridePrefetcher(self, prefetch) if prefetch is not None else None
        )
        #: bounded in-flight window for :meth:`BlobHandle.write_async`
        self.max_inflight_writes = max_inflight_writes
        self._write_window = threading.BoundedSemaphore(max_inflight_writes)
        self._writer_pool: Optional[ThreadPoolExecutor] = None
        self._writer_pool_lock = make_lock("Session._writer_pool_lock")
        self._async_lock = make_lock("Session._async_lock")
        self._async_writes: List[Future] = []
        #: assigned-but-unreported versions per blob (guarded by
        #: ``_async_lock``): a node death mid-write leaves these wedging
        #: in-order publication, and the repair service's writer-recovery
        #: path (``RepairService.recover_writers``) abandons them
        self._inflight_versions: Dict[int, Set[int]] = {}
        self._pool = cluster._pool
        # per-session stream, DISTINCT per session: N sessions seeded alike
        # would sample identical replica pairs in lockstep and re-herd the
        # very hot pages replica spreading exists to fan out
        self._rng = random.Random(0xB10B + 0x9E3779B1 * _index)
        self._closed = False

    # -- handles ---------------------------------------------------------------
    def open(self, blob_id: int) -> "BlobHandle":
        return BlobHandle(self, blob_id)

    def create(self, size_bytes: int, page_size: int) -> "BlobHandle":
        """ALLOC a fresh blob on the cluster and open it in this session."""
        return self.open(self.cluster.alloc(size_bytes, page_size))

    # -- stats plumbing --------------------------------------------------------
    def _record_data(
        self, dest: int, n_messages: int, n_bytes: int, read: bool = False
    ) -> None:
        self.stats.record_data(dest, n_messages, n_bytes, read=read)
        self.cluster.stats.record_data(dest, n_messages, n_bytes, read=read)

    def _record_cache(self, hits: int, misses: int) -> None:
        self.stats.record_cache(hits=hits, misses=misses)
        self.cluster.stats.record_cache(hits=hits, misses=misses)

    def _record_retry(self, n: int = 1) -> None:
        self.stats.record_retry(n)
        self.cluster.stats.record_retry(n)

    def _record_fallback(self, n: int = 1) -> None:
        self.stats.record_fallback(n)
        self.cluster.stats.record_fallback(n)

    def _record_degraded(self, n: int = 1) -> None:
        self.stats.record_degraded_read(n)
        self.cluster.stats.record_degraded_read(n)

    def _record_checksum_failure(self, n: int = 1) -> None:
        self.stats.record_checksum_failure(n)
        self.cluster.stats.record_checksum_failure(n)

    @property
    def cache_hit_rate(self) -> float:
        h, m = self.stats.cache_hits, self.stats.cache_misses
        return h / (h + m) if h + m else 0.0

    # -- WRITE plane -----------------------------------------------------------
    def _writev(
        self,
        blob_id: int,
        patches: Sequence[Tuple[int, np.ndarray]],
        coalesce_meta: bool = False,
    ) -> List[int]:
        """Vectored WRITE (see :meth:`BlobHandle.writev` for semantics and
        the zero-copy buffer-surrender contract). ``coalesce_meta`` routes
        the node store through the DHT's group-commit path so concurrent
        small writes (the ``write_async`` window) share one shard round."""
        self.cluster._check_node_up()
        vm = self.cluster.version_manager
        total_pages, page_size = vm.blob_info(blob_id)
        sync = self.sync_write
        # pass 1: validate and normalize every patch — no side effects yet,
        # so a bad later patch cannot leave earlier buffers frozen
        bufs: List[np.ndarray] = []
        spans: List[Tuple[int, int]] = []  # (page_offset, n_pages) per patch
        for offset_bytes, buffer in patches:
            src = np.ascontiguousarray(buffer).view(np.uint8).reshape(-1)
            if offset_bytes % page_size or src.size % page_size:
                raise ValueError("WRITE must be page-aligned (paper §II)")
            n_pages = src.size // page_size
            if n_pages == 0:
                raise ValueError("empty write")
            bufs.append(src)
            spans.append((offset_bytes // page_size, n_pages))
        if not bufs:
            return []
        # pass 2 (pipelined only; the sync baseline copies every page anyway):
        # make each source immutable before any view of it is handed out.
        # Zero-copy is only safe when freezing the array that OWNS the memory
        # actually cuts off future writes — i.e. the caller passed the owning
        # array itself (or our normalization already copied). A view of some
        # larger writable array cannot be protected by freezing (writes
        # through the base would still mutate the stored pages), so that case
        # falls back to ONE bulk copy per patch — never a per-page copy.
        if not sync:
            for i, (src, (_, buffer)) in enumerate(zip(bufs, patches)):
                root = src
                while isinstance(root.base, np.ndarray):
                    root = root.base
                if root.flags.writeable:
                    caller_root = buffer
                    while isinstance(caller_root, np.ndarray) and isinstance(
                        caller_root.base, np.ndarray
                    ):
                        caller_root = caller_root.base
                    owns = root is not caller_root or (
                        isinstance(buffer, np.ndarray) and buffer.base is None
                    )
                    if owns:
                        root.flags.writeable = False
                    else:
                        src = bufs[i] = src.copy()
                        src.flags.writeable = False
                ro = src.view()
                ro.flags.writeable = False
                bufs[i] = ro

        provider_manager = self.cluster.provider_manager
        metadata = self.cluster.metadata

        # (1) placements for every fresh page of every patch, in one call
        placements = provider_manager.allocate(sum(n for _, n in spans))

        by_provider: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        per_patch: List[List[Tuple[PageRef, Tuple[PageRef, ...]]]] = []
        #: per patch, the page arrays actually handed to the store (views in
        #: the pipelined path, copies in the sync baseline) — the write-through
        #: cache must reference these, never a possibly-writable source
        stored_pages: List[List[np.ndarray]] = []
        versions: List[int] = []
        node_keys: List[NodeKey] = []
        data_futures: List[Future] = []
        meta_futures: List[Future] = []
        try:
            cursor = 0
            #: per patch, per page: the integrity checksum stamped onto the
            #: leaf — computed HERE, at freeze time, so it attests to exactly
            #: the immutable bytes handed to the store
            checksums: List[List[int]] = []
            for src, (_, n_pages) in zip(bufs, spans):
                mine = placements[cursor : cursor + n_pages]
                cursor += n_pages
                per_patch.append(mine)
                pages: List[np.ndarray] = []
                sums: List[int] = []
                for i, (primary, replicas) in enumerate(mine):
                    page = src[i * page_size : (i + 1) * page_size]
                    if sync:
                        page = page.copy()  # pre-pipeline baseline: defensive copy
                    pages.append(page)
                    sums.append(page_checksum(page))
                    for pid, key in (primary,) + replicas:
                        by_provider.setdefault(pid, []).append((key, page))
                stored_pages.append(pages)
                checksums.append(sums)

            # (2) LAUNCH the aggregated per-provider puts; the pipeline only
            #     joins them at the end (sync baseline: full barrier here)
            data_pids = list(by_provider)
            data_futures = [
                self._pool.submit(self._put_batch, pid, items)
                for pid, items in by_provider.items()
            ]
            if sync:
                for f in data_futures:
                    f.result()

            # (3) version numbers + border links for ALL patches under ONE
            #     manager lock acquisition (the only serialized step) — this
            #     does not depend on data-put completion, so it runs while
            #     the pages are still in flight
            assigned = vm.assign_versions(blob_id, spans)
            versions = [v for v, _ in assigned]
            with self._async_lock:
                self._inflight_versions.setdefault(blob_id, set()).update(
                    versions
                )

            # (4) weave every patch's tree while the data puts are still in
            #     flight, then LAUNCH one aggregated node put per shard
            #     (paper §V.A aggregation across the whole writev); the sync
            #     baseline runs the same aggregated put behind a barrier
            all_nodes: List[TreeNode] = []
            for (page_offset, n_pages), mine, sums, (version, links) in zip(
                spans, per_patch, checksums, assigned
            ):
                all_nodes.extend(
                    build_write_tree(
                        blob_id, version, total_pages, page_offset, n_pages,
                        mine, links, leaf_checksums=sums,
                    )
                )
            node_keys.extend(node.key for node in all_nodes)
            if sync:
                metadata.put_nodes(all_nodes)
            elif coalesce_meta:
                # cross-writev coalescing: writes streaming through the async
                # window merge their node batches into one shard round
                meta_futures.extend(metadata.put_nodes_coalesced(all_nodes))
            else:
                meta_futures.extend(metadata.put_nodes_async(all_nodes))

            # join: every page and node must be durable before success. The
            # metadata futures join FIRST so that when a data batch has to be
            # re-placed onto a healthy provider, no stale in-flight leaf put
            # can overwrite the corrected refs we write below.
            for f in meta_futures:
                err = f.exception()
                if err is not None:
                    raise err
            failed_batches: List[Tuple[int, BaseException]] = []
            for pid, f in zip(data_pids, data_futures):
                err = f.exception()
                if err is None:
                    continue
                if sync or not isinstance(err, (ProviderFailed, KeyError)):
                    raise err  # sync baseline keeps abort-on-failure
                failed_batches.append((pid, err))
            if failed_batches:
                # self-healing: move the dead provider's pages to healthy
                # nodes mid-flight instead of aborting the whole writev;
                # raises (→ abort path) only when no healthy target remains
                self._replace_failed_batches(
                    blob_id, failed_batches, by_provider, placements, all_nodes
                )

            # (5) report success (one lock for the batch) → in-order publish
            vm.report_successes(blob_id, versions)
            self._untrack_inflight(blob_id, versions)
        except VersionAbandoned:
            # writer recovery (a federated node-death verdict) withdrew
            # these versions mid-flight and owns their wreckage — abandon
            # again would be a no-op, and cleaning up here would double-
            # release what the recovery scrub already released. Just
            # quiesce the in-flight puts and surface the failure.
            for f in data_futures + meta_futures:
                f.exception()
            self._untrack_inflight(blob_id, versions)
            raise
        except BaseException:
            # NOTE: frozen sources stay frozen — a concurrent write may
            # already hold zero-copy views of the same root, so restoring
            # writability here would let the caller mutate ITS published
            # pages through the shared memory
            self._abort_writev(
                blob_id, versions, placements, by_provider, node_keys,
                data_futures, meta_futures,
            )
            self._untrack_inflight(blob_id, versions)
            raise

        # write-through into the PRIVATE tier only: the just-stored pages are
        # already immutable, so this session's re-reads of these versions come
        # straight from RAM — but the versions may not have published yet, and
        # the shared tier must never hold a page another session could not
        # also fetch from the providers after frontier validation
        if self.cache is not None:
            items: List[Tuple[Tuple[int, int, int], np.ndarray]] = []
            for pages, (page_offset, _), version in zip(
                stored_pages, spans, versions
            ):
                for i, page in enumerate(pages):
                    items.append(((blob_id, version, page_offset + i), page))
            self.cache.put_many(items)
        return versions

    def _put_batch(self, pid: int, items: List[Tuple[int, np.ndarray]]) -> None:
        """One aggregated data put, retried per :class:`RetryPolicy`.

        Every failed attempt feeds the health machine; retries stop early
        once the target is declared dead (the writev join will re-place the
        batch on a healthy provider instead). ``KeyError`` (the provider was
        deregistered mid-flight) is not retried — the id will never come
        back. Backoff runs on a pool worker, never under a lock."""
        pm = self.cluster.provider_manager
        policy = self.cluster.retry_policy
        attempts = max(policy.max_attempts, 1)
        for attempt in range(attempts):
            try:
                pm.get_provider(pid).put_pages(items)
            except ProviderFailed:
                pm.note_failure(pid)
                if attempt + 1 < attempts and pid not in pm.dead_providers():
                    self._record_retry()
                    policy.backoff(attempt)
                    continue
                raise
            pm.note_success(pid)
            self._record_data(pid, len(items), sum(p.nbytes for _, p in items))
            return

    def _replace_failed_batches(
        self,
        blob_id: int,
        failed_batches: List[Tuple[int, BaseException]],
        by_provider: Dict[int, List[Tuple[int, np.ndarray]]],
        placements: List[Tuple[PageRef, Tuple[PageRef, ...]]],
        all_nodes: List[TreeNode],
    ) -> None:
        """Mid-flight write repair: a data batch whose provider died (or was
        deregistered) after placement gets re-put onto healthy providers, and
        the writev completes instead of aborting.

        Works per failed batch, transactionally: either every item of the
        batch lands on a healthy target (then the bookkeeping — load credit,
        ``by_provider``, ``placements``, the woven leaves — is swung over to
        the new refs), or the partial moves are undone and the original
        error is re-raised so the normal abort path runs on *consistent*
        state. Leaf corrections are plain re-puts of still-unpublished keys;
        the metadata futures joined before this runs, so no stale in-flight
        put can overwrite a corrected leaf."""
        pm = self.cluster.provider_manager
        metadata = self.cluster.metadata
        failed_pids = {pid for pid, _ in failed_batches}
        moved: Dict[PageRef, PageRef] = {}
        for pid, original_err in failed_batches:
            items = by_provider[pid]
            # replica sets must stay on distinct providers: for each page key,
            # know who else already holds a copy
            holders: Dict[int, Set[int]] = defaultdict(set)
            for other_pid, other_items in by_provider.items():
                if other_pid != pid:
                    for key, _ in other_items:
                        holders[key].add(other_pid)
            placed: List[Tuple[int, int, np.ndarray]] = []  # (target, key, page)
            try:
                for key, page in items:
                    tried: Set[int] = set()
                    while True:
                        target = pm.least_loaded(
                            exclude=tuple(holders[key] | failed_pids | tried)
                        )
                        if target is None:
                            raise original_err  # no healthy target → abort
                        try:
                            pm.get_provider(target).put_pages([(key, page)])
                        except (ProviderFailed, KeyError):
                            pm.note_failure(target)
                            tried.add(target)
                            continue
                        pm.note_success(target)
                        pm.add_load(target, 1)
                        placed.append((target, key, page))
                        moved[(pid, key)] = (target, key)
                        self._record_data(target, 1, page.nbytes)
                        break
            except BaseException:
                # undo THIS batch's partial moves; earlier batches already
                # committed their bookkeeping, so abort cleanup stays exact
                for target, key, _ in placed:
                    try:
                        pm.get_provider(target).delete_pages([key])
                    except (ProviderFailed, KeyError):
                        pass
                    moved.pop((pid, key), None)
                pm.release([(target, key) for target, key, _ in placed])
                raise
            # commit: the dead provider's load credit moves to the new holders
            pm.release([(pid, key) for key, _ in items])
            del by_provider[pid]
            for target, key, page in placed:
                by_provider.setdefault(target, []).append((key, page))
            self._record_retry(len(items))
        # rewrite affected leaves with the corrected refs
        corrected = [
            dataclasses.replace(
                node,
                page=moved.get(node.page, node.page),
                replicas=tuple(moved.get(r, r) for r in node.replicas),
            )
            for node in all_nodes
            if node.is_leaf
            and (node.page in moved or any(r in moved for r in node.replicas))
        ]
        if corrected:
            metadata.put_nodes(corrected)
        # swing placements to the new refs so a LATER failure's abort path
        # deletes/releases what is actually stored now
        for i, (primary, replicas) in enumerate(placements):
            if primary in moved or any(r in moved for r in replicas):
                placements[i] = (
                    moved.get(primary, primary),
                    tuple(moved.get(r, r) for r in replicas),
                )

    def _abort_writev(
        self,
        blob_id: int,
        versions: List[int],
        placements: List[Tuple[PageRef, Tuple[PageRef, ...]]],
        by_provider: Dict[int, List[Tuple[int, np.ndarray]]],
        node_keys: List[NodeKey],
        data_futures: List[Future],
        meta_futures: List[Future],
    ) -> None:
        """Failure cleanup for a mid-flight ``writev``: without this, the
        placement load heap keeps phantom load, stored pages and nodes of the
        doomed versions leak forever, and in-order publication wedges behind
        versions that will never report success.

        The doomed versions are withdrawn first; what happens to their
        stored wreckage depends on how :meth:`VersionManager.abandon`
        resolved them. Fully *erased* versions (no concurrent writer assigned
        after them) are scrubbed: pages deleted, nodes deleted, placement
        credits released. Versions that became publication *holes* are left
        in place instead — a later writer may already have woven border links
        into their trees, so deleting whatever did land would turn that
        writer's published version unreadable; the wreckage stays until
        :meth:`Cluster.gc` collects it (which also returns the load
        credit), the same stance taken for orphans on a down provider."""
        provider_manager = self.cluster.provider_manager
        for f in data_futures + meta_futures:
            f.exception()  # quiesce: no put may still be in flight
        if versions:
            holes = self.cluster.version_manager.abandon(blob_id, versions)
            if holes:
                return  # leak to GC: later versions may reference the nodes
        for pid, items in by_provider.items():
            try:  # best-effort: a down provider keeps its orphans until GC
                provider_manager.get_provider(pid).delete_pages(
                    [key for key, _ in items]
                )
            except (ProviderFailed, KeyError):
                pass
        try:
            self.cluster.metadata.delete_nodes(node_keys)
        except ProviderFailed:
            pass
        provider_manager.release(
            [ref for primary, replicas in placements for ref in (primary,) + replicas]
        )

    def _untrack_inflight(self, blob_id: int, versions: Sequence[int]) -> None:
        with self._async_lock:
            mine = self._inflight_versions.get(blob_id)
            if mine is None:
                return
            mine.difference_update(versions)
            if not mine:
                del self._inflight_versions[blob_id]

    def inflight_versions(self) -> Dict[int, Set[int]]:
        """Snapshot of this session's assigned-but-unreported versions —
        what writer recovery must abandon when the session's node dies
        mid-write (in-order publication would otherwise wedge forever)."""
        with self._async_lock:
            return {b: set(vs) for b, vs in self._inflight_versions.items()}

    # -- asynchronous write streaming ------------------------------------------
    def _write_async(
        self, blob_id: int, buffer: np.ndarray, offset_bytes: int
    ) -> "Future[int]":
        if self._closed:
            # a closed session's writer pool is already shut down and the
            # cluster no longer tracks the session (GC would skip its cache);
            # silently resurrecting the pool here would leak its threads
            raise RuntimeError("write_async on a closed session")
        self._write_window.acquire()
        try:
            future = self._writers().submit(
                self._windowed_write, blob_id, buffer, offset_bytes
            )
        except BaseException:
            self._write_window.release()
            raise
        with self._async_lock:
            # prune successfully-completed futures so a long-running streamer
            # that joins its own returned futures (never calls flush) does
            # not accumulate them forever; FAILED futures are kept until
            # flush()/close() so their errors cannot vanish unobserved
            self._async_writes = [
                f for f in self._async_writes
                # done() guards the exception() call: it cannot block here
                if not f.done() or f.exception() is not None  # lint: allow(blocking-under-lock)
            ]
            self._async_writes.append(future)
        return future

    def _writers(self) -> ThreadPoolExecutor:
        with self._writer_pool_lock:
            if self._writer_pool is None:
                self._writer_pool = ThreadPoolExecutor(
                    max_workers=self.max_inflight_writes
                )
            return self._writer_pool

    def _windowed_write(
        self, blob_id: int, buffer: np.ndarray, offset_bytes: int
    ) -> int:
        try:
            # async-window writes coalesce their metadata: several small
            # writes in flight at once share ONE aggregated shard round
            return self._writev(
                blob_id, [(offset_bytes, buffer)],
                coalesce_meta=not self.sync_write,
            )[0]
        finally:
            self._write_window.release()

    def flush(self) -> List[int]:
        """Join every outstanding ``write_async`` of this session —
        SESSION-GLOBAL: it drains the whole window, including writes queued
        by other threads sharing this session (a multi-writer client should
        instead join the futures ``write_async`` returned to it). Returns the
        versions of the writes still tracked by the window (writes that
        completed and were already pruned are not re-reported) and re-raises
        the first failure."""
        with self._async_lock:
            futures, self._async_writes = self._async_writes, []
        versions: List[int] = []
        first_err: Optional[BaseException] = None
        for f in futures:
            try:
                versions.append(f.result())
            except BaseException as err:  # keep joining; surface the first
                if first_err is None:
                    first_err = err
        if first_err is not None:
            raise first_err
        return versions

    # -- READ plane --------------------------------------------------------------
    def read_pages(
        self,
        blob_id: int,
        version: int,
        pages: Sequence[int],
        pinned: bool = False,
    ) -> List[np.ndarray]:
        """Gather whole pages of one published ``version`` in a single
        vectored read — the serving plane's page-table → readv-plan surface.
        Full-page segments come back as zero-copy views of cached pages.

        ``pinned=True`` is the caller's attestation that ``version`` is held
        by a snapshot pin it owns (taken via :meth:`Cluster.pin_published`,
        which already validated the publish frontier); the per-call frontier
        check is then skipped, exactly like :class:`Snapshot` re-reads.
        Without it the version is validated here, so an unpublished version
        can never be read either way."""
        vm = self.cluster.version_manager
        if pinned:
            total_pages, page_size = vm.blob_info(blob_id)
        else:
            total_pages, page_size, version, _ = vm.resolve_read_version(
                blob_id, version
            )
        segments = [(p * page_size, page_size) for p in pages]
        return self._readv(blob_id, version, segments, total_pages, page_size)

    def _readv(
        self,
        blob_id: int,
        version: int,
        segments: Sequence[Tuple[int, int]],
        total_pages: int,
        page_size: int,
    ) -> List[np.ndarray]:
        """``readv`` body with the version-manager state already resolved —
        the serialized actor is consulted exactly once per public call (and
        not at all for :class:`Snapshot` re-reads).

        The miss path is a *streaming pipeline*, symmetric with the write
        plane: as the level-synchronous metadata traversal resolves leaves
        (per shard, as each shard's RPC of a level completes), the
        per-provider ``get_pages`` futures launch immediately on the cluster
        pool — data transfer overlaps the remaining metadata rounds, with
        ONE join before assembly. ``sync_read=True`` keeps the phased
        baseline: the full traversal completes before the first page fetch."""
        self.cluster._check_node_up()
        # clamp segments; collect the deduplicated union of needed pages
        total_bytes = total_pages * page_size
        clamped: List[Tuple[int, int]] = []
        needed: Set[int] = set()
        for offset, size in segments:
            if offset < 0 or size < 0:
                raise ValueError(f"negative read offset/size ({offset}, {size})")
            if size == 0:
                clamped.append((offset, 0))
                continue
            if offset >= total_bytes:
                raise ValueError(
                    f"read at offset {offset} out of range (blob is {total_bytes} bytes)"
                )
            size = min(size, total_bytes - offset)  # clamp to blob end
            clamped.append((offset, size))
            first_page = offset // page_size
            last_page = min(-(-(offset + size) // page_size), total_pages)
            needed.update(range(first_page, last_page))

        # adaptive readahead: feed the stride detector BEFORE this read's own
        # fetch, so the readahead it may issue (for pages beyond this read)
        # overlaps the demand traversal below. The observed version is the
        # resolved published version, so prefetch can never cross the
        # publish frontier.
        if self.prefetcher is not None and needed:
            self.prefetcher.observe(
                blob_id, version, min(needed), max(needed) + 1,
                total_pages, page_size,
            )

        # cache phase. Tier order: the private cache first (it may hold this
        # session's own write-through pages), then the shared tier, which
        # also provides cross-session single-flight — exactly one reader on
        # the whole node becomes the fetch leader for each missing page. The
        # version was already validated against the publish frontier, so
        # everything that enters the shared tier here is published data.
        pages: Dict[int, Optional[np.ndarray]] = {}
        if self.cluster.caches_servable():
            private = self.cache
            shared = self.cluster.shared_cache
        else:
            # FENCED (federated lease lapsed): no cache tier may serve or be
            # filled — the whole read goes through to the providers, which is
            # always correct because federated GC never reclaims a version a
            # live node still needs
            private = None
            shared = None
        flight_cache = shared if shared is not None else private
        owned: List[int] = []
        waits: Dict[Tuple[int, int, int], object] = {}
        if needed:
            keys = [(blob_id, version, p) for p in sorted(needed)]
            hits = 0
            if shared is not None and private is not None:
                got = private.get_many(keys)
                pages.update({key[2]: pg for key, pg in got.items()})
                hits += len(got)
                keys = [k for k in keys if k not in got]
            if flight_cache is not None:
                plan = flight_cache.plan(keys, record=False)
                pages.update({key[2]: page for key, page in plan.hits.items()})
                hits += len(plan.hits)
                owned = sorted(key[2] for key in plan.owned)
                waits = plan.waits
                self._record_cache(hits, len(owned) + len(waits))
            else:
                owned = sorted(key[2] for key in keys)

        if owned:
            fulfilled: Set[int] = set()
            stream = _PageFetchStream(self, page_size)
            redirect = self._read_redirect(blob_id)
            try:
                if self.sync_read:
                    # phased baseline: the traversal runs to completion, THEN
                    # the leaves are fetched (one aggregated RPC per provider)
                    leaves = traverse_batch(
                        self.cluster.metadata.get_nodes, blob_id, version,
                        total_pages, _merge_ranges(owned), redirect=redirect,
                    )
                    stream.submit(leaves)
                else:
                    # (2)+(3) overlapped: per-shard partial results stream
                    # get_pages futures into flight mid-level; the per-level
                    # on_leaves emission is the catch-all for get_nodes
                    # implementations that do not stream (stream.submit
                    # dedups, so doubly delivered leaves fetch once)
                    def _streaming_get_nodes(keys):
                        return self.cluster.metadata.get_nodes(
                            keys, on_partial=stream.submit_partial
                        )

                    leaves = traverse_batch(
                        _streaming_get_nodes, blob_id, version, total_pages,
                        _merge_ranges(owned), on_leaves=stream.submit,
                        redirect=redirect,
                    )
                    # implicit-zero pages resolve in the traversal, not the
                    # data plane — record them with the stream's results
                    stream.submit(
                        {p: None for p, leaf in leaves.items() if leaf is None}
                    )
                # the ONE join of the read pipeline: every launched fetch
                # lands (with per-page replica fallback) before assembly
                fetched = stream.join()
                for p, page in fetched.items():
                    pages[p] = page
                    if flight_cache is not None:
                        # zero pages share one buffer — charge them the LRU
                        # slot, not a full page, so repeat sparse reads skip
                        # the metadata walk without evicting real pages
                        flight_cache.fulfill(
                            (blob_id, version, p),
                            page if page is not None else _zero_page(page_size),
                            charge=None if page is not None else ZERO_PAGE_CHARGE,
                        )
                        fulfilled.add(p)
            except BaseException as err:
                stream.quiesce()  # no fetch may still be in flight
                if flight_cache is not None:
                    for p in owned:
                        if p not in fulfilled:
                            flight_cache.abort((blob_id, version, p), err)
                raise

        # follower phase: collect pages fetched by concurrent leaders
        for key, flight in waits.items():
            pages[key[2]] = flight_cache.wait(key, flight)  # type: ignore[union-attr, arg-type]

        # assemble per-segment outputs from the shared page map: a segment
        # covering exactly one whole page is served as a zero-copy read-only
        # view of that page; an aligned multi-page segment is one C-level
        # concatenate of the page views (no per-page Python copy loop); the
        # unaligned rest goes into an UNinitialized buffer with explicit
        # zero-fill only where a page is implicitly zero — never a full
        # zero-fill that every byte then overwrites
        outs: List[np.ndarray] = []
        for offset, size in clamped:
            if size == 0:
                outs.append(np.empty(0, dtype=np.uint8))
                continue
            if size == page_size and offset % page_size == 0:
                page = pages.get(offset // page_size)
                outs.append(page if page is not None else _zero_page(page_size))
                continue
            first = offset // page_size
            last = -(-(offset + size) // page_size)
            if offset % page_size == 0 and size % page_size == 0:
                zero = _zero_page(page_size)
                parts = [pages.get(p) for p in range(first, last)]
                outs.append(np.concatenate(
                    [pg if pg is not None else zero for pg in parts]
                ))
                continue
            out = np.empty(size, dtype=np.uint8)
            for p in range(first, last):
                page = pages.get(p)
                page_lo = p * page_size
                a = max(offset, page_lo)
                b = min(offset + size, page_lo + page_size)
                if page is None:
                    out[a - offset : b - offset] = 0  # implicit zero page
                else:
                    out[a - offset : b - offset] = page[a - page_lo : b - page_lo]
            outs.append(out)
        return outs

    def _read_redirect(self, blob_id: int) -> Optional[Callable[[int, int, int], int]]:
        """Dangling-link resolver for tree traversals of ``blob_id``.

        A writer that aborted mid-flight may have become a publication
        *hole*: a later published version can carry border links into trees
        the hole never stored (the write-plane leak the metadata scrub
        eventually rewrites). The returned hook redirects any link into an
        aborted version to the newest surviving version covering the same
        segment — such a node always exists, because every stored node of a
        version covers a canonical segment intersecting that version's
        written interval. Returns ``None`` (zero overhead) when the blob has
        no abandoned versions."""
        vm = self.cluster.version_manager
        aborted = vm.aborted_view(blob_id)
        if not aborted:
            return None

        def redirect(version: int, offset: int, size: int) -> int:
            if version not in aborted:
                return version
            return vm.redirect_read_link(blob_id, version, offset, size)

        return redirect

    def _choose_ref(
        self, leaf: TreeNode, read_load: Dict[int, int], page_size: int
    ) -> PageRef:
        """Pick which replica serves this page via power-of-two random
        choices: sample two replicas, take the one with less read traffic so
        far, charging ``read_load`` tentatively so one batch also spreads.
        The random sampling is what prevents the herd effect — a
        deterministic global minimum sends every concurrent client to the
        same momentarily-idle provider, re-serializing the hot page there."""
        refs = leaf.all_page_refs()
        a, b = self._rng.sample(range(len(refs)), 2)
        pid, key = min(
            refs[a], refs[b], key=lambda r: read_load.get(r[0], 0)
        )
        read_load[pid] = read_load.get(pid, 0) + page_size
        return pid, key

    def _fetch_pages(
        self, leaves: Dict[int, Optional[TreeNode]], page_size: int
    ) -> Dict[int, Optional[np.ndarray]]:
        """Fetch all leaf pages in one shot: one aggregated RPC per serving
        provider (in parallel), per-page replica fallback if a provider batch
        fails. This is the phased entry point (``sync_read`` baseline,
        background prefetch fills); the streaming read plane drives the same
        :class:`_PageFetchStream` incrementally instead."""
        stream = _PageFetchStream(self, page_size)
        stream.submit(leaves)
        return stream.join()

    def _get_batch(
        self, pid: int, items: List[Tuple[int, int, TreeNode]]
    ) -> Optional[Dict[int, np.ndarray]]:
        """One aggregated ``get_pages`` RPC to provider ``pid``; ``None`` on
        provider failure (the stream's join falls back per page). Failures
        feed the health machine — enough of them within the decay window
        marks the source suspect, then dead (triggering background repair)."""
        pm = self.cluster.provider_manager
        try:
            provider = pm.get_provider(pid)
            fetched = provider.get_pages([key for _, key, _ in items])
        except ProviderFailed:
            pm.note_failure(pid)
            return None  # provider down: caller falls back per page
        except KeyError:
            return None  # deregistered: nothing to mark
        self._record_data(
            pid, len(items), sum(pg.nbytes for pg in fetched), read=True
        )
        # end-to-end integrity: verify every page against the checksum its
        # leaf carries; a mismatch is a provider failure, not a crash — the
        # bad page is simply absent from the result, and the stream's join
        # falls back to a replica and repairs the corrupt copy
        good: Dict[int, np.ndarray] = {}
        corrupt = 0
        for (p, _, leaf), pg in zip(items, fetched):
            if leaf.checksum is not None and page_checksum(pg) != leaf.checksum:
                corrupt += 1
                continue
            good[p] = pg
        if corrupt:
            self._record_checksum_failure(corrupt)
            pm.note_failure(pid)
        else:
            pm.note_success(pid)
        return good

    def _prefetch_fill(
        self,
        blob_id: int,
        version: int,
        prefetch_pages: Sequence[int],
        total_pages: int,
        page_size: int,
    ) -> int:
        """Best-effort background fill of ``prefetch_pages`` of a *published*
        ``version`` into the session's fill tier (the cluster's shared tier
        when present — so one session's readahead warms every session on the
        node). Used by the stride prefetcher and the watch warmer; runs off
        the read path (aux pool / warmer thread).

        Coherence is the same argument as any read: the version was resolved
        against the publish frontier by whoever triggered the fill, fills go
        through the cache's single-flight plan (``record=False`` — a
        prefetch miss must not distort any session's demand hit rate), and
        every owned key is fulfilled or aborted even on failure, so demand
        readers waiting as followers never hang. Returns pages filled."""
        if not self.cluster.caches_servable():
            return 0  # fenced node: background fills must not repopulate
        cache = (
            self.cluster.shared_cache
            if self.cluster.shared_cache is not None
            else self.cache
        )
        if cache is None:
            return 0
        plan = cache.plan(
            [(blob_id, version, p) for p in prefetch_pages], record=False
        )
        owned = sorted(key[2] for key in plan.owned)
        if not owned:
            return 0
        done: Set[int] = set()
        try:
            leaves = traverse_batch(
                self.cluster.metadata.get_nodes, blob_id, version, total_pages,
                _merge_ranges(owned), redirect=self._read_redirect(blob_id),
            )
            fetched = self._fetch_pages(leaves, page_size)
            for p in owned:
                page = fetched.get(p)
                cache.fulfill(
                    (blob_id, version, p),
                    page if page is not None else _zero_page(page_size),
                    charge=None if page is not None else ZERO_PAGE_CHARGE,
                )
                done.add(p)
        except BaseException as err:
            for p in owned:
                if p not in done:
                    cache.abort((blob_id, version, p), err)
        return len(done)

    def _fetch_single(
        self,
        page_index: int,
        leaf: TreeNode,
        skip_pid: Optional[int] = None,
        repair_refs: Sequence[PageRef] = (),
    ) -> np.ndarray:
        """Per-page replica fallback with bounded retry rounds: every replica
        is tried once per round (each failure feeding the health machine);
        between rounds the retry policy backs off — a transient blip on ALL
        replicas still completes, a truly lost page fails after
        ``max_attempts`` rounds.

        Integrity: a fetched page whose checksum mismatches the leaf's is
        treated as a failed (non-retryable) copy — the fallback continues to
        the other replicas, and once a verified-good page is in hand every
        corrupt copy observed (plus any the caller already detected, via
        ``repair_refs``) is overwritten in place with the good bytes."""
        pm = self.cluster.provider_manager
        policy = self.cluster.retry_policy
        refs = [r for r in leaf.all_page_refs() if r[0] != skip_pid]
        refs = list(refs or leaf.all_page_refs())
        corrupt: List[PageRef] = list(repair_refs)
        last_err: Optional[Exception] = None
        for attempt in range(max(policy.max_attempts, 1)):
            if attempt:
                self._record_retry()
                policy.backoff(attempt - 1)
            retryable = False
            for pid, key in refs:
                if (pid, key) in corrupt:
                    continue  # known-bad copy: only a repair target now
                try:
                    page = pm.get_provider(pid).get_page(key)
                except ProviderFailed as err:
                    pm.note_failure(pid)
                    last_err = err
                    retryable = True  # the provider may come back
                    continue
                except KeyError as err:
                    last_err = err  # missing page/provider: will not heal
                    continue
                if (
                    leaf.checksum is not None
                    and page_checksum(page) != leaf.checksum
                ):
                    # silent corruption: never return the bad bytes; the
                    # copy will not heal by retrying, so fall through to
                    # the remaining replicas and remember it for repair
                    self._record_checksum_failure()
                    pm.note_failure(pid)
                    corrupt.append((pid, key))
                    last_err = ProviderFailed(
                        f"page {page_index} checksum mismatch at provider {pid}"
                    )
                    continue
                pm.note_success(pid)
                self._record_data(pid, 1, page.nbytes, read=True)
                for ref in corrupt:
                    self._repair_corrupt_copy(ref, page)
                return page
            if not retryable:
                break
        raise last_err if last_err else KeyError(f"page {page_index} unavailable")

    def _repair_corrupt_copy(self, ref: PageRef, page: np.ndarray) -> None:
        """Overwrite a checksum-failed stored copy with verified-good bytes.
        Best-effort: page CONTENT under a key is immutable, so rewriting a
        corrupt copy restores the published data rather than mutating it (the
        same sanctioned-re-put argument the repair service relies on)."""
        pm = self.cluster.provider_manager
        pid, key = ref
        try:
            pm.get_provider(pid).put_pages([(key, page)])
        except (ProviderFailed, KeyError):
            return  # the copy stays bad; reads keep falling back around it
        self.stats.record_repair(1)
        self.cluster.stats.record_repair(1)

    # -- lifecycle ---------------------------------------------------------------
    def close(self) -> None:
        """Quiesce the async write window and detach from the cluster.
        Errors of still-outstanding async writes are the caller's to observe
        via ``flush()``/the returned futures, not ``close()``."""
        if self._closed:
            return
        self._closed = True
        with self._async_lock:
            futures, self._async_writes = self._async_writes, []
        for f in futures:
            f.exception()
        # detach the pool under the lock, shut it down OUTSIDE it: a writer
        # task that touches the session while close() waits for it would
        # otherwise deadlock on _writer_pool_lock
        with self._writer_pool_lock:
            pool, self._writer_pool = self._writer_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        self.cluster._forget_session(self)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BlobHandle:
    """Fine-grain access to one blob through one session (paper §III.B).

    WRITE is the overlapped pipeline (data puts in flight while versions are
    assigned and metadata is woven; one join; in-order publication), READ is
    its symmetric streaming pipeline: private tier, then the cluster's
    shared tier with node-wide single-flight, then one level-synchronous
    metadata traversal whose resolving leaves launch aggregated per-provider
    page fetches *while the remaining metadata rounds are still in flight*
    (one join before assembly; ``sync_read`` sessions keep the phased
    baseline). Page transport is zero-copy end to end: ``writev`` freezes
    owning source buffers and hands page views to the providers; a
    full-single-page read returns a read-only view of the stored/cached
    page.
    """

    def __init__(self, session: Session, blob_id: int) -> None:
        self.session = session
        self.blob_id = blob_id
        self.total_pages, self.page_size = (
            session.cluster.version_manager.blob_info(blob_id)
        )

    @property
    def size_bytes(self) -> int:
        return self.total_pages * self.page_size

    @property
    def _vm(self) -> VersionManager:
        return self.session.cluster.version_manager

    # -- versions ---------------------------------------------------------------
    def latest_published(self) -> int:
        """Latest readable published version."""
        return self._vm.latest_published(self.blob_id)

    def wait_for_version(self, version: int, timeout: Optional[float] = None) -> bool:
        """Block until ``version`` publishes; False on timeout."""
        return self._vm.wait_published(self.blob_id, version, timeout)

    def snapshot(self) -> "Snapshot":
        """Pin the latest published version; see :class:`Snapshot`."""
        return self.at(None)

    def at(self, version: Optional[int]) -> "Snapshot":
        """Pin ``version`` (validated published and readable) for lock-free
        repeated reads; ``None`` pins the latest published version. Pinning
        serializes against :meth:`Cluster.gc` so a returned snapshot's
        version was either visible to every earlier GC pass or created after
        the pass finished — never silently collected mid-creation. (A
        snapshot of a version a *completed* GC already dropped still fails
        on first read: the pin protects the future, not the past.)"""
        cluster = self.session.cluster
        with cluster._gc_guard:
            total_pages, page_size, resolved, _ = self._vm.resolve_read_version(
                self.blob_id, version
            )
            cluster.pin_version(self.blob_id, resolved)
        return Snapshot(self, resolved, total_pages, page_size)

    def watch(self, start_version: Optional[int] = None) -> "VersionWatch":
        """Subscribe to publications of this blob: the returned
        :class:`VersionWatch` delivers every published version greater than
        ``start_version`` (default: the latest published right now), strictly
        in version order, waking on :meth:`VersionManager.wait_published`
        instead of polling."""
        if start_version is None:
            start_version = self._vm.latest_published(self.blob_id)
        return VersionWatch(self._vm, self.blob_id, start_version)

    # -- READ -------------------------------------------------------------------
    def read(
        self, offset_bytes: int, size_bytes: int, version: Optional[int] = None
    ) -> ReadResult:
        """Read ``[offset_bytes, offset_bytes+size_bytes)`` of ``version``
        (``None`` = latest published). Fails if ``version`` is unpublished,
        abandoned, or the range is fully out of bounds; a range overlapping
        the blob's end is clamped (short read). A read of exactly one whole
        page returns a read-only view of the stored/cached page (zero-copy);
        copy before mutating."""
        total_pages, page_size, resolved, latest = self._vm.resolve_read_version(
            self.blob_id, version
        )
        data = self.session._readv(
            self.blob_id, resolved, [(offset_bytes, size_bytes)],
            total_pages, page_size,
        )[0]
        return ReadResult(latest, data)

    def readv(
        self, segments: Sequence[Tuple[int, int]], version: Optional[int] = None
    ) -> List[np.ndarray]:
        """Vectored READ: fetch many ``(offset_bytes, size_bytes)`` segments
        of one version in a single batched, *streaming* pass. Pages shared
        between segments are deduplicated; cache hits skip the network
        entirely; the remaining pages cost one level-synchronous metadata
        traversal (one aggregated RPC per shard per level) whose resolving
        leaves immediately launch aggregated per-provider ``get_pages``
        fetches, overlapping data transfer with the rest of the traversal
        (``sync_read`` sessions instead finish the traversal first — the
        phased baseline). Returns one ``np.uint8`` array per segment
        (full-single-page segments are read-only zero-copy views)."""
        total_pages, page_size, resolved, _ = self._vm.resolve_read_version(
            self.blob_id, version
        )
        return self.session._readv(
            self.blob_id, resolved, segments, total_pages, page_size
        )

    # -- WRITE ------------------------------------------------------------------
    def write(self, buffer: np.ndarray, offset_bytes: int) -> int:
        """Patch the blob with ``buffer`` at ``offset_bytes``; returns the
        assigned version (published once all earlier versions publish)."""
        return self.writev([(offset_bytes, buffer)])[0]

    def writev(self, patches: Sequence[Tuple[int, np.ndarray]]) -> List[int]:
        """Vectored WRITE: apply many ``(offset_bytes, buffer)`` page-aligned
        patches. Each patch gets its own version (identical semantics to a
        loop of :meth:`write`, in patch order), but the data plane batches
        AND pipelines: one placement call, ONE aggregated ``put_pages`` RPC
        per data provider across all patches launched up front, version
        assignment and metadata weaving while those puts are in flight, and a
        single join before success is reported. Returns the assigned
        versions.

        Zero-copy hand-off: the write plane freezes each source buffer that
        owns its memory (``writeable = False``) and providers keep page-sized
        views of it; a buffer passed to ``writev`` is surrendered to the
        store for good, whether the write succeeds or fails (another
        overlapping write may already share the frozen buffer, so failure
        cannot safely hand it back). Views of larger writable arrays cannot
        be frozen and are bulk-copied once per patch instead. Caveat the
        store cannot detect: a writable view the caller created BEFORE the
        call still aliases the frozen memory — mutating through it corrupts
        published data, exactly like scribbling over an O_DIRECT buffer with
        I/O in flight."""
        return self.session._writev(self.blob_id, patches)

    def write_async(self, buffer: np.ndarray, offset_bytes: int) -> "Future[int]":
        """Queue a :meth:`write` into the session's bounded in-flight window
        and return a future of its assigned version. Blocks (backpressure)
        once ``max_inflight_writes`` writes are outstanding. Successive
        writes' pipelines overlap — a later write's pages may land before an
        earlier write's metadata — while the version manager still publishes
        strictly in assignment order. Join the window with
        :meth:`Session.flush` (or await the returned future)."""
        return self.session._write_async(self.blob_id, buffer, offset_bytes)

    def write_unaligned(self, buffer: np.ndarray, offset_bytes: int) -> int:
        """WRITE at arbitrary byte offset/size via client-side
        read-modify-write of the boundary pages (the paper's API allows
        arbitrary segments; pages are the storage granularity, so partial
        boundary pages are merged from the latest published version before
        patching). Both boundary pages are fetched in one :meth:`readv`
        call, so hot boundary pages come straight from the page cache.

        Note the concurrency caveat the paper implies: the boundary merge
        reads the LATEST version, so two concurrent unaligned writers sharing
        a boundary page serialize at page granularity like any COW system."""
        page_size = self.page_size
        buffer = np.ascontiguousarray(buffer).view(np.uint8).reshape(-1)
        lo = offset_bytes // page_size * page_size
        hi = -(-(offset_bytes + buffer.size) // page_size) * page_size
        if lo == offset_bytes and hi == offset_bytes + buffer.size:
            return self.write(buffer, offset_bytes)
        merged = np.zeros(hi - lo, np.uint8)
        boundary_segs: List[Tuple[int, int]] = []
        if lo < offset_bytes:  # left boundary page
            boundary_segs.append((lo, page_size))
        if hi > offset_bytes + buffer.size:  # right boundary page
            boundary_segs.append((hi - page_size, page_size))
        boundary = self.readv(boundary_segs)
        for (seg_off, _), data in zip(boundary_segs, boundary):
            merged[seg_off - lo : seg_off - lo + page_size] = data
        merged[offset_bytes - lo : offset_bytes - lo + buffer.size] = buffer
        return self.write(merged, lo)


class Snapshot:
    """An immutable, pinned view of one published version of a blob.

    Repeated reads through a snapshot are **lock-free**: the version was
    resolved and validated once at creation, so :meth:`read`/:meth:`readv`
    never touch the version manager again — the serialized actor costs zero
    on the snapshot re-read path (the supernovae detector differencing the
    same two sky versions window by window). The pinned version is also
    protected from :meth:`Cluster.gc` until :meth:`release` (or context-
    manager exit): GC of *other* versions can proceed freely while this
    snapshot stays readable.
    """

    def __init__(
        self, handle: BlobHandle, version: int, total_pages: int, page_size: int
    ) -> None:
        self.handle = handle
        self.version = version
        self._total_pages = total_pages
        self._page_size = page_size
        self._pinned = True
        self._pin_lock = make_lock("Snapshot._pin_lock")

    @property
    def blob_id(self) -> int:
        return self.handle.blob_id

    @property
    def pinned(self) -> bool:
        return self._pinned

    def read(self, offset_bytes: int, size_bytes: int) -> np.ndarray:
        return self.readv([(offset_bytes, size_bytes)])[0]

    def readv(self, segments: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        return self.handle.session._readv(
            self.handle.blob_id, self.version, segments,
            self._total_pages, self._page_size,
        )

    def release(self) -> None:
        """Drop the GC pin (idempotent). Reads remain possible afterwards but
        are no longer protected from a concurrent :meth:`Cluster.gc`."""
        with self._pin_lock:
            if not self._pinned:
                return
            self._pinned = False
        self.handle.session.cluster.unpin_version(self.handle.blob_id, self.version)

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class VersionWatch:
    """Ordered publish subscription for one blob.

    :meth:`next` blocks until a version newer than the last delivered one is
    published and returns it; versions are delivered densely and strictly in
    order even when many writers publish concurrently (the consumer may lag —
    publications are never skipped, except abandoned holes, which were never
    readable). Iterating the watch yields versions forever."""

    def __init__(self, vm: VersionManager, blob_id: int, start_version: int) -> None:
        self._vm = vm
        self.blob_id = blob_id
        self.last_delivered = start_version

    def next(self, timeout: Optional[float] = None) -> Optional[int]:
        """The next published version after ``last_delivered``, or ``None``
        on timeout. Abandoned (never-readable) versions are skipped."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            target = self.last_delivered + 1
            remaining: Optional[float] = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            try:
                # fail_on_withdrawn=False: an erased version number may be
                # reissued to the next writer, and the watch must deliver it
                # then — only aborted holes (never readable) raise, and those
                # are stepped over without delivery
                if not self._vm.wait_published(
                    self.blob_id, target, remaining, fail_on_withdrawn=False
                ):
                    return None
            except VersionAbandoned:
                self.last_delivered = target
                continue
            self.last_delivered = target
            return target

    def drain(self) -> List[int]:
        """Every already-published undelivered version, without blocking."""
        out: List[int] = []
        while True:
            v = self.next(timeout=0)
            if v is None:
                return out
            out.append(v)

    def __iter__(self) -> Iterator[int]:
        while True:
            v = self.next()
            assert v is not None  # no timeout -> next() only returns versions
            yield v
