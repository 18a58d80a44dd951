# Copy of src/repro/core/federation.py; only the package name in imports differs, apart from
# GcEpochCoordinator's __init__, unpin, sync_pins and end_sweep: a pin resync that arrives while a GC
# sweep is open is installed as the sweep closes instead of waiting for it (see sync_pins).
"""Federated multi-node clusters over one shared substrate (paper §VI).

The paper's deployment is many *access nodes* — each running its own client
sessions, page-cache tier and prefetchers — over one shared infrastructure:
the version manager (still the system's only serialization point), the
metadata DHT and the data providers. :class:`Federation` builds exactly that
topology in-process: N :class:`~repro.core.cluster.Cluster` nodes constructed
around ONE injected ``VersionManager``/``ProviderManager``/``MetadataDHT``,
each keeping its own shared cache tier and session population.

The robustness core is the **GC epoch/lease protocol**
(:class:`GcEpochCoordinator`), the missing distributed half of GC↔cache
coherence. Single-node GC can purge every cache on its node inline; a
federated GC pass cannot reach into a partitioned node's RAM, so reclaiming
storage is only safe once every remote cache is provably incapable of
serving the reclaimed versions:

* every node holds a **time-bounded, renewable lease** tied to the GC epoch
  it last joined;
* ``Federation.gc`` advances the epoch and, per live node, obtains an **ack**
  — the node's cache tiers are purged of the collected versions and the node
  rejoins at the new epoch — retrying per :class:`RetryPolicy`;
* a node whose ack cannot be obtained is **waited out**: its lease expiry
  bounds the stall (recorded in ``TrafficStats.epoch_stalls``), because
* a node whose lease lapses **fences itself**: the per-read lease guard
  purges its tiers (``TrafficStats.lease_fences``) and refuses every
  frontier-validated cache serve — reads fall through to the providers,
  which is always correct — until the node rejoins at the *current* epoch.
  A lease renewal that discovers the epoch advanced underneath it (the
  renew-under-GC race) fences and rejoins the same way, which *is* the ack
  the GC pass is waiting for.

The invariant that makes remote caches trustworthy: **no node ever serves a
cached page of a reclaimed version after its lease expired** — reclaim
happens only after ack-or-expiry, and expiry forces the fence before the
next cache serve.

Node liveness reuses the ``live → suspect → dead`` health machine of the
provider/metadata planes (same :class:`HealthConfig`, same sliding-window
rules): failed ack RPCs feed it, and a node declared **dead** has its lease
and coordinator pins reclaimed and its sessions' assigned-but-unreported
versions abandoned via :meth:`RepairService.recover_writers`, so in-order
publication never wedges behind a dead writer. Snapshot pins are federated
too: every node forwards pins to the coordinator (a partitioned node's pin
is *refused* — the safe failure), so a GC initiated on any node honors
every live node's snapshots; only a death verdict reclaims them.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.lockwatch import make_condition, make_lock
from repro_torch.core.cluster import DEFAULT_SHARED_CACHE_BYTES, Cluster
from repro_torch.core.dht import (
    HealthConfig,
    MetadataDHT,
    ProviderFailed,
    RetryPolicy,
    TrafficStats,
)
from repro_torch.core.provider import DataProvider, ProviderManager
from repro_torch.core.segment_tree import ZERO_VERSION
from repro_torch.core.version_manager import VersionManager

#: node modes (the chaos harness's node plane drives these)
NODE_UP = "up"
#: coordinator RPCs fail, the data plane still works — the fencing story
NODE_PARTITIONED = "partitioned"
#: every RPC in or out fails, but the process is "alive" (hung)
NODE_WEDGED = "wedged"
#: the node is gone
NODE_KILLED = "killed"


class GcEpochCoordinator:
    """Epoch counter + per-node leases + federated snapshot pins.

    All state lives under ONE level-3 lock; no method blocks while holding
    it except :meth:`pin`, which waits on the aliased condition while a GC
    sweep is in progress (the federated analog of the single-node
    ``_gc_guard`` pin linearization — a pin lands strictly before the sweep
    reads the pin set, or strictly after the sweep completes).

    Lease semantics:

    * :meth:`join` grants a fresh lease (``lease_seconds`` long on the
      injectable ``clock``) bound to the *current* epoch — callers must
      purge their cache tiers BEFORE joining a newer epoch;
    * :meth:`renew` extends the lease only while the epoch still matches:
      a renewal under an advanced epoch fails, forcing the fence+rejoin
      that doubles as the GC ack;
    * :meth:`reclaim` (the death path) drops the lease AND the node's pins.

    Node health mirrors :class:`~repro.core.provider.ProviderManager`'s
    machine exactly: failures inside the sliding window make a node
    ``suspect`` then ``dead`` (sticky until success or :meth:`revive`).
    """

    def __init__(
        self,
        lease_seconds: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        health: Optional[HealthConfig] = None,
    ) -> None:
        self.lease_seconds = lease_seconds
        self.clock = clock
        self.health_config = health or HealthConfig()
        self._lock = make_lock("GcEpochCoordinator._lock")
        self._cv = make_condition("GcEpochCoordinator._cv", lock=self._lock)
        self._epoch = 1
        #: node -> epoch it last joined at
        self._lease_epoch: Dict[int, int] = {}
        #: node -> absolute lease expiry on ``clock``
        self._lease_expiry: Dict[int, float] = {}
        #: node -> (blob_id, version) -> refcount (reclaimed on node death)
        self._pins: Dict[int, Dict[Tuple[int, int], int]] = {}
        #: node health: failure timestamps within the window + sticky deaths
        self._failures: Dict[int, List[float]] = {}
        self._dead: Set[int] = set()
        #: a GC storage sweep is in progress: pins wait it out
        self._sweeping = False
        #: node -> pin table of a rejoin-time resync that arrived mid-sweep;
        #: :meth:`end_sweep` installs it as the sweep closes
        self._resyncs: Dict[int, Dict[Tuple[int, int], int]] = {}

    # -- epoch / leases ------------------------------------------------------
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def advance_epoch(self) -> int:
        with self._lock:
            self._epoch += 1
            return self._epoch

    def join(self, node_id: int) -> int:
        """Grant ``node_id`` a fresh lease at the current epoch and return
        that epoch. The caller must have purged its cache tiers first when
        it is joining a newer epoch than it last held."""
        with self._lock:
            if node_id in self._dead:
                raise ProviderFailed(
                    f"node {node_id} is declared dead; revive it first"
                )
            self._lease_epoch[node_id] = self._epoch
            self._lease_expiry[node_id] = self.clock() + self.lease_seconds
            return self._epoch

    def renew(self, node_id: int) -> bool:
        """Extend the lease; ``False`` when the node must fence+rejoin
        instead (epoch advanced under it, lease already expired, or a death
        verdict stands)."""
        with self._lock:
            if node_id in self._dead:
                return False
            if self._lease_epoch.get(node_id) != self._epoch:
                return False  # renew-under-GC: rejoining is the ack
            if self._lease_expiry.get(node_id, 0.0) <= self.clock():
                return False
            self._lease_expiry[node_id] = self.clock() + self.lease_seconds
            return True

    def lease_valid(self, node_id: int) -> bool:
        with self._lock:
            return (
                node_id not in self._dead
                and self._lease_expiry.get(node_id, 0.0) > self.clock()
            )

    def seconds_until_expiry(self, node_id: int) -> float:
        with self._lock:
            return max(
                0.0, self._lease_expiry.get(node_id, 0.0) - self.clock()
            )

    def joined_epoch(self, node_id: int) -> Optional[int]:
        with self._lock:
            return self._lease_epoch.get(node_id)

    def reclaim(self, node_id: int) -> None:
        """Death path: the node's lease AND its pins die with it."""
        with self._lock:
            self._lease_epoch.pop(node_id, None)
            self._lease_expiry.pop(node_id, None)
            self._pins.pop(node_id, None)

    # -- federated snapshot pins ---------------------------------------------
    def pin(self, node_id: int, blob_id: int, version: int) -> None:
        """Register a snapshot pin for ``node_id``. Blocks while a GC sweep
        is in progress — the pin then lands strictly after the pass (whose
        reclaim it could no longer veto), never mid-sweep."""
        with self._cv:
            while self._sweeping:
                self._cv.wait()
            if node_id in self._dead:
                raise ProviderFailed(
                    f"node {node_id} is declared dead; pin refused"
                )
            pins = self._pins.setdefault(node_id, {})
            key = (blob_id, version)
            pins[key] = pins.get(key, 0) + 1

    def unpin(self, node_id: int, blob_id: int, version: int) -> None:
        with self._lock:
            key = (blob_id, version)
            resync = self._resyncs.get(node_id)
            if resync and key in resync:
                # the resync the sweep holds back replaces the node's table
                # when the sweep closes: the unpin must reach it too
                resync[key] -= 1
                if resync[key] <= 0:
                    del resync[key]
            pins = self._pins.get(node_id)
            if not pins:
                return
            key = (blob_id, version)
            if key not in pins:
                return
            pins[key] -= 1
            if pins[key] <= 0:
                del pins[key]
            if not pins:
                del self._pins[node_id]

    def sync_pins(
        self, node_id: int, pins: Dict[Tuple[int, int], int]
    ) -> None:
        """Rejoin-time resync: replace ``node_id``'s registered pins with
        the node's local pin table. Unpins issued while the node was
        unreachable are swallowed best-effort on the node side, so without
        this the coordinator would protect the released versions forever;
        conversely a revived node re-registers the pins its death verdict
        reclaimed. While a sweep is in progress the table is held back and
        installed by :meth:`end_sweep`, so re-added pins land strictly after
        the pass they could no longer veto, as :meth:`pin`'s do.

        Unlike :meth:`pin`, a resync never waits for the sweep: it runs in
        ``Federation.rejoin_node``, which the chaos harness calls from
        whichever thread crosses a ``recover`` event's op, and that can be
        the thread that runs the sweep (its own metadata RPCs cross the
        fault gates). Waiting there would wait on the caller itself."""
        with self._lock:
            if self._sweeping:
                self._resyncs[node_id] = dict(pins)
            elif pins:
                self._pins[node_id] = dict(pins)
            else:
                self._pins.pop(node_id, None)

    def pinned_versions(self, blob_id: int) -> Set[int]:
        """Union of every node's pins for ``blob_id`` — what a federated GC
        pass must keep no matter what the caller asked for."""
        with self._lock:
            return {
                v
                for pins in self._pins.values()
                for (b, v) in pins
                if b == blob_id
            }

    def begin_sweep(self, blob_id: int) -> Set[int]:
        """Open the sweep window: returns the pin snapshot for ``blob_id``
        and blocks new pins until :meth:`end_sweep`."""
        with self._lock:
            self._sweeping = True
            return {
                v
                for pins in self._pins.values()
                for (b, v) in pins
                if b == blob_id
            }

    def end_sweep(self) -> None:
        with self._cv:
            # resyncs that arrived mid-sweep land first, then the pins that
            # waited on the condition land on top of them
            for node_id, pins in self._resyncs.items():
                if pins:
                    self._pins[node_id] = pins
                else:
                    self._pins.pop(node_id, None)
            self._resyncs.clear()
            self._sweeping = False
            self._cv.notify_all()

    # -- node health (live -> suspect -> dead) --------------------------------
    def note_failure(self, node_id: int) -> bool:
        """Record a failed coordinator RPC against ``node_id``; returns True
        exactly once, when the failure crosses the death threshold (the
        caller runs the death path — reclaim + writer recovery — outside
        this lock)."""
        now = self.health_config.clock()
        horizon = now - self.health_config.window_seconds
        with self._lock:
            record = self._failures.setdefault(node_id, [])
            record.append(now)
            while record and record[0] < horizon:
                record.pop(0)
            if (
                len(record) >= self.health_config.dead_after
                and node_id not in self._dead
            ):
                self._dead.add(node_id)
                return True
            return False

    def note_success(self, node_id: int) -> None:
        with self._lock:
            self._failures.pop(node_id, None)
            self._dead.discard(node_id)

    def node_dead(self, node_id: int) -> bool:
        with self._lock:
            return node_id in self._dead

    def health_state(self, node_id: int) -> str:
        now = self.health_config.clock()
        horizon = now - self.health_config.window_seconds
        with self._lock:
            if node_id in self._dead:
                return "dead"
            record = self._failures.get(node_id)
            if not record:
                return "live"
            recent = sum(1 for t in record if t >= horizon)
            return (
                "suspect"
                if recent >= self.health_config.suspect_after
                else "live"
            )

    def revive(self, node_id: int) -> None:
        """Rejoin announcement: clear the health record and death verdict
        (the caller purges the node's tiers and :meth:`join`\\ s it)."""
        with self._lock:
            self._failures.pop(node_id, None)
            self._dead.discard(node_id)


class Federation:
    """N access nodes over one shared substrate, with epoch/lease GC.

    ``nodes[0]`` is the *home* node: it hosts the one wired
    :class:`~repro.core.repair.RepairService` (per-node repair passes over a
    shared substrate would race each other) and runs the storage sweep of a
    federated GC pass. Every node is a full :class:`Cluster` — sessions,
    private + shared cache tiers, prefetchers — whose GC, snapshot-pin and
    cache-serve paths are rewired through this federation.
    """

    def __init__(
        self,
        n_nodes: int = 2,
        n_data_providers: int = 4,
        n_metadata_providers: int = 4,
        page_replication: int = 1,
        metadata_replication: int = 1,
        max_workers: int = 8,
        shared_cache_bytes: int = DEFAULT_SHARED_CACHE_BYTES,
        page_service_seconds: float = 0.0,
        metadata_latency_seconds: float = 0.0,
        retry_policy: Optional[RetryPolicy] = None,
        health: Optional[HealthConfig] = None,
        lease_seconds: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if n_nodes < 1:
            raise ValueError("a federation needs at least one node")
        #: substrate-level traffic (node-local traffic aggregates on each
        #: node's own stats); lease_fences/epoch_stalls land here too
        self.stats = TrafficStats()
        self.retry_policy = retry_policy or RetryPolicy()
        self.clock = clock
        self.version_manager = VersionManager()
        self.provider_manager = ProviderManager(
            replication=page_replication, stats=self.stats, health=health
        )
        for i in range(n_data_providers):
            self.provider_manager.register(
                DataProvider(i, page_service_seconds)
            )
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="fed-dht"
        )
        self.metadata = MetadataDHT(
            n_metadata_providers,
            replication=metadata_replication,
            stats=self.stats,
            executor=self._pool,
            rpc_latency_seconds=metadata_latency_seconds,
            retry_policy=self.retry_policy,
            health=health,
        )
        self.coordinator = GcEpochCoordinator(
            lease_seconds=lease_seconds, clock=clock, health=health
        )
        #: serializes federated GC passes; held across node acks, lease
        #: waits and the home sweep by design (level 0, allow_blocking)
        self._gc_lock = make_lock("Federation._gc_lock")
        #: near-expiry threshold below which the lease guard renews inline
        self._renew_margin = lease_seconds * 0.5
        self._node_modes: List[str] = []
        self._fenced: List[bool] = []
        self._fence_locks: List = []
        self.nodes: List[Cluster] = []
        for i in range(n_nodes):
            node = Cluster(
                max_workers=max_workers,
                shared_cache_bytes=shared_cache_bytes,
                hot_replicas=False,
                page_service_seconds=page_service_seconds,
                retry_policy=self.retry_policy,
                health=health,
                version_manager=self.version_manager,
                provider_manager=self.provider_manager,
                metadata=self.metadata,
            )
            self._wire_node(i, node)
            self.nodes.append(node)
        home = self.nodes[0]
        #: the ONE repair service wired to the shared substrate's death
        #: verdicts (it happens to live on the home node)
        self.repair_service = home.repair_service
        self.provider_manager.on_dead = self.repair_service.schedule
        self.metadata.on_dead = self.repair_service.schedule
        self._closed = False

    def _wire_node(self, i: int, node: Cluster) -> None:
        self._node_modes.append(NODE_UP)
        self._fenced.append(False)
        self._fence_locks.append(make_lock("Federation._fence_lock"))
        node._federation = self
        node._node_id = i
        node._pin_sink = (
            lambda blob_id, version, i=i: self._pin_from_node(
                i, blob_id, version
            )
        )
        node._unpin_sink = (
            lambda blob_id, version, i=i: self._unpin_from_node(
                i, blob_id, version
            )
        )
        node._node_gate = lambda i=i: self._check_node(i)
        node._lease_guard = lambda i=i: self._lease_guard_check(i)
        self.coordinator.join(i)

    # -- topology --------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def node(self, i: int) -> Cluster:
        return self.nodes[i]

    def node_mode(self, i: int) -> str:
        return self._node_modes[i]

    def node_fenced(self, i: int) -> bool:
        return self._fenced[i]

    # -- per-op gates (installed on every node) --------------------------------
    def _check_node(self, i: int) -> None:
        mode = self._node_modes[i]
        if mode in (NODE_KILLED, NODE_WEDGED):
            raise ProviderFailed(f"node {i} is {mode}")

    def _coordinator_reachable(self, i: int) -> bool:
        return self._node_modes[i] == NODE_UP

    def _pin_from_node(self, i: int, blob_id: int, version: int) -> None:
        if not self._coordinator_reachable(i):
            raise ProviderFailed(
                f"node {i} cannot reach the GC coordinator "
                f"({self._node_modes[i]}); pin refused"
            )
        self.coordinator.pin(i, blob_id, version)

    def _unpin_from_node(self, i: int, blob_id: int, version: int) -> None:
        if not self._coordinator_reachable(i):
            raise ProviderFailed(
                f"node {i} cannot reach the GC coordinator "
                f"({self._node_modes[i]})"
            )
        self.coordinator.unpin(i, blob_id, version)

    def _lease_guard_check(self, i: int) -> bool:
        """The per-read gate: may node ``i``'s cache tiers serve right now?

        Valid lease → serve (renewing inline when near expiry and the
        coordinator is reachable). A renewal that fails because the epoch
        advanced (renew-under-GC) fences and rejoins — the implicit ack.
        Lapsed lease → fence BEFORE any further cache serve; rejoin
        immediately when the coordinator is reachable (the freshly purged
        tiers hold nothing stale), else stay fenced and read through."""
        coord = self.coordinator
        if coord.lease_valid(i):
            if (
                self._node_modes[i] == NODE_UP
                and coord.seconds_until_expiry(i) <= self._renew_margin
            ):
                if not coord.renew(i):
                    self._fence(i)
                    return self._rejoin(i)
            return True
        self._fence(i)
        if self._node_modes[i] != NODE_UP:
            return False
        return self._rejoin(i)

    def _fence(self, i: int) -> None:
        """Purge node ``i``'s tiers exactly once per fence transition."""
        with self._fence_locks[i]:
            if self._fenced[i]:
                return
            self._fenced[i] = True
            node = self.nodes[i]
            node.fence_caches()
            node.stats.record_lease_fence()
            self.stats.record_lease_fence()

    def _rejoin(self, i: int) -> bool:
        with self._fence_locks[i]:
            if self._node_modes[i] != NODE_UP:
                return False
            try:
                self.coordinator.join(i)
            except ProviderFailed:
                return False  # declared dead: only rejoin_node() revives
            self._fenced[i] = False
            return True

    # -- federated GC ----------------------------------------------------------
    def gc(
        self, blob_id: int, keep_versions: Sequence[int]
    ) -> Tuple[int, int]:
        """The epoch/lease GC protocol; called via any node's
        ``Cluster.gc`` (which delegates here) or directly.

        1. advance the epoch;
        2. per live node, obtain an **ack** (purge its tiers of the doomed
           versions, rejoin it at the new epoch), retrying per
           :class:`RetryPolicy` — every failed attempt feeds the node
           health machine, and a death verdict runs the death path
           (lease+pin reclaim, writer recovery) instead;
        3. a node that is unreachable but not dead is **waited out**: its
           lease expiry bounds the stall (``epoch_stalls``), and expiry
           guarantees the node fences before its next cache serve;
        4. sweep storage on the home node (whose local GC re-reads the
           coordinator pin set inside its gc guard, blocking new pins for
           the sweep's duration).

        Like single-node GC, the caller promises no concurrent accesses
        target the dropped versions."""
        home = self.nodes[0]
        with self._gc_lock:
            epoch = self.coordinator.advance_epoch()
            latest = self.version_manager.latest_published(blob_id)
            keep_cached = (
                set(keep_versions)
                | self.coordinator.pinned_versions(blob_id)
                | {ZERO_VERSION}
            )
            for i in range(len(self.nodes)):
                if self.coordinator.node_dead(i):
                    continue  # lease and pins were reclaimed with the verdict
                if self._ack_with_retries(i, blob_id, keep_cached, latest, epoch):
                    continue
                self._wait_out_lease(i, epoch)
            return home.gc(blob_id, keep_versions, _local=True)

    def _ack_with_retries(
        self,
        i: int,
        blob_id: int,
        keep_cached: Set[int],
        latest: int,
        epoch: int,
    ) -> bool:
        """True when node ``i`` is handled — acked (directly or by its own
        fence+rejoin) or declared dead (death path run)."""
        policy = self.retry_policy
        attempts = max(policy.max_attempts, 1)
        for attempt in range(attempts):
            if self.coordinator.joined_epoch(i) == epoch:
                self.coordinator.note_success(i)
                return True  # implicit ack: the node fenced+rejoined itself
            try:
                self._ack_node(i, blob_id, keep_cached, latest)
                return True
            except ProviderFailed:
                if self.coordinator.note_failure(i):
                    self._handle_node_death(i)
                    return True
                if attempt + 1 < attempts:
                    self.stats.record_retry()
                    policy.backoff(attempt)
        return False

    def _ack_node(
        self, i: int, blob_id: int, keep_cached: Set[int], latest: int
    ) -> None:
        """One ack RPC: purge the node's tiers of the doomed versions and
        rejoin it at the current epoch. Raises ``ProviderFailed`` when the
        node is unreachable (killed / wedged / partitioned)."""
        if self._node_modes[i] != NODE_UP:
            raise ProviderFailed(f"node {i} is {self._node_modes[i]}")
        node = self.nodes[i]
        caches = [node.shared_cache] + [s.cache for s in node.sessions()]
        for cache in caches:
            if cache is not None:
                cache.drop_versions(blob_id, keep_cached, max_version=latest)
        self.coordinator.note_success(i)
        self.coordinator.join(i)
        with self._fence_locks[i]:
            self._fenced[i] = False

    def _wait_out_lease(self, i: int, epoch: int) -> None:
        """An unreachable-but-not-dead node stalls the pass until its lease
        expires (or it acks by rejoining on its own): past expiry the node
        cannot serve a cached page without fencing first, so reclaim is
        safe without its ack."""
        coord = self.coordinator
        stalled = False
        while True:
            if coord.joined_epoch(i) == epoch:
                return  # implicit ack
            remaining = coord.seconds_until_expiry(i)
            if remaining <= 0.0:
                return  # lease lapsed: the node fences before its next serve
            if not stalled:
                stalled = True
                self.stats.record_epoch_stall()
            # sleep on the policy's injectable sleep so chaos tests drive
            # this loop with a fake clock, bounded so a lease granted on a
            # coarse clock still converges quickly
            self.retry_policy.sleep(
                min(remaining, max(self.coordinator.lease_seconds * 0.1, 1e-4))
            )

    def _handle_node_death(self, i: int) -> None:
        """Death path: reclaim the lease and pins, fence whatever the node
        cached, and abandon its sessions' in-flight writes so in-order
        publication never wedges behind the dead writers."""
        node = self.nodes[i]
        self.coordinator.reclaim(i)
        with self._fence_locks[i]:
            self._fenced[i] = True
        self.repair_service.recover_writers(node.sessions())

    # -- node-plane faults (chaos harness) -------------------------------------
    def apply_node_fault(self, i: int, action: str) -> None:
        """The chaos harness's node plane: ``kill`` / ``wedge`` drop the
        whole node (every data op raises), ``partition`` cuts only the
        coordinator RPCs (the data plane still works — the fencing story),
        ``recover`` rejoins the node at the current epoch."""
        if action == "kill":
            self._node_modes[i] = NODE_KILLED
        elif action == "wedge":
            self._node_modes[i] = NODE_WEDGED
        elif action == "partition":
            self._node_modes[i] = NODE_PARTITIONED
        elif action == "recover":
            self.rejoin_node(i)
        else:
            raise ValueError(f"unknown node fault action {action!r}")

    def rejoin_node(self, i: int) -> None:
        """Bring a downed node back: purge its tiers (it may have missed any
        number of GC purges while away), clear its health record, resync its
        pins, grant a fresh lease at the current epoch.

        The pin resync reconciles both drift directions a downtime window
        accrues: unpins the node issued while unreachable were swallowed
        best-effort (the coordinator would otherwise protect the released
        versions forever), and a death verdict reclaimed pins the node's
        live snapshots still hold. The mode flips to ``up`` only after the
        resync, so no new pin can interleave with the snapshot."""
        self.coordinator.revive(i)
        with self._fence_locks[i]:
            self.nodes[i].fence_caches()
            self.coordinator.join(i)
            self.coordinator.sync_pins(i, self.nodes[i].local_pins())
            self._fenced[i] = False
        self._node_modes[i] = NODE_UP

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for node in self.nodes:
            node.close()
        self.metadata.close()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "Federation":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
