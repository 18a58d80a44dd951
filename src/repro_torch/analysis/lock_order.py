# Copy of src/repro/analysis/lock_order.py (the JAX package's storage core); only the package name in imports differs.
"""The repo's global lock hierarchy — the single source of truth.

Every lock in ``repro.core`` (and the lock-bearing satellites in
``repro.storage``) is declared here with a *level*: a thread may only acquire
a lock whose level is strictly greater than the level of every lock it
already holds. The static lint (:mod:`repro.analysis.lint`) checks acquisition
edges against this partial order at parse time; the runtime watchdog
(:mod:`repro.analysis.lockwatch`) records the actual acquisition graph and
reports any cycle — the two see the same names because lock construction goes
through :func:`repro.analysis.lockwatch.make_lock` with the declared name.

Levels (outermost → innermost):

======  ======================================================================
level   locks
======  ======================================================================
0       ``BlobCheckpointer._lock`` — serializes whole checkpoint passes; a
        save calls the full write plane AND ``Cluster.gc`` underneath
1       ``Cluster._gc_guard`` — serializes GC passes against snapshot pinning
2       ``ReplicaBalancer._rebalance_lock`` / ``RepairService._lock`` —
        promotion and re-replication/scrub passes; non-blocking for readers,
        deliberately held across data-plane copies (one aliases the other
        when both actors exist)
3       per-object bookkeeping locks that guard small registries and windows
        (session lists, async-write windows, coalesce queues, pin flags)
4       the shared actors' state locks (version manager, provider manager,
        pin table, balancer heat counters, aux-pool bring-up)
5       leaf locks: per-cache, per-provider, per-stats — never hold anything
        else while holding one of these
======  ======================================================================

``allow_blocking`` marks locks that are *designed* to be held across blocking
work (modeled-RTT RPCs, provider service sleeps). For every other lock, any
blocking call — ``time.sleep``, ``Future.result``, ``Event.wait``, executor
joins, the modeled RPC methods — inside its critical section is a lint
violation (rule ``blocking-under-lock``).

A lock that exists in the code but not here is itself a violation
(``undeclared-lock``): growing the concurrency surface requires declaring
where the new lock sits in the order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class LockSpec:
    """One declared lock: its canonical name, hierarchy level, and whether it
    may be held across blocking calls."""

    name: str  #: canonical name, ``Class._attr`` — the make_lock() argument
    level: int  #: partial order: may acquire only strictly greater levels
    allow_blocking: bool = False
    note: str = ""


#: The declared hierarchy. Order within a level is irrelevant — locks of the
#: SAME level must never nest (for aliases of one underlying lock, nesting
#: would be a self-deadlock; for distinct locks it is an undeclared ordering).
LOCKS = [
    # -- level 0: checkpoint passes (blocking by design) ---------------------
    LockSpec("BlobCheckpointer._lock", 0, allow_blocking=True,
             note="serializes save/restore passes; a save holds it across "
                  "full blob writes AND the retention Cluster.gc call"),
    LockSpec("Federation._gc_lock", 0, allow_blocking=True,
             note="serializes federated GC passes; held across per-node "
                  "acks, RetryPolicy backoffs, lease-expiry waits and the "
                  "home node's Cluster.gc by design. Same level as "
                  "BlobCheckpointer._lock: a checkpointer must never wrap "
                  "a federated node (its retention gc would nest the two)"),
    # -- level 1: GC passes ---------------------------------------------------
    LockSpec("Cluster._gc_guard", 1, allow_blocking=True,
             note="serializes GC passes against snapshot creation; the pass "
                  "does metadata/provider RPCs under it by design"),
    # -- level 2: promotion / repair passes ----------------------------------
    LockSpec("ReplicaBalancer._rebalance_lock", 2, allow_blocking=True,
             note="readers try-lock and skip; held across page copies so "
                  "promotions serialize without queueing the read path"),
    LockSpec("Federation._fence_lock", 2, allow_blocking=True,
             note="per-node fence/rejoin transitions (one instance per "
                  "node); held across the node's cache purges (level 5) "
                  "and the coordinator join (level 3), so it must sit "
                  "BELOW the coordinator lock. Never nests the repair/"
                  "rebalance locks of this level"),
    LockSpec("RepairService._lock", 2, allow_blocking=True,
             note="re-replication/scrub passes; held across data-plane "
                  "copies like the rebalance lock. On clusters WITH a "
                  "balancer this name is never constructed — the service "
                  "ALIASES ReplicaBalancer._rebalance_lock so repair, "
                  "promotion and GC exclusion all serialize on one lock "
                  "(same level: the two names must never nest)"),
    # -- level 3: small registries / windows ---------------------------------
    LockSpec("Cluster._sessions_lock", 3),
    LockSpec("Cluster._membership_lock", 3),
    LockSpec("Cluster._warmers_lock", 3),
    LockSpec("Session._async_lock", 3),
    LockSpec("Session._writer_pool_lock", 3),
    LockSpec("Snapshot._pin_lock", 3),
    LockSpec("StridePrefetcher._lock", 3),
    LockSpec("_PageFetchStream._lock", 3),
    LockSpec("WatchWarmer._cv", 3,
             note="condition over its own lock; warmer rendezvous only"),
    LockSpec("MetadataDHT._coalesce_lock", 3),
    LockSpec("MetadataDHT._executor_lock", 3),
    LockSpec("BlobStore._handles_lock", 3),
    LockSpec("GcEpochCoordinator._lock", 3,
             note="epoch counter, per-node leases, federated pin tables "
                  "and node health; no RPC ever runs under it"),
    LockSpec("GcEpochCoordinator._cv", 3,
             note="condition ALIASING GcEpochCoordinator._lock (the "
                  "VersionManager._published_cv pattern): pins wait on it "
                  "while a GC sweep is in progress; nesting the two names "
                  "is a self-deadlock"),
    LockSpec("FaultInjector._lock", 3,
             note="guards the chaos harness's op counter and pending "
                  "fault queues; fault ACTIONS (kill/recover/sleep) run "
                  "outside it"),
    LockSpec("PageDirectory._lock", 3,
             note="the content-addressed page registry (dict/LRU/refcounts "
                  "only); version pins are taken BEFORE it (they nest the "
                  "level-1 gc guard) and eviction hooks/unpins fire OUTSIDE "
                  "it — same level as BlobKVStore._lock: never nest the two"),
    LockSpec("BlobKVStore._lock", 3,
             note="KV page-pool slot free-list + refcounts; directory "
                  "eviction (which re-enters the level-4 pin table) is "
                  "always called with this RELEASED"),
    # -- level 4: shared-actor state -----------------------------------------
    LockSpec("Cluster._aux_lock", 4),
    LockSpec("Cluster._pins_lock", 4),
    LockSpec("VersionManager._lock", 4),
    LockSpec("VersionManager._published_cv", 4,
             note="condition ALIASING VersionManager._lock — same underlying "
                  "lock, so nesting the two names is a self-deadlock (equal "
                  "levels forbid it)"),
    LockSpec("ProviderManager._lock", 4),
    LockSpec("MetadataDHT._health_lock", 4,
             note="shard health records (failure window + dead set), the "
                  "metadata mirror of ProviderManager._lock; on_dead fires "
                  "OUTSIDE it"),
    LockSpec("ReplicaBalancer._heat_lock", 4),
    # -- level 5: leaves ------------------------------------------------------
    LockSpec("PageCache._lock", 5),
    LockSpec("DataProvider._lock", 5, allow_blocking=True,
             note="page_service_seconds sleeps UNDER the lock on purpose: a "
                  "provider with finite service bandwidth is the paper's "
                  "network model (hot provider = bottleneck)"),
    LockSpec("TrafficStats._lock", 5),
]

BY_NAME: Dict[str, LockSpec] = {spec.name: spec for spec in LOCKS}

#: attribute-suffix → spec, only for suffixes that are unambiguous across the
#: registry (``_lock`` is not; ``_gc_guard`` is) — lets the lint resolve
#: acquisitions through foreign receivers like ``cluster._gc_guard``.
_suffix_counts: Dict[str, int] = {}
for _spec in LOCKS:
    _suffix_counts[_spec.name.split(".")[-1]] = (
        _suffix_counts.get(_spec.name.split(".")[-1], 0) + 1
    )
BY_UNIQUE_ATTR: Dict[str, LockSpec] = {
    spec.name.split(".")[-1]: spec
    for spec in LOCKS
    if _suffix_counts[spec.name.split(".")[-1]] == 1
}


def get(name: str) -> Optional[LockSpec]:
    return BY_NAME.get(name)


def allows_blocking(name: str) -> bool:
    """Whether ``name`` may be held across blocking calls. Unknown locks
    default to ``False`` — an undeclared lock gets the strict rules."""
    spec = BY_NAME.get(name)
    return spec.allow_blocking if spec is not None else False


def order_violation(held: str, acquiring: str) -> Optional[str]:
    """Return a human-readable reason if acquiring ``acquiring`` while holding
    ``held`` breaks the declared partial order, else ``None``. Unknown locks
    are not ordered here (the lint reports them separately as
    ``undeclared-lock``)."""
    a, b = BY_NAME.get(held), BY_NAME.get(acquiring)
    if a is None or b is None:
        return None
    if held == acquiring:
        return f"re-acquiring non-reentrant {held} (self-deadlock)"
    if b.level < a.level:
        return (
            f"acquires {acquiring} (level {b.level}) while holding {held} "
            f"(level {a.level}) — edges must go strictly downward in the "
            f"declared hierarchy"
        )
    if b.level == a.level:
        return (
            f"acquires {acquiring} while holding {held}: both level "
            f"{a.level} — same-level locks must never nest"
        )
    return None
