# Copy of src/repro/core/provider.py (the JAX package's storage core); only the package name in imports differs.
"""Data providers + provider manager (paper §III.A).

Data providers store pages in RAM. The provider manager tracks registered
providers and, per WRITE, picks which providers receive the freshly written
pages using a load-balancing strategy (least-loaded, ties broken by provider
id — "some strategy that favors global load balancing").

Providers may join and leave dynamically; page replication (``replication``)
plus replica fallback on read provides the fault tolerance the paper defers to
future work.

Placement is a lazy min-heap over ``(load, provider_id)``: allocating a page
pops the ``replication`` least-loaded providers and pushes them back with
their load incremented, so a bulk allocation of ``n`` pages costs
O(n·replication·log P) heap operations instead of the O(n·P·log P) of a
per-page full sort. Stale heap entries (left behind by ``release`` or
membership churn) are discarded on pop; every push/pop is counted in
``placement_ops`` so tests can assert the complexity bound.
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.lockwatch import make_lock

# DEAD/LIVE/SUSPECT and HealthConfig moved to repro.core.dht in the
# metadata-fault PR (both planes share one health machine); imported here so
# existing ``repro.core.provider.HealthConfig`` references keep working.
from repro_torch.core.dht import (  # noqa: F401 - re-exports
    DEAD,
    LIVE,
    SUSPECT,
    HealthConfig,
    ProviderFailed,
    TrafficStats,
)
from repro_torch.core.segment_tree import PageRef


class DataProvider:
    """RAM page store. Pages are immutable once stored (COW discipline).

    All page-map accesses are serialized on a per-provider lock, so concurrent
    ``put_pages``/``delete_pages`` never race ``used_bytes``/``n_pages``
    iterating the dict. ``page_service_seconds`` > 0 models a provider with
    finite service bandwidth: each request holds the lock for that long per
    page transferred (the sleep releases the GIL, so *different* providers
    still serve in parallel — exactly the paper's network model, where a hot
    provider is the bottleneck and spreading load across providers helps).
    """

    def __init__(self, provider_id: int, page_service_seconds: float = 0.0) -> None:
        self.provider_id = provider_id
        self.page_service_seconds = page_service_seconds
        self._pages: Dict[int, np.ndarray] = {}
        self._lock = make_lock("DataProvider._lock")
        self.failed = False
        #: chaos-harness hook (:mod:`repro.core.faults`): called at RPC entry
        #: with ``(op, provider_id)`` BEFORE the provider lock is taken, so an
        #: injector may sleep (delay), raise ``ProviderFailed`` (drop), or
        #: flip failure flags without ever nesting under a level-5 lock
        self.fault_gate: Optional[Callable[[str, int], None]] = None

    def _serve(self, n_pages: int) -> None:
        if self.page_service_seconds > 0.0 and n_pages > 0:
            time.sleep(self.page_service_seconds * n_pages)

    def _gate(self, op: str) -> None:
        gate = self.fault_gate
        if gate is not None:
            gate(op, self.provider_id)

    def set_failed(self, failed: bool) -> None:
        """Flip the failure-injection flag under this provider's own lock, so
        the transition serializes against in-flight ``put_pages``/``get_pages``
        (which check ``failed`` under the same lock): a request observes the
        provider strictly before or strictly after the transition, never a
        torn mid-request flip."""
        with self._lock:
            self.failed = failed

    def put_pages(self, items: Sequence[Tuple[int, np.ndarray]]) -> None:
        """Store pages zero-copy: the given arrays (typically read-only views
        into a writer's frozen source buffer) are referenced, never copied.
        Each stored page is marked read-only here, so the COW discipline is
        enforced at the store boundary no matter what the caller passed."""
        self._gate("put_pages")
        with self._lock:
            if self.failed:
                raise ProviderFailed(f"data provider {self.provider_id} is down")
            for page_key, data in items:
                data.flags.writeable = False
                self._pages[page_key] = data
            self._serve(len(items))

    def get_page(self, page_key: int) -> np.ndarray:
        self._gate("get_page")
        with self._lock:
            if self.failed:
                raise ProviderFailed(f"data provider {self.provider_id} is down")
            page = self._pages[page_key]
            self._serve(1)
            return page

    def get_pages(self, page_keys: Sequence[int]) -> List[np.ndarray]:
        """One aggregated RPC for many pages (paper §V.A batching). Raises
        ``KeyError`` on the first missing key — callers fall back per page.
        Returns the stored (immutable, read-only) arrays themselves — no
        defensive copies; published-page immutability makes sharing safe."""
        self._gate("get_pages")
        with self._lock:
            if self.failed:
                raise ProviderFailed(f"data provider {self.provider_id} is down")
            pages = [self._pages[key] for key in page_keys]
            self._serve(len(pages))
            return pages

    def has_page(self, page_key: int) -> bool:
        with self._lock:
            return not self.failed and page_key in self._pages

    def delete_pages(self, page_keys: Sequence[int]) -> None:
        with self._lock:
            for key in page_keys:
                self._pages.pop(key, None)

    @property
    def n_pages(self) -> int:
        with self._lock:
            return len(self._pages)

    def used_bytes(self) -> int:
        with self._lock:
            return sum(p.nbytes for p in self._pages.values())


class ProviderManager:
    """Tracks live data providers and allocates page placements.

    Placement returns, per page, a primary provider and ``replication - 1``
    replica providers (all distinct). The strategy is least-loaded-first over
    a running load counter, which converges to the round-robin-ish balance the
    paper relies on for its throughput scaling.
    """

    def __init__(
        self,
        replication: int = 1,
        stats: Optional[TrafficStats] = None,
        health: Optional[HealthConfig] = None,
    ) -> None:
        self.replication = replication
        self._providers: Dict[int, DataProvider] = {}
        self._load: Dict[int, int] = {}
        #: lazy min-heap of (load, provider_id); entries whose load no longer
        #: matches ``_load`` (or whose provider left) are discarded on pop
        self._heap: List[Tuple[int, int]] = []
        #: heap pushes + pops, for complexity assertions in tests
        self.placement_ops = 0
        self._page_key_counter = itertools.count()
        self._lock = make_lock("ProviderManager._lock")
        self.stats = stats or TrafficStats()
        self.health_config = health or HealthConfig()
        #: per-provider failure timestamps within the decay window; a pid is
        #: present here only while it has recorded failures, so the hot-path
        #: ``note_success`` membership probe stays a racy dict lookup
        self._failures: Dict[int, List[float]] = {}
        #: pids declared dead (sticky until success/recover)
        self._dead: set = set()
        #: invoked OUTSIDE the manager lock when a provider transitions to
        #: dead — the cluster wires this to RepairService scheduling
        self.on_dead: Optional[Callable[[int], None]] = None

    # -- membership (dynamic join/leave, paper §III.A) ---------------------
    def register(self, provider: DataProvider) -> None:
        with self._lock:
            self._providers[provider.provider_id] = provider
            self._load.setdefault(provider.provider_id, 0)
            self._push(provider.provider_id)

    def deregister(self, provider_id: int) -> int:
        """Remove a provider and release its outstanding load credit.

        Returns the released credit (pages the manager still charged to the
        provider when it left) so callers can account for the re-placement
        work the departure implies. Health records go with it — a provider
        that re-registers under the same id starts live with zero load.
        """
        with self._lock:
            self._providers.pop(provider_id, None)
            credit = self._load.pop(provider_id, 0)
            self._failures.pop(provider_id, None)
            self._dead.discard(provider_id)
            # heap entries for provider_id go stale and die on pop
            return credit

    def providers(self) -> List[DataProvider]:
        with self._lock:
            return list(self._providers.values())

    def get_provider(self, provider_id: int) -> DataProvider:
        with self._lock:
            return self._resolve_locked(provider_id)

    def _resolve_locked(self, provider_id: int) -> DataProvider:
        try:
            return self._providers[provider_id]
        except KeyError:
            raise KeyError(
                f"unknown data provider id {provider_id}; registered ids: "
                f"{sorted(self._providers)}"
            ) from None

    # -- health (live -> suspect -> dead, paper-deferred fault tolerance) ----
    def note_failure(self, provider_id: int) -> None:
        """Record an observed RPC failure against ``provider_id``.

        Transitions the provider ``live -> suspect -> dead`` per the
        :class:`HealthConfig` thresholds. The ``on_dead`` callback fires
        exactly once per death, outside the manager lock (it schedules
        repair work that takes other level-4 locks).
        """
        now = self.health_config.clock()
        horizon = now - self.health_config.window_seconds
        newly_dead = False
        with self._lock:
            if provider_id not in self._providers:
                return  # departed or never registered: nothing to track
            record = self._failures.setdefault(provider_id, [])
            record.append(now)
            while record and record[0] < horizon:
                record.pop(0)
            if (
                len(record) >= self.health_config.dead_after
                and provider_id not in self._dead
            ):
                self._dead.add(provider_id)
                newly_dead = True
            callback = self.on_dead
        if newly_dead and callback is not None:
            callback(provider_id)

    def note_success(self, provider_id: int) -> None:
        """An observed successful RPC clears suspicion and death. The
        unlocked membership probe keeps this free on the (overwhelmingly
        common) healthy fast path; the race is benign — a concurrent
        ``note_failure`` simply wins or loses the lock like any other
        interleaving of the two observations."""
        if provider_id not in self._failures and provider_id not in self._dead:
            return
        with self._lock:
            self._failures.pop(provider_id, None)
            if provider_id in self._dead:
                self._dead.discard(provider_id)
                if provider_id in self._load:
                    self._push(provider_id)

    def health_state(self, provider_id: int) -> str:
        """``live``/``suspect``/``dead`` for a registered provider."""
        now = self.health_config.clock()
        horizon = now - self.health_config.window_seconds
        with self._lock:
            self._resolve_locked(provider_id)
            return self._health_state_locked(provider_id, horizon)

    def _health_state_locked(self, provider_id: int, horizon: float) -> str:
        if provider_id in self._dead:
            return DEAD
        record = self._failures.get(provider_id)
        if not record:
            return LIVE
        recent = sum(1 for t in record if t >= horizon)
        return SUSPECT if recent >= self.health_config.suspect_after else LIVE

    def healthy_providers(self) -> List[DataProvider]:
        """Providers currently ``live`` (no recent failures, not failed) —
        the candidate set for repair targets and fresh placements."""
        now = self.health_config.clock()
        horizon = now - self.health_config.window_seconds
        with self._lock:
            return [
                provider
                for pid, provider in self._providers.items()
                if not provider.failed
                and self._health_state_locked(pid, horizon) == LIVE
            ]

    def dead_providers(self) -> List[int]:
        """Pids currently declared dead (repair's work queue)."""
        with self._lock:
            return sorted(self._dead)

    def _placeable_locked(self, pid: int) -> bool:
        """Placement admits live and suspect providers but never dead or
        failure-flagged ones: one blip should not evict a node from
        placement (the retry layer absorbs it), a declared death must."""
        provider = self._providers.get(pid)
        return provider is not None and not provider.failed and pid not in self._dead

    # -- placement ----------------------------------------------------------
    def _push(self, pid: int) -> None:
        heapq.heappush(self._heap, (self._load[pid], pid))
        self.placement_ops += 1

    def _pop_least_loaded(self, exclude: set, stash: List[Tuple[int, int]]) -> int:
        """Pop until a healthy, non-stale, non-excluded provider surfaces.

        Valid heap entries of *unhealthy* (failed or dead) providers are
        stashed instead of discarded — the caller re-pushes them after the
        batch, so a provider that later recovers resurfaces in the heap
        without any re-seeding bookkeeping.
        """
        while True:
            try:
                load, pid = heapq.heappop(self._heap)
            except IndexError:
                raise ProviderFailed(
                    "placement heap exhausted: no healthy provider available"
                ) from None
            self.placement_ops += 1
            if pid not in self._providers or self._load[pid] != load:
                continue  # stale: provider left, or load moved on
            if pid in exclude:
                continue  # duplicate entry of an already-chosen provider
            if not self._placeable_locked(pid):
                stash.append((load, pid))  # valid entry, provider down: keep
                continue
            return pid

    def allocate(self, n_pages: int) -> List[Tuple[PageRef, Tuple[PageRef, ...]]]:
        """Pick (primary, replicas) for ``n_pages`` fresh pages in bulk.

        One lock acquisition and O(n_pages·replication·log P) heap work for
        the whole batch — the per-page sort this replaces was
        O(n_pages·P·log P) *inside the lock*, which serialized concurrent
        writers on placement instead of on the version manager only.

        Only *healthy* providers (not failure-flagged, not declared dead)
        receive placements; raises ``RuntimeError`` when fewer than
        ``replication`` of them remain.
        """
        with self._lock:
            placeable = sum(1 for pid in self._providers if self._placeable_locked(pid))
            if placeable < self.replication:
                # ProviderFailed (a RuntimeError) rather than a bare
                # RuntimeError: writers treat "no healthy placement" exactly
                # like a provider failure — abort, abandon, clean up
                raise ProviderFailed(
                    f"only {placeable} healthy providers for replication "
                    f"{self.replication} ({len(self._providers)} registered)"
                )
            stash: List[Tuple[int, int]] = []
            out: List[Tuple[PageRef, Tuple[PageRef, ...]]] = []
            for _ in range(n_pages):
                chosen: List[int] = []
                taken: set = set()
                while len(chosen) < self.replication:
                    pid = self._pop_least_loaded(taken, stash)
                    chosen.append(pid)
                    taken.add(pid)
                key = next(self._page_key_counter)
                for pid in chosen:
                    self._load[pid] += 1
                    self._push(pid)
                primary: PageRef = (chosen[0], key)
                replicas: Tuple[PageRef, ...] = tuple((pid, key) for pid in chosen[1:])
                out.append((primary, replicas))
            for entry in stash:  # down providers stay discoverable post-recovery
                heapq.heappush(self._heap, entry)
                self.placement_ops += 1
            return out

    def least_loaded(self, exclude: Sequence[int] = ()) -> Optional[int]:
        """Peek the least-loaded healthy (non-failed, non-dead) provider not
        in ``exclude`` (for the replica balancer's promotion targets and the
        write plane's mid-flight re-placements). Returns ``None`` if no
        provider qualifies — one failed cold provider must not block
        promotion while healthy targets exist."""
        excluded = set(exclude)
        with self._lock:
            candidates = [
                pid
                for pid in self._providers
                if pid not in excluded and self._placeable_locked(pid)
            ]
            if not candidates:
                return None
            return min(candidates, key=lambda pid: (self._load[pid], pid))

    def add_load(self, pid: int, n_pages: int = 1) -> None:
        """Charge ``pid`` for pages placed outside :meth:`allocate` (promoted
        hot-page replicas), keeping the heap's least-loaded order truthful."""
        with self._lock:
            if pid in self._load:
                self._load[pid] += n_pages
                self._push(pid)

    def release(self, refs: Sequence[PageRef]) -> None:
        """Return load credit for GC'd pages."""
        with self._lock:
            for pid, _ in refs:
                if pid in self._load and self._load[pid] > 0:
                    self._load[pid] -= 1
                    self._push(pid)

    # -- failure injection ---------------------------------------------------
    # The manager lock only resolves the provider; the flag itself flips
    # under the PROVIDER's lock (set_failed), strictly after the manager lock
    # is released — manager(level 4) -> provider(level 5) nesting is legal but
    # unnecessary here, and the provider lock is what put/get check under.
    def fail_provider(self, provider_id: int) -> None:
        with self._lock:
            provider = self._resolve_locked(provider_id)
        provider.set_failed(True)

    def recover_provider(self, provider_id: int) -> None:
        """Clear the failure-injection flag AND the health record — this is
        the provider's rejoin announcement, so it comes back ``live`` and
        placeable immediately."""
        with self._lock:
            provider = self._resolve_locked(provider_id)
            self._failures.pop(provider_id, None)
            self._dead.discard(provider_id)
            self._push(provider_id)  # guarantee a fresh, valid heap entry
        provider.set_failed(False)

    def load_snapshot(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._load)
