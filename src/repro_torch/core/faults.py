# Copy of src/repro/core/faults.py (the JAX package's chaos harness); only the package name in imports differs.
"""Deterministic chaos harness: seeded fault schedules for all three planes.

The self-healing machinery (health states, retry/backoff, mid-flight write
re-placement, replica-fallback reads, background repair) is only as
trustworthy as the failures it was exercised under. This module injects
those failures *deterministically*:

* A :class:`FaultSchedule` is a seeded, immutable list of
  :class:`FaultEvent`\\ s positioned in **operation space** — "at the N-th
  data-plane RPC, kill provider 3" — not wall-clock time, so a loaded CI
  machine and a laptop replay the same fault sequence.
* A :class:`FaultInjector` attaches to every data provider's AND metadata
  shard's ``fault_gate`` (an RPC-entry hook that runs BEFORE the actor's
  lock) and counts RPCs cluster-wide on one shared clock; events fire as
  their op index is crossed. Kills flip the actor's failure flag
  (``ProviderManager.fail_provider`` / ``MetadataDHT.fail_shard``) —
  in-flight requests observe the flip exactly as a real crash: mid-batch,
  under live traffic. Drops fail one single RPC; delays stall one RPC.
* A third, **node plane** (``target="node"``) drives whole federation
  nodes on the same shared op clock: ``kill`` / ``wedge`` down a node,
  ``partition`` cuts only its GC-coordinator RPCs (data plane intact — the
  lease-fencing story), ``recover`` rejoins it at the current epoch. Node
  events need a :class:`~repro.core.federation.Federation` as the
  injector's cluster.

Determinism caveat, stated honestly: the *schedule* is deterministic, but
which concurrent client's RPC crosses the op threshold depends on thread
interleaving. Chaos tests therefore assert interleaving-independent
invariants (zero published-data loss, monotone publish frontier,
replication-factor restoration) rather than exact traces — the properties
the paper's lock-free design must hold under ANY interleaving.

All injector state lives under its own level-3 lock; fault ACTIONS
(kill/recover/sleep/raise) run strictly outside it, so the gate never nests
into the manager or provider locks while holding anything.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import TYPE_CHECKING, Dict, List, Sequence, Set, Tuple

from repro_torch.analysis.lockwatch import make_lock
from repro_torch.core.dht import ProviderFailed

if TYPE_CHECKING:  # pragma: no cover - cluster imports stay one-directional
    from repro_torch.core.cluster import Cluster

#: fault actions
KILL = "kill"  #: flip the provider's failed flag (stays down until recover)
RECOVER = "recover"  #: clear the flag + health record (rejoin announcement)
DROP = "drop"  #: fail exactly one subsequent RPC at the provider
DELAY = "delay"  #: stall exactly one subsequent RPC by ``param`` seconds
#: node-plane only: cut the node's GC-coordinator RPCs, data plane intact —
#: exercises the lease-fencing story rather than plain unavailability
PARTITION = "partition"
#: node-plane only: the node hangs — every data op raises, process "alive"
WEDGE = "wedge"

#: fault targets — which plane's RPCs the event hits
DATA = "data"  #: ``provider_id`` names a data provider
METADATA = "metadata"  #: ``provider_id`` names a metadata shard
#: ``provider_id`` names a federation node (requires a
#: :class:`~repro.core.federation.Federation` as the injector's cluster)
NODE = "node"


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One scheduled fault: at the ``at_op``-th cluster-wide RPC (or
    later — the next RPC to cross the threshold), apply ``action`` to
    ``provider_id``. ``param`` is the delay in seconds for ``delay``;
    ``target`` selects the plane (``provider_id`` is a data provider id for
    :data:`DATA`, a metadata shard id for :data:`METADATA`). Both planes
    advance the SAME op clock, so a mixed campaign interleaves its kills
    exactly where the merged traffic crossed each threshold."""

    at_op: int
    action: str
    provider_id: int
    param: float = 0.0
    target: str = DATA


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, op-ordered fault sequence. Build directly from events
    or via :meth:`generate` for a seeded random campaign."""

    events: Sequence[FaultEvent] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(sorted(self.events)))

    @classmethod
    def generate(
        cls,
        seed: int,
        n_providers: int,
        n_events: int = 12,
        max_dead: int = 1,
        min_gap: int = 5,
        max_gap: int = 40,
        delay_seconds: float = 0.002,
        recover_all: bool = True,
        target: str = DATA,
    ) -> "FaultSchedule":
        """Seeded random campaign: kills, recoveries, drops and delays, with
        at most ``max_dead`` providers down simultaneously (the chaos tests
        pair this with replication > max_dead so published data must
        survive). With ``recover_all`` every still-dead provider gets a
        trailing recover event, so repair can restore full replication.
        ``target`` aims the whole campaign at one plane; merge two campaigns
        with ``FaultSchedule(a.events + b.events)`` for mixed chaos."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        dead: Set[int] = set()
        op = 0
        for _ in range(n_events):
            op += rng.randint(min_gap, max_gap)
            roll = rng.random()
            alive = [p for p in range(n_providers) if p not in dead]
            if target == NODE:
                # node plane: kill / partition / wedge / rejoin — no
                # one-shot drops/delays (those belong to the RPC planes)
                if dead and roll < 0.4:
                    pid = rng.choice(sorted(dead))
                    dead.discard(pid)
                    events.append(FaultEvent(op, RECOVER, pid, target=NODE))
                elif len(dead) < max_dead and alive:
                    pid = rng.choice(alive)
                    dead.add(pid)
                    action = (KILL, PARTITION, WEDGE)[rng.randint(0, 2)]
                    events.append(FaultEvent(op, action, pid, target=NODE))
                continue
            if dead and roll < 0.25:
                pid = rng.choice(sorted(dead))
                dead.discard(pid)
                events.append(FaultEvent(op, RECOVER, pid, target=target))
            elif len(dead) < max_dead and roll < 0.55 and alive:
                pid = rng.choice(alive)
                dead.add(pid)
                events.append(FaultEvent(op, KILL, pid, target=target))
            elif roll < 0.8 and alive:
                events.append(
                    FaultEvent(op, DROP, rng.choice(alive), target=target)
                )
            elif alive:
                events.append(
                    FaultEvent(
                        op, DELAY, rng.choice(alive), delay_seconds, target
                    )
                )
        if recover_all:
            for pid in sorted(dead):
                op += rng.randint(min_gap, max_gap)
                events.append(FaultEvent(op, RECOVER, pid, target=target))
        return cls(tuple(events))


class FaultInjector:
    """Drives a :class:`FaultSchedule` against a live cluster.

    Usage::

        injector = FaultInjector(cluster, schedule)
        injector.attach()
        try:
            ...  # run traffic; faults fire as RPCs cross the op thresholds
            injector.drain()  # force any not-yet-reached kills/recovers
        finally:
            injector.detach()
    """

    def __init__(self, cluster: "Cluster", schedule: FaultSchedule) -> None:
        self.cluster = cluster
        self.schedule = schedule
        self._lock = make_lock("FaultInjector._lock")
        self._op = 0
        self._pending: List[FaultEvent] = list(schedule.events)
        #: per-(target, id) one-shot faults armed by DROP/DELAY events
        self._drops: Dict[Tuple[str, int], int] = {}
        self._delays: Dict[Tuple[str, int], float] = {}
        #: applied events, for test introspection
        self.fired: List[FaultEvent] = []

    # -- wiring ---------------------------------------------------------------
    def attach(self) -> None:
        for provider in self.cluster.provider_manager.providers():
            provider.fault_gate = self._gate
        for shard in self.cluster.metadata.shards:
            shard.fault_gate = self._meta_gate

    def detach(self) -> None:
        for provider in self.cluster.provider_manager.providers():
            provider.fault_gate = None
        for shard in self.cluster.metadata.shards:
            shard.fault_gate = None

    # -- the gates ------------------------------------------------------------
    def _gate(self, op: str, provider_id: int) -> None:
        """Data-plane RPC-entry hook (runs lock-free in the provider, before
        its own lock)."""
        self._gate_common(op, provider_id, DATA)

    def _meta_gate(self, op: str, shard_id: int) -> None:
        """Metadata-plane RPC-entry hook: same op clock as the data gate, so
        one schedule interleaves faults across both planes."""
        self._gate_common(op, shard_id, METADATA)

    def _gate_common(self, op: str, actor_id: int, target: str) -> None:
        """Advance the shared op clock, apply due events, then enforce any
        one-shot drop/delay armed for this (plane, actor)."""
        due: List[FaultEvent] = []
        key = (target, actor_id)
        with self._lock:
            self._op += 1
            while self._pending and self._pending[0].at_op <= self._op:
                due.append(self._pending.pop(0))
        for event in due:
            self._apply(event)
        # consume one-shots AFTER applying due events, so a drop/delay whose
        # op threshold this very RPC crossed hits this RPC, not the next one
        with self._lock:
            delay = self._delays.pop(key, 0.0)
            dropped = self._drops.get(key, 0)
            if dropped:
                self._drops[key] = dropped - 1
        if delay > 0.0:
            time.sleep(delay)  # outside every lock: stalls only this RPC
        if dropped:
            raise ProviderFailed(
                f"injected drop: {target} actor {actor_id} {op} RPC"
            )

    def _apply(self, event: FaultEvent) -> None:
        try:
            if event.action == KILL:
                self._kill(event)
            elif event.action == RECOVER:
                self._recover(event)
            elif event.action in (PARTITION, WEDGE):
                self._node_fault(event)
            elif event.action == DROP:
                with self._lock:
                    key = (event.target, event.provider_id)
                    self._drops[key] = self._drops.get(key, 0) + 1
            elif event.action == DELAY:
                with self._lock:
                    self._delays[(event.target, event.provider_id)] = (
                        event.param
                    )
            else:
                raise ValueError(f"unknown fault action {event.action!r}")
        except KeyError:
            pass  # provider deregistered mid-campaign: fault is moot
        with self._lock:
            self.fired.append(event)

    def _kill(self, event: FaultEvent) -> None:
        if event.target == NODE:
            self._node_fault(event)
        elif event.target == METADATA:
            self.cluster.metadata.fail_shard(event.provider_id)
        else:
            self.cluster.provider_manager.fail_provider(event.provider_id)

    def _recover(self, event: FaultEvent) -> None:
        if event.target == NODE:
            self._node_fault(event)
        elif event.target == METADATA:
            self.cluster.metadata.recover_shard(event.provider_id)
        else:
            self.cluster.provider_manager.recover_provider(event.provider_id)

    def _node_fault(self, event: FaultEvent) -> None:
        """Node-plane dispatch: the injector's ``cluster`` must be a
        :class:`~repro.core.federation.Federation` (it quacks like a cluster
        for the RPC planes — ``provider_manager`` + ``metadata`` — and adds
        ``apply_node_fault`` for this one)."""
        apply = getattr(self.cluster, "apply_node_fault", None)
        if apply is None:
            raise ValueError(
                "node-plane fault events require a Federation, "
                f"got {type(self.cluster).__name__}"
            )
        apply(event.provider_id, event.action)

    # -- campaign control -----------------------------------------------------
    def drain(self) -> None:
        """Apply every not-yet-fired kill/recover immediately (traffic ended
        before the op clock reached them). One-shot drops/delays are
        discarded — there is no RPC left for them to hit."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._drops.clear()
            self._delays.clear()
        for event in pending:
            if event.action in (KILL, RECOVER, PARTITION, WEDGE):
                self._apply(event)

    def ops_seen(self) -> int:
        with self._lock:
            return self._op

    def pending_events(self) -> List[FaultEvent]:
        with self._lock:
            return list(self._pending)
