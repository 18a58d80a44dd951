# Copy of src/repro/analysis/schedules.py (the JAX package's interleaving explorer); only the package name in imports differs.
"""Deterministic interleaving explorer for cross-actor coherence scenarios.

The store's coherence argument rests on a small number of cross-thread
interactions: a writer publishing while a reader fills the shared tier, GC
racing a snapshot pin, async-write windows racing ``flush``, the watch
warmer racing demand reads. Production runs sample one arbitrary
interleaving per execution; this module instead *enumerates every bounded
interleaving* of those actors cooperatively and asserts the coherence
invariant after every step of every schedule.

Model: each scenario provides actors as ordered step lists (plain callables
against a freshly built cluster). A *schedule* is one interleaving of the
steps that preserves each actor's order — exactly the schedules a
sequentially consistent machine could produce at API granularity. For every
schedule the scenario world is rebuilt from scratch, the steps run in
schedule order on ONE thread (so there is no hidden nondeterminism), and the
invariant is evaluated after every step:

* the **shared cache tier only ever holds pages of published versions**
  (:func:`shared_tier_violations` — the paper's frontier rule), and
* any scenario-specific checks recorded in ``ctx.errors`` (torn reads,
  lost pins, dropped writes).

This is not a model checker over arbitrary preemption points — steps are
atomic API calls — but every ordering bug reachable at API granularity is
found exhaustively, deterministically, and with a replayable schedule
trace. The interleaving count is the multinomial coefficient of the step
counts, so scenarios stay small by construction; :func:`explore` refuses
(rather than silently truncates) scenarios whose schedule count exceeds
``max_schedules``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import traceback
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Scenario",
    "Failure",
    "Report",
    "explore",
    "interleavings",
    "shared_tier_violations",
    "SCENARIOS",
    "run_all",
]


# -- schedule enumeration ----------------------------------------------------

def n_interleavings(counts: Sequence[int]) -> int:
    total, denom = sum(counts), 1
    for c in counts:
        denom *= math.factorial(c)
    return math.factorial(total) // denom


def interleavings(counts: Sequence[int]) -> Iterator[Tuple[int, ...]]:
    """Every merge of ``counts[i]`` ordered steps per actor ``i`` that
    preserves each actor's internal order, in lexicographic actor order."""
    remaining = list(counts)

    def rec(prefix: List[int]) -> Iterator[Tuple[int, ...]]:
        if not any(remaining):
            yield tuple(prefix)
            return
        for i, left in enumerate(remaining):
            if left:
                remaining[i] -= 1
                prefix.append(i)
                yield from rec(prefix)
                prefix.pop()
                remaining[i] += 1

    return rec([])


# -- scenario protocol -------------------------------------------------------

@dataclasses.dataclass
class Scenario:
    """``build`` creates a fresh world (returns a ctx namespace that MUST
    carry ``cluster`` and an ``errors`` list); ``actors`` returns
    ``[(actor_name, [step, ...]), ...]`` with steps closed over the ctx;
    ``finalize`` (optional) quiesces the world before the last invariant
    evaluation (e.g. a final ``flush``)."""

    name: str
    build: Callable[[], SimpleNamespace]
    actors: Callable[[SimpleNamespace], List[Tuple[str, List[Callable[[], None]]]]]
    finalize: Optional[Callable[[SimpleNamespace], None]] = None


@dataclasses.dataclass(frozen=True)
class Failure:
    scenario: str
    schedule: Tuple[str, ...]  # actor step labels in execution order
    step: int  # index into schedule after which the invariant broke
    errors: Tuple[str, ...]

    def __str__(self) -> str:
        trace = " -> ".join(
            f"[{s}]" if i == self.step else s
            for i, s in enumerate(self.schedule)
        )
        errs = "; ".join(self.errors)
        return f"{self.scenario}: schedule {trace}: {errs}"


@dataclasses.dataclass
class Report:
    scenario: str
    n_schedules: int
    n_steps: int
    failures: List[Failure]

    @property
    def ok(self) -> bool:
        return not self.failures

    def __str__(self) -> str:
        status = "OK" if self.ok else f"{len(self.failures)} FAILING"
        return (
            f"{self.scenario}: {self.n_schedules} schedules x "
            f"{self.n_steps} steps — {status}"
        )


# -- the coherence invariant -------------------------------------------------

def shared_tier_violations(cluster) -> List[str]:
    """The paper's frontier rule: the SHARED cache tier may only ever hold
    pages of published, non-aborted versions (private session caches may
    hold a writer's own unpublished pages; the shared tier never may).
    Returns one message per offending (blob, version)."""
    cache = getattr(cluster, "shared_cache", None)
    if cache is None:
        return []
    vm = cluster.version_manager
    out: List[str] = []
    for blob_id in vm.blob_ids():
        for version in cache.cached_versions(blob_id):
            if version == 0:
                continue  # v0 is the implicit all-zeros base, always readable
            if not vm.is_published(blob_id, version):
                out.append(
                    f"shared tier holds blob {blob_id} v{version} "
                    f"which is not published"
                )
            elif vm.is_aborted(blob_id, version):
                out.append(
                    f"shared tier holds blob {blob_id} v{version} "
                    f"which was aborted"
                )
    return out


def _invariant(ctx: SimpleNamespace) -> List[str]:
    out = shared_tier_violations(ctx.cluster)
    out.extend(ctx.errors)
    ctx.errors = []
    return out


# -- the explorer ------------------------------------------------------------

def explore(scenario: Scenario, max_schedules: int = 512) -> Report:
    """Run ``scenario`` under EVERY interleaving of its actors' steps,
    rebuilding the world per schedule and checking the invariant after every
    step. Raises ``ValueError`` if the schedule space exceeds
    ``max_schedules`` — bound the scenario, don't sample it silently."""
    probe = scenario.build()
    try:
        actor_list = scenario.actors(probe)
    finally:
        probe.cluster.close()
    counts = [len(steps) for _, steps in actor_list]
    total = n_interleavings(counts)
    if total > max_schedules:
        raise ValueError(
            f"{scenario.name}: {total} interleavings exceed the "
            f"max_schedules bound of {max_schedules} — shrink the scenario"
        )

    failures: List[Failure] = []
    n_run = 0
    for order in interleavings(counts):
        n_run += 1
        ctx = scenario.build()
        actors = scenario.actors(ctx)
        cursors = [0] * len(actors)
        labels: List[str] = []
        try:
            broke = False
            for idx, actor_i in enumerate(order):
                name, steps = actors[actor_i]
                step = steps[cursors[actor_i]]
                labels.append(f"{name}.{cursors[actor_i]}")
                cursors[actor_i] += 1
                try:
                    step()
                except Exception:
                    ctx.errors.append(
                        f"step {labels[-1]} raised:\n"
                        + traceback.format_exc(limit=4)
                    )
                errors = _invariant(ctx)
                if errors:
                    failures.append(Failure(
                        scenario.name, tuple(labels), idx, tuple(errors)))
                    broke = True
                    break
            if not broke and scenario.finalize is not None:
                try:
                    scenario.finalize(ctx)
                except Exception:
                    ctx.errors.append(
                        "finalize raised:\n" + traceback.format_exc(limit=4))
                errors = _invariant(ctx)
                if errors:
                    failures.append(Failure(
                        scenario.name, tuple(labels), len(order), tuple(errors)))
        finally:
            ctx.cluster.close()
    return Report(scenario.name, n_run, sum(counts), failures)


# -- world builders ----------------------------------------------------------

_PAGE = 256  # tiny pages keep every schedule's build cheap
_PAGES = 4


def _fill(value: int, n_bytes: int = _PAGE * _PAGES) -> np.ndarray:
    return np.full(n_bytes, value % 251, dtype=np.uint8)


def _base_ctx(shared_cache: bool = True) -> SimpleNamespace:
    from repro_torch.core.cluster import Cluster

    cluster = Cluster(
        n_data_providers=2,
        n_metadata_providers=2,
        max_workers=2,
        shared_cache_bytes=(1 << 20) if shared_cache else 0,
        hot_replicas=False,
    )
    ctx = SimpleNamespace(cluster=cluster, errors=[])
    ctx.blob_id = cluster.alloc(_PAGE * _PAGES, _PAGE)
    return ctx


def _check_uniform(ctx: SimpleNamespace, data: np.ndarray, label: str) -> None:
    values = set(np.unique(data).tolist())
    published = {
        v % 251
        for v in range(
            0, ctx.cluster.version_manager.latest_published(ctx.blob_id) + 1
        )
    }
    if len(values) > 1:
        ctx.errors.append(
            f"{label}: torn read mixes page values {sorted(values)}")
    elif values and not values <= published:
        ctx.errors.append(
            f"{label}: read returned value {sorted(values)} which no "
            f"published version ever wrote")


# -- scenario: publish frontier vs shared-tier fill --------------------------

def _build_publish_vs_fill() -> SimpleNamespace:
    ctx = _base_ctx()
    ctx.writer = ctx.cluster.session()
    ctx.reader = ctx.cluster.session(cache_bytes=0)  # all fills hit shared tier
    ctx.whandle = ctx.writer.open(ctx.blob_id)
    ctx.rhandle = ctx.reader.open(ctx.blob_id)
    ctx.whandle.write(_fill(1), 0)  # v1 published before the race starts
    return ctx


def _actors_publish_vs_fill(ctx) -> List[Tuple[str, List[Callable[[], None]]]]:
    def write(value):
        return lambda: ctx.whandle.write(_fill(value), 0)

    def read():
        def step():
            data = ctx.rhandle.read(0, _PAGE * _PAGES).data
            _check_uniform(ctx, data, "demand read")
        return step

    return [
        ("writer", [write(2), write(3)]),
        ("reader", [read(), read(), read()]),
    ]


# -- scenario: Cluster.gc vs Snapshot pin ------------------------------------

def _build_gc_vs_pin() -> SimpleNamespace:
    ctx = _base_ctx()
    ctx.session = ctx.cluster.session()
    ctx.handle = ctx.session.open(ctx.blob_id)
    ctx.handle.write(_fill(1), 0)  # v1
    ctx.handle.write(_fill(2), 0)  # v2
    ctx.snap = None
    ctx.gc_done = False
    ctx.pinned_before_gc = False
    return ctx


def _actors_gc_vs_pin(ctx) -> List[Tuple[str, List[Callable[[], None]]]]:
    def pin():
        ctx.snap = ctx.handle.at(1)
        # the pin contract protects against FUTURE GC passes only: pinning
        # after a completed pass succeeds but the first read fails
        # ("the pin protects the future, not the past" — BlobHandle.at)
        ctx.pinned_before_gc = not ctx.gc_done

    def read_pinned():
        if ctx.snap is None:
            return
        try:
            data = ctx.snap.read(0, _PAGE * _PAGES)
        except (KeyError, ValueError) as exc:
            if ctx.pinned_before_gc:
                ctx.errors.append(
                    f"v1 was pinned BEFORE the GC pass yet the pinned read "
                    f"failed: {exc!r}")
            return  # pin lost the race to a completed pass: the contract
        if not (data == _fill(1)).all():
            ctx.errors.append("pinned v1 read returned non-v1 data")

    def release():
        if ctx.snap is not None:
            ctx.snap.release()

    def gc():
        ctx.cluster.gc(ctx.blob_id, [2])
        ctx.gc_done = True

    return [
        ("pinner", [pin, read_pinned, release]),
        ("collector", [gc]),
    ]


# -- scenario: Cluster.gc vs a shared-tier cached read -----------------------

def _build_gc_vs_cached_read() -> SimpleNamespace:
    ctx = _base_ctx()
    ctx.session = ctx.cluster.session(cache_bytes=0)
    ctx.handle = ctx.session.open(ctx.blob_id)
    ctx.handle.write(_fill(1), 0)  # v1
    ctx.handle.write(_fill(2), 0)  # v2
    ctx.handle.read(0, _PAGE * _PAGES, version=1)  # shared tier holds v1
    return ctx


def _actors_gc_vs_cached_read(ctx) -> List[Tuple[str, List[Callable[[], None]]]]:
    def read_v1():
        try:
            data = ctx.handle.read(0, _PAGE * _PAGES, version=1).data
        except (KeyError, ValueError):
            return  # v1 already collected: failing the read is the contract
        if not (data == _fill(1)).all():
            ctx.errors.append(
                "read of retained v1 returned non-v1 data (stale or torn "
                "cache fill survived GC)")

    def gc():
        ctx.cluster.gc(ctx.blob_id, [2])

    return [
        ("reader", [read_v1, read_v1]),
        ("collector", [gc]),
    ]


# -- scenario: write_async window vs flush -----------------------------------

def _build_write_async_vs_flush() -> SimpleNamespace:
    ctx = _base_ctx()
    ctx.session = ctx.cluster.session()
    ctx.handle = ctx.session.open(ctx.blob_id)
    ctx.handle.write(_fill(1), 0)  # v1
    return ctx


def _actors_write_async_vs_flush(ctx) -> List[Tuple[str, List[Callable[[], None]]]]:
    def write_async(value):
        return lambda: ctx.handle.write_async(_fill(value), 0)

    def flush():
        ctx.session.flush()

    return [
        ("writer", [write_async(2), write_async(3)]),
        ("flusher", [flush, flush]),
    ]


def _finalize_write_async_vs_flush(ctx) -> None:
    ctx.session.flush()
    latest = ctx.handle.latest_published()
    if latest != 3:
        ctx.errors.append(
            f"after final flush, frontier is v{latest}, expected v3 — an "
            f"async write was dropped or published out of order")
    data = ctx.handle.read(0, _PAGE * _PAGES).data
    if not (data == _fill(3)).all():
        ctx.errors.append("final read does not see the last async write")


# -- scenario: WatchWarmer fill vs demand read -------------------------------

def _build_warmer_vs_demand() -> SimpleNamespace:
    ctx = _base_ctx()
    ctx.session = ctx.cluster.session(cache_bytes=0)
    ctx.handle = ctx.session.open(ctx.blob_id)
    ctx.handle.write(_fill(1), 0)  # v1
    # frame_versions far beyond any version this scenario publishes: the
    # warmer's own thread never fires, so every warm pass below is a
    # deterministic explorer step instead of a background race
    ctx.warmer = ctx.cluster.warm_on_publish(
        ctx.blob_id, frame_versions=1 << 30)
    return ctx


def _actors_warmer_vs_demand(ctx) -> List[Tuple[str, List[Callable[[], None]]]]:
    def publish(value):
        return lambda: ctx.handle.write(_fill(value), 0)

    def warm():
        version = ctx.handle.latest_published()
        ctx.warmer._warm(version)

    def read():
        data = ctx.handle.read(0, _PAGE * _PAGES).data
        _check_uniform(ctx, data, "demand read vs warmer")

    return [
        ("publisher", [publish(2)]),
        ("warmer", [warm, warm]),
        ("detector", [read, read]),
    ]


# -- scenario: metadata shard failover vs concurrent publish ------------------

def _build_shard_failover_vs_publish() -> SimpleNamespace:
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.dht import RetryPolicy

    cluster = Cluster(
        n_data_providers=2,
        n_metadata_providers=2,
        metadata_replication=2,  # every node on BOTH shards: failover always has a home
        max_workers=2,
        shared_cache_bytes=0,  # every read re-traverses the metadata plane
        hot_replicas=False,
        retry_policy=RetryPolicy(max_attempts=1, sleep=lambda s: None),
    )
    ctx = SimpleNamespace(cluster=cluster, errors=[])
    ctx.blob_id = cluster.alloc(_PAGE * _PAGES, _PAGE)
    ctx.session = cluster.session(cache_bytes=0)
    ctx.handle = ctx.session.open(ctx.blob_id)
    ctx.handle.write(_fill(1), 0)  # v1 on both replicas before the race
    return ctx


def _actors_shard_failover_vs_publish(ctx) -> List[Tuple[str, List[Callable[[], None]]]]:
    """A metadata shard dies, rejoins blank of the versions published while
    it was down, and is re-replicated — all racing a writer that keeps
    publishing and a reader that keeps traversing. The reader must NEVER
    observe a torn tree (an inner node resolved on one replica pointing at a
    leaf state the other replica never stored): every read is uniform and a
    value some published version actually wrote."""

    def publish(value):
        return lambda: ctx.handle.write(_fill(value), 0)

    def kill():
        ctx.cluster.metadata.fail_shard(0)

    def rejoin():
        # rejoins LIVE but stale: nodes published during the outage are
        # missing until the repair step — the classic torn-tree window
        ctx.cluster.metadata.recover_shard(0)

    def repair():
        ctx.cluster.repair_service.run_once()

    def read():
        data = ctx.handle.read(0, _PAGE * _PAGES).data
        _check_uniform(ctx, data, "read across shard failover")

    return [
        ("writer", [publish(2), publish(3)]),
        ("failover", [kill, rejoin, repair]),
        ("reader", [read, read]),
    ]


def _finalize_shard_failover_vs_publish(ctx) -> None:
    metadata = ctx.cluster.metadata
    if metadata.dead_shards() or metadata.shards[0].failed:
        metadata.recover_shard(0)
    ctx.cluster.repair_service.run_once()
    data = ctx.handle.read(0, _PAGE * _PAGES).data
    if not (data == _fill(3)).all():
        ctx.errors.append(
            "after failover + repair the frontier read is not v3's data")
    # replication whole again: every journal-covered node on BOTH shards
    vm = ctx.cluster.version_manager
    published, aborted = vm.repair_horizon(ctx.blob_id)
    for key, node in metadata.iter_nodes(ctx.blob_id):
        if key.version > published or key.version in aborted:
            continue
        for sid in metadata._replica_ids(key):
            if metadata.shards[sid].get(key) is None:
                ctx.errors.append(
                    f"replica {sid} missing {key} after failover repair")


def _build_node_death_vs_gc_ack() -> SimpleNamespace:
    from repro_torch.core.dht import HealthConfig, RetryPolicy
    from repro_torch.core.federation import Federation

    class _Clock:
        def __init__(self) -> None:
            self.t = 0.0

        def __call__(self) -> float:
            return self.t

        def advance(self, dt: float) -> None:
            self.t += dt

    clock = _Clock()
    fed = Federation(
        n_nodes=2,
        n_data_providers=2,
        n_metadata_providers=2,
        max_workers=2,
        lease_seconds=5.0,
        clock=clock,
        # sleeps (ack backoff, lease wait-out) advance the fake clock, so a
        # wait-out terminates deterministically inside one atomic step
        retry_policy=RetryPolicy(max_attempts=1, sleep=clock.advance),
        # dead_after=2: ONE failed ack leaves the node suspect (the GC pass
        # waits its lease out); a SECOND failed ack is the death verdict
        health=HealthConfig(
            dead_after=2, window_seconds=1e9, clock=clock
        ),
    )
    ctx = SimpleNamespace(cluster=fed, errors=[])
    ctx.fed = fed
    ctx.clock = clock
    ctx.blob_id = fed.nodes[0].alloc(_PAGE * _PAGES, _PAGE)
    ctx.s0 = fed.nodes[0].session()
    ctx.s1 = fed.nodes[1].session(cache_bytes=0)  # fills hit node 1's shared tier
    ctx.h0 = ctx.s0.open(ctx.blob_id)
    ctx.h1 = ctx.s1.open(ctx.blob_id)
    ctx.h0.write(_fill(1), 0)  # v1 published before the race
    ctx.h1.read(0, _PAGE * _PAGES)  # node 1's shared tier holds v1
    return ctx


def _actors_node_death_vs_gc_ack(ctx) -> List[Tuple[str, List[Callable[[], None]]]]:
    """A federated GC pass needs node 1's ack (purge + rejoin at the new
    epoch) while node 1 is partitioned from the coordinator, declared dead,
    or rejoining — in every order. Whatever the interleaving: node 1's reads
    stay uniform (its data plane works while partitioned), and after any
    read with a lapsed/reclaimed lease the node is FENCED (or already
    rejoined at the current epoch) — never serving cached pages past its
    lease."""
    fed = ctx.fed

    def partition():
        fed.apply_node_fault(1, "partition")

    def recover():
        fed.apply_node_fault(1, "recover")

    def gc():
        latest = fed.version_manager.latest_published(ctx.blob_id)
        fed.gc(ctx.blob_id, keep_versions=[latest])

    def write():
        ctx.h0.write(_fill(2), 0)

    def read():
        data = ctx.h1.read(0, _PAGE * _PAGES).data
        _check_uniform(ctx, data, "node-1 read across GC/death race")
        if not (fed.coordinator.lease_valid(1) or fed.node_fenced(1)):
            ctx.errors.append(
                "node 1 served with neither a valid lease nor its fence up"
            )

    return [
        ("chaos", [partition, recover]),
        ("gc", [gc, gc]),
        ("writer", [write]),
        ("reader", [read]),
    ]


def _finalize_node_death_vs_gc_ack(ctx) -> None:
    fed = ctx.fed
    fed.apply_node_fault(1, "recover")
    # a rejoined node starts from purged tiers: nothing it cached before the
    # outage can have survived the GC passes it missed
    cached = fed.nodes[1].shared_cache.cached_versions(ctx.blob_id)
    if cached:
        ctx.errors.append(
            f"node 1 rejoined with stale cached versions {cached}"
        )
    latest = fed.version_manager.latest_published(ctx.blob_id)
    data = ctx.h1.read(0, _PAGE * _PAGES).data
    if not (data == _fill(latest)).all():
        ctx.errors.append(
            "after rejoin node 1's frontier read is not the latest version"
        )


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in [
        Scenario("publish_vs_shared_fill",
                 _build_publish_vs_fill, _actors_publish_vs_fill),
        Scenario("gc_vs_pin", _build_gc_vs_pin, _actors_gc_vs_pin),
        Scenario("gc_vs_cached_read",
                 _build_gc_vs_cached_read, _actors_gc_vs_cached_read),
        Scenario("write_async_vs_flush",
                 _build_write_async_vs_flush, _actors_write_async_vs_flush,
                 finalize=_finalize_write_async_vs_flush),
        Scenario("warmer_vs_demand_read",
                 _build_warmer_vs_demand, _actors_warmer_vs_demand),
        Scenario("shard_failover_vs_publish",
                 _build_shard_failover_vs_publish,
                 _actors_shard_failover_vs_publish,
                 finalize=_finalize_shard_failover_vs_publish),
        Scenario("node_death_vs_gc_ack",
                 _build_node_death_vs_gc_ack,
                 _actors_node_death_vs_gc_ack,
                 finalize=_finalize_node_death_vs_gc_ack),
    ]
}


def run_all(max_schedules: int = 512) -> List[Report]:
    """Explore every registered scenario; returns one report per scenario."""
    return [explore(s, max_schedules) for s in SCENARIOS.values()]


if __name__ == "__main__":  # pragma: no cover - manual driver
    bad = False
    for report in run_all():
        print(report)
        for failure in report.failures:
            bad = True
            print(f"  {failure}")
    raise SystemExit(1 if bad else 0)
