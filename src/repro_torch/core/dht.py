# Copy of src/repro/core/dht.py; only the package name in imports and the wording of a few comments differ.
"""Metadata-provider DHT abstraction (paper §III.A, "metadata provider").

The paper stores segment-tree nodes in BambooDHT across *metadata providers*.
Here the DHT is a set of in-process shards keyed by a stable hash of the node
key. Nodes are immutable and **create-only** (never mutated, never overwritten
with different content), so gets and puts need no locking beyond the
interpreter's atomic dict operations — this mirrors the lock-free property of
the paper's design rather than merely simulating it.

A :class:`TrafficStats` recorder counts RPCs and bytes, with and without the
paper's client-side RPC aggregation (§V.A: "delays RPC calls to a single
machine and streams all of them in a single real RPC call"), so benchmarks can
model network completion time for the Fig. 3 reproductions.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time
from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

from repro_torch.analysis.lockwatch import make_lock
from repro_torch.core.segment_tree import NodeKey, TreeNode

_T = TypeVar("_T")
_R = TypeVar("_R")


class ProviderFailed(RuntimeError):
    """Raised when an injected failure makes a provider unreachable."""


#: provider/shard health states (paper-deferred fault tolerance, data plane
#: first, then the metadata plane). ``live`` nodes take fresh traffic;
#: ``suspect`` ones (recent RPC failures within the decay window) still serve
#: but are candidates for retry avoidance; ``dead`` ones (failure count over
#: threshold) are excluded and trigger re-replication repair.
LIVE = "live"
SUSPECT = "suspect"
DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Failure-detection knobs shared by the data plane's
    :class:`~repro.core.provider.ProviderManager` and the metadata plane's
    :class:`MetadataDHT`.

    A node becomes ``suspect`` after ``suspect_after`` observed RPC
    failures inside the trailing ``window_seconds``, and ``dead`` at
    ``dead_after`` failures. Suspicion decays: once the window slides past
    the recorded failures the node is ``live`` again. Death is sticky —
    only an explicit recover call (the rejoin announcement) or an observed
    success clears it. ``clock`` is injectable so tests drive the decay
    window deterministically.
    """

    suspect_after: int = 1
    dead_after: int = 3
    window_seconds: float = 30.0
    clock: Callable[[], float] = time.monotonic


#: monotonically numbers RetryPolicy instances (see ``RetryPolicy.nonce``)
_POLICY_NONCES = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter, shared by the
    data plane's page RPCs and the metadata plane's shard RPCs.

    ``delay(attempt)`` grows ``base_delay_seconds`` by ``multiplier`` per
    attempt, capped at ``max_delay_seconds``, then adds up to ``jitter``
    fraction of deterministic noise. The noise stream is seeded by
    ``(seed, nonce, attempt)`` where ``nonce`` defaults to a fresh
    per-instance value: one policy instance replays its exact schedule
    (``sleep`` is injectable so tests record it without wall-clock cost),
    but N policies constructed with the same ``seed`` — one per session or
    per node, the common construction — get *distinct* jitter streams.
    Without the nonce, same-seed policies backed off in lockstep and their
    synchronized retry waves re-stampeded whichever provider or shard had
    just recovered. Pass an explicit ``nonce`` to replay a specific stream
    across instances.
    """

    max_attempts: int = 3
    base_delay_seconds: float = 0.005
    multiplier: float = 2.0
    max_delay_seconds: float = 0.1
    jitter: float = 0.5
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep
    nonce: int = dataclasses.field(
        default_factory=lambda: next(_POLICY_NONCES)
    )

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based)."""
        raw = min(
            self.base_delay_seconds * (self.multiplier ** attempt),
            self.max_delay_seconds,
        )
        rng = random.Random(
            (self.seed * 0x9E3779B1)
            ^ (self.nonce * 0x85EBCA6B)
            ^ (attempt * 0xC2B2AE3D)
        )
        return raw * (1.0 + self.jitter * rng.random())

    def backoff(self, attempt: int) -> None:
        self.sleep(self.delay(attempt))

    def max_backoff_seconds(self) -> float:
        """Worst-case total injected sleep for one fully retried RPC — the
        bound chaos tests assert a dead shard can never exceed."""
        return sum(
            self.delay(attempt) for attempt in range(max(self.max_attempts - 1, 0))
        )


#: per-word-count weight vectors for :func:`page_checksum`, cached per page
#: size (all pages of one blob share a size, so this holds a handful of
#: entries). Concurrent first-computes race benignly: both produce the same
#: vector.
_CHECKSUM_WEIGHTS: Dict[int, "np.ndarray"] = {}


def page_checksum(page) -> int:
    """End-to-end integrity checksum of one stored page: a position-weighted
    64-bit word sum (Fletcher-style, vectorized). The verify runs on EVERY
    provider fetch, so this sits on the read hot path — the numpy reduction
    is ~6x faster than ``zlib.crc32`` on a 64 KiB page. Same threat model as
    a CRC: detects random corruption (any single corrupted word is caught
    outright — every weight is odd, hence invertible mod 2**64 — and
    multi-word damage survives with probability ~2**-64), not adversarial
    tampering. Computed once at ``writev`` freeze time (the page is
    immutable from that point on), stored in the leaf's
    :class:`TreeNode`, and verified on every provider fetch — a mismatch is
    treated exactly like a provider failure: replica fallback plus repair
    of the corrupt copy."""
    data = np.frombuffer(memoryview(page).cast("B"), dtype=np.uint8)
    tail = data.size % 8
    if tail:  # pad the rare non-word-aligned page to a whole word count
        data = np.concatenate([data, np.zeros(8 - tail, np.uint8)])
    words = data.view(np.uint64)
    weights = _CHECKSUM_WEIGHTS.get(words.size)
    if weights is None:
        weights = (
            np.arange(words.size, dtype=np.uint64)
            * np.uint64(0x9E3779B97F4A7C15)  # golden-ratio odd multiplier
            | np.uint64(1)
        )
        _CHECKSUM_WEIGHTS[words.size] = weights
    plain = int(np.add.reduce(words))
    weighted = int(np.add.reduce(words * weights))
    return (plain ^ (weighted << 1)) & 0xFFFFFFFFFFFFFFFF


@dataclasses.dataclass
class TrafficStats:
    """Thread-safe accounting of logical RPCs / bytes per destination.

    ``rpcs`` counts logical messages, ``aggregated_rpcs`` counts the real
    wire round-trips after the paper's client-side aggregation (§V.A) —
    broken down into ``data_rounds`` (data providers) and ``metadata_rounds``
    (metadata DHT shards). ``cache_hits``/``cache_misses`` track the client
    page cache, whose hits issue no RPC at all.
    """

    rpcs: int = 0
    aggregated_rpcs: int = 0
    bytes_sent: int = 0
    data_rounds: int = 0
    metadata_rounds: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    #: self-healing data plane: RPC attempts retried after a failure,
    #: per-page fetches served by a non-chosen replica after the chosen
    #: source failed, read ops that completed with at least one provider
    #: down, and pages re-replicated by the repair service
    retries: int = 0
    replica_fallbacks: int = 0
    degraded_reads: int = 0
    repaired_pages: int = 0
    #: metadata-plane self-healing: shard RPC attempts re-issued after
    #: a failure, and stored pages whose checksum did not match on fetch
    #: (each one also triggers the replica-fallback + repair path)
    metadata_retries: int = 0
    checksum_failures: int = 0
    #: federated GC: times a node fenced its cache tiers because its
    #: GC-epoch lease lapsed, and GC passes that had to stall waiting out an
    #: unresponsive node's lease before reclaiming storage
    lease_fences: int = 0
    epoch_stalls: int = 0
    per_dest_bytes: Dict[int, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    #: read-path bytes per DATA provider only (no metadata shards, no writes) —
    #: the skew signal the replica balancer promotes hot pages from
    per_dest_read_bytes: Dict[int, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int)
    )
    #: write-path bytes per DATA provider only — the placement-skew signal
    #: (hot-spotted writes) for the balancer and the write benchmarks
    per_dest_write_bytes: Dict[int, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int)
    )
    _lock: threading.Lock = dataclasses.field(
        default_factory=lambda: make_lock("TrafficStats._lock"), repr=False
    )

    def record(self, dest: int, n_messages: int, n_bytes: int) -> None:
        with self._lock:
            self._record_locked(dest, n_messages, n_bytes)

    def _record_locked(self, dest: int, n_messages: int, n_bytes: int) -> None:
        self.rpcs += n_messages
        self.aggregated_rpcs += 1
        self.bytes_sent += n_bytes
        self.per_dest_bytes[dest] += n_bytes

    def record_data(self, dest: int, n_messages: int, n_bytes: int, read: bool = False) -> None:
        """One aggregated round-trip to a data provider."""
        with self._lock:
            self._record_locked(dest, n_messages, n_bytes)
            self.data_rounds += 1
            if read:
                self.per_dest_read_bytes[dest] += n_bytes
            else:
                self.per_dest_write_bytes[dest] += n_bytes

    def read_bytes_snapshot(self) -> Dict[int, int]:
        """Copy of per-data-provider read bytes (for replica choice/skew)."""
        with self._lock:
            return dict(self.per_dest_read_bytes)

    def write_bytes_snapshot(self) -> Dict[int, int]:
        """Copy of per-data-provider write bytes (for write hot-spot skew)."""
        with self._lock:
            return dict(self.per_dest_write_bytes)

    def record_metadata(self, dest: int, n_messages: int, n_bytes: int) -> None:
        """One aggregated round-trip to a metadata shard."""
        with self._lock:
            self._record_locked(dest, n_messages, n_bytes)
            self.metadata_rounds += 1

    def record_cache(self, hits: int, misses: int) -> None:
        with self._lock:
            self.cache_hits += hits
            self.cache_misses += misses

    def record_retry(self, n: int = 1) -> None:
        """RPC attempts re-issued after a ``ProviderFailed``."""
        with self._lock:
            self.retries += n

    def record_fallback(self, n: int = 1) -> None:
        """Page fetches recovered via a replica after the source failed."""
        with self._lock:
            self.replica_fallbacks += n

    def record_degraded_read(self, n: int = 1) -> None:
        """Read ops completed while at least one provider was down."""
        with self._lock:
            self.degraded_reads += n

    def record_repair(self, n_pages: int) -> None:
        """Pages re-replicated by the repair service."""
        with self._lock:
            self.repaired_pages += n_pages

    def record_metadata_retry(self, n: int = 1) -> None:
        """Metadata shard RPC attempts re-issued after a failure."""
        with self._lock:
            self.metadata_retries += n

    def record_checksum_failure(self, n: int = 1) -> None:
        """Fetched pages whose stored checksum did not match their bytes."""
        with self._lock:
            self.checksum_failures += n

    def record_lease_fence(self, n: int = 1) -> None:
        """A node fenced its cache tiers after its GC-epoch lease lapsed."""
        with self._lock:
            self.lease_fences += n

    def record_epoch_stall(self, n: int = 1) -> None:
        """A federated GC pass waited out an unreachable node's lease."""
        with self._lock:
            self.epoch_stalls += n

    def reset(self) -> None:
        with self._lock:
            self.rpcs = 0
            self.aggregated_rpcs = 0
            self.bytes_sent = 0
            self.data_rounds = 0
            self.metadata_rounds = 0
            self.cache_hits = 0
            self.cache_misses = 0
            self.retries = 0
            self.replica_fallbacks = 0
            self.degraded_reads = 0
            self.repaired_pages = 0
            self.metadata_retries = 0
            self.checksum_failures = 0
            self.lease_fences = 0
            self.epoch_stalls = 0
            self.per_dest_bytes.clear()
            self.per_dest_read_bytes.clear()
            self.per_dest_write_bytes.clear()


#: Serialized size of one tree node on the wire; matches the order of
#: magnitude of the paper's implementation (key + two child versions + page
#: ref + framing).
NODE_WIRE_BYTES = 64


class MetadataShard:
    """One metadata provider: an in-memory, create-only node store."""

    def __init__(self, shard_id: int) -> None:
        self.shard_id = shard_id
        self._nodes: Dict[NodeKey, TreeNode] = {}
        self.failed = False
        #: chaos-harness hook (:mod:`repro.core.faults`): called at RPC entry
        #: with ``(op, shard_id)``, mirroring ``DataProvider.fault_gate`` —
        #: an injector may sleep (delay), raise ``ProviderFailed`` (drop), or
        #: flip failure flags; shards hold no lock, so the gate runs free
        self.fault_gate: Optional[Callable[[str, int], None]] = None

    def _gate(self, op: str) -> None:
        gate = self.fault_gate
        if gate is not None:
            gate(op, self.shard_id)

    def put_many(self, nodes: Sequence[TreeNode]) -> None:
        self._gate("put_many")
        if self.failed:
            raise ProviderFailed(f"metadata shard {self.shard_id} is down")
        for node in nodes:
            # Create-only: concurrent writers never target the same key
            # because keys embed the (unique) version number. The sanctioned
            # re-puts are leaf rewrites that keep the page DATA identical and
            # change only placement hints: the replica balancer's
            # grown/shrunk replica sets and the repair service's
            # re-replication (both serialize on the rebalance lock), plus a
            # writer correcting its OWN still-unpublished leaves after a
            # mid-flight provider death (no one else targets those keys
            # until the version publishes).
            self._nodes[node.key] = node

    def get(self, key: NodeKey) -> Optional[TreeNode]:
        self._gate("get")
        if self.failed:
            raise ProviderFailed(f"metadata shard {self.shard_id} is down")
        return self._nodes.get(key)

    def get_many(self, keys: Sequence[NodeKey]) -> Dict[NodeKey, TreeNode]:
        """One aggregated RPC: every found node for ``keys`` (missing keys are
        simply absent from the result — the caller decides whether to fall
        back to a replica or error)."""
        self._gate("get_many")
        if self.failed:
            raise ProviderFailed(f"metadata shard {self.shard_id} is down")
        out: Dict[NodeKey, TreeNode] = {}
        for key in keys:
            node = self._nodes.get(key)
            if node is not None:
                out[key] = node
        return out

    def nodes_of_blob(self, blob_id: int) -> Dict[NodeKey, TreeNode]:
        self._gate("nodes_of_blob")
        if self.failed:
            raise ProviderFailed(f"metadata shard {self.shard_id} is down")
        return {k: n for k, n in list(self._nodes.items()) if k.blob_id == blob_id}

    def delete_many(self, keys: Iterable[NodeKey]) -> None:
        for key in keys:
            self._nodes.pop(key, None)

    def __len__(self) -> int:
        return len(self._nodes)


class MetadataDHT:
    """Hash-dispersed node store over ``n_shards`` metadata providers.

    ``replication`` > 1 stores each node on that many consecutive shards
    (BambooDHT-style neighbor replication); reads fall back across replicas,
    which is the paper's (inherited) metadata fault tolerance. Writes commit
    to a quorum of ``ceil(replication / 2)`` replicas per node — nodes are
    create-only and immutable, so a sub-majority quorum is sound: any single
    surviving copy is the truth, reads fall back across all ``replication``
    homes, and :meth:`restore_replication` (driven by the repair service)
    rebuilds lost copies from survivors. Every shard RPC runs under the
    shared bounded :class:`RetryPolicy` and the same ``live → suspect →
    dead`` health machine the data plane uses: observed failures accumulate
    toward a death verdict (``on_dead`` schedules repair), a declared-dead
    shard fails fast instead of burning the retry budget, and an optional
    ``rpc_timeout_seconds`` bounds each attempt so a wedged (delayed) shard
    degrades latency instead of hanging the read plane.

    ``rpc_latency_seconds`` > 0 models the wire round-trip of one *parallel
    round* of aggregated shard RPCs (the metadata half of the paper's network
    model — what the overlapped write plane hides behind the data puts): the
    concurrent per-shard RPCs of a round complete together one RTT after they
    are issued, so a round costs ONE flat sleep, not one per shard. The sleep
    holds no lock and occupies at most one pool worker, so the model adds
    latency without stealing execution resources from the real data plane.
    """

    def __init__(
        self,
        n_shards: int,
        replication: int = 1,
        stats: Optional[TrafficStats] = None,
        executor: Optional[ThreadPoolExecutor] = None,
        rpc_latency_seconds: float = 0.0,
        retry_policy: Optional[RetryPolicy] = None,
        health: Optional[HealthConfig] = None,
        rpc_timeout_seconds: Optional[float] = None,
    ) -> None:
        if replication > n_shards:
            raise ValueError("replication cannot exceed shard count")
        self.shards = [MetadataShard(i) for i in range(n_shards)]
        self.rpc_latency_seconds = rpc_latency_seconds
        self.replication = replication
        #: replicas a node put must land on for the write to succeed; see the
        #: class docstring for why ceil(R/2) (not majority-of-ack R) is sound
        #: for a create-only store
        self.write_quorum = (replication + 1) // 2
        self.stats = stats or TrafficStats()
        self.retry_policy = retry_policy or RetryPolicy()
        self.health_config = health or HealthConfig()
        #: per-attempt RPC bound; ``None`` (default) trusts shards to answer.
        #: When set, each attempt runs on a pool worker and is abandoned
        #: after the timeout (counted as a failure toward the shard's health)
        self.rpc_timeout_seconds = rpc_timeout_seconds
        #: shard health records, same shape as ``ProviderManager``'s: failure
        #: timestamps within the decay window plus the sticky dead set
        self._health_lock = make_lock("MetadataDHT._health_lock")
        self._failures: Dict[int, List[float]] = {}
        self._dead: set = set()
        #: invoked OUTSIDE the health lock when a shard transitions to dead —
        #: the cluster wires this to RepairService scheduling (metadata pass)
        self.on_dead: Optional[Callable[[int], None]] = None
        self._executor = executor
        self._owns_executor = False
        self._executor_lock = make_lock("MetadataDHT._executor_lock")
        # group-commit state for put_nodes_coalesced: writes arriving while
        # coalesce_max_rounds rounds are already in flight pile up here and
        # ride the next round together. The bound matters both ways: with
        # unbounded rounds nothing ever coalesces (that is put_nodes_async),
        # and with ONE serialized round a lone streamer pays +0.5 RTT per
        # write for no benefit — concurrent wire RPCs genuinely overlap
        self._coalesce_lock = make_lock("MetadataDHT._coalesce_lock")
        self._coalesce_pending: List[Tuple[List[TreeNode], Future]] = []
        self._coalesce_active = 0
        self.coalesce_max_rounds = 4
        #: rounds actually flushed by the coalescer (tests assert that N
        #: concurrent small writes cost fewer than N rounds)
        self.coalesced_rounds = 0

    def _round_trip(self) -> None:
        """One modeled RTT for a parallel round of shard RPCs."""
        if self.rpc_latency_seconds > 0.0:
            time.sleep(self.rpc_latency_seconds)

    def _pool(self) -> ThreadPoolExecutor:
        with self._executor_lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=min(len(self.shards), 16)
                )
                self._owns_executor = True
            return self._executor

    def _fan_out(
        self, batches: List[Tuple[int, List[_T]]], fn: Callable[[int, List[_T]], _R]
    ) -> List[_R]:
        """Run ``fn(shard_id, batch)`` for every per-shard batch concurrently —
        one traversal level (or one writev's node set) costs ONE parallel
        round over the shards instead of a serial Python loop (paper §III.B
        "parallel per level"). A single batch skips the pool entirely."""
        if len(batches) <= 1:
            return [fn(sid, batch) for sid, batch in batches]
        futures = [self._pool().submit(fn, sid, batch) for sid, batch in batches]
        return [f.result() for f in futures]

    def close(self) -> None:
        # detach under the lock, shut down OUTSIDE it: shutdown(wait=True)
        # joins pool workers, and a worker calling _pool() while close()
        # blocks on it inside _executor_lock would deadlock
        pool: Optional[ThreadPoolExecutor] = None
        with self._executor_lock:
            if self._owns_executor and self._executor is not None:
                pool = self._executor
                self._executor = None
                self._owns_executor = False
        if pool is not None:
            pool.shutdown(wait=True)

    # -- shard health (live -> suspect -> dead, mirroring ProviderManager) ---
    def note_shard_failure(self, shard_id: int) -> None:
        """Record an observed shard RPC failure; transitions the shard
        ``live -> suspect -> dead`` per :class:`HealthConfig`. ``on_dead``
        fires exactly once per death, outside the health lock (it schedules
        repair work that takes other locks)."""
        now = self.health_config.clock()
        horizon = now - self.health_config.window_seconds
        newly_dead = False
        with self._health_lock:
            record = self._failures.setdefault(shard_id, [])
            record.append(now)
            while record and record[0] < horizon:
                record.pop(0)
            if (
                len(record) >= self.health_config.dead_after
                and shard_id not in self._dead
            ):
                self._dead.add(shard_id)
                newly_dead = True
            callback = self.on_dead
        if newly_dead and callback is not None:
            callback(shard_id)

    def note_shard_success(self, shard_id: int) -> None:
        """An observed successful RPC clears suspicion and death (recovery is
        observed, not configured — same rule as the data plane). The unlocked
        membership probe keeps the healthy fast path free; the race with a
        concurrent ``note_shard_failure`` is a benign interleaving of the two
        observations."""
        if shard_id not in self._failures and shard_id not in self._dead:
            return
        with self._health_lock:
            self._failures.pop(shard_id, None)
            self._dead.discard(shard_id)

    def shard_health(self, shard_id: int) -> str:
        """``live``/``suspect``/``dead`` verdict for one shard."""
        now = self.health_config.clock()
        horizon = now - self.health_config.window_seconds
        with self._health_lock:
            if shard_id in self._dead:
                return DEAD
            record = self._failures.get(shard_id)
            if not record:
                return LIVE
            recent = sum(1 for t in record if t >= horizon)
            return SUSPECT if recent >= self.health_config.suspect_after else LIVE

    def dead_shards(self) -> List[int]:
        """Shard ids currently declared dead (the repair pass's work queue)."""
        with self._health_lock:
            return sorted(self._dead)

    # -- bounded shard RPC (retry + per-attempt timeout) ---------------------
    def _attempt(self, sid: int, fn: Callable[[], _R], timed: bool) -> _R:
        """One shard RPC attempt, bounded by ``rpc_timeout_seconds`` when set
        (and ``timed``): the call runs on a pool worker and is abandoned on
        timeout, which surfaces as a ``ProviderFailed`` — a wedged shard
        costs one timeout per attempt, never a hang. ``timed=False`` callers
        (the async write rounds, which already run ON a pool worker) stay
        inline so a saturated pool cannot deadlock on nested futures."""
        timeout = self.rpc_timeout_seconds
        if timeout is None or not timed:
            return fn()
        fut = self._pool().submit(fn)
        try:
            return fut.result(timeout=timeout)
        except FutureTimeout:
            raise ProviderFailed(
                f"metadata shard {sid} RPC timed out after {timeout}s"
            ) from None

    def _with_retry(self, sid: int, fn: Callable[[], _R], timed: bool = True) -> _R:
        """Run one shard RPC under the bounded :class:`RetryPolicy`. Every
        failed attempt is recorded against the shard's health; retries stop
        early once the shard is declared dead (fail fast — its replicas
        carry the load) and never run under a lock."""
        policy = self.retry_policy
        attempts = max(policy.max_attempts, 1)
        for attempt in range(attempts):
            try:
                out = self._attempt(sid, fn, timed)
            except ProviderFailed:
                self.note_shard_failure(sid)
                if attempt + 1 < attempts and sid not in self.dead_shards():
                    self.stats.record_metadata_retry()
                    policy.backoff(attempt)
                    continue
                raise
            self.note_shard_success(sid)
            return out
        raise AssertionError("unreachable")  # pragma: no cover

    def _check_quorum(self, nodes: Sequence[TreeNode], failed: set) -> None:
        """Raise unless every node landed on at least ``write_quorum`` of its
        replica shards (``failed`` holds the shard ids whose batch store
        failed after retries)."""
        if not failed:
            return
        for node in nodes:
            stored = sum(
                1 for sid in self._replica_ids(node.key) if sid not in failed
            )
            if stored < self.write_quorum:
                raise ProviderFailed(
                    f"metadata write quorum lost for {node.key}: {stored}/"
                    f"{self.replication} replicas stored "
                    f"(need {self.write_quorum})"
                )

    def _home(self, key: NodeKey) -> int:
        return hash((key.blob_id, key.version, key.offset, key.size)) % len(self.shards)

    def _replica_ids(self, key: NodeKey) -> List[int]:
        home = self._home(key)
        return [(home + r) % len(self.shards) for r in range(self.replication)]

    def put_nodes(self, nodes: Sequence[TreeNode]) -> None:
        """Store nodes, aggregating all puts to the same shard into one RPC;
        the per-shard RPCs are issued concurrently (one parallel round), each
        under the retry policy. A shard that stays down after retries costs
        its replicas only: the put succeeds as long as every node reached its
        write quorum, and raises ``ProviderFailed`` otherwise."""
        by_shard: Dict[int, List[TreeNode]] = defaultdict(list)
        for node in nodes:
            for sid in self._replica_ids(node.key):
                by_shard[sid].append(node)

        def _put(sid: int, batch: List[TreeNode]) -> Optional[int]:
            try:
                self._with_retry(sid, lambda: self.shards[sid].put_many(batch))
            except ProviderFailed:
                return sid
            self.stats.record_metadata(sid, len(batch), len(batch) * NODE_WIRE_BYTES)
            return None

        failed = {
            sid
            for sid in self._fan_out(list(by_shard.items()), _put)
            if sid is not None
        }
        self._round_trip()
        self._check_quorum(nodes, failed)

    def put_nodes_async(self, nodes: Sequence[TreeNode]) -> List[Future]:
        """Pipelined :meth:`put_nodes`: returns immediately with the round's
        future(s); the overlapped write plane stores a writev's metadata
        while its data puts are still in flight, joining everything only
        before ``report_success``. The round runs on ONE pool worker that
        performs the per-shard batch stores back-to-back (in-process dict
        inserts, microseconds each — fanning them out would cost more in task
        dispatch, and a worker waiting on nested futures could deadlock a
        saturated pool) and then sleeps one modeled RTT for the whole round,
        mirroring what concurrent per-shard wire RPCs would cost."""
        by_shard: Dict[int, List[TreeNode]] = defaultdict(list)
        for node in nodes:
            for sid in self._replica_ids(node.key):
                by_shard[sid].append(node)
        frozen = list(nodes)

        def _put_round() -> None:
            failed = set()
            for sid, batch in by_shard.items():
                try:
                    # timed=False: this worker must not wait on a nested
                    # pool future (a saturated pool would deadlock)
                    self._with_retry(
                        sid, lambda: self.shards[sid].put_many(batch), timed=False
                    )
                except ProviderFailed:
                    failed.add(sid)
                    continue
                self.stats.record_metadata(sid, len(batch), len(batch) * NODE_WIRE_BYTES)
            self._round_trip()
            self._check_quorum(frozen, failed)

        return [self._pool().submit(_put_round)]

    def put_nodes_coalesced(self, nodes: Sequence[TreeNode]) -> List[Future]:
        """Group-commit metadata store: the cross-writev half of the paper's
        RPC aggregation. Up to ``coalesce_max_rounds`` rounds run
        concurrently (concurrent wire RPCs overlap their RTTs, exactly like
        ``put_nodes_async`` — a lightly loaded streamer keeps its latency);
        node batches from writes that arrive while all round slots are busy
        are merged into ONE per-shard batch round (one aggregated RPC per
        shard, one modeled RTT for all of them) instead of paying a shard
        round per write — the ``write_async`` window routes its writes
        through here, so a burst of small fine-grain writes shares metadata
        rounds the way one big ``writev`` always has. Returns one future
        that resolves when this call's nodes are durable; a shard failure
        fails exactly the calls that stored nodes on that shard, not the
        whole round."""
        fut: Future = Future()
        with self._coalesce_lock:
            self._coalesce_pending.append((list(nodes), fut))
            launch = self._coalesce_active < self.coalesce_max_rounds
            if launch:
                self._coalesce_active += 1
        if launch:
            try:
                self._pool().submit(self._coalesce_flush)
            except BaseException as err:
                # executor gone (shutdown race): return the slot and fail
                # whatever is queued if no live flusher remains to drain it —
                # a stranded future would hang its writer's join forever
                with self._coalesce_lock:
                    self._coalesce_active -= 1
                    stranded = []
                    if self._coalesce_active == 0:
                        stranded, self._coalesce_pending = (
                            self._coalesce_pending, []
                        )
                for _, pending_fut in stranded:
                    pending_fut.set_exception(err)
                raise
        return [fut]

    def _coalesce_flush(self) -> None:
        """Drain the coalesce queue: each loop iteration takes EVERYTHING
        queued so far as one round (per-shard aggregated stores + one RTT),
        then re-checks — writes that arrived while every round slot was busy
        ride the next loop. Runs on a pool worker per active round; the
        per-shard stores are in-process dict inserts (fanning them out would
        cost more in task dispatch than it saves, exactly like
        ``put_nodes_async``)."""
        while True:
            with self._coalesce_lock:
                batch, self._coalesce_pending = self._coalesce_pending, []
                if not batch:
                    self._coalesce_active -= 1
                    return
                self.coalesced_rounds += 1  # under the lock: flushes race
            by_shard: Dict[int, List[TreeNode]] = defaultdict(list)
            for nodes, _ in batch:
                for node in nodes:
                    for sid in self._replica_ids(node.key):
                        by_shard[sid].append(node)
            failed: set = set()
            for sid, shard_nodes in by_shard.items():
                try:
                    # timed=False: flush workers must not wait on nested
                    # pool futures (a saturated pool would deadlock)
                    self._with_retry(
                        sid,
                        lambda: self.shards[sid].put_many(shard_nodes),
                        timed=False,
                    )
                except BaseException:
                    failed.add(sid)
                    continue
                self.stats.record_metadata(
                    sid, len(shard_nodes), len(shard_nodes) * NODE_WIRE_BYTES
                )
            self._round_trip()
            # settle per queued write: a failed shard fails exactly the calls
            # whose nodes dropped below their write quorum, not the round
            for nodes, fut in batch:
                try:
                    self._check_quorum(nodes, failed)
                except ProviderFailed as err:
                    fut.set_exception(err)
                else:
                    fut.set_result(None)

    def get_node(self, key: NodeKey) -> TreeNode:
        last_err: Optional[Exception] = None
        for sid in self._replica_ids(key):
            try:
                node = self._with_retry(sid, lambda: self.shards[sid].get(key))
                self.stats.record_metadata(sid, 1, NODE_WIRE_BYTES)
                self._round_trip()
            except ProviderFailed as err:  # replica fallback
                last_err = err
                continue
            if node is not None:
                return node
        if last_err is not None:
            raise last_err
        raise KeyError(f"metadata node not found: {key}")

    def get_nodes(
        self,
        keys: Sequence[NodeKey],
        on_partial: Optional[Callable[[Dict[NodeKey, TreeNode]], None]] = None,
    ) -> Dict[NodeKey, TreeNode]:
        """Batched node fetch: ONE aggregated RPC per (home) shard for the
        whole key set — the per-shard RPCs of each round run concurrently —
        with per-key replica fallback rounds on shard failure or missing
        replicas. Raises ``KeyError`` if any key is nowhere.

        ``on_partial`` switches the round into *streaming* delivery (the
        read-plane pipeline): each shard batch's found nodes are handed to
        the callback the moment that shard's RPC completes — possibly
        concurrently from pool workers, and crucially *without waiting for
        the round's slower shards* — so the caller can launch data-page
        fetches while the rest of the traversal level is still in flight.
        The modeled RTT of a streaming round elapses BEFORE the per-shard
        results are delivered (a response can only be acted on one round
        trip after the round is issued), so streaming never under-counts
        latency; the complete result dict is still returned at the end."""
        found: Dict[NodeKey, TreeNode] = {}
        pending = list(dict.fromkeys(keys))
        last_err: Optional[ProviderFailed] = None

        def _get(
            sid: int, batch: List[NodeKey]
        ) -> Tuple[List[NodeKey], Optional[Dict[NodeKey, TreeNode]], Optional[ProviderFailed]]:
            try:
                got = self._with_retry(sid, lambda: self.shards[sid].get_many(batch))
                self.stats.record_metadata(sid, len(batch), len(batch) * NODE_WIRE_BYTES)
                if on_partial is not None and got:
                    on_partial(got)
                return batch, got, None
            except ProviderFailed as err:
                return batch, None, err

        for round_idx in range(self.replication):
            if not pending:
                break
            by_shard: Dict[int, List[NodeKey]] = defaultdict(list)
            # inline (home + round) % n rather than _replica_ids(...)[round_idx]:
            # this loop runs per key per traversal level on the read hot path,
            # and the per-key list allocation is measurable there
            home_of, n_shards = self._home, len(self.shards)
            for key in pending:
                by_shard[(home_of(key) + round_idx) % n_shards].append(key)
            if on_partial is not None:
                self._round_trip()  # streaming: deliver at response-arrival time
            still_missing: List[NodeKey] = []
            for batch, got, err in self._fan_out(list(by_shard.items()), _get):
                if err is not None:
                    last_err = err
                    still_missing.extend(batch)
                    continue
                assert got is not None
                found.update(got)
                still_missing.extend(k for k in batch if k not in got)
            if on_partial is None:
                self._round_trip()
            pending = still_missing
        if pending:
            if last_err is not None:  # an outage, not a lost node
                raise last_err
            raise KeyError(f"metadata nodes not found: {pending[:3]}" +
                           (f" (+{len(pending) - 3} more)" if len(pending) > 3 else ""))
        return found

    def iter_nodes(self, blob_id: int):
        """Iterate ``(key, node)`` over every stored node of ``blob_id``,
        deduplicated across replicas (public API for GC — callers must not
        reach into shard internals)."""
        merged: Dict[NodeKey, TreeNode] = {}
        for shard in self.shards:
            try:
                merged.update(
                    self._with_retry(
                        shard.shard_id, lambda s=shard: s.nodes_of_blob(blob_id)
                    )
                )
            except ProviderFailed:
                continue  # replicas on live shards still cover its nodes
        return iter(merged.items())

    def delete_nodes(self, keys: Iterable[NodeKey]) -> None:
        by_shard: Dict[int, List[NodeKey]] = defaultdict(list)
        for key in keys:
            for sid in self._replica_ids(key):
                by_shard[sid].append(key)
        for sid, batch in by_shard.items():
            self.shards[sid].delete_many(batch)

    def restore_replication(self, nodes: Sequence[TreeNode]) -> int:
        """Metadata re-replication (the repair service's metadata pass): for
        every given node, ensure a copy exists on each of its *live* replica
        shards, re-putting the copies a dead-then-recovered (or wiped)
        replica lost. Per live shard this costs one aggregated ``get_many``
        probe plus at most one ``put_many`` of the missing nodes; shards that
        are still down are skipped (the next pass gets them). Returns the
        number of node copies restored."""
        if self.replication <= 1:
            return 0
        wanted: Dict[int, Dict[NodeKey, TreeNode]] = defaultdict(dict)
        for node in nodes:
            for sid in self._replica_ids(node.key):
                wanted[sid][node.key] = node
        restored = 0
        for sid, want in wanted.items():
            keys = list(want)
            try:
                held = self._with_retry(
                    sid, lambda: self.shards[sid].get_many(keys)
                )
            except ProviderFailed:
                continue  # still down: repair again after it rejoins
            missing = [node for key, node in want.items() if key not in held]
            if not missing:
                continue
            try:
                self._with_retry(
                    sid, lambda: self.shards[sid].put_many(missing)
                )
            except ProviderFailed:
                continue
            self.stats.record_metadata(
                sid, len(missing), len(missing) * NODE_WIRE_BYTES
            )
            restored += len(missing)
        return restored

    def total_nodes(self) -> int:
        return sum(len(s) for s in self.shards)

    def fail_shard(self, shard_id: int) -> None:
        self.shards[shard_id].failed = True

    def recover_shard(self, shard_id: int) -> None:
        """Rejoin announcement: clear the failure flag AND the health record,
        so the shard comes back ``live`` immediately (matching
        ``ProviderManager.recover_provider``). Nodes stored while it was down
        are missing until :meth:`restore_replication` re-puts them."""
        self.shards[shard_id].failed = False
        with self._health_lock:
            self._failures.pop(shard_id, None)
            self._dead.discard(shard_id)
