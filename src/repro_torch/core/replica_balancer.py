# Copy of src/repro/core/replica_balancer.py (the JAX package's storage core); only the package name in imports differs.
"""Adaptive hot-page replication (BlobSeer-style dynamic replication).

The paper's placement spreads *writes* evenly, but a skewed read workload
(every client hammering the same few pages — the supernovae detector's hot sky
windows) still funnels all fetches to whichever providers happen to hold the
hot pages: aggregate read bandwidth collapses to a handful of providers'
service capacity. BlobSeer's answer, reproduced here, is to watch the
per-provider read-traffic skew and *promote* hot pages onto extra providers,
so the replica-spreading read path (``Session._fetch_pages``) can fan
hot traffic out across the cluster; promotions are demoted (the extra copies
dropped) when GC collects the version or when callers demote explicitly.

Safety: data pages are immutable, so copying one to another provider and
re-putting its leaf node with a *grown* replica tuple never changes what a
reader observes — at worst a reader holds the older node and simply doesn't
know about the new replica yet. Node rewrites are serialized on the
balancer's rebalance lock, preserving the DHT's "no concurrent writes to one
key" discipline.

Locking: the read path only ever touches ``_heat_lock``, whose critical
sections are a few dict operations — never a network copy. Promotion passes
serialize on a separate non-blocking ``_rebalance_lock`` and perform their
page copies with no lock held, so readers are never queued behind a
promotion (that would re-serialize the very path this module parallelizes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch.analysis.lockwatch import make_lock
from repro_torch.core.dht import MetadataDHT, ProviderFailed, TrafficStats
from repro_torch.core.provider import ProviderManager
from repro_torch.core.segment_tree import NodeKey, PageRef, TreeNode


@dataclasses.dataclass(frozen=True)
class BalancerConfig:
    """Knobs for hot-page promotion.

    ``hot_threshold``: provider fetches of a page (since its counter last
    decayed) before it is promotion-eligible. ``skew_ratio``: promote only
    while the busiest provider's read bytes exceed this multiple of the mean.
    ``check_interval``: how many noted page-fetches between rebalance passes.
    ``max_extra_replicas``: cap of *promoted* copies per page, on top of the
    write-time replication. ``max_promotions_per_pass`` bounds the work one
    unlucky reader thread can absorb.
    """

    hot_threshold: int = 4
    skew_ratio: float = 1.5
    check_interval: int = 64
    max_extra_replicas: int = 3
    max_promotions_per_pass: int = 8


class ReplicaBalancer:
    """Watches read skew and replicates hot pages onto cold providers."""

    def __init__(
        self,
        provider_manager: ProviderManager,
        metadata: MetadataDHT,
        stats: TrafficStats,
        config: Optional[BalancerConfig] = None,
    ) -> None:
        self.providers = provider_manager
        self.metadata = metadata
        self.stats = stats
        self.config = config or BalancerConfig()
        #: guards _heat/_promoted/_since_check; held only for dict ops
        self._heat_lock = make_lock("ReplicaBalancer._heat_lock")
        #: serializes promotion/demotion passes (and their node rewrites);
        #: the read path never blocks on it
        self._rebalance_lock = make_lock("ReplicaBalancer._rebalance_lock")
        #: per-leaf fetch counters + the freshest node observed for that key
        self._heat: Dict[NodeKey, Tuple[int, TreeNode]] = {}
        #: promoted (extra) replicas per leaf — the only ones demote may drop
        self._promoted: Dict[NodeKey, List[PageRef]] = {}
        self._since_check = 0
        self.promotions = 0
        self.demotions = 0
        self._rng = random.Random(0x5EED)

    # -- read-path hooks ---------------------------------------------------
    def note_fetches(self, leaves: Iterable[TreeNode]) -> None:
        """Record that these leaves' pages were fetched from providers (cache
        hits never reach here — RAM hits need no rebalancing). Cheap: one lock
        pass of counter bumps; every ``check_interval`` noted fetches the
        caller runs one rebalance pass inline (skipped without blocking if a
        pass is already running on another thread)."""
        run_pass = False
        with self._heat_lock:
            for leaf in leaves:
                count, known = self._heat.get(leaf.key, (0, leaf))
                # our own promote/demote rewrites are the only mutations a
                # leaf ever sees, so the node already recorded here is always
                # at least as fresh as a reader's copy — never replace it
                # (a reader's pre-demotion node would resurrect dropped refs)
                self._heat[leaf.key] = (count + 1, known)
                self._since_check += 1
            if self._since_check >= self.config.check_interval:
                self._since_check = 0
                run_pass = True
        if run_pass:
            self.rebalance()

    # -- promotion / demotion ----------------------------------------------
    def rebalance(self) -> int:
        """One promotion pass; returns how many pages were promoted.

        Only one thread rebalances at a time (non-blocking for the rest), and
        the page copies run with no lock held, so read latency never stacks
        behind a queue of passes.
        """
        if not self._rebalance_lock.acquire(blocking=False):
            return 0
        try:
            read_bytes = self.stats.read_bytes_snapshot()
            live = {p.provider_id for p in self.providers.providers()}
            if not read_bytes or len(live) < 2:
                return 0
            mean = sum(read_bytes.values()) / max(len(live), 1)
            if mean <= 0:
                return 0
            hot_providers = {
                pid for pid, b in read_bytes.items()
                if b > self.config.skew_ratio * mean
            }
            with self._heat_lock:
                # hottest pages first, only those served from a skewed
                # provider and not already replicated to the cap
                candidates = sorted(
                    (
                        (count, key, node)
                        for key, (count, node) in self._heat.items()
                        if count >= self.config.hot_threshold
                        and len(self._promoted.get(key, []))
                        < self.config.max_extra_replicas
                    ),
                    key=lambda t: -t[0],
                )
            promoted = 0
            for count, key, node in candidates:
                if promoted >= self.config.max_promotions_per_pass:
                    break
                if hot_providers and not (
                    {pid for pid, _ in node.all_page_refs()} & hot_providers
                ):
                    continue
                new_ref, new_node = self._promote(node)
                if new_node is not None:
                    assert new_ref is not None
                    with self._heat_lock:
                        self._promoted.setdefault(key, []).append(new_ref)
                        self._heat[key] = (0, new_node)
                    self.promotions += 1
                    promoted += 1
            with self._heat_lock:
                # decay so yesterday's hot pages don't stay eligible forever
                self._heat = {
                    k: (c // 2, n)
                    for k, (c, n) in self._heat.items()
                    if c // 2 > 0 or k in self._promoted
                }
            return promoted
        finally:
            self._rebalance_lock.release()

    def _promote(
        self, node: TreeNode
    ) -> Tuple[Optional[PageRef], Optional[TreeNode]]:
        """Copy ``node``'s page to the least-loaded provider not already
        serving it and re-put the leaf with the grown replica set. Runs under
        ``_rebalance_lock`` only — the copy is pure data-plane traffic."""
        serving = [pid for pid, _ in node.all_page_refs()]
        target_pid = self.providers.least_loaded(exclude=serving)
        if target_pid is None:
            return None, None
        page = None
        for pid, page_key in node.all_page_refs():
            try:
                provider = self.providers.get_provider(pid)
                page = provider.get_page(page_key)
                break
            except (ProviderFailed, KeyError):
                continue
        if page is None:
            return None, None  # every current replica is dark; nothing to copy
        assert node.page is not None
        page_key = node.page[1]  # replicas share the primary's page key
        new_ref: PageRef = (target_pid, page_key)
        try:
            self.providers.get_provider(target_pid).put_pages([(page_key, page)])
        except (ProviderFailed, KeyError):
            return None, None
        self.providers.add_load(target_pid)
        new_node = dataclasses.replace(node, replicas=node.replicas + (new_ref,))
        self.metadata.put_nodes([new_node])
        return new_ref, new_node

    def demote(self, key: NodeKey) -> int:
        """Drop every *promoted* replica of leaf ``key`` (write-time replicas
        stay): delete the copies, return their load credit, re-put the leaf
        with the shrunken replica set. Returns how many copies were dropped."""
        with self._rebalance_lock:
            with self._heat_lock:
                extras = self._promoted.pop(key, [])
                entry = self._heat.get(key)
            if not extras:
                return 0
            node = entry[1] if entry is not None else None
            if node is None:
                try:
                    node = self.metadata.get_node(key)
                except (KeyError, ProviderFailed):
                    node = None
            for pid, page_key in extras:
                try:
                    self.providers.get_provider(pid).delete_pages([page_key])
                except KeyError:
                    pass
            self.providers.release(extras)
            if node is not None:
                kept = tuple(r for r in node.replicas if r not in set(extras))
                new_node = dataclasses.replace(node, replicas=kept)
                self.metadata.put_nodes([new_node])
                with self._heat_lock:
                    if key in self._heat:
                        self._heat[key] = (self._heat[key][0], new_node)
            self.demotions += len(extras)
            return len(extras)

    # -- GC coherence --------------------------------------------------------
    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Block promotion/demotion passes for the duration (GC uses this so
        an in-flight promotion can't re-create a node GC just deleted or copy
        a page GC is about to drop)."""
        with self._rebalance_lock:
            yield

    def forget(self, keys: Iterable[NodeKey]) -> None:
        """GC collected these leaves: drop their heat and promotion records.
        (The promoted page copies themselves are already deleted by GC — they
        appear in the rewritten nodes' ``all_page_refs``.)"""
        with self._heat_lock:
            for key in keys:
                self._heat.pop(key, None)
                self._promoted.pop(key, None)

    # -- introspection -------------------------------------------------------
    def hottest_page_offsets(self, blob_id: int, k: int) -> List[int]:
        """Top-``k`` page offsets of ``blob_id`` by provider-fetch heat,
        aggregated across versions (pages are COW-rewritten under new
        versions but their *offsets* keep their access skew). This is the
        watch-warmer's prior for which pages of a freshly published version
        detectors will pull first; ties break low-offset-first so the order
        is deterministic."""
        with self._heat_lock:
            agg: Dict[int, int] = {}
            for key, (count, _) in self._heat.items():
                if key.blob_id == blob_id:
                    agg[key.offset] = agg.get(key.offset, 0) + count
        return sorted(agg, key=lambda o: (-agg[o], o))[:k]

    def promoted_refs(self, key: NodeKey) -> Tuple[PageRef, ...]:
        with self._heat_lock:
            return tuple(self._promoted.get(key, ()))

    def n_tracked(self) -> int:
        with self._heat_lock:
            return len(self._heat)
