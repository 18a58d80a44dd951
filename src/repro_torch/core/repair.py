# Copy of src/repro/core/repair.py (the JAX package's storage core); only the package name in imports differs.
"""Background re-replication and metadata scrub: the self-healing half of
the data plane.

The health machine in :class:`~repro.core.provider.ProviderManager` turns
observed RPC failures into a ``live → suspect → dead`` verdict; this module
is what happens *after* the verdict. When a provider is declared dead its
published pages are down one replica — readers still complete through the
surviving copies (the read plane's per-page fallback), but the cluster is
running degraded until someone restores the replication factor. The
:class:`RepairService` is that someone:

* **Re-replication** (:meth:`RepairService.run_once`): for every published
  leaf with a replica on a dead (or failure-flagged) provider, copy the page
  from a surviving replica onto healthy providers until ``replication``
  copies exist again, then re-put the leaf with the corrected ref set — the
  same sanctioned placement-only leaf rewrite the replica balancer performs,
  serialized on the same lock.
* **Metadata re-replication** (part of :meth:`RepairService.run_once`): the
  same treatment for the metadata plane. When a metadata shard dies
  (``MetadataDHT.on_dead`` is wired to :meth:`schedule`, exactly like the
  provider hook) its node copies are down one replica; once the shard — or
  a blank stand-in — rejoins, the pass rebuilds its journal-covered node
  set from the surviving consecutive-home replicas via
  :meth:`~repro.core.dht.MetadataDHT.restore_replication`. Create-only
  nodes make any survivor an authoritative source.
* **Metadata scrub** (:meth:`RepairService.scrub`): writer recovery. A
  writer that died mid-``writev`` was withdrawn by
  :meth:`~repro.core.version_manager.VersionManager.abandon`; if it had
  become a publication *hole*, later published versions may carry border
  links into trees the hole never (fully) stored. Readers survive those
  dangling links through the version manager's redirect
  (:meth:`~repro.core.version_manager.VersionManager.redirect_read_link`),
  but the wreckage — partial nodes, orphan pages, phantom placement load —
  stays behind. The scrub rewrites every inner link that points into an
  aborted version to its redirect target and deletes the hole's stored
  nodes and pages, returning their placement credit. Abandons are
  journaled, so a recovered version manager replays the same holes and the
  scrub remains valid after recovery.

Both passes run under ONE level-2 lock: on clusters with a replica balancer
the service *aliases* ``ReplicaBalancer._rebalance_lock`` (repair, promotion
and GC exclusion serialize together — GC pausing the balancer pauses repair
for free); without a balancer it constructs its own declared
``RepairService._lock`` at the same level and :meth:`Cluster.gc` pauses
repair through :meth:`RepairService.paused`.

Scheduling: ``ProviderManager.on_dead`` (fired outside the manager lock) is
wired to :meth:`RepairService.schedule`, which queues one pass on the
cluster's aux pool — repair never steals a data-plane worker, and a flurry
of death verdicts coalesces into one pass.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.lockwatch import make_lock
from repro_torch.core.dht import ProviderFailed, page_checksum
from repro_torch.core.segment_tree import NodeKey, PageRef, TreeNode

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (cluster imports us)
    from repro_torch.core.cluster import Cluster


class RepairService:
    """Restores the replication factor and scrubs abandoned-write wreckage.

    Construct once per cluster (done by ``Cluster.__init__``); thread-safe.
    ``run_once``/``scrub`` may be called directly (tests, admin tooling) or
    arrive via :meth:`schedule` on the aux pool.
    """

    def __init__(self, cluster: "Cluster") -> None:
        self.cluster = cluster
        balancer = cluster.replica_balancer
        #: level-2 pass lock; aliases the balancer's rebalance lock when the
        #: balancer exists so repair/promotion/GC-exclusion serialize on one
        #: lock (see lock_order.py — the two NAMES must never nest)
        if balancer is not None:
            self._lock = balancer._rebalance_lock
        else:
            self._lock = make_lock("RepairService._lock")
        #: best-effort dedup for schedule(): a benign race (two schedulers
        #: both passing the check) just queues one redundant no-op pass
        self._queued = False
        #: last background-pass failure, kept observable (aux-pool futures
        #: are fire-and-forget)
        self.last_error: Optional[BaseException] = None
        #: total page copies re-replicated by this service
        self.pages_repaired = 0
        #: total nodes scrubbed (hole nodes deleted + inner links rewritten)
        self.nodes_scrubbed = 0
        #: total metadata node copies re-replicated onto recovered shards
        self.nodes_rereplicated = 0

    # -- scheduling ----------------------------------------------------------
    def schedule(self, provider_id: Optional[int] = None) -> None:
        """Queue one repair pass on the cluster's aux pool (the
        ``ProviderManager.on_dead`` hook). Death verdicts arriving while a
        pass is queued coalesce — the pass snapshots the dead set when it
        runs, so it covers them all. Never raises: a closed cluster simply
        drops the pass."""
        if self._queued:
            return
        self._queued = True
        try:
            self.cluster._aux_submit(self._run_background)
        except RuntimeError:  # cluster closed: nothing left to repair
            self._queued = False

    def _run_background(self) -> None:
        self._queued = False  # re-arm BEFORE running: a death verdict that
        # lands mid-pass must queue a fresh pass for the state it changed
        try:
            self.run_once()
        except BaseException as err:  # noqa: BLE001 - keep the aux pool alive
            self.last_error = err

    # -- GC interlock --------------------------------------------------------
    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Block repair/scrub passes for the duration. ``Cluster.gc`` uses
        this on balancer-less clusters; with a balancer, pausing the
        balancer pauses repair too (same underlying lock)."""
        with self._lock:
            yield

    # -- re-replication ------------------------------------------------------
    def run_once(self, scrub: bool = True) -> Tuple[int, int]:
        """One full repair pass over every blob: re-replicate published
        leaves that lost copies to dead/failed providers, (by default)
        scrub abandoned-write wreckage, then restore metadata replication
        for journal-covered nodes (tracked in :attr:`nodes_rereplicated`).
        Returns ``(pages_repaired, nodes_scrubbed)`` for this pass.

        Pages whose every replica is unreachable are *unrepairable* and
        skipped — with ``replication`` copies that takes ``replication``
        simultaneous deaths, the same bound any replicated store carries.
        Stale pages left on a provider that later recovers are orphans until
        :meth:`Cluster.gc` collects them (their leaves no longer reference
        that provider)."""
        with self._lock:
            repaired = 0
            scrubbed = 0
            rereplicated = 0
            vm = self.cluster.version_manager
            for blob_id in vm.blob_ids():
                repaired += self._repair_blob_locked(blob_id)
                if scrub:
                    scrubbed += self._scrub_blob_locked(blob_id)
                rereplicated += self._restore_metadata_locked(blob_id)
            self.pages_repaired += repaired
            self.nodes_scrubbed += scrubbed
            self.nodes_rereplicated += rereplicated
            return repaired, scrubbed

    def _unavailable_pids(self) -> Set[int]:
        pm = self.cluster.provider_manager
        down = set(pm.dead_providers())
        for provider in pm.providers():
            if provider.failed:
                down.add(provider.provider_id)
        return down

    def _repair_blob_locked(self, blob_id: int) -> int:
        pm = self.cluster.provider_manager
        vm = self.cluster.version_manager
        metadata = self.cluster.metadata
        down = self._unavailable_pids()
        if not down:
            return 0
        published, aborted = vm.repair_horizon(blob_id)
        corrected: List[TreeNode] = []
        released: List[PageRef] = []
        repaired = 0
        for key, node in metadata.iter_nodes(blob_id):
            if not node.is_leaf:
                continue
            if key.version > published or key.version in aborted:
                continue  # in-flight writers fix their own placements
            refs = node.all_page_refs()
            lost = [r for r in refs if r[0] in down]
            if not lost:
                continue
            survivors = [r for r in refs if r[0] not in down]
            if not survivors:
                continue  # every replica down at once: unrepairable
            page = self._fetch_from_survivors(survivors, node.checksum)
            holders = {r[0] for r in refs}
            fresh: List[PageRef] = []
            if page is not None:
                want = max(pm.replication - len(survivors), 0)
                for _ in range(want):
                    placed = self._place_copy(page, survivors[0][1], holders)
                    if placed is None:
                        break  # out of healthy capacity; drop lost refs anyway
                    holders.add(placed[0])
                    fresh.append(placed)
                repaired += len(fresh)
            # rewrite the leaf without the lost refs even when no fresh copy
            # could be placed — readers must stop dialing dead providers
            new_refs = survivors + fresh
            corrected.append(
                dataclasses.replace(
                    node, page=new_refs[0], replicas=tuple(new_refs[1:])
                )
            )
            released.extend(lost)
        if corrected:
            metadata.put_nodes(corrected)
            pm.release(released)
        if repaired:
            self.cluster.stats.record_repair(repaired)
        return repaired

    def _fetch_from_survivors(
        self, survivors: List[PageRef], checksum: Optional[int] = None
    ):
        """First *verified* copy among the survivors: a fetch whose bytes do
        not match the leaf's freeze-time checksum is silent corruption, not a
        repair source — it is skipped (and counted) like a failed provider."""
        pm = self.cluster.provider_manager
        for pid, page_key in survivors:
            try:
                page = pm.get_provider(pid).get_page(page_key)
            except ProviderFailed:
                pm.note_failure(pid)
                continue
            except KeyError:
                continue
            if checksum is not None and page_checksum(page) != checksum:
                self.cluster.stats.record_checksum_failure()
                pm.note_failure(pid)
                continue
            pm.note_success(pid)
            return page
        return None

    def _place_copy(
        self, page, page_key: int, holders: Set[int]
    ) -> Optional[PageRef]:
        """Copy ``page`` (stored under ``page_key``) onto the least-loaded
        healthy provider not already holding it; returns the new ref or
        ``None`` when no target qualifies."""
        pm = self.cluster.provider_manager
        tried: Set[int] = set()
        while True:
            target = pm.least_loaded(exclude=tuple(holders | tried))
            if target is None:
                return None
            try:
                pm.get_provider(target).put_pages([(page_key, page)])
            except ProviderFailed:
                pm.note_failure(target)
                tried.add(target)
                continue
            except KeyError:
                tried.add(target)
                continue
            pm.note_success(target)
            pm.add_load(target, 1)
            return (target, page_key)

    # -- metadata re-replication ---------------------------------------------
    def _restore_metadata_locked(self, blob_id: int) -> int:
        """Rebuild a dead/recovered metadata replica's node set from the
        surviving replicas: every journal-covered node (at or below the
        publish frontier, not an abandoned hole) is re-put to any of its
        ``metadata_replication`` consecutive home shards that lost it. The
        node store is create-only, so re-putting from ANY survivor is sound
        — there is nothing newer a dead replica could have held for these
        keys. Runs under the same level-2 pass lock as page repair and the
        scrub, so a scrub deleting hole nodes never races a pass restoring
        them."""
        metadata = self.cluster.metadata
        if metadata.replication <= 1:
            return 0
        published, aborted = self.cluster.version_manager.repair_horizon(
            blob_id
        )
        covered: List[TreeNode] = []
        for key, node in metadata.iter_nodes(blob_id):
            if key.version > published or key.version in aborted:
                continue  # outside the journal-covered horizon
            covered.append(node)
        if not covered:
            return 0
        return metadata.restore_replication(covered)

    # -- writer recovery (dead node) -----------------------------------------
    def recover_writers(self, sessions) -> int:
        """Scrub after a *node* death (federated mode): every session of the
        dead node may hold assigned-but-unreported versions that would wedge
        in-order publication forever. Abandon them (erase or hole, per
        :meth:`VersionManager.abandon`), then scrub the holes' wreckage so
        the storage space comes back. Idempotent — versions the writer
        already aborted itself are skipped by ``abandon``. Returns the
        number of versions abandoned."""
        vm = self.cluster.version_manager
        doomed: Dict[int, Set[int]] = {}
        for sess in sessions:
            for blob_id, versions in sess.inflight_versions().items():
                doomed.setdefault(blob_id, set()).update(versions)
        abandoned = 0
        for blob_id, versions in doomed.items():
            vm.abandon(blob_id, sorted(versions))
            abandoned += len(versions)
            self.scrub(blob_id)
        return abandoned

    # -- metadata scrub (writer recovery) ------------------------------------
    def scrub(self, blob_id: int) -> int:
        """Scrub one blob's abandoned-write wreckage; see module docstring.
        Returns nodes scrubbed (holes deleted + inner links rewritten)."""
        with self._lock:
            n = self._scrub_blob_locked(blob_id)
            self.nodes_scrubbed += n
            return n

    def _scrub_blob_locked(self, blob_id: int) -> int:
        vm = self.cluster.version_manager
        pm = self.cluster.provider_manager
        metadata = self.cluster.metadata
        aborted = vm.aborted_view(blob_id)
        if not aborted:
            return 0
        doomed: List[NodeKey] = []
        doomed_pages: Set[PageRef] = set()
        rewritten: List[TreeNode] = []
        for key, node in metadata.iter_nodes(blob_id):
            if key.version in aborted:
                # wreckage the abort left behind (partial puts of a hole)
                doomed.append(key)
                if node.is_leaf:
                    doomed_pages.update(node.all_page_refs())
                continue
            if node.is_leaf:
                continue
            left, right = node.left_version, node.right_version
            if left not in aborted and right not in aborted:
                continue
            half = key.size // 2
            if left in aborted:
                left = vm.redirect_read_link(blob_id, left, key.offset, half)
            if right in aborted:
                right = vm.redirect_read_link(
                    blob_id, right, key.offset + half, half
                )
            rewritten.append(
                dataclasses.replace(node, left_version=left, right_version=right)
            )
        if rewritten:
            # unlink FIRST: once no stored link reaches the holes, deleting
            # their nodes cannot strand a concurrent traversal (which also
            # redirects on its own via the aborted view)
            metadata.put_nodes(rewritten)
        if doomed:
            metadata.delete_nodes(doomed)
            by_provider: Dict[int, List[int]] = {}
            for pid, page_key in doomed_pages:
                by_provider.setdefault(pid, []).append(page_key)
            for pid, page_keys in by_provider.items():
                try:  # best-effort: a down provider keeps orphans until GC
                    pm.get_provider(pid).delete_pages(page_keys)
                except (ProviderFailed, KeyError):
                    pass
            pm.release(sorted(doomed_pages))
        return len(doomed) + len(rewritten)
