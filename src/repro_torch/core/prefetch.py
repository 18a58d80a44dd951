# Copy of src/repro/core/prefetch.py (the JAX package's storage core); only the package name in imports differs.
"""Adaptive readahead for the streaming read plane (beyond-paper scaling).

The paper's READ protocol is demand-driven: nothing moves until a client asks.
The workloads that hammer this reproduction — supernovae detectors sweeping
MB-scale windows out of each freshly published sky frame (§IV) — are highly
predictable, though, and BlobSeer-style deployments win by warming a RAM tier
before the detectors ask. Two predictors live here:

* :class:`StridePrefetcher` — a per-:class:`~repro.core.cluster.Session`
  sequential/stride detector over read offsets. Once a stable forward stride
  is observed it issues *bounded* readahead of the next pages into the
  cluster's shared cache tier, through the same frontier-validated fill path
  every read uses. The prefetcher only ever fetches pages of the version the
  session is already reading — a version that was resolved and validated as
  published — so it can never pull unpublished data past the publish
  frontier, and it clamps readahead at the blob end. Readahead is issued on
  the cluster's *auxiliary* pool and never blocks the read path: when the
  in-flight budget is exhausted the observation is simply dropped.

* :class:`WatchWarmer` — a cluster-level warmer that subscribes to a blob's
  publications (:class:`~repro.core.cluster.VersionWatch`) and fills the
  shared tier with the *hottest* pages of each freshly published version
  before detector sessions read it, reusing the
  :class:`~repro.core.replica_balancer.ReplicaBalancer`'s read-heat counters
  as the prior (falling back to the version's own freshly written interval
  while no heat has accumulated yet). The warmer drives a private session's
  read path, so every fill is frontier-validated and single-flighted like
  any other read: it structurally cannot warm an unpublished version, GC
  purges warmed pages like any cached page, and snapshot pins keep pinned
  versions readable exactly as they do for demand reads.

Both predictors are best-effort: a failed fill aborts its single-flight
entries (so concurrent demand readers retry or surface the same provider
error they would have hit themselves) and is otherwise dropped.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, TimeoutError as FutureTimeout
from typing import TYPE_CHECKING, Dict, List, Optional, Set

from repro_torch.analysis.lockwatch import make_condition, make_lock

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (cluster imports us)
    from repro_torch.core.cluster import Cluster, Session


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    """Knobs for :class:`StridePrefetcher`.

    ``min_run``: consecutive same-stride observations before readahead fires
    (one coincidental repeat is not a pattern). ``window_pages``: how many
    pages each readahead issue covers — the depth of the pipeline in pages.
    ``max_inflight``: bound on concurrent readahead fills per session; an
    observation arriving at the bound is dropped, never queued, so a slow
    tier can't build an unbounded fetch backlog.
    """

    min_run: int = 2
    window_pages: int = 32
    max_inflight: int = 2


@dataclasses.dataclass
class _BlobStride:
    """Per-(blob, version) detector state."""

    version: int
    last_first: int  # first page of the previous observed read
    stride: int = 0
    run: int = 0
    #: next page the prefetcher has NOT yet issued readahead for — keeps
    #: overlapping observations from re-fetching the same pages
    frontier: int = 0


class StridePrefetcher:
    """Sequential/stride read detector with bounded shared-tier readahead."""

    def __init__(
        self, session: "Session", config: Optional[PrefetchConfig] = None
    ) -> None:
        self._session = session
        self.config = config or PrefetchConfig()
        self._lock = make_lock("StridePrefetcher._lock")
        self._state: Dict[int, _BlobStride] = {}
        self._inflight: Set[Future] = set()
        #: readahead issues / pages covered / observations dropped at the
        #: in-flight bound — benchmark & test introspection
        self.issued = 0
        self.pages_requested = 0
        self.skipped_inflight = 0

    def observe(
        self,
        blob_id: int,
        version: int,
        first_page: int,
        end_page: int,
        total_pages: int,
        page_size: int,
    ) -> None:
        """Feed one read's page span ``[first_page, end_page)`` of a resolved
        *published* ``version`` to the detector; maybe issue readahead.
        Cheap (a few dict ops under a lock) and non-blocking — called inline
        by the read path before its own fetch, so readahead overlaps the
        very read that triggered it."""
        cfg = self.config
        fut: Optional[Future] = None
        with self._lock:
            st = self._state.get(blob_id)
            if st is None or st.version != version:
                # new blob or new version: start a fresh detector window
                self._state[blob_id] = _BlobStride(
                    version=version, last_first=first_page, frontier=end_page
                )
                return
            stride = first_page - st.last_first
            if stride > 0 and stride == st.stride:
                st.run += 1
            else:
                # broken or backward pattern: re-arm (a backward/random jump
                # resets the readahead frontier to the new position)
                st.run = 1 if stride > 0 else 0
                st.frontier = end_page
            st.stride = stride
            st.last_first = first_page
            st.frontier = max(st.frontier, end_page)
            if st.run < cfg.min_run:
                return
            start = st.frontier
            # bounded pipeline depth: never run more than the in-flight
            # budget's worth of windows ahead of the reader — an unbounded
            # frontier on a long scan would evict prefetched pages before
            # the reader reaches them and double the provider traffic
            horizon = end_page + cfg.window_pages * cfg.max_inflight
            stop = min(start + cfg.window_pages, horizon, total_pages)
            if start >= stop:
                return
            if len(self._inflight) >= cfg.max_inflight:
                self.skipped_inflight += 1
                return
            try:
                fut = self._session.cluster._aux_submit(
                    self._session._prefetch_fill,
                    blob_id,
                    version,
                    list(range(start, stop)),
                    total_pages,
                    page_size,
                )
            except RuntimeError:
                return  # aux pool shut down mid-close: drop, never raise
            st.frontier = stop
            self.issued += 1
            self.pages_requested += stop - start
            self._inflight.add(fut)
        fut.add_done_callback(self._discard)

    def _discard(self, fut: Future) -> None:
        with self._lock:
            self._inflight.discard(fut)

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Join all outstanding readahead tasks (tests/benchmarks only —
        production readers never wait on the prefetcher)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                pending = list(self._inflight)
            if not pending:
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                pending[0].exception(timeout=remaining)
            except FutureTimeout:
                return False


class WatchWarmer:
    """Publish-driven shared-tier warmer for one blob.

    A daemon thread waits on the blob's :class:`VersionWatch`; when versions
    publish it drains to the newest one (warming a superseded version would
    only evict pages detectors are about to replace) and fills the shared
    tier with up to ``top_pages`` pages of it: the balancer's hottest page
    offsets first, then the version's own freshly written interval. With
    ``frame_versions=N`` set, only every N-th version is warmed — the paper's
    application publishes one version per sky *region*, so a frame boundary
    is every ``n_regions`` versions and warming mid-frame versions would be
    wasted traffic.

    Create via :meth:`Cluster.warm_on_publish`, which also stops the warmer
    on cluster close; ``wait_warmed`` lets tests and benchmark harnesses
    rendezvous with a fill deterministically.
    """

    def __init__(
        self,
        cluster: "Cluster",
        blob_id: int,
        top_pages: int = 256,
        frame_versions: Optional[int] = None,
        poll_seconds: float = 0.05,
    ) -> None:
        self.cluster = cluster
        self.blob_id = blob_id
        self.top_pages = top_pages
        self.frame_versions = frame_versions
        self._poll = poll_seconds
        # the warmer's private client: no private cache, so every fill lands
        # in the cluster's SHARED tier through the frontier-validated path
        self._session = cluster.session(cache_bytes=0)
        self._handle = self._session.open(blob_id)
        self._watch = self._handle.watch()
        self._stop = threading.Event()
        self._cv = make_condition("WatchWarmer._cv")
        self._warmed: Dict[int, int] = {}  # version -> pages filled
        self.pages_warmed = 0
        self._thread = threading.Thread(
            target=self._run, name=f"watch-warmer-{blob_id}", daemon=True
        )
        self._thread.start()

    # -- the warming loop ----------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            v = self._watch.next(timeout=self._poll)
            if v is None:
                continue
            newest = max([v] + self._watch.drain())
            if self.frame_versions:
                newest = (newest // self.frame_versions) * self.frame_versions
                if newest == 0 or newest in self._warmed:
                    continue
            try:
                n = self._warm(newest)
            except BaseException:
                n = 0  # best-effort: a failed warm is just a cold first read
            with self._cv:
                self._warmed[newest] = n
                self.pages_warmed += n
                self._cv.notify_all()

    def _warm(self, version: int) -> int:
        total_pages = self._handle.total_pages
        pages = self._pick_pages(version, total_pages)
        if not pages:
            return 0
        return self._session._prefetch_fill(
            self.blob_id, version, pages, total_pages, self._handle.page_size
        )

    def _pick_pages(self, version: int, total_pages: int) -> List[int]:
        """Hottest page offsets by read heat, topped up from the version's
        own written interval while the heat counters are still cold."""
        pages: List[int] = []
        balancer = self.cluster.replica_balancer
        if balancer is not None:
            pages = [
                p
                for p in balancer.hottest_page_offsets(self.blob_id, self.top_pages)
                if p < total_pages
            ]
        if len(pages) < self.top_pages:
            try:
                off, size = self.cluster.version_manager.interval_of(
                    self.blob_id, version
                )
            except KeyError:
                off = size = 0
            seen = set(pages)
            for p in range(off, min(off + size, total_pages)):
                if len(pages) >= self.top_pages:
                    break
                if p not in seen:
                    pages.append(p)
        return pages[: self.top_pages]

    # -- rendezvous / introspection ------------------------------------------
    def wait_warmed(self, version: int, timeout: Optional[float] = None) -> bool:
        """Block until a warm pass for ``version`` (or any newer one) has
        completed; ``False`` on timeout."""
        with self._cv:
            return self._cv.wait_for(
                lambda: any(v >= version for v in self._warmed), timeout
            )

    def warmed_versions(self) -> Dict[int, int]:
        with self._cv:
            return dict(self._warmed)

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the warming thread and release the warmer's session
        (idempotent; called by :meth:`Cluster.close`). The join is bounded by
        ``timeout`` — a warm pass wedged on a dead provider must not hang the
        caller's close; the daemon thread then dies with the process."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=timeout)
        self._session.close()
