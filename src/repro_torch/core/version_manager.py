# Copy of src/repro/core/version_manager.py (the JAX package's storage core); only the package name in imports differs.
"""Version manager (paper §III.A/§IV): the system's only serialization point.

Responsibilities, exactly as in the paper:

* assign monotonically increasing version numbers to WRITEs of a blob;
* **precompute border-node links** for each assigned version from the interval
  history of *all* previously assigned versions — published or not — so that
  concurrent writers weave their metadata trees in complete isolation
  (paper §IV.C);
* publish versions **in order**: version ``v`` becomes visible to readers only
  once versions ``1..v`` have all reported success. This yields the paper's
  global serializability (every READ of version ``v`` sees exactly the first
  ``v`` patches) and liveness (every WRITE eventually publishes).

Fault tolerance (paper's future work, implemented here): every state
transition is appended to a journal; :func:`VersionManager.recover` rebuilds a
manager from a journal replay, and unfinished assignments are surfaced so the
caller can retry or abandon them. :meth:`VersionManager.abandon` is the online
analog — a writer whose data or metadata puts failed mid-flight withdraws its
assigned versions so in-order publication is never wedged behind a version
that will never report success.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.lockwatch import make_condition, make_lock
from repro_torch.core.segment_tree import BorderLink, ZERO_VERSION, compute_border_links


class VersionAbandoned(ValueError):
    """The awaited version was withdrawn by a failed writer — it will never
    publish as written. Raised by :meth:`VersionManager.wait_published` so a
    waiter fails fast the moment :meth:`VersionManager.abandon` runs, instead
    of blocking for its full timeout on a version that cannot arrive."""


@dataclasses.dataclass
class JournalEntry:
    op: str  # "alloc" | "assign" | "complete" | "abandon"
    blob_id: int
    version: int = 0
    offset: int = 0
    size: int = 0
    total_pages: int = 0
    page_size: int = 0


@dataclasses.dataclass
class _BlobState:
    total_pages: int
    page_size: int
    #: latest assigned version (may exceed latest published under concurrency)
    assigned: int = 0
    #: latest published version; versions publish strictly in order
    published: int = 0
    #: interval history: version -> (offset, size) in pages
    intervals: Dict[int, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    #: versions that reported success but are not yet publishable
    completed: set = dataclasses.field(default_factory=set)
    #: versions withdrawn by failed writers; publication skips over them but
    #: they are never readable (their trees were never fully stored)
    aborted: set = dataclasses.field(default_factory=set)
    #: immutable snapshot of ``aborted``, swapped (never mutated) under the
    #: manager lock — read paths grab it lock-free to decide whether the
    #: aborted-link redirect machinery needs to engage at all
    aborted_view: frozenset = frozenset()
    #: versions fully *erased* by abandon (they were the latest assignment, so
    #: interval history rolled back) and not yet reassigned to a new writer.
    #: Publication can never reach them until reassignment, so waiters treat
    #: them exactly like aborted holes and fail fast; ``assign_versions``
    #: clears a number from here the moment a new writer takes it.
    withdrawn: set = dataclasses.field(default_factory=set)
    #: per-page latest assigned version, for O(range-max) border queries
    page_versions: Optional[np.ndarray] = None


class VersionManager:
    """Serializes version assignment; everything else stays parallel."""

    def __init__(self) -> None:
        self._blobs: Dict[int, _BlobState] = {}
        self._blob_id_counter = 0
        self._lock = make_lock("VersionManager._lock")
        self._published_cv = make_condition(
            "VersionManager._published_cv", lock=self._lock
        )
        self.journal: List[JournalEntry] = []

    # -- ALLOC ---------------------------------------------------------------
    def alloc(self, total_pages: int, page_size: int) -> int:
        if total_pages & (total_pages - 1):
            raise ValueError("total_pages must be a power of two (paper §II)")
        with self._lock:
            blob_id = self._blob_id_counter
            self._blob_id_counter += 1
            self._blobs[blob_id] = _BlobState(
                total_pages=total_pages,
                page_size=page_size,
                page_versions=np.zeros(total_pages, dtype=np.int64),
            )
            self.journal.append(
                JournalEntry("alloc", blob_id, total_pages=total_pages, page_size=page_size)
            )
            return blob_id

    def blob_info(self, blob_id: int) -> Tuple[int, int]:
        with self._lock:
            st = self._blobs[blob_id]
            return st.total_pages, st.page_size

    def blob_ids(self) -> List[int]:
        """Every allocated blob id (public API for invariant checkers — the
        interleaving explorer sweeps all blobs without reaching into
        ``_blobs``)."""
        with self._lock:
            return sorted(self._blobs)

    # -- WRITE protocol --------------------------------------------------------
    def assign_version(
        self, blob_id: int, offset: int, size: int
    ) -> Tuple[int, List[BorderLink]]:
        """Step 2 of a WRITE: get a fresh version number + precomputed border
        links. Thin wrapper over :meth:`assign_versions` — journal replay
        (:meth:`recover`) sees identical per-version ``assign`` entries either
        way."""
        return self.assign_versions(blob_id, [(offset, size)])[0]

    def assign_versions(
        self, blob_id: int, spans: Sequence[Tuple[int, int]]
    ) -> List[Tuple[int, List[BorderLink]]]:
        """Batch version assignment for a multi-patch ``writev``: ONE manager
        lock acquisition covers every ``(offset, size)`` span, in span order.
        The serialized section stays O(Σ size + patches·log total_pages) —
        each span's border links are computed against the interval history of
        all earlier assignments *including the preceding spans of this very
        batch*, exactly as a loop of :meth:`assign_version` would see them.
        One ``assign`` journal entry is appended per span, so journals are
        byte-compatible with the single-patch API."""
        with self._lock:
            st = self._blobs[blob_id]
            for offset, size in spans:
                if offset < 0 or size <= 0 or offset + size > st.total_pages:
                    raise ValueError("write range out of bounds")
            pv = st.page_versions
            assert pv is not None

            def version_of_segment(o: int, s: int) -> int:
                # Most recent version < `version` intersecting [o, o+s):
                # range-max over the per-page latest-version array, which at
                # this point reflects exactly versions 1..version-1.
                return int(pv[o : o + s].max(initial=ZERO_VERSION))

            out: List[Tuple[int, List[BorderLink]]] = []
            for offset, size in spans:
                version = st.assigned + 1
                st.withdrawn.discard(version)  # the number has a writer again
                links = compute_border_links(
                    st.total_pages, offset, size, version_of_segment
                )
                # Commit the assignment only after computing links.
                st.assigned = version
                st.intervals[version] = (offset, size)
                pv[offset : offset + size] = version
                self.journal.append(
                    JournalEntry("assign", blob_id, version, offset, size)
                )
                out.append((version, links))
            return out

    def report_success(self, blob_id: int, version: int) -> int:
        """Final step of a WRITE. Publishes the maximal completed prefix and
        returns the new latest published version."""
        return self.report_successes(blob_id, [version])

    def report_successes(self, blob_id: int, versions: Sequence[int]) -> int:
        """Batched :meth:`report_success` for a multi-patch ``writev``: all of
        the batch's versions complete under ONE lock acquisition (one
        ``complete`` journal entry per version, so journals stay
        byte-compatible with the single-version API)."""
        with self._lock:
            st = self._blobs[blob_id]
            # writer-recovery race: if a death verdict abandoned these
            # versions while their (actually live, e.g. partitioned) writer
            # was mid-flight, the write MUST surface as a failure — marking
            # an aborted hole "complete" would silently ack a write that
            # will never publish
            stale = sorted(
                v for v in versions if v in st.aborted or v in st.withdrawn
            )
            if stale:
                raise VersionAbandoned(
                    f"versions {stale} of blob {blob_id} were abandoned "
                    "by writer recovery before their writer reported"
                )
            for version in versions:
                st.completed.add(version)
                self.journal.append(JournalEntry("complete", blob_id, version))
            self._advance_published_locked(st)
            return st.published

    def abandon(self, blob_id: int, versions: Sequence[int]) -> "set":
        """Withdraw assigned-but-unreportable versions after a failed WRITE.

        Without this, in-order publication would wedge forever behind a
        version whose writer died mid-flight. Two cases, handled newest-first:

        * the version is still the *latest* assignment — it is fully erased
          (interval history and the per-page version array are rolled back),
          so no future border link can ever reference it and the version
          number is reused by the next writer;
        * a concurrent writer was assigned after it — the version becomes an
          *aborted hole*: publication skips over it, reads of it are
          rejected, and its interval stays in the history, but the per-page
          latest-version array is rolled back past it so every writer
          assigned *from now on* links straight to live versions. Writers
          assigned *before* the abandon may already have woven border links
          against the hole; those dangling links are resolved on the read
          path via :meth:`redirect_read_link` and eventually unlinked by the
          repair service's metadata scrub.

        Returns the set of versions that became holes (empty when everything
        was erased) — the caller must NOT scrub a hole's stored pages/nodes
        inline, since pre-abandon writers' trees may reference them (the
        scrub runs later, once the read-path redirect makes it safe).
        """
        holes: set = set()
        with self._lock:
            st = self._blobs[blob_id]
            pv = st.page_versions
            assert pv is not None

            def rolled_back(offset: int, size: int) -> np.ndarray:
                """What the per-page latest-version array should say for
                ``[offset, offset+size)`` given only live (non-aborted)
                interval history."""
                seg = np.full(size, ZERO_VERSION, dtype=np.int64)
                for w, (wo, ws) in st.intervals.items():
                    if w in st.aborted:
                        continue  # holes must never resurface in pv
                    lo, hi = max(offset, wo), min(offset + size, wo + ws)
                    if lo < hi:
                        np.maximum(
                            seg[lo - offset : hi - offset],
                            w,
                            out=seg[lo - offset : hi - offset],
                        )
                return seg

            for v in sorted(set(versions), reverse=True):
                if (
                    v <= st.published
                    or v > st.assigned
                    or v in st.completed
                    or v in st.aborted
                ):
                    continue  # published/completed versions are past abandoning
                self.journal.append(JournalEntry("abandon", blob_id, v))
                if v == st.assigned:
                    offset, size = st.intervals.pop(v)
                    st.assigned -= 1
                    st.withdrawn.add(v)
                    pv[offset : offset + size] = rolled_back(offset, size)
                else:
                    st.aborted.add(v)
                    holes.add(v)
                    # roll pv back over the hole too: pages still carrying v
                    # recompute from live history, pages a later writer
                    # already overwrote stay theirs
                    offset, size = st.intervals[v]
                    span = pv[offset : offset + size]
                    mine = span == v
                    if mine.any():
                        span[mine] = rolled_back(offset, size)[mine]
            if holes:
                st.aborted_view = frozenset(st.aborted)
            self._advance_published_locked(st)
        return holes

    def _advance_published_locked(self, st: _BlobState) -> None:
        """Publish the maximal completed-or-aborted prefix (caller holds the
        lock). Aborted versions are skipped over but stay in ``st.aborted`` so
        reads can reject them."""
        while (st.published + 1) in st.completed or (st.published + 1) in st.aborted:
            st.completed.discard(st.published + 1)
            st.published += 1
        self._published_cv.notify_all()

    # -- READ protocol ---------------------------------------------------------
    @staticmethod
    def _latest_readable_locked(st: _BlobState) -> int:
        """Latest readable published version (caller holds the lock):
        aborted holes at the publish frontier are walked back over (an
        aborted version has no tree)."""
        v = st.published
        while v in st.aborted:
            v -= 1
        return v

    def latest_published(self, blob_id: int) -> int:
        """Latest *readable* published version."""
        with self._lock:
            return self._latest_readable_locked(self._blobs[blob_id])

    def resolve_read_version(
        self, blob_id: int, version: Optional[int]
    ) -> Tuple[int, int, int, int]:
        """One-lock READ setup: returns ``(total_pages, page_size, resolved,
        latest)`` where ``resolved`` is ``version`` (validated: published and
        not aborted) or the latest readable version when ``version`` is None.
        The serialized actor is consulted exactly once per read call."""
        with self._lock:
            st = self._blobs[blob_id]
            latest = self._latest_readable_locked(st)
            if version is None:
                resolved = latest
            else:
                if version > st.published:
                    raise ValueError(
                        f"version {version} not yet published (latest={st.published})"
                    )
                if version in st.aborted:
                    raise ValueError(
                        f"version {version} was abandoned by a failed writer"
                    )
                resolved = version
            return st.total_pages, st.page_size, resolved, latest

    def is_published(self, blob_id: int, version: int) -> bool:
        with self._lock:
            return version <= self._blobs[blob_id].published

    def is_aborted(self, blob_id: int, version: int) -> bool:
        """True if ``version`` was withdrawn by a failed writer (publication
        skipped over it; it was never readable). Version-watch subscriptions
        use this to step over holes without delivering them."""
        with self._lock:
            return version in self._blobs[blob_id].aborted

    def aborted_view(self, blob_id: int) -> frozenset:
        """Lock-free snapshot of the blob's aborted (hole) versions.

        The common case is the empty frozenset, letting read paths skip the
        dangling-link redirect entirely without touching the manager lock.
        Memory visibility is safe: a reader resolving its read version takes
        the manager lock *after* any abandon that published the hole, so the
        swapped-in frozenset (an immutable object, never mutated) is at
        least as fresh as the version being read."""
        return self._blobs[blob_id].aborted_view

    def repair_horizon(self, blob_id: int) -> Tuple[int, frozenset]:
        """The journal-covered repair window: ``(latest_published,
        aborted_view)`` read under ONE lock acquisition so the pair is
        mutually consistent. Repair passes (page re-replication, metadata
        re-replication) must only touch versions the journal vouches for —
        at or below the publish frontier and not an abandoned hole:
        everything above the frontier is an in-flight writer's private state
        (the writer fixes its own placements or gets withdrawn), and holes
        are the scrub's business. Both values derive from journaled
        transitions (``publish``/``abandon``), so a recovered manager
        replays the identical horizon and a repair decided before the crash
        stays valid after it."""
        with self._lock:
            st = self._blobs[blob_id]
            return self._latest_readable_locked(st), st.aborted_view

    def redirect_read_link(
        self, blob_id: int, version: int, offset: int, size: int
    ) -> int:
        """Resolve a dangling border link: a stored tree node links segment
        ``[offset, offset+size)`` (in pages) to aborted ``version``. Returns
        the most recent live version below it whose interval intersects the
        segment — the version whose tree holds the segment's real content
        (aborted versions in between never stored data, so skipping them is
        exactly COW semantics) — or ``ZERO_VERSION`` when no live writer
        ever touched the segment (implicit zeros)."""
        with self._lock:
            st = self._blobs[blob_id]
            best = ZERO_VERSION
            for w, (wo, ws) in st.intervals.items():
                if w >= version or w <= best or w in st.aborted:
                    continue
                if wo < offset + size and offset < wo + ws:
                    best = w
            return best

    def wait_published(
        self,
        blob_id: int,
        version: int,
        timeout: Optional[float] = None,
        *,
        fail_on_withdrawn: bool = True,
    ) -> bool:
        """Block until ``version`` publishes; ``False`` on timeout.

        Raises :class:`VersionAbandoned` when ``version`` was withdrawn by a
        failed writer — whether it became an aborted hole or was erased
        outright. :meth:`abandon` notifies this condition, so a waiter whose
        version is abandoned *mid-wait* fails fast instead of burning its
        whole timeout on a version that can never arrive as written.

        ``fail_on_withdrawn=False`` is for subscription waiters
        (:class:`~repro.core.cluster.VersionWatch`): an *erased* version
        number may be reissued to the next writer, so a watch keeps waiting
        for the number to publish under its new owner — only aborted holes
        (which can never publish) raise."""
        st = self._blobs[blob_id]

        def resolved() -> bool:
            if st.published >= version or version in st.aborted:
                return True
            return fail_on_withdrawn and version in st.withdrawn

        with self._published_cv:
            if not self._published_cv.wait_for(resolved, timeout=timeout):
                return False
            if version in st.aborted or (
                fail_on_withdrawn and version in st.withdrawn
            ):
                raise VersionAbandoned(
                    f"version {version} of blob {blob_id} was abandoned by a "
                    f"failed writer"
                )
            return True

    def interval_of(self, blob_id: int, version: int) -> Tuple[int, int]:
        with self._lock:
            return self._blobs[blob_id].intervals[version]

    def assigned_versions(self, blob_id: int) -> int:
        with self._lock:
            return self._blobs[blob_id].assigned

    # -- fault tolerance ---------------------------------------------------------
    @classmethod
    def recover(cls, journal: List[JournalEntry]) -> Tuple["VersionManager", Dict[int, List[int]]]:
        """Rebuild a manager from a journal replay.

        Returns ``(manager, orphans)`` where ``orphans[blob_id]`` lists
        versions that were assigned but never reported success — a recovering
        deployment either waits for their writers or garbage-collects their
        pages. Publishing stops before the first orphan, preserving
        serializability across the crash.
        """
        vm = cls()
        completed: Dict[int, set] = {}
        for entry in journal:
            if entry.op == "alloc":
                bid = vm.alloc(entry.total_pages, entry.page_size)
                assert bid == entry.blob_id
                completed[bid] = set()
            elif entry.op == "assign":
                version, _ = vm.assign_version(entry.blob_id, entry.offset, entry.size)
                assert version == entry.version
            elif entry.op == "complete":
                completed[entry.blob_id].add(entry.version)
            elif entry.op == "abandon":
                vm.abandon(entry.blob_id, [entry.version])
        orphans: Dict[int, List[int]] = {}
        for bid, done in completed.items():
            for v in sorted(done):
                vm.report_success(bid, v)
            st = vm._blobs[bid]
            orphans[bid] = [
                v
                for v in range(1, st.assigned + 1)
                if v not in done and v not in st.aborted and v > st.published
            ]
        return vm, orphans
