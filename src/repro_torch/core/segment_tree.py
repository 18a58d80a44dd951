# Copy of src/repro/core/segment_tree.py (the JAX package's storage core); only the package name in imports differs.
"""Copy-on-write distributed segment-tree metadata (paper §III.C).

A blob of ``total_pages`` pages (power of two) is described, for each
*version*, by a full binary tree. A node covers the segment ``(offset, size)``
(in pages): its left child covers the first half, the right child the second
half, and leaves cover exactly one page. Node identity in the metadata DHT is
``(blob_id, version, offset, size)``.

A WRITE that patches pages ``[wo, wo+ws)`` and is assigned version ``v``
creates only the nodes whose covered segment intersects the patch — the
smallest (possibly incomplete) subtree with those leaves. *Border nodes* (whose
covered segment only partially intersects the patch) are completed by linking
the missing child to the node of an **earlier** version covering that child
segment: the tree of version ``v`` is "weaved" into its predecessors, so all
unmodified metadata (and therefore data pages) are shared between snapshots.

Child links are stored as *version numbers*: the left child of inner node
``(v, o, s)`` is the node ``(left_version, o, s/2)`` and the right child is
``(right_version, o + s/2, s/2)``. A link to ``version 0`` denotes the
implicit all-zero initial string (paper §II) — no node is materialized for it.

All nodes are immutable and create-only, which is what makes readers lock-free
with respect to writers: a published version's tree can never change.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

# A page is addressed by (provider_id, page_key). page_key is globally unique.
PageRef = Tuple[int, int]

#: Version number of the implicit all-zero initial string.
ZERO_VERSION = 0


@dataclasses.dataclass(frozen=True)
class NodeKey:
    """DHT key of a metadata tree node. ``offset``/``size`` are in pages."""

    blob_id: int
    version: int
    offset: int
    size: int

    def child_keys(self, left_version: int, right_version: int) -> Tuple["NodeKey", "NodeKey"]:
        half = self.size // 2
        return (
            NodeKey(self.blob_id, left_version, self.offset, half),
            NodeKey(self.blob_id, right_version, self.offset + half, half),
        )


@dataclasses.dataclass(frozen=True)
class TreeNode:
    """An immutable metadata node.

    Leaves (``size == 1``) carry ``page`` (+ replicas) and, since the
    metadata-fault PR, an end-to-end page ``checksum``
    (:func:`repro.core.dht.page_checksum` of the page bytes, computed at
    ``writev`` freeze time and verified on every provider fetch; ``None``
    for pre-checksum nodes and inner nodes). The sanctioned
    leaf rewrites (balancer promotion, repair re-placement) go through
    ``dataclasses.replace`` and change only placement fields, so the
    checksum follows the page data it attests to.
    Inner nodes carry the versions of their two children.
    """

    key: NodeKey
    left_version: int = ZERO_VERSION
    right_version: int = ZERO_VERSION
    page: Optional[PageRef] = None
    replicas: Tuple[PageRef, ...] = ()
    checksum: Optional[int] = None

    @property
    def is_leaf(self) -> bool:
        return self.key.size == 1

    def all_page_refs(self) -> Tuple[PageRef, ...]:
        assert self.page is not None
        return (self.page,) + self.replicas


def intersects(o1: int, s1: int, o2: int, s2: int) -> bool:
    """Do half-open page intervals [o1, o1+s1) and [o2, o2+s2) intersect?"""
    return o1 < o2 + s2 and o2 < o1 + s1


@dataclasses.dataclass(frozen=True)
class BorderLink:
    """Precomputed link for a border node's missing child (paper §IV.C).

    The node covering ``(offset, size)`` of the *new* tree is incomplete; its
    missing child covering ``(child_offset, child_size)`` must point to
    ``child_version`` — the most recent version ``< v`` whose patch intersects
    the child segment (``ZERO_VERSION`` if none).
    """

    offset: int
    size: int
    child_offset: int
    child_size: int
    child_version: int


def compute_border_links(
    total_pages: int,
    write_offset: int,
    write_size: int,
    version_of_segment: Callable[[int, int], int],
) -> List[BorderLink]:
    """Compute every border link needed to weave version ``v``'s tree.

    ``version_of_segment(o, s)`` must return the most recent version ``< v``
    whose patched interval intersects ``[o, o+s)`` (``ZERO_VERSION`` if none).
    The version manager supplies this from its interval history — crucially it
    can do so even for *unpublished* concurrent writes, which is what lets
    concurrent writers weave in complete isolation (paper §IV.C).

    The walk mirrors the read traversal: starting at the root, descend into
    children that intersect the patch; a child that does not intersect the
    patch produces a :class:`BorderLink`.
    """
    links: List[BorderLink] = []

    def descend(offset: int, size: int) -> None:
        if size == 1:
            return
        half = size // 2
        lo, ls = offset, half
        ro, rs = offset + half, half
        l_hit = intersects(lo, ls, write_offset, write_size)
        r_hit = intersects(ro, rs, write_offset, write_size)
        if l_hit and not r_hit:
            links.append(BorderLink(offset, size, ro, rs, version_of_segment(ro, rs)))
        if r_hit and not l_hit:
            links.append(BorderLink(offset, size, lo, ls, version_of_segment(lo, ls)))
        if l_hit:
            descend(lo, ls)
        if r_hit:
            descend(ro, rs)

    descend(0, total_pages)
    return links


def build_write_tree(
    blob_id: int,
    version: int,
    total_pages: int,
    write_offset: int,
    write_size: int,
    leaf_pages: Sequence[Tuple[PageRef, Tuple[PageRef, ...]]],
    border_links: Sequence[BorderLink],
    leaf_checksums: Optional[Sequence[int]] = None,
) -> List[TreeNode]:
    """Materialize all nodes of version ``version``'s (incomplete) tree.

    ``leaf_pages[i]`` is ``(primary, replicas)`` for page ``write_offset+i``;
    ``leaf_checksums[i]`` (when given) is that page's integrity checksum,
    stamped onto the leaf. Returns the new nodes (leaves + inner + root);
    nothing is written to the DHT here — the caller stores them, then reports
    success to the version manager (two-phase write, paper §III.B).
    """
    border = {(b.offset, b.size): b for b in border_links}
    nodes: List[TreeNode] = []

    def descend(offset: int, size: int) -> None:
        key = NodeKey(blob_id, version, offset, size)
        if size == 1:
            i = offset - write_offset
            primary, replicas = leaf_pages[i]
            checksum = leaf_checksums[i] if leaf_checksums is not None else None
            nodes.append(
                TreeNode(
                    key, page=primary, replicas=tuple(replicas), checksum=checksum
                )
            )
            return
        half = size // 2
        lo, ls = offset, half
        ro, rs = offset + half, half
        l_hit = intersects(lo, ls, write_offset, write_size)
        r_hit = intersects(ro, rs, write_offset, write_size)
        lv = version if l_hit else border[(offset, size)].child_version
        rv = version if r_hit else border[(offset, size)].child_version
        nodes.append(TreeNode(key, left_version=lv, right_version=rv))
        if l_hit:
            descend(lo, ls)
        if r_hit:
            descend(ro, rs)

    descend(0, total_pages)
    return nodes


def traverse(
    get_node: Callable[[NodeKey], TreeNode],
    blob_id: int,
    root_version: int,
    total_pages: int,
    offset: int,
    size: int,
) -> Iterator[Tuple[int, Optional[TreeNode]]]:
    """Yield ``(page_index, leaf_or_None)`` for every page of ``[offset,
    offset+size)`` under the tree rooted at ``root_version``.

    ``None`` stands for a page of the implicit all-zero version. ``get_node``
    is the (possibly remote / DHT) node fetch; traversal issues only the node
    fetches whose segment intersects the request (paper Fig. 2a).
    """
    if root_version == ZERO_VERSION:
        for p in range(offset, offset + size):
            yield p, None
        return

    def descend(version: int, o: int, s: int) -> Iterator[Tuple[int, Optional[TreeNode]]]:
        if version == ZERO_VERSION:
            lo = max(o, offset)
            hi = min(o + s, offset + size)
            for p in range(lo, hi):
                yield p, None
            return
        node = get_node(NodeKey(blob_id, version, o, s))
        if node.is_leaf:
            yield o, node
            return
        half = s // 2
        if intersects(o, half, offset, size):
            yield from descend(node.left_version, o, half)
        if intersects(o + half, half, offset, size):
            yield from descend(node.right_version, o + half, half)

    yield from descend(root_version, 0, total_pages)


class IntervalIndex:
    """Disjoint sorted page intervals with O(log R) intersection queries.

    Built once per ``traverse_batch`` from the request's R ranges: overlapping
    and adjacent ranges are merged, then ``intersects_any``/``clip`` answer by
    bisecting the merged starts instead of rescanning all R ranges at every
    tree node (which made vectored reads O(nodes·R)).
    """

    __slots__ = ("starts", "ends")

    def __init__(self, ranges: Sequence[Tuple[int, int]]) -> None:
        merged: List[Tuple[int, int]] = []  # (start, end), half-open, disjoint
        for o, s in sorted((o, s) for o, s in ranges if s > 0):
            if merged and o <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], o + s))
            else:
                merged.append((o, o + s))
        self.starts = [m[0] for m in merged]
        self.ends = [m[1] for m in merged]

    def intersects_any(self, o: int, s: int) -> bool:
        """Does [o, o+s) intersect any requested range?"""
        # the only candidate is the last interval starting at or before o
        # (they are disjoint), plus any interval starting inside [o, o+s)
        i = bisect.bisect_right(self.starts, o) - 1
        if i >= 0 and self.ends[i] > o:
            return True
        j = i + 1
        return j < len(self.starts) and self.starts[j] < o + s

    def clip(self, o: int, s: int) -> Iterator[Tuple[int, int]]:
        """Yield the sub-intervals of [o, o+s) covered by requested ranges."""
        i = max(bisect.bisect_right(self.starts, o) - 1, 0)
        while i < len(self.starts) and self.starts[i] < o + s:
            lo = max(self.starts[i], o)
            hi = min(self.ends[i], o + s)
            if lo < hi:
                yield lo, hi
            i += 1


def traverse_batch(
    get_nodes: Callable[[Sequence[NodeKey]], "dict[NodeKey, TreeNode]"],
    blob_id: int,
    root_version: int,
    total_pages: int,
    ranges: Sequence[Tuple[int, int]],
    on_leaves: Optional[Callable[["dict[int, TreeNode]"], None]] = None,
    redirect: Optional[Callable[[int, int, int], int]] = None,
) -> "dict[int, Optional[TreeNode]]":
    """Resolve every page of several ``(offset, size)`` page ranges in ONE
    traversal pass: the tree is walked level-synchronously, and all node
    fetches of a level go through a single ``get_nodes`` call (which the
    metadata DHT aggregates into one RPC per shard). This is the metadata
    half of the batched ``readv`` data plane — N overlapping segments share
    the path nodes near the root instead of re-fetching them N times.

    Range membership queries go through an :class:`IntervalIndex` over the
    merged request ranges, so each visited node costs O(log R) instead of a
    full rescan of all R ranges.

    ``on_leaves`` is the streaming hook of the overlapped read plane: it is
    invoked with ``{page_index: leaf}`` batches of newly resolved leaves as
    each traversal level completes — before any deeper level's node fetches
    are issued — so the caller can put data-page fetches in flight while the
    remaining metadata rounds run. (A ``get_nodes`` that itself streams
    per-shard results may deliver some leaves even earlier; this hook is the
    level-granularity catch-all that works with ANY ``get_nodes``.)
    Implicit-zero pages are never emitted — there is nothing to fetch for
    them; every emitted page also appears in the returned dict.

    ``redirect`` is the dangling-link hook of writer recovery: when given,
    every child link ``(version, offset, size)`` is mapped through it before
    the zero-check or any fetch. The version manager supplies a mapping that
    sends links to *aborted* versions (holes left by failed writers whose
    neighbors had already woven border links against them) to the newest
    live version covering the segment — so a traversal never fetches a
    node of a tree that was never fully stored. Identity for live links.

    Returns ``{page_index: leaf_or_None}`` for exactly the requested pages
    (``None`` = implicit all-zero page).
    """
    index = IntervalIndex(ranges)
    out: "dict[int, Optional[TreeNode]]" = {}

    def wanted(o: int, s: int) -> bool:
        return index.intersects_any(o, s)

    def mark_zero(o: int, s: int) -> None:
        for lo, hi in index.clip(o, s):
            for p in range(lo, hi):
                out[p] = None

    if root_version == ZERO_VERSION:
        mark_zero(0, total_pages)
        return out

    frontier: List[Tuple[int, int, int]] = [(root_version, 0, total_pages)]
    while frontier:
        nodes = get_nodes([NodeKey(blob_id, v, o, s) for v, o, s in frontier])
        next_frontier: List[Tuple[int, int, int]] = []
        new_leaves: "dict[int, TreeNode]" = {}
        for v, o, s in frontier:
            node = nodes[NodeKey(blob_id, v, o, s)]
            if node.is_leaf:
                out[o] = node
                if on_leaves is not None:
                    new_leaves[o] = node
                continue
            half = s // 2
            for child_v, co in ((node.left_version, o), (node.right_version, o + half)):
                if not wanted(co, half):
                    continue
                if redirect is not None and child_v != ZERO_VERSION:
                    child_v = redirect(child_v, co, half)
                if child_v == ZERO_VERSION:
                    mark_zero(co, half)
                else:
                    next_frontier.append((child_v, co, half))
        if on_leaves is not None and new_leaves:
            on_leaves(new_leaves)
        frontier = next_frontier
    return out


def count_write_nodes(total_pages: int, write_offset: int, write_size: int) -> int:
    """Number of metadata nodes a WRITE of ``write_size`` pages creates.

    Used by benchmarks: 2·p − 1 nodes for the aligned subtree plus the path to
    the root — O(p + log total_pages), independent of blob size beyond the log
    factor (the paper's space-efficiency argument).
    """
    count = 0

    def descend(offset: int, size: int) -> None:
        nonlocal count
        count += 1
        if size == 1:
            return
        half = size // 2
        if intersects(offset, half, write_offset, write_size):
            descend(offset, half)
        if intersects(offset + half, half, write_offset, write_size):
            descend(offset + half, half)

    descend(0, total_pages)
    return count
