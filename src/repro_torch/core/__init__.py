"""Lock-free versioned blob storage: the storage core that blob-mode serving
and the sky application stand on, copied from :mod:`repro.core` (only the
package name in imports differs; ``tests/test_torch_blob_kv.py`` holds each
copy to its source).

Public API: :class:`Cluster` (shared plane: version manager, metadata DHT,
data providers, replica balancer, shared cache tier) → :class:`Session`
(per-client state) → :class:`BlobHandle` (fine-grain ALLOC/READ/WRITE ops,
:class:`Snapshot` pinning, :class:`VersionWatch` subscriptions), the
cluster-wide :class:`PageDirectory` of published prefix pages,
:func:`flatten` (a version's page map as arrays), :class:`BlobStore`, the
deprecated single-object facade, :class:`Federation` (several access nodes
on one substrate under the GC epoch/lease protocol of
:class:`GcEpochCoordinator`) and the chaos harness (:class:`FaultSchedule`,
:class:`FaultEvent`, :class:`FaultInjector`).

Two copies differ from their sources, each to repair a fault of the
reference: in ``federation`` a rejoining node's pin resync that arrives
while a GC sweep is open is installed as the sweep closes instead of
waiting for it (a ``recover`` event that the sweep's own RPCs cross
deadlocked the sweep), and in ``cluster`` a GC pass always keeps the
newest published version (one whose keep list predated a concurrent
publish collected the tree every later write links into).
"""

from repro_torch.core.blob import BlobStore
from repro_torch.core.cluster import (
    BlobHandle,
    Cluster,
    DEFAULT_CACHE_BYTES,
    DEFAULT_SHARED_CACHE_BYTES,
    ReadResult,
    RetryPolicy,
    Session,
    Snapshot,
    VersionWatch,
)
from repro_torch.core.dht import (
    MetadataDHT,
    ProviderFailed,
    TrafficStats,
    page_checksum,
)
from repro_torch.core.faults import FaultEvent, FaultInjector, FaultSchedule
from repro_torch.core.federation import Federation, GcEpochCoordinator
from repro_torch.core.flat_view import FlatView, ZERO_PAGE, flatten
from repro_torch.core.page_cache import CacheKey, FetchPlan, PageCache
from repro_torch.core.page_directory import PageAddress, PageDirectory
from repro_torch.core.prefetch import PrefetchConfig, StridePrefetcher, WatchWarmer
from repro_torch.core.provider import DataProvider, HealthConfig, ProviderManager
from repro_torch.core.repair import RepairService
from repro_torch.core.replica_balancer import BalancerConfig, ReplicaBalancer
from repro_torch.core.segment_tree import (
    BorderLink,
    IntervalIndex,
    NodeKey,
    PageRef,
    TreeNode,
    ZERO_VERSION,
    build_write_tree,
    compute_border_links,
    count_write_nodes,
    traverse,
    traverse_batch,
)
from repro_torch.core.version_manager import (
    JournalEntry,
    VersionAbandoned,
    VersionManager,
)

__all__ = [
    "BlobHandle",
    "BlobStore",
    "Cluster",
    "DEFAULT_CACHE_BYTES",
    "DEFAULT_SHARED_CACHE_BYTES",
    "ReadResult",
    "RetryPolicy",
    "Session",
    "Snapshot",
    "VersionWatch",
    "FaultEvent",
    "FaultInjector",
    "FaultSchedule",
    "Federation",
    "GcEpochCoordinator",
    "HealthConfig",
    "RepairService",
    "CacheKey",
    "FetchPlan",
    "PageAddress",
    "PageCache",
    "PageDirectory",
    "PrefetchConfig",
    "StridePrefetcher",
    "WatchWarmer",
    "MetadataDHT",
    "ProviderFailed",
    "TrafficStats",
    "page_checksum",
    "FlatView",
    "ZERO_PAGE",
    "flatten",
    "DataProvider",
    "ProviderManager",
    "BalancerConfig",
    "ReplicaBalancer",
    "BorderLink",
    "IntervalIndex",
    "NodeKey",
    "PageRef",
    "TreeNode",
    "ZERO_VERSION",
    "build_write_tree",
    "compute_border_links",
    "count_write_nodes",
    "traverse",
    "traverse_batch",
    "JournalEntry",
    "VersionAbandoned",
    "VersionManager",
]
