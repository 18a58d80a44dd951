"""Deprecated facade: ``BlobStore`` = one :class:`Cluster` + one
:class:`Session`.

The god-object API this module used to implement was split into the layered
:mod:`repro.core.cluster` API — :class:`~repro.core.cluster.Cluster` (shared
plane), :class:`~repro.core.cluster.Session` (per-client state) and
:class:`~repro.core.cluster.BlobHandle` (fine-grain ops, snapshots, version
watches). ``BlobStore`` remains as a thin compatibility wrapper so external
callers keep working one release longer; it constructs a private cluster
with the shared cache tier DISABLED (the pre-split topology: one client, one
cache) and forwards every old entry point to the single session. It emits a
:class:`DeprecationWarning` on construction and is used nowhere else inside
this repository — CI runs a ``-W error::DeprecationWarning`` leg to keep it
that way.

Migration map (old → new)::

    BlobStore(...)                    Cluster(...); session = cluster.session()
    store.alloc(size, page)           cluster.alloc(size, page)  /  session.create(size, page)
    store.read(b, v, off, sz)         session.open(b).read(off, sz, version=v)
    store.readv(b, v, segs)           session.open(b).readv(segs, version=v)
    store.write(b, buf, off)          handle.write(buf, off)
    store.writev(b, patches)          handle.writev(patches)
    store.write_async(b, buf, off)    handle.write_async(buf, off)
    store.flush()                     session.flush()
    store.write_unaligned(...)        handle.write_unaligned(buf, off)
    store.gc(b, keep)                 cluster.gc(b, keep)
    store.page_cache                  session.cache  (+ cluster.shared_cache)
    store.stats                       cluster.stats  (+ session.stats per client)
    —                                 handle.snapshot() / handle.at(v)   (pinned lock-free reads)
    —                                 handle.watch() / handle.wait_for_version(v)
"""

from __future__ import annotations

import warnings
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.lockwatch import make_lock
from repro_torch.core.cluster import (
    BlobHandle,
    Cluster,
    DEFAULT_CACHE_BYTES,
    ReadResult,
    Session,
)
from repro_torch.core.replica_balancer import BalancerConfig

__all__ = ["BlobStore", "DEFAULT_CACHE_BYTES", "ReadResult"]


class BlobStore:
    """Deprecated single-client facade over ``Cluster`` + ``Session``."""

    def __init__(
        self,
        n_data_providers: int = 4,
        n_metadata_providers: int = 4,
        page_replication: int = 1,
        metadata_replication: int = 1,
        max_workers: int = 8,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        replica_spread: bool = True,
        hot_replicas: bool = True,
        balancer_config: Optional[BalancerConfig] = None,
        page_service_seconds: float = 0.0,
        metadata_latency_seconds: float = 0.0,
        sync_write: bool = False,
        max_inflight_writes: int = 8,
    ) -> None:
        warnings.warn(
            "BlobStore is deprecated: use Cluster/Session/BlobHandle "
            "(repro.core.cluster) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        self.cluster = Cluster(
            n_data_providers=n_data_providers,
            n_metadata_providers=n_metadata_providers,
            page_replication=page_replication,
            metadata_replication=metadata_replication,
            max_workers=max_workers,
            shared_cache_bytes=0,  # pre-split topology: one client, one cache
            hot_replicas=hot_replicas,
            balancer_config=balancer_config,
            page_service_seconds=page_service_seconds,
            metadata_latency_seconds=metadata_latency_seconds,
        )
        self.session: Session = self.cluster.session(
            cache_bytes=cache_bytes,
            replica_spread=replica_spread,
            sync_write=sync_write,
            max_inflight_writes=max_inflight_writes,
        )
        #: blob_id -> handle; blob geometry is immutable after alloc, so the
        #: facade must not pay a fresh blob_info lock round-trip per call
        self._handles: dict = {}
        self._handles_lock = make_lock("BlobStore._handles_lock")

    # -- shared-plane attributes the old object exposed directly ---------------
    @property
    def stats(self):
        return self.cluster.stats

    @property
    def version_manager(self):
        return self.cluster.version_manager

    @property
    def provider_manager(self):
        return self.cluster.provider_manager

    @property
    def metadata(self):
        return self.cluster.metadata

    @property
    def replica_balancer(self):
        return self.cluster.replica_balancer

    @property
    def page_cache(self):
        return self.session.cache

    @property
    def replica_spread(self) -> bool:
        return self.session.replica_spread

    @replica_spread.setter
    def replica_spread(self, value: bool) -> None:
        self.session.replica_spread = value

    @property
    def sync_write(self) -> bool:
        return self.session.sync_write

    @property
    def max_inflight_writes(self) -> int:
        return self.session.max_inflight_writes

    # -- old entry points -------------------------------------------------------
    def add_data_provider(self) -> int:
        return self.cluster.add_data_provider()

    def alloc(self, size_bytes: int, page_size: int) -> int:
        return self.cluster.alloc(size_bytes, page_size)

    def _handle(self, blob_id: int) -> BlobHandle:
        with self._handles_lock:
            handle = self._handles.get(blob_id)
            if handle is None:
                handle = self._handles[blob_id] = self.session.open(blob_id)
            return handle

    def write(self, blob_id: int, buffer: np.ndarray, offset_bytes: int) -> int:
        return self._handle(blob_id).write(buffer, offset_bytes)

    def writev(
        self, blob_id: int, patches: Sequence[Tuple[int, np.ndarray]]
    ) -> List[int]:
        return self._handle(blob_id).writev(patches)

    def write_async(
        self, blob_id: int, buffer: np.ndarray, offset_bytes: int
    ) -> "Future[int]":
        return self._handle(blob_id).write_async(buffer, offset_bytes)

    def flush(self) -> List[int]:
        return self.session.flush()

    def read(
        self,
        blob_id: int,
        version: Optional[int],
        offset_bytes: int,
        size_bytes: int,
    ) -> ReadResult:
        return self._handle(blob_id).read(offset_bytes, size_bytes, version=version)

    def readv(
        self,
        blob_id: int,
        version: Optional[int],
        segments: Sequence[Tuple[int, int]],
    ) -> List[np.ndarray]:
        return self._handle(blob_id).readv(segments, version=version)

    def write_unaligned(
        self, blob_id: int, buffer: np.ndarray, offset_bytes: int
    ) -> int:
        return self._handle(blob_id).write_unaligned(buffer, offset_bytes)

    def gc(self, blob_id: int, keep_versions: Sequence[int]) -> Tuple[int, int]:
        return self.cluster.gc(blob_id, keep_versions)

    def storage_bytes(self) -> int:
        return self.cluster.storage_bytes()

    def close(self) -> None:
        self.cluster.close()
