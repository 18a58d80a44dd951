"""Tree → flat page-table flattening: the TPU hardware adaptation seam.

TPU cores cannot chase DHT pointers, so the device-facing view of a blob
version is a *flat page table*: for each page of a requested range, the
``(provider_id, page_key)`` pair, as int32 numpy arrays. The host resolves the
segment tree once per (version, range); devices then perform O(1) indexed
gathers — this is exactly how the serving engine turns the paper's metadata
scheme into something a Pallas kernel can consume (see
``storage/kvcache.py`` and ``kernels/paged_attention``).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.segment_tree import traverse

if TYPE_CHECKING:
    from repro_torch.core.cluster import Cluster

#: Sentinel for pages of the implicit all-zero version.
ZERO_PAGE = -1


@dataclasses.dataclass
class FlatView:
    """Device-consumable description of ``[first_page, first_page+n)`` of one
    published version of a blob."""

    blob_id: int
    version: int
    first_page: int
    provider_ids: np.ndarray  # int32 (n,)  ZERO_PAGE for implicit zero pages
    page_keys: np.ndarray  # int32 (n,)

    @property
    def n_pages(self) -> int:
        return int(self.page_keys.shape[0])


def flatten(
    cluster: "Cluster", blob_id: int, version: int, first_page: int, n_pages: int
) -> FlatView:
    """Resolve ``n_pages`` of one published version to (provider, key) pairs.
    ``cluster`` is the shared plane (anything exposing ``version_manager``
    and ``metadata`` works, including the deprecated ``BlobStore``)."""
    total_pages, _ = cluster.version_manager.blob_info(blob_id)
    if version > cluster.version_manager.latest_published(blob_id):
        raise ValueError(f"version {version} not yet published")
    provider_ids = np.full(n_pages, ZERO_PAGE, dtype=np.int32)
    page_keys = np.full(n_pages, ZERO_PAGE, dtype=np.int32)
    for page_index, leaf in traverse(
        cluster.metadata.get_node, blob_id, version, total_pages, first_page, n_pages
    ):
        if leaf is not None:
            pid, key = leaf.page  # type: ignore[misc]
            provider_ids[page_index - first_page] = pid
            page_keys[page_index - first_page] = key
    return FlatView(blob_id, version, first_page, provider_ids, page_keys)
