"""Host-side paged-KV bookkeeping and the blob-store checkpointer."""

from repro_torch.storage.checkpoint import BlobCheckpointer, CheckpointRecord
from repro_torch.storage.kvcache import PagedKVAllocator, SeqState, Snapshot, chain_hash

__all__ = ["BlobCheckpointer", "CheckpointRecord", "PagedKVAllocator", "SeqState", "Snapshot", "chain_hash"]
