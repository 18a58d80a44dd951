"""Host-side paged-KV bookkeeping."""

from repro_torch.storage.kvcache import PagedKVAllocator, SeqState, Snapshot, chain_hash

__all__ = ["PagedKVAllocator", "SeqState", "Snapshot", "chain_hash"]
