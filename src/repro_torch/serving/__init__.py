"""Continuous-batching serving engine on the paged KV pool, and the
blob-backed KV plane it publishes pages to and fetches them from."""

from repro_torch.serving.blob_kv import (
    BlobKVClient,
    BlobKVStore,
    KVSeq,
    kv_page_nbytes,
    pack_kv_page,
    unpack_kv_page,
)
from repro_torch.serving.engine import Completion, Request, ServingEngine

__all__ = [
    "BlobKVClient",
    "BlobKVStore",
    "Completion",
    "KVSeq",
    "Request",
    "ServingEngine",
    "kv_page_nbytes",
    "pack_kv_page",
    "unpack_kv_page",
]
