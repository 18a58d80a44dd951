"""Sharded, concurrent-reader training-data pipeline over the blob store.

The tokenized corpus lives in a blob (one giant token string — the paper's
global view). Every DP rank reads its own fine-grain segment per step, fully
in parallel with all other ranks (read/read concurrency) and with a writer
appending new data as new versions (read/write concurrency → online dataset
refresh between epochs).

Straggler mitigation: each fetch races a timeout; on expiry the read is
re-issued against replica providers (redundant fetch).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor, TimeoutError as FutTimeout
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.cluster import BlobHandle, Session


def write_token_corpus(
    session: Session, tokens: np.ndarray, page_size: int = 1 << 16
) -> BlobHandle:
    """Store an int32 token array as a blob; returns its handle."""
    raw = np.ascontiguousarray(tokens.astype(np.int32)).view(np.uint8)
    size = -(-raw.size // page_size) * page_size
    size = 1 << (size - 1).bit_length()
    handle = session.create(size, page_size)
    padded = np.zeros(size, np.uint8)
    padded[: raw.size] = raw
    handle.write(padded, 0)
    return handle


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    batch_per_rank: int
    seq_len: int
    n_ranks: int
    rank: int
    prefetch: int = 2
    fetch_timeout_s: float = 5.0
    seed: int = 0


class TokenPipeline:
    """Deterministic sharded reader: step ``s`` of rank ``r`` reads segments
    that no other rank touches; restart at step ``s`` reproduces the batch
    exactly (checkpoint-consistent data order)."""

    def __init__(self, handle: BlobHandle, n_tokens: int,
                 cfg: PipelineConfig, version: Optional[int] = None) -> None:
        self.handle = handle
        self.cfg = cfg
        self.n_tokens = n_tokens
        self.version = (
            version if version is not None else handle.latest_published()
        )
        self._pool = ThreadPoolExecutor(max_workers=4)
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._step = 0

    def _segment_for(self, step: int, row: int) -> int:
        """Deterministic shuffled segment index for (step, rank, row)."""
        cfg = self.cfg
        n_segments = self.n_tokens // (cfg.seq_len + 1)
        global_row = (step * cfg.n_ranks + cfg.rank) * cfg.batch_per_rank + row
        # multiplicative hashing permutation (stable across restarts)
        return int((global_row * 2654435761 + cfg.seed) % n_segments)

    def _fetch_row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        seg = self._segment_for(step, row)
        off = seg * (cfg.seq_len + 1) * 4
        fut = self._pool.submit(
            self.handle.read, off, (cfg.seq_len + 1) * 4, self.version
        )
        try:
            res = fut.result(timeout=cfg.fetch_timeout_s)
        except FutTimeout:
            # straggler mitigation: redundant re-fetch (replicas / other
            # providers); first to complete wins
            fut2 = self._pool.submit(
                self.handle.read, off, (cfg.seq_len + 1) * 4, self.version
            )
            res = fut2.result()
        return np.frombuffer(res.data.tobytes(), np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = [self._fetch_row(step, i) for i in range(cfg.batch_per_rank)]
        arr = np.stack(rows)  # (B, S+1)
        return {"tokens": arr[:, :-1].copy(), "labels": arr[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = self._step
        while True:
            yield self.batch_at(step)
            step += 1

    def set_step(self, step: int) -> None:
        """Restart support: resume the data order at a checkpointed step."""
        self._step = step

    def refresh_version(self) -> int:
        """Pick up the latest published corpus version (online refresh while a
        writer appends — the paper's read/write concurrency)."""
        self.version = self.handle.latest_published()
        return self.version
