"""Incremental, versioned, crash-consistent checkpointing on the blob store,
the counterpart of :mod:`repro.storage.checkpoint` for trees of torch
tensors (nested dicts and lists, as ``params`` and the optimizer state are).

The state is serialized into ONE blob with a page-aligned layout. Each
checkpoint WRITEs only the *dirty* pages (blake2b content hash changed
since the previous save), so consecutive checkpoints share every unchanged
page, old checkpoints stay readable while the next is written, and a
checkpoint becomes visible only when its last write publishes: a crash
mid-save leaves the previous one intact.

The leaves are flattened to the paths ``jax.tree_util.keystr`` gives (for
example ``['params']['embed']['table']``: dict keys sorted, list items in
order), so the layout (offset, size, dtype name and shape of each leaf)
equals the JAX package's for the same state; bf16 leaves are stored as
their uint16 bits under the dtype name ``"bfloat16"``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.lockwatch import make_lock
from repro_torch.core.cluster import Session
from repro_torch.parallel.axisinfo import AxisInfo


@dataclasses.dataclass
class LeafInfo:
    path: str
    offset: int  # byte offset in the blob (page aligned)
    size: int
    dtype: str
    shape: Tuple[int, ...]


@dataclasses.dataclass
class CheckpointRecord:
    step: int
    version: int  # blob version at which this checkpoint is complete
    dirty_pages: int
    total_pages: int


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's flattening order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _leaf_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _spec_leaves(tree) -> list:
    """The specs of a spec tree in the order of :func:`_leaf_paths`: a spec
    (a tuple) is a leaf, not a node."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def _structure(tree):
    """The tree with every leaf replaced by None (what :func:`_unflatten` fills)."""
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _unflatten(structure, leaves):
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v) for v in s]
        return next(it)

    return build(structure)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(leaf.dtype).removeprefix("torch.")
    return np.dtype(leaf.dtype).name


def host_copy(leaf) -> np.ndarray:
    """A leaf's values on the host as a numpy array: a bf16 tensor as its
    uint16 bits (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _from_bytes(data: np.ndarray, info: LeafInfo, device) -> torch.Tensor:
    raw = np.array(data, dtype=np.uint8)  # a writable copy: fetched pages are read-only
    if info.dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).reshape(info.shape)).view(torch.bfloat16).to(device)
    return torch.from_numpy(raw.view(np.dtype(info.dtype)).reshape(info.shape)).to(device)


class BlobCheckpointer:
    def __init__(
        self,
        session: Session,
        template: Any,
        page_size: int = 1 << 20,
        keep_last: int = 3,
    ) -> None:
        self.session = session
        self.page_size = page_size
        self.keep_last = keep_last
        self._lock = make_lock("BlobCheckpointer._lock")

        self.layout: List[LeafInfo] = []
        off = 0
        for path, leaf in _leaf_paths(template):
            shape = tuple(leaf.shape)
            itemsize = leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize
            size = int(np.prod(shape)) * itemsize
            self.layout.append(LeafInfo(path, off, size, _dtype_name(leaf), shape))
            off += -(-size // page_size) * page_size  # page-align every leaf
        total = max(off, page_size)
        # blob sizes are powers of two (paper §II)
        self.blob_bytes = 1 << (total - 1).bit_length()
        self.handle = session.create(self.blob_bytes, page_size)
        self.blob_id = self.handle.blob_id
        self.n_pages = self.blob_bytes // page_size
        self._page_hash: Dict[int, bytes] = {}
        self.checkpoints: List[CheckpointRecord] = []
        self._structure = _structure(template)

    # -- save -------------------------------------------------------------------------
    def save(self, step: int, state: Any) -> CheckpointRecord:
        """Write the dirty pages of ``state`` (tensors on any device, or the
        host arrays of :meth:`save_async`); returns the checkpoint record.
        Each leaf's runs of dirty pages are written as soon as the leaf is
        hashed, in the order the JAX package writes them."""
        with self._lock:
            leaves = _leaf_paths(state)
            if len(leaves) != len(self.layout):
                raise ValueError("state structure changed")
            ps = self.page_size
            dirty = total_pages = 0
            version = self.handle.latest_published()
            for info, (_, leaf) in zip(self.layout, leaves):
                raw = np.ascontiguousarray(host_copy(leaf)).reshape(-1).view(np.uint8)
                n_pages = -(-raw.size // ps)
                total_pages += n_pages
                first_page = info.offset // ps
                runs: List[Tuple[int, int]] = []  # [start, end) pages of the leaf
                start: Optional[int] = None
                for p in range(n_pages):
                    chunk = raw[p * ps:(p + 1) * ps]
                    if chunk.size < ps:
                        chunk = np.concatenate([chunk, np.zeros(ps - chunk.size, np.uint8)])
                    h = hashlib.blake2b(chunk, digest_size=16).digest()
                    if self._page_hash.get(first_page + p) == h:
                        if start is not None:
                            runs.append((start, p))
                            start = None
                        continue
                    self._page_hash[first_page + p] = h
                    dirty += 1
                    if start is None:
                        start = p
                if start is not None:
                    runs.append((start, n_pages))
                for a, b in runs:
                    buf = np.zeros((b - a) * ps, np.uint8)  # owned: handed to the store without a copy
                    part = raw[a * ps:b * ps]
                    buf[:part.size] = part
                    version = self.handle.write(buf, (first_page + a) * ps)

            rec = CheckpointRecord(step, version, dirty, total_pages)
            self.checkpoints.append(rec)
            self._gc()
            return rec

    def save_async(self, step: int, state: Any) -> threading.Thread:
        """Snapshot ``state`` to the host, then write it in a background
        thread (training proceeds concurrently: the paper's read/write
        concurrency)."""
        host_state = _unflatten(_structure(state), [host_copy(leaf).copy() for _, leaf in _leaf_paths(state)])
        t = threading.Thread(target=self.save, args=(step, host_state), daemon=True)
        t.start()
        return t

    # -- restore ----------------------------------------------------------------------
    def _record(self, step: Optional[int]) -> CheckpointRecord:
        with self._lock:
            if not self.checkpoints:
                raise RuntimeError("no checkpoints saved")
            if step is None:
                return self.checkpoints[-1]
            return next(c for c in self.checkpoints if c.step == step)

    def _read(self, info: LeafInfo, rec: CheckpointRecord) -> np.ndarray:
        return self.handle.read(info.offset, info.size, version=rec.version).data

    def restore(self, step: Optional[int] = None, device="cuda", shardings: Any = None,
                axis_info: Optional[AxisInfo] = None) -> Any:
        """Rebuild the state tree (any retained step; the latest by default)
        as tensors on ``device``. With ``shardings`` (a spec tree shaped
        like the state) and ``axis_info``, this rank's blocks on a mesh of
        any shape (elastic restart): :func:`restore_onto_mesh`, which every
        other rank of the mesh calls at the same time."""
        if shardings is not None:
            return restore_onto_mesh(self, shardings, axis_info, step=step, device=device)
        device = resolve_device(device)
        rec = self._record(step)
        leaves = [_from_bytes(self._read(info, rec), info, device) for info in self.layout]
        return _unflatten(self._structure, leaves)

    # -- retention ----------------------------------------------------------------------
    def _gc(self) -> None:
        if len(self.checkpoints) <= self.keep_last:
            return
        keep = self.checkpoints[-self.keep_last :]
        self.session.cluster.gc(self.blob_id, [c.version for c in keep])
        self.checkpoints = keep

    def manifest(self) -> str:
        return json.dumps(
            {
                "blob_id": self.blob_id,
                "page_size": self.page_size,
                "checkpoints": [dataclasses.asdict(c) for c in self.checkpoints],
            }
        )


def restore_onto_mesh(ckpt: Optional[BlobCheckpointer], shardings: Any, axis_info: AxisInfo,
                      step: Optional[int] = None, device="cuda") -> Any:
    """Restore a checkpoint onto ``axis_info``'s mesh, the JAX package's
    ``restore(shardings=)``: every rank of the mesh calls this. The blob
    store lives in one process, so ``ckpt`` is the checkpointer on rank 0
    and None on the others. Rank 0 sends the layout, then reads each leaf
    of the checkpoint (the full logical state) and broadcasts its bytes;
    every rank keeps its block of the leaf under its spec in ``shardings`` (:func:`repro_torch.parallel.sharding.shard_leaf`).
    Returns this rank's state tree on ``device``."""
    import torch.distributed as dist

    from repro_torch.parallel.sharding import shard_leaf

    device = resolve_device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank == 0:
        if ckpt is None:
            raise ValueError("rank 0 holds the checkpoints: pass its checkpointer")
        rec = ckpt._record(step)
        header = [ckpt.layout, ckpt._structure]
    else:
        header = [None, None]
    if dist.is_initialized():
        dist.broadcast_object_list(header, src=0)
    layout, structure = header
    specs = _spec_leaves(shardings)
    if len(specs) != len(layout):
        raise ValueError(f"shardings has {len(specs)} leaves, the checkpoint {len(layout)}")
    leaves = []
    for info, spec in zip(layout, specs):
        if rank == 0:
            raw = torch.from_numpy(np.array(ckpt._read(info, rec), dtype=np.uint8)).to(device)
        else:
            raw = torch.empty((info.size,), dtype=torch.uint8, device=device)
        if dist.is_initialized():
            dist.broadcast(raw, src=0)
        full = raw.view(getattr(torch, info.dtype)).reshape(info.shape)  # dtype names are torch's
        # a block is a view: copy it, so that the full leaf is freed
        leaves.append(shard_leaf(full, spec, axis_info).clone() if len(spec) else full)
    return _unflatten(structure, leaves)
