"""Difference imaging on the device: the sky's transient detector.

:func:`detect_transients_batched` finds, for a batch of regions at once,
what :func:`repro_torch.data.sky.detect_transients` (numpy, its plain
version) finds region by region: the pixels whose brightness grew by more
than ``threshold`` between two frames, as ``(x, y, value)`` in the
row-major order ``np.where`` gives. :class:`DeviceDetector` is one detector
session's path from its ``readv`` windows onto the device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

Hit = Tuple[int, int, float]


def detect_transients_batched(
    before: torch.Tensor, after: torch.Tensor, threshold: float
) -> List[List[Hit]]:
    """``(R, px, px)`` f32 frames on any device; returns, per region, its
    ``(x, y, value)`` hits in row-major order."""
    return per_region(hit_rows(before, after, threshold).cpu(), before.shape[0])


def hit_rows(before: torch.Tensor, after: torch.Tensor, threshold: float) -> torch.Tensor:
    """The hits as an ``(n, 4)`` f64 tensor on the frames' device: region,
    y, x (row-major order) and the f32 value, all exact in f64, so one copy
    takes them to the host. The difference and the comparison are f32, as
    numpy's are (the threshold is rounded to f32 once, as numpy rounds a
    Python float against an f32 array). One ``nonzero`` for the whole batch:
    one host sync per frame pair."""
    diff = after - before
    hits = (diff > torch.full((), threshold, dtype=diff.dtype, device=diff.device)).nonzero()
    values = diff[hits[:, 0], hits[:, 1], hits[:, 2]]
    return torch.cat((hits.to(torch.float64), values.to(torch.float64)[:, None]), 1)


def per_region(rows: torch.Tensor, n_regions: int) -> List[List[Hit]]:
    out: List[List[Hit]] = [[] for _ in range(n_regions)]
    for r, y, x, v in rows.tolist():
        out[int(r)].append((int(x), int(y), v))
    return out


class DeviceDetector:
    """One detector session's frames on the device.

    The ``readv`` windows are read-only ``uint8`` arrays in pageable memory
    (``torch.from_numpy`` warns on them), so the first ``px * px * 4`` bytes
    of each are copied once into a staging buffer, pinned on a card, that
    goes to the device in one asynchronous copy on the detector's own
    stream: one detector's copy does not queue behind another's. On a card
    each frame pair records three events on that stream (before the copy,
    after it, after the detection) in ``spans``."""

    def __init__(self, n_regions: int, region_px: int, device) -> None:
        self.device = torch.device(device)
        on_card = self.device.type == "cuda"
        self.staging = torch.empty((2, n_regions, region_px, region_px), dtype=torch.float32,
                                   pin_memory=on_card)
        self._bytes = self.staging.numpy().reshape(2, n_regions, -1).view(np.uint8)
        self.stream = torch.cuda.Stream(self.device) if on_card else None
        self.spans: List[Tuple[torch.cuda.Event, ...]] = []
        #: the device of the last frame pair's tensors
        self.tensor_device = None

    def detect(self, before: Sequence[np.ndarray], after: Sequence[np.ndarray],
               threshold: float) -> List[List[Hit]]:
        nbytes = self._bytes.shape[2]
        for f, windows in enumerate((before, after)):
            for i, w in enumerate(windows):
                self._bytes[f, i] = w[:nbytes]
        with torch.cuda.stream(self.stream):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if self.stream else []
            if events:
                events[0].record()
            frames = self.staging.to(self.device, non_blocking=True)
            if events:
                events[1].record()
            self.tensor_device = frames.device
            rows = hit_rows(frames[0], frames[1], threshold)
            if events:
                events[2].record()
                self.spans.append(tuple(events))
            rows = rows.cpu()
        return per_region(rows, len(before))
