"""Synthetic telescope sky (the paper's application, §I).

The sky is a grid of ``region`` images concatenated into one global blob (the
paper's "very long string of bytes obtained by concatenating the images in
binary form"). Each observation epoch produces a new *version* of the blob:
regions are re-imaged with photon noise, and occasionally a supernova ignites
— a transient brightness spike following a simple light curve.

``SkySimulator.observe_epoch`` WRITEs the updated regions (fine-grain patches,
one per region — concurrent telescope writers are threads); detection code
READs two versions of a region and difference-images them.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import BlobHandle, Session


@dataclasses.dataclass(frozen=True)
class SkyLayout:
    n_regions: int = 64
    region_px: int = 64  # region is region_px × region_px float32 pixels
    page_size: int = 4096

    @property
    def region_bytes(self) -> int:
        raw = self.region_px * self.region_px * 4
        return -(-raw // self.page_size) * self.page_size  # page-aligned

    @property
    def blob_bytes(self) -> int:
        total = self.n_regions * self.region_bytes
        return 1 << (total - 1).bit_length()  # power of two (paper §II)


@dataclasses.dataclass
class Supernova:
    region: int
    x: int
    y: int
    ignite_epoch: int
    peak: float


class SkySimulator:
    """Generates epochs of the sky into the blob store through one writer
    :class:`Session` (the telescope client)."""

    def __init__(self, session: Session, layout: SkyLayout = SkyLayout(), seed: int = 0,
                 sn_rate: float = 0.05) -> None:
        self.session = session
        self.layout = layout
        self.rng = np.random.default_rng(seed)
        self.sn_rate = sn_rate
        self.handle: BlobHandle = session.create(layout.blob_bytes, layout.page_size)
        self.blob_id = self.handle.blob_id
        # static star field per region
        self._stars: List[np.ndarray] = [
            self._star_field() for _ in range(layout.n_regions)
        ]
        self.supernovae: List[Supernova] = []
        self.epoch = 0

    def _star_field(self) -> np.ndarray:
        px = self.layout.region_px
        img = np.zeros((px, px), np.float32)
        n_stars = int(self.rng.integers(8, 24))
        xs = self.rng.integers(0, px, n_stars)
        ys = self.rng.integers(0, px, n_stars)
        mag = self.rng.uniform(50, 400, n_stars).astype(np.float32)
        img[ys, xs] = mag
        return img

    def _light_curve(self, sn: Supernova, epoch: int) -> float:
        dt = epoch - sn.ignite_epoch
        if dt < 0:
            return 0.0
        rise, decay = 1.0, 6.0
        return sn.peak * min(dt / rise, 1.0) * np.exp(-max(dt - rise, 0) / decay)

    def region_image(self, region: int, epoch: int) -> np.ndarray:
        img = self._stars[region].copy()
        for sn in self.supernovae:
            if sn.region == region:
                img[sn.y, sn.x] += self._light_curve(sn, epoch)
        noise = self.rng.normal(0, 1.0, img.shape).astype(np.float32)
        return img + noise

    def _maybe_ignite(self) -> None:
        if self.rng.random() < self.sn_rate * self.layout.n_regions / 8:
            px = self.layout.region_px
            self.supernovae.append(
                Supernova(
                    region=int(self.rng.integers(self.layout.n_regions)),
                    x=int(self.rng.integers(px)),
                    y=int(self.rng.integers(px)),
                    ignite_epoch=self.epoch,
                    peak=float(self.rng.uniform(300, 900)),
                )
            )

    def _region_patch(self, r: int) -> np.ndarray:
        img = self.region_image(r, self.epoch)
        buf = np.zeros(self.layout.region_bytes, np.uint8)
        raw = img.tobytes()
        buf[: len(raw)] = np.frombuffer(raw, np.uint8)
        return buf

    def observe_epoch_stream(self) -> int:
        """Stream one epoch's region patches through the session's bounded
        ``write_async`` window (overlapped write pipelines, backpressure once
        the window fills) and join it; returns the epoch's published version.
        This is the telescope as the paper means it: a producer that never
        stops imaging to wait for the previous frame's metadata round-trip."""
        self.epoch += 1
        self._maybe_ignite()
        for r in range(self.layout.n_regions):
            self.handle.write_async(self._region_patch(r), r * self.layout.region_bytes)
        self.session.flush()
        return self.handle.latest_published()

    def observe_epoch(self, concurrent: bool = True) -> int:
        """Image every region and WRITE the patches; returns the published
        version of this epoch. Telescopes (threads) write concurrently."""
        self.epoch += 1
        self._maybe_ignite()

        def write_region(r: int) -> None:
            img = self.region_image(r, self.epoch)
            buf = np.zeros(self.layout.region_bytes, np.uint8)
            raw = img.tobytes()
            buf[: len(raw)] = np.frombuffer(raw, np.uint8)
            self.handle.write(buf, r * self.layout.region_bytes)

        if concurrent:
            threads = [
                threading.Thread(target=write_region, args=(r,))
                for r in range(self.layout.n_regions)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for r in range(self.layout.n_regions):
                write_region(r)
        return self.handle.latest_published()

    def read_region(self, region: int, version: Optional[int] = None) -> np.ndarray:
        px = self.layout.region_px
        res = self.handle.read(
            region * self.layout.region_bytes, px * px * 4, version=version
        )
        return np.frombuffer(res.data.tobytes(), np.float32).reshape(px, px)


def detect_transients(
    before: np.ndarray, after: np.ndarray, threshold: float = 100.0
) -> List[Tuple[int, int, float]]:
    """Difference imaging: pixels that brightened by more than ``threshold``."""
    diff = after - before
    ys, xs = np.where(diff > threshold)
    return [(int(x), int(y), float(diff[y, x])) for x, y in zip(xs, ys)]
