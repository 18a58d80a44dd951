"""The paper's application on the device: supernova detection over the
versioned sky blob, the counterpart of ``examples/supernovae.py``.

One :class:`Cluster` models the deployment. A writer session (the
telescope) streams each epoch's region images through ``write_async`` while
N detector sessions, woken by ``handle.watch()`` when a frame finishes
publishing (version ``epoch * n_regions``), pin the frame pair with two
snapshots, read their regions' overlapping windows with ``readv`` and
difference-image the pair on the device (:mod:`repro_torch.data.detect`).
A publish-driven warmer pulls each fresh frame into the shared cache tier.

    PYTHONPATH=src python -m repro_torch.launch.supernovae --smoke --device cpu

``--smoke`` is the example's deployment (32 regions of 64 px, 4 KiB pages).
The default is the paper's (``configs/paper_sky.py``): 64 KiB pages, 20 data
and 20 metadata providers, regions of ``segment_max`` (16 MiB, 2048 x 2048
f32) and one epoch the 1 GiB hot window (64 regions), read by 8 detector
sessions. The blob's logical size follows from the regions written (1 GiB,
not the paper's 1 TB). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_sky import CONFIG
from repro_torch.core import Cluster
from repro_torch.data.detect import DeviceDetector
from repro_torch.data.sky import SkyLayout, SkySimulator

WATCH_TIMEOUT_S = 60.0
# the example's application parameters, the same in every deployment
SEED, SN_RATE, THRESHOLD, MAX_WORKERS = 7, 0.2, 150.0, 32


@dataclasses.dataclass(frozen=True)
class Deployment:
    n_regions: int
    region_px: int
    page_size: int
    n_data_providers: int
    n_metadata_providers: int
    shared_cache_bytes: int
    warm_pages: int  # the frame warmer's ``top_pages``
    n_detectors: int
    epochs: int

    @classmethod
    def smoke(cls) -> "Deployment":
        """The numbers of ``examples/supernovae.py``."""
        return cls(n_regions=32, region_px=64, page_size=4096, n_data_providers=8,
                   n_metadata_providers=8, shared_cache_bytes=256 << 20, warm_pages=256,
                   n_detectors=4, epochs=8)

    @classmethod
    def paper(cls) -> "Deployment":
        """One region per ``segment_max`` segment, one epoch per hot window;
        the shared tier holds three frames (the pair being compared and the
        one being warmed), and the warmer pulls a whole frame. Eight epochs
        (seven frame pairs) take about 80 s of the telescope."""
        return cls(n_regions=CONFIG.hot_interval // CONFIG.segment_max,
                   region_px=math.isqrt(CONFIG.segment_max // 4), page_size=CONFIG.page_size,
                   n_data_providers=CONFIG.n_data_providers,
                   n_metadata_providers=CONFIG.n_metadata_providers,
                   shared_cache_bytes=3 * CONFIG.hot_interval,
                   warm_pages=CONFIG.hot_interval // CONFIG.page_size, n_detectors=8, epochs=8)


def busy_ms(spans: Sequence[Sequence[float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def run(smoke: bool = False, *, device="cuda", on_pair: Optional[Callable] = None) -> dict:
    """Run the application; returns the ground truth, the detections, the
    store's counters and the timings. ``on_pair(detector, epoch, regions,
    before, after, hits)`` is called in the detector's thread after each
    frame pair, with the ``readv`` windows and the device's hits."""
    dev = resolve_device(device)
    dep = Deployment.smoke() if smoke else Deployment.paper()
    layout = SkyLayout(n_regions=dep.n_regions, region_px=dep.region_px, page_size=dep.page_size)
    n, px, n_det = dep.n_regions, dep.region_px, dep.n_detectors
    img_bytes = px * px * 4
    # overlapping windows: each spills one page into the next region
    windows = [(r * layout.region_bytes, img_bytes + layout.page_size) for r in range(n)]

    cluster = Cluster(n_data_providers=dep.n_data_providers,
                      n_metadata_providers=dep.n_metadata_providers,
                      max_workers=MAX_WORKERS, shared_cache_bytes=dep.shared_cache_bytes)
    try:
        writer = cluster.session(max_inflight_writes=8)
        sim = SkySimulator(writer, layout, seed=SEED, sn_rate=SN_RATE)
        warmer = cluster.warm_on_publish(sim.blob_id, top_pages=dep.warm_pages, frame_versions=n)
        print(f"sky blob: {n} regions of {px}x{px} f32, {layout.page_size >> 10} KiB pages, "
              f"{layout.blob_bytes >> 20} MiB logical; 1 telescope session + {n_det} detector "
              f"sessions on {dev} + 1 frame warmer")

        sessions = [cluster.session(cache_bytes=0) for _ in range(n_det)]
        shares = [list(range(k, n, n_det)) for k in range(n_det)]
        detectors = [DeviceDetector(len(shares[k]), px, dev) for k in range(n_det)]
        detections: Dict[int, list] = {}
        pairs: List[dict] = []
        first_reads = [[0, 0] for _ in range(n_det)]
        lock = threading.Lock()
        failures: List[BaseException] = []

        def detector(k: int) -> None:
            try:
                session, regions = sessions[k], shares[k]
                handle = session.open(sim.blob_id)
                watch = handle.watch(start_version=0)
                segs = [windows[r] for r in regions]
                for epoch in range(2, dep.epochs + 1):
                    target = epoch * n  # frame `epoch` fully published
                    while True:
                        v = watch.next(timeout=WATCH_TIMEOUT_S)
                        if v is None:
                            raise RuntimeError(f"detector {k}: writer stalled before v{target}")
                        if v >= target:
                            break
                    woke = time.perf_counter()
                    # two pinned snapshots: the pair is immune to the writer and to GC
                    before, after = handle.at(target - n), handle.at(target)
                    try:
                        before_w = before.readv(segs)
                        h0, m0 = session.stats.cache_hits, session.stats.cache_misses
                        after_w = after.readv(segs)  # the fresh frame: warmer territory
                        first_reads[k][0] += session.stats.cache_hits - h0
                        first_reads[k][1] += session.stats.cache_misses - m0
                    finally:
                        before.release()
                        after.release()
                    read = time.perf_counter()
                    hits = detectors[k].detect(before_w, after_w, THRESHOLD)
                    done = time.perf_counter()
                    with lock:
                        pairs.append(dict(detector=k, epoch=epoch, woke=woke, read_s=read - woke, done=done,
                                          bytes=2 * sum(size for _, size in segs)))
                        for r, h in zip(regions, hits):
                            if h:
                                detections.setdefault(epoch, []).append((r, h))
                    if on_pair is not None:
                        on_pair(k, epoch, regions, before_w, after_w, hits)
            except Exception as e:  # reported by the caller's thread after the join
                failures.append(e)

        on_card = dev.type == "cuda"
        if on_card:
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
        t_start = time.perf_counter()
        threads = [threading.Thread(target=detector, args=(k,), daemon=True) for k in range(n_det)]
        for t in threads:
            t.start()
        # the telescope streams every epoch WHILE the detectors compare earlier frames
        writes = []
        for epoch in range(1, dep.epochs + 1):
            t0 = time.perf_counter()
            v = sim.observe_epoch_stream()
            t1 = time.perf_counter()
            writes.append(dict(epoch=epoch, version=v, published=t1, write_s=t1 - t0,
                               bytes=n * layout.region_bytes))
            print(f"epoch {epoch}: published v{v} in {(t1 - t0) * 1e3:.1f} ms "
                  f"({n * layout.region_bytes / (t1 - t0) / 1e6:.1f} MB/s; "
                  f"{cluster.metadata.total_nodes()} metadata nodes, "
                  f"{cluster.storage_bytes() >> 20} MiB stored)", flush=True)
        for t in threads:
            t.join()
        if failures:
            raise failures[0]
        wall_s = time.perf_counter() - t_start
        device_spans = []
        if on_card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            for k, det in enumerate(detectors):
                for epoch, (e0, e1, e2) in enumerate(det.spans, start=2):
                    device_spans.append(dict(detector=k, epoch=epoch, start_ms=ref.elapsed_time(e0),
                                             copied_ms=ref.elapsed_time(e1), done_ms=ref.elapsed_time(e2)))
            span_ms = ref.elapsed_time(end)

        truth = [(sn.region, sn.x, sn.y, sn.ignite_epoch) for sn in sim.supernovae]
        found = sorted({(r, x, y) for hits in detections.values() for r, hs in hits for x, y, _ in hs})
        print(f"ground truth supernovae: {truth}")
        print(f"detected transients:    {found}")
        recovered = {t[:3] for t in truth} & set(found)
        print(f"recovered {len(recovered)}/{len(truth)} supernovae")

        # a frame is published when its writer returns or a detector wakes on it, whichever is first
        published = {w["epoch"]: w["published"] for w in writes}
        for p in pairs:
            published[p["epoch"]] = min(published[p["epoch"]], p["woke"])
        latency_ms = {e: (max(p["done"] for p in pairs if p["epoch"] == e) - published[e]) * 1e3
                      for e in range(2, dep.epochs + 1)}
        per_detector = []
        for k, s in enumerate(sessions):
            mine = [p for p in pairs if p["detector"] == k]
            read_s = sum(p["read_s"] for p in mine)
            nbytes = sum(p["bytes"] for p in mine)
            per_detector.append(dict(read_bytes=nbytes, read_ms=read_s * 1e3, read_MBps=nbytes / read_s / 1e6,
                                     hit_rate=s.cache_hit_rate,
                                     first_read_hit_rate=first_reads[k][0] / max(sum(first_reads[k]), 1)))
        c_hits = sum(s.stats.cache_hits for s in sessions)
        c_misses = sum(s.stats.cache_misses for s in sessions)
        f_hits, f_misses = sum(f[0] for f in first_reads), sum(f[1] for f in first_reads)
        store = dict(storage_bytes=cluster.storage_bytes(), data_rounds=cluster.stats.data_rounds,
                     cache_hits=c_hits, cache_misses=c_misses, hit_rate=c_hits / max(c_hits + c_misses, 1),
                     first_read_hits=f_hits, first_read_misses=f_misses,
                     first_read_hit_rate=f_hits / max(f_hits + f_misses, 1),
                     pages_warmed=warmer.pages_warmed, frames_warmed=len(warmer.warmed_versions()))
        print(f"shared cache tier, over {n_det} detector sessions: {c_hits} hits / {c_misses} misses "
              f"({store['hit_rate']:.0%}), {store['data_rounds']} provider RPC rounds; frame warmer "
              f"{store['pages_warmed']} pages over {store['frames_warmed']} frames, first reads "
              f"{store['first_read_hit_rate']:.0%} warm")
        out = dict(deployment=dataclasses.asdict(dep),
                   detector_device=sorted({d.tensor_device.type for d in detectors}),
                   truth=truth, detections=detections, found=found, recovered=len(recovered),
                   writes=[{k: w[k] for k in ("epoch", "version", "write_s", "bytes")} for w in writes],
                   pairs=[{k: p[k] for k in ("detector", "epoch", "read_s", "bytes")}
                          for p in sorted(pairs, key=lambda p: (p["epoch"], p["detector"]))],
                   latency_ms=latency_ms, per_detector=per_detector,
                   aggregate_read_MBps=sum(d["read_MBps"] for d in per_detector),
                   store=store, wall_s=wall_s, device_spans=device_spans, span_ms=None, busy_ms=None)
        if on_card:
            out.update(span_ms=span_ms, busy_ms=busy_ms([(s["start_ms"], s["done_ms"]) for s in device_spans]))
        return out
    finally:
        cluster.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="the example's small deployment")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.smoke, device=args.device)
    for k, d in enumerate(out["per_detector"]):
        print(f"  detector {k}: read {d['read_MBps']:.1f} MB/s, hit rate {d['hit_rate']:.0%}, "
              f"first-read hit rate {d['first_read_hit_rate']:.0%}")
    lat = sorted(out["latency_ms"].values())
    print(f"aggregate read {out['aggregate_read_MBps']:.1f} MB/s; detection latency p50 "
          f"{float(np.median(lat)):.1f} ms, max {lat[-1]:.1f} ms")


if __name__ == "__main__":
    main()
