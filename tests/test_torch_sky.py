"""The port's sky application against the JAX package's, in one process.

The telescope (``SkySimulator`` on a ``Cluster``) writes the same sky in
both packages from the same seed; the port's difference imaging
(``repro_torch.data.detect``, on the CPU here) finds exactly what numpy's
``detect_transients`` finds; ``flatten`` and the deprecated ``BlobStore``
agree across packages; ``python -m repro_torch.launch.supernovae --smoke``
finds what ``examples/supernovae.py`` finds; and ``chip_smoke.py``'s step 13
rehearses at the example's size. Every comparison uses the sequential
``observe_epoch_stream``: ``observe_epoch(concurrent=True)`` draws noise
from one generator in threads, in an order that changes from run to run.
"""

import importlib.util
import os
import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.data.sky as jsky  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data.sky as tsky  # noqa: E402
from repro_torch.data.detect import DeviceDetector, detect_transients_batched  # noqa: E402
from repro_torch.launch import supernovae  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = [(jcore, jsky), (tcore, tsky)]


def observe(core, sky, layout, epochs, sn_rate, seed=7):
    """A cluster, its simulator and every frame's version after ``epochs``
    streamed epochs; the caller closes the cluster."""
    cluster = core.Cluster(n_data_providers=4, n_metadata_providers=4)
    sim = sky.SkySimulator(cluster.session(max_inflight_writes=8), layout, seed=seed, sn_rate=sn_rate)
    versions = [sim.observe_epoch_stream() for _ in range(epochs)]
    return cluster, sim, versions


# ------------------------------ (i) the same sky ------------------------------
# sn_rate * n_regions / 8 is an epoch's chance of a supernova: 0.8, then 1
@pytest.mark.parametrize("n_regions,region_px,page_size,sn_rate", [(32, 64, 4096, 0.2), (8, 256, 64 << 10, 1.0)])
def test_both_telescopes_write_the_same_sky(n_regions, region_px, page_size, sn_rate):
    runs = []
    for core, sky in PACKAGES:
        layout = sky.SkyLayout(n_regions=n_regions, region_px=region_px, page_size=page_size)
        cluster, sim, versions = observe(core, sky, layout, 4, sn_rate)
        try:
            frames = [[sim.read_region(r, v).copy() for r in range(n_regions)] for v in versions]
            runs.append(([(s.region, s.x, s.y, s.ignite_epoch, s.peak) for s in sim.supernovae],
                         versions, frames))
        finally:
            cluster.close()
    (jtruth, jversions, jframes), (truth, versions, frames) = runs
    assert truth == jtruth and len(truth) >= 2
    assert versions == jversions == [e * n_regions for e in range(1, 5)]
    for jframe, frame in zip(jframes, frames):
        for j, t in zip(jframe, frame):
            assert t.tobytes() == j.tobytes()


# ------------------------------ (ii) the detector ------------------------------
def planted(rng, R=6, px=48, threshold=150.0):
    """Noise frames with planted brightenings (at R = 6: regions 1 and 4
    empty, region 3 crowded); a diff exactly at the threshold, one a float32
    step above it, and dimmed pixels (negative diffs)."""
    before = rng.normal(0, 20, (R, px, px)).astype(np.float32)
    after = before + rng.normal(0, 1, (R, px, px)).astype(np.float32)
    for r, n in ((0, 3), (2, 1), (3, 400), (5, 12))[: R - 3]:
        ys, xs = rng.integers(0, px, n), rng.integers(0, px, n)
        after[r, ys, xs] = before[r, ys, xs] + rng.uniform(200, 900, n).astype(np.float32)
    t = np.float32(threshold)
    before[0, 1, 2], after[0, 1, 2] = 0, t  # exactly the threshold: not a hit
    before[0, 2, 2], after[0, 2, 2] = 0, np.nextafter(t, np.float32(np.inf))
    after[R - 1, 7, 7] = before[R - 1, 7, 7] - 600  # dimmed
    after[2, 0, 0] = before[2, 0, 0] - 300
    return before, after


@pytest.mark.parametrize("threshold", [150.0, 100.1])  # 100.1 has no float32 of its own
def test_batched_detector_matches_numpy_region_by_region(threshold):
    before, after = planted(np.random.default_rng(0), threshold=threshold)
    if threshold != 150.0:  # diffs either side of the float32 rounding of 100.1
        t = np.float32(threshold)
        before[2, 3, 3], after[2, 3, 3] = 0, t
        before[2, 3, 4], after[2, 3, 4] = 0, np.nextafter(t, np.float32(0))
        before[2, 3, 5], after[2, 3, 5] = 0, np.nextafter(t, np.float32(np.inf))
    want = [jsky.detect_transients(b, a, threshold=threshold) for b, a in zip(before, after)]
    got = detect_transients_batched(torch.from_numpy(before), torch.from_numpy(after), threshold)
    assert got == want
    assert not got[1] and not got[4] and len(got[3]) > 300
    assert all(type(v) is float and type(x) is int for hits in got for x, _, v in hits)


def test_device_detector_reads_windows_as_numpy_does():
    """Read-only ``uint8`` windows with a spill page, as ``readv`` returns
    them: the detector takes each window's first ``px * px * 4`` bytes."""
    before, after = planted(np.random.default_rng(1), R=3, px=32)
    page = 4096

    def windows(frames):
        out = []
        for img in frames:
            w = np.full(img.nbytes + page, 0xFF, np.uint8)  # the spill page must not be read
            w[: img.nbytes] = img.reshape(-1).view(np.uint8)
            w.flags.writeable = False
            out.append(w)
        return out

    det = DeviceDetector(3, 32, "cpu")
    want = [jsky.detect_transients(b, a, threshold=150.0) for b, a in zip(before, after)]
    for _ in range(2):  # the staging buffer is reused
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert det.detect(windows(before), windows(after), 150.0) == want
    assert det.tensor_device.type == "cpu" and det.stream is None and det.spans == []


# ------------------------------ (iii) flatten ------------------------------
def test_flatten_agrees_across_packages():
    n_pages, page = 64, 4096
    rng = np.random.default_rng(3)
    patches = [(rng.integers(0, n_pages - 4), rng.integers(1, 5)) for _ in range(12)]
    data = [rng.integers(0, 256, k * page, dtype=np.uint8) for _, k in patches]
    views = []
    for core, _ in PACKAGES:
        cluster = core.Cluster(n_data_providers=3, n_metadata_providers=3)
        try:
            handle = cluster.session().create(n_pages * page, page)
            versions = [handle.write(d.copy(), int(p) * page) for (p, _), d in zip(patches, data)]
            flat = [core.flatten(cluster, handle.blob_id, v, 0, n_pages) for v in (versions[3], versions[-1])]
            pages = [[cluster.provider_manager.get_provider(int(pid)).get_page(int(key)).tobytes()
                      if pid != core.ZERO_PAGE else None for pid, key in zip(f.provider_ids, f.page_keys)]
                     for f in flat]
            with pytest.raises(ValueError, match="not yet published"):
                core.flatten(cluster, handle.blob_id, versions[-1] + 1, 0, n_pages)
            views.append((flat, pages))
        finally:
            cluster.close()
    (jflat, jpages), (tflat, tpages) = views
    for j, t, jp, tp in zip(jflat, tflat, jpages, tpages):
        assert (t.version, t.first_page, t.n_pages) == (j.version, j.first_page, j.n_pages) == (t.version, 0, n_pages)
        assert np.array_equal(t.provider_ids == tcore.ZERO_PAGE, j.provider_ids == jcore.ZERO_PAGE)
        assert 0 < int((t.provider_ids != tcore.ZERO_PAGE).sum()) < n_pages
        # sequential writes on the least-loaded heap: placement is deterministic
        assert np.array_equal(t.provider_ids, j.provider_ids) and np.array_equal(t.page_keys, j.page_keys)
        assert tp == jp


# ------------------------------ (iv) the BlobStore facade ------------------------------
def test_blob_store_facade_agrees_and_warns():
    page = 4096
    rng = np.random.default_rng(4)
    bufs = [rng.integers(0, 256, k * page, dtype=np.uint8) for k in (1, 3, 2)]
    out = []
    for core, _ in PACKAGES:
        with pytest.warns(DeprecationWarning, match="BlobStore is deprecated"):
            store = core.BlobStore(n_data_providers=2, n_metadata_providers=2)
        try:
            blob = store.alloc(16 * page, page)
            versions = [store.write(blob, b.copy(), off * page) for b, off in zip(bufs, (0, 5, 1))]
            reads = [store.read(blob, v, 0, 16 * page).data.tobytes() for v in versions]
            segs = store.readv(blob, versions[1], [(page, 3 * page), (5 * page + 17, 100)])
            out.append((versions, reads, [s.tobytes() for s in segs], store.storage_bytes()))
        finally:
            store.close()
    assert out[0] == out[1]


# ------------------------------ (v)-(vi) the launcher ------------------------------
def printed(text, prefix):
    (line,) = [ln for ln in text.splitlines() if ln.strip().startswith(prefix)]
    return line.strip()


def test_smoke_launcher_finds_what_the_example_finds(capsys):
    example = subprocess.run([sys.executable, str(ROOT / "examples" / "supernovae.py")], capture_output=True,
                             text=True, timeout=300, cwd=ROOT,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"})
    assert example.returncode == 0, example.stderr
    res = supernovae.run(smoke=True, device="cpu")
    text = capsys.readouterr().out
    for prefix in ("ground truth supernovae:", "detected transients:", "recovered"):
        assert printed(text, prefix) == printed(example.stdout, prefix)
    assert res["truth"] == [(3, 30, 22, 3), (7, 6, 25, 4), (26, 59, 59, 5), (10, 34, 14, 8)]
    assert res["found"] == [(3, 30, 22), (7, 6, 25), (26, 59, 59)] and res["recovered"] == 3
    assert res["detector_device"] == ["cpu"] and res["device_spans"] == [] and res["busy_ms"] is None
    assert len(res["pairs"]) == 4 * 7 and sorted(res["latency_ms"]) == list(range(2, 9))
    assert res["store"]["first_read_hits"] + res["store"]["first_read_misses"] > 0


def test_launcher_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        supernovae.run(smoke=True, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        supernovae.main(["--smoke"])


def test_paper_deployment_is_the_paper_config():
    from repro_torch.configs.paper_sky import CONFIG

    dep = supernovae.Deployment.paper()
    assert (dep.n_regions, dep.region_px, dep.page_size, dep.n_data_providers, dep.n_metadata_providers,
            dep.n_detectors) == (64, 2048, 64 << 10, 20, 20, 8)
    layout = tsky.SkyLayout(n_regions=dep.n_regions, region_px=dep.region_px, page_size=dep.page_size)
    assert layout.region_bytes == CONFIG.segment_max and layout.blob_bytes == CONFIG.hot_interval
    assert dep.epochs >= 5


@pytest.mark.parametrize("spans,want", [([], 0.0), ([(0, 1), (2, 3)], 2.0), ([(0, 2), (1, 3), (5, 6)], 4.0),
                                        ([(1, 5), (2, 3), (0, 1)], 5.0)])
def test_busy_ms_is_the_union_of_spans(spans, want):
    assert supernovae.busy_ms(spans) == want


# ------------------------------ (vii) chip_smoke.py's step 13 ------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class FakeEvent:
    def __init__(self, **_):
        pass

    def record(self, *_):
        pass

    def elapsed_time(self, _):
        return 1.0


def stub_card(monkeypatch, cs):
    for name, fn in (("reset_peak_memory_stats", lambda *a, **k: None), ("max_memory_allocated", lambda *a, **k: 0),
                     ("synchronize", lambda *a, **k: None), ("Event", FakeEvent)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(cs, "SKY_DEVICE_TYPE", "cpu")


def test_chip_smoke_sky_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    cs = _chip_smoke()
    stub_card(monkeypatch, cs)
    kernels = (SimpleNamespace(launches=5), SimpleNamespace(launches=5))
    out = cs.sky_phase(torch.device("cpu"), "a card, 700.00 W", kernels, smoke=True)
    assert out["launches"] == {"flash_attention": 0, "paged_attention": 0}
    assert out["found"] == [(3, 30, 22), (7, 6, 25), (26, 59, 59)]
    assert len(out["write_MBps"]) == 8 and len(out["read_MBps"]) == 4 and out["busy_share"] is None
    assert all(p["h2d_ms"] is None for p in out["pairs"].values())
    pair_bytes = 2 * 32 * 64 * 64 * 4
    assert out["replay"] == dict(device_ms=0.1, bytes=pair_bytes, bound_ms=pair_bytes / cs.HBM_BYTES_PER_S * 1e3,
                                 bound_by="bytes", calls=4)
    assert "frame pair (7, 8) on a card, 700.00 W" in capsys.readouterr().out


def test_chip_smoke_sky_phase_fails_on_a_wrong_detection(monkeypatch):
    """A detector that misses the last hit of each region must fail check (a)."""
    cs = _chip_smoke()
    stub_card(monkeypatch, cs)
    detect = DeviceDetector.detect
    monkeypatch.setattr(DeviceDetector, "detect", lambda self, *a: [h[:-1] for h in detect(self, *a)])
    with pytest.raises(SystemExit):
        cs.sky_phase(torch.device("cpu"), "a card", (SimpleNamespace(launches=0),) * 2, smoke=True)


def test_chip_smoke_sky_pair_times_from_device_spans():
    cs = _chip_smoke()
    dep = dict(n_regions=4, region_px=8, epochs=3)
    spans = [dict(detector=k, epoch=e, start_ms=10.0 * e + k, copied_ms=10.0 * e + k + 2, done_ms=10.0 * e + k + 2.5)
             for e in (2, 3) for k in (0, 1)]
    rows = cs.sky_pair_times({"deployment": dep, "device_spans": spans})
    pair_bytes = 2 * 4 * 8 * 8 * 4
    assert rows[2] == rows[3] == dict(bytes=pair_bytes, h2d_ms=4.0, h2d_GBps=pair_bytes / 4.0 / 1e6, stream_ms=1.0)
