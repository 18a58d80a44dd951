"""The port's federation (``repro_torch.core.federation``) against the JAX
package's, in one process.

(a) every test of ``tests/test_federation.py``, run against
``repro_torch.core``; (c) one deterministic single-threaded federated
scenario through both packages, with equal bytes, counters and cached
versions; (f) the GC sweep's self-deadlock, reproduced on the port, where
it no longer hangs (the JAX package's copy still does, so it is not run
into it here); (g) ``chip_smoke.py``'s step 14 at the example's deployment
on the CPU. Every thread is a daemon joined against a deadline that fails
the test.
"""

import contextlib
import faulthandler
import importlib.util
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.launch.supernovae import Deployment  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PAGE, PAGES = 256, 8
DEADLINE_S = 10.0


def _port_of(test_file: str, name: str):
    """``tests/<test_file>`` with its ``repro.core`` imports pointed at
    ``repro_torch.core``: the same tests, run against the port."""
    source = (ROOT / "tests" / test_file).read_text()
    ported = source.replace("from repro.core", "from repro_torch.core")
    assert "repro." not in ported.replace("repro_torch.", "")
    module = type(sys)(name)
    module.__file__ = str(ROOT / "tests" / test_file)
    exec(compile(ported, module.__file__, "exec"), module.__dict__)
    return module


FEDERATION_TESTS = _port_of("test_federation.py", "test_federation_on_the_port")
NAMES = sorted(n for n in vars(FEDERATION_TESTS) if n.startswith("test_"))


def test_the_ported_federation_tests_run_the_port():
    assert len(NAMES) == (ROOT / "tests" / "test_federation.py").read_text().count("\ndef test_") == 14
    assert FEDERATION_TESTS.Federation is tcore.Federation
    assert FEDERATION_TESTS.GcEpochCoordinator is tcore.GcEpochCoordinator


# ------------------------------ (a) tests/test_federation.py on the port ------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_federation_test_on_the_port(name):
    getattr(FEDERATION_TESTS, name)()


class FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def make_fed(core, clock, n_nodes=2, **kw):
    return core.Federation(
        n_nodes=n_nodes, n_data_providers=4, n_metadata_providers=4, max_workers=2,
        lease_seconds=10.0, clock=clock,
        retry_policy=core.RetryPolicy(max_attempts=1, sleep=clock.advance),
        health=core.HealthConfig(dead_after=100, window_seconds=1e9, clock=clock), **kw)


def fill(value, n_bytes=PAGE * PAGES):
    return np.full(n_bytes, value, np.uint8)


class Hung(AssertionError):
    """A thread outlived its deadline. It may hold locks that closing what
    it ran on would wait for, so that is left open (see ``unless_hung``)."""


@contextlib.contextmanager
def unless_hung(close):
    """Call ``close`` on the way out, unless a thread hung."""
    try:
        yield
    except Hung:
        raise
    except BaseException:
        close()
        raise
    close()


def run_daemon(target, what):
    """``target`` in a daemon thread that must end within the deadline;
    returns what it returned (or raises what it raised)."""
    out = []

    def body():
        try:
            out.append((True, target()))
        except Exception as e:  # re-raised in the test's thread
            out.append((False, e))

    t = threading.Thread(target=body, name=what, daemon=True)
    t.start()
    t.join(DEADLINE_S)
    if t.is_alive():
        faulthandler.dump_traceback(all_threads=True)
        raise Hung(f"{what} still running after {DEADLINE_S} s: a hang (stacks on stderr)")
    ok, value = out[0]
    if not ok:
        raise value
    return value


# ------------------------------ (c) one federated scenario, both packages ------------------------------
def scenario(core):
    """Write on node 0, read on nodes 1-3, kill node 3, partition node 1,
    GC, probe node 1, recover both, read again: everything on one thread
    and a fake clock, so both packages must agree exactly."""
    clock = FakeClock()
    fed = make_fed(core, clock, n_nodes=4, page_replication=2)
    try:
        h0 = fed.nodes[0].session().create(PAGE * PAGES, PAGE)
        blob = h0.blob_id
        v1 = h0.write(fill(1), 0)
        v2 = h0.write(fill(2, PAGE * 4), PAGE * 2)
        readers = [fed.nodes[i].session(cache_bytes=0).open(blob) for i in (1, 2, 3)]
        reads = [h.read(0, PAGE * PAGES, version=v).data.tobytes() for h in readers for v in (v1, v2)]
        fed.apply_node_fault(3, "kill")
        fed.apply_node_fault(1, "partition")
        v3 = h0.write(fill(3, PAGE * 2), 0)
        freed = fed.gc(blob, keep_versions=[v3])
        probe = fed.nodes[1].session(cache_bytes=0)
        reads.append(probe.open(blob).read(0, PAGE).data.tobytes())
        probe.close()
        fenced = fed.node_fenced(1)
        fed.apply_node_fault(3, "recover")
        fed.apply_node_fault(1, "recover")
        reads += [h.read(0, PAGE * PAGES).data.tobytes() for h in readers]
        with pytest.raises(KeyError):
            readers[0].read(0, PAGE * PAGES, version=v1)
        return dict(reads=reads, versions=(v1, v2, v3), freed=freed, fenced=fenced,
                    epoch_stalls=fed.stats.epoch_stalls, lease_fences=fed.stats.lease_fences,
                    node_fences=[n.stats.lease_fences for n in fed.nodes],
                    cached=[n.shared_cache.cached_versions(blob) for n in fed.nodes],
                    modes=[fed.node_mode(i) for i in range(4)], epoch=fed.coordinator.epoch())
    finally:
        fed.close()


def test_one_federated_scenario_agrees_across_packages():
    want, got = scenario(jcore), scenario(tcore)
    assert got == want
    assert got["freed"][1] > 0 and got["epoch_stalls"] >= 1 and got["lease_fences"] >= 1 and got["fenced"]
    assert got["modes"] == ["up"] * 4
    assert got["reads"][-1] == (fill(3, PAGE * 2).tobytes() + fill(2, PAGE * 4).tobytes()
                                + fill(1, PAGE * 2).tobytes())


# ------------------------------ the sweep keeps the newest version ------------------------------
def gc_behind_a_publish(core):
    """A pass whose keep list was chosen before a publish, then one more
    write: what the reference does to versions written after its pass."""
    cluster = core.Cluster(n_data_providers=2, n_metadata_providers=2)
    try:
        handle = cluster.session().create(PAGE * PAGES, PAGE)
        handle.write(fill(1), 0)
        handle.write(fill(2, 2 * PAGE), 0)
        seen = handle.latest_published()
        v3 = handle.write(fill(3, 2 * PAGE), 4 * PAGE)  # publishes after the keep list was chosen
        freed = cluster.gc(handle.blob_id, keep_versions=[seen])
        v4 = handle.write(fill(4, 2 * PAGE), 0)  # its border links point into v3's tree
        try:
            after = handle.read(0, PAGE * PAGES, version=v4).data.copy()
        except KeyError as e:
            after = e
        return v3, freed, after
    finally:
        cluster.close()


def test_a_pass_behind_a_publish_keeps_the_newest_version():
    """The JAX package's sweep collects every version its keep list leaves
    out, the newest included: a write after the pass links into the
    collected tree and cannot be read back. The port's sweep keeps the
    newest published version, so it frees less and the later write reads
    back whole."""
    (v3, jfreed, jafter), (t3, freed, after) = gc_behind_a_publish(jcore), gc_behind_a_publish(tcore)
    assert v3 == t3 == 3
    assert isinstance(jafter, KeyError) and "version=3" in str(jafter)
    want = np.concatenate([fill(4, 2 * PAGE), fill(1, 2 * PAGE), fill(3, 2 * PAGE), fill(1, 2 * PAGE)])
    np.testing.assert_array_equal(after, want)
    assert freed[1] < jfreed[1] and freed[1] > 0


# ------------------------------ (f) the sweep's self-deadlock ------------------------------
def recovery_mid_sweep(fed, node):
    """An injector whose one event recovers ``node`` at the first RPC after
    it attaches: with no other traffic, that is the home sweep's first
    metadata RPC (``mark``'s ``get_node``), crossed on the GC thread while
    the coordinator's sweep window is open. Records, for the event, the
    thread it ran on and whether the sweep was open."""
    fired = []
    apply = fed.apply_node_fault

    def watched(i, action):
        fired.append((threading.get_ident(), fed.coordinator._sweeping, i, action))
        apply(i, action)

    fed.apply_node_fault = watched
    schedule = tcore.FaultSchedule([tcore.FaultEvent(1, "recover", node, target="node")])
    injector = tcore.FaultInjector(fed, schedule)
    injector.attach()
    return injector, fired


def test_gc_sweep_survives_a_recover_that_its_own_rpc_crosses():
    """The reference's hang: ``Federation.gc`` → home ``Cluster.gc`` opens the
    sweep window → ``mark`` → ``metadata.get_node`` → the fault gate applies
    a due node ``recover`` on the calling thread → ``rejoin_node`` →
    ``sync_pins``, which in the JAX package waits for a sweep that only this
    thread can close. In the port the resync is held back and installed
    when the sweep closes: ``gc`` returns, node 1 is up, its pins synced."""
    clock = FakeClock()
    fed = make_fed(tcore, clock)
    with unless_hung(fed.close):
        h0 = fed.nodes[0].session().create(PAGE * PAGES, PAGE)
        blob = h0.blob_id
        v1 = h0.write(fill(1), 0)
        snap = fed.nodes[1].session().open(blob).at(v1)  # node 1 pins v1
        v2 = h0.write(fill(2), 0)
        fed.apply_node_fault(1, "kill")
        snap.release()  # the unpin is lost with the node: the coordinator still pins v1
        assert fed.coordinator.pinned_versions(blob) == {v1}
        injector, fired = recovery_mid_sweep(fed, 1)
        try:
            gc_thread = []
            nodes_freed, pages_freed = run_daemon(
                lambda: gc_thread.append(threading.get_ident()) or fed.gc(blob, keep_versions=[v2]), "fed.gc")
        finally:
            injector.detach()
        assert fired == [(gc_thread[0], True, 1, "recover")]  # on the GC thread, mid-sweep
        assert [e.action for e in injector.fired] == ["recover"]
        assert fed.node_mode(1) == "up" and fed.coordinator.lease_valid(1)
        assert fed.coordinator.epoch() == 2 and fed.coordinator.joined_epoch(1) == 2
        assert fed.nodes[1].local_pins() == {}
        assert fed.coordinator.pinned_versions(blob) == set()  # the resync landed as the sweep closed
        assert fed.stats.epoch_stalls == 1  # node 1's lease was waited out before the sweep
        np.testing.assert_array_equal(h0.read(0, PAGE * PAGES, version=v1).data, fill(1))  # the stale pin kept v1
        assert pages_freed == 0
        assert run_daemon(lambda: fed.gc(blob, keep_versions=[v2]), "fed.gc")[1] == PAGES  # now v1 goes
        with pytest.raises(KeyError):
            h0.read(0, PAGE * PAGES, version=v1)


def test_no_pin_lands_mid_sweep_when_a_recover_fires_in_it():
    """The same schedule with a second thread pinning on the recovered node
    while the sweep is open: the coordinator's pin set is the same when the
    sweep closes as when it opened (neither that pin nor the resync landed
    mid-sweep); after it, the resync and then the pin are both in."""
    clock = FakeClock()
    fed = make_fed(tcore, clock)
    with unless_hung(fed.close):
        h0 = fed.nodes[0].session().create(PAGE * PAGES, PAGE)
        blob = h0.blob_id
        v1 = h0.write(fill(1), 0)
        h1 = fed.nodes[1].session().open(blob)
        stale = h1.at(v1)  # released while node 1 is down: the resync must drop it
        v2 = h0.write(fill(2), 0)
        fed.apply_node_fault(1, "kill")
        stale.release()
        coord = fed.coordinator
        seen, pinned, pinner = {}, [], []
        begin, end = coord.begin_sweep, coord.end_sweep

        def begin_sweep(blob_id):
            out = begin(blob_id)
            seen["open"] = coord.pinned_versions(blob)
            return out

        def end_sweep():
            seen["closing"] = coord.pinned_versions(blob)
            end()

        coord.begin_sweep, coord.end_sweep = begin_sweep, end_sweep
        injector, fired = recovery_mid_sweep(fed, 1)
        apply = fed.apply_node_fault

        def recover_then_pin(i, action):
            apply(i, action)  # node 1 is up again, mid-sweep
            t = threading.Thread(target=lambda: pinned.append(h1.at(v2)), name="pinner", daemon=True)
            t.start()
            pinner.append(t)
            t.join(0.3)  # parked at the coordinator until the sweep closes
            seen["pinner_parked"] = t.is_alive()
            seen["during"] = coord.pinned_versions(blob)

        fed.apply_node_fault = recover_then_pin
        try:
            run_daemon(lambda: fed.gc(blob, keep_versions=[v2]), "fed.gc")
        finally:
            injector.detach()
        pinner[0].join(DEADLINE_S)
        assert not pinner[0].is_alive(), "the pin never landed after the sweep"
        assert fired and fired[0][1:] == (True, 1, "recover")
        assert seen["pinner_parked"]
        assert seen["open"] == seen["during"] == seen["closing"] == {v1}  # no pin landed mid-sweep
        assert coord.pinned_versions(blob) == {v2}  # after it: v1's stale pin resynced away, v2 pinned
        assert pinned[0].version == v2
        pinned[0].release()
        assert coord.pinned_versions(blob) == set()


def test_an_unpin_during_the_sweep_reaches_the_held_back_resync():
    """A node that rejoined mid-sweep releases a snapshot before the sweep
    closes: the unpin reaches both the coordinator's table and the resync
    that will replace it, so no released pin survives the sweep."""
    coord = tcore.GcEpochCoordinator(lease_seconds=10.0, clock=FakeClock())
    coord.join(0)
    coord.pin(0, 7, 3)
    assert coord.begin_sweep(7) == {3}
    run_daemon(lambda: coord.sync_pins(0, {(7, 3): 1, (7, 4): 2}), "sync_pins")  # held back, never waits
    assert coord.pinned_versions(7) == {3}
    coord.unpin(0, 7, 3)
    coord.unpin(0, 7, 4)
    coord.end_sweep()
    assert coord.pinned_versions(7) == {4}
    coord.unpin(0, 7, 4)
    assert coord.pinned_versions(7) == set()


# ------------------------------ (g) chip_smoke.py's step 14 ------------------------------
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


@pytest.fixture
def chip_smoke_on_the_cpu(monkeypatch):
    cs = _chip_smoke()
    for name, fn in (("reset_peak_memory_stats", lambda *a, **k: None), ("max_memory_allocated", lambda *a, **k: 0),
                     ("synchronize", lambda *a, **k: None), ("Event", FakeEvent)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(cs, "SKY_DEVICE_TYPE", "cpu")
    return cs


def test_chip_smoke_federated_sky_rehearses_on_the_cpu(chip_smoke_on_the_cpu, capsys):
    cs = chip_smoke_on_the_cpu
    kernels = (SimpleNamespace(launches=5), SimpleNamespace(launches=5))
    out = cs.federated_sky_phase(torch.device("cpu"), "a card, 700.00 W", kernels, Deployment.smoke())
    assert out["launches"] == {"flash_attention": 0, "paged_attention": 0}
    # the example's sky: of its supernovae, those igniting in epochs 3 and 4 show in pairs 4 and 5
    assert out["found"] == [(3, 30, 22), (7, 6, 25)]
    assert out["gc"]["keep"] == [3 * 32] and out["gc"]["pages_freed"] > 0
    assert out["gc"]["epoch_stalls"] >= 1 and out["gc"]["lease_fences"] >= 1
    assert out["refused"][1] >= 1 and out["refused"][3] >= 1 and len(out["write_MBps"]) == 5
    assert sorted(out["node_read"]) == [0, 1, 2, 3] and out["busy_share"] is None
    assert all(p["h2d_ms"] is None for p in out["pairs"].values())
    text = capsys.readouterr().out
    assert "node 3 killed, node 1 partitioned" in text and "nodes 3 and 1 recovered" in text


def test_chip_smoke_federated_sky_fails_on_a_wrong_detection(chip_smoke_on_the_cpu, monkeypatch):
    from repro_torch.data.detect import DeviceDetector

    cs = chip_smoke_on_the_cpu
    detect = DeviceDetector.detect
    monkeypatch.setattr(DeviceDetector, "detect", lambda self, *a: [h[:-1] for h in detect(self, *a)])
    with pytest.raises(SystemExit):
        cs.federated_sky_phase(torch.device("cpu"), "card", (SimpleNamespace(launches=0),) * 2,
                               Deployment.smoke())
