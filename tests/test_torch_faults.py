"""The port's chaos harness (``repro_torch.core.faults``) against the JAX
package's, in one process.

(b) ``FaultSchedule.generate`` gives the same events in both packages;
every test of ``tests/test_faults.py`` but its three chaos campaigns runs
against ``repro_torch.core``; (d) the port's chaos campaigns (data-plane,
metadata-plane, both merged, and the federation's node plane), seeds 0-2,
at the sizes of the JAX package's campaigns. Their traffic runs in daemon
threads joined against one deadline: a hang fails the test, with every
thread's stack on stderr, instead of stalling the suite.
"""

import contextlib
import faulthandler
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.faults as jfaults  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.faults as tfaults  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Cluster,
    FaultInjector,
    FaultSchedule,
    Federation,
    HealthConfig,
    ProviderFailed,
    RetryPolicy,
)
from repro_torch.core.faults import DATA, METADATA, NODE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PAGE = 256
DEADLINE_S = 60.0
CHAOS = ("test_chaos_metadata_faults_zero_published_data_loss",
         "test_chaos_mixed_traffic_zero_published_data_loss",
         "test_chaos_node_faults_zero_published_data_loss")


# ------------------------------ (b) the same schedules ------------------------------
@pytest.mark.parametrize("target", [DATA, METADATA, NODE])
@pytest.mark.parametrize("seed", range(10))
def test_generated_schedules_agree_across_packages(seed, target):
    kw = dict(seed=seed, n_providers=4, n_events=12, max_dead=2, min_gap=3, max_gap=30, target=target)
    want = jfaults.FaultSchedule.generate(**kw).events
    got = tfaults.FaultSchedule.generate(**kw).events
    assert [tuple(vars(e).values()) for e in got] == [tuple(vars(e).values()) for e in want]
    assert got and all(e.target == target for e in got)
    assert [e.at_op for e in got] == sorted(e.at_op for e in got)


def test_the_harness_is_the_ports():
    assert tcore.FaultInjector is tfaults.FaultInjector is not jcore.FaultInjector
    assert FaultInjector.__module__ == "repro_torch.core.faults"


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


FAULT_TESTS = _port_of("test_faults.py", "test_faults_on_the_port")
NAMES = sorted(n for n in vars(FAULT_TESTS) if n.startswith("test_") and n not in CHAOS)


def test_the_ported_fault_tests_run_the_port():
    assert set(CHAOS) <= set(vars(FAULT_TESTS))
    assert len(NAMES) + len(CHAOS) == (ROOT / "tests" / "test_faults.py").read_text().count("\ndef test_")
    assert FAULT_TESTS.FaultInjector is tcore.FaultInjector and FAULT_TESTS.Cluster is tcore.Cluster


@pytest.mark.parametrize("name", NAMES)
def test_fault_test_on_the_port(name):
    getattr(FAULT_TESTS, name)()


# ------------------------------ (d) the chaos campaigns ------------------------------
class Hung(AssertionError):
    """A thread outlived its deadline. It may hold locks that draining the
    injector or closing the cluster would wait for, so those are left
    undone (see ``unless_hung``)."""


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


def drain_and_detach(injector):
    injector.drain()  # recovers whatever is still down
    injector.detach()


def run_traffic(targets, what):
    """Start each callable in a daemon thread, join all against one
    deadline, and fail on a hang (dumping every stack) or on any thread's
    exception."""
    errors = []

    def body(fn):
        try:
            fn()
        except Exception as e:  # reported in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=body, args=(fn,), name=f"{what}-{i}", daemon=True)
               for i, fn in enumerate(targets)]
    for t in threads:
        t.start()
    end = time.monotonic() + DEADLINE_S
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        faulthandler.dump_traceback(all_threads=True)
        raise Hung(f"{what}: {alive} still running after {DEADLINE_S} s: a hang (stacks on stderr)")
    if errors:
        raise errors[0]


def region_writer(blob, published, lock, wid, sess, n_rounds=8, regions=4):
    def run():
        handle = sess.open(blob)
        for r in range(n_rounds):
            region = (wid * regions + r % regions) * 8
            value = (wid * 100 + r + 1) % 251 + 1
            try:
                v = handle.write(np.full(8 * PAGE, value, np.uint8), region * PAGE)
            except ProviderFailed:
                continue  # aborted cleanly: never acked
            with lock:
                published.append((v, region, value))
    return run


def frontier_reader(cluster, blob, errors):
    def run():
        handle = cluster.session(cache_bytes=0).open(blob)
        last = 0
        for _ in range(30):
            v = handle.latest_published()
            assert v >= last, "publish frontier must be monotone"
            last = v
            if v:
                try:
                    handle.read(0, 64 * PAGE, version=v)
                except ProviderFailed as err:
                    errors.append(err)
            time.sleep(0.002)
    return run


def assert_no_published_loss(checker, published, seed, kept=lambda v, latest: True, frontier=True):
    """Every published write that GC was told to keep reads back, and (with
    ``frontier``) the frontier holds the newest write of each region."""
    latest = checker.latest_published()
    for v, region, value in published:
        if not kept(v, latest):
            continue  # collected by an explicit keep-latest GC pass
        np.testing.assert_array_equal(checker.read(region * PAGE, 8 * PAGE, version=v).data,
                                      np.full(8 * PAGE, value, np.uint8), err_msg=f"seed {seed}: v{v} lost data")
    if not frontier:
        return
    expected = np.zeros(64 * PAGE, np.uint8)
    for v, region, value in sorted(published):
        if v <= latest:
            expected[region * PAGE:(region + 8) * PAGE] = value
    np.testing.assert_array_equal(checker.read(0, 64 * PAGE, version=latest).data, expected)


#: plane -> (data providers, page replication, metadata shards, metadata replication)
CAMPAIGNS = {"data": (8, 3, 4, 1), "metadata": (4, 2, 4, 2), "mixed": (4, 2, 4, 2)}


def chaos_schedule(plane, seed):
    """``data``: the JAX package's mixed-traffic campaign (provider faults,
    at most 2 of 8 providers down); ``metadata``: its metadata campaign's
    shard faults alone (at most 1 of 4 shards down); ``mixed``: its
    metadata campaign, those shard faults merged with light provider
    faults."""
    data = FaultSchedule.generate(seed=seed, n_providers=8, n_events=10, max_dead=2, min_gap=3, max_gap=25)
    meta = FaultSchedule.generate(seed=seed, n_providers=4, n_events=8, max_dead=1, min_gap=3, max_gap=20,
                                  target=METADATA)
    light = FaultSchedule.generate(seed=seed + 100, n_providers=4, n_events=4, max_dead=1, min_gap=10,
                                   max_gap=40)
    return {"data": data, "metadata": meta, "mixed": FaultSchedule(meta.events + light.events)}[plane]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("plane", sorted(CAMPAIGNS))
def test_port_chaos_zero_published_data_loss(plane, seed):
    """Two writer and two reader sessions on one cluster while a seeded
    schedule kills, recovers, drops and delays data providers, metadata
    shards or both, at the JAX package's sizes. Published versions lose
    nothing, the frontier is monotone, reads complete (under metadata
    faults, once the faults are drained and repaired), and after drain and
    one repair pass every journal-covered metadata node is on all its
    shards and every published leaf's refs are on distinct healthy
    providers that hold the page.

    Two checks of the JAX package's campaigns are not held here, because
    the reference fails them too (ROADMAP Queue 3). Its data campaign holds
    every leaf to 3 providers after the repair pass, but a pass whose fetch
    from the surviving copy fails (an injected drop) rewrites the leaf
    without its lost refs and with no fresh copy, and no later pass looks
    at it again since none of its refs is down (seed 1 fails about one run
    in six in both packages). Its metadata campaign holds every read under
    the faults to complete, but a node written while one of its two shards
    was down commits on the other alone (the quorum of 2 is 1), and a read
    fails while that shard is down in turn (seed 0 of the JAX campaign,
    about one run in thirty)."""
    n_providers, replication, n_shards, meta_replication = CAMPAIGNS[plane]
    cluster = Cluster(
        n_data_providers=n_providers, page_replication=replication, n_metadata_providers=n_shards,
        metadata_replication=meta_replication, shared_cache_bytes=0,
        retry_policy=RetryPolicy(max_attempts=3, base_delay_seconds=0.001, max_delay_seconds=0.004),
        health=HealthConfig(dead_after=2, window_seconds=60.0))
    with unless_hung(cluster.close):
        writers = [cluster.session(cache_bytes=0) for _ in range(2)]
        blob = writers[0].create(64 * PAGE, PAGE).blob_id
        injector = FaultInjector(cluster, chaos_schedule(plane, seed))
        injector.attach()
        published, lock, errors = [], threading.Lock(), []
        with unless_hung(lambda: drain_and_detach(injector)):
            run_traffic([region_writer(blob, published, lock, i, s) for i, s in enumerate(writers)]
                        + [frontier_reader(cluster, blob, errors) for _ in range(2)], f"{plane} chaos")
        if meta_replication == 1:  # no metadata faults: every read completes under the faults
            assert not errors, f"reads failed under {plane} chaos: {errors[:3]}"
        assert all(isinstance(e, ProviderFailed) for e in errors)
        assert injector.fired and not injector.pending_events()
        cluster.repair_service.run_once()
        checker = cluster.session(cache_bytes=0).open(blob)
        assert_no_published_loss(checker, published, seed)
        for v, _, _ in published:
            checker.read(0, 64 * PAGE, version=v)  # every read completes once the faults are repaired
        vm, pm = cluster.version_manager, cluster.provider_manager
        frontier, aborted = vm.repair_horizon(blob)
        for key, node in cluster.metadata.iter_nodes(blob):
            if key.version > frontier or key.version in aborted:
                continue
            for sid in cluster.metadata._replica_ids(key):
                assert cluster.metadata.shards[sid].get(key) is not None, f"seed {seed}: shard {sid} lost {key}"
            if node.is_leaf:
                refs = node.all_page_refs()
                assert len({pid for pid, _ in refs}) == len(refs) >= 1, f"seed {seed}: {key} refs {refs}"
                for pid, page_key in refs:
                    assert not pm.get_provider(pid).failed and pm.get_provider(pid).has_page(page_key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_node_chaos_zero_published_data_loss(seed):
    """The federated campaign on the port, at the JAX package's size: 4
    nodes x 4 sessions of mixed traffic on one substrate while a seeded
    node-plane schedule kills, partitions and wedges whole nodes and a GC
    thread runs federated passes. The JAX package's copy of this campaign
    can hang (its GC thread deadlocks itself when its own RPC crosses a
    ``recover``); the port's must finish within the deadline. Zero loss of
    published data no pass could collect, no torn reads, every node up at
    the end, and after a final pass no node's shared tier holds a collected
    version.

    Two differences from the JAX package's campaign. A pass collects every
    version up to the newest it sees but those it keeps, and versions can
    publish while it waits out leases, so the versions held to be lossless
    are those newer than the newest published when each pass returned (the
    JAX campaign takes the version it asked to keep, which a concurrent
    publish makes collectable; with its sweep collecting the newest version
    too, it then loses versions written after the pass, ROADMAP Queue 3).
    And where the JAX campaign's worker threads die unobserved on any
    exception, this one fails on every exception but two, both faults of
    the reference that the port keeps (ROADMAP Queue 3), each counted and
    then shown to name a collected version: a snapshot taken on a node
    other than the home node while a pass runs can name a version that pass
    collects (its pin lands after the sweep it raced), so its first read
    raises ``KeyError``; and while such a pin lives, a pass aborts at
    ``mark`` with ``KeyError`` before it reclaims anything. A third fault of
    the reference is checked for by its signature: when a death verdict
    erases a live writer's in-flight version (it was the newest assigned),
    the number goes to the next writer and both writers' reports succeed,
    so two writes are acked under one version and one of them never shows;
    such writes are held only to the frontier, where their region holds
    either them or its newest other acked write."""
    n_nodes, writers_per_node, readers_per_node = 4, 2, 2
    fed = Federation(
        n_nodes=n_nodes, n_data_providers=4, page_replication=2, n_metadata_providers=4,
        metadata_replication=2, lease_seconds=0.05,
        retry_policy=RetryPolicy(max_attempts=2, base_delay_seconds=0.001, max_delay_seconds=0.004),
        health=HealthConfig(dead_after=2, window_seconds=60.0))
    with unless_hung(fed.close):
        sessions = [[fed.nodes[n].session() for _ in range(writers_per_node + readers_per_node)]
                    for n in range(n_nodes)]
        blob = sessions[0][0].create(64 * PAGE, PAGE).blob_id
        schedule = FaultSchedule.generate(seed=seed, n_providers=n_nodes, n_events=10, max_dead=2, min_gap=5,
                                          max_gap=30, target=NODE)
        injector = FaultInjector(fed, schedule)
        injector.attach()
        published, lock, errors, gc_floors = [], threading.Lock(), [], []
        lost_snapshots, aborted_passes = [], []  # the two reference faults: versions they name
        traffic_done = threading.Event()
        n_writers = n_nodes * writers_per_node
        left = [n_nodes * (writers_per_node + readers_per_node)]

        def traffic(fn):
            def run():
                try:
                    fn()
                finally:
                    with lock:
                        left[0] -= 1
                        if not left[0]:
                            traffic_done.set()
            return run

        def writer(node_i, slot, sess):
            wid = node_i * writers_per_node + slot
            handle = sess.open(blob)
            for r in range(6):
                value = (wid * 31 + r) % 251 + 1
                try:
                    v = handle.write(np.full(8 * PAGE, value, np.uint8), wid * 8 * PAGE)
                except (ProviderFailed, ValueError):
                    continue  # node down / writer recovered: never acked
                with lock:
                    published.append((v, wid * 8, value))

        def reader(sess):
            handle = sess.open(blob)
            last = 0
            for _ in range(20):
                v = handle.latest_published()
                assert v >= last, "publish frontier must be monotone"
                last = v
                try:
                    snap = handle.at(None)  # a federated pin: GC must honour it
                except (ProviderFailed, ValueError):
                    time.sleep(0.002)
                    continue  # node down or partitioned: the pin is refused
                try:
                    data = snap.read(0, 64 * PAGE)
                    for w in range(n_writers):
                        vals = np.unique(data[w * 8 * PAGE:(w + 1) * 8 * PAGE])
                        if len(vals) > 1:
                            errors.append(f"torn region {w} at v{snap.version}: {vals.tolist()}")
                except ProviderFailed:
                    pass  # the node died mid-read: acceptable, data loss is not
                except KeyError:
                    lost_snapshots.append(snap.version)  # raced a pass that collected it
                finally:
                    snap.release()
                time.sleep(0.002)

        def gc_loop():
            while not traffic_done.wait(0.02):
                latest = fed.version_manager.latest_published(blob)
                if latest:
                    try:
                        fed.gc(blob, keep_versions=[latest])
                    except KeyError as e:  # a live pin names a collected version
                        aborted_passes.append(int(re.search(r"version=(\d+)", str(e)).group(1)))
                        continue
                    # the pass kept its own newest version, which may be newer than
                    # ``latest``; versions between the two were its to collect
                    gc_floors.append(fed.version_manager.latest_published(blob))

        with unless_hung(lambda: drain_and_detach(injector)):  # recover_all rejoins every downed node
            run_traffic([traffic(lambda n=n, s=s: writer(n, s, sessions[n][s]))
                         for n in range(n_nodes) for s in range(writers_per_node)]
                        + [traffic(lambda n=n, s=s: reader(sessions[n][writers_per_node + s]))
                           for n in range(n_nodes) for s in range(readers_per_node)]
                        + [gc_loop], f"node chaos seed {seed}")
        assert not errors, f"seed {seed}: stale/torn reads: {errors[:3]}"
        fed.repair_service.run_once()
        assert all(fed.node_mode(i) == "up" for i in range(n_nodes))
        floor = max(gc_floors, default=0)
        checker = fed.nodes[1].session(cache_bytes=0).open(blob)
        latest = checker.latest_published()
        # writes acked under one version number by two writers: writer recovery erased the
        # first writer's in-flight version and the number went to the next writer
        reissued = {v for v, _, _ in published if len({r for w, r, _ in published if w == v}) > 1}
        clean = [p for p in published if p[0] not in reissued]
        assert_no_published_loss(checker, clean, seed, kept=lambda v, latest: v >= floor or v == latest,
                                 frontier=False)
        data = checker.read(0, 64 * PAGE, version=latest).data
        for w in range(n_writers):  # each region holds its newest acked write (or a newer reissued one)
            mine = sorted((v, value) for v, r, value in published if r == w * 8 and v <= latest)
            newest = max([(v, value) for v, value in mine if v not in reissued], default=(0, 0))
            want = {newest[1]} | {value for v, value in mine if v in reissued and v > newest[0]}
            got = set(np.unique(data[w * 8 * PAGE:(w + 1) * 8 * PAGE]).tolist())
            assert len(got) == 1 and got <= want, f"seed {seed}: region {w} holds {got}, not one of {want}"
        for v in set(lost_snapshots + aborted_passes):  # each names a version a pass did collect
            with pytest.raises(KeyError):
                checker.read(0, 64 * PAGE, version=v)
        fed.gc(blob, keep_versions=[latest])
        for i in range(n_nodes):
            stale = [v for v in fed.nodes[i].shared_cache.cached_versions(blob) if v != 0 and v < latest]
            assert not stale, f"seed {seed}: node {i} caches collected versions {stale}"
        assert fed.coordinator.epoch() > 1
