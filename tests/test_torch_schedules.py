"""The port's interleaving explorer (``repro_torch.analysis.schedules``)
against the JAX package's, in one process: every registered scenario
explored on both packages gives the same schedule and step counts, and no
schedule fails on the port but with the one fault of the reference that
``REFERENCE_FAULT`` names; the explorer's own tests (enumeration, refusal
of unbounded scenarios, the seeded order bug) hold on the port."""

from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro.analysis import schedules as jschedules  # noqa: E402
from repro_torch.analysis import schedules  # noqa: E402


def test_the_same_scenarios_are_registered():
    assert sorted(schedules.SCENARIOS) == sorted(jschedules.SCENARIOS)
    assert {"gc_vs_pin", "publish_vs_shared_fill", "node_death_vs_gc_ack"} <= set(schedules.SCENARIOS)


#: the failure a fault of the reference lets a scenario show, in both packages (ROADMAP
#: Queue 3): ``write_async`` assigns a write its version on a pool thread, so two queued
#: writes can take their versions in the other order and the first one ends on top (in about
#: one exploration in fifteen)
REFERENCE_FAULT = {"write_async_vs_flush": ("final read does not see the last async write",)}


@pytest.mark.parametrize("name", sorted(jschedules.SCENARIOS))
def test_scenario_explores_alike_and_passes_on_the_port(name):
    want = jschedules.explore(jschedules.SCENARIOS[name])
    got = schedules.explore(schedules.SCENARIOS[name])
    assert (got.scenario, got.n_schedules, got.n_steps) == (want.scenario, want.n_schedules, want.n_steps)
    assert got.n_schedules >= 2
    failures = [f for f in got.failures if f.errors != REFERENCE_FAULT.get(name)]
    assert not failures, "\n".join(str(f) for f in failures)


def test_the_port_builds_the_ports_clusters():
    ctx = schedules.SCENARIOS["gc_vs_pin"].build()
    try:
        assert type(ctx.cluster).__module__ == "repro_torch.core.cluster"
    finally:
        ctx.cluster.close()


def test_interleavings_enumerate_every_merge():
    orders = list(schedules.interleavings([2, 2]))
    assert len(orders) == len(set(orders)) == 6 == schedules.n_interleavings([2, 2])
    for order in orders:
        assert [i for i in order if i == 0] == [0, 0] and [i for i in order if i == 1] == [1, 1]
    assert list(schedules.interleavings([3, 1, 2])) == list(jschedules.interleavings([3, 1, 2]))


def test_explorer_refuses_unbounded_scenarios():
    with pytest.raises(ValueError, match="interleavings exceed"):
        schedules.explore(schedules.SCENARIOS["publish_vs_shared_fill"], max_schedules=2)


def test_explorer_catches_seeded_order_bug():
    """A reader that can run before the writer publishes: the port's
    explorer reports exactly that one schedule of the two."""

    def build():
        return SimpleNamespace(cluster=SimpleNamespace(close=lambda: None), errors=[], published=False)

    def actors(ctx):
        def publish():
            ctx.published = True

        def read():
            if not ctx.published:
                ctx.errors.append("read before publish")

        return [("writer", [publish]), ("reader", [read])]

    report = schedules.explore(schedules.Scenario("seeded_order_bug", build, actors))
    assert report.n_schedules == 2 and len(report.failures) == 1
    failure = report.failures[0]
    assert failure.schedule[0] == "reader.0" and "read before publish" in failure.errors[0]
    assert str(failure) == "seeded_order_bug: schedule [reader.0]: read before publish"


def test_run_all_reports_every_scenario():
    reports = schedules.run_all()
    assert [r.scenario for r in reports] == list(schedules.SCENARIOS)
    assert all(f.errors == REFERENCE_FAULT.get(r.scenario) for r in reports for f in r.failures)
