"""The trace reduction on a hand-made timeline: busy union, idle gaps by
what the host was doing, and each call's kernel time inside its device-side
annotation."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from h100bench import trace

CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def ev(name, dev, s, e, thread=1):
    return NS(name=name, device_type=dev, time_range=NS(start=s, end=e), thread=thread)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_summary_by_hand():
    events = [
        ev("bench.stretch", CPU, 0, 100),
        ev("bench.decode", CPU, 0, 60),
        ev("aten::mm", CPU, 5, 15),
        ev("bench.paged#0", CPU, 20, 30),
        ev("cudaLaunchKernel", CPU, 21, 23),
        ev("bench.prefill", CPU, 70, 100),
        ev("aten::copy_", CPU, 80, 95),
        ev("other thread", CPU, 0, 100, thread=2),
        # device timeline, in microseconds
        ev("gemm", GPU, 10, 20),
        ev("gemm", GPU, 15, 25),  # overlaps the first: counted once
        ev("paged_split_kernel<bf16>(int)", GPU, 30, 40),
        ev("div", GPU, 42, 44),
        ev("bench.paged#0", GPU, 30, 44),  # the annotation: not work
        ev("flash", GPU, 90, 110),  # runs past the stretch: clipped
    ]
    s = trace.summarize(Prof(events))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((15 + 10 + 2 + 10) * 1e-6)
    assert s["calls"] == {"bench.paged#0": pytest.approx(12e-6)}
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["gemm"] == pytest.approx(20e-6) and ops["paged_split_kernel<bf16>"] == pytest.approx(10e-6)
    idle = dict(s["breakdown"]["idle_gaps"])
    # gaps 0-10 (decode: aten::mm at 5), 25-30 (decode: python), 40-42 (decode: python),
    # 44-90 (mid 67: step, between the decode and the prefill)
    assert idle == {"decode: aten::mm": pytest.approx(10e-6), "decode: python": pytest.approx(7e-6),
                    "step: python": pytest.approx(46e-6)}
    assert trace.roofline_share({"bench.paged#0": 6e-6, "bench.paged#1": 1.0}, s["calls"]) == pytest.approx(50.0)
