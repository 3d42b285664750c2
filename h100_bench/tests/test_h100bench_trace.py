"""The trace reduction on a hand-made event list: device time as the union
of intervals, launches counted, range copies left out, idle gaps charged to
the ranges they overlap, and device time charged to ranges by correlation."""

from __future__ import annotations

import pytest

from harness.trace import Event, device_busy, device_s_in_ranges, reduce_trace, summed


def events():
    host = lambda name, a, b, corr=0: Event(name, False, a, b, corr, "/" in name)
    dev = lambda name, a, b, corr=0: Event(name, True, a, b, corr, "/" in name)
    return [
        host("h100_bench/scene000", 0, 1000),  # a coarse range: never charged gap time
        host("train_step/project", 0, 300),
        host("cudaLaunchKernel", 10, 12, corr=1),
        host("cudaLaunchKernel", 20, 22, corr=2),
        host("aten::mul", 5, 25),
        host("train_step/backward", 500, 900),
        host("cudaLaunchKernel", 510, 512, corr=3),
        host("aten::add", 940, 950),
        dev("train_step/project", 100, 300),  # a range's device-side copy: no work of its own
        dev("kernel_a", 100, 200, corr=1),
        dev("kernel_b", 150, 250, corr=2),  # overlaps kernel_a: counted once in busy time
        dev("kernel_c", 600, 700, corr=3),
        dev("kernel_d", 960, 1000),
    ]


def test_busy_launches_and_device_ops():
    t = reduce_trace(events(), window_s=0.001)
    assert t["busy_s"] == pytest.approx((150 + 100 + 40) / 1e6)
    assert t["launches"] == 3
    assert t["device_s_by_op"] == pytest.approx({"kernel_a": 100e-6, "kernel_b": 100e-6,
                                                 "kernel_c": 100e-6, "kernel_d": 40e-6})
    assert "train_step/project" not in t["device_s_by_op"]


def test_idle_gaps_are_charged_to_the_ranges_they_overlap():
    gaps = dict(reduce_trace(events(), window_s=0.001)["breakdown"]["idle_gaps"])
    # gap 250-600: project to 300, no range 300-500 (after aten::mul), backward 500-600;
    # gap 700-960: backward to 900, then no range (after the last op before 700: aten::mul)
    assert gaps["train_step/project"] == pytest.approx(50e-6)
    assert gaps["train_step/backward"] == pytest.approx(300e-6)
    assert gaps["after aten::mul, in no range"] == pytest.approx(260e-6)
    assert sum(gaps.values()) == pytest.approx(610e-6)


def test_device_time_is_charged_to_the_range_that_queued_it():
    split = device_s_in_ranges(events(), "train_step/")
    assert split["project"]["total"] == pytest.approx(200e-6)
    assert split["backward"] == {"total": pytest.approx(100e-6), "kernel_c": pytest.approx(100e-6)}


def test_device_busy_is_the_union_and_finds_lost_kernels():
    ev = events()
    b = device_busy(ev)
    assert b["busy_s"] == pytest.approx((150 + 100 + 40) / 1e6)
    assert (b["device_events"], b["launches"], b["lost"]) == (4, 3, 0)
    lost = device_busy([e for e in ev if e.name != "kernel_c"])  # launch 3's kernel dropped
    assert (lost["launches"], lost["lost"]) == (3, 1)


def test_stretches_add_up_and_too_many_lost_kernels_fail():
    part = {"busy_s": 0.5, "device_events": 990, "launches": 1000, "lost": 10}
    assert summed([part, part]) == {"busy_s": 1.0, "device_events": 1980, "launches": 2000, "lost": 20}
    with pytest.raises(RuntimeError, match="lost the kernels of 60 of 1000"):
        summed([dict(part, lost=60)])
