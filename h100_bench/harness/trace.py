"""The traced run: one ``torch.profiler`` trace over the traced part of the
window, reduced once to what the per-layer readers take from it.

The profiler's raw events are read as they come (no event tree is built).
Device time is the union of the device events' intervals (kernels, copies,
sets), so two overlapping kernels count once; a ``record_function`` range's
device-side copy spans its kernels and is no work of its own.  Launches are
the host's kernel-launch calls.  An idle gap on the device is charged to
what the host was doing meanwhile (``gap_charges``): the ranges it
overlaps, else the host operation that started last before it.

``DeviceClock`` is the untraced run's device reading: the device's busy
seconds over stretches profiled for device activity alone, with the
launches whose kernel the trace missed counted.
"""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from typing import NamedTuple

LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
RUNTIME_PREFIXES = ("cuda", "cu")
TOP = 10  # entries of each breakdown list
COARSE_PREFIX = "h100_bench/"  # the benchmark's per-scene and per-segment ranges
SPAN_PREFIX = "h100_bench.span/"  # the benchmark's spans around the program's calls
# the share of launches whose kernel record a device clock may miss: the trace drops some records
# (0.06-1.64 % of a training window's on an H100) while its busy time stays within its own spread
# (PERF.md); a share several times that is a broken trace
MAX_LOST = 0.05


class Event(NamedTuple):
    name: str
    device: bool  # ran on the device (a kernel, a copy, a set)
    start_us: float
    end_us: float
    corr: int  # CUDA correlation id: a launch call and the kernel it queued share it
    user: bool  # a record_function range (host side or its device-side copy)


@contextmanager
def spans_around(enabled: bool, targets):
    """While open (and ``enabled``), each ``(owner, attribute)`` of
    ``targets`` runs inside a ``record_function`` range named
    ``h100_bench.span/<attribute>``: spans around the calls into the
    program's layers, set from the benchmark's side.  Nothing of the
    program changes but the range around the call."""
    if not enabled:
        yield
        return
    from torch.profiler import record_function

    saved = []
    for owner, attr in targets:
        fn = getattr(owner, attr)

        def spanned(*a, _fn=fn, _name=SPAN_PREFIX + attr, **k):
            with record_function(_name):
                return _fn(*a, **k)
        saved.append((owner, attr, fn))
        setattr(owner, attr, spanned)
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


@contextmanager
def traced(run, enabled: bool):
    """Trace the body when ``enabled``; record the traced wall seconds, the
    events and their reduction in ``run.facts``."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = run.device.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.__enter__()
    t0 = time.perf_counter()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(run.device)
        window_s = time.perf_counter() - t0
        prof.__exit__(None, None, None)
    t1 = time.perf_counter()
    events = raw_events(prof)
    run.facts["trace_events"] = events
    run.facts["trace"] = reduce_trace(events, window_s)
    run.say(f"trace of {len(events)} events reduced in {time.perf_counter() - t1:.3f} s")


def raw_events(prof) -> list:
    return events_of(prof.profiler.kineto_results)


def events_of(results) -> list:
    """The events of one profiler session's results, as ``Event``s."""
    from torch.autograd import DeviceType

    out = []
    for e in results.events():
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), e.device_type() != DeviceType.CPU, start,
                         start + e.duration_ns() / 1e3, e.correlation_id(),
                         bool(e.is_user_annotation()) or "/" in e.name()))
    return out


class DeviceClock:
    """Device busy seconds over stretches of a run, each profiled for
    device activity alone (kernels, copies, sets and the runtime calls; no
    host operations).  Each stretch ends in a synchronize, so its work has
    all run when its session stops; stopping a session costs the host some
    seconds, and the sessions' results are reduced after the window
    (``reduce``)."""

    def __init__(self, device):
        self.device, self.results = device, []

    @contextmanager
    def stretch(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        try:
            yield
        finally:
            torch.cuda.synchronize(self.device)
            prof.__exit__(None, None, None)
            self.results.append(prof.profiler.kineto_results)

    def reduce(self) -> dict:
        """busy_s (the union of the device events' intervals), the device
        events, the launches and the launches whose kernel is missing,
        summed over the stretches (``summed``)."""
        parts = []
        while self.results:
            parts.append(device_busy(clock_events(self.results.pop(0))))
        return summed(parts)


def clock_events(results) -> list:
    """What ``device_busy`` reads of one session, read with as few calls
    per event as will do: the launch calls and the device events."""
    from torch.autograd import DeviceType

    cpu, out = DeviceType.CPU, []
    for e in results.events():
        if e.device_type() == cpu:
            name = e.name()
            if name in LAUNCH_KEYS:
                out.append(Event(name, False, 0.0, 0.0, e.correlation_id(), False))
        elif not e.is_user_annotation():
            start = e.start_ns() / 1e3
            out.append(Event("", True, start, start + e.duration_ns() / 1e3, e.correlation_id(), False))
    return out


def summed(parts, max_lost: float = MAX_LOST) -> dict:
    """The stretches' readings added up; raises where more than
    ``max_lost`` of the launches have no device event (the trace dropped
    them, and with them possibly device time)."""
    out = {k: sum(p[k] for p in parts) for k in ("busy_s", "device_events", "launches", "lost")}
    if out["lost"] > max_lost * out["launches"]:
        raise RuntimeError(f"the device trace lost the kernels of {out['lost']} of "
                           f"{out['launches']} launches, more than {max_lost:.0%}")
    return out


def device_busy(events) -> dict:
    """busy_s, the device events, the launch calls, and the launches
    (by correlation id) that no device event answers."""
    device = [e for e in events if e.device and not e.user]
    launched = {e.corr for e in events if not e.device and e.name in LAUNCH_KEYS}
    busy = _merged([(e.start_us, e.end_us) for e in device])
    return {"busy_s": sum(hi - lo for lo, hi in busy) / 1e6, "device_events": len(device),
            "launches": len(launched), "lost": len(launched - {e.corr for e in device})}


def _merged(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def gap_charges(host, gaps) -> dict:
    """Idle seconds by what the host was doing: each gap's time goes to the
    ``record_function`` ranges it overlaps (the program's own, or the
    benchmark's spans around its calls; not the benchmark's scene or segment
    ranges; the ranges named are taken not to nest), and what no range covers
    to the host operation that started last before the gap."""
    spans = sorted((e.start_us, e.end_us, e.name) for e in host
                   if e.user and not e.name.startswith(COARSE_PREFIX))
    span_los = [lo for lo, _, _ in spans]
    ops = sorted((e.start_us, e.name) for e in host
                 if not e.user and not e.name.startswith(RUNTIME_PREFIXES))
    op_los = [lo for lo, _ in ops]
    out: dict = {}
    for g0, g1 in gaps:
        covered = 0.0
        j = bisect.bisect_left(span_los, g1) - 1
        while j >= 0 and spans[j][1] > g0:  # the spans that start before the gap ends and end after it starts
            part = min(spans[j][1], g1) - max(spans[j][0], g0)
            out[spans[j][2]] = out.get(spans[j][2], 0.0) + part / 1e6
            covered += part
            j -= 1
        if g1 - g0 - covered > 0:
            i = bisect.bisect_right(op_los, g0) - 1
            name = f"after {ops[i][1]}, in no range" if i >= 0 else "before the first host op"
            out[name] = out.get(name, 0.0) + (g1 - g0 - covered) / 1e6
    return out


def reduce_trace(events, window_s: float) -> dict:
    """busy_s, window_s, launches, device seconds by operation, and the
    breakdown: device operations and idle gaps, the largest first."""
    device = [e for e in events if e.device and not e.user]
    host = [e for e in events if not e.device]
    busy = _merged([(e.start_us, e.end_us) for e in device])
    by_op: dict = {}
    for e in device:
        by_op[e.name] = by_op.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e6
    gaps = gap_charges(host, [(hi0, lo1) for (_, hi0), (lo1, _) in zip(busy, busy[1:])])
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "busy_s": sum(hi - lo for lo, hi in busy) / 1e6,
        "window_s": window_s,
        "launches": sum(1 for e in host if e.name in LAUNCH_KEYS),
        "device_s_by_op": by_op,
        "breakdown": {"device_ops": top(by_op), "idle_gaps": top(gaps)},
    }


def device_s_in_ranges(events, prefix: str) -> dict:
    """Device seconds per ``record_function`` range named ``prefix<name>``,
    summed over the ranges of one name and kept by operation: each device
    event is charged to the range whose host interval holds the launch call
    that queued it (matched by correlation id), whatever thread made the
    call.  The rule of chip_smoke.py's ``stage_split`` at commit 7a69f88.
    Returns {name: {"total": s, operation: s, ...}}."""
    ranges = sorted((e.start_us, e.end_us, e.name[len(prefix):]) for e in events
                    if not e.device and e.user and e.name.startswith(prefix))
    los = [lo for lo, _, _ in ranges]
    queued_at = {e.corr: e.start_us for e in events
                 if not e.device and e.name.startswith(RUNTIME_PREFIXES)}
    split: dict = {name: {} for _, _, name in ranges}
    for e in events:
        if not e.device or e.user:
            continue
        t = queued_at.get(e.corr)
        if t is None:
            continue
        # the ranges of one prefix do not nest: the latest-starting one holds t or none does
        i = bisect.bisect_right(los, t) - 1
        if i < 0 or t > ranges[i][1]:
            continue
        per = split[ranges[i][2]]
        s = (e.end_us - e.start_us) / 1e6
        per["total"] = per.get("total", 0.0) + s
        per[e.name] = per.get(e.name, 0.0) + s
    return split
