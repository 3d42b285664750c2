"""What several per-layer readers take from one run: the reduced trace,
device seconds of a kernel inside one of the benchmark's ranges, the
compositor bounds (counted once per run) and the card's power limit."""

from __future__ import annotations

import subprocess

from harness.core import entry_runner
from harness.trace import device_s_in_ranges

K1 = "composite_tiles_kernel"
K3 = "composite_tiles_bwd_kernel"


def trace(run):
    """The reduced trace, or None where the run traced no device work."""
    t = run.facts.get("trace")
    return t if t and t["busy_s"] > 0 else None


def per_unit(run, value: float, unit_key: str):
    n = run.facts.get(unit_key, 0)
    return value / n if n else None


def range_kernel_s(run, range_name: str, fragment: str) -> float:
    """Device seconds of the kernels named with ``fragment`` that were
    queued inside the benchmark's range ``h100_bench/<range_name>``."""
    split = run.facts.get("bench_ranges")
    if split is None:
        split = run.facts["bench_ranges"] = device_s_in_ranges(run.facts["trace_events"], "h100_bench/")
    return sum(s for name, s in split.get(range_name, {}).items() if name != "total" and fragment in name)


def bounds(run, ctx, fn: str):
    """The entry's compositor bounds (``entries/<entry>.py::<fn>``), once."""
    key = f"bounds:{fn}"
    if key not in run.facts:
        run.facts[key] = getattr(entry_runner(run.cell.config), fn)(run, ctx)
    return run.facts[key]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def roofline(run, least_ms: float, device_s: float, label: str, bound_by: str, launches: int):
    """100 x the least time over the measured device time, or None where
    the kernel did not run on the device."""
    if device_s <= 0:
        return None
    share = 100.0 * least_ms / 1e3 / device_s
    run.say(f"{label}: least {least_ms:.6f} ms (bound by {bound_by}) over {launches} launches, "
            f"device {1e3 * device_s:.6f} ms, share {share:.4f} % of the H100 SXM peaks; "
            f"card {power_limit()}")
    return share
