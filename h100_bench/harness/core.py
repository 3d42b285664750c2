"""What every cell shares: finding a cell's files by name, the caches'
places, the run's record and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration is the JSON file the ``configs`` entry names; its traffic is
``traffic/<traffic>.json``; the runner of its entry point is
``entries/<config["entry"]>.py``; each per-layer metric is read by
``metrics/<metric name>.py``.  Adding a cell, a configuration, a mix or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = BENCH.parent  # the checkout
CACHE = BENCH / "cache"  # inputs made from fixed seeds, kept across runs
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pegasus_tpu")


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed place inside the checkout,
    so that only a checkout's first run builds."""
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module at ``path``: an entry runner or a metric reader, found by
    the name ``BENCHMARK.json`` gives it."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its configuration and
    its traffic mix read from their files."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / BENCH.name / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)],
    )


def entry_runner(config: dict, bench: Path = BENCH):
    return load_module(bench / "entries" / f"{config['entry']}.py", f"h100_bench_entry_{config['entry']}")


def metric_reader(name: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{name}.py", "h100_bench_metric_" + name.replace(".", "_"))


@dataclass
class Check:
    """One number compared with the plain reference, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Run:
    """What one run of a cell records, for the result line and the readers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    workdir: Path
    end_to_end: dict = field(default_factory=dict)  # name -> value
    facts: dict = field(default_factory=dict)  # what the readers read: stats, counts, trace
    checks: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    cache: Path = CACHE  # where inputs made from fixed seeds are kept

    def say(self, line: str) -> None:
        print(f"[h100_bench {self.cell.name}] {line}", flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must never load,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def io_bytes() -> dict:
    """This process's bytes written so far (``/proc/self/io``): to storage,
    and through write calls."""
    try:
        text = Path("/proc/self/io").read_text()
    except OSError:
        return {}
    fields = dict(line.split(": ") for line in text.strip().splitlines())
    return {"write_bytes": int(fields.get("write_bytes", 0)), "wchar": int(fields.get("wchar", 0))}


def metric_value(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def result_line(run: Run, metrics: dict, device: dict, breakdown: dict | None) -> str:
    out = {
        "correct": bool(run.checks) and all(c.ok for c in run.checks),
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": metrics,
        "device": device,
    }
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else str(c.value),
                              "limit": c.limit} for c in run.checks}
    return json.dumps(out)


def _steal_s() -> float:
    """Seconds the hypervisor gave this machine's CPUs to others, all CPUs
    summed (``/proc/stat``), or 0 where it is not kept."""
    try:
        fields = Path("/proc/stat").read_text().splitlines()[0].split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK") if len(fields) > 8 else 0.0
    except (OSError, ValueError):
        return 0.0


def host_probe_s() -> float:
    """Seconds one fixed piece of pure-Python work takes on this thread:
    the host's speed at the moment, to set beside a run's rate."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i * i
    return time.perf_counter() - t0


@contextmanager
def host_account(run, label: str):
    """Say, after the body, where the host's time went during it: the
    process's CPU seconds against the wall, the CPU time stolen from the
    machine, and the garbage collector's passes and pauses."""
    pauses = {"n": [0, 0, 0], "s": 0.0, "t": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            pauses["t"] = time.perf_counter()
        else:
            pauses["n"][info["generation"]] += 1
            pauses["s"] += time.perf_counter() - pauses["t"]

    gc.callbacks.append(on_gc)
    cpu0, steal0, t0 = os.times(), _steal_s(), time.perf_counter()
    try:
        yield
    finally:
        gc.callbacks.remove(on_gc)
        cpu1, wall = os.times(), time.perf_counter() - t0
        run.say(f"host during {label}: wall {wall:.3f} s, process CPU user {cpu1.user - cpu0.user:.3f} s "
                f"system {cpu1.system - cpu0.system:.3f} s, stolen {_steal_s() - steal0:.3f} s, "
                f"gc passes by generation {pauses['n']} pausing {pauses['s']:.4f} s")
