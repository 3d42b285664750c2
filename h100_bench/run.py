"""One run of one benchmark cell of the PyTorch + CUDA port.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names its
configuration and its traffic mix; the configuration names the runner of
its entry point (``entries/<entry>.py``).  A run sets up (inputs from the
cache or made from fixed seeds, the program built and warmed on every shape
the cell uses), measures for ``--seconds``, then holds what the measured
window produced against the plain reference (``reference/``) and prints
each number compared beside its limit.  With ``--trace 0`` the result
carries the cell's end-to-end metrics; with ``--trace 1`` the window runs
under ``torch.profiler`` and the result carries the per-layer metrics, each
read by ``metrics/<name>.py``.  An end-to-end metric whose source is
``device_trace`` is read in the ``--trace 0`` run from a profile of device
activity alone.  The last line of standard output is the result as one JSON
object.

Exits 2 without a result when there is no card or fewer than the cell asks
for, and 3 when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):  # the harness, then the program at the checkout's root
    if p not in sys.path:
        sys.path.insert(0 if p == str(HERE) else 1, p)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(cell, seed: int, seconds: float, trace: bool, device, t0: float = T0, cache=None):
    """Set-up, the measured window, the check against the reference and
    the readers: (run, metrics, device record, breakdown or None)."""
    import torch

    from harness.core import Run, entry_runner, host_probe_s, io_bytes, metric_reader, metric_value

    runner = entry_runner(cell.config)
    with tempfile.TemporaryDirectory(prefix="h100_bench_") as tmp:
        run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
                  workdir=Path(tmp))
        if cache is not None:
            run.cache = Path(cache)
        io0 = io_bytes()
        ctx = run.facts["ctx"] = runner.setup(run)
        sync(device)
        setup_s = time.perf_counter() - t0
        run.say(f"set-up {setup_s:.4f} s")
        runner.window(run, ctx)  # traces its traced part itself when run.trace
        run.say(f"host probe {host_probe_s():.4f} s")  # the host's speed, once the window is timed
        cuda = device.type == "cuda"
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        runner.release(run, ctx)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        run.checks = runner.check(run, ctx)
        if run.trace:
            metrics = {}
            for m in cell.per_layer:
                value = metric_reader(m["name"]).read(run, ctx)
                if value is not None:
                    metrics[m["name"]] = metric_value(value, m["unit"])
        else:
            values = dict(run.end_to_end, setup_s=setup_s)
            # a device reading has no value on the CPU; on the card every one is there
            metrics = {m["name"]: metric_value(values[m["name"]], m["unit"]) for m in cell.end_to_end
                       if cuda or m["source"] != "device_trace"}
        io1 = io_bytes()
        run.say("bytes written by this run: " + ", ".join(
            f"{k} {io1[k] - io0.get(k, 0)}" for k in io1))
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    breakdown = None
    if run.trace and "trace" in run.facts:
        trace = run.facts["trace"]
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        breakdown = trace["breakdown"]
    return run, metrics, dev, breakdown


def main(argv=None) -> int:
    args = parse(argv)
    from harness.core import forbidden_modules, load_cell, result_line, use_checkout_caches

    use_checkout_caches()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # float32 stays float32: no TF32 in a product of the program or of the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, metrics, dev, breakdown = execute(cell, args.seed, args.seconds, bool(args.trace),
                                           torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"h100_bench: the run loaded {loaded}, which the port must never load", file=sys.stderr)
        return 3
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(result_line(run, metrics, dev, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
