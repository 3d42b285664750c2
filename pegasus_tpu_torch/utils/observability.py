"""Copied from ``pegasus_tpu/utils/observability.py``: ``stage_timer``, ``SceneStats``, ``retry_scene`` and ``completed_scene_ids``, unchanged but for the log prefix; ``trace``, ``enable_nan_debugging``, ``checked`` and ``assert_finite`` rewritten for torch.

Tracing, structured per-scene metrics and failure handling:

  * ``stage_timer``: wall-clock stage timing;
  * ``SceneStats``: structured per-scene throughput records (frames/s,
    splat counts) appended as JSON lines;
  * ``trace``: a ``torch.profiler`` trace around a block, written to a
    directory as a Chrome trace;
  * ``retry_scene``: per-scene retry with resumable scene index (the
    trajectory JSON on disk is the resume point);
  * ``enable_nan_debugging`` (autograd's anomaly mode), ``checked`` and
    ``assert_finite``: numerics tripwires.

The JAX package's ``checked`` carries errors as values (checkify) and its
``enable_nan_debugging`` also runs when ``PEGASUS_TPU_DEBUG_NANS`` is set at
import; here ``checked`` raises after the call, and nothing is switched on
at import (the package sets no global flag by itself).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def stage_timer(stats: Optional[dict] = None, name: str = "stage",
                verbose: bool = False):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if stats is not None:
        stats[name] = stats.get(name, 0.0) + dt
    if verbose:
        print(f"[pegasus-tpu-torch] {name}: {dt * 1000:.1f} ms")


@contextlib.contextmanager
def trace(log_dir: str = "pegasus_trace"):
    """A ``torch.profiler`` trace (host, and the card's kernels when there
    is one) around a block, written to ``log_dir/trace_<ns>.json`` as a
    Chrome trace; yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


@dataclass
class SceneStats:
    """Structured per-scene generation metrics (JSONL sink)."""

    path: Optional[str] = None
    records: list = field(default_factory=list)
    # sharded runs: one entry per batch (its scene ids and stage seconds);
    # kept in memory only, the JSONL sink holds the per-scene records
    batches: list = field(default_factory=list)

    def record(self, scene_id: int, **metrics) -> dict:
        rec = {"scene_id": scene_id, "time": time.time(), **metrics}
        self.records.append(rec)
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
        return rec

    def summary(self) -> dict:
        if not self.records:
            return {}
        fps = [r["frames_per_s"] for r in self.records if "frames_per_s" in r]
        return {
            "scenes": len(self.records),
            "mean_frames_per_s": sum(fps) / len(fps) if fps else None,
        }


def retry_scene(
    fn: Callable[[int], None],
    scene_id: int,
    max_retries: int = 2,
    on_failure: Optional[Callable] = None,
) -> bool:
    """Run one scene's generation with bounded retries (SURVEY 5 failure-
    detection gap: the reference exits hard on any error).  Returns True on
    success."""
    for attempt in range(max_retries + 1):
        try:
            fn(scene_id)
            return True
        except Exception as e:  # noqa: BLE001 — deliberate catch-all boundary
            print(
                f"[pegasus-tpu-torch] scene {scene_id} attempt {attempt + 1} "
                f"failed: {type(e).__name__}: {e}"
            )
            if on_failure:
                on_failure(scene_id, attempt, e)
    return False


def completed_scene_ids(dataset_path, dataset_name: str) -> set:
    """Scenes with finalized annotations — the resume point
    (scene_gt.json is written last, so its presence marks completion)."""
    train = Path(dataset_path) / dataset_name / "train"
    done = set()
    if train.exists():
        for scene_dir in train.iterdir():
            if (scene_dir / "scene_gt.json").exists():
                try:
                    done.add(int(scene_dir.name))
                except ValueError:
                    pass
    return done


# -- numerics debugging (the reference exposes only torch's detect_anomaly
# -- flag, default off; gs_training.py:18,45) ----------------------------------


def enable_nan_debugging(enabled: bool = True) -> None:
    """Global NaN tripwire for gradients: autograd's anomaly mode, in which
    a backward that produces NaN raises and names the forward op (``False``
    switches it off again)."""
    torch.autograd.set_detect_anomaly(enabled)


def checked(fn):
    """``fn`` wrapped so that a non-finite float anywhere in its output
    raises ``FloatingPointError`` (``assert_finite``) after the call.

        out = checked(render_frame)(scene, cam, colors)
    """

    @functools.wraps(fn)
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, name=getattr(fn, "__name__", "output"))
        return out

    return run


def _leaves(tree, path: str = ""):
    """(path, array) for every tensor or numpy array in a nest of
    dataclasses, named tuples, dicts, lists and tuples."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def assert_finite(tree, name: str = "value") -> None:
    """Finiteness audit of every float tensor or array in ``tree`` (use at
    stage boundaries: after physics, after render, before writes); raises
    ``FloatingPointError`` naming the first offending leaf."""
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point():
            bad = int((~torch.isfinite(t)).sum())
            if bad:
                raise FloatingPointError(f"{name}{path}: {bad} non-finite values")
