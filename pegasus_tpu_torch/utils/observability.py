"""Copied from ``pegasus_tpu/utils/observability.py``: ``stage_timer``, ``SceneStats``, ``retry_scene`` and ``completed_scene_ids``, unchanged but for the log prefix.

Structured per-scene metrics and failure handling for the generation loop:

  * ``stage_timer``: wall-clock stage timing;
  * ``SceneStats``: structured per-scene throughput records (frames/s,
    splat counts) appended as JSON lines;
  * ``retry_scene``: per-scene retry with resumable scene index (the
    trajectory JSON on disk is the resume point).

The reference's ``trace``, ``checked``, ``enable_nan_debugging`` and
``assert_finite`` are tied to JAX and are not ported here.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional


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
