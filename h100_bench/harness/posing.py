"""Posing in generation: what the traced window spent inside the program's
``generate/pose`` ranges, and the least time posing's work can take.

The program opens ``generate/pose`` around posing (``PEGASUS.generate_dataset``:
static once per scene; dynamic once per scene around the pose sequence and
once per chunk around its poses).  A program without the range reads as
nothing: each reader then returns None.

Posing's least work counts only the splats that move: per frame, each
object splat's xyz, quaternion, SH bands 1-3 and body id read once, and its
xyz, quaternion and bands written once, with the FP32 operations of the
rigid motion, the quaternion product and the band rotations.  The
environment is posed by the identity and its bands are zero: a program that
leaves it alone does no less than this count, so the share cannot pass
100 % by that.
"""

from __future__ import annotations

import bisect

from harness.roofline import kernel_bound
from harness.trace import LAUNCH_KEYS, RUNTIME_PREFIXES

POSE_RANGE = "generate/pose"
SCENE_PREFIX = "h100_bench/scene"  # the generation entry's range around each scene
F32 = 4


def _holder(ranges, los, t):
    """The range of ``ranges`` (sorted, not nesting) whose interval holds
    ``t``, or None."""
    i = bisect.bisect_right(los, t) - 1
    return ranges[i] if i >= 0 and t <= ranges[i][1] else None


def pose_trace(run):
    """{"device_s", "launches", "scenes": {scene: {"device_s", "launches"}}}
    of the traced window's ``generate/pose`` ranges (a scene is the
    entry's range that holds the call; None for calls outside every scene),
    read once per run, or None where the run has no trace or the trace no
    such range.  A device event counts where the call that queued it lies
    in a range (by correlation id), kernels and copies alike; a launch
    where its call does."""
    if "trace_events" not in run.facts:
        return None
    if "pose_trace" not in run.facts:
        run.facts["pose_trace"] = _read(run.facts["trace_events"])
    return run.facts["pose_trace"]


def _read(events):
    host = [e for e in events if not e.device]
    poses = sorted((e.start_us, e.end_us, e.name) for e in host if e.user and e.name == POSE_RANGE)
    if not poses:
        return None
    scenes = sorted((e.start_us, e.end_us, e.name[len("h100_bench/"):]) for e in host
                    if e.user and e.name.startswith(SCENE_PREFIX))
    pose_los, scene_los = [r[0] for r in poses], [r[0] for r in scenes]
    queued_at = {e.corr: e.start_us for e in host if e.name.startswith(RUNTIME_PREFIXES)
                 and _holder(poses, pose_los, e.start_us) is not None}
    scene_of = lambda corr: (_holder(scenes, scene_los, queued_at[corr]) or (0, 0, None))[2]
    launches, by_scene = 0, {}
    for e in host:
        if e.name in LAUNCH_KEYS and e.corr in queued_at:
            launches += 1
            per = by_scene.setdefault(scene_of(e.corr), {"device_s": 0.0, "launches": 0})
            per["launches"] += 1
    device_s = 0.0
    for e in events:
        if not e.device or e.user or e.corr not in queued_at:
            continue
        s = (e.end_us - e.start_us) / 1e6
        device_s += s
        per = by_scene.setdefault(scene_of(e.corr), {"device_s": 0.0, "launches": 0})
        per["device_s"] += s
    return {"device_s": device_s, "launches": launches, "scenes": by_scene}


def pose_work(template, n_frames: int) -> dict:
    """Bytes and FP32 operations of posing ``template``'s object splats
    (object id other than 0) once a frame for ``n_frames`` frames."""
    cloud = template.cloud
    moving = int((cloud.object_id != 0).sum())
    bands = [2 * band + 1 for band in range(1, cloud.sh_degree + 1)]
    coeffs = 3 + 4 + 3 * sum(bands)  # xyz, quaternion, the bands' three channels
    per_splat_bytes = F32 * (2 * coeffs + 1)  # read and written once, and the body id read
    # rigid motion about the pivot (3 sub, 9 mul + 6 add, 6 add), Hamilton product (16 mul + 12 add),
    # each band's [d, d] rotation of its three channels (3 d (2d - 1))
    per_splat_ops = 24 + 28 + sum(3 * d * (2 * d - 1) for d in bands)
    return {"moving_splats": moving, "frames": n_frames,
            "bytes": n_frames * moving * per_splat_bytes, "ops": n_frames * moving * per_splat_ops}


def pose_least(template, n_frames: int) -> dict:
    """``pose_work`` with its least time on the H100 SXM's peaks
    (``least_ms``) and which peak bounds it (``bound_by``)."""
    work = pose_work(template, n_frames)
    least_ms, bound_by = kernel_bound(work["ops"], work["bytes"])
    return {**work, "least_ms": least_ms, "bound_by": bound_by}
