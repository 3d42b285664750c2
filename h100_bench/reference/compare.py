"""The numbers that decide ``correct``: what the program produced against
what the plain reference works out from the same inputs.  Each is a gap,
0 when the two agree; a gap of structure (other keys, other lengths, a
missing file) is infinite.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

INF = float("inf")


def _leaf_gap(a, b) -> float:
    """Largest |a - b| / max(1, |b|) over the numbers of two JSON trees."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or a.keys() != b.keys():
            return INF
        return max((_leaf_gap(a[k], b[k]) for k in b), default=0.0)
    if isinstance(b, (list, tuple)):
        if not isinstance(a, (list, tuple)) or len(a) != len(b):
            return INF
        return max((_leaf_gap(x, y) for x, y in zip(a, b)), default=0.0)
    if isinstance(b, bool) or isinstance(a, bool):
        return 0.0 if a == b else INF
    if isinstance(b, (int, float)) and isinstance(a, (int, float)):
        return abs(float(a) - float(b)) / max(1.0, abs(float(b)))
    return 0.0 if a == b else INF


def _png(path: Path):
    from reference.frozen.io.png import read_png

    return np.asarray(read_png(path)) if path.exists() else None


GEN_NUMBERS = ("annot", "rgb_rmse", "depth_off", "mask_off", "sem_off")


def written_scene(scene_dir: Path, ref: dict):
    """What the program wrote for the frames ``ref`` holds, in the shape of
    ``reference_scene``'s result, or None where a file is missing or
    unreadable."""
    try:
        written = {name: json.loads((scene_dir / f"{name}.json").read_text())
                   for name in ("scene_camera", "scene_gt", "scene_gt_info")}
    except (OSError, ValueError):
        return None
    images = {}
    for f, want in ref["images"].items():
        name = f"{f:06d}.png"
        k = want["mask"].shape[-1]
        got = {sub: _png(scene_dir / sub / name) for sub in ("rgb", "depth", "sem_mask")}
        am = [_png(scene_dir / "mask" / f"{f:06d}_{j:06d}.png") for j in range(k)]
        vi = [_png(scene_dir / "mask_visib" / f"{f:06d}_{j:06d}.png") for j in range(k)]
        if any(x is None for x in [*got.values(), *am, *vi]):
            return None
        got["mask"] = np.stack(am, -1) > 127
        got["mask_visib"] = np.stack(vi, -1) > 127
        images[f] = got
    return {"scene_camera": written["scene_camera"], "scene_gt": written["scene_gt"],
            "gt_info": {f: written["scene_gt_info"].get(f) for f in ref["gt_info"]},
            "images": images}


def generation_gaps(got, want: dict) -> dict:
    """annot: scene_camera and scene_gt of every frame and the sampled
    frames' gt_info; rgb_rmse: the worst sampled frame's RMS difference in
    8-bit levels; depth_off: the share of pixels whose depth differs by more
    than 1 mm; mask_off, sem_off: the share of mask and semantic-mask
    pixels that differ.  ``got`` is ``written_scene``'s result (None: every
    number infinite) or a second reference."""
    if got is None:
        return dict.fromkeys(GEN_NUMBERS, INF)
    gaps = {"annot": max(_leaf_gap(got[k], want[k]) for k in ("scene_camera", "scene_gt", "gt_info"))}
    rmse, depth, masks, sem = [], [0, 0], [0, 0], [0, 0]
    for f, w in want["images"].items():
        g = got["images"][f]
        if any(g[k].shape != w[k].shape for k in w):
            return {**gaps, **dict.fromkeys(GEN_NUMBERS[1:], INF)}
        diff = g["rgb"].astype(np.float64) - w["rgb"]
        rmse.append(math.sqrt(float(np.mean(diff * diff))))
        depth[0] += int((np.abs(g["depth"].astype(np.int64) - w["depth"].astype(np.int64)) > 1).sum())
        depth[1] += w["depth"].size
        for k in ("mask", "mask_visib"):
            masks[0] += int((g[k] != w[k]).sum())
            masks[1] += w[k].size
        sem[0] += int(np.any(g["sem_mask"] != w["sem_mask"], axis=-1).sum())
        sem[1] += w["sem_mask"].shape[0] * w["sem_mask"].shape[1]
    gaps["rgb_rmse"] = max(rmse)
    gaps["depth_off"] = depth[0] / depth[1]
    gaps["mask_off"] = masks[0] / max(masks[1], 1)
    gaps["sem_off"] = sem[0] / sem[1]
    return gaps


def _norms(tree: dict) -> dict:
    return {g: float(torch.linalg.vector_norm(v.double())) for g, v in tree.items()}


def training_gaps(program: dict, ref: dict) -> dict:
    """loss: the largest relative gap of a step's loss; grad: the worst
    group's gap between the two first gradients' norms; change: the worst
    group's gap between the norms of the parameters' change after the
    steps.  A group's gap is measured against the reference's norm of that
    group or of the median group, whichever is larger.  ``change`` leaves
    out groups whose reference gradient is under a thousandth of the median
    group's: they move by round-off alone."""
    losses = [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"])]
    if len(program["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, losses)):
        return {"loss": INF, "grad": INF, "change": INF}
    g_ref, g_prog = _norms(ref["grad"]), _norms(program["grad"])
    g_med = float(np.median(list(g_ref.values())))
    moved = [g for g in g_ref if g_ref[g] >= 1e-3 * g_med]
    c_ref, c_prog = _norms(ref["change"]), _norms(program["change"])
    return {"loss": max(losses), "grad": _worst(g_prog, g_ref, list(g_ref)),
            "change": _worst(c_prog, c_ref, moved)}


WINDOW_NUMBERS = ("densify_alive", "densify_change", "densify_moments")


def window_gaps(pre: dict, post: dict, ref: dict) -> dict:
    """The window's densify step, from the program's state ``pre`` before
    it: densify_alive: the share of slots whose alive flag differs between
    the program's state after it (``post``) and the reference's, over the
    reference's alive count; densify_change: the worst group's gap between
    the norms of the parameters' change over the step, groups left out as
    in ``training_gaps``; densify_moments: the worst group's gap between
    the norms of Adam's first and second moments after it, each against
    the larger of its own and the median group's reference norm."""
    state = ref["state"]
    pass
    alive_ref = state.cloud.alive
    if post["cloud"]["alive"].shape != alive_ref.shape:
        return dict.fromkeys(WINDOW_NUMBERS, INF)
    out = {"densify_alive": int((post["cloud"]["alive"] != alive_ref).sum())
           / max(int(alive_ref.sum()), 1)}
    g_ref = _norms(ref["grad"])
    g_med = float(np.median(list(g_ref.values())))
    moved = [g for g in g_ref if g_ref[g] >= 1e-3 * g_med]
    c_ref = _norms({g: getattr(state.cloud, g) - pre["cloud"][g] for g in moved})
    c_prog = _norms({g: post["cloud"][g] - pre["cloud"][g] for g in moved})
    out["densify_change"] = _worst(c_prog, c_ref, moved)
    out["densify_moments"] = max(_worst(_norms(post[k]), _norms(getattr(state, k)), list(g_ref))
                                 for k in ("mu", "nu"))
    return out


def _worst(prog: dict, refn: dict, groups) -> float:
    """The worst group's |prog - ref| over the larger of its own and the
    median group's reference norm."""
    med = float(np.median([refn[g] for g in groups]))
    gaps = [abs(prog[g] - refn[g]) / max(refn[g], med) if max(refn[g], med) > 0
            else (0.0 if prog[g] == 0 else INF) for g in groups]
    return max(gaps) if gaps and all(map(math.isfinite, gaps)) else INF
