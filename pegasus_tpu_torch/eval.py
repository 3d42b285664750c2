"""Copied verbatim from ``pegasus_tpu/eval.py``; only the import lines differ, PNGs are read by ``io/png.py::read_png`` (no imageio), and the CLI names this package.

BOP pose-error metrics and dataset self-checks (L10 glue).

The reference defers evaluation to the bop_toolkit submodule (SURVEY 2.5,
L10).  bop_toolkit remains usable on our output (the formats match); this
module provides the standard pose errors natively so generated datasets
can be validated without the external dependency:

  add / adi  — (average) distance of model points, indistinguishable
               variant for symmetric objects;
  mssd       — maximum symmetry-aware surface distance;
  mspd       — maximum symmetry-aware projection distance;
  re / te    — rotation (deg) / translation errors;
  vsd        — visible surface discrepancy over a native z-buffer mesh
               depth renderer (the one metric the reference could only
               score through bop_toolkit's C++ renderer);
  check_bop_dataset — structural validation of a generated BOP tree.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _transform(R, t, pts):
    return pts @ np.asarray(R).T + np.asarray(t).reshape(1, 3)


def add(R_est, t_est, R_gt, t_gt, pts) -> float:
    """Average distance of corresponding model points (ADD)."""
    return float(
        np.linalg.norm(
            _transform(R_est, t_est, pts) - _transform(R_gt, t_gt, pts), axis=1
        ).mean()
    )


def adi(R_est, t_est, R_gt, t_gt, pts) -> float:
    """ADD-S / ADI: nearest-point distance (symmetric objects)."""
    from scipy.spatial import cKDTree

    est = _transform(R_est, t_est, pts)
    gt = _transform(R_gt, t_gt, pts)
    return float(cKDTree(est).query(gt, k=1)[0].mean())


def mssd(R_est, t_est, R_gt, t_gt, pts, syms=None) -> float:
    """Maximum symmetry-aware surface distance (bop_toolkit pose_error)."""
    syms = syms or [{"R": np.eye(3), "t": np.zeros(3)}]
    best = np.inf
    est = _transform(R_est, t_est, pts)
    for s in syms:
        pts_s = _transform(s["R"], s["t"], pts)
        gt = _transform(R_gt, t_gt, pts_s)
        best = min(best, float(np.linalg.norm(est - gt, axis=1).max()))
    return best


def _project(K, R, t, pts):
    cam = _transform(R, t, pts)
    uv = cam @ np.asarray(K).T
    return uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)


def mspd(R_est, t_est, R_gt, t_gt, K, pts, syms=None) -> float:
    """Maximum symmetry-aware projection distance."""
    syms = syms or [{"R": np.eye(3), "t": np.zeros(3)}]
    best = np.inf
    est = _project(K, R_est, t_est, pts)
    for s in syms:
        pts_s = _transform(s["R"], s["t"], pts)
        gt = _project(K, R_gt, t_gt, pts_s)
        best = min(best, float(np.linalg.norm(est - gt, axis=1).max()))
    return best


def re(R_est, R_gt) -> float:
    """Rotation error in degrees."""
    cos = (np.trace(np.asarray(R_est) @ np.asarray(R_gt).T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def te(t_est, t_gt) -> float:
    return float(np.linalg.norm(np.asarray(t_est) - np.asarray(t_gt)))


# ---------------------------------------------------------------------------
# vsd — Visible Surface Discrepancy (BOP'19), natively.
# The reference defers this one metric to bop_toolkit's C++ renderer
# (bop_toolkit_lib/pose_error.py:17); here the model depth is rendered by a
# small z-buffer mesh rasterizer so eval.py is a complete BOP19 scorer.
# ---------------------------------------------------------------------------


def render_mesh_depth(mesh, R, t, K, width: int, height: int) -> np.ndarray:
    """Z-buffer depth image (meters*input-units, 0 = background) of a
    TriMesh posed by x_cam = R x + t and projected by K.

    Dispatches to the native renderer (csrc/zbuffer.cpp — the analog of
    bop_toolkit's renderer_cpp) when it loads; the NumPy loop below is
    the portable reference with identical semantics."""
    from pegasus_tpu_torch.io import zbuffer as _zb

    native = _zb.render_depth(
        mesh.vertices, mesh.faces, R, t, K, width, height
    )
    if native is not None:
        return native
    K = np.asarray(K, np.float64)
    cam = _transform(R, t, mesh.vertices)  # [V, 3]
    z = cam[:, 2]
    uv = cam @ K.T
    uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-12)

    depth = np.zeros((height, width), np.float64)
    zbuf = np.full((height, width), np.inf)
    tris = mesh.faces
    for f in range(len(tris)):
        i0, i1, i2 = tris[f]
        if z[i0] <= 1e-6 or z[i1] <= 1e-6 or z[i2] <= 1e-6:
            continue
        p0, p1, p2 = uv[i0], uv[i1], uv[i2]
        x_min = max(int(np.floor(min(p0[0], p1[0], p2[0]))), 0)
        x_max = min(int(np.ceil(max(p0[0], p1[0], p2[0]))) + 1, width)
        y_min = max(int(np.floor(min(p0[1], p1[1], p2[1]))), 0)
        y_max = min(int(np.ceil(max(p0[1], p1[1], p2[1]))) + 1, height)
        if x_min >= x_max or y_min >= y_max:
            continue
        xs, ys = np.meshgrid(
            np.arange(x_min, x_max) + 0.5, np.arange(y_min, y_max) + 0.5
        )
        d = (p1[0] - p0[0]) * (p2[1] - p0[1]) - (p2[0] - p0[0]) * (p1[1] - p0[1])
        if abs(d) < 1e-12:
            continue
        w1 = ((xs - p0[0]) * (p2[1] - p0[1]) - (p2[0] - p0[0]) * (ys - p0[1])) / d
        w2 = ((p1[0] - p0[0]) * (ys - p0[1]) - (xs - p0[0]) * (p1[1] - p0[1])) / d
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z
        zi = 1.0 / (w0 / z[i0] + w1 / z[i1] + w2 / z[i2])
        patch_z = zbuf[y_min:y_max, x_min:x_max]
        upd = inside & (zi < patch_z)
        patch_z[upd] = zi[upd]
        depth_patch = depth[y_min:y_max, x_min:x_max]
        depth_patch[upd] = zi[upd]
    return depth


def depth_to_dist(depth: np.ndarray, K) -> np.ndarray:
    """Depth (z) image -> distance-from-camera-center image
    (bop_toolkit misc.depth_im_to_dist_im_fast semantics)."""
    K = np.asarray(K, np.float64)
    h, w = depth.shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    Xs = (xs - K[0, 2]) / K[0, 0]
    Ys = (ys - K[1, 2]) / K[1, 1]
    return np.sqrt((Xs * depth) ** 2 + (Ys * depth) ** 2 + depth.astype(np.float64) ** 2)


def _visib_mask(d_test, d_model, delta, mode="bop19"):
    """bop_toolkit visibility._estimate_visib_mask semantics."""
    d_diff = d_model.astype(np.float32) - d_test.astype(np.float32)
    if mode == "bop18":
        return (d_diff <= delta) & (d_test > 0) & (d_model > 0)
    if mode == "bop19":
        return ((d_diff <= delta) | (d_test == 0)) & (d_model > 0)
    raise ValueError(f"unknown visibility mode {mode}")


def vsd(
    R_est, t_est, R_gt, t_gt,
    depth_test: np.ndarray,
    K,
    delta: float,
    taus,
    normalized_by_diameter: bool,
    diameter: float,
    mesh,
    cost_type: str = "step",
    visib_mode: str = "bop19",
    depth_est: np.ndarray | None = None,
    depth_gt: np.ndarray | None = None,
):
    """Visible Surface Discrepancy (bop_toolkit pose_error.vsd:17-95).

    depth_test and the mesh must share units (BOP: millimeters).  Returns
    one error per tau in ``taus``.

    depth_est / depth_gt override the mesh z-buffer renders with caller
    supplied object-depth images (same shape/units as depth_test).  Used
    to score against the dataset's own splat-rendered depth and thereby
    isolate the splat-vs-mesh representation gap (VERDICT r4 item 3).
    """
    h, w = depth_test.shape
    if depth_est is None:
        depth_est = render_mesh_depth(mesh, R_est, t_est, K, w, h)
    if depth_gt is None:
        depth_gt = render_mesh_depth(mesh, R_gt, t_gt, K, w, h)

    dist_test = depth_to_dist(depth_test, K)
    dist_gt = depth_to_dist(depth_gt, K)
    dist_est = depth_to_dist(depth_est, K)

    visib_gt = _visib_mask(dist_test, dist_gt, delta, visib_mode)
    visib_est = _visib_mask(dist_test, dist_est, delta, visib_mode)
    visib_est = visib_est | (visib_gt & (dist_est > 0))

    visib_inter = visib_gt & visib_est
    visib_union = visib_gt | visib_est
    union_count = int(visib_union.sum())
    comp_count = union_count - int(visib_inter.sum())

    dists = np.abs(dist_gt[visib_inter] - dist_est[visib_inter])
    if normalized_by_diameter:
        dists = dists / diameter

    if union_count == 0:
        return [1.0] * len(taus)
    errors = []
    for tau in taus:
        if cost_type == "step":
            costs = (dists >= tau).astype(np.float64)
        elif cost_type == "tlinear":
            costs = np.minimum(dists / tau, 1.0)
        else:
            raise ValueError(f"unknown cost type {cost_type}")
        errors.append(float((costs.sum() + comp_count) / union_count))
    return errors


# ---------------------------------------------------------------------------
# BOP19 scoring (the reference's scripts/eval_bop19_pose.py flow, natively)
# ---------------------------------------------------------------------------


def load_bop_results(path) -> list:
    """Parse a BOP results CSV: scene_id,im_id,obj_id,score,R,t,time
    (R = 9 space-separated floats row-major; t in millimeters)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("scene_id"):
                continue
            scene_id, im_id, obj_id, score, R, t, tm = line.split(",")
            rows.append(
                {
                    "scene_id": int(scene_id),
                    "im_id": int(im_id),
                    "obj_id": int(obj_id),
                    "score": float(score),
                    "R": np.fromstring(R, sep=" ").reshape(3, 3),
                    "t": np.fromstring(t, sep=" "),
                    "time": float(tm),
                }
            )
    return rows


def score_bop19(
    results_path,
    dataset_root,
    dataset_name: str,
    split: str = "train",
    vsd_delta: float = 15.0,
    visib_gt_min: float = 0.1,
    max_points: int = 1000,
    return_items: bool = False,
    vsd_est_depth: str = "mesh",
) -> dict:
    """BOP-2019 Average Recall over vsd/mssd/mspd, natively.

    Protocol per scripts/eval_bop19_pose.py:16-53: vsd with taus
    0.05..0.5 (diameter-normalized, delta 15 mm) and thresholds
    0.05..0.5; mssd thresholds 0.05..0.5 x diameter; mspd thresholds
    5..50 px scaled by width/640.  AR = mean(AR_vsd, AR_mssd, AR_mspd).
    Simplifications (documented): estimates are matched to GT instances
    of the same obj_id greedily by score (the toolkit's full n_top
    matching reduces to this for the single-instance scenes PEGASUS
    emits), and symmetries default to identity.

    return_items=True adds an ``"items"`` list — one dict per scored GT
    with its per-metric recalls and visib_fract — so callers can emit
    the per-frame recall DISTRIBUTION instead of only the average
    (VERDICT r4: the vsd self-score gap must be attributable).

    vsd_est_depth selects the vsd renders: "mesh" (default, the BOP
    semantics — estimate and GT object depth from the mesh z-buffer) or
    "dataset" (both renders taken from the dataset's own splat-rendered
    depth image masked by the per-object mask_visib PNG).  "dataset" is
    only meaningful for GT-as-estimates self-scoring: it removes the
    splat-vs-mesh surface gap, so any residual vsd loss would expose a
    writer/scorer defect (depth/mask incoherence), not representation."""
    from pegasus_tpu_torch.io.mesh import load_mesh
    from pegasus_tpu_torch.io.png import read_png

    root = Path(dataset_root) / dataset_name
    with open(root / "models" / "models_info.json") as f:
        models_info = json.load(f)
    meshes = {}
    for mid in models_info:
        p = root / "models" / f"obj_{int(mid):06d}.ply"
        if p.exists():
            meshes[int(mid)] = load_mesh(p)

    results = load_bop_results(results_path)
    by_image: dict = {}
    for r in results:
        by_image.setdefault((r["scene_id"], r["im_id"]), []).append(r)

    taus = np.arange(0.05, 0.51, 0.05)
    ths = np.arange(0.05, 0.51, 0.05)
    ths_px = np.arange(5, 51, 5)

    recalls = {
        "vsd": np.zeros((len(taus), len(ths))),
        "mssd": np.zeros(len(ths)),
        "mspd": np.zeros(len(ths_px)),
    }
    n_gt = 0
    items = []

    scene_dirs = sorted((root / split).iterdir())
    for scene_dir in scene_dirs:
        if not scene_dir.is_dir():
            continue
        scene_id = int(scene_dir.name)
        with open(scene_dir / "scene_gt.json") as f:
            scene_gt = json.load(f)
        with open(scene_dir / "scene_camera.json") as f:
            scene_cam = json.load(f)
        gt_info = {}
        info_path = scene_dir / "scene_gt_info.json"
        if info_path.exists():
            with open(info_path) as f:
                gt_info = json.load(f)

        for fid, gts in scene_gt.items():
            K = np.asarray(scene_cam[fid]["cam_K"]).reshape(3, 3)
            ests = sorted(
                by_image.get((scene_id, int(fid)), []),
                key=lambda r: -r["score"],
            )
            depth_path = scene_dir / "depth" / f"{int(fid):06d}.png"
            depth_test = (
                np.asarray(read_png(depth_path)).astype(np.float64)
                if depth_path.exists()
                else None
            )
            used = set()
            for gi, gt in enumerate(gts):
                info = (gt_info.get(fid) or [None] * (gi + 1))[gi]
                if info and info.get("visib_fract", 1.0) < visib_gt_min:
                    continue
                n_gt += 1
                obj_id = int(gt["obj_id"])
                mesh = meshes.get(obj_id)
                if mesh is None:
                    continue
                pts = mesh.vertices
                if len(pts) > max_points:
                    pts = pts[:: len(pts) // max_points]
                diam = models_info[str(obj_id)]["diameter"]
                R_gt = np.asarray(gt["cam_R_m2c"]).reshape(3, 3)
                t_gt = np.asarray(gt["cam_t_m2c"])

                match = None
                for ei, e in enumerate(ests):
                    if ei in used or e["obj_id"] != obj_id:
                        continue
                    match = (ei, e)
                    break
                if match is None:
                    continue
                used.add(match[0])
                e = match[1]

                e_mssd = mssd(e["R"], e["t"], R_gt, t_gt, pts)
                rec_mssd = e_mssd < ths * diam
                recalls["mssd"] += rec_mssd
                w = int(K[0, 2] * 2)
                e_mspd = mspd(e["R"], e["t"], R_gt, t_gt, K, pts)
                rec_mspd = e_mspd < ths_px * (w / 640.0)
                recalls["mspd"] += rec_mspd
                rec_vsd = None
                if depth_test is not None:
                    d_ovr = None
                    if vsd_est_depth == "dataset":
                        mpath = (
                            scene_dir / "mask_visib"
                            / f"{int(fid):06d}_{gi:06d}.png"
                        )
                        m = np.asarray(read_png(mpath)) > 0
                        d_ovr = depth_test * m
                    e_vsd = np.asarray(
                        vsd(
                            e["R"], e["t"], R_gt, t_gt, depth_test, K,
                            vsd_delta, taus, True, diam, mesh,
                            depth_est=d_ovr, depth_gt=d_ovr,
                        )
                    )
                    rec_vsd = e_vsd[:, None] < ths[None, :]
                    recalls["vsd"] += rec_vsd
                if return_items:
                    items.append(
                        {
                            "scene_id": scene_id,
                            "im_id": int(fid),
                            "obj_id": obj_id,
                            "visib_fract": (
                                float(info["visib_fract"]) if info else None
                            ),
                            "recall_vsd": (
                                float(rec_vsd.mean())
                                if rec_vsd is not None else None
                            ),
                            "recall_mssd": float(np.mean(rec_mssd)),
                            "recall_mspd": float(np.mean(rec_mspd)),
                        }
                    )

    if n_gt == 0:
        raise ValueError("no ground-truth instances found")
    ar_vsd = float(recalls["vsd"].sum() / (n_gt * len(taus) * len(ths)))
    ar_mssd = float(recalls["mssd"].sum() / (n_gt * len(ths)))
    ar_mspd = float(recalls["mspd"].sum() / (n_gt * len(ths_px)))
    out = {
        "AR_vsd": ar_vsd,
        "AR_mssd": ar_mssd,
        "AR_mspd": ar_mspd,
        "AR": (ar_vsd + ar_mssd + ar_mspd) / 3.0,
        "n_gt": n_gt,
    }
    if return_items:
        out["items"] = items
    return out


def check_bop_dataset(dataset_root, dataset_name: str) -> dict:
    """Structural self-check of a generated BOP tree (the role
    bop_toolkit's check_results scripts play for results files).
    Returns a report dict; raises on hard violations."""
    root = Path(dataset_root) / dataset_name
    report = {"dataset": str(root), "scenes": {}, "errors": []}

    cam_path = root / "camera.json"
    if not cam_path.exists():
        report["errors"].append("missing camera.json")
    else:
        cam = json.loads(cam_path.read_text())
        for key in ("fx", "fy", "cx", "cy", "width", "height", "depth_scale"):
            if key not in cam:
                report["errors"].append(f"camera.json missing {key}")

    minfo_path = root / "models" / "models_info.json"
    model_ids = set()
    if minfo_path.exists():
        minfo = json.loads(minfo_path.read_text())
        for mid, entry in minfo.items():
            model_ids.add(int(mid))
            for key in ("diameter", "min_x", "size_x"):
                if key not in entry:
                    report["errors"].append(f"models_info[{mid}] missing {key}")
            if not (root / "models" / f"obj_{int(mid):06d}.ply").exists():
                report["errors"].append(f"missing obj_{int(mid):06d}.ply")
    else:
        report["errors"].append("missing models/models_info.json")

    train = root / "train"
    for scene_dir in sorted(train.iterdir()) if train.exists() else []:
        if not scene_dir.is_dir():
            continue
        srep = {"frames": 0, "missing": []}
        gt_path = scene_dir / "scene_gt.json"
        cam_path = scene_dir / "scene_camera.json"
        if not gt_path.exists() or not cam_path.exists():
            srep["missing"].append("scene_gt/scene_camera json")
            report["scenes"][scene_dir.name] = srep
            continue
        scene_gt = json.loads(gt_path.read_text())
        scene_cam = json.loads(cam_path.read_text())
        if set(scene_gt.keys()) != set(scene_cam.keys()):
            srep["missing"].append("frame-id mismatch gt vs camera")
        for fid, entries in scene_gt.items():
            srep["frames"] += 1
            f = int(fid)
            if not (scene_dir / "rgb" / f"{f:06d}.png").exists():
                srep["missing"].append(f"rgb/{f:06d}.png")
            for j, entry in enumerate(entries):
                R = np.asarray(entry["cam_R_m2c"]).reshape(3, 3)
                if abs(np.linalg.det(R) - 1.0) > 1e-2:
                    report["errors"].append(
                        f"{scene_dir.name}/{fid}[{j}] cam_R_m2c not a rotation"
                    )
                if model_ids and entry["obj_id"] not in model_ids:
                    report["errors"].append(
                        f"{scene_dir.name}/{fid}[{j}] unknown obj_id "
                        f"{entry['obj_id']}"
                    )
        report["scenes"][scene_dir.name] = srep

    report["ok"] = not report["errors"]
    return report


def main(argv=None) -> None:
    """CLI: score a BOP results CSV or structurally check a dataset
    (the role of bop_toolkit's eval_bop19_pose / check scripts).

        python -m pegasus_tpu_torch.eval --dataset-root out --dataset-name ds \\
            [--results estimates.csv] [--check]
    """
    import argparse

    parser = argparse.ArgumentParser(description="PEGASUS-TPU BOP evaluation")
    parser.add_argument("--dataset-root", required=True)
    parser.add_argument("--dataset-name", required=True)
    parser.add_argument("--results", help="BOP results CSV to score")
    parser.add_argument("--split", default="train")
    parser.add_argument("--check", action="store_true",
                        help="structural dataset validation")
    args = parser.parse_args(argv)

    out = {}
    if args.check or not args.results:
        out["check"] = check_bop_dataset(args.dataset_root, args.dataset_name)
    if args.results:
        out["scores"] = score_bop19(
            args.results, args.dataset_root, args.dataset_name,
            split=args.split,
        )
    print(json.dumps(out, indent=1, default=_to_json_default))


def _to_json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


if __name__ == "__main__":
    main()
