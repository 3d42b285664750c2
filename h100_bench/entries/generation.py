"""Runner of the ``generation`` entry: whole scenes through
``pegasus_tpu_torch.generate.run_generation``.

Set-up builds one ``PEGASUS`` (every asset's cloud on the device, as
``run_generation`` builds it) and generates one short scene to warm every
shape a scene uses: the kernels and the PNG encoder are built, a drop is
captured, a full chunk and a tail chunk render.  The window then runs
scenes one after another, each with ``num_scenes=1`` in a dataset of its
own (so ``finalize_dataset``'s gt-info and image-wise conversion stay per
scene), the shared ``PEGASUS`` re-seeded per scene.  Scenes come in
rounds, one scene per object count of the mix's list in an order shuffled
by the run's seed, until ``--seconds`` have passed; the round in progress
is finished, so every run does the same work per round whatever its seed.
"""

from __future__ import annotations

import dataclasses
import shutil
import time

import numpy as np
import torch

from harness.core import Check, host_account
from harness.inputs import asset_library
from harness.trace import spans_around, traced


def _scene_config(base, name: str, n_objects: int, seed: int):
    return dataclasses.replace(base, dataset_name=name, min_num_objects=n_objects,
                               max_num_objects=n_objects, seed=seed)


def setup(run) -> dict:
    from pegasus_tpu_torch.assets.rosters import ENV_CLASSES, YCB_CLASSES
    from pegasus_tpu_torch.config import GenerationConfig
    from pegasus_tpu_torch.generate import run_generation
    from pegasus_tpu_torch.pegasus import PEGASUS

    cfg, mix = run.cell.config, run.cell.traffic
    root = asset_library(cfg, cache=run.cache, say=run.say)
    envs = [ENV_CLASSES[n](str(root)) for n in cfg["environments"]]
    objs = [YCB_CLASSES[n](str(root)) for n in cfg["objects"]]
    gen = {**cfg["generation"], **mix["scene"]}
    base = GenerationConfig(**gen, dataset_path=str(root), env_dataset_path=str(root),
                            dataset_base_path=str(run.workdir), num_scenes=1)
    # run_generation's own construction of PEGASUS (quiet: no progress bar), kept for every scene
    pegasus = PEGASUS(
        dataset_path=base.dataset_path, env_dataset_path=base.env_dataset_path,
        urdf_asset_folder=str(root / "urdf"), gs_env_list=envs, gs_object_list=objs,
        mode=base.mode, camera_trajectory_mode=base.camera_trajectory_mode,
        render_height=base.render_height, render_width=base.render_width,
        num_cameras=base.num_cameras, simulation_steps=base.simulation_steps,
        num_camera_interpolation_steps=base.num_camera_interpolation_steps,
        dataset_base_path=base.dataset_base_path, background=base.background, seed=base.seed,
        splat_budget=base.splat_budget, unit_scale=base.unit_scale, frame_chunk=base.frame_chunk,
        compact_readback=base.compact_readback, QUIET=True, device=run.device,
    )
    warm = mix["warmup"]
    warm_cfg = dataclasses.replace(
        _scene_config(base, "warmup", max(mix["object_counts"]), warm["seed"]),
        num_cameras=warm["cameras"], num_camera_interpolation_steps=warm["interpolation_steps"])
    pegasus.rng = np.random.default_rng(warm["seed"])
    run_generation(warm_cfg, envs, objs, pegasus=pegasus, device=run.device)
    shutil.rmtree(run.workdir / "warmup")
    return {"root": root, "envs": envs, "objs": objs, "base": base, "pegasus": pegasus,
            "gen": gen, "run_generation": run_generation}


def window(run, ctx) -> None:
    scenes, records = [], []
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    with traced(run, run.trace), spans_around(run.trace, _layers()), host_account(run, "the window"):
        t0 = time.perf_counter()
        wall = _scenes(run, ctx, scenes, records, t0)
    frames = sum(int(r["frames"]) for r in records)
    run.end_to_end["frames_per_s"] = frames / wall
    run.attempted = len(scenes)
    run.facts.update(scenes=scenes, records=records, frames=frames, wall_s=wall)
    secs = sorted(float(r["seconds"]) for r in records)
    run.say(f"window: {len(scenes)} scenes, {frames} frames in {wall:.4f} s; seconds per scene "
            f"median {float(np.median(secs)):.4f}, max {secs[-1]:.4f} (n = {len(secs)})")


def _layers():
    """The program's calls a traced window puts spans around: a scene's
    stages as ``run_generation`` calls them, and the dataset's finish."""
    from pegasus_tpu_torch import generate
    from pegasus_tpu_torch.pegasus import PEGASUS

    return [(PEGASUS, "init_bullet"), (PEGASUS, "init"), (PEGASUS, "init_start_position"),
            (PEGASUS, "generate_dataset"), (PEGASUS, "save2bop"), (generate, "write_models"),
            (generate, "finalize_dataset")]


def scene_draws(seed: int, object_counts):
    """(object count, scene seed) of the window's scenes, in order: rounds
    of the mix's counts, each round shuffled, all drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    while True:
        for n in rng.permutation(object_counts):
            yield int(n), int(rng.integers(0, 2**63 - 1))


def check_plan(seed: int, n_scenes: int, n_frames: int, n_checked: int):
    """The scene a run checks and its frames: the first, the last, and
    others drawn from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    j = int(rng.integers(0, n_scenes))
    picks = rng.choice(np.arange(1, n_frames - 1), n_checked - 2, replace=False)
    return j, sorted({0, n_frames - 1, *(int(f) for f in picks)})


def _scenes(run, ctx, scenes, records, t0) -> float:
    """Rounds of scenes until ``run.seconds`` have passed since ``t0``;
    the wall seconds to the last one's files closed."""
    from torch.profiler import record_function

    counts = run.cell.traffic["object_counts"]
    draws = scene_draws(run.seed, counts)
    while not scenes or len(scenes) % len(counts) or time.perf_counter() - t0 < run.seconds:
        i = len(scenes)
        n_objects, seed = next(draws)
        scene = {"name": f"scene{i:03d}", "n_objects": n_objects, "seed": seed}
        config = _scene_config(ctx["base"], scene["name"], scene["n_objects"], scene["seed"])
        ctx["pegasus"].rng = np.random.default_rng(scene["seed"])
        with record_function(f"h100_bench/{scene['name']}"):
            stats = ctx["run_generation"](config, ctx["envs"], ctx["objs"], pegasus=ctx["pegasus"],
                                          device=run.device)
        records.append(stats.records[-1])
        scenes.append(scene)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    return time.perf_counter() - t0


def release(run, ctx) -> None:
    """The program's state goes before the reference runs."""
    for key in ("pegasus", "run_generation", "envs", "objs"):
        ctx.pop(key, None)


def check(run, ctx) -> list:
    from reference.compare import generation_gaps, written_scene
    from reference.generation import reference_scene

    cfg, mix = run.cell.config, run.cell.traffic
    scenes = run.facts["scenes"]
    n_frames = ctx["base"].num_cameras * ctx["base"].num_camera_interpolation_steps
    j, frames = check_plan(run.seed, len(scenes), n_frames, mix["check"]["frames"])
    scene = scenes[j]
    gen = {**ctx["gen"], "min_num_objects": scene["n_objects"], "max_num_objects": scene["n_objects"]}
    t0 = time.perf_counter()
    ref = reference_scene(ctx["root"], gen, cfg["environments"], cfg["objects"], scene["seed"],
                          frames, run.device, run.workdir / "reference")
    scene_dir = run.workdir / scene["name"] / "train" / "000001"
    gaps = generation_gaps(written_scene(scene_dir, ref), ref)
    run.say(f"reference of {scene['name']} ({scene['n_objects']} objects, frames {frames}) "
            f"in {time.perf_counter() - t0:.3f} s")
    run.facts["checked"] = {"scene": scene, "ref": ref}
    checks = [Check(name, float(gaps[name]), float(cfg["limits"][name])) for name in cfg["limits"]]
    run.failed = int(not all(c.ok for c in checks))
    return checks


def k1_bounds(run, ctx):
    """K1's least times (``harness.roofline.Bounds``) over the checked
    scene's frames in chunks of ``frame_chunk``, on bins the frozen binning
    makes from the reference's posed scene and cameras."""
    from harness.roofline import Bounds
    from reference.frozen.camera import CameraBatch
    from reference.frozen.ops.binning import bin_splats
    from reference.frozen.ops.rasterize_cuda import project_gaussians

    ref = run.facts["checked"]["ref"]
    cams, scene, k = ref["cams"], ref["scene"], ref["n_objects"] + 1
    chunk = ctx["base"].frame_chunk
    bounds = Bounds()
    with torch.no_grad():
        for lo in range(0, len(cams), chunk):
            batch = CameraBatch.stack(cams[lo:lo + chunk])
            bins = bin_splats(project_gaussians(scene, batch), batch.width, batch.height)
            bounds.add(bins, batch.width, batch.height, k)
    return bounds
