"""Runner of the ``generation_dynamic`` entry: whole dynamic scenes through
``pegasus_tpu_torch.generate.run_generation``.

Set-up, the window and the release are the ``generation`` entry's: one
``PEGASUS`` built once, a short warm-up scene (here dynamic, so a full
chunk's and a tail chunk's poses are warm), then rounds of scenes drawn by
``scene_draws`` from the run's seed, so that a seed gives the scenes it
gives ``gen.static`` and the two cells differ in posing alone.  The check
holds the chosen scene against ``reference.generation_dynamic``: every
frame's annotations at that frame's step, and the sampled frames each posed
by its own pose.
"""

from __future__ import annotations

import time

from harness.core import Check, entry_runner

_generation = entry_runner({"entry": "generation"})
setup = _generation.setup
window = _generation.window
release = _generation.release
check_plan = _generation.check_plan
scene_draws = _generation.scene_draws


def check(run, ctx) -> list:
    from reference.compare import generation_gaps, written_scene
    from reference.generation_dynamic import reference_dynamic_scene

    cfg, mix = run.cell.config, run.cell.traffic
    scenes = run.facts["scenes"]
    n_frames = ctx["base"].num_cameras * ctx["base"].num_camera_interpolation_steps
    j, frames = check_plan(run.seed, len(scenes), n_frames, mix["check"]["frames"])
    scene = scenes[j]
    gen = {**ctx["gen"], "min_num_objects": scene["n_objects"], "max_num_objects": scene["n_objects"]}
    t0 = time.perf_counter()
    ref = reference_dynamic_scene(ctx["root"], gen, cfg["environments"], cfg["objects"], scene["seed"],
                                  frames, run.device, run.workdir / "reference")
    scene_dir = run.workdir / scene["name"] / "train" / "000001"
    gaps = generation_gaps(written_scene(scene_dir, ref), ref)
    run.say(f"dynamic reference of {scene['name']} ({scene['n_objects']} objects, frames {frames}) "
            f"in {time.perf_counter() - t0:.3f} s")
    run.facts["checked"] = {"scene": scene, "ref": ref}
    checks = [Check(name, float(gaps[name]), float(cfg["limits"][name])) for name in cfg["limits"]]
    run.failed = int(not all(c.ok for c in checks))
    return checks


def pose_bound(run, ctx):
    """Posing's least work over the checked scene (``harness.posing``),
    counted on the reference's template of that scene."""
    from harness.posing import pose_least

    ref = run.facts["checked"]["ref"]
    return pose_least(ref["template"], len(ref["steps"]))
