"""The readings ``gen.dynamic``'s limits are held against, at the cell's own
size, in one process: the program's numbers over seeds, the control's (the
plain dynamic reference in bfloat16, in the program's place) and each fault
of posing that a dynamic scene can have.

    python3 h100_bench/readings_dynamic.py [--seeds a,b,...] [--control-seeds x,y]
        [--faults step_behind,step_zero,frozen_gt,sh_unrotated --fault-seeds x,y]

Prints one JSON line per reading: {"reading", "seed", "numbers"}.  The
program's readings and the faults share one set-up; each runs the shortest
window (one round of scenes) and its check.  The benchmark's own runs never
run this.  Needs a card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from contextlib import contextmanager, nullcontext
from pathlib import Path

HERE = Path(__file__).resolve().parent
for i, p in enumerate((str(HERE), str(HERE.parent))):
    if p not in sys.path:
        sys.path.insert(i, p)

CELL = "gen.dynamic"
FAULTS = ("step_behind", "step_zero", "frozen_gt", "sh_unrotated")


@contextmanager
def fault(name: str):
    """Patch the program so that its dynamic scenes carry ``name``:

    * ``step_behind``: frame ``i`` is posed, and its ground truth written,
      at step ``i - 1`` (frame 0 at step 0);
    * ``step_zero``: every frame is posed at the drop's first step;
    * ``frozen_gt``: ``freeze_dynamic_gt_pose=True``, the source's quirk:
      every frame's ground truth holds the first step's poses;
    * ``sh_unrotated``: posing leaves the SH bands 1-3 as they are."""
    import numpy as np
    import torch

    from pegasus_tpu_torch.pegasus import PEGASUS
    from pegasus_tpu_torch.utils import sh

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name in ("step_behind", "step_zero"):
        at = PEGASUS._body_poses_at
        shift = ((lambda s: np.maximum(np.asarray(s) - 1, 0)) if name == "step_behind"
                 else (lambda s: np.zeros_like(np.asarray(s))))
        patch(PEGASUS, "_body_poses_at", lambda self, step, _at=at: _at(self, shift(step)))
    elif name == "frozen_gt":
        generate = PEGASUS.generate_dataset

        def frozen(self, *a, _generate=generate, **k):
            self.freeze_dynamic_gt_pose = True
            try:
                return _generate(self, *a, **k)
            finally:
                self.freeze_dynamic_gt_pose = False
        patch(PEGASUS, "generate_dataset", frozen)
    elif name == "sh_unrotated":
        def identity(R, band):
            d = 2 * band + 1
            return torch.eye(d, dtype=R.dtype, device=R.device).expand(*R.shape[:-2], d, d)
        patch(sh, "sh_band_rotation", identity)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def control_numbers(cell, seed: int, device, workdir: Path, cache=None) -> dict:
    """The dynamic reference in bfloat16 against the reference in float32,
    on what the shortest run of ``seed`` would check."""
    from harness.core import entry_runner
    from harness.inputs import asset_library
    from reference.compare import generation_gaps
    from reference.generation_dynamic import reference_dynamic_scene
    from reference.precision import lower_precision

    cfg, mix = cell.config, cell.traffic
    runner = entry_runner(cfg)
    root = asset_library(cfg, **({"cache": cache} if cache else {}))
    counts = mix["object_counts"]
    draws = runner.scene_draws(seed, counts)
    round_ = [next(draws) for _ in counts]  # the shortest window: one round
    gen = {**cfg["generation"], **mix["scene"]}
    j, frames = runner.check_plan(seed, len(round_), gen["num_cameras"]
                                  * gen["num_camera_interpolation_steps"], mix["check"]["frames"])
    n_objects, scene_seed = round_[j]
    gen.update(min_num_objects=n_objects, max_num_objects=n_objects)
    args = (root, gen, cfg["environments"], cfg["objects"], scene_seed, frames, device)
    want = reference_dynamic_scene(*args, workdir / "f32")
    with lower_precision():
        got = reference_dynamic_scene(*args, workdir / "bf16")
    return generation_gaps(got, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]

    from harness.core import Run, entry_runner, load_cell, use_checkout_caches

    use_checkout_caches()
    cell = load_cell(CELL)
    import torch

    import readings

    if not torch.cuda.is_available():
        print("readings_dynamic.py needs a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    runner = entry_runner(cell.config)
    faults = [f for f in args.faults.split(",") if f]
    with tempfile.TemporaryDirectory(prefix="h100_bench_readings_") as tmp:
        tmp = Path(tmp)
        ctx = None
        if ints(args.seeds) or faults:
            ctx = runner.setup(Run(cell=cell, seed=0, seconds=0.0, trace=False, device=device,
                                   workdir=tmp))
        readings_of = [("program", None, s) for s in ints(args.seeds)]
        readings_of += [(f"fault:{f}", f, s) for f in faults for s in ints(args.fault_seeds)]
        for kind, name, seed in readings_of:
            with fault(name) if name else nullcontext():
                numbers, _ = readings.program_numbers(runner, cell, seed, device, tmp, ctx)
            readings.say(kind, seed, numbers)
            for d in tmp.iterdir():
                if d.name.startswith(("scene", "reference")):
                    shutil.rmtree(d)
        ctx = None
        torch.cuda.empty_cache()
        for seed in ints(args.control_seeds):
            readings.say("control", seed, control_numbers(cell, seed, device, tmp / f"control{seed}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
