"""The readings a cell's limits are set from, at the cell's own size, in one
process: the program's numbers over many seeds, the control's (the plain
reference in bfloat16, in the program's place) and, for training, each
fault of the program that a step can have.

    python3 h100_bench/readings.py --workload <cell> --seeds a,b,... \\
        [--control-seeds x,y,z] [--faults half_batch,altered_tile --fault-seeds x,y,z]

Prints one JSON line per reading: {"reading", "seed", "numbers"}.  The
benchmark's own runs never run this.  Needs a card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
from contextlib import contextmanager
from pathlib import Path

HERE = Path(__file__).resolve().parent
for i, p in enumerate((str(HERE), str(HERE.parent))):
    if p not in sys.path:
        sys.path.insert(i, p)


def say(kind: str, seed, numbers: dict) -> None:
    print(json.dumps({"reading": kind, "seed": seed, "numbers": numbers}), flush=True)


# -- faults planted in the program, the way a broken change would plant them --

@contextmanager
def fault(name: str):
    """Patch the program so that its timed path carries ``name``:

    * ``state_unchanged``: a training step returns the state it was given,
      counting the step;
    * ``half_batch``: the loss is the mean over the image's upper half of
      rows only;
    * ``altered_tile``: the compositor's output has the 16 x 16 tile at
      the centre of every image set to zero where it is produced;
    * ``frozen_drop``: a physics step returns its state unchanged;
    * ``half_chunk``: the second half of every chunk of frames repeats the
      first half's frames;
    * ``densify_skipped``: training's densify/prune returns the state it
      was given;
    * ``prune_skipped``: densify/prune keeps every splat, whatever its
      opacity."""
    import torch

    from pegasus_tpu_torch import pegasus
    from pegasus_tpu_torch.ops import composite_vjp, rasterize_cuda
    from pegasus_tpu_torch.physics import rigid_body
    from pegasus_tpu_torch.training import trainer

    saved = []

    def patch(module, attr, value):
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    if name == "state_unchanged":
        patch(trainer.GSTrainer, "_apply_grads",
              lambda self, state, *a: state.replace(step=state.step + 1, count=state.count + 1))
    elif name == "half_batch":
        loss = trainer.gs_loss
        patch(trainer, "gs_loss", lambda pred, gt, lam: loss(pred[: pred.shape[0] // 2],
                                                             gt[: gt.shape[0] // 2], lam))
    elif name == "altered_tile":
        def zero_tile(out):
            out = out.clone()
            h, w = out.shape[-3] // 2, out.shape[-2] // 2
            out[..., h - 8:h + 8, w - 8:w + 8, :] = 0.0
            return out
        for module in (composite_vjp, rasterize_cuda):
            fn = module.composite_tiles

            def broken(*a, _fn=fn, **k):
                res = _fn(*a, **k)
                return (zero_tile(res[0]), res[1]) if isinstance(res, tuple) else zero_tile(res)
            broken.launches = fn.launches  # the kernel's wrapper counts its launches by this name
            patch(module, "composite_tiles", broken)
    elif name == "frozen_drop":
        patch(rigid_body, "_step", lambda params, state, *a: state)
        simulate = rigid_body._simulate_batch
        patch(rigid_body, "_simulate_batch",
              lambda *a, replay=False, **k: simulate(*a, replay=False, **k))
    elif name == "half_chunk":
        render = pegasus.render_chunk

        def halved(scene, cams, *a, **k):
            out = render(scene, cams, *a, **k)
            c = len(cams)
            if c < 2:
                return out
            idx = torch.arange(c, device=out.rgb.device)
            idx[(c + 1) // 2:] = idx[: c // 2]
            return type(out)(*(t[idx] for t in out))
        patch(pegasus, "render_chunk", halved)
    elif name == "densify_skipped":
        patch(trainer.GSTrainer, "densify_and_prune", lambda self, state, *a: state)
    elif name == "prune_skipped":
        densify = trainer.GSTrainer.densify_and_prune

        def keep_all(self, *a):
            config = self.config
            self.config = dataclasses.replace(config, min_opacity=0.0)
            try:
                return densify(self, *a)
            finally:
                self.config = config
        patch(trainer.GSTrainer, "densify_and_prune", keep_all)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for module, attr, value in reversed(saved):
            setattr(module, attr, value)


def program_numbers(runner, cell, seed: int, device, workdir: Path, ctx=None, control=False,
                    cache=None):
    """One seed of the program's timed path, the shortest window (one scene,
    or training's segments up to its first densify step), and its numbers;
    the set-up is reused where given.  With ``control``, for training also
    the control's numbers of the window's step: the reference in bfloat16
    against the reference, from the program's state before that step."""
    from harness.core import Run

    run = Run(cell=cell, seed=seed, seconds=0.0, trace=False, device=device, workdir=workdir)
    if cache is not None:
        run.cache = Path(cache)
    ctx = dict(ctx) if ctx is not None else runner.setup(run)
    runner.window(run, ctx)
    runner.release(run, ctx)
    checks = runner.check(run, ctx)
    numbers = {c.name: c.value for c in checks}
    if control and cell.config["entry"] == "training":
        return numbers, window_control(runner, cell, ctx, device)
    return numbers, None


def window_control(training, cell, ctx, device) -> dict:
    from reference.compare import window_gaps
    from reference.precision import lower_precision
    from reference.training import reference_window

    train, cap = cell.config["train"], ctx["capture"]
    pick, noise = training.window_draws(train, cap, len(ctx["scan"]["views"]), device)
    want = reference_window(ctx["scan"], train, cap.pre, pick, noise, device)
    with lower_precision():
        got = reference_window(ctx["scan"], train, cap.pre, pick, noise, device)
    post = {"cloud": {f: getattr(got["state"].cloud, f) for f in cap.pre["cloud"]},
            "mu": got["state"].mu, "nu": got["state"].nu}
    return window_gaps(cap.pre, post, want)


def control_numbers(cell, seed: int, device, workdir: Path, cache=None) -> dict:
    """The reference in bfloat16 against the reference in float32, on what
    the shortest run of ``seed`` would check."""
    from reference.compare import generation_gaps
    from reference.precision import lower_precision

    cfg, mix = cell.config, cell.traffic
    if cfg["entry"] == "generation":
        from harness.core import entry_runner
        from harness.inputs import asset_library
        from reference.generation import reference_scene

        generation = entry_runner(cfg)
        root = asset_library(cfg, **({"cache": cache} if cache else {}))
        counts = mix["object_counts"]
        draws = generation.scene_draws(seed, counts)
        round_ = [next(draws) for _ in counts]  # the shortest window: one round
        gen = {**cfg["generation"], **mix["scene"]}
        j, frames = generation.check_plan(seed, len(round_), gen["num_cameras"]
                                          * gen["num_camera_interpolation_steps"], mix["check"]["frames"])
        n_objects, scene_seed = round_[j]
        gen.update(min_num_objects=n_objects, max_num_objects=n_objects)
        want = reference_scene(root, gen, cfg["environments"], cfg["objects"], scene_seed, frames,
                               device, workdir / "f32")
        with lower_precision():
            got = reference_scene(root, gen, cfg["environments"], cfg["objects"], scene_seed, frames,
                                  device, workdir / "bf16")
        return generation_gaps(got, want)
    return training_control(cell, seed, device, cache)


def training_control(cell, seed: int, device, cache=None) -> dict:
    from harness.core import entry_runner
    from harness.inputs import load_scan, training_scan
    from reference.compare import training_gaps
    from reference.precision import lower_precision
    from reference.training import reference_steps

    training = entry_runner(cell.config)
    cfg, mix = cell.config, cell.traffic
    scan = load_scan(training_scan(cfg, device, **({"cache": cache} if cache else {})))
    seeds = training.step_seeds(seed, mix["check_steps"], len(scan["views"]))
    picks = [training.first_pick(s, len(scan["views"])) for s in seeds]
    want = reference_steps(scan, cfg["train"], picks, device)
    with lower_precision():
        got = reference_steps(scan, cfg["train"], picks, device)
    return training_gaps(got, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]

    from harness.core import entry_runner, load_cell, use_checkout_caches

    use_checkout_caches()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("readings.py needs a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    runner = entry_runner(cell.config)
    gen = cell.config["entry"] == "generation"
    with tempfile.TemporaryDirectory(prefix="h100_bench_readings_") as tmp:
        tmp = Path(tmp)
        ctx = None
        if gen and ints(args.seeds):
            from harness.core import Run

            ctx = runner.setup(Run(cell=cell, seed=0, seconds=0.0, trace=False, device=device,
                                   workdir=tmp))
        for seed in ints(args.seeds):
            numbers, control = program_numbers(runner, cell, seed, device, tmp, ctx,
                                               control=not gen)
            say("program", seed, numbers)
            if control:
                say("control:window", seed, control)
            for d in tmp.iterdir():
                if d.name.startswith(("scene", "reference")):
                    shutil.rmtree(d)
        ctx = None
        torch.cuda.empty_cache()
        for seed in ints(args.control_seeds):
            say("control", seed, control_numbers(cell, seed, device, tmp / f"control{seed}"))
        for name in [f for f in args.faults.split(",") if f]:
            for seed in ints(args.fault_seeds):
                with fault(name):
                    numbers, _ = program_numbers(runner, cell, seed, device, tmp / f"{name}{seed}", None)
                say(f"fault:{name}", seed, numbers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
