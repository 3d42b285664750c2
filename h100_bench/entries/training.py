"""Runner of the ``training`` entry: ``GSTrainer.train`` on a cached scan.

Set-up builds one trainer and its state as the training wrapper does (the
first cloud from the scan's seed points, capacity and schedule of the
configuration) and takes the first steps through ``train`` itself, one
iteration per call with a seed chosen so that each step sees another view.
Those steps build the kernels, and what they did is what the reference is
held against.  The window continues the same state in segments of
``train`` calls, each with its own seed drawn from the run's, until
``--seconds`` have passed and the window has run its first densify step;
the segment in progress is finished.  Through ``train``'s iteration hook
the window keeps a copy of the program's state on the step before that
densify step and on the step itself: the reference takes the one step and
the densify/prune from the first copy and is held against the second.

The end-to-end reading is the device's busy time per iteration over every
segment of the window, each segment profiled for device activity alone
(``harness.trace.DeviceClock``).  The wall per iteration, which follows the
host's speed, is a per-layer reading of the traced run, over the segments
after the traced one, which run with no profiler at all.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext

import numpy as np
import torch

from harness.core import Check, host_account
from harness.inputs import load_scan, training_scan
from harness.trace import DeviceClock, traced

GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot")


def first_pick(seed: int, n_views: int) -> int:
    """The view ``GSTrainer.train(..., iterations=1, seed=seed)`` trains on."""
    return int(np.random.default_rng(seed).integers(0, n_views))


def step_seeds(seed: int, n: int, n_views: int) -> list:
    """Seeds of ``n`` single-step ``train`` calls on ``n`` different views."""
    rng = np.random.default_rng([seed, 2])
    seeds, views = [], set()
    while len(seeds) < n:
        s = int(rng.integers(0, 2**31))
        v = first_pick(s, n_views)
        if v not in views:
            seeds.append(s)
            views.add(v)
    return seeds


def densify_steps(train: dict, after: int, upto: int) -> list:
    """The global steps in (after, upto] on which ``train`` densifies."""
    return [s for s in range(after + 1, upto + 1)
            if train["densify_from_iter"] <= s <= train["densify_until_iter"]
            and s % train["densification_interval"] == 0]


def _copy(state, full: bool) -> dict:
    """A copy of a training state's cloud and Adam moments; with ``full``,
    of everything the next step reads."""
    out = {"cloud": {f.name: getattr(state.cloud, f.name).clone()
                     for f in dataclasses.fields(state.cloud)},
           "mu": {g: v.clone() for g, v in state.mu.items()},
           "nu": {g: v.clone() for g, v in state.nu.items()}, "step": int(state.step)}
    if full:
        out.update(xyz_grad_accum=state.xyz_grad_accum.clone(), denom=state.denom.clone(),
                   max_radii2d=state.max_radii2d.clone(), count=int(state.count),
                   spatial_lr_scale=float(state.spatial_lr_scale))
    return out


class Capture:
    """Iteration hook of the window: the program's state after step
    ``step - 1`` (``pre``) and after step ``step`` (``post``), and the
    segment (its seed and the step it started from) that ran ``step``."""

    def __init__(self, step: int):
        self.step, self.pre, self.post, self.segment, self.current = step, None, None, None, None

    def __call__(self, state, gstep: int) -> None:
        if gstep == self.step - 1:
            self.pre = _copy(state, full=True)
        elif gstep == self.step and self.pre is not None:
            self.post = _copy(state, full=False)
            self.segment = self.current

    @property
    def done(self) -> bool:
        return self.post is not None


def setup(run) -> dict:
    from pegasus_tpu_torch.camera import Camera
    from pegasus_tpu_torch.training.trainer import GSTrainer, TrainConfig, init_from_points

    cfg, mix = run.cell.config, run.cell.traffic
    scan = load_scan(training_scan(cfg, run.device, cache=run.cache, say=run.say))
    size = int(scan["views"].shape[1])
    fov = float(scan["fov"])
    cams = [Camera.from_colmap(q, t, fov, fov, size, size, device=run.device)
            for q, t in zip(scan["qvec"], scan["tvec"])]
    images = [torch.tensor(im, device=run.device) for im in scan["images"]]
    config = TrainConfig(**cfg["train"])
    trainer = GSTrainer(config, width=size, height=size, backend=cfg["backend"], device=run.device)
    cloud0 = init_from_points(scan["points"], scan["point_colors"], config, device=run.device)
    state = trainer.init_state(cloud0, spatial_lr_scale=scan["extent"])
    if state.step != mix["start_iteration"]:
        raise ValueError(f"the mix starts at iteration {mix['start_iteration']}, the state at {state.step}")
    start = {g: getattr(state.cloud, g).clone() for g in GROUPS}
    seeds = step_seeds(run.seed, mix["check_steps"], len(cams))
    losses, grad = [], None
    for s in seeds:
        state, metrics = trainer.train(state, cams, images, iterations=1, seed=s,
                                       scene_extent=scan["extent"])
        losses.append(float(metrics["loss"]))
        if grad is None:  # Adam's first moment after one update is (1 - b1) g
            grad = {g: (state.mu[g] / (1 - 0.9)).clone() for g in GROUPS}
    program = {"losses": losses, "grad": grad,
               "change": {g: getattr(state.cloud, g) - start[g] for g in GROUPS},
               "picks": [first_pick(s, len(cams)) for s in seeds]}
    clock = None
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        if not run.trace:  # the profiler's start-up goes to set-up
            clock = DeviceClock(run.device)
            with clock.stretch():
                torch.ones(1, device=run.device).add_(1)
            clock.results.clear()
    return {"scan": scan, "cams": cams, "images": images, "trainer": trainer, "state": state,
            "program": program, "clock": clock}


def window(run, ctx) -> None:
    mix = run.cell.traffic
    rng = np.random.default_rng([run.seed, 3])
    segments = []
    step = int(ctx["state"].step)
    ahead = densify_steps(run.cell.config["train"], step + 1, run.cell.config["train"]["iterations"])
    capture = ctx["capture"] = Capture(ahead[0] if ahead else step + 2)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    t0 = time.perf_counter()
    if run.trace:  # the traced part: the first segment, with each step's cloud kept
        with traced(run, True):
            _segment(run, ctx, rng, segments, mix["traced_iterations"], keep=True)
        run.facts["traced_iterations"] = mix["traced_iterations"]
    clock = ctx["clock"]
    t1, untraced = time.perf_counter(), len(segments)
    with host_account(run, "the window"):
        while not segments or time.perf_counter() - t0 < run.seconds or not capture.done:
            with clock.stretch() if clock else nullcontext():
                _segment(run, ctx, rng, segments, mix["segment_iterations"])
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    t2 = time.perf_counter()
    wall = t2 - t0
    iterations = sum(s["iterations"] for s in segments)
    after = sum(s["iterations"] for s in segments[untraced:])
    if after:
        run.facts["wall_ms_per_iter"] = 1e3 * (t2 - t1) / after
    if clock:
        t3 = time.perf_counter()
        busy = clock.reduce()
        run.end_to_end["device_ms_per_iter"] = 1e3 * busy["busy_s"] / iterations
        run.say(f"device busy {busy['busy_s']:.6f} s over {iterations} iterations: "
                f"{busy['device_events']} device events, {busy['launches']} launches, "
                f"{busy['lost']} of them with no device event; reduced in {time.perf_counter() - t3:.3f} s")
    run.attempted = iterations
    run.facts.update(segments=segments, iterations=iterations, wall_s=wall,
                     alive=int(ctx["state"].cloud.alive.sum()), step=int(ctx["state"].step))
    per = [1e3 * s["host_s"] / s["iterations"] for s in segments]
    run.say(f"window: {iterations} iterations (to step {ctx['state'].step}, "
            f"{run.facts['alive']} alive) in {wall:.4f} s"
            + (f", wall per iteration {run.facts['wall_ms_per_iter']:.4f} ms after the traced part"
               if run.trace and after else "") + "; ms per iteration inside each segment's train call "
            f"median {float(np.median(per)):.4f}, max {max(per):.4f} (n = {len(per)}): "
            + " ".join(f"{v:.2f}" for v in per))


def _segment(run, ctx, rng, segments, n: int, keep: bool = False) -> None:
    """One ``train`` call of ``n`` iterations with a seed from ``rng``;
    with ``keep``, the cloud each step starts from."""
    from torch.profiler import record_function

    seed = int(rng.integers(0, 2**31))
    kept = [ctx["state"].cloud] if keep else []
    capture = ctx["capture"]
    capture.current = (seed, int(ctx["state"].step))

    def hook(state, step):
        capture(state, step)
        if keep and len(kept) < n:
            kept.append(state.cloud)

    t0 = time.perf_counter()
    with record_function(f"h100_bench/segment{len(segments):03d}"):
        ctx["state"], _ = ctx["trainer"].train(ctx["state"], ctx["cams"], ctx["images"], iterations=n,
                                               seed=seed, scene_extent=ctx["scan"]["extent"],
                                               iteration_hook=hook)
    segments.append({"seed": seed, "iterations": n, "clouds": kept,
                     "step0": int(ctx["state"].step) - n, "host_s": time.perf_counter() - t0})


def release(run, ctx) -> None:
    for key in ("trainer", "state", "cams", "images", "clock"):
        ctx.pop(key, None)


def window_draws(train: dict, capture: Capture, n_views: int, device):
    """What ``train`` drew for the captured step from its segment's seed:
    the view it trained on, and the two standard-normal draws of its
    densify/prune (the segment's generator, advanced past the segment's
    earlier densify steps), or None where the step does not densify."""
    seed, step0 = capture.segment
    rng = np.random.default_rng(seed)
    pick = [int(rng.integers(0, n_views)) for _ in range(capture.step - step0)][-1]
    gen = torch.Generator(device=device).manual_seed(seed)
    kmax = min(train["max_split_per_round"], train["capacity"])
    noise = None
    for _ in densify_steps(train, step0, capture.step):
        noise = (torch.randn((kmax, 3), generator=gen, device=device),
                 torch.randn((train["capacity"], 3), generator=gen, device=device))
    return pick, (noise if capture.step in densify_steps(train, step0, capture.step) else None)


def check(run, ctx) -> list:
    from reference.compare import training_gaps, window_gaps
    from reference.training import reference_steps, reference_window

    cfg = run.cell.config
    t0 = time.perf_counter()
    ref = reference_steps(ctx["scan"], cfg["train"], ctx["program"]["picks"], run.device)
    gaps = training_gaps(ctx["program"], ref)
    run.say(f"reference of {len(ref['losses'])} steps on views {ctx['program']['picks']} in "
            f"{time.perf_counter() - t0:.3f} s; losses program {ctx['program']['losses']} "
            f"reference {ref['losses']}")
    cap, t0 = ctx["capture"], time.perf_counter()
    pick, noise = window_draws(cfg["train"], cap, len(ctx["scan"]["views"]), run.device)
    win = reference_window(ctx["scan"], cfg["train"], cap.pre, pick, noise, run.device)
    gaps.update(window_gaps(cap.pre, cap.post, win))
    alive = [int(x["cloud"]["alive"].sum()) for x in (cap.pre, cap.post)]
    run.say(f"reference of the window's step {cap.step} (view {pick}, densify) in "
            f"{time.perf_counter() - t0:.3f} s; alive {alive[0]} -> program {alive[1]}, "
            f"reference {int(win['state'].cloud.alive.sum())}")
    checks = [Check(name, float(gaps[name]), float(cfg["limits"][name])) for name in cfg["limits"]]
    run.failed = int(not all(c.ok for c in checks))
    return checks


def compositor_bounds(run, ctx):
    """K2' and K3 least times (``harness.roofline.Bounds``) over the traced
    segment's steps, on bins the frozen binning makes from each step's own
    cloud and view."""
    from harness.roofline import Bounds
    from reference.frozen.camera import Camera
    from reference.frozen.gs.cloud import GaussianCloud
    from reference.frozen.ops.binning import bin_splats
    from reference.frozen.ops.projection import project_gaussians

    scan, seg = ctx["scan"], run.facts["segments"][0]
    size, fov = int(scan["views"].shape[1]), float(scan["fov"])
    rng = np.random.default_rng(seg["seed"])  # train's own draws, one per iteration
    picks = [int(rng.integers(0, len(scan["views"]))) for _ in range(seg["iterations"])]
    sh_interval = run.cell.config["train"]["sh_increase_interval"]
    max_sh = run.cell.config["train"]["max_sh_degree"]
    bounds = Bounds()
    step0 = seg["step0"]
    with torch.no_grad():
        for i, (cloud, idx) in enumerate(zip(seg["clouds"], picks)):
            frozen = GaussianCloud(**{f.name: getattr(cloud, f.name)
                                      for f in dataclasses.fields(GaussianCloud)})
            deg = min((step0 + i) // sh_interval, max_sh)
            band_of = torch.tensor([1] * 3 + [2] * 5 + [3] * 7, device=frozen.xyz.device)
            mask = (band_of[:frozen.f_rest.shape[1]] <= deg).to(torch.float32)[None, :, None]
            frozen = frozen.replace(f_rest=frozen.f_rest * mask)
            cam = Camera.from_colmap(scan["qvec"][idx], scan["tvec"][idx], fov, fov, size, size,
                                     device=frozen.xyz.device)
            proj = project_gaussians(frozen, cam, sh_degree=frozen.sh_degree)
            bounds.add(bin_splats(proj, size, size), size, size, 1)
    return bounds
