"""The plain reference of training steps, from the same scan.

The frozen trainer builds its own first cloud from the scan's seed points
(k-nearest-neighbour scales), renders with the plain compositor and its
plain backward, takes the loss and steps Adam.  It follows the cameras the
benchmark picked for the program's first steps, by the same seeded rule.
For a step deep in the window it starts from the program's state on the
step before (``reference_window``): it takes that one step and its
densify/prune and opacity reset as the schedule has them.
"""

from __future__ import annotations

import torch

from reference.frozen.training.trainer import GROUPS


def reference_steps(scan: dict, train: dict, picks, device) -> dict:
    """Per step the loss; the first step's raw gradient per group; each
    group's change after ``len(picks)`` steps."""
    from reference.frozen.camera import Camera
    from reference.frozen.training.trainer import GSTrainer, TrainConfig, init_from_points

    size = int(scan["views"].shape[1])
    config = TrainConfig(**train)
    trainer = GSTrainer(config, width=size, height=size, device=device)
    cloud0 = init_from_points(scan["points"], scan["point_colors"], config, device=device)
    state = trainer.init_state(cloud0, spatial_lr_scale=scan["extent"])
    fov = float(scan["fov"])
    start = {g: getattr(state.cloud, g).clone() for g in GROUPS}
    losses, first_grad = [], None
    for idx in picks:
        cam = Camera.from_colmap(scan["qvec"][idx], scan["tvec"][idx], fov, fov, size, size,
                                 device=device)
        gt = torch.tensor(scan["images"][idx], device=device)
        loss, _, grads, offset_grad = trainer._loss_and_grads(state, cam, gt)
        g2d, denom = trainer._densify_stats(offset_grad)
        state = trainer._apply_grads(state, grads, g2d, denom)
        losses.append(float(loss))
        if first_grad is None:
            first_grad = {g: v.clone() for g, v in grads.items()}
    change = {g: getattr(state.cloud, g) - start[g] for g in GROUPS}
    return {"losses": losses, "grad": first_grad, "change": change}


def reference_window(scan: dict, train: dict, pre: dict, pick: int, noise, device) -> dict:
    """Step ``pre["step"] + 1`` from the state ``pre`` on view ``pick``,
    then densify/prune with the draws ``noise`` (a pair; None: the step
    does not densify) and the opacity reset where the schedule has one:
    the state after the step and the step's raw gradient per group."""
    from reference.frozen.camera import Camera
    from reference.frozen.gs.cloud import GaussianCloud
    from reference.frozen.training.trainer import GSTrainer, TrainConfig, TrainState

    size = int(scan["views"].shape[1])
    config = TrainConfig(**train)
    trainer = GSTrainer(config, width=size, height=size, device=device)
    state = TrainState(
        cloud=GaussianCloud(**{k: v.clone() for k, v in pre["cloud"].items()}),
        mu=dict(pre["mu"]), nu=dict(pre["nu"]), count=pre["count"],
        xyz_grad_accum=pre["xyz_grad_accum"], denom=pre["denom"], max_radii2d=pre["max_radii2d"],
        step=pre["step"], spatial_lr_scale=pre["spatial_lr_scale"])
    fov = float(scan["fov"])
    cam = Camera.from_colmap(scan["qvec"][pick], scan["tvec"][pick], fov, fov, size, size,
                             device=device)
    gt = torch.tensor(scan["images"][pick], device=device)
    _, _, grads, offset_grad = trainer._loss_and_grads(state, cam, gt)
    g2d, denom = trainer._densify_stats(offset_grad)
    state = trainer._apply_grads(state, grads, g2d, denom)
    if noise is not None:
        state = trainer.densify_with_noise(state, noise[0], noise[1], scan["extent"])
    if state.step % config.opacity_reset_interval == 0 and state.step <= config.densify_until_iter:
        state = trainer.reset_opacity(state)
    return {"state": state, "grad": grads}
