"""The comparison with the plain reference fails on a perturbed frame and
on a perturbed parameter row, with the limits the configurations state."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from harness.core import BENCH
from reference.compare import GEN_NUMBERS, WINDOW_NUMBERS, generation_gaps, training_gaps, window_gaps

GEN_LIMITS = json.loads((BENCH / "configs" / "pegaset_1m.json").read_text())["limits"]
TRAIN_LIMITS = json.loads((BENCH / "configs" / "gs_asset_512.json").read_text())["limits"]


def scene(rng):
    h, w, k = 48, 64, 2
    masks = rng.random((h, w, k)) < 0.2
    img = {"rgb": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
           "depth": rng.integers(0, 3000, (h, w)).astype(np.uint16),
           "mask": masks, "mask_visib": masks & (rng.random((h, w, k)) < 0.8),
           "sem_mask": rng.integers(0, 256, (h, w, 3), dtype=np.uint8)}
    gt = {"0": [{"cam_R_m2c": [1.0, 0, 0, 0, 1, 0, 0, 0, 1], "cam_t_m2c": [10.0, 20.0, 900.0],
                 "obj_id": 3}]}
    return {"scene_camera": {"0": {"cam_K": [600.0, 0, 320, 0, 600, 240, 0, 0, 1], "depth_scale": 1.0}},
            "scene_gt": gt, "gt_info": {"0": [{"px_count_all": 120, "visib_fract": 0.5}]},
            "images": {0: img}}


def limits_fail(gaps, limits):
    return [n for n in gaps if not gaps[n] <= limits[n]]


def test_equal_scenes_pass():
    want = scene(np.random.default_rng(0))
    gaps = generation_gaps(copy.deepcopy(want), want)
    assert gaps == dict.fromkeys(GEN_NUMBERS, 0.0)


@pytest.mark.parametrize("field,expect", [("rgb", "rgb_rmse"), ("depth", "depth_off"),
                                          ("mask", "mask_off"), ("sem_mask", "sem_off")])
def test_perturbed_frame_fails(field, expect):
    want = scene(np.random.default_rng(1))
    got = copy.deepcopy(want)
    tile = got["images"][0][field][16:32, 16:32]
    if tile.dtype == bool:
        tile[...] = ~tile
    else:
        tile[...] = (tile.astype(np.int64) + 40) % (256 if tile.dtype == np.uint8 else 65536)
    assert expect in limits_fail(generation_gaps(got, want), GEN_LIMITS)


def test_perturbed_annotation_and_missing_files_fail():
    want = scene(np.random.default_rng(2))
    got = copy.deepcopy(want)
    got["scene_gt"]["0"][0]["cam_t_m2c"][2] += 1.0  # one millimetre
    assert "annot" in limits_fail(generation_gaps(got, want), GEN_LIMITS)
    got = copy.deepcopy(want)
    got["scene_gt"]["0"][0]["obj_id"] = 4
    assert "annot" in limits_fail(generation_gaps(got, want), GEN_LIMITS)
    got = copy.deepcopy(want)
    got["scene_gt"]["0"].append(got["scene_gt"]["0"][0])  # an object too many
    assert generation_gaps(got, want)["annot"] == float("inf")
    assert all(v == float("inf") for v in generation_gaps(None, want).values())


def steps(seed):
    g = torch.Generator().manual_seed(seed)
    groups = {"xyz": (50, 3), "f_dc": (50, 1, 3), "f_rest": (50, 15, 3), "opacity": (50, 1),
              "scale": (50, 3), "rot": (50, 4)}
    grad = {k: torch.randn(s, generator=g) * 1e-3 for k, s in groups.items()}
    grad["f_rest"].zero_()  # no SH band above 0 trains at first: nought to rounding
    change = {k: torch.sign(v) * 1e-3 for k, v in grad.items()}
    return {"losses": [0.2, 0.19, 0.185], "grad": grad, "change": change}


def test_equal_steps_pass():
    ref = steps(0)
    assert training_gaps(copy.deepcopy(ref), ref) == {"loss": 0.0, "grad": 0.0, "change": 0.0}


@pytest.mark.parametrize("tree,expect", [("change", "change"), ("grad", "grad")])
def test_perturbed_parameter_row_fails(tree, expect):
    ref = steps(3)
    prog = copy.deepcopy(ref)
    prog[tree]["xyz"][7] += 0.05
    assert expect in limits_fail(training_gaps(prog, ref), TRAIN_LIMITS)


def test_perturbed_loss_fails():
    ref = steps(4)
    prog = copy.deepcopy(ref)
    prog["losses"][2] *= 1.01
    assert "loss" in limits_fail(training_gaps(prog, ref), TRAIN_LIMITS)


def test_groups_nought_to_rounding_are_left_out_of_the_change():
    ref = steps(5)
    prog = copy.deepcopy(ref)
    prog["change"]["f_rest"] += 1e-7  # round-off motion of a group the reference does not move
    assert training_gaps(prog, ref)["change"] == 0.0


def window(seed):
    """(pre, post, ref) of a densify step on which the program and the
    reference agree: 40 of 60 slots alive before, 45 after."""
    from types import SimpleNamespace

    g = torch.Generator().manual_seed(seed)
    pre_steps, post_steps = steps(seed), steps(seed + 100)
    alive0 = torch.arange(60) < 40
    alive1 = torch.arange(60) < 45
    pad = lambda t: torch.cat([t, torch.zeros((10,) + t.shape[1:])])
    pre = {"cloud": {k: pad(v) for k, v in pre_steps["change"].items()}}
    pre["cloud"]["alive"] = alive0
    post_cloud = {k: pad(v) + 1e-3 * torch.randn((60,) + v.shape[1:], generator=g)
                  for k, v in post_steps["change"].items()}
    post_cloud["f_rest"] = pre["cloud"]["f_rest"].clone()
    post_cloud["alive"] = alive1
    mu = {k: pad(v) for k, v in post_steps["grad"].items()}
    nu = {k: v * v for k, v in mu.items()}
    post = {"cloud": post_cloud, "mu": mu, "nu": nu}
    ref_state = SimpleNamespace(cloud=SimpleNamespace(**copy.deepcopy(post_cloud)),
                                mu=copy.deepcopy(mu), nu=copy.deepcopy(nu))
    return pre, post, {"state": ref_state, "grad": {k: pad(v) for k, v in pre_steps["grad"].items()}}


def test_equal_window_steps_pass():
    pre, post, ref = window(6)
    assert window_gaps(pre, post, ref) == dict.fromkeys(WINDOW_NUMBERS, 0.0)


@pytest.mark.parametrize("what,expect", [("alive", "densify_alive"), ("row", "densify_change"),
                                         ("moment", "densify_moments")])
def test_perturbed_window_step_fails(what, expect):
    pre, post, ref = window(7)
    if what == "alive":  # a prune left out: one more slot alive in the program
        post["cloud"]["alive"][50] = True
    elif what == "row":  # a placed child with another scale
        post["cloud"]["scale"][42] += 0.5
    else:  # stale moments kept where the reference zeroes them
        post["mu"]["opacity"][45:] = 1e-3
    assert expect in limits_fail(window_gaps(pre, post, ref), TRAIN_LIMITS)
