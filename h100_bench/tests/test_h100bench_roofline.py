"""The roofline count against a hand count on two tiles, and the count's
independence of the program's binning."""

from __future__ import annotations

import math

import pytest
import torch

from harness import roofline as R
from reference.frozen.ops.binning import bin_splats
from reference.frozen.ops.projection import ProjectedGaussians

W, H = 32, 16  # two tiles of 16 x 16


def two_tile_splats():
    """Three splats: one inside the left tile, one across both, one in the
    right tile, object ids 0, 1, 2."""
    col = lambda *v: torch.tensor(v, dtype=torch.float32)
    return ProjectedGaussians(
        mean_x=col(6.0, 16.5, 27.0), mean_y=col(8.0, 7.0, 4.0),
        conic_a=col(0.2, 0.05, 0.5), conic_b=col(0.0, 0.01, 0.0), conic_c=col(0.2, 0.05, 0.5),
        color_r=col(1, 0, 0), color_g=col(0, 1, 0), color_b=col(0, 0, 1),
        opacity=col(0.9, 0.5, 0.05), depth=col(1.0, 2.0, 3.0), radius=col(6.0, 9.0, 3.0),
        object_id=torch.tensor([0, 1, 2], dtype=torch.int32), valid=torch.ones(3, dtype=torch.bool))


def hand_count(p):
    """Every (pixel, entry) pair of each tile, with the kernels' keep rule
    written out pixel by pixel."""
    pairs = kept = kept_obj = 0
    tiles = {0: [], 1: []}
    for s in range(3):  # the tiles each splat's 3-sigma box touches
        lo = max(0, math.floor((p.mean_x[s] - p.radius[s]) / 16))
        hi = min(1, math.floor((p.mean_x[s] + p.radius[s]) / 16))
        for t in range(lo, hi + 1):
            tiles[t].append(s)
    for t, splats in tiles.items():
        for y in range(16):
            for x in range(16 * t, 16 * t + 16):
                for s in splats:
                    pairs += 1
                    dx, dy = x - float(p.mean_x[s]), y - float(p.mean_y[s])
                    a, b, c = float(p.conic_a[s]), float(p.conic_b[s]), float(p.conic_c[s])
                    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                    alpha = min(float(p.opacity[s]) * math.exp(min(power, 0.0)), 0.99)
                    r = float(p.radius[s])
                    if power <= 0 and alpha >= 1 / 255 and abs(dx) <= r and abs(dy) <= r:
                        kept += 1
                        kept_obj += int(p.object_id[s] != 0)
    return pairs, kept, kept_obj, sum(len(v) for v in tiles.values())


def test_pair_count_matches_a_hand_count_on_two_tiles():
    p = two_tile_splats()
    bins = bin_splats(p, W, H)
    pairs, kept, kept_obj, m = hand_count(p)
    assert int(bins.tile_count.sum()) == m == 4
    assert R.pair_counts(bins, W, H) == (pairs, kept, kept_obj)
    assert pairs == 256 * 4 and 0 < kept_obj < kept < pairs


def test_bounds_are_the_larger_of_operations_and_bytes():
    p = two_tile_splats()
    bins = bin_splats(p, W, H)
    pairs, kept, kept_obj, m = hand_count(p)
    k = 3
    b = R.compositor_bounds(bins, W, H, k)
    inputs = 4 * (12 * 3 + m + 2 * 2)
    image = 4 * W * H * (5 + 3 * k + 2)
    fwd_ops = R.OPS_ALPHA_TEST * pairs + R.OPS_FWD_KEPT * kept
    want = max(fwd_ops / R.H100_FP32_FLOPS, (inputs + image) / R.H100_BYTES_PER_S) * 1e3
    assert b["fwd"][0] == pytest.approx(want, rel=1e-12)
    assert b["fwd"][1] == "bytes"  # a toy case moves more than it computes
    bwd_ops = (R.OPS_ALPHA_TEST * pairs + R.OPS_BWD_KEPT * kept + R.OPS_BWD_KEPT_OBJ * kept_obj
               + W * H * (2 * (5 + k) + 2 * k + 2))
    want = max(bwd_ops / R.H100_FP32_FLOPS,
               (inputs + 2 * image + 40 * m) / R.H100_BYTES_PER_S) * 1e3
    assert b["bwd"][0] == pytest.approx(want, rel=1e-12)
    total = R.Bounds()
    total.add(bins, W, H, k)
    total.add(bins, W, H, k)
    assert total.ms["fwd"] == pytest.approx(2 * b["fwd"][0]) and total.bound_by("fwd") == "bytes"


def test_count_does_not_read_the_programs_bins(monkeypatch, tiny_cell, execute):
    """With the program's binning and projection broken after the window,
    the counted bounds of both entries are unchanged."""
    import pegasus_tpu_torch.ops.binning as port_binning
    import pegasus_tpu_torch.ops.projection as port_projection

    from harness.core import entry_runner

    for name, fn in (("gen.static", "k1_bounds"), ("train.asset512", "compositor_bounds")):
        cell = tiny_cell(name)
        run, *_ = execute(cell, trace=True)
        runner = entry_runner(cell.config)
        ctx = run.facts["ctx"]
        before = getattr(runner, fn)(run, ctx).ms
        with monkeypatch.context() as m:
            def refuse(*a, **k):
                raise AssertionError("the count read the program's binning")
            m.setattr(port_binning, "bin_splats", refuse)
            m.setattr(port_projection, "project_gaussians", refuse)
            assert getattr(runner, fn)(run, ctx).ms == before
        assert before["fwd"] > 0 and before["bwd"] > 0
