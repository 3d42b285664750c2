"""On the card: each cell at a tiny size through the program's kernels is
correct against the plain reference, and the bfloat16 control is not.
Skips without a card (decided inside each test)."""

from __future__ import annotations

import time

import pytest
import torch

import readings
import run as run_py

pytestmark = pytest.mark.gpu


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["gen.static", "train.asset512"])
def test_tiny_cell_on_the_card(name, tiny_cell, cache, tmp_path):
    device = card()
    cell = tiny_cell(name)
    run, metrics, dev, _ = run_py.execute(cell, 2**31 + 99, 0.5, False, device,
                                          t0=time.perf_counter(), cache=cache)
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert all(c.ok for c in run.checks), [(c.name, c.value, c.limit) for c in run.checks]
    numbers = readings.control_numbers(cell, 2**31 + 99, device, tmp_path, cache=cache)
    assert any(not numbers[n] <= cell.config["limits"][n] for n in numbers), numbers
