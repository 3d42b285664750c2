"""The control (the plain reference in bfloat16, in the program's place)
comes out not correct, and so does a run whose timed path carries any of
the faults the cell can have."""

from __future__ import annotations

import pytest
import torch

import readings
from reference.compare import WINDOW_NUMBERS


@pytest.mark.parametrize("name", ["gen.static", "train.asset512"])
def test_control_is_not_correct(name, tiny_cell, cache, tmp_path):
    cell = tiny_cell(name)
    numbers = readings.control_numbers(cell, 2**31 + 5, torch.device("cpu"), tmp_path, cache=cache)
    limits = cell.config["limits"]
    # training's control of the window's step needs the program's state: test_window_control
    assert set(numbers) == set(limits) - (set(WINDOW_NUMBERS) if name == "train.asset512" else set())
    failed = [n for n in numbers if not numbers[n] <= limits[n]]
    assert failed, numbers


def test_window_control(tiny_cell, cache, tmp_path):
    """The control of training's window step, from the program's state
    before it, reads every window number; the program's own numbers pass."""
    from harness.core import entry_runner

    cell = tiny_cell("train.asset512")
    numbers, control = readings.program_numbers(entry_runner(cell.config), cell, 2**31 + 11,
                                                torch.device("cpu"), tmp_path, control=True,
                                                cache=cache)
    assert set(control) == set(WINDOW_NUMBERS)
    assert all(numbers[n] <= cell.config["limits"][n] for n in numbers), numbers


FAULTS = [("gen.static", "frozen_drop"), ("gen.static", "half_chunk"), ("gen.static", "altered_tile"),
          ("train.asset512", "state_unchanged"), ("train.asset512", "half_batch"),
          ("train.asset512", "altered_tile"), ("train.asset512", "densify_skipped"),
          ("train.asset512", "prune_skipped")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_run_with_a_fault_is_not_correct(name, fault, tiny_cell, execute):
    cell = tiny_cell(name)
    with readings.fault(fault):
        run, *_ = execute(cell)
    assert not all(c.ok for c in run.checks), [(c.name, c.value) for c in run.checks]
    assert run.failed == 1


def test_faults_are_lifted_after_the_run(tiny_cell, execute):
    cell = tiny_cell("train.asset512")
    with readings.fault("half_batch"):
        pass
    run, *_ = execute(cell)
    assert all(c.ok for c in run.checks)
