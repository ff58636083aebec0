"""On the card, at each cell's own size: the control (the configuration's
reference in the precision just below the configuration's, put in the
program's place) fails the cell's check on three seeds, and a short run
of each one-chip cell passes it.

    python3 -m pytest portbench/tests/test_portbench_card.py -q
"""

import time

import pytest

from portbench.core import control, harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
ONE_CHIP = [w["name"] for w in spec.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_fails_the_check(card, cell, seed):
    limits = spec.Cell(cell).limits()
    nums = control.control_numbers(cell, seed, [card])
    assert control.failed(nums, limits), nums


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_short_run_is_correct(card, cell):
    res = harness.run(cell, 2**31 + 104, 2.0, False, devices=[card],
                      t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
