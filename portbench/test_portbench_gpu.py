"""The benchmark's tests that need the card (marked ``gpu``; they skip
without one): a cell at its own size through the harness is correct, and
the bfloat16 control fails the same cell's limits.

    python -m pytest portbench/test_portbench_gpu.py -q -m gpu
"""

from __future__ import annotations

import pytest
import torch

from portbench import compare, control, run

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("name", ["garden-exact.overview",
                                  "garden-fast.orbit"])
def test_a_cell_at_its_size_is_correct_and_its_control_is_not(card, name):
    _, config, traffic, limits = run.load_cell(name)
    res = run.run_cell(config, traffic, limits, 2 ** 31 + 5, 3.0, False,
                       log=lambda *a: None)
    assert res["correct"], res["checks"]
    nums = control.control_numbers(config, traffic, 2 ** 31 + 5)
    assert compare.judge(nums, limits)[1] == len(nums)
