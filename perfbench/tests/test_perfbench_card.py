"""The control on the card: at each cell's own size, the reference in
TF32 in the program's place fails the cell's limits while the program
passes them. Marked ``cuda``; skips without a card.

Run on the card: ``python -m pytest perfbench/tests -q -m cuda``.
"""

from __future__ import annotations

import importlib
import time

import pytest

from perfbench import core
from perfbench.run import make_job
from tinybench import CELLS, SEED


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_refused(card, name):
    import torch

    cell = core.Cell(core.load_spec(), name)
    kind = importlib.import_module(f"perfbench.kinds.{cell.traffic['kind']}")
    torch.manual_seed(SEED)
    r = kind.control_readings(make_job(cell, SEED, 3.0, False, card, time.time()))
    assert core.judge(r["program"], cell.limits)[0], r
    assert not core.judge(r["control"], cell.limits)[0], r
