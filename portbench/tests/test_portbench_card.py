"""The benchmark on the card: each cell's short run is correct against the
reference at the cell's own size, and the control (the program with
bfloat16 fields) is not.  Marked ``cuda``; each test decides whether a card
is present and skips without one."""

import pytest
import torch

from portbench import harness

pytestmark = pytest.mark.cuda

BENCH = harness.load_benchmark()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_correct_on_the_card(card, cell):
    out = harness.run_cell(cell, 2 ** 32 + 7, 0.5, False, card, bench=BENCH,
                           log=lambda *a: None)
    assert out["line"]["correct"], out["checks"]
    assert out["line"]["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", ["bench128.steps", "bench128.live"])
def test_control_is_not_correct_on_the_card(card, cell):
    out = harness.run_cell(cell, 2 ** 32 + 8, 0.5, False, card, bench=BENCH,
                           program_overrides={"dtype": "bfloat16"}, log=lambda *a: None)
    assert not out["line"]["correct"], out["checks"]
