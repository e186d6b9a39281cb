"""On the card, at a size a test run holds: each cell's program reads
correct, and its control (the plain reference in the program's place,
computing in TF32) reads incorrect.  ``python -m pytest portbench/tests
-m gpu`` on a machine with a card."""

import pytest
import torch

from portbench.harness import execute
from portbench.tests.conftest import TINY, tiny_run

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("control,correct", [(None, True),
                                             ("reference-tf32", False)])
def test_control_fails_where_the_program_holds(cuda, cell, control,
                                               correct):
    out = execute(tiny_run(cell, seconds=2.0, device=cuda,
                           control=control))
    assert out["correct"] is correct, out["checks"]
