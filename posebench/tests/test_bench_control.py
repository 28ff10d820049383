"""Each cell's control comes out not correct against the cell's
committed limits: the reference in the program's place, in the nearest
precision below the configuration's (`posebench/control.py`).  The
served control (float8 products) runs here at tiny widths; the training
control is TF32, which only the card has, so it runs on the card at the
cell's own size."""

import pytest
import torch

from posebench import control, harness
from posebench.tests.tiny_cells import serve_b64


def failing(cell, numbers):
    return [c.name for c in harness.checks_of(numbers, cell.limits)
            if not c.ok]


def test_served_control_fails_and_program_passes_at_tiny_widths():
    cell = serve_b64(batch=4)
    out = control.serve_readings(cell, 5, torch.device("cpu"))
    assert failing(cell, out["program"]) == []
    assert "heads_ratio" in failing(cell, out["control"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["serve_b64_offline", "train_fused_b32"])
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("the TF32 and full-size controls need the card")
    cell = harness.find_cell(name)
    read = (control.serve_readings if name.startswith("serve")
            else control.train_readings)
    out = read(cell, 7, harness.card())
    assert failing(cell, out["control"])
    if "half_batch" in out:
        assert failing(cell, out["half_batch"])
