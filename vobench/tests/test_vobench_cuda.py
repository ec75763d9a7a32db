"""On the card: a short run of each cell through the command's own path
comes out correct, with every end-to-end metric of the cell, on the
card's name, and with the step replayed from its CUDA graph."""

from __future__ import annotations

import pytest
import torch

from vobench import registry, run


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["city640.offline", "city640.batch6"])
def test_a_short_run_is_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = registry.cell(name)
    got = run.run(cell, 3_141_592_653, 12.0, False, "cuda:0", log=lambda s: None)
    assert got["correct"], got["checks"]
    assert got["device"]["kind"] == torch.cuda.get_device_name(0)
    assert {m["name"] for m in cell.end_to_end} == set(got["metrics"])
    assert got["failed"] <= 0.05 * got["attempted"]
