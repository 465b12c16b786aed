"""On the chip: each cell as it is committed, run for a short window,
comes out correct with its metrics, on the card's own kernels
(``PYTHONPATH=src python -m pytest perfbench/tests -m card``; skipped
without a card)."""
import pytest
import torch

from perfbench import cell as C


@pytest.mark.card
@pytest.mark.parametrize("name", ["phi35moe.chat", "phi35moe.overload",
                                  "cmdrplus.batch"])
def test_cell_runs_correct_on_the_card(card, name):
    from repro_torch.kernels import _build
    _build.build_all()
    cell = C.load_cell(name)
    out, _ = C.run_once(cell, 2**31 + 123, 8.0, False, card)
    assert out["correct"], out["checks"]
    assert out["device"]["kind"] == torch.cuda.get_device_name(card)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    torch.cuda.empty_cache()
