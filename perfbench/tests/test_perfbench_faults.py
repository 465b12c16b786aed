"""A run with the timed path broken underneath comes out not correct,
and a sound one correct, on the CPU at a tiny size: the harness's look
for a card is skipped, the rest of a run is driven as it is on the chip
(``cell.run_once``), with each cell's own limits."""
import pytest
import torch

from perfbench import cell as C, faults


def _small(name):
    """The cell at the port's tiny config, with a short mix: a few
    requests and ticks, so that a run takes seconds on the CPU."""
    cell = C.load_cell(name)
    tr = dict(cell.traffic, engine=dict(cell.traffic["engine"], max_slots=2),
              prompt={"dist": "uniform", "min": 6, "max": 10},
              output={"dist": "uniform", "min": 3, "max": 4})
    if tr["kind"] == "open":
        tr["rate_per_s"] = 8.0
    else:
        tr["clients"] = 2
    cell.traffic = tr
    cell.limits = dict(cell.limits, prefills=2, ticks=2, site_rows=2)
    return cell


SECONDS = 0.6


def _run(cell, fault=None, seed=2**31 + 5):
    undo = []

    def underneath(prog):
        if fault is not None:
            undo.append(faults.FAULTS[fault](prog))

    try:
        out, _ = C.run_once(cell, seed, SECONDS, False, torch.device("cpu"),
                            reduced=True, underneath=underneath)
    finally:
        for u in undo:
            u()
    return out


CASES = [("phi35moe.chat", None, True, None),
         ("phi35moe.chat", "token", False, "gap"),
         ("phi35moe.chat", "state", False, "kv_err"),
         ("cmdrplus.batch", None, True, None),
         ("cmdrplus.batch", "token", False, "gap"),
         ("cmdrplus.batch", "state", False, "kv_err"),
         ("cmdrplus.batch", "act", False, "act_err")]


@pytest.mark.parametrize("name,fault,correct,caught", CASES,
                         ids=[f"{n}-{f or 'sound'}" for n, f, _, _ in CASES])
def test_a_broken_step_is_not_correct(name, fault, correct, caught):
    torch.manual_seed(0)
    out = _run(_small(name), fault)
    assert out["correct"] is correct, out["checks"]
    assert list(out)[-1] == "checks"
    if caught:
        c = out["checks"][caught]
        assert c["value"] > c["limit"], out["checks"]
    else:
        assert out["attempted"] > 0 and out["metrics"]["setup_s"]["value"] > 0
