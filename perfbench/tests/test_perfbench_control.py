"""The control: the reference at the precision below the
configuration's (TF32 operands in the emulator, fp8 in the digital
model), put in the program's place over a window's kept calls, fails a
limit that the program's own run passes; on the CPU at a tiny size."""
import pytest
import torch

from perfbench import cell as C, loadgen
from perfbench.tests.test_perfbench_faults import SECONDS, _small


@pytest.mark.parametrize("name", ["phi35moe.chat", "cmdrplus.batch"])
def test_the_control_fails_a_limit(name):
    cell = _small(name)
    prog = C.Program(cell, 11, torch.device("cpu"), reduced=True)
    prog.warm()
    reqs = loadgen.make_requests(cell.traffic, 11, SECONDS,
                                 prog.ref_cfg["vocab_size"])
    picks, times = C.pick_sample(cell, reqs, 11, SECONDS)
    win = C.Window(prog, reqs, picks, times)
    rec = C.Record(cell=cell.name, cfg=prog.ref_cfg, sites=prog.sites,
                   max_slots=2, setup_s=0.0, start=0.0, end=0.0, requests=[])
    with torch.no_grad():
        win.lead_in(rec, cell.traffic)
        win.run(rec, SECONDS, cell.traffic)
    kw = dict(site_rows=2, seed=11, reference=cell.config["reference"])
    sound = C.check(win.caps, prog.params, prog.eparams, prog.ref_cfg,
                    cell.config["crossbar"], **kw)
    low = C.check(win.caps, prog.params, prog.eparams, prog.ref_cfg,
                  cell.config["crossbar"], control=True, **kw)
    lim = cell.limits["limits"]
    assert C.verdict(sound, lim)[0]
    assert not C.verdict(low, lim)[0]
    assert low["site_err"] > lim["site_err"] > sound["site_err"]
    assert low["logit_err"] > lim["logit_err"] >= sound["logit_err"]
