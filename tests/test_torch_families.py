"""The recurrent families (recurrentgemma-2b's RG-LRU, falcon-mamba-7b's
Mamba-1) and deepseek-coder-33b's untied head, served by the port, against
the JAX package on the CPU.

(a) Model schemas: the full-size key paths and shapes equal the
    reference's.
(b) Model level in float32 (params and compute), reduced configs: prefill
    logits and 3 greedy decode steps against
    ``repro.models.model.prefill/decode_step`` on converted params, tokens
    equal, logits within rtol 1e-4 (atol 1e-4 of the logits' scale).
    Depths with one stacked period, two stacked periods and a tail;
    recurrentgemma also on the emulator backend (its MLPs analog).
(c) ``ServeSession`` end to end in bfloat16 on the reference session's
    params and prompt, digitally at ``BF16_REL``'s bound; on the emulator
    the call sites equal the reference's and the logits stay within a
    stated multiple of the reference's own spread under a one-ulp nudge.
(d) Port only: prefill + decode equals one forward over the whole
    sequence (fails if decode drops the recurrent states of stacked
    periods).
(e) The serve CLI takes the new archs and refuses the two frontend archs
    still unported (ROADMAP A9c).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import is_schema_leaf as ref_is_leaf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import is_schema_leaf  # noqa: E402
from torch_parity import (decode_matches_forward, model_parity_f32,  # noqa: E402
                          nudged_generate, same_config, serve_parity_bf16,
                          serve_sessions_bf16, step_rel)

NEW_ARCHS = ("recurrentgemma-2b", "falcon-mamba-7b", "deepseek-coder-33b")
UNPORTED = ("internvl2-76b", "seamless-m4t-large-v2")


def _shapes(tree, is_leaf, path=()):
    if is_leaf(tree):
        return {path: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_shapes(v, is_leaf, path + (k,)))
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_model_schema_matches_reference(arch):
    rcfg, tcfg = ref_get_config(arch), get_config(arch)
    assert same_config(tcfg, rcfg)
    assert _shapes(TM.model_schema(tcfg), is_schema_leaf) == \
        _shapes(RM.model_schema(rcfg), ref_is_leaf)


# recurrentgemma's pattern is (R, R, L): 3 layers are one stacked period,
# 4 add an R tail, 7 are two periods and a tail; P = 32 is two windows of
# the reduced config (the chunked local-attention path).  falcon-mamba's
# period is one M layer: 2 and 3 layers are that many stacked periods.
# The emulator runs at 4 layers with a short prompt (its plain CPU
# evaluation is the slow part).
@pytest.mark.parametrize("arch,layers,P,backend", [
    ("recurrentgemma-2b", 3, 16, "digital"),
    ("recurrentgemma-2b", 7, 32, "digital"),
    ("recurrentgemma-2b", 4, 8, "emulator"),
    ("falcon-mamba-7b", 2, 16, "digital"),
    ("falcon-mamba-7b", 3, 32, "digital"),
    ("deepseek-coder-33b", 2, 16, "digital"),
])
def test_model_prefill_decode_match_reference_f32(arch, layers, P, backend):
    model_parity_f32(arch, layers, P, backend)


@pytest.mark.parametrize("arch,layers", [("recurrentgemma-2b", 3),
                                         ("falcon-mamba-7b", 2)])
def test_serve_session_end_to_end_bf16(arch, layers):
    serve_parity_bf16(arch, layers, "digital")


# How far the port's bf16 emulator serve may sit from the reference's, as
# a multiple of how far the reference moves from itself when 1% of the
# elements of every parameter move up one bf16 ulp.  Measured at seed 0
# (``tools/bf16_sensitivity.py --leaf ""``): port 0.649 / 1.051 / 1.458
# of the logits' scale over 3 steps, nudged reference 0.472 / 1.060 /
# 1.113, a largest ratio of 1.38.
NUDGE_FACTOR = 2.0


def test_serve_session_emulator_bf16_within_the_paths_own_spread():
    """recurrentgemma on the emulator in bfloat16: the same call sites as
    the reference (3 MLP projections a layer, R and L layers alike; the
    recurrent mixers' einsums are none), finite logits, and at every step
    the port's logits within ``NUDGE_FACTOR`` times the distance by which
    a one-ulp nudge of the params moves the reference from itself.  In
    bfloat16 this path carries a one-ulp difference to O(1) in the
    reference itself (the drive map sends an exact zero to 0 V and any
    nonzero activation to at least v_th), so ``BF16_REL``'s fixed bound
    does not apply; a port fault moves the logits farther than the
    path's own spread.  The same path is held in float32 by
    ``test_model_prefill_decode_match_reference_f32``."""
    ts, rs, tout, rout = serve_sessions_bf16("recurrentgemma-2b", 3, "emulator")
    assert len(ts.sites()) == 3 * 3
    assert sorted(ts.sites()) == sorted(rs.sites())
    assert tout["tokens"].shape == rout["tokens"].shape == (2, 3)
    assert tout["logits"].shape == rout["logits"].shape
    assert np.isfinite(tout["logits"]).all()
    nout = nudged_generate(rs, 0)
    scale = float(np.abs(rout["logits"]).max())
    port = step_rel(tout["logits"], rout["logits"], scale)
    spread = step_rel(nout["logits"], rout["logits"], scale)
    assert min(spread) > 0, spread
    for step, (p, s) in enumerate(zip(port, spread)):
        assert p <= NUDGE_FACTOR * s, (step, port, spread)


@pytest.mark.parametrize("arch,layers", [("falcon-mamba-7b", 4),
                                         ("recurrentgemma-2b", 6)])
def test_decode_matches_the_full_forward(arch, layers):
    """Prefill P tokens, then decode G more (teacher forcing), against one
    forward over all P + G: logits within rtol 1e-4, atol 1e-4 of their
    scale.  Both configs stack at least two periods, whose recurrent
    states decode must carry from step to step."""
    cfg = decode_matches_forward(arch, layers)
    assert cfg.num_periods >= 2


def test_serve_cli_takes_the_new_archs_and_refuses_the_unported():
    from repro_torch.launch import serve
    base = ["--reduced", "--device", "cpu", "--batch", "1",
            "--prompt-len", "4", "--gen", "2"]
    for arch in UNPORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            serve.main(["--arch", arch] + base)
    for arch in NEW_ARCHS:
        sess, out = serve.main(["--arch", arch] + base)
        assert sess.cfg.name == f"{arch}-reduced"
        assert out["tokens"].shape == (1, 2)
        assert np.isfinite(out["logits"]).all()
