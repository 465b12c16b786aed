"""Training in the port against the JAX package, on the CPU.

Inputs are made with numpy from a seed; params cross from the reference's
``init_train_state`` through ``interop.params_from_numpy``; the reference
runs its own ``jax.jit``/``jax.grad`` on the CPU.  Tolerances:
- the data pipeline: bit-equal batches;
- ``adamw_update`` given the reference's grads: rtol 1e-6;
- one train step (reduced gemma3-1b, deepseek-coder-33b,
  recurrentgemma-2b, falcon-mamba-7b; float32 compute): the loss within
  rtol 1e-5, each grad within rtol 1e-4 / atol 1e-6, the new params
  within rtol 1e-5 / atol 1e-7 where |grad| > 1e-5 and within 2 lr
  elsewhere (Adam's first step moves a param by about lr * sign(g), so a
  near-zero grad may take either sign);
- grad accumulation, the three remat policies, B6's gradient, the
  emulator-backend step and the plan cache under in-place updates, each
  with its tolerance stated.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.base import ParallelConfig as RefPcfg  # noqa: E402
from repro.configs.base import TrainConfig as RefTcfg  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A  # noqa: E402
from repro.core.analog import AnalogExecutor as RefExecutor  # noqa: E402
from repro.data import SyntheticLMData as RefData  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import use_dense_hook as ref_hook  # noqa: E402
from repro.models.ssm import chunked_recurrence as ref_recurrence  # noqa: E402
from repro.optim.adamw import adamw_update as ref_adamw  # noqa: E402
from repro.optim.adamw import lr_schedule as ref_lr  # noqa: E402
from repro.runtime import steps as RS  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import AnalogConfig, ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A  # noqa: E402
from repro_torch.core.analog import AnalogExecutor  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.interop import emulator_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels.linear_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.linear_scan.linear_scan import (fold_h0,  # noqa: E402
                                                         linear_scan_plain)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import tree_items, use_dense_hook  # noqa: E402
from repro_torch.optim import adamw_update, init_opt_state, lr_schedule  # noqa: E402
from repro_torch.runtime import steps as S  # noqa: E402
from torch_parity import ref_emulator_params, to_np, tree_np  # noqa: E402

SEQ, BATCH, LR = 32, 4, 1e-3
REF_PCFG = RefPcfg(compute_dtype="float32", attn_block_kv=16, xent_chunk=16,
                   scan_chunk=8)
PCFG = ParallelConfig(compute_dtype="float32", attn_block_kv=16, xent_chunk=16)
REF_TCFG = RefTcfg(lr=LR, warmup_steps=2)
TCFG = TrainConfig(lr=LR, warmup_steps=2)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small ops: beside the suite's other worker processes, more
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_batch(batch):
    return {"tokens": torch.from_numpy(batch["tokens"]).long(),
            "targets": torch.from_numpy(batch["targets"]).long(),
            "mask": torch.from_numpy(batch["mask"])}


def _port_state(ref_params):
    params = params_from_numpy(tree_np(ref_params), device="cpu")
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _flat(tree):
    return {k: to_np(v) for k, v in tree_items(tree)}


def _ref_step_and_grads(rcfg, rpcfg, rtcfg, rstate, batch):
    """The reference's jitted train step and its grads on one batch."""
    step = RS.make_train_step(rcfg, rpcfg, rtcfg)

    def both(state, b):
        def loss(p):
            return RM.lm_loss(p, b, cfg=rcfg, pcfg=rpcfg,
                              compute_dtype=jnp.float32, z_coef=rtcfg.z_loss)
        (_, _), g = jax.value_and_grad(loss, has_aux=True)(state["params"])
        return step(state, b), g

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (new_state, metrics), grads = jax.jit(both)(rstate, jb)
    return new_state, metrics, grads


def _assert_grads(got, want):
    w = _flat(want)
    for k, g in _flat(got).items():
        np.testing.assert_allclose(g, w[k], rtol=1e-4, atol=1e-6, err_msg=k)


def _assert_new_params(got, want, grads, lr):
    w, gs = _flat(want), _flat(grads)
    for k, p in _flat(got).items():
        big = np.abs(gs[k]) > 1e-5
        np.testing.assert_allclose(p[big], w[k][big], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        assert np.all(np.abs(p[~big] - w[k][~big]) <= 2 * lr), k


# --------------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,seed,step", [
    ("gemma3-1b", 0, 0), ("gemma3-1b", 3, 17), ("falcon-mamba-7b", 5, 2),
    ("gemma3-1b", 1, 4)])
def test_data_batches_bit_equal(arch, seed, step):
    rcfg = ref_reduced(ref_get_config(arch))
    tcfg = reduced(get_config(arch))
    if (seed, step) == (1, 4):    # the vision and encoder extras too
        rcfg = dataclasses.replace(rcfg, frontend="vision", encoder_layers=2)
        tcfg = dataclasses.replace(tcfg, frontend="vision", encoder_layers=2)
    want = RefData(rcfg, 16, 4, seed=seed).batch(step)
    got = SyntheticLMData(tcfg, 16, 4, seed=seed).batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_data_is_pure_function_of_step():
    cfg = reduced(get_config("gemma3-1b"))
    d1, d2 = SyntheticLMData(cfg, 16, 4, seed=3), SyntheticLMData(cfg, 16, 4,
                                                                  seed=3)
    b1 = d1.batch(17)
    for k, v in d2.batch(17).items():
        np.testing.assert_array_equal(v, b1[k])
    assert not np.array_equal(d1.batch(18)["tokens"], b1["tokens"])


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("step,gscale", [(0, 0.01), (7, 0.01), (3, 5.0)])
def test_adamw_update_matches_reference(step, gscale):
    """Matrices (decayed), vectors (not) and a stacked leaf; moments from
    earlier steps; a clip that binds at gscale 5.  rtol 1e-6."""
    rng = np.random.default_rng(step)
    shapes = {"w": (6, 5), "b": (5,), "stack": {"k": (2, 4, 3)}}

    def draw(scale, fn=lambda x: x):
        def one(node):
            if isinstance(node, dict):
                return {k: one(v) for k, v in node.items()}
            return fn(scale * rng.standard_normal(node)).astype(np.float32)
        return one(shapes)

    params, grads = draw(0.5), draw(gscale)
    # the moments of earlier steps (zeros at step 0)
    m = draw(0.01 if step else 0.0)
    v = draw(1e-4 if step else 0.0, np.abs)
    tc = RefTcfg(lr=2e-3, warmup_steps=5, total_steps=40)
    rp, ro, rmet = ref_adamw(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v)},
        jnp.asarray(step, jnp.int32), tc)
    t = lambda tree: params_from_numpy(tree, device="cpu")  # noqa: E731
    pp, po, pmet = adamw_update(t(params), t(grads), {"m": t(m), "v": t(v)},
                                torch.tensor(step, dtype=torch.int32),
                                TrainConfig(lr=2e-3, warmup_steps=5,
                                            total_steps=40))
    for got, want in ((pp, rp), (po, ro)):
        w = _flat(tree_np(want))
        for k, x in _flat(got).items():
            np.testing.assert_allclose(x, w[k], rtol=1e-6, atol=0, err_msg=k)
    for k in ("gnorm", "lr"):
        np.testing.assert_allclose(float(pmet[k]), float(rmet[k]), rtol=1e-6)


def test_lr_schedule_matches_reference():
    tc = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    for s in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(float(lr_schedule(s, TrainConfig(**tc))),
                                   float(ref_lr(jnp.asarray(s), RefTcfg(**tc))),
                                   rtol=1e-6, err_msg=str(s))


# --------------------------------------------------------------------------- #
# The train step, four families
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-coder-33b",
                                  "recurrentgemma-2b", "falcon-mamba-7b"])
def test_train_step_matches_reference(arch):
    rcfg = ref_reduced(ref_get_config(arch))
    tcfg = reduced(get_config(arch))
    rstate = RS.init_train_state(jax.random.PRNGKey(0), rcfg)
    batch = RefData(rcfg, SEQ, BATCH).batch(0)
    new_r, rmet, rgrads = _ref_step_and_grads(rcfg, REF_PCFG, REF_TCFG,
                                              rstate, batch)
    state = _port_state(rstate["params"])
    tb = _port_batch(batch)
    loss, parts, grads = S.make_grad_fn(tcfg, PCFG, TCFG)(state["params"], tb)
    _assert_grads(grads, rgrads)
    state, met = S.make_train_step(tcfg, PCFG, TCFG)(state, tb)
    for k in ("loss", "xent", "aux", "gnorm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(rmet[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(loss) == float(met["loss"])
    assert int(state["step"]) == int(new_r["step"]) == 1
    _assert_new_params(state["params"], new_r["params"], rgrads, LR)


def test_grad_accum_matches_reference_and_its_definition():
    """grad_accum=2 against the reference's (loss rtol 1e-5, new params as
    in the train-step test); against the port's grad_accum=1 its grads
    are the mean of the two microbatches' own grads (each the gradient
    of its own masked mean; rtol 1e-5 / atol 1e-7), and, where both
    microbatches carry the same mask count, the full batch's grads
    (rtol 1e-4 / atol 1e-6)."""
    arch = "deepseek-coder-33b"
    rcfg = ref_reduced(ref_get_config(arch))
    tcfg = reduced(get_config(arch))
    rstate = RS.init_train_state(jax.random.PRNGKey(0), rcfg)
    batch = RefData(rcfg, SEQ, BATCH).batch(1)
    rp2 = dataclasses.replace(REF_PCFG, grad_accum=2)
    p2 = dataclasses.replace(PCFG, grad_accum=2)
    new_r, rmet, _ = _ref_step_and_grads(rcfg, rp2, REF_TCFG, rstate, batch)
    state = _port_state(rstate["params"])
    tb = _port_batch(batch)
    _, _, g2 = S.make_grad_fn(tcfg, p2, TCFG)(state["params"], tb)
    g1 = S.make_grad_fn(tcfg, PCFG, TCFG)
    halves = [g1(state["params"], {k: v[i * 2:(i + 1) * 2]
                                   for k, v in tb.items()})[2]
              for i in range(2)]
    want = {k: (a + b) / 2 for (k, a), (_, b) in
            zip(tree_items(halves[0]), tree_items(halves[1]))}
    for k, g in tree_items(g2):
        np.testing.assert_allclose(to_np(g), to_np(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    state, met = S.make_train_step(tcfg, p2, TCFG)(state, tb)
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                               rtol=1e-5)
    _assert_new_params(state["params"], new_r["params"], g2, LR)
    # equal mask counts: the mean of the halves' means is the batch's mean
    even = dict(tb, mask=torch.ones_like(tb["mask"]))
    _, _, ga = S.make_grad_fn(tcfg, p2, TCFG)(_port_state(rstate["params"])
                                              ["params"], even)
    _, _, gb = g1(_port_state(rstate["params"])["params"], even)
    fb = dict(tree_items(gb))
    for k, g in tree_items(ga):
        np.testing.assert_allclose(to_np(g), to_np(fb[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------- #
# Remat
# --------------------------------------------------------------------------- #
def _emulator_executor(seed=3):
    return AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                       layers=("mlp",)), geom=CASE_A,
                          emulator_params=emulator_params_from_numpy(
                              ref_emulator_params(REF_A, 0, seed),
                              device="cpu"))


@pytest.mark.parametrize("arch,layers,analog", [
    ("gemma3-1b", 6, False), ("recurrentgemma-2b", 3, False),
    ("gemma3-1b", 6, True)])
def test_remat_policies_give_the_same_grads(arch, layers, analog,
                                            monkeypatch):
    """One stacked period (every layer under the policy): "full" and
    "dots" against "none", bit for bit (a recompute repeats the same
    operations in the same order).  The analog case runs each policy on
    a fresh executor, whose first pass builds the emulator's collapsed
    weights that its recompute finds cached; the build is made to run a
    product too (as a remap's scoring does), which "dots" must not count
    among the products it keeps."""
    from repro_torch.core import analog as analog_mod
    real = analog_mod.conv4xbar.blocklast_weights

    def with_a_product(*args, **kw):
        torch.mm(torch.ones(2, 3), torch.ones(3, 2))
        return real(*args, **kw)

    monkeypatch.setattr(analog_mod.conv4xbar, "blocklast_weights",
                        with_a_product)
    cfg = reduced(get_config(arch), layers=layers)
    assert cfg.num_periods == 1 and not cfg.tail_kinds
    params = S.init_model_params(0, cfg, "cpu")
    tb = _port_batch(SyntheticLMData(cfg, 8, 2).batch(0))
    out = {}
    for remat in ("none", "full", "dots"):
        pcfg = dataclasses.replace(PCFG, remat=remat)
        ctx = (use_dense_hook(_emulator_executor().hook) if analog
               else use_dense_hook(None))
        with ctx:
            out[remat] = S.make_grad_fn(cfg, pcfg, TCFG)(params, tb)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        want = dict(tree_items(out["none"][2]))
        for k, g in tree_items(out[remat][2]):
            assert torch.equal(g, want[k]), (remat, k)


def test_remat_dots_with_a_hook_over_two_stacked_periods():
    """Two stacked periods under "dots" with an analog hook: the hook
    keeps one cache entry a tag, which the second period's weights
    replace, so the first period's recompute must rebuild it before the
    checkpointed region (its one-token run), or selective checkpointing
    meets ops its forward did not run.  The grads equal "none"'s bit for
    bit."""
    cfg = reduced(get_config("deepseek-coder-33b"), layers=2)
    assert cfg.num_periods == 2
    params = S.init_model_params(0, cfg, "cpu")
    tb = _port_batch(SyntheticLMData(cfg, 8, 2).batch(0))
    out = {}
    for remat in ("none", "dots"):
        pcfg = dataclasses.replace(PCFG, remat=remat)
        with use_dense_hook(_emulator_executor().hook):
            out[remat] = S.make_grad_fn(cfg, pcfg, TCFG)(params, tb)
    assert torch.equal(out["dots"][0], out["none"][0])
    want = dict(tree_items(out["none"][2]))
    for k, g in tree_items(out["dots"][2]):
        assert torch.equal(g, want[k]), k


def test_remat_recompute_keeps_the_dense_hook_on_autograd_thread():
    """A CUDA backward runs on the autograd engine's own thread, where the
    caller's thread-local dense hook is not installed; the recompute must
    still route each site through the first pass's hook.  Here the
    backward runs on another thread: the grads equal those of a backward
    on the caller's thread bit for bit, and the hook saw every MLP site
    twice (the first pass and the recompute)."""
    import threading
    cfg = reduced(get_config("gemma3-1b"), layers=6)
    params = S.init_model_params(0, cfg, "cpu")
    tb = _port_batch(SyntheticLMData(cfg, 8, 2).batch(0))
    calls = []

    def hook(x, w, tag):
        if not tag.startswith("mlp"):
            return None
        calls.append(tag)
        return 2.0 * torch.matmul(x, w.to(x.dtype))

    def grads(on_thread):
        leaves = [p.detach().requires_grad_() for _, p in tree_items(params)]
        with use_dense_hook(hook):
            loss, _ = TM.lm_loss(S._unflatten(params, leaves), tb, cfg=cfg,
                                 pcfg=PCFG, compute_dtype=torch.float32)
        out = []
        if on_thread:
            t = threading.Thread(target=lambda: out.append(
                torch.autograd.grad(loss, leaves)))
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
        else:
            out.append(torch.autograd.grad(loss, leaves))
        return out[0]

    same = grads(False)
    n_first = len(calls)
    other = grads(True)
    assert n_first == 2 * 18 and len(calls) == 2 * n_first
    for a, b in zip(same, other):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# B6's gradient
# --------------------------------------------------------------------------- #
def _scan_inputs(B, S_, D, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.99, (B, S_, D)).astype(np.float32)
    b = (0.3 * rng.standard_normal((B, S_, D))).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    wh = rng.standard_normal((B, S_, D)).astype(np.float32)
    wl = rng.standard_normal((B, D)).astype(np.float32)
    return a, b, h0, wh, wl


def _loop_scan(a, b, h0):
    b0 = None if h0 is None else fold_h0(a, b, h0)
    h = linear_scan_plain(a, b, b0)
    return h, h[:, -1]


@pytest.mark.parametrize("S_,with_h0", [(1, True), (16, False), (64, True)])
def test_linear_scan_grad_matches_autograd_of_the_loop(S_, with_h0):
    """``ops.linear_scan``'s backward (its formula on the plain version)
    against torch's autograd through the plain loop itself; a loss on h
    and on h_last.  rtol 1e-5 / atol 1e-6."""
    a, b, h0, wh, wl = (torch.from_numpy(x) for x in _scan_inputs(2, S_, 8, S_))
    grads = []
    for fn in (scan_ops.linear_scan, _loop_scan):
        xs = [t.clone().requires_grad_() for t in (a, b, h0)]
        h, last = fn(xs[0], xs[1], xs[2] if with_h0 else None)
        ((h * wh).sum() + (last * wl).sum()).backward()
        grads.append([x.grad for x in (xs if with_h0 else xs[:2])])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_linear_scan_grad_matches_jax_grad_of_reference_recurrence():
    """Against ``jax.grad`` of the reference's ``chunked_recurrence``
    (chunks of 16 over S = 64, h0 given; trailing lanes (4, 3) flattened
    by the port as ``models.ssm`` does).  rtol 1e-4 / atol 1e-5 (the
    reference scans associatively)."""
    from repro_torch.models.ssm import chunked_recurrence
    rng = np.random.default_rng(7)
    shape = (2, 64, 4, 3)
    a = rng.uniform(0.5, 0.99, shape).astype(np.float32)
    b = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    h0 = rng.standard_normal((2, 4, 3)).astype(np.float32)
    wh = rng.standard_normal(shape).astype(np.float32)
    wl = rng.standard_normal((2, 4, 3)).astype(np.float32)

    def rloss(a, b, h0):
        h, last = ref_recurrence(a, b, h0, 16)
        return (h * wh).sum() + (last * wl).sum()

    want = jax.grad(rloss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                for x in (a, b, h0)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (a, b, h0)]
    h, last = chunked_recurrence(*xs)
    ((h * torch.from_numpy(wh)).sum()
     + (last * torch.from_numpy(wl)).sum()).backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_linear_scan_backward_is_one_reverse_scan():
    """The backward launches the scan once, on ``reverse_inputs`` -- the
    recorded call equals the plain version on those inputs bit for bit,
    and its flipped result is db."""
    a, b, _, wh, _ = (torch.from_numpy(x) for x in _scan_inputs(2, 24, 8, 3))
    calls = []
    real = scan_ops._scan

    def recording(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    scan_ops._scan = recording
    try:
        xs = [t.clone().requires_grad_() for t in (a, b)]
        h, _ = scan_ops.linear_scan(*xs)
        (h * wh).sum().backward()
    finally:
        scan_ops._scan = real
    assert len(calls) == 2
    (ar, gr, b0), g = calls[1]
    ea, eg = scan_ops.reverse_inputs(a, wh)
    assert b0 is None and torch.equal(ar, ea) and torch.equal(gr, eg)
    assert torch.equal(g, linear_scan_plain(ea, eg))
    assert torch.equal(xs[1].grad, g.flip(1))


# --------------------------------------------------------------------------- #
# The emulator backend and the plan cache
# --------------------------------------------------------------------------- #
def test_emulator_backend_step_matches_reference():
    """The reference's ``tests/test_system.py`` setup (reduced gemma3-1b,
    2 layers, MLPs on the emulator, batch 2 x 16, warmup 1) in float32
    compute, on the same emulator params (npz layout): loss rtol 1e-5,
    grads rtol 1e-4 / atol 1e-6, new params as in the train-step test."""
    arch = "gemma3-1b"
    rcfg = ref_reduced(ref_get_config(arch), layers=2)
    tcfg = reduced(get_config(arch), layers=2)
    npp = ref_emulator_params(REF_A, 0, seed=3)
    rex = RefExecutor(acfg=RefAnalogConfig(enabled=True, backend="emulator",
                                           layers=("mlp",)),
                      geom=REF_A, emulator_params={k: jnp.asarray(v)
                                                   for k, v in npp.items()},
                      use_pallas=False)
    rp = RefPcfg(compute_dtype="float32", attn_block_kv=16, xent_chunk=16,
                 scan_chunk=8)
    tp = ParallelConfig(compute_dtype="float32", attn_block_kv=16,
                        xent_chunk=16)
    rt, tt = RefTcfg(warmup_steps=1), TrainConfig(warmup_steps=1)
    rstate = RS.init_train_state(jax.random.PRNGKey(1), rcfg)
    batch = RefData(rcfg, 16, 2).batch(0)
    with ref_hook(rex.hook):
        new_r, rmet, rgrads = _ref_step_and_grads(rcfg, rp, rt, rstate, batch)
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                     layers=("mlp",)), geom=CASE_A,
                        emulator_params=emulator_params_from_numpy(npp, "cpu"))
    state = _port_state(rstate["params"])
    tb = _port_batch(batch)
    with use_dense_hook(ex.hook):
        _, _, grads = S.make_grad_fn(tcfg, tp, tt)(state["params"], tb)
        state, met = S.make_train_step(tcfg, tp, tt)(state, tb)
    assert sum(ex.calls.values()) == 2 * 6          # 3 MLP sites a layer
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                               rtol=1e-5)
    _assert_grads(grads, rgrads)
    _assert_new_params(state["params"], new_r["params"], rgrads, tt.lr)


def test_plan_cache_misses_after_an_in_place_update():
    """A weight updated in place is a new weight to the plan cache: the
    next matmul rebuilds its plan and equals a fresh executor's bit for
    bit; untouched, the plan is kept."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 70)).astype(np.float32))
    w = torch.from_numpy(0.1 * rng.standard_normal((70, 8)).astype(np.float32))
    ex = _emulator_executor()
    ex.matmul(x, w, "t")
    ex.matmul(x, w, "t")
    assert ex.builds["plan"]["t"] == 1
    with torch.no_grad():
        w.mul_(-0.5)
    y = ex.matmul(x, w, "t")
    assert ex.builds["plan"]["t"] == 2
    assert torch.equal(y, _emulator_executor().matmul(x, w, "t"))


def test_train_steps_serve_each_step_its_own_plan():
    """Two float32 steps on one executor, one layer (each MLP tag one
    weight, so the plan cache can hit): each step builds its 3 plans anew
    from the weights the previous step updated in place (fp32 compute
    hands the executor the master tensor itself), and its loss equals a
    fresh executor's on those weights bit for bit."""
    cfg = reduced(get_config("gemma3-1b"), layers=1)
    ex = _emulator_executor()
    state = {"params": S.init_model_params(0, cfg, "cpu")}
    state.update(opt=init_opt_state(state["params"]),
                 step=torch.zeros((), dtype=torch.int32))
    data = SyntheticLMData(cfg, 16, 2)
    step = S.make_train_step(cfg, PCFG, TCFG)
    grad = S.make_grad_fn(cfg, PCFG, TCFG)
    builds = []
    for t in range(2):
        tb = _port_batch(data.batch(t))
        with use_dense_hook(_emulator_executor().hook):
            fresh = grad(state["params"], tb)[0]
        with use_dense_hook(ex.hook):
            state, met = step(state, tb)
        assert torch.equal(met["loss"], fresh), t
        builds.append(sum(ex.builds["plan"].values()))
    assert builds == [3, 6]
