"""The MoE decoder archs phi3.5-moe-42b-a6.6b (layernorm, 16 experts
top-2) and llama4-scout-17b-a16e (16 experts top-1 with a shared expert,
chunked attention), served and trained by the port, against the JAX
package on the CPU.

(a) Schemas: the config copies and the full-size key paths and shapes
    equal the reference's.
(b) ``moe_mixer`` in float32 (rtol 1e-5 / atol 1e-6): y and the aux loss
    in eval and train mode, with and without the shared expert, top-1
    and top-2; a router that sends most tokens to one expert, so that
    many assignments are dropped (a drop that differs from the
    reference's shows as a large error); the capacity rule.
(c) ``chunked_attention`` with S a multiple of the chunk, S not a
    multiple, and the chunk at least S (rtol 1e-5 / atol 1e-6).
(d) Model level in float32, reduced configs: prefill logits and greedy
    decode steps against ``repro.models.model.prefill/decode_step``
    (tokens equal, logits within rtol 1e-4, atol 1e-4 of the scale):
    phi3.5-moe at 2 layers, llama4-scout at 4 (one period) and 6 (one
    period and a tail of 2), a decode across a chunk boundary (window
    16, prompt 12, 8 steps), and phi3.5-moe on the emulator backend with
    its attention projections analog (``AnalogConfig(layers=("attn",))``
    on both sides), whose call sites equal the reference's.
(e) ``ServeSession`` in bfloat16 against the reference session
    (``BF16_REL``'s bound), and, port only, prefill + decode against one
    forward.
(f) Training: ``lm_loss`` (loss, xent, aux) and the grads of the router,
    the experts and attention against ``jax.grad`` of the reference's,
    under remat "none" and "full" (rtol 1e-4 / atol 1e-6); grad
    accumulation carries the aux loss (the mean of the microbatches').
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs.base import ParallelConfig as RefPcfg  # noqa: E402
from repro.data import SyntheticLMData as RefData  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.runtime import steps as S  # noqa: E402
from torch_parity import (decode_matches_forward, model_parity_f32,  # noqa: E402
                          same_config, serve_parity_bf16, site_keys_match,
                          to_np, tree_np)

PHI, LLAMA4 = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
SEQ, BATCH = 16, 4
REF_PCFG = RefPcfg(compute_dtype="float32", attn_block_kv=16, xent_chunk=16,
                   scan_chunk=8)
PCFG = ParallelConfig(compute_dtype="float32", attn_block_kv=16, xent_chunk=16)
TCFG = TrainConfig()


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small ops: beside the suite's other worker processes, more
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(tree, is_leaf, path=()):
    if is_leaf(tree):
        return {path: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_shapes(v, is_leaf, path + (k,)))
    return out


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_model_schema_matches_reference(arch):
    rcfg, tcfg = ref_get_config(arch), get_config(arch)
    assert same_config(tcfg, rcfg)
    assert same_config(reduced(tcfg), ref_reduced(rcfg))
    assert reduced(tcfg).moe.num_experts == 4
    assert _shapes(TM.model_schema(tcfg), TC.is_schema_leaf) == \
        _shapes(RM.model_schema(rcfg), RC.is_schema_leaf)


# --------------------------------------------------------------------------- #
# moe_mixer
# --------------------------------------------------------------------------- #
def test_capacity_matches_reference():
    for arch in (PHI, LLAMA4):
        m = reduced(get_config(arch)).moe
        rm = ref_reduced(ref_get_config(arch)).moe
        for T in (1, 2, 3, 17, 32, 100, 128, 1000):
            for train in (False, True):
                assert TMoE._capacity(T, m, train) == \
                    RMoE._capacity(T, rm, train), (arch, T, train)


def _moe_cfgs(arch, top_k, shared):
    rcfg = ref_reduced(ref_get_config(arch))
    tcfg = reduced(get_config(arch))
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, top_k=top_k, shared_expert=shared))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, top_k=top_k, shared_expert=shared))
    return rcfg, tcfg


def _moe_both(rcfg, tcfg, x, train, edit=None):
    """The reference's and the port's ``moe_mixer`` on the same params
    (``edit`` may change the numpy tree first) and input."""
    rp = tree_np(RC.init_params(jax.random.PRNGKey(2),
                                RMoE.moe_schema(rcfg)))
    if edit is not None:
        rp = edit(rp)
    assert sorted(rp) == sorted(TMoE.moe_schema(tcfg))
    jp = jax.tree.map(jnp.asarray, rp)
    ry, raux = jax.jit(lambda p, v: RMoE.moe_mixer(
        p, v, cfg=rcfg, pcfg=RefPcfg(), train=train))(jp, jnp.asarray(x))
    tp = params_from_numpy(rp, device="cpu")
    ty, taux = TMoE.moe_mixer(tp, torch.from_numpy(x), cfg=tcfg, train=train)
    return (ry, raux), (ty, taux), tp


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("arch,top_k,shared", [
    (PHI, 2, False), (PHI, 2, True), (LLAMA4, 1, True), (LLAMA4, 1, False)])
def test_moe_mixer_matches_reference(arch, top_k, shared, train):
    rcfg, tcfg = _moe_cfgs(arch, top_k, shared)
    x = np.random.default_rng(3).standard_normal((3, 7, rcfg.d_model)) \
        .astype(np.float32)
    (ry, raux), (ty, taux), _ = _moe_both(rcfg, tcfg, x, train)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5, atol=1e-7)
    assert float(taux) > 0


@pytest.mark.parametrize("top_k,train", [(1, False), (2, True)])
def test_moe_mixer_drops_as_the_reference_does(top_k, train):
    """A router column tilted toward expert 0 and inputs with a common
    component send most tokens' first choice there, past its capacity:
    the assignments kept and dropped (by their rank in the (t, k) order)
    decide y, so a drop that differs shows as a large error."""
    rcfg, tcfg = _moe_cfgs(PHI, top_k, False)
    x = (np.random.default_rng(4).standard_normal((2, 16, rcfg.d_model))
         + 1.0).astype(np.float32)

    def tilt(p):
        p = dict(p)
        p["router"] = p["router"].copy()
        p["router"][:, 0] += 0.15
        return p

    (ry, raux), (ty, taux), tp = _moe_both(rcfg, tcfg, x, train, edit=tilt)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5, atol=1e-7)
    T, E = 32, tcfg.moe.num_experts
    _, _, idx = TMoE.route(tp, torch.from_numpy(x).reshape(T, -1), tcfg.moe)
    C = TMoE._capacity(T, tcfg.moe, train)
    _, keep = TMoE.slots(idx, E, C)
    dropped = int((~keep).sum())
    assert dropped >= 8, dropped
    # expert 0 is sent more first choices than it has slots
    assert float(torch.bincount(idx[:, 0], minlength=E)[0]) > C


# --------------------------------------------------------------------------- #
# Chunked attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("S,chunk", [(32, 8), (20, 8), (8, 16)])
def test_chunked_attention_matches_reference(S, chunk):
    """S a multiple of the chunk (the 1-chunk trick), S not a multiple
    (the masked blockwise path) and the chunk at least S (plain causal)."""
    rng = np.random.default_rng(S + chunk)
    q, k, v = (rng.standard_normal((2, S, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = RA.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), chunk)
    got = TA.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    if chunk < S:   # a query sees nothing of an earlier chunk
        cut = torch.from_numpy(k).clone()
        cut[:, :chunk] += 5.0
        moved = TA.chunked_attention(torch.from_numpy(q), cut,
                                     torch.from_numpy(v), chunk)
        assert torch.equal(moved[:, chunk:], got[:, chunk:])


# --------------------------------------------------------------------------- #
# Model level
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,layers,P,G", [
    (PHI, 2, 16, 3), (LLAMA4, 4, 16, 3), (LLAMA4, 6, 32, 3),
    (LLAMA4, 4, 12, 8)])
def test_model_prefill_decode_match_reference_f32(arch, layers, P, G):
    """llama4's reduced chunk is 16: P = 32 takes the 1-chunk prefill, P =
    16 the plain causal one; P = 12 with 8 steps decodes across the
    boundary at position 16 on the 16-slot ring."""
    cfg = reduced(get_config(arch), layers=layers)
    if arch == LLAMA4:
        assert cfg.window == 16
    model_parity_f32(arch, layers, P, "digital", G=G)


def test_model_on_the_emulator_with_analog_attention_matches_reference():
    """phi3.5-moe's analog sites are its attention projections (its
    experts never call ``dense()``)."""
    rex, tex = model_parity_f32(PHI, 2, 8, "emulator",
                                analog_layers=("attn",))
    keys = site_keys_match(PHI, 2, rex, tex)
    assert len(keys) == 2 * 4 and all(":attn." in k for k in keys)
    assert sorted({k.split("#")[0] for k in tex.calls}) == \
        ["attn.k", "attn.o", "attn.q", "attn.v"]


@pytest.mark.parametrize("arch,layers", [(PHI, 2), (LLAMA4, 4)])
def test_serve_session_end_to_end_bf16(arch, layers):
    serve_parity_bf16(arch, layers, "digital")


def _holding_every_assignment(cfg):
    """``cfg`` with an evaluation capacity of every token (factor E / K):
    no assignment is dropped, so a token's output does not depend on how
    many batch-mates a call has."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, eval_capacity_factor=m.num_experts / m.top_k))


@pytest.mark.parametrize("arch,layers", [(PHI, 3), (LLAMA4, 6)])
def test_decode_matches_the_full_forward(arch, layers):
    """The full forward routes B x (P + G) tokens at once, prefill B x P
    and each decode step B: at the configs' own capacity a token can be
    dropped in one and kept in another (its output depends on its
    batch-mates), so the capacity here holds every assignment and the
    comparison holds the caches and the chunked attention alone."""
    cfg = decode_matches_forward(arch, layers,
                                 edit_cfg=_holding_every_assignment)
    assert TMoE._capacity(2 * 19, cfg.moe, train=False) >= 2 * 19


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #
def _data(rcfg):
    b = RefData(rcfg, SEQ, BATCH).batch(0)
    tb = {"tokens": torch.from_numpy(b["tokens"]).long(),
          "targets": torch.from_numpy(b["targets"]).long(),
          "mask": torch.from_numpy(b["mask"])}
    return {k: jnp.asarray(v) for k, v in b.items()}, tb


@pytest.mark.parametrize("arch,layers", [(PHI, 2), (LLAMA4, 4)])
def test_lm_loss_matches_reference(arch, layers):
    rcfg = ref_reduced(ref_get_config(arch), layers=layers)
    tcfg = reduced(get_config(arch), layers=layers)
    rp = RC.init_params(jax.random.PRNGKey(0), RM.model_schema(rcfg))
    jb, tb = _data(rcfg)
    rl, rparts = jax.jit(lambda p, b: RM.lm_loss(
        p, b, cfg=rcfg, pcfg=REF_PCFG, compute_dtype=jnp.float32))(rp, jb)
    with torch.no_grad():
        tl, tparts = TM.lm_loss(params_from_numpy(tree_np(rp), device="cpu"),
                                tb, cfg=tcfg, pcfg=PCFG,
                                compute_dtype=torch.float32)
    assert float(tparts["aux"]) > 0
    for got, want in ((tl, rl), (tparts["xent"], rparts["xent"]),
                      (tparts["aux"], rparts["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch,layers", [(PHI, 2), (LLAMA4, 4)])
def test_grads_match_jax_grad(arch, layers, remat):
    """Every leaf's grad (router, experts, shared expert, attention,
    norms, embedding) within rtol 1e-4 / atol 1e-6 of ``jax.grad`` of the
    reference's ``lm_loss`` under the same remat policy; the loss equal
    within rtol 1e-5."""
    rcfg = ref_reduced(ref_get_config(arch), layers=layers)
    tcfg = reduced(get_config(arch), layers=layers)
    rpc = dataclasses.replace(REF_PCFG, remat=remat)
    tpc = dataclasses.replace(PCFG, remat=remat)
    rp = RC.init_params(jax.random.PRNGKey(0), RM.model_schema(rcfg))
    jb, tb = _data(rcfg)

    def loss(p, b):
        return RM.lm_loss(p, b, cfg=rcfg, pcfg=rpc,
                          compute_dtype=jnp.float32, z_coef=TCFG.z_loss)

    (rl, _), rg = jax.jit(jax.value_and_grad(loss, has_aux=True))(rp, jb)
    tl, tparts, tg = S.make_grad_fn(tcfg, tpc, TCFG)(
        params_from_numpy(tree_np(rp), device="cpu"), tb)
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-5)
    want = {k: to_np(v) for k, v in tree_items(tree_np(rg))}
    got = {k: to_np(v) for k, v in tree_items(tg)}
    assert sorted(got) == sorted(want)
    assert any("['router']" in k for k in got)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_grad_accum_carries_the_aux_loss():
    """grad_accum=2: the loss, xent and aux are the means of the two
    microbatches' own (each run with grad_accum=1), the aux nonzero."""
    rcfg = ref_reduced(ref_get_config(PHI), layers=2)
    tcfg = reduced(get_config(PHI), layers=2)
    params = params_from_numpy(tree_np(RC.init_params(
        jax.random.PRNGKey(0), RM.model_schema(rcfg))), device="cpu")
    _, tb = _data(rcfg)
    l2, p2, _ = S.make_grad_fn(tcfg, dataclasses.replace(PCFG, grad_accum=2),
                               TCFG)(params, tb)
    g1 = S.make_grad_fn(tcfg, PCFG, TCFG)
    halves = [g1(params, {k: v[i * 2:(i + 1) * 2] for k, v in tb.items()})
              for i in range(2)]
    assert float(p2["aux"]) > 0
    np.testing.assert_allclose(float(l2), float(sum(h[0] for h in halves)) / 2,
                               rtol=1e-6)
    for key in ("xent", "aux"):
        np.testing.assert_allclose(
            float(p2[key]), float(sum(h[1][key] for h in halves)) / 2,
            rtol=1e-6, err_msg=key)
