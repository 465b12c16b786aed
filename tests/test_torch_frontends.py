"""The frontend archs internvl2-76b (a vision stub: precomputed patch
embeddings through the ``frontend.proj`` site over the first positions)
and seamless-m4t-large-v2 (an encoder over precomputed frames, the
decoder's cross attention and its caches), and the logit softcap, served
by the port, against the JAX package on the CPU.

(a) Configs and schemas: the config copies equal the reference's; the
    full-size and reduced key paths and shapes equal the reference's.
(b) Units in float32 (rtol 1e-5 / atol 1e-6): the bidirectional and the
    cross ``attn_mixer``, with key lengths that are and are not a
    multiple of the KV block (the padded keys masked).
(c) Model level in float32 (params and compute), reduced configs, 2
    layers: prefill logits and 3 greedy decode steps against
    ``repro.models.model.prefill/decode_step`` on converted params, the
    same image embeddings or frames given to both; tokens equal, logits
    within rtol 1e-4 (atol 1e-4 of the logits' scale); digitally and on
    the emulator backend, whose call sites (``frontend.proj#0``,
    ``enc.{p}:...``, the cross sites) equal the reference's.
(d) ``ServeSession`` in bfloat16 against the reference session on its
    own params, prompt, embeddings and frames (``BF16_REL``'s bound).
(e) Port only: prefill + decode equals one forward over the sequence
    (a cross cache of 5 encoder positions).
(f) The logit softcap (reduced gemma3-1b at ``logit_softcap=30``):
    prefill and decode against the reference, decode against one
    forward, ``chunked_xent`` and its gradient against ``jax.grad``.
(g) Training: ``lm_loss`` and every gradient against
    ``jax.value_and_grad`` of the reference's, under remat "none",
    "full" and, with an analog hook on the encoder arch, "dots".
(h) A vision prompt shorter than the image raises ``ValueError``.
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
from repro.models.common import use_dense_hook as ref_hook  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import tree_items, use_dense_hook  # noqa: E402
from repro_torch.runtime import steps as S  # noqa: E402
from torch_parity import (decode_matches_forward, executors,  # noqa: E402
                          model_parity_f32, same_config, serve_parity_bf16,
                          site_keys_match, to_np, tree_np)

VLM, AUDIO = "internvl2-76b", "seamless-m4t-large-v2"
FRONTENDS = (VLM, AUDIO)
# each arch's analog projections beyond the MLPs: the vision projection
# with the attention, the encoder's and the cross attention's with the MLPs
ANALOG = {VLM: ("frontend.proj", "attn"), AUDIO: ("mlp", "attn")}
SEQ, BATCH = 16, 2
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


# --------------------------------------------------------------------------- #
# (a) configs and schemas
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FRONTENDS)
def test_model_schema_matches_reference(arch):
    rcfg, tcfg = ref_get_config(arch), get_config(arch)
    assert same_config(tcfg, rcfg)
    for t, r in ((tcfg, rcfg), (reduced(tcfg), ref_reduced(rcfg))):
        assert same_config(t, r)
        got = _shapes(TM.model_schema(t), TC.is_schema_leaf)
        assert got == _shapes(RM.model_schema(r), RC.is_schema_leaf)
    if arch == VLM:
        assert got[("proj",)] == (64, 64)
    else:
        assert ("encoder", "final_norm", "w") in got
        assert got[("decoder", "scan", "p0", "cross", "wq")] == (2, 64, 64)
        assert ("decoder", "scan", "p0", "cross", "bq") not in got


# --------------------------------------------------------------------------- #
# (b) the bidirectional and cross attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,S,Sk,block", [
    ("B", 8, 8, 4), ("B", 6, 6, 4), ("cross", 3, 5, 4), ("cross", 1, 5, 4),
    ("cross", 4, 8, 8)])
def test_attn_mixer_matches_reference(kind, S, Sk, block):
    """Reduced seamless' ``attn_mixer`` (rtol 1e-5 / atol 1e-6): the BIDIR
    kind at train and prefill (its prefill cache too), the cross kind on
    given encoder keys and values; key lengths not a multiple of
    ``block`` pad the KV, and the padded keys must stay masked."""
    rcfg = ref_reduced(ref_get_config(AUDIO))
    tcfg = reduced(get_config(AUDIO))
    rng = np.random.default_rng(S * 10 + Sk)
    rp = tree_np(RC.init_params(jax.random.PRNGKey(0),
                                RA.attention_schema(rcfg, cross=kind == "cross")))
    jp = jax.tree.map(jnp.asarray, rp)
    tp = params_from_numpy(rp, device="cpu")
    x = rng.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    rpc = RefPcfg(compute_dtype="float32", attn_block_kv=block)
    tpc = ParallelConfig(compute_dtype="float32", attn_block_kv=block)
    if kind == "cross":
        kv = [rng.standard_normal((2, Sk, rcfg.num_kv_heads, rcfg.head_dim))
              .astype(np.float32) for _ in range(2)]
        want, _ = RA.attn_mixer(jp, jnp.asarray(x), cfg=rcfg, pcfg=rpc,
                                kind="cross", mode="prefill",
                                enc_kv=tuple(jnp.asarray(a) for a in kv))
        got, cache = TA.attn_mixer(tp, torch.from_numpy(x), cfg=tcfg,
                                   pcfg=tpc, kind="cross", mode="prefill",
                                   enc_kv=tuple(torch.from_numpy(a)
                                                for a in kv))
        assert cache is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        return
    for mode in ("train", "prefill"):
        want, rcache = RA.attn_mixer(jp, jnp.asarray(x), cfg=rcfg, pcfg=rpc,
                                     kind=kind, mode=mode)
        got, tcache = TA.attn_mixer(tp, torch.from_numpy(x), cfg=tcfg,
                                    pcfg=tpc, kind=kind, mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=mode)
        assert (tcache is None) == (rcache is None) == (mode == "train")
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(rcache[k]),
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# (c) model level against the reference, (d) the bf16 session
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,backend,analog", [
    (VLM, "digital", None), (AUDIO, "digital", None),
    (VLM, "emulator", ("mlp",)), (AUDIO, "emulator", ("mlp",)),
    (VLM, "emulator", ANALOG[VLM]), (AUDIO, "emulator", ANALOG[AUDIO])])
def test_model_prefill_decode_match_reference_f32(arch, backend, analog):
    """Two layers (two stacked decoder periods; seamless' reduced encoder
    has two layers too); on the emulator with a short prompt (its plain
    CPU evaluation is the slow part), whose call sites equal the
    reference's."""
    P = 8 if backend == "emulator" else 16
    rex, tex = model_parity_f32(arch, 2, P, backend,
                                analog_layers=analog or ("mlp",))
    if backend == "digital":
        return
    keys = site_keys_match(arch, 2, rex, tex)
    n_mlp = (2 if arch == AUDIO else 3) * 2 * (2 if arch == AUDIO else 1)
    if analog == ("mlp",):
        assert len(keys) == n_mlp and all(":mlp." in k for k in keys)
    elif arch == VLM:
        assert "frontend.proj#0" in keys and len(keys) == 1 + 4 * 2
    else:
        # per encoder layer 4 + 2, per decoder layer 4 + 4 (cross) + 2
        assert len(keys) == 2 * 6 + 2 * 10
        assert {"enc.0:attn.q#0", "enc.1:mlp.down#0", "dec.1:attn.k#1",
                "dec.0:attn.o#1"} <= set(keys)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_serve_session_end_to_end_bf16(arch):
    serve_parity_bf16(arch, 2, "digital")


@pytest.mark.parametrize("arch", FRONTENDS)
def test_decode_matches_the_full_forward(arch):
    """The vision arch's image over the first 4 of 16 positions; the
    encoder arch's cross caches hold 5 encoder positions."""
    cfg = decode_matches_forward(arch, 2, enc_len=5)
    assert cfg.frontend_tokens == 4


# --------------------------------------------------------------------------- #
# (f) the logit softcap
# --------------------------------------------------------------------------- #
def _softcapped(cfg):
    return dataclasses.replace(cfg, logit_softcap=30.0)


def test_logit_softcap_prefill_decode_match_reference():
    """Reduced gemma3-1b at a softcap of 30 against the reference (the
    parity helper's gate), and against one forward over the sequence;
    the cap moves the logits by more than that gate."""
    model_parity_f32("gemma3-1b", 2, 16, "digital", edit_cfg=_softcapped)
    cfg = decode_matches_forward("gemma3-1b", 2, edit_cfg=_softcapped)
    assert cfg.logit_softcap == 30.0
    params = TC.init_params(0, TM.model_schema(cfg), device="cpu")
    h = 8.0 * torch.randn((2, 3, cfg.d_model),
                          generator=torch.Generator().manual_seed(0))
    capped = TM.compute_logits(params, h, cfg)[..., :cfg.vocab_size]
    plain = TM.compute_logits(params, h, dataclasses.replace(
        cfg, logit_softcap=0.0))[..., :cfg.vocab_size]
    assert float(capped.abs().max()) < 30.0
    torch.testing.assert_close(capped, torch.tanh(plain / 30.0) * 30.0)
    assert float((capped - plain).abs().max()) > 1e-2 * float(
        plain.abs().max())


def test_logit_softcap_chunked_xent_and_grad_match_reference():
    """``chunked_xent`` (two chunks, a z-loss) under the softcap, and its
    gradient with respect to h and the embedding, against the
    reference's under ``jax.value_and_grad``: rtol 1e-5 for the loss,
    rtol 1e-4 / atol 1e-6 for the gradients."""
    rcfg = _softcapped(ref_reduced(ref_get_config("gemma3-1b")))
    tcfg = _softcapped(reduced(get_config("gemma3-1b")))
    rp = tree_np(RC.init_params(jax.random.PRNGKey(0), RM.model_schema(rcfg)))
    rng = np.random.default_rng(3)
    h = (4.0 * rng.standard_normal((2, 8, rcfg.d_model))).astype(np.float32)
    tg = rng.integers(0, rcfg.vocab_size, (2, 8))
    mask = (rng.random((2, 8)) > 0.2).astype(np.float32)

    def ref_loss(embed, h):
        return RM.chunked_xent({"embed": embed}, h, jnp.asarray(tg),
                               jnp.asarray(mask), cfg=rcfg, chunk=4,
                               z_coef=1e-4)

    rl, (rge, rgh) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(rp["embed"]), jnp.asarray(h))
    embed = torch.from_numpy(rp["embed"]).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    tl = TM.chunked_xent({"embed": embed}, th, torch.from_numpy(tg),
                         torch.from_numpy(mask), cfg=tcfg, chunk=4,
                         z_coef=1e-4)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-5)
    for got, want in ((embed.grad, rge), (th.grad, rgh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)


# --------------------------------------------------------------------------- #
# (g) training
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,remat,analog", [
    (VLM, "none", False), (AUDIO, "full", False), (AUDIO, "dots", True)])
def test_lm_loss_and_grads_match_reference(arch, remat, analog):
    """``lm_loss`` and every leaf's gradient (the vision projection, the
    encoder, the cross attention) against ``jax.value_and_grad`` of the
    reference's under the same remat policy, on the reference's
    synthetic batch with its image embeddings or frames: the loss within
    rtol 1e-5, the grads within rtol 1e-4 / atol 1e-6.  The analog case
    runs the MLPs on the emulator under "dots", where each stacked
    period (the encoder's too) first runs on one position to build the
    hook's caches."""
    rcfg = ref_reduced(ref_get_config(arch))
    tcfg = reduced(get_config(arch))
    rpc = RefPcfg(compute_dtype="float32", attn_block_kv=8, xent_chunk=8,
                  remat=remat)
    tpc = ParallelConfig(compute_dtype="float32", attn_block_kv=8,
                         xent_chunk=8, remat=remat)
    rp = RC.init_params(jax.random.PRNGKey(0), RM.model_schema(rcfg))
    b = RefData(rcfg, SEQ, BATCH).batch(0)
    assert ("image_embeds" if arch == VLM else "enc_frames") in b
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    tb["tokens"], tb["targets"] = tb["tokens"].long(), tb["targets"].long()
    rex, tex = executors("emulator" if analog else "digital")

    def loss(p, batch):
        return RM.lm_loss(p, batch, cfg=rcfg, pcfg=rpc,
                          compute_dtype=jnp.float32, z_coef=TCFG.z_loss)

    with ref_hook(rex.hook if rex else None):
        (rl, _), rg = jax.jit(jax.value_and_grad(loss, has_aux=True))(rp, jb)
    with use_dense_hook(tex.hook if tex else None):
        tl, _, tg = S.make_grad_fn(tcfg, tpc, TCFG)(
            params_from_numpy(tree_np(rp), device="cpu"), tb)
    if analog:
        assert tex.calls and all(t.startswith("mlp") for t in tex.calls)
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-5)
    want = {k: to_np(v) for k, v in tree_items(tree_np(rg))}
    got = {k: to_np(v) for k, v in tree_items(tg)}
    assert sorted(got) == sorted(want)
    assert any(("['proj']" if arch == VLM else "['encoder']") in k
               for k in got)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# --------------------------------------------------------------------------- #
# (h) a vision prompt shorter than the image
# --------------------------------------------------------------------------- #
def test_vision_prompt_shorter_than_the_image_raises():
    from repro_torch.launch.serve import ServeSession
    sess = ServeSession(VLM, reduced=True, batch=1, prompt_len=3, gen=2,
                        device="cpu")
    assert sess.batch["image_embeds"].shape == (1, 4, 64)
    with pytest.raises(ValueError, match="4 image positions .* 3 tokens"):
        sess.generate()
