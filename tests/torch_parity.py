"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU as its own tests run it, and arrays cross as
numpy.  Emulator params come from the reference's ``init_params`` and
reach the port through ``repro_torch.interop``.
"""
from __future__ import annotations

import numpy as np


def to_np(x) -> np.ndarray:
    """jax array / torch tensor -> float-comparable numpy array."""
    try:
        import torch
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            if x.dtype == torch.bfloat16:
                x = x.float()
            return x.numpy()
    except ImportError:
        pass
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def ref_emulator_params(geom, n_periph: int = 0, seed: int = 0):
    """Reference-initialized Conv4Xbar params as a numpy dict, with
    nonzero biases so the bias paths are exercised too."""
    import jax
    from repro.core.conv4xbar import conv4xbar_schema
    from repro.models.common import init_params
    p = init_params(jax.random.PRNGKey(seed), conv4xbar_schema(geom, n_periph))
    rng = np.random.default_rng(seed + 100)
    out = {}
    for k, v in p.items():
        a = np.asarray(v, np.float32)
        if k.endswith("_b"):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


def both_emulator_params(geom, n_periph: int = 0, seed: int = 0):
    """(jax dict, torch dict) of the same emulator params."""
    import jax.numpy as jnp
    from repro_torch.interop import emulator_params_from_numpy
    npp = ref_emulator_params(geom, n_periph, seed)
    return ({k: jnp.asarray(v) for k, v in npp.items()},
            emulator_params_from_numpy(npp, device="cpu"))


def assert_close(got, want, rtol, atol, what=""):
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


# --------------------------------------------------------------------------- #
# Model-level parity (the serving slice against the JAX package)
# --------------------------------------------------------------------------- #
def _ref_splice(z, c):
    """The reference ServeSession's prefill-cache splice."""
    import jax
    c = c.astype(z.dtype)
    if z.shape == c.shape:
        return c
    if z.ndim == c.ndim and ((z.shape[2:] == c.shape[2:] and z.shape[0] == c.shape[0])
                             or (z.shape[3:] == c.shape[3:]
                                 and z.shape[:2] == c.shape[:2])):
        return jax.lax.dynamic_update_slice(z, c, (0,) * c.ndim)
    return z


def executors(backend, layers=("mlp",)):
    """(reference, port) analog executors with the same emulator params on
    the projections of ``layers`` (tag prefixes; default the MLP's);
    (None, None) for the digital backend."""
    if backend == "digital":
        return None, None
    from repro.configs.base import AnalogConfig as RefAnalogConfig
    from repro.configs.rram_ps32 import CASE_A as REF_A
    from repro.core.analog import AnalogExecutor as RefExecutor
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.analog import AnalogExecutor
    jp, tp = both_emulator_params(REF_A, 0, seed=3)
    ref = RefExecutor(acfg=RefAnalogConfig(enabled=True, backend="emulator",
                                           layers=tuple(layers)),
                      geom=REF_A, emulator_params=jp, use_pallas=False)
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                     layers=tuple(layers)),
                        geom=CASE_A, emulator_params=tp)
    return ref, ex


def same_config(tcfg, rcfg) -> bool:
    """The port's config equals the reference's field for field (nested
    sub-configs compared as dicts; the analog config is the port's own)."""
    import dataclasses
    t, r = dataclasses.asdict(tcfg), dataclasses.asdict(rcfg)
    return all(t[f] == r[f] for f in t if f != "analog")


def model_parity_f32(arch, layers, P, backend, B=2, G=3,
                     analog_layers=("mlp",), params_fn=None):
    """Reduced ``arch`` at ``layers`` in float32 (params and compute):
    prefill logits and G greedy decode steps of the port against
    ``repro.models.model.prefill/decode_step`` on converted params --
    tokens equal, logits within rtol 1e-4 (atol 1e-4 of the logits'
    scale).  ``analog_layers`` are the emulator backend's projections;
    ``params_fn`` (numpy tree -> numpy tree) edits the reference's params
    before both packages take them.  Returns the (reference, port)
    executors (None, None digitally)."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as ref_get_config, reduced as ref_reduced
    from repro.configs.base import ParallelConfig as RefPcfg
    from repro.models import model as RM
    from repro.models.common import init_params as ref_init_params
    from repro.models.common import use_dense_hook as ref_hook
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.serve import _splice_tree
    from repro_torch.models import model as TM
    from repro_torch.models.common import use_dense_hook

    rcfg = ref_reduced(ref_get_config(arch), layers=layers)
    tcfg = reduced(get_config(arch), layers=layers)
    assert same_config(tcfg, rcfg)
    rp = ref_init_params(jax.random.PRNGKey(0), RM.model_schema(rcfg))
    if params_fn is not None:
        rp = jax.tree.map(jnp.asarray, params_fn(tree_np(rp)))
    tp = params_from_numpy(tree_np(rp), device="cpu")
    rpc = RefPcfg(compute_dtype="float32", attn_block_kv=min(1024, P),
                  scan_chunk=min(256, P))
    tpc = ParallelConfig(compute_dtype="float32", attn_block_kv=min(1024, P))
    tokens = np.random.default_rng(1).integers(0, rcfg.vocab_size, (B, P))
    rex, tex = executors(backend, analog_layers)
    rctx = ref_hook(rex.hook) if rex else ref_hook(None)
    tctx = use_dense_hook(tex.hook) if tex else use_dense_hook(None)

    with rctx:
        pf = jax.jit(lambda t: RM.prefill(rp, t, cfg=rcfg, pcfg=rpc,
                                          compute_dtype=jnp.float32))
        dec = jax.jit(lambda t, c, pos: RM.decode_step(
            rp, t, c, pos, cfg=rcfg, pcfg=rpc, compute_dtype=jnp.float32))
        rl, rcache = pf(jnp.asarray(tokens, jnp.int32))
        cache = RM.zeros_cache(RM.model_cache_schema(rcfg, B, P + G,
                                                     dtype=jnp.float32))
        cache = jax.tree.map(_ref_splice, cache, rcache)
        r_logits, r_toks = [np.asarray(rl)], [np.asarray(jnp.argmax(rl, -1))]
        tok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
        for i in range(G):
            rl, cache = dec(tok, cache, jnp.asarray(P + i, jnp.int32))
            r_logits.append(np.asarray(rl))
            r_toks.append(np.asarray(jnp.argmax(rl, -1)))
            tok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)

    with torch.no_grad(), tctx:
        tl, tcache = TM.prefill(tp, torch.from_numpy(tokens), cfg=tcfg,
                                pcfg=tpc, compute_dtype=torch.float32)
        cache = TM.zeros_cache(TM.model_cache_schema(tcfg, B, P + G,
                                                     dtype=torch.float32), "cpu")
        cache = _splice_tree(cache, tcache)
        t_logits, t_toks = [tl.numpy()], [tl.argmax(-1).numpy()]
        tok = tl.argmax(-1)[:, None]
        for i in range(G):
            tl, cache = TM.decode_step(tp, tok, cache, P + i, cfg=tcfg,
                                       pcfg=tpc, compute_dtype=torch.float32)
            t_logits.append(tl.numpy())
            t_toks.append(tl.argmax(-1).numpy())
            tok = tl.argmax(-1)[:, None]

    for step, (g, w) in enumerate(zip(t_logits, r_logits)):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"step {step}")
    np.testing.assert_array_equal(np.stack(t_toks), np.stack(r_toks))
    return rex, tex


def site_keys_match(arch, layers, rex, tex):
    """The reference's and the port's ``ServeSession`` over reduced
    ``arch`` at ``layers``, on executors ``rex`` / ``tex``, discover the
    same analog call sites (the port's on the reference's params)."""
    from repro.launch.serve import ServeSession as RefSession
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.serve import ServeSession
    rs = RefSession(arch, reduced=True, reduced_layers=layers, batch=1,
                    prompt_len=4, gen=2, executor=rex)
    ts = ServeSession(arch, reduced=True, reduced_layers=layers, batch=1,
                      prompt_len=4, gen=2, executor=tex, device="cpu",
                      params=params_from_numpy(tree_np(rs.params),
                                               device="cpu"))
    assert sorted(ts.sites()) == sorted(rs.sites())
    return sorted(ts.sites())


def decode_matches_forward(arch, layers, B=2, P=16, G=3, seed=5,
                           edit_cfg=None):
    """Port only: reduced ``arch`` at ``layers`` (``edit_cfg`` may change
    the config), float32; prefill P tokens, then decode G more (teacher
    forcing), against one forward over all P + G: logits within rtol
    1e-4, atol 1e-4 of their scale."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.serve import _splice_tree
    from repro_torch.models import model as TM
    from repro_torch.models.common import init_params
    cfg = reduced(get_config(arch), layers=layers)
    if edit_cfg is not None:
        cfg = edit_cfg(cfg)
    pcfg = ParallelConfig(compute_dtype="float32")
    params = init_params(0, TM.model_schema(cfg), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P + G)))
    f32 = torch.float32
    with torch.no_grad():
        h, _, _ = TM.forward(params, toks, cfg=cfg, pcfg=pcfg, mode="prefill",
                             compute_dtype=f32)
        want = TM.compute_logits(params, h[:, P - 1:], cfg).numpy()
        logits, pcache = TM.prefill(params, toks[:, :P], cfg=cfg, pcfg=pcfg,
                                    compute_dtype=f32)
        cache = TM.zeros_cache(TM.model_cache_schema(cfg, B, P + G, dtype=f32),
                               "cpu")
        cache = _splice_tree(cache, pcache)
        got = [logits.numpy()]
        for i in range(G):
            logits, cache = TM.decode_step(params, toks[:, P + i:P + i + 1],
                                           cache, P + i, cfg=cfg, pcfg=pcfg,
                                           compute_dtype=f32)
            got.append(logits.numpy())
    scale = float(np.abs(want).max())
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, want[:, i], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"{arch} step {i}")
    return cfg


# bf16 end to end: both packages round activations to bf16 after every op,
# but a matmul's f32 result can round to the neighbouring bf16 value when
# the two frameworks sum in another order.  Digitally that stays an ulp
# (measured on gemma3-1b: at most 0.0067 of the logits' max |value| over 3
# steps and 2 seeds).  On the emulator backend one such ulp is amplified:
# the gate-overdrive drive map sends a zero activation to 0 V and any
# nonzero one to at least v_th (0.4 of full scale), and a bf16 gelu output
# that is exactly 0 on one side and tiny on the other (tanh saturating at
# a threshold an ulp away) moves that row's analog mlp.down output by
# O(1).  Measured: at most 0.37 of the logits' max |value| over the same
# steps and seeds, with identical tokens.  The bounds are those
# measurements rounded up; f32 parity of the same path is
# ``model_parity_f32``.
BF16_REL = {"digital": 0.02, "emulator": 0.5}


def serve_sessions_bf16(arch, layers, backend, P=16, B=2, G=3, seed=0):
    """(port session, reference session, port output, reference output):
    ``ServeSession`` on the CPU in bfloat16, the port's on the reference
    session's own params and prompt."""
    import torch
    from repro.launch.serve import ServeSession as RefSession
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.serve import ServeSession
    rex, tex = executors(backend)
    rs = RefSession(arch, reduced=True, reduced_layers=layers, batch=B,
                    prompt_len=P, gen=G, seed=seed, executor=rex)
    rout = rs.generate()
    ts = ServeSession(arch, reduced=True, reduced_layers=layers, batch=B,
                      prompt_len=P, gen=G, seed=seed, executor=tex,
                      device="cpu", params=params_from_numpy(
                          tree_np(rs.params), device="cpu"),
                      prompt=torch.tensor(np.asarray(rs.batch["tokens"])))
    return ts, rs, ts.generate(), rout


def nudged_generate(rs, seed, leaf="", share=0.01):
    """The reference session ``rs`` generated again with ``share`` of the
    elements of every parameter whose key path holds ``leaf`` (every one
    for "") moved up by one bfloat16 ulp (drawn from ``seed``): how far
    the path itself carries a rounding difference.  ``rs`` keeps the
    nudged params."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)

    def nudge(path, v):
        if leaf not in jax.tree_util.keystr(path):
            return v
        a = np.asarray(v.astype(jnp.float32))
        hit = rng.random(a.shape) < share
        return jnp.asarray(np.where(hit, a * (1 + 2.0 ** -7), a), v.dtype)

    rs.params = jax.tree_util.tree_map_with_path(nudge, rs.params)
    rs._steps_built = False            # rebuild the steps on new params
    return rs.generate()


def step_rel(a, b, scale):
    """Per decode step, the largest |a - b| over ``scale``."""
    return [float(np.abs(a[s] - b[s]).max()) / scale for s in range(a.shape[0])]


def serve_parity_bf16(arch, layers, backend, P=16, B=2, G=3):
    """``ServeSession`` end to end on the CPU in bfloat16, on the reference
    session's own params and prompt: the same call sites, the first token
    equal, the logits within ``BF16_REL[backend]`` of their scale."""
    ts, rs, tout, rout = serve_sessions_bf16(arch, layers, backend, P, B, G)
    assert sorted(ts.sites()) == sorted(rs.sites())
    assert tout["tokens"].shape == rout["tokens"].shape == (B, G)
    assert tout["logits"].shape == rout["logits"].shape
    assert np.isfinite(tout["logits"]).all()
    # the first token comes from the prefill logits alone
    np.testing.assert_array_equal(tout["tokens"][:, 0], rout["tokens"][:, 0])
    scale = float(np.abs(rout["logits"]).max())
    err = float(np.abs(tout["logits"] - rout["logits"]).max())
    assert err <= BF16_REL[backend] * scale, (err, scale)
