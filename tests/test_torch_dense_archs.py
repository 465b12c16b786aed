"""The dense decoder archs qwen1.5-110b (q/k/v biases) and
command-r-plus-104b (layernorm, the parallel block, tied embeddings),
served by the port, against the JAX package on the CPU.

(a) Configs and schemas: the config copies equal the reference's; the
    full-size key paths and shapes equal the reference's; ``get_config``
    serves the four decoder archs of this slice and the two frontend
    archs (``tests/test_torch_frontends.py``), and refuses an unknown
    name.
(b) Units in float32 (rtol 1e-5 / atol 1e-6): ``layernorm`` (also in
    bfloat16, within one bf16 ulp) and the biased q/k/v projections with
    nonzero biases (the reference's schema starts them at zero, which
    would hide the bias path).
(c) Model level in float32 (params and compute), reduced configs, 2
    layers: prefill logits and 3 greedy decode steps against
    ``repro.models.model.prefill/decode_step`` on converted params with
    nonzero biases, tokens equal, logits within rtol 1e-4 (atol 1e-4 of
    the logits' scale); qwen also on the emulator backend (its MLPs
    analog), whose call sites equal the reference's.
(d) ``ServeSession`` in bfloat16 against the reference session
    (``BF16_REL``'s bound).
(e) Port only: prefill + decode equals one forward over the sequence.
(f) The serve CLI serves the four decoder archs of this slice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from torch_parity import (decode_matches_forward, model_parity_f32,  # noqa: E402
                          same_config, serve_parity_bf16, site_keys_match,
                          tree_np)

DENSE = ("qwen1.5-110b", "command-r-plus-104b")
DECODERS = DENSE + ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")


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


@pytest.mark.parametrize("arch", DENSE)
def test_model_schema_matches_reference(arch):
    rcfg, tcfg = ref_get_config(arch), get_config(arch)
    assert same_config(tcfg, rcfg)
    assert same_config(reduced(tcfg), ref_reduced(rcfg))
    assert _shapes(TM.model_schema(tcfg), TC.is_schema_leaf) == \
        _shapes(RM.model_schema(rcfg), RC.is_schema_leaf)


def test_get_config_serves_the_decoders_and_refuses_the_frontend_archs():
    """Every arch of the reference's registry is served now, the two
    frontend archs too; only a name the reference does not know is
    refused."""
    from repro.configs import ARCH_NAMES as REF_ARCHS
    from repro_torch.configs import ARCH_NAMES
    assert ARCH_NAMES == REF_ARCHS
    for arch in DECODERS + ("internvl2-76b", "seamless-m4t-large-v2"):
        assert same_config(get_config(arch), ref_get_config(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def _bf16_np(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """fp32 statistics, eps 1e-5, scale and shift; the result in x's
    dtype: float32 within rtol 1e-5 / atol 1e-6, bfloat16 within one
    bf16 ulp of the reference's (2^-7 of the value)."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((4, 5, 64)) + 1.5).astype(np.float32)
    w = (1.0 + 0.3 * rng.standard_normal(64)).astype(np.float32)
    b = (0.2 * rng.standard_normal(64)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_np(x)
        want = np.asarray(RC.layernorm(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(w), jnp.asarray(b))
                          .astype(jnp.float32))
        got = TC.layernorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                           torch.from_numpy(b))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-30)
    else:
        want = np.asarray(RC.layernorm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b)))
        got = TC.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the schema and apply_norm's branch
    assert sorted(TC.norm_schema(64, "layernorm")) == ["b", "w"]
    np.testing.assert_array_equal(
        TC.apply_norm({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                      torch.from_numpy(x), "layernorm").numpy(),
        TC.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b)).numpy())


def _with_biases(tree, seed=7, scale=0.3):
    """A numpy param tree with every bias leaf (``bq``/``bk``/``bv`` and
    the norms' ``b``) drawn from ``seed`` in place of its zeros."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bq", "bk", "bv", "b"):
                out[k] = (scale * rng.standard_normal(v.shape)).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree)


def test_qkv_bias_projections_match_reference():
    """Reduced qwen's q/k/v projections with nonzero biases, added after
    the product in x's dtype: rtol 1e-5 / atol 1e-6."""
    rcfg = ref_reduced(ref_get_config("qwen1.5-110b"))
    tcfg = reduced(get_config("qwen1.5-110b"))
    assert tcfg.qkv_bias
    rp = _with_biases(tree_np(RC.init_params(jax.random.PRNGKey(0),
                                             RA.attention_schema(rcfg))))
    assert sorted(rp) == sorted(TA.attention_schema(tcfg))
    assert np.abs(rp["bq"]).min() > 0
    tp = params_from_numpy(rp, device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 5, rcfg.d_model)) \
        .astype(np.float32)
    jp = jax.tree.map(jnp.asarray, rp)
    rq = RA._project_q(jp, jnp.asarray(x), rcfg)
    rk, rv = RA._project_kv(jp, jnp.asarray(x), rcfg)
    tq = TA._project_q(tp, torch.from_numpy(x), tcfg)
    tk, tv = TA._project_kv(tp, torch.from_numpy(x), tcfg)
    for got, want in ((tq, rq), (tk, rk), (tv, rv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    # the bias moved the projection
    assert not np.allclose(tq.numpy(), np.asarray(
        RA._project_q(dict(jp, bq=jnp.zeros_like(jp["bq"])),
                      jnp.asarray(x), rcfg)))


@pytest.mark.parametrize("arch,backend", [
    ("qwen1.5-110b", "digital"), ("command-r-plus-104b", "digital"),
    ("qwen1.5-110b", "emulator")])
def test_model_prefill_decode_match_reference_f32(arch, backend):
    """Two layers (two stacked periods of the one-layer pattern), every
    bias nonzero; the emulator on the MLP projections, with a short
    prompt (its plain CPU evaluation is the slow part)."""
    P = 8 if backend == "emulator" else 16
    rex, tex = model_parity_f32(arch, 2, P, backend, params_fn=_with_biases)
    if backend == "emulator":
        keys = site_keys_match(arch, 2, rex, tex)
        assert len(keys) == 2 * 3 and all(":mlp." in k for k in keys)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_session_end_to_end_bf16(arch):
    serve_parity_bf16(arch, 2, "digital")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_the_full_forward(arch):
    cfg = decode_matches_forward(arch, 3)
    assert cfg.num_periods == 3


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_cli_takes_the_decoder_archs(arch):
    from repro_torch.launch import serve
    sess, out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "4", "--gen", "2"])
    assert sess.cfg.name == f"{arch}-reduced"
    assert out["tokens"].shape == (2, 2)
    assert np.isfinite(out["logits"]).all()
