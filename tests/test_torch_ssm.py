"""The state-space mixers (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU, inputs and params made with
numpy from a seed.

* ``chunked_recurrence``: the port hands the flattened lanes to the
  linear-scan entry point (B6's plain version on the CPU, a sequential
  float32 carry); the reference runs an associative scan in chunks of
  its ``chunk`` (the port has none).  They sum in another order: rtol
  1e-5 / atol 1e-6.
* ``_causal_conv``: the same taps in the same order, same tolerance.
* ``mamba_mixer`` / ``rglru_mixer`` in float32, prefill then one decode
  step on converted params: output and new cache within rtol 1e-4, atol
  1e-4 of the output's scale.
* On a CUDA tensor ``chunked_recurrence`` reaches the kernel's wrapper
  and never the plain version (the dispatch emulated: no card here).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config, reduced as ref_reduced  # noqa: E402
from repro.configs.base import ParallelConfig as RefPcfg  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models.common import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from torch_parity import assert_close, to_np, tree_np  # noqa: E402

scan_ops = importlib.import_module("repro_torch.kernels.linear_scan.ops")


def _recurrence_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    h0 = rng.standard_normal((shape[0],) + shape[2:]).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("shape", [(2, 24, 40), (2, 24, 6, 4)],
                         ids=["3d", "4d"])
@pytest.mark.parametrize("chunk", [8, 7], ids=["divides", "ragged"])
@pytest.mark.parametrize("h0_kind", ["zero", "nonzero"])
def test_chunked_recurrence_matches_reference(shape, chunk, h0_kind):
    a, b, h0 = _recurrence_inputs(shape, sum(shape) + chunk)
    if h0_kind == "zero":
        h0 = np.zeros_like(h0)
    wh, wl = RS.chunked_recurrence(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(h0), chunk)
    h, h_last = TS.chunked_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(h0))
    assert tuple(h.shape) == shape and tuple(h_last.shape) == h0.shape
    assert_close(h, wh, 1e-5, 1e-6, "h")
    assert_close(h_last, wl, 1e-5, 1e-6, "h_last")
    if h0_kind == "zero":
        # no state (what prefill passes) is exactly a zero state
        hn, ln = TS.chunked_recurrence(torch.from_numpy(a),
                                       torch.from_numpy(b), None)
        assert torch.equal(hn, h) and torch.equal(ln, h_last)


def test_chunked_recurrence_launches_the_kernel_on_a_cuda_tensor(monkeypatch):
    """The dispatch of ``ops.linear_scan`` emulated for a CUDA tensor: the
    kernel's wrapper gets the flattened (B, S, lanes) operands, contiguous,
    and no fold when there is no state; the plain version is not reached."""
    calls = []
    real_plain = scan_ops.linear_scan_plain

    def kernel(a, b, b0=None):
        calls.append((tuple(a.shape), a.is_contiguous(), b.is_contiguous(), b0))
        return real_plain(a, b, b0)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(scan_ops, "on_cuda", lambda t, name: True)
    monkeypatch.setattr(scan_ops, "linear_scan_plain", plain)
    monkeypatch.setattr(scan_ops, "linear_scan_cuda", kernel)
    a, b, h0 = _recurrence_inputs((2, 5, 3, 4), 9)
    h, _ = TS.chunked_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                 None)
    assert calls == [((2, 5, 12), True, True, None)]
    assert tuple(h.shape) == (2, 5, 3, 4)
    TS.chunked_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(h0))
    assert calls[1][3] is not None and tuple(calls[1][3].shape) == (2, 12)


def test_chunked_recurrence_refuses_other_devices():
    meta = torch.empty((1, 4, 2, 3), device="meta")
    with pytest.raises(ValueError, match="linear_scan"):
        TS.chunked_recurrence(meta, meta, None)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3 + with_state)
    B, S, K, Di = 2, 9, 4, 12
    x = rng.standard_normal((B, S, Di)).astype(np.float32)
    w = rng.standard_normal((K, Di)).astype(np.float32)
    b = rng.standard_normal((Di,)).astype(np.float32)
    st = rng.standard_normal((B, K - 1, Di)).astype(np.float32) if with_state else None
    wy, ws = RS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    ty, ts = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b),
                             None if st is None else torch.from_numpy(st))
    assert_close(ty, wy, 1e-5, 1e-6, "y")
    assert_close(ts, ws, 1e-5, 1e-6, "state")


def _jitter(tree, rng):
    """The reference's init plus noise, so that no zeros or ones (biases,
    A_log, D, lam) hide a wrong term."""
    if isinstance(tree, dict):
        return {k: _jitter(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)


MIXERS = {"mamba": ("falcon-mamba-7b", "mamba"),
          "rglru": ("recurrentgemma-2b", "rglru")}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_matches_reference_f32(mixer, mode):
    """Prefill from no state; decode one token from the prefill's cache."""
    arch, name = MIXERS[mixer]
    rcfg = ref_reduced(ref_get_config(arch))
    tcfg = reduced(get_config(arch))
    rschema = getattr(RS, f"{name}_schema")(rcfg)
    npp = _jitter(tree_np(ref_init_params(jax.random.PRNGKey(1), rschema)),
                  np.random.default_rng(2))
    rp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_numpy(npp, device="cpu")
    rmix, tmix = getattr(RS, f"{name}_mixer"), getattr(TS, f"{name}_mixer")
    rpc, tpc = RefPcfg(scan_chunk=8), ParallelConfig()
    rng = np.random.default_rng(4)
    B, S = 2, 20
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, rcfg.d_model)).astype(np.float32)

    def check(got, want, what):
        w = to_np(want)
        assert_close(got, w, 1e-4, 1e-4 * float(np.abs(w).max()), what)

    wy, wc = rmix(rp, jnp.asarray(x), cfg=rcfg, pcfg=rpc, mode="prefill")
    with torch.no_grad():
        ty, tc = tmix(tp, torch.from_numpy(x), cfg=tcfg, pcfg=tpc,
                      mode="prefill")
    assert sorted(tc) == sorted(wc) == ["conv", "h"]
    assert tc["h"].dtype == torch.float32
    if mode == "prefill":
        check(ty, wy, "prefill out")
        for k in tc:
            check(tc[k], wc[k], f"prefill cache {k}")
        return

    wy, wc2 = rmix(rp, jnp.asarray(x1), cfg=rcfg, pcfg=rpc, cache=wc,
                   mode="decode")
    with torch.no_grad():
        ty, tc2 = tmix(tp, torch.from_numpy(x1), cfg=tcfg, pcfg=tpc, cache=tc,
                       mode="decode")
    check(ty, wy, "decode out")
    for k in tc2:
        check(tc2[k], wc2[k], f"decode cache {k}")
