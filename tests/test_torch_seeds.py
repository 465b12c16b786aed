"""Seeds of the port on the CPU: distinct seeds give distinct draws.

The CPU generator (mt19937) keeps only the low 32 bits of a seed, so a
seed and a path must be folded into 32 bits before they reach it
(``models.common.fold_seed``); a seed shifted above bit 31 would be lost.
Checked for ``init_params`` (every leaf), the emulator's initial params
and ``ServeSession``'s init, prompt and sampling generators; equal seeds
give equal draws.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.rram_ps32 import CASE_A  # noqa: E402
from repro_torch.core import conv4xbar  # noqa: E402
from repro_torch.launch.serve import ServeSession  # noqa: E402
from repro_torch.models.common import fold_seed, init_params  # noqa: E402

SEEDS = (0, 1, 2, 7, 2 ** 32)


def _schema():
    return conv4xbar.conv4xbar_schema(CASE_A, 2)


def _random_leaves(p):
    return {k: v for k, v in p.items() if v.abs().sum() > 0}


def test_fold_seed_keeps_the_seed_and_the_tag_in_32_bits():
    folds = {fold_seed(s, t) for s in SEEDS for t in ("init", "prompt")}
    assert len(folds) == 2 * len(SEEDS)
    assert all(0 <= f < 2 ** 32 for f in folds)
    assert fold_seed(3, "a") == fold_seed(3, "a")


@pytest.mark.parametrize("a,b", [(0, 1), (0, 2), (1, 3), (0, 2 ** 32)])
def test_init_params_distinct_seeds_give_distinct_leaves(a, b):
    pa = _random_leaves(init_params(a, _schema(), device="cpu"))
    pb = _random_leaves(init_params(b, _schema(), device="cpu"))
    assert sorted(pa) == sorted(pb) and len(pa) >= 8
    for k in pa:
        assert not torch.equal(pa[k], pb[k]), k


def test_init_params_equal_seeds_give_equal_leaves_and_leaves_differ():
    pa = init_params(5, _schema(), device="cpu")
    pb = init_params(5, _schema(), device="cpu")
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    # two leaves of one shape draw from their own paths
    fc = init_params(5, {"a": _schema()["fc1_w"], "b": _schema()["fc1_w"]},
                     device="cpu")
    assert not torch.equal(fc["a"], fc["b"])


def _session(seed):
    return ServeSession("gemma3-1b", reduced=True, reduced_layers=1, batch=2,
                        prompt_len=8, gen=2, temperature=1.0, seed=seed,
                        device="cpu")


def _draws(sess):
    sample = torch.rand(16, generator=sess._sample_gen)
    return sess.params["embed"].float(), sess.batch["tokens"], sample


def test_serve_session_seed_moves_params_prompt_and_samples():
    d0, d1, d0b = (_draws(_session(s)) for s in (0, 1, 0))
    for x, y, z in zip(d0, d1, d0b):
        assert not torch.equal(x, y)
        assert torch.equal(x, z)
