"""The int8-compressed collectives of the port on the CPU: ``int8_compress``
/ ``int8_decompress`` against the reference's (bit-equal), and
``compressed_all_reduce`` / ``compressed_grad_sync`` in 4 processes over
``torch.distributed``'s gloo backend against the exact sum, within 8 x
the common scale as the reference's ``PSUM_SCRIPT``
(``tests/test_multidevice.py``) holds ``compressed_psum``."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.parallel.collectives import int8_compress as ref_compress  # noqa: E402
from repro_torch.parallel import (compressed_grad_sync, int8_compress,  # noqa: E402
                                  int8_decompress)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
WORLD = 4

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, SRC)
from repro_torch.parallel import compressed_all_reduce, compressed_grad_sync
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                        rank=RANK, world_size=WORLD)
try:
    x = np.random.default_rng(0).standard_normal((WORLD, 256)).astype(np.float32)
    y = compressed_all_reduce(torch.from_numpy(x[RANK]))
    scale = float(np.abs(x).max()) / 127.0
    err = float(np.abs(y.numpy() - x.sum(0)).max())
    tree = {"a": torch.from_numpy(x[RANK, :16].copy()),
            "b": {"c": torch.from_numpy(x[RANK, 16:].reshape(12, 20).copy())}}
    g = compressed_grad_sync(tree, dist.group.WORLD)
    mean = x.mean(0)
    gerr = max(float(np.abs(g["a"].numpy() - mean[:16]).max()),
               float(np.abs(g["b"]["c"].numpy().ravel() - mean[16:]).max()))
    gscale = max(float(np.abs(x[:, :16]).max()),
                 float(np.abs(x[:, 16:]).max())) / 127.0
    print("RESULT " + json.dumps({"err": err, "scale": scale, "gerr": gerr,
                                  "gscale": gscale, "y": y.tolist()}))
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_int8_compress_matches_reference():
    x = np.random.default_rng(1).standard_normal((8, 33)).astype(np.float32)
    rq, rs = ref_compress(jnp.asarray(x))
    q, s = int8_compress(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    back = int8_decompress(q, s).numpy()
    assert float(np.abs(back - x).max()) <= float(s) / 2 + 1e-7


def test_grad_sync_is_the_identity_without_a_group():
    g = {"w": torch.ones(3)}
    assert compressed_grad_sync(g, None) is g


def test_compressed_all_reduce_in_four_gloo_processes():
    """Each rank holds one row of a (4, 256) draw; the int8 sum is within
    8 x scale of the exact sum (scale = max |x| / 127), the same on every
    rank; the tree sync is within 8 x its scale / 4 of the exact mean."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"SRC={SRC!r}\nPORT={port}\nRANK={r}\n"
         f"WORLD={WORLD}\n" + WORKER],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, err[-2000:]
        line = next(l for l in out.splitlines() if l.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    for r in results:
        assert r["err"] <= 8 * r["scale"] + 1e-6, r
        assert r["gerr"] <= 8 * r["gscale"] / WORLD + 1e-6, r
        assert r["y"] == results[0]["y"]
