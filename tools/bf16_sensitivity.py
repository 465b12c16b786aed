"""How far a bfloat16 serve moves under a one-ulp change, for the JAX
package and its PyTorch port side by side, on the CPU.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/bf16_sensitivity.py \
      [--arch recurrentgemma-2b] [--layers 3] [--backend emulator] \
      [--seeds 0 1] [--leaf in_x] [--share 0.01]

Per seed: the reference's reduced ``ServeSession`` (batch 2, prompt 16,
3 tokens) in bfloat16, the port's on the same params and prompt (the
emulator backend on the parity tests' random Conv4Xbar, MLP projections
analog), and the reference again with ``--share`` of the elements of every
parameter whose key path holds ``--leaf`` (every parameter for "") moved
by one bfloat16 ulp.
Prints, per decode step, the largest logit difference over the logits'
largest magnitude: port against reference, and reference against its
perturbed self.  Where the second is as large as the first, the path
itself amplifies rounding, and the port, which sums its matmuls in
another order, cannot be held closer than that.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))
from torch_parity import nudged_generate, serve_sessions_bf16, step_rel  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--backend", default="emulator",
                    choices=["digital", "emulator"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--leaf", default="in_x")
    ap.add_argument("--share", type=float, default=0.01)
    args = ap.parse_args(argv)
    out = []
    for seed in args.seeds:
        _, rs, tout, rout = serve_sessions_bf16(args.arch, args.layers,
                                                args.backend, seed=seed)
        pout = nudged_generate(rs, seed, args.leaf, args.share)
        scale = float(np.abs(rout["logits"]).max())
        row = {"seed": seed,
               "port_vs_ref": step_rel(tout["logits"], rout["logits"], scale),
               "ref_vs_nudged_ref": step_rel(pout["logits"], rout["logits"],
                                             scale),
               "first_token_equal": bool((tout["tokens"][:, 0]
                                          == rout["tokens"][:, 0]).all()),
               "tokens_equal": bool((tout["tokens"] == rout["tokens"]).all())}
        print(json.dumps(row), flush=True)
        out.append(row)
    print(json.dumps({"arch": args.arch, "layers": args.layers,
                      "backend": args.backend, "leaf": args.leaf,
                      "share": args.share, "runs": out}))


if __name__ == "__main__":
    main()
