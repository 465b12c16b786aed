#!/usr/bin/env python3
"""The ideal serve of two trees of the port, in turns on one card.

  python3 tools/serve_ab.py --parent build/parent [--rounds 4]

``--parent`` is an unpacked earlier tree of the repo (``git archive``
under the gitignored ``build/``).  The current tree trains a small
CASE_A emulator with its quickstart (the weights only need to be the
same for both trees); each tree serves once unread (it builds its
kernels there); then each round runs one process a tree in the order
parent, current, current, parent, and each process serves gemma3-1b at
full width, depth 2, batch 4, prompt 32, 8 tokens, at the ideal corner
on the emulator fast path, twice through the serve CLI: the process's
first serve (cold) and the same serve again (warm).  Prints every
reading of the CLI's prefill and decode lines and each tree's medians,
beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# one process, two serves: the first (cold) and the same again (warm)
TWICE = ("import sys; from repro_torch.launch import serve; "
         "serve.main(sys.argv[1:]); serve.main(sys.argv[1:])")
SERVE = ["-c", TWICE, "--arch", "gemma3-1b",
         "--layers", "2", "--batch", "4", "--prompt-len", "32", "--gen", "8",
         "--seed", "0", "--analog-backend", "emulator"]


def run(tree: Path, args, timeout=900) -> str:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    out = subprocess.run([sys.executable, *args], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        sys.exit(f"serve_ab: {tree}: {' '.join(args)} failed:\n"
                 f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.stdout


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    parent = args.parent.resolve()
    if not (parent / "src" / "repro_torch" / "launch" / "serve.py").is_file():
        sys.exit(f"serve_ab: no port under {parent}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    npz = ROOT / "build" / "serve_ab_emulator.npz"
    npz.parent.mkdir(exist_ok=True)
    run(ROOT, ["-m", "repro_torch.launch.quickstart", "--n-train", "4096",
               "--n-test", "512", "--epochs", "2", "--save-npz", str(npz)])
    trees = {"parent": parent, "current": ROOT}
    for tree in trees.values():
        run(tree, SERVE + ["--emulator-params", str(npz)])
    got = {k: {m: [] for m in ("cold prefill", "cold decode", "warm prefill",
                               "warm decode")} for k in trees}
    for r in range(args.rounds):
        for name in ("parent", "current", "current", "parent"):
            text = run(trees[name], SERVE + ["--emulator-params", str(npz)])
            pre = [float(v) for v in
                   re.findall(r"prefill \d+x\d+: ([\d.]+) ms", text)]
            dec = [float(v) for v in
                   re.findall(r"decode\s+\d+ steps: ([\d.]+) ms", text)]
            for i, state in enumerate(("cold", "warm")):
                got[name][f"{state} prefill"].append(pre[i])
                got[name][f"{state} decode"].append(dec[i])
            print(f"[serve_ab] round {r} {name}: prefill 4x32 cold {pre[0]:.1f} "
                  f"/ warm {pre[1]:.1f} ms, decode 7 steps cold {dec[0]:.1f} / "
                  f"warm {dec[1]:.1f} ms [{card}]", flush=True)
    for name, v in got.items():
        print(f"[serve_ab] {name} medians over {args.rounds * 2} processes: "
              + ", ".join(f"{k} {statistics.median(x):.1f} ms"
                          for k, x in v.items()) + f" [{card}]", flush=True)

if __name__ == "__main__":
    main()
