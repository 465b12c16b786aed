"""The rank side of ``tests/test_torch_sharding.py``: every mesh contract
of the tensor-parallel analog plane in one world of ranks over gloo on
the CPU.  Imports torch and the port only (each rank is a spawned
process; the test compares what rank 0 returns with the JAX package).

``contracts(rank, world, device, payload)`` builds the (1, 4), (2, 2) and
(4, 1) meshes over the one world and returns, per rank, a dict of numpy
arrays and figures."""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import AnalogConfig
from repro_torch.configs.rram_ps32 import CASE_A
from repro_torch.core.analog import AnalogExecutor
from repro_torch.core.deployment import load_deployment, save_deployment
from repro_torch.parallel.sharding import (lattice_window, mesh_coords,
                                           mesh_shape, serve_mesh)

MESHES = ((1, 4), (2, 2), (4, 1))
# (case, K, N, B, forced scheme): col NB=1 NO=8; row NB=4 NO=5;
# neither NB=3 NO=5 (the reference's multi-device cases)
CASES = (("col", 70, 8, 6, "auto"), ("row", 1024, 5, 6, "row"),
         ("none", 768, 5, 6, "auto"))
SWAP_AGE = 2.592e6


def _np(t):
    return t.detach().cpu().numpy()


def contracts(rank, world, device, payload):
    data = np.load(payload["npz"])
    params = {k[3:]: torch.from_numpy(data[k]) for k in data.files
              if k.startswith("ep:")}
    params2 = {k[4:]: torch.from_numpy(data[k]) for k in data.files
               if k.startswith("ep2:")}

    def mk(backend="emulator", **kw):
        if backend == "emulator":
            kw.setdefault("emulator_params", params)
        return AnalogExecutor(AnalogConfig(backend=backend), geom=CASE_A,
                              **kw)

    def xw(case):
        return (torch.from_numpy(data[f"{case}:x"]),
                torch.from_numpy(data[f"{case}:w"]))

    meshes = {m: serve_mesh(*m, device=device) for m in MESHES}
    out = {"coords": {m: mesh_coords(mesh) for m, mesh in meshes.items()},
           "shapes": {m: mesh_shape(mesh) for m, mesh in meshes.items()}}

    # -- bit-identity: every case on every mesh against the replicated path
    for case, _, _, _, scheme in CASES:
        x, w = xw(case)
        for backend in ("emulator", "analytic") if case == "col" else (
                "emulator",):
            rep = mk(backend)
            out[f"{case}:{backend}:rep"] = _np(rep.matmul(x, w, "t"))
            out[f"{case}:{backend}:rep:bytes"] = rep.cache_bytes()
            for m, mesh in meshes.items():
                ex = mk(backend, mesh=mesh, shard_scheme=scheme)
                out[f"{case}:{backend}:{m}:scheme"] = ex._scheme_for(
                    *{"col": (1, 8), "row": (4, 5), "none": (3, 5)}[case])
                out[f"{case}:{backend}:{m}"] = _np(ex.matmul(x, w, "t"))
                out[f"{case}:{backend}:{m}:bytes"] = ex.cache_bytes()
                out[f"{case}:{backend}:{m}:plan"] = tuple(
                    ex._plan_for(w, "t").g_feat.shape[:2])

    # -- build-once: the swap sequence sharded and unsharded
    x, w = xw("col")
    for label, ex in (("rep", mk()), ("2,2", mk(mesh=meshes[(2, 2)]))):
        ys = [_np(ex.matmul(x, w, "t"))]
        ex.deploy(scenario="stressed", key=1)
        ys.append(_np(ex.matmul(x, w, "t")))
        ex.deploy(age=SWAP_AGE)
        ys.append(_np(ex.matmul(x, w, "t")))
        ex.deploy(remap=True)
        ys.append(_np(ex.matmul(x, w, "t")))
        ex.deploy(params=params2)
        ys.append(_np(ex.matmul(x, w, "t")))
        out[f"swaps:{label}"] = ys
        out[f"swaps:{label}:bytes"] = ex.cache_bytes()
        out[f"builds:{label}"] = {k: dict(v) for k, v in ex.builds.items()}

    # -- re-shard on load: saved under (2, 2), served under (1, 4)
    ex1 = mk(mesh=meshes[(2, 2)])
    ex1.deploy(scenario="stressed", remap=True, key=1)
    st = ex1.state_for("t", w)
    ex1.deploy(states={"t": st})                   # pin the read-cycle key
    out["reshard:y1"] = _np(ex1.matmul(x, w, "t"))
    full = ex1.gather_states({"t": st})
    path = os.path.join(payload["tmp"], "dep.npz")
    if rank == 0:
        save_deployment(path, full, ex1.deployment)
    dist.barrier()
    ex2 = mk(mesh=meshes[(1, 4)])
    states, dep = load_deployment(path, "cpu", executor=ex2)
    ex2.deploy(scenario=dep.scenario, key=dep.key, remap=dep.remap,
               states=dep.states)
    st2 = ex2.state_for("t", w)
    _, t = mesh_coords(meshes[(1, 4)])
    win = lattice_window(1, 8, 4, "col", t)
    out["reshard:lattice"] = st2.window
    out["reshard:gf_is_window"] = bool(torch.equal(st2.gf,
                                                   full["t"].gf[win]))
    out["reshard:y2"] = _np(ex2.matmul(x, w, "t"))

    # -- refresh_states on a (1, 4) mesh: the engine's tokens stay
    from repro_torch.launch.batching import ContinuousBatchEngine
    from repro_torch.launch.serve import ServeSession
    prompts = [np.asarray(p) for p in payload["prompts"]]

    def engine(mesh):
        ex = AnalogExecutor(AnalogConfig(backend="analytic",
                                         layers=("mlp",)), geom=CASE_A,
                            mesh=mesh)
        sess = ServeSession("gemma3-1b", reduced=True, reduced_layers=2,
                            batch=1, prompt_len=len(prompts[0]),
                            gen=payload["gen"], seed=0, executor=ex,
                            device="cpu")
        return ex, ContinuousBatchEngine(sess, max_slots=2,
                                         max_len=len(prompts[0])
                                         + payload["gen"])

    _, eng0 = engine(None)
    out["engine:rep"] = [np.asarray(t) for t in eng0.run(
        prompts, max_new=payload["gen"])]
    ex, eng = engine(meshes[(1, 4)])
    out["engine:before"] = [np.asarray(t) for t in eng.run(
        prompts, max_new=payload["gen"])]
    full = ex.gather_states(eng._st())
    eng.refresh_states(states=full)
    out["engine:windows"] = sorted(
        (k, tuple(st.gf.shape[:2]), tuple(full[k].gf.shape[:2]))
        for k, st in eng._st().items())
    out["engine:after"] = [np.asarray(t) for t in eng.run(
        prompts, max_new=payload["gen"])]
    return out
