#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX or of the JAX package.  Phases (any failure exits non-zero):

  0. the card's name and power limit (nvidia-smi), torch and CUDA versions
  1. build every kernel from ``src/repro_torch`` (one nvcc per source, in
     parallel): B1 (unified evaluator), B2 (per-block network), B3 (grid
     network), B4 (crossbar MAC), B5 (flash attention), B6 (linear scan);
     ptxas registers / shared memory / spills (B1's kernel per mode and
     geometry and B3's per geometry on lines of their own, beside their
     dynamic shared memory; B2's beside B3's, and the thread blocks of
     B2 the card keeps resident, which B2's tile rule spreads N over);
     the tensor-core
     instructions (HMMA, HGMMA) in each library's SASS, which B4 and B5
     must have
  2. the emulator kernels against their plain PyTorch versions on the
     card, fp32 with TF32 off, at small shapes (ragged tiles, CASE_A and
     CASE_B, plain and conditioned periph widths; B1 in both modes, given
     the plan's g_norm, which its kernel folds into the per-plan
     precompute itself, with passes of rows cut short and one row a tile;
     B3 likewise: M = R + 1 and one row a tile; B2 with passes of one
     block, tiles that are not whole passes, P = 0, 2, 15 and 40) and at
     the full-width gemma3-1b MLP shapes; outputs compared at rtol 1e-4 /
     atol 1e-5; B1's persistent walk (``b1_walk_check``): lattices with
     fewer items than the card's resident thread blocks and far more,
     both modes and geometries, ragged M, two row tiles, against the plain
     version and bit for bit against a launch of one item a thread block
  3. the emulator lifecycle at the paper's sizes through the port's
     quickstart: label the Table 1 dataset (50,000 + 5,000 CASE_A blocks)
     with the circuit solver, train a Conv4Xbar on it (B2 evaluates the
     test set), save it; then the serving CLI on gemma3-1b at full width,
     depth cut to 2 layers, MLP projections on that trained emulator (B1,
     which must run without a host-side ``blocklast_precompute``); plus
     the analog matmul on the card against the port's CPU path
  4. B1's times at full-width ``mlp.up`` and ``mlp.down`` (CUDA events)
     beside the least time the card could take; B1's bf16 mode driven
     through the dispatcher at the same shapes, held against its plain
     version (rtol 1e-4 / atol 1e-5; its max abs error, by design 0, is
     printed) and against the fp32 mode (atol 5e-2), timed, and failed if
     its call builds the per-plan precompute on the host
  5. the paper's headline: time per CASE_A block for the circuit solver,
     the analytic model, the plain network and B2, at 2,048 and 65,536
     blocks; B2's kernel alone (weights packed once) and its whole call
     (the host's weight pack, checks, launch), in turns
  6. the executor's slow path: the reference bench protocol (16 x 512 @
     512 x 32, calibrated) per backend (circuit, analytic, emulator slow
     path = B3, emulator fast path = B1); full-width ``mlp.up`` through
     B3 against B1 at rtol 2e-4 / atol 1e-5; a conditioned net given
     scenario features through B2; B3's kernel alone (weights packed
     once) and its whole call, in turns, each with its share of the bound
  7. serving under a device corner (``repro_torch.nonideal``): gemma3-1b
     at full width, depth 2, batch 4, prompt 32, 8 tokens, through the
     serve CLI: (a) the phase-3 net under ``stressed`` with
     ``--fault-remap``; (b) a scenario-conditioned CASE_A net (P = 15)
     trained here by ``train_conditioned_emulator`` under a tiled corner
     (each tile of ``mlp.up``/``mlp.gate``'s lattice its own prog and read
     sigma, so B1 takes a per-block fc0 shift), with ``--state-save``,
     then again with ``--state-load`` (tokens equal, logits bit-equal);
     B1's launches per run; each run's full-width ``mlp.up`` state through
     B1 against its plain version, one read draw given to both; the
     conditioned net at the ideal corner bit-equal to no shift; the slow
     path (B3 for the plain net, B2 at P = 15 for the conditioned one)
     against the fast path under ``stressed`` (rtol 2e-4 / atol 1e-5, one
     read draw); prefill / decode ms beside the ideal serve, each tag's
     host ms to materialize its device state and the remap's share, the
     remap's instant damage, the ms the per-call read-noise redraw adds
     to a decode step, the conditioned net's label / train s and test MSE
  8. the kernels' own entry points, each launched through its ``ops``
     function at full model widths and at a ragged shape, fp32 and bf16:
     B4 ``xbar_mac`` (gemma3-1b's ``mlp.up``/``mlp.down`` as one crossbar
     MAC), B5 ``flash_attention`` (gemma3-1b's global and local layers,
     recurrentgemma-2b's local layers), B6 ``linear_scan`` (falcon-mamba-
     7b's selective-scan state, recurrentgemma-2b's RG-LRU, and ragged
     shapes with h0, one of an odd row pitch, D = 1001); B4 and B5 held
     against their plain versions (fp32 rtol 1e-4 / atol 1e-5, bf16 rtol
     1e-2 / atol 1e-2), B6 bit for bit (``torch.equal``); each timed
     beside its bound and, where one PyTorch call computes the same
     function, that call (``library_ms``, timed in turns with the kernel,
     the median of 7 event pairs each) and the ratio to it; B4's and B5's
     fp32 rows, which run as 3xTF32, carry a bound at three TF32 passes
     beside the one at fp32's CUDA-core rate; B6's rows carry, timed in
     turns, the kernel alone (on b0 folded once), the call (the h0 fold
     included) and ``torch.add(a, b, out=h)`` (``copy_ms``: what the card
     achieves for the same traffic, no library call for the scan)
  9. the recurrent families through the serve CLI at full width, batch
     4, 8 tokens: recurrentgemma-2b cut to one (R, R, L) period, prompt
     32, its MLPs on the phase-3 net (B1); falcon-mamba-7b cut to 2
     layers, prompt 512, digital.  B6 runs each prefill recurrence (and,
     with an executor, the session's one-token site discovery); B1 and
     B6 launches counted per serve; B6's first call at the prompt's
     length, recorded on the path, held bit for bit against the plain
     version and timed beside its bytes bound and its share of prefill;
     on recurrentgemma B1's first prefill call at each MLP shape
     (gate/up 2560 -> 7680, down 7680 -> 2560), recorded on the path,
     held against the plain version (rtol 1e-4, atol 1e-5) and timed
     beside its bound;
     prefill ms, decode ms a step, peak memory; then, digital, fp32, TF32
     off, prefill + 3 decode steps against one forward over the same
     tokens (rtol 1e-3, atol 1e-3 of the logits' scale)
 10. the serving plane (``launch.batching``, ``obs``), telemetry on:
     (a) gemma3-1b at full width, depth 2, its MLPs on the phase-3 net
     (6 sites, B1 fp32), through an 8-slot ``ContinuousBatchEngine``
     (max_len 96, pages of 16): 16 requests, prompts of 16-64 tokens
     drawn from the seed, 16 new tokens each, submitted through the
     ``AsyncBatchServer`` in two waves of 8 (the second after 4 ticks),
     each request's tokens against a batch-1 ``ServeSession.generate``
     on the same params and states; one mid-run tick's logits against
     its rows decoded one at a time (the gap printed); the same requests
     through a digital engine on the same params, against batch-1
     sessions and with its tick's gap, printed; B1's first tick
     call at each MLP shape (M = 8) held against its plain version; (b)
     4 requests through a packed-prefill engine against packed-solo
     runs; (c) a ``RecompileSentinel`` over (a); (d) (a)'s telemetry
     snapshot and a ``ServeSession``'s through ``tools/
     check_telemetry.py`` (``serve`` and ``session`` profiles); (e) the
     same requests with telemetry off and on, in turns: the same tokens,
     each run's tokens/s; (f) falcon-mamba-7b (digital, depth 2) through
     a 4-slot engine, 8 requests, prompts of 64-256, 8 new tokens: bulk
     (B6 at every prefill, its first call held bit for bit) against
     batch-1 sessions, and packed (slot reuse, rows zeroed at admission)
     against packed-solo runs (against the sessions printed); (g) the
     first wave through a fresh engine with the tuner at its default
     setting (``REPRO_AUTOTUNE`` unset, a cache file of its own), sweeping
     B1's tile at each new shape, then with the tiles in memory: tokens
     equal to (a), each run's tokens/s, median tick, sweeps and their s.
     B1's tick calls are also launched one row at a time (bit-equality
     printed).  Prints requests/s, generated tokens/s, TTFT and latency
     p50/p90 (the snapshot's histogram buckets and the requests' own
     clocks), the median tick, the mean occupancy, B1's and B6's
     launches on the engine runs, peak memory; a JSON ``serving`` line
 11. lifetime management and the fleet twin (``nonideal.lifetime``,
     ``nonideal.sweep``, ``fleet``): (a) the drift walk (t0, 1h, 1d, 1mo)
     of gemma3-1b's full-width ``mlp.up`` (1152 x 6912, random) on the
     phase-3 net under bench_lifetime's per-tile corner (prog sigma 0.02
     -> 0.08 across output groups, stuck-off 0.04, drift nu 0.05),
     unmitigated, with remap and recalibration, and mitigated (remap,
     recalibration, the noise-aware retrainer, n 4096, 30 epochs): per
     checkpoint the error against the
     ideal device, calib_n, retrained, the fine-tune's seconds, the host
     ms to materialize the state and the remap's share, B1's launches;
     one plan build per tag; (b) at (64, 8, 4), calib_n 32, the field
     retrainer on the phase-3 net beside the conditioned field calibrator
     on phase 7's conditioned net, which must retrain at deployment only;
     (c) ``ScenarioSweep`` on ``mlp.up``: 8 draws at 5 levels of prog
     sigma, B = 4, one build, the mean error non-decreasing in sigma, the
     stacked draws bit-equal to one draw at a time, B1's stacked call
     held against its plain version draw by draw; (d) bench_fleet's
     campaign, 10^5 devices of (128, 16, 8), chunk 256, its BASE corner
     and SLO rule, on the conditioned net, telemetry on: the SLO floor on
     512 devices, ``MaintenancePlanner.plan`` (surrogate on 256 probed
     devices), ``simulate_policy`` for never / always / the plan; one
     chunk-step build (``RecompileSentinel``), every error finite, the
     snapshot through ``tools/check_telemetry.py``'s fleet profile, 1,000
     devices bit-equal at chunk 256 and 64, two B1 launches a chunk; the
     planner against both baselines at every checkpoint, seconds per full
     evaluation, devices/s, one chunk's card and host ms beside its B1
     calls and its draws, peak memory; each chunk B1 call held against
     its plain version and one device launched alone against its stacked
     blocks (bit for bit); (e) ``ServeSession.calibrate`` on gemma3-1b at
     full width, depth 2, 6 sites on the phase-3 net under ``stressed``:
     cold at deployment, warm at one month (timed), then served twice on
     the same states (batch 4, prompt 32, 8 tokens): tokens equal, prefill
     / decode ms; a JSON ``lifetime`` line
 12. training (``runtime.steps``, ``optim``, ``checkpoint``,
     ``runtime.trainer``), random weights at full widths, lr 1e-3 after a
     2-step warmup: (a) gemma3-1b at full depth (26 layers), digital,
     bf16, remat "full", B = 4, S = 256, 10 steps: the loss finite and its
     last 3 steps' mean below its first 3; step ms, tokens/s, the
     model-FLOPs share (6 N tokens / step / 989 TFLOP/s), one more step
     split into gradient and AdamW, peak memory; (b) gemma3-1b cut to one
     stacked period (6 layers, all under remat), MLPs on the phase-3 net,
     fp32, B = 4, S = 32, 3 steps: B1 launched 18 sites x (forward +
     recompute) a step, its first training call held against the plain
     version (rtol 1e-4 / atol 1e-5), the straight-through products
     ``ct @ w.T`` / ``x.T @ ct`` bit for bit, each step's ``mlp.up`` plan
     the one of the weights the step started from (the optimizer updates
     them in place) and its loss that of a fresh executor; (c)
     recurrentgemma-2b cut to (R, R, L), fp32, B = 2, S = 128, 3 steps:
     B6 launched 2 layers x (forward + recompute) and once a layer in
     backward a step; one layer's backward launch bit-equal to the plain
     version on the reversed inputs, its da / db against autograd of the
     plain loop (rtol 1e-4 / atol 1e-5), the backward through the engine
     and its Function's body, its flips and the launch alone timed in
     turns beside the bytes bound; (d) the
     ``Trainer`` on gemma3-1b at depth 2, fp32, a checkpoint every 2
     steps, a ``SimulatedFailure`` at step 3: one restart, steps 2 run
     twice, the end at step 6; the 4.3 GB state's device-to-host, write
     and restore seconds; ``grad_accum=2`` against 1 on a mask of equal
     counts (grads within rtol 1e-4 plus 1e-5 of each leaf's max), and
     grad_accum=2's train step against a step from the same state on the
     two microbatches' grads averaged by hand (the new params within rtol
     1e-4); a JSON ``training`` line
 13. the dense and MoE decoder families through the serve CLI at full
     width on the phase-3 net (``DEC_SERVES``): qwen1.5-110b and
     command-r-plus-104b cut to 1 layer, deepseek-coder-33b to 2 (batch
     2, prompt 16, 4 tokens, MLPs analog), phi3.5-moe-42b-a6.6b to 2 and
     llama4-scout-17b-a16e to one (C, C, C, G) period (batch 4, prompt
     32, 8 tokens, attention projections analog: the experts never call
     dense()).  Per serve: B1's launches (one a site a forward), the
     first decode call (M = batch) of each site shape held against the
     plain version (in column chunks) at rtol 1e-4 / atol 1e-5, it and
     the first prefill call timed beside their bounds, prefill ms,
     decode ms a step, B1's share of each, the executor's plan and cache
     bytes, peak memory, the MoE archs' share of routed assignments
     dropped at prefill; then, digitally in fp32, prefill + 3 decode
     steps against one forward (an MoE arch at a capacity that holds
     every assignment), rtol 1e-3, atol 1e-3 of the logits' scale; a
     JSON ``decoders`` line
 14. the frontend archs through the serve CLI at full width on the
     phase-3 net (``FRONT_SERVES``): internvl2-76b cut to 1 layer, batch
     1, prompt 272 (256 image positions, then 16 text tokens), 8 tokens,
     its vision projection and attention analog; seamless-m4t-large-v2 at
     its published depth (24 encoder + 24 decoder layers), batch 2, 32
     frames and a 32-token prompt, 8 tokens, its MLPs and attention (the
     encoder's and the cross attention's too) analog.  Per serve: the
     served widths against the published ones; B1's launches against the
     count the sites imply (the vision projection, the encoder's sites
     and the cross k / v launch at prefill alone, every other site once a
     forward); every decode call (M = batch) held against the plain
     version (in column chunks) at rtol 1e-4 / atol 1e-5; the first call
     at each (M, site shape) timed beside its bound; prefill ms, decode ms
     a step, B1's share of each, the executor's plan and cache bytes,
     peak memory; then, digitally in fp32, prefill + 3 decode steps
     against one forward, the same image embeddings or frames given to
     both, rtol 1e-3, atol 1e-3 of the logits' scale; a JSON
     ``frontends`` line
 15. a JSON ``kernels`` line, then the card line, then the result line.
     The B2, B3 and B6 rows' ``ms`` is the kernel alone (B2, B3 on weights
     packed once); their ``call_ms`` is the whole call a user makes, which
     also packs the weights on the host (B2, B3) or folds h0 (B6).  Every
     other row's ``ms`` is the call.  B1's and B6's records carry their
     launches on phase 9's serves (``model_launches``) and their path
     calls (``model_path``: B1's two MLP shapes; B6's per serve, with its
     times and memory), and phase 10's engine runs (``engine_launches``,
     also counted in ``launches``; ``engine_path``: B1's tick calls, B6's
     first prefill call), and phase 11's (``lifetime_launches`` per part,
     also counted in ``launches``; ``lifetime_path``: the sweep's stacked
     call and a fleet chunk's two calls), and phase 12's
     (``training_launches``: B1's in the train steps, also counted in
     ``launches``, and in the fresh executors' check forwards, not counted
     there; B6's in its Function's forward and backward, both counted;
     ``training_path``: B1's first training call;
     ``training_backward``: B6's backward call), and phase 13's
     (``decoder_launches`` per arch, also counted in ``launches``;
     ``decoder_path``: B1's prefill and decode calls at each site shape),
     and phase 14's (``frontend_launches`` per arch, also counted in
     ``launches``; ``frontend_path``: B1's first call at each (M, site
     shape), with its count and the largest error of its decode calls),
     and phase 16's (``mesh_launches`` per run, summed over its ranks and
     counted in ``launches``; ``mesh_path``: each rank's figures;
     ``tuner``: phase 16 (d), its launches not counted in ``launches``),
     and phase 17's (``train_mesh_launches``, B1's and B6's per run,
     summed over its ranks and counted in ``launches``).
 16. the tensor-parallel analog plane and the autotuner (run before the
     kernels line, which carries their launches).  Phases 1-15 run with
     ``REPRO_AUTOTUNE=0`` (set at the start, with the tuner's cache file
     under the gitignored ``build/``), so their launch counts and times
     stay comparable with earlier runs.  (a) gemma3-1b at full width,
     depth 2, batch 4, prompt 32, 8 tokens, on the phase-3 net through
     the serve CLI with ``--mesh 1,2``, ``2,1`` and ``2,2`` (every rank on
     the one card, over gloo; ``mlp.up``/``mlp.gate`` (NB, NO) = (5,
     6912) and ``mlp.down`` (27, 1152) take the col scheme at tp = 2):
     tokens equal to phase 3's unsharded serve and logits bit-equal; per
     rank B1's launches (48), its states' ``gf`` bytes (half the whole
     lattice's at tp = 2), every byte its executor caches (1/tp of phase
     3's executor's), its peak allocation, prefill ms, decode ms a step,
     and, from a
     second generate timed with synchronizations (``--mesh-times``), B1's
     ms a call beside the collectives'.  (b) the row scheme forced at
     phi3.5-moe's q projection (K = N = 4096: (NB, NO) = (16, 4096)) at
     M = 2 and 32 on (1, 2) and (1, 4) meshes: within rtol 1e-5 / atol
     2e-6 of the unsharded executor, each rank's B1 calls held against
     the plain version (rtol 1e-4 / atol 1e-5).  (c) a ``stressed``,
     fault-remapped deployment saved under (1, 2), served unsharded from
     the file, and loaded under (2, 2): tokens equal, logits bit-equal
     to the unsharded serve on both meshes.  (d) the tuner with
     ``REPRO_AUTOTUNE=1`` and a fresh cache file: B1's swept row tile at
     ``mlp.up`` M = 4 and 128, each candidate's ms beside phase 4's
     bound, the second resolution a ``memory`` hit and a fresh process's
     a ``disk`` hit, and B1 bit-equal (``torch.equal``) under every
     candidate tile.
 17. training on a mesh (run after phase 16, before the kernels line),
     every rank on the one card over gloo, random weights at full
     published widths (``MT*``): (a) gemma3-1b at depth 2, bf16 compute,
     remat "full", 4 x 256, 3 steps unsharded and on (2, 1), (1, 2) and
     (2, 2) meshes (the train step; on (2, 2) the ``Trainer``, its
     checkpoint every 2 steps feeding (b)): each rank's loss within 1e-2 and
     clip norm within 5% of the unsharded run's at every step; its bytes
     of params + m + v beside the unsharded state's, every leaf whose spec
     divides every axis held at 1/(dp*tp) (gated); step ms, and the
     synchronized ms of its collectives a step; peak memory.  (b) the (2,
     2) run's step-2 checkpoint restored on (4, 1) and in one process:
     step 2's loss within 1e-2 of the (2, 2) run's.  (c) phase 12 (b)'s
     model (one period, MLPs on the phase-3 net, fp32) and
     recurrentgemma-2b cut to one period (fp32), one step each on (1, 2):
     the recurrent step's loss within rtol 1e-4 of the unsharded step's;
     the analog step's within rtol 1e-2 (``MT_EMU_RTOL``: the split
     digital products' last bits, which the emulated MLPs amplify), and
     within rtol 1e-5 with every digital product whole on each rank (the
     analog plane alone on the mesh); B1's and B6's launches a rank equal
     to the unsharded step's, and each rank's first and last B1 call (by
     column chunks) and B6 call against the plain versions (rtol 1e-4 /
     atol 1e-5).  The ranks of (a)'s (2, 1) and (1, 2), (c) and (d)'s
     (1, 2) share one world of 2; (a)'s (2, 2), (b) and (d)'s (1, 4) one
     of 4.  (d) ``sharded_flash_decode``
     at a gemma3-1b global layer's cache (S_max 32,768, fp32) on (1, 2)
     and (1, 4), each rank against ``decode_attention`` on the whole cache
     (rtol 1e-4 / atol 1e-5), both timed.  A JSON ``train_mesh`` line.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-5
BF16_RTOL, BF16_ATOL = 1e-2, 1e-2     # bf16 outputs: about one bf16 ulp
B1_BF16_ATOL = 5e-2          # B1 bf16 mode vs fp32 mode (ROADMAP B1 gate)
SLOW_RTOL, SLOW_ATOL = 2e-4, 1e-5     # slow path vs fast path (reference's)
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3
FP32_FLOP_S = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOP_S = 989e12         # H100 SXM dense bf16 on the tensor cores
TF32X3_FLOP_S = 495e12 / 3   # fp32 as three TF32 tensor-core products
GEMMA = dict(d_model=1152, d_ff=6912)
# the emulator's training budget on the card: 50 epochs on the Table 1
# set, lr 2e-3 halved at the quickstart's points stretched to 50 epochs
# (about 80 s on an H100 with the labelling; the paper trains 2,000
# epochs, see PERF.md)
TRAIN = dict(n_train=50_000, n_test=5_000, epochs=50, lr_halve_at=(31, 44))
# B3's phase-2 cases: (label, geometry name, P, M, NB, NO, block_m); R =
# D*W rows a pass (8 under CASE_A, 16 under CASE_B), so M = R + 1 ends on a
# pass of one row, and block_m = 1 gives every tile a single row
B3_CASES = [
    ("A P=2 M%bm", "A", 2, 5, 3, 7, 2), ("A no periph", "A", 0, 3, 2, 4, None),
    ("B P=15 M%bm", "B", 15, 5, 2, 5, 3), ("B P=2", "B", 2, 130, 1, 3, None),
    ("A P=0 M=R+1", "A", 0, 9, 2, 3, None), ("B P=2 M=R+1", "B", 2, 17, 2, 2, None),
    ("A P=15 M=13 bm=1", "A", 15, 13, 2, 2, 1),
    ("B P=0 M=13 bm=1", "B", 0, 13, 1, 3, 1)]
# B2's phase-2 cases: (label, geometry name, P, N, block_n); R = D*W blocks
# a pass (8 under CASE_A, 16 under CASE_B): N = 1, 9 and 17 end on a pass
# of one block; block_n 3, 7 and 32 and the default rule's tiles (N = 5,000
# and 65,536) are not whole passes; N = 3,001 with block_n 3 launches more
# thread blocks than the card keeps resident; P = 40 reads periph features
# past one warp's 32; CASE_A P = 15 at N = 5,000 is the shape of phase 7's
# conditioned-net evaluations (its test set)
B2_CASES = [
    ("A P=2 N%bn", "A", 2, 1001, 32), ("A no periph", "A", 0, 64, None),
    ("A P=15", "A", 15, 77, 8), ("B P=2 N%bn", "B", 2, 515, 16),
    ("B P=15 (>48 KB smem)", "B", 15, 300, None),
    ("A P=2 N=1", "A", 2, 1, None), ("A P=0 N=9", "A", 0, 9, None),
    ("B P=15 N=17", "B", 15, 17, None), ("A P=15 N=37 bn=3", "A", 15, 37, 3),
    ("B P=2 N=100 bn=7", "B", 2, 100, 7), ("A P=2 N=3001 bn=3", "A", 2, 3001, 3),
    ("A P=40 N=50", "A", 40, 50, None), ("A P=2 N=5000", "A", 2, 5000, None),
    ("B P=15 N=5000", "B", 15, 5000, None), ("A P=15 N=5000", "A", 15, 5000, None),
    ("A P=2 N=65536", "A", 2, 65536, None)]
# B1's persistent walk: (label, geometry name, P, NB, NO, M, block_m, shift);
# the first two lattices hold fewer (block, row tile) items than the card's
# resident thread blocks (264 under CASE_A, 132 under CASE_B), so each
# thread block takes one item; the others far more, drawn from the
# launch's ticket, with ragged M and row tiles of 4 and 8 below M
B1_WALK_CASES = [
    ("A below the slots", "A", 0, 3, 40, 5, None, None),
    ("B below the slots", "B", 15, 2, 30, 9, None, "flat"),
    ("A far above M=13 bm=4", "A", 15, 16, 4096, 13, 4, "block"),
    ("A far above M=37", "A", 0, 48, 1000, 37, None, None),
    ("B far above M=20 bm=8", "B", 0, 16, 1024, 20, 8, None),
    ("B far above M=3", "B", 15, 10, 2000, 3, None, "block")]
# B2's kernel per geometry, as ptxas names its template instances
B2_TEMPLATES = {"CASE_A": "block_warp_kernelILi4ELi2ELi1E",
                "CASE_B": "block_warp_kernelILi2ELi8ELi4E"}
# B1's kernel per geometry and mode, as ptxas names its template instances
B1_TEMPLATES = {"CASE_A": "fused_kernelILi4ELi2ELi1E",
                "CASE_B": "fused_kernelILi2ELi8ELi4E"}
B1_MODES = {"fp32": "Lb0E", "bf16": "Lb1E"}
# B3's kernel per geometry, as ptxas names its template instances
B3_TEMPLATES = {"CASE_A": "grid_warp_kernelILi4ELi2ELi1E",
                "CASE_B": "grid_warp_kernelILi2ELi8ELi4E"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rand_params(geom, n_periph, seed, dev):
    """Conv4Xbar params from ``seed`` on ``dev``, with nonzero biases so
    that every bias path is exercised."""
    import torch
    from repro_torch.core import conv4xbar
    from repro_torch.models.common import init_params
    p = init_params(seed, conv4xbar.conv4xbar_schema(geom, n_periph), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(11 + seed)
    for k in p:
        if k.endswith("_b"):
            p[k] = 0.1 * torch.randn(p[k].shape, generator=g, device=dev)
    return p


def unified_work(M, NB, NO, D, W, O, flat, shift, bf16=False):
    """(bytes, GEMM operations, other operations) the unified block
    evaluator must move and do for one call: every input read once, the
    output written once; an FMA counts 2, an expm1 (inside CELU) 1, a bias
    starts its accumulator (as ``net_flops`` counts).  The GEMM operations
    are the products of the stage-1 window contraction, the tail stages,
    the W-stage and the FC head (bf16 operands in the bf16 mode).  The
    kernel reads the plan's g_norm and stage 0's weights and computes the
    per-plan precompute once per block (g0's multiply and add, celu0's
    expm1, the y0 product and bias), in both modes; ``bf16``: the y0
    product, whose operands stay fp32 in the bf16 mode, counts with the
    other operations."""
    G, K1, C0, O1 = 32, 2, 16, 8
    nblk = NB * NO
    P = D * W * G
    n_in = 2 * M * NB * D * G * K1                       # u, pos
    n_pre = nblk * P * K1 + 2 * C0 + O1                  # g_norm, w0g, b0, b1
    n_w = (C0 + K1 * C0 * O1 + 32 * 4 + 4 + 32 * 32 + 32 + 64 * 32 + 32
           + flat * 32 + 32 + 32 * 16 + 16 + 16 * O + O)
    n_sh = 0 if shift is None else shift.numel()
    n_out = 2 * M * nblk * O
    nbytes = 4 * (n_in + n_pre + n_w + n_sh + n_out)
    taps = P * K1
    wo = 1 if W <= 2 else W // 2
    gemm = taps * 2 * C0 * O1 + 2 * (
        (P // 4) * 2 * 32 * 4 + (P // 32) * 2 * 32 * 32 + D * wo * 2 * 64 * 32
        + 2 * flat * 32 + 2 * 32 * 16 + 2 * 16 * O)
    # per tap: u*w0v + g0 (FMA), expm1, - celu0; the rail mask's product
    # and two sums; per position: y0 + each rail, the rail difference, two
    # expm1; per rail the tail's expm1s and the optional fc0 shift
    other = taps * (4 * C0 + 3 * O1) + P * 5 * O1 + 2 * (
        (P // 4) * 4 + (P // 32) * 32 + D * wo * 32 + 32
        + (32 if shift is not None else 0) + 16)
    gemm_fold = nblk * P * K1 * C0 * O1 * 2
    other_fold = nblk * (taps * C0 * 3 + P * O1)
    if bf16:
        gemm_fold, other_fold = 0, other_fold + gemm_fold
    return (nbytes, M * nblk * gemm + gemm_fold,
            M * nblk * other + other_fold)


def net_layers(geom, P):
    """(outputs, multiply-adds per output) of each layer of the
    paper-faithful network (B2/B3): stage 0 first, fc2 last."""
    D, H, W, O = geom.tiles, geom.rows, geom.cols, geom.outputs
    wo = 1 if W <= 2 else W // 2
    return [(D * H * W * 16, 2), (D * (H // 2) * W * 8, 32),
            (D * (H // 8) * W * 4, 32), (D * (H // 64) * W * 32, 32),
            (D * wo * 32, 64), (32, D * wo * 32 + P), (16, 32), (O, 16)]


def net_flops(geom, P):
    """fp32 operations of one network evaluation on its own (B2): per
    output element 2 per multiply-add, the bias being the accumulator's
    start, and 1 for CELU's expm1 (every layer but fc2)."""
    layers = net_layers(geom, P)
    (n_out, k_out) = layers[-1]
    return sum(n * (2 * k + 1) for n, k in layers[:-1]) + n_out * 2 * k_out


def net_weight_floats(geom, P):
    D, W, O = geom.tiles, geom.cols, geom.outputs
    flat = D * (1 if W <= 2 else W // 2) * 32
    return (16 * 3 + 2 * 16 * 8 + 8 + 32 * 4 + 4 + 32 * 32 + 32 + 64 * 32 + 32
            + (flat + P) * 32 + 32 + 32 * 16 + 16 + 16 * O + O)


def block_work(geom, N, P):
    """(bytes, operations) of one B2 call on N blocks."""
    feat = 2 * geom.tiles * geom.rows * geom.cols
    nbytes = 4 * (N * (feat + P + geom.outputs) + net_weight_floats(geom, P))
    return nbytes, N * net_flops(geom, P)


def grid_work(geom, M, NB, NO, P):
    """(bytes, operations) of one B3 call: the drive and the shared
    conductances read once, the (M, NB*NO, O) output written once."""
    D, H, W, O = geom.tiles, geom.rows, geom.cols, geom.outputs
    nbytes = 4 * (M * NB * D * H + NB * NO * D * H * W + M * NB * NO * O
                  + net_weight_floats(geom, P))
    # stage 0's conductance term w0g*g + b0 is the same for every row of a
    # block: one FMA per stage-0 output per block; each row then adds
    # w0v*v (one FMA) and takes the expm1, 3 operations where a network
    # on its own spends 2*2 + 1
    n0 = net_layers(geom, P)[0][0]
    per_row = net_flops(geom, P) - n0 * (2 * 2 + 1) + n0 * 3
    return nbytes, M * NB * NO * per_row + NB * NO * n0 * 2


def bound_ms(nbytes, *work):
    """The least time the card could take: the larger of the bytes over
    the memory rate and each (operations, peak rate) pair's time; the
    pairs' units may run at once, so their times do not add."""
    tb = nbytes / HBM_BYTES_S * 1e3
    to = max((ops / peak * 1e3 for ops, peak in work), default=0.0)
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def paired_ms(fns, iters, reps=7, warmup=2):
    """Median time of each of ``fns`` over ``reps`` event pairs of
    ``iters`` calls each, the functions taking turns within a rep: a
    stall of the card or the host weighs on one pair, not on a whole
    reading, and not on one function more than another."""
    import statistics
    import torch
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    pairs = [[] for _ in fns]
    for _ in range(reps):
        for fn, ps in zip(fns, pairs):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            ps.append((a, b))
    torch.cuda.synchronize()
    return [statistics.median(a.elapsed_time(b) / iters for a, b in ps)
            for ps in pairs]


def host_ms(fn, iters, warmup=1):
    """Host clock around calls that end in a synchronize (a whole matmul
    through the executor, host work included)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def compare(label, got, want, rtol=RTOL, atol=ATOL):
    """Hold ``got`` against ``want``; print, fail on disagreement, return
    the max abs error."""
    import torch
    if got.shape != want.shape:
        fail(f"[{label}] shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    mabs = float(err.max()) if err.numel() else 0.0
    rel = float((err / want.abs().clamp_min(1e-30)).max()) if err.numel() else 0.0
    # the largest share of its allowance (atol + rtol * |want|) an element uses
    use = float((err / (atol + rtol * want.abs())).max()) if err.numel() else 0.0
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    print(f"[kernel vs plain] {label}: max_abs={mabs:.3e} max_rel={rel:.3e} "
          f"gate use {use:.2f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"[{label}] disagrees beyond rtol {rtol} / atol {atol}")
    return mabs


def b1_walk_check(dev):
    """B1's persistent thread blocks at ``B1_WALK_CASES``, in both modes:
    the kernel against its plain version (rtol 1e-4 / atol 1e-5) and, bit
    for bit, against the same inputs launched one item a thread block
    (the grid of a lattice below the slots); prints each launch's items,
    thread blocks and items each, and the resident thread blocks per
    geometry and mode.  Returns the max abs error of each mode."""
    import torch
    from repro_torch.configs.rram_ps32 import CASE_A, CASE_B
    from repro_torch.core import conv4xbar
    from repro_torch.kernels.emulator_block import emulator_block as eb
    for gid, name in enumerate(("CASE_A", "CASE_B")):
        for mode, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            print(f"[B1 walk] {name} {mode}: resident thread blocks (the "
                  f"runtime's occupancy x SMs) {eb.unified_slots(gid, dt, dev)}"
                  f"; dynamic shared memory {eb.unified_smem_bytes(gid, dt)} B",
                  flush=True)
    worst = {"fp32": 0.0, "bf16": 0.0}
    for i, (label, gname, P, NB, NO, M, bm, sh) in enumerate(B1_WALK_CASES):
        geom = {"A": CASE_A, "B": CASE_B}[gname]
        aux = conv4xbar.blocklast_weights(rand_params(geom, P, 30 + P, dev), geom)
        g = torch.Generator(device=dev)
        g.manual_seed(400 + i)
        gn = torch.rand((NB, NO, geom.tiles, geom.rows, geom.cols),
                        generator=g, device=dev)
        u = torch.rand((M, NB, geom.tiles, geom.rows), generator=g, device=dev)
        u = torch.where(u < 0.2, torch.zeros_like(u), u)
        pos = ((torch.rand(u.shape, generator=g, device=dev) < 0.5)
               & (u > 0)).float()
        shift = None
        if sh is not None:
            shp = (32,) if sh == "flat" else (NB * NO, 32)
            shift = 0.2 * torch.randn(shp, generator=g, device=dev)
        for mode, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            a = eb.launch_args(aux, gn, u, pos, shift, bm, dt)
            got = eb.launch_unified(a, gn, u, pos, shift)
            one = eb.launch_args(aux, gn, u, pos, shift, bm, dt,
                                 slots=2 ** 31 - 1)
            each = eb.launch_unified(one, gn, u, pos, shift)
            want = eb.emulator_block_unified_plain(aux, gn, u, pos, shift=shift,
                                                   compute_dtype=dt)
            torch.cuda.synchronize()
            tag = (f"B1 walk {mode} {label}: NB={NB} NO={NO} M={M} "
                   f"bm={a['bm']}, {a['items']} items in {a['ctas']} thread "
                   f"blocks")
            worst[mode] = max(worst[mode], compare(tag, got, want))
            eq = torch.equal(got, each)
            print(f"[B1 walk] {tag} vs {one['ctas']} thread blocks of one "
                  f"item: bit-equal {eq}", flush=True)
            if not eq:
                fail(f"[{tag}] differs from one item a thread block")
            if a["ctas"] != min(a["items"], eb.unified_slots(a["geom"], dt, dev)):
                fail(f"[{tag}] is not min(items, resident thread blocks)")
            del got, each, want
    torch.cuda.empty_cache()
    return worst


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"the port's package src/repro_torch is missing next to {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    BF16 = torch.bfloat16
    t_start = time.perf_counter()
    # phases 1-15 resolve B1's row tile to its default, as before the
    # tuner, from a cache file of this run (phase 16 (d) turns it on)
    (ROOT / "build").mkdir(exist_ok=True)
    os.environ["REPRO_AUTOTUNE"] = "0"
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(ROOT / "build" / "chip_smoke_autotune.json")
    Path(os.environ["REPRO_AUTOTUNE_CACHE"]).unlink(missing_ok=True)
    print(f"REPRO_AUTOTUNE={os.environ['REPRO_AUTOTUNE']} "
          f"REPRO_AUTOTUNE_CACHE={os.environ['REPRO_AUTOTUNE_CACHE']}", flush=True)

    # ---- phase 0 --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(card, flush=True)

    from repro_torch.configs.rram_ps32 import CASE_A, CASE_B
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.core import conv4xbar
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.core.crossbar import build_conductance_plan
    from repro_torch.interop import save_emulator_npz
    from repro_torch.kernels import _build
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.emulator_block.ops import emulator_block_unified
    from repro_torch.models.common import init_params

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for src, (lib, log) in built.items():
        print(f"[build] {src.name} -> {lib.name}", flush=True)
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "error")):
                print(f"[build]   {line.strip()}", flush=True)
    b1_src = next(src for src in built if src.name == "emulator_block_unified.cu")
    b1_stats = ptxas_stats(built[b1_src][1])
    for gid, name in enumerate(("CASE_A", "CASE_B")):
        for mode, dt in (("fp32", torch.float32), ("bf16", BF16)):
            stats = [v for k, v in b1_stats.items()
                     if B1_TEMPLATES[name] + B1_MODES[mode] in k]
            print(f"[build] B1 fused_kernel {mode} {name}: "
                  f"{stats[0] if stats else 'no ptxas output (library cached)'}"
                  f"; dynamic shared memory {eb.unified_smem_bytes(gid, dt)} B",
                  flush=True)
    b3_src = next(src for src in built if src.name == "emulator_block.cu")
    b3_stats = ptxas_stats(built[b3_src][1])
    for name, geom in (("CASE_A", CASE_A), ("CASE_B", CASE_B)):
        for kid, templates, smem in (
                ("B2 block_warp_kernel", B2_TEMPLATES,
                 f"{eb.block_smem_bytes(geom, 2)} B at P=2"),
                ("B3 grid_warp_kernel", B3_TEMPLATES,
                 f"{eb.grid_smem_bytes(geom)} B")):
            stats = [v for k, v in b3_stats.items() if templates[name] in k]
            print(f"[build] {kid} {name}: "
                  f"{stats[0] if stats else 'no ptxas output (library cached)'}"
                  f"; dynamic shared memory {smem}", flush=True)
    for geom in (CASE_A, CASE_B):
        for P in (0, 2, 15):
            print(f"[build] B2 dynamic shared memory {geom.name} P={P}: "
                  f"{eb.block_smem_bytes(geom, P)} B; resident thread blocks "
                  f"(the runtime's occupancy x SMs) {eb.block_slots(geom, P, dev)}",
                  flush=True)
    tensor_core_counts(built)
    fa = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    for D in (64, 128, 256):
        print(f"[build] B5 dynamic shared memory D={D}: fp32 "
              f"{fa.smem_bytes(D)} B, bf16 {fa.smem_bytes(D, BF16)} B",
              flush=True)

    # ---- phase 2: kernel vs plain ---------------------------------------
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    nets = {}

    def net(geom, n_periph):
        key = (geom.name, n_periph)
        if key not in nets:
            p = rand_params(geom, n_periph, 7 + n_periph, dev)
            nets[key] = (p, conv4xbar.blocklast_weights(p, geom))
        return nets[key]

    def inputs(geom, K, N, M, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        x = torch.randn((M, K), generator=g, device=dev)
        plan = build_conductance_plan(w, acfg, geom)
        ex = AnalogExecutor(acfg, geom=geom, emulator_params={})
        xs = x.abs().max()
        u = plan.tile_v(ex._drive01(x.abs() / xs), 1.0).contiguous()
        pos = plan.tile_v((x > 0).float(), 1.0).contiguous()
        return plan, u, pos

    cases = [  # (label, geom, n_periph, K, N, M, block_m, shift)
        ("A ideal M%bm", CASE_A, 0, 300, 3, 5, 2, None),
        ("A flat shift", CASE_A, 15, 256, 4, 3, None, "flat"),
        ("A block shift", CASE_A, 15, 200, 5, 6, 4, "block"),
        ("B ideal", CASE_B, 0, 200, 10, 5, 3, None),
        ("B block shift", CASE_B, 15, 130, 12, 4, None, "block"),
        ("mlp.up M=4", CASE_A, 0, GEMMA["d_model"], GEMMA["d_ff"], 4, None, None),
        ("mlp.up M=128", CASE_A, 0, GEMMA["d_model"], GEMMA["d_ff"], 128, None, None),
        ("mlp.down M=4", CASE_A, 0, GEMMA["d_ff"], GEMMA["d_model"], 4, None, None),
        ("mlp.down M=128", CASE_A, 0, GEMMA["d_ff"], GEMMA["d_model"], 128, None, None),
        # B1 passes R = D*W/2 rows (4 under CASE_A, 8 under CASE_B)
        ("A ideal M=9 bm=1", CASE_A, 0, 150, 3, 9, 1, None),
        ("B flat shift M=R+1", CASE_B, 15, 130, 5, 9, None, "flat"),
    ]
    max_abs = {"B1": 0.0, "B1 bf16": 0.0, "B2": 0.0, "B3": 0.0}
    timed = {}
    for i, (label, geom, npf, K, N, M, bm, sh) in enumerate(cases):
        params, aux = net(geom, npf)
        plan, u, pos = inputs(geom, K, N, M, 100 + i)
        gn = plan.g_norm.contiguous()
        shift = None
        if sh is not None:
            f = aux["fcs"][0][0].shape[1]
            g = torch.Generator(device=dev)
            g.manual_seed(200 + i)
            shp = (f,) if sh == "flat" else (plan.n_blocks, f)
            shift = 0.2 * torch.randn(shp, generator=g, device=dev)
        got = eb.emulator_block_unified_cuda(aux, gn, u, pos, shift=shift,
                                             block_m=bm)
        torch.cuda.synchronize()
        want = eb.emulator_block_unified_plain(aux, gn, u, pos, shift=shift)
        torch.cuda.synchronize()
        max_abs["B1"] = max(max_abs["B1"], compare(
            f"B1 {label}: NB={plan.NB} NO={plan.NO} M={M}", got, want))
        if not label.startswith("mlp."):    # bf16 mode: full widths in phase 4
            got = eb.emulator_block_unified_cuda(aux, gn, u, pos, shift=shift,
                                                 block_m=bm, compute_dtype=BF16)
            torch.cuda.synchronize()
            want = eb.emulator_block_unified_plain(aux, gn, u, pos, shift=shift,
                                                   compute_dtype=BF16)
            max_abs["B1 bf16"] = max(max_abs["B1 bf16"], compare(
                f"B1 bf16 mode {label}: NB={plan.NB} NO={plan.NO} M={M}", got,
                want))
        if label.startswith("mlp."):
            timed[(label.split()[0], M)] = (aux, gn, u, pos, plan)
        del got, want
    torch.cuda.empty_cache()
    walk = b1_walk_check(dev)
    max_abs["B1"] = max(max_abs["B1"], walk["fp32"])
    max_abs["B1 bf16"] = max(max_abs["B1 bf16"], walk["bf16"])

    gen = torch.Generator(device=dev)
    gen.manual_seed(300)
    for label, gname, P, N, bn in B2_CASES:
        geom = {"A": CASE_A, "B": CASE_B}[gname]
        p = rand_params(geom, P, 20 + P, dev)
        x = torch.rand((N,) + geom.chw, generator=gen, device=dev)
        per = torch.rand((N, P), generator=gen, device=dev) * 2 - 1 if P else None
        got = eb.emulator_block_cuda(p, x, per, geom, block_n=bn)
        torch.cuda.synchronize()
        want = eb.emulator_block_plain(p, x, per)
        max_abs["B2"] = max(max_abs["B2"], compare(f"B2 {label}", got, want))
        del x, got, want
    for label, gname, P, M, NB, NO, bm in B3_CASES:
        geom = {"A": CASE_A, "B": CASE_B}[gname]
        p = rand_params(geom, P, 30 + P, dev)
        v = torch.rand((M, NB, geom.tiles, geom.rows), generator=gen, device=dev)
        gn = torch.rand((NB * NO,) + geom.chw[1:], generator=gen, device=dev)
        got = eb.emulator_block_grid_cuda(p, v, gn, geom, block_m=bm)
        torch.cuda.synchronize()
        want = eb.emulator_block_grid_plain(p, v, gn, geom)
        max_abs["B3"] = max(max_abs["B3"], compare(f"B3 {label}", got, want))
    p_grid = rand_params(CASE_A, 2, 32, dev)
    for (tag, M), (_, _, u, _, plan) in sorted(timed.items()):
        if M != 4:
            continue
        # the slow path's operands: both rails stacked (2M rows), g_norm
        v = torch.cat([u, u.flip(0)]).contiguous()
        gn = plan.g_norm.reshape(plan.n_blocks, plan.D, plan.rows, 2 * plan.no)
        got = eb.emulator_block_grid_cuda(p_grid, v, gn.contiguous(), CASE_A)
        torch.cuda.synchronize()
        want = eb.emulator_block_grid_plain(p_grid, v, gn, CASE_A)
        max_abs["B3"] = max(max_abs["B3"], compare(
            f"B3 {tag} M=4 (8 rail rows): NB={plan.NB} NO={plan.NO}", got, want))
        del got, want
    torch.cuda.empty_cache()

    # ---- phase 3: the emulator lifecycle, then serve the trained net ----
    from repro_torch.launch import quickstart, serve
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    npz = build / "chip_smoke_conv4xbar_a.npz"
    eb.emulator_block_cuda.launches = 0
    qs = quickstart.main([
        "--seed", "0", "--n-train", str(TRAIN["n_train"]),
        "--n-test", str(TRAIN["n_test"]), "--epochs", str(TRAIN["epochs"]),
        "--lr-halve-at", *[str(e) for e in TRAIN["lr_halve_at"]],
        "--save-npz", str(npz)])
    b2_launches = eb.emulator_block_cuda.launches
    res = qs["result"]
    n_lab = qs["n_labelled"]
    print(f"[lifecycle] circuit solver labelled {n_lab} CASE_A blocks in "
          f"{qs['label_s']:.3f} s ({n_lab / qs['label_s']:.0f} blocks/s) [{card}]",
          flush=True)
    print(f"[lifecycle] trained {TRAIN['epochs']} epochs on {TRAIN['n_train']} "
          f"blocks in {qs['train_s']:.1f} s: test MSE {res.test_mse:.4e} V^2, "
          f"MAE {res.test_mae * 1e3:.3f} mV, Thm 4.1 bound {res.bound:.3e}, "
          f"sig_prob {res.sig_prob:.4f}, accepted {res.accepted} [{card}]",
          flush=True)
    print(f"[lifecycle] calibrated 4x128 @ 128x8 emulator matmul vs digital: "
          f"corr {qs['corr']:.4f}; B2 launches {b2_launches}", flush=True)
    if not (np_isfinite(res.test_mse) and np_isfinite(res.test_mae)):
        fail("non-finite emulator test error")
    if not res.history["test"][-1] < res.history["test"][0]:
        fail(f"training did not lower the test MSE: {res.history['test']}")
    want_b2 = len(res.history["epoch"]) + 1      # logged epochs + final eval
    if b2_launches != want_b2:
        fail(f"B2 launched {b2_launches} times in training, expected {want_b2}")
    trained, test_mse = res.params, res.test_mse
    del qs, res
    torch.cuda.empty_cache()

    # the fp32 fast path folds the precompute into B1: count any host-side
    # build of it while serving
    pre_calls = [0]
    host_precompute = conv4xbar.blocklast_precompute

    def counted_precompute(*a, **k):
        pre_calls[0] += 1
        return host_precompute(*a, **k)

    conv4xbar.blocklast_precompute = counted_precompute
    eb.emulator_block_unified_cuda.launches = 0
    sess, out = serve.main([
        "--arch", "gemma3-1b", "--layers", "2", "--batch", "4",
        "--prompt-len", "32", "--gen", "8", "--seed", "0",
        "--analog-backend", "emulator", "--emulator-params", str(npz)])
    b1_launches = eb.emulator_block_unified_cuda.launches
    conv4xbar.blocklast_precompute = host_precompute
    if pre_calls[0]:
        fail(f"serving built the per-plan precompute on the host "
             f"{pre_calls[0]} times (B1's fp32 kernel folds it in)")
    n_fwd = 1 + (8 - 1)
    want_launches = 3 * 2 * n_fwd
    cfg = sess.cfg
    print(f"[serve] {cfg.name}: d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} sites="
          f"{len(sess.sites())} trained emulator {npz.name}, kernel launches="
          f"{b1_launches}, host-side precompute builds {pre_calls[0]}",
          flush=True)
    if (cfg.d_model, cfg.d_ff, cfg.vocab_size) != (1152, 6912, 262144):
        fail("serve did not run gemma3-1b at full width")
    if b1_launches != want_launches:
        fail(f"kernel launched {b1_launches} times in serving, expected "
             f"{want_launches} (3 projections x 2 layers x {n_fwd} forwards)")
    if not np_isfinite(out["logits"]):
        fail("non-finite logits")
    if out["tokens"].shape != (4, 8):
        fail(f"tokens shape {out['tokens'].shape} != (4, 8)")
    pre_ms, dec_ms = out["prefill_s"] * 1e3, out["decode_s"] * 1e3
    print(f"[serve] prefill 4x32: {pre_ms:.1f} ms ({4 * 32 / out['prefill_s']:.1f} "
          f"tok/s); decode 7 steps: {dec_ms:.1f} ms "
          f"({4 * 7 / out['decode_s']:.1f} tok/s) [{card}]", flush=True)
    # phase 16's yardstick
    unsharded = {"tokens": out["tokens"], "logits": out["logits"],
                 "cache_bytes": sess.ex.cache_bytes()[1]}
    print(f"[serve] executor caches {unsharded['cache_bytes'] / 1e6:.1f} MB "
          f"[{card}]", flush=True)
    del sess, out
    torch.cuda.empty_cache()

    # small-input agreement: the analog matmul through the kernel on the
    # card vs the port's CPU path (the path the CPU tests hold against the
    # JAX package)
    p_cpu = init_params(3, conv4xbar.conv4xbar_schema(CASE_A), device="cpu")
    g = torch.Generator().manual_seed(5)
    w = torch.randn((200, 24), generator=g) * 0.1
    x = torch.randn((6, 200), generator=g)
    ys = []
    for d in ("cpu", dev):
        ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params={
            k: v.to(d) for k, v in p_cpu.items()})
        ys.append(ex.matmul(x.to(d), w.to(d), "mlp.check").cpu())
    rel = float((ys[1] - ys[0]).abs().max() / ys[0].abs().max())
    print(f"[serve] analog matmul card vs CPU path: max rel err {rel:.3e}",
          flush=True)
    if not rel < 1e-4:
        fail("analog matmul on the card disagrees with the CPU path")

    # ---- phase 4: B1 times; B1's bf16 mode ---------------------------------
    b1_shapes, b1_bf16_shapes = [], []
    b1_bf16_launches, bf16_vs_f32 = 0, 0.0
    pre_calls[0] = 0
    for (tag, M), (aux, gn, u, pos, plan) in sorted(timed.items()):
        nbytes, gemm, other = unified_work(M, plan.NB, plan.NO, plan.D,
                                           2 * plan.no, 1, 128, None)
        bms, by = bound_ms(nbytes, (gemm + other, FP32_FLOP_S))
        ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, gn, u, pos),
                     iters=10 if M <= 8 else 5)
        pms = cuda_ms(lambda: eb.emulator_block_unified_plain(aux, gn, u, pos),
                      iters=3 if M <= 8 else 1, warmup=1)
        b1_shapes.append(dict(shape=f"{tag} K={plan.K} N={plan.N} M={M}", ms=ms,
                              plain_ms=pms, bound_ms=bms, bound_by=by,
                              bytes=nbytes, flops=gemm + other, peak="fp32"))
        print(f"[time] B1 {tag} M={M}: kernel {ms:.3f} ms (the precompute "
              f"folded in), plain {pms:.3f} ms, bound {bms:.3f} ms ({by}: "
              f"{nbytes / 1e9:.3f} GB, {(gemm + other) / 1e9:.2f} GFLOP at "
              f"fp32) [{card}]", flush=True)
        # the bf16 mode through the dispatcher, as a caller asks for it;
        # any host-side build of the precompute is counted
        nbytes, gemm, other = unified_work(M, plan.NB, plan.NO, plan.D,
                                           2 * plan.no, 1, 128, None,
                                           bf16=True)

        def bf16_call():
            conv4xbar.blocklast_precompute = counted_precompute
            try:
                return emulator_block_unified(aux, gn, u, pos,
                                              compute_dtype=BF16)
            finally:
                conv4xbar.blocklast_precompute = host_precompute

        eb.emulator_block_unified_cuda.launches = 0
        got = bf16_call()
        torch.cuda.synchronize()
        b1_bf16_launches += eb.emulator_block_unified_cuda.launches
        want = eb.emulator_block_unified_plain(aux, gn, u, pos,
                                               compute_dtype=BF16)
        max_abs["B1 bf16"] = max(max_abs["B1 bf16"], compare(
            f"B1 bf16 mode {tag} M={M}", got, want))
        f32 = eb.emulator_block_unified_cuda(aux, gn, u, pos)
        d = compare(f"B1 bf16 mode vs fp32 mode {tag} M={M}", got, f32, 0.0,
                    B1_BF16_ATOL)
        bf16_vs_f32 = max(bf16_vs_f32, d)
        del got, want, f32
        bms, by = bound_ms(nbytes, (gemm, BF16_FLOP_S), (other, FP32_FLOP_S))
        ms = cuda_ms(bf16_call, iters=10 if M <= 8 else 5)
        pms = cuda_ms(lambda: eb.emulator_block_unified_plain(
            aux, gn, u, pos, compute_dtype=BF16), iters=3 if M <= 8 else 1,
            warmup=1)
        b1_bf16_shapes.append(dict(
            shape=f"{tag} K={plan.K} N={plan.N} M={M} bf16 mode", ms=ms,
            plain_ms=pms, bound_ms=bms, bound_by=by, bytes=nbytes,
            flops=gemm + other, peak="GEMM bf16, the rest fp32"))
        print(f"[time] B1 bf16 mode {tag} M={M}: kernel {ms:.3f} ms (the "
              f"precompute folded in), plain {pms:.3f} ms, bound {bms:.3f} ms "
              f"({by}: {nbytes / 1e9:.3f} GB; "
              f"{gemm / 1e9:.2f} GFLOP GEMM at bf16, {other / 1e9:.2f} GFLOP "
              f"other at fp32) [{card}]", flush=True)
    print(f"[B1 bf16] launches through the dispatcher {b1_bf16_launches}; max "
          f"|bf16 mode - fp32 mode| {bf16_vs_f32:.4e} (gate {B1_BF16_ATOL}); "
          f"max |kernel - plain| {max_abs['B1 bf16']:.3e} (gate rtol {RTOL} "
          f"/ atol {ATOL}; 0 by design); host-side precompute builds "
          f"{pre_calls[0]}", flush=True)
    if b1_bf16_launches != len(timed):
        fail(f"B1's bf16 mode launched {b1_bf16_launches} times for "
             f"{len(timed)} dispatcher calls")
    if pre_calls[0]:
        fail(f"B1's bf16 mode built the per-plan precompute on the host "
             f"{pre_calls[0]} times (its kernel folds it in)")
    up_plan = timed[("mlp.up", 4)][4]
    down_plan = timed[("mlp.down", 4)][4]
    del timed
    torch.cuda.empty_cache()

    # ---- phase 5: the paper's headline, per block --------------------------
    from repro_torch.core.analytic import analytic_block_response
    from repro_torch.core.circuit import CircuitParams, block_response
    from repro_torch.core.emulator import normalize_features, sample_block_inputs
    cp = CircuitParams()
    b2_shapes = []
    per_block = {}
    for N in (2048, 65536):
        gb = torch.Generator(device=dev)
        gb.manual_seed(N)
        xr, per = sample_block_inputs(gb, N, CASE_A, acfg)
        xn = normalize_features(xr, acfg).contiguous()
        per = per.contiguous()
        it = 5 if N <= 2048 else 2
        routes = {
            "circuit": lambda: block_response(xr, cp, per),
            "analytic": lambda: analytic_block_response(xr, cp, per),
            "plain apply": lambda: eb.emulator_block_plain(trained, xn, per),
            "B2": lambda: eb.emulator_block_cuda(trained, xn, per, CASE_A),
        }
        row = {name: cuda_ms(fn, iters=it, warmup=1) for name, fn in routes.items()}
        # B2's kernel alone (the weights packed once) and its whole call
        # (pack, checks, launch), in turns
        pk = eb.pack_block_weights(trained, CASE_A)
        b2_kernel, b2_call = paired_ms(
            [lambda: eb.launch_block(pk, xn, per, CASE_A), routes["B2"]],
            iters=20 if N <= 2048 else 5)
        if N == 2048:
            # the repo's own structural check (tests/test_system.py): a
            # trained emulator tracks the circuit on its training
            # distribution
            yc, ye = routes["circuit"]().ravel(), routes["B2"]().ravel()
            corr_ce = float(torch.corrcoef(torch.stack([yc, ye]))[0, 1])
            print(f"[headline] circuit vs trained emulator (B2) on {N} fresh "
                  f"blocks: circuit |V| mean {float(yc.abs().mean()) * 1e3:.3f} "
                  f"mV; emulator MAE {float((ye - yc).abs().mean()) * 1e3:.3f} "
                  f"mV, corr {corr_ce:.4f}", flush=True)
            if test_mse <= 1.5e-3 and not corr_ce > 0.8:
                fail(f"the trained emulator tracks the circuit at corr {corr_ce:.3f}")
        per_block[N] = {k: v * 1e3 / N for k, v in row.items()}     # us/block
        nbytes, flops = block_work(CASE_A, N, 2)
        bms, by = bound_ms(nbytes, (flops, FP32_FLOP_S))
        b2_shapes.append(dict(shape=f"CASE_A N={N} P=2", ms=b2_kernel,
                              call_ms=b2_call, plain_ms=row["plain apply"],
                              bound_ms=bms, bound_by=by, bytes=nbytes,
                              flops=flops, bound_share=bms / b2_kernel))
        print(f"[headline] N={N} CASE_A blocks, us per block: " + ", ".join(
            f"{k} {v:.5f}" for k, v in per_block[N].items())
            + f"; circuit / B2 = {row['circuit'] / row['B2']:.1f}x (the call), "
            f"{row['circuit'] / b2_kernel:.1f}x (the kernel alone) [{card}]",
            flush=True)
        print(f"[time] B2 N={N}: kernel {b2_kernel:.4f} ms, call (pack, "
              f"checks, launch) {b2_call:.4f} ms, plain "
              f"{row['plain apply']:.3f} ms, bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
              f"{100 * bms / b2_kernel:.1f}% of the bound [{card}]", flush=True)
        del xr, xn, per, routes, pk
        torch.cuda.empty_cache()

    # ---- phase 6: the executor's slow path ----------------------------------
    import dataclasses
    eb.emulator_block_grid_cuda.launches = 0
    b3_calls = 0
    gs = torch.Generator(device=dev)
    gs.manual_seed(0)
    w = torch.randn((512, 32), generator=gs, device=dev) * 0.2
    xin = torch.randn((16, 512), generator=gs, device=dev) * 0.5
    xc = torch.randn((256, 512), generator=gs, device=dev) * 0.5
    y_dig = xin @ w
    y_circ = None
    base = AnalogConfig()
    for name, backend, fast in (("circuit", "circuit", True),
                                ("analytic", "analytic", True),
                                ("emulator slow path (B3)", "emulator", False),
                                ("emulator fast path (B1)", "emulator", True)):
        ex = AnalogExecutor(dataclasses.replace(base, backend=backend),
                            geom=CASE_A, cp=cp, fast_path=fast,
                            emulator_params=trained if backend == "emulator"
                            else None)
        ex.calibrate(xc, w, "bench")
        iters = 3
        ms = host_ms(lambda: ex.matmul(xin, w, "bench"), iters=iters)
        y = ex.matmul(xin, w, "bench")
        if backend == "emulator" and not fast:
            b3_calls += 1 + 1 + iters + 1      # calibrate, warm-up, timed, last
        corr = float(torch.corrcoef(torch.stack([y.ravel(), y_dig.ravel()]))[0, 1])
        if y_circ is None:
            y_circ = y
        corr_c = float(torch.corrcoef(torch.stack([y.ravel(), y_circ.ravel()]))[0, 1])
        print(f"[slow path] bench (16, 512) @ (512, 32) {name}: corr with "
              f"digital {corr:.4f}, with the circuit backend {corr_c:.4f}, "
              f"{ms:.3f} ms per calibrated matmul [{card}]", flush=True)
        # nonlinear hardware: correlated with the digital product, not
        # equal to it (tests/test_system.py's bound for the physical models)
        if not (corr > 0.3 if backend != "emulator" else corr == corr):
            fail(f"{name} correlates {corr:.3f} with digital")
    # the trained emulator against the circuit on the bench matmul's own
    # blocks (both rails, ideal periph), next to the training
    # distribution of phase 5
    ex = AnalogExecutor(base, geom=CASE_A, cp=cp, emulator_params=trained)
    plan = build_conductance_plan(w, base, CASE_A)
    rails = torch.cat([xin.clamp_min(0), (-xin).clamp_min(0)])
    xb = plan.build_x(plan.tile_v(ex._drive01(rails / xin.abs().max()),
                                  base.v_read))
    per = torch.tensor([1.0, 0.0], device=dev).expand(xb.shape[0], 2).contiguous()
    yc = block_response(xb, cp, per).ravel()
    ye = eb.emulator_block_cuda(trained, normalize_features(xb, base).contiguous(),
                                per, CASE_A).ravel()
    corr_b = float(torch.corrcoef(torch.stack([yc, ye]))[0, 1])
    print(f"[slow path] bench blocks ({xb.shape[0]}): circuit |V| mean "
          f"{float(yc.abs().mean()) * 1e3:.3f} mV; trained emulator MAE "
          f"{float((ye - yc).abs().mean()) * 1e3:.3f} mV, corr {corr_b:.4f}",
          flush=True)
    b3_shapes = []
    slow_err = 0.0
    for tag, K, N in (("mlp.up", GEMMA["d_model"], GEMMA["d_ff"]),):
        g = torch.Generator(device=dev)
        g.manual_seed(400)
        w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        slow = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained,
                              fast_path=False)
        fast = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained)
        for M in (4, 128):
            x = torch.randn((M, K), generator=g, device=dev)
            ys, _ = slow.raw_matmul(x, w, tag)
            b3_calls += 1
            yf, _ = fast.raw_matmul(x, w, tag)
            torch.cuda.synchronize()
            slow_err = max(slow_err, compare(
                f"slow path (B3) vs fast path (B1) {tag} M={M}", ys, yf,
                SLOW_RTOL, SLOW_ATOL))
            del ys, yf
    b3_launches = eb.emulator_block_grid_cuda.launches
    print(f"[slow path] B3 launches {b3_launches}, slow-path emulator calls "
          f"{b3_calls}", flush=True)
    if b3_launches != b3_calls:
        fail(f"B3 launched {b3_launches} times for {b3_calls} slow-path calls")

    # a conditioned net given scenario features takes B2 with its periph
    pc = rand_params(CASE_A, 15, 50, dev)
    sfeat = 0.5 * torch.randn(13, generator=gs, device=dev)
    w = torch.randn((200, 6), generator=gs, device=dev) * 0.1
    x = torch.randn((3, 200), generator=gs, device=dev)
    cond = []
    for d in (dev, "cpu"):
        n2, n3 = eb.emulator_block_cuda.launches, eb.emulator_block_grid_cuda.launches
        ex = AnalogExecutor(acfg, geom=CASE_A, fast_path=False,
                            emulator_params={k: v.to(d) for k, v in pc.items()})
        cond.append(ex.raw_matmul(x.to(d), w.to(d), "cond", sfeat=sfeat.to(d))[0])
        if d == dev and (eb.emulator_block_cuda.launches - n2,
                         eb.emulator_block_grid_cuda.launches - n3) != (1, 0):
            fail("a conditioned net with scenario features did not take B2")
    compare("conditioned slow path with sfeat (B2) card vs CPU", cond[0].cpu(),
            cond[1], 1e-4, 1e-6)

    # B3 times at the slow path's full-width shapes
    for tag, plan in (("mlp.up", up_plan), ("mlp.down", down_plan)):
        gn = plan.g_norm.reshape(plan.n_blocks, plan.D, plan.rows,
                                 2 * plan.no).contiguous()
        for M in (4, 128):
            rows = 2 * M
            v = torch.rand((rows, plan.NB, plan.D, plan.rows), generator=gs,
                           device=dev)
            nbytes, flops = grid_work(CASE_A, rows, plan.NB, plan.NO, 2)
            bms, by = bound_ms(nbytes, (flops, FP32_FLOP_S))
            pk = eb.pack_grid_weights(trained, CASE_A)
            ms, call_ms = paired_ms(
                [lambda: eb.launch_grid(pk, v, gn, CASE_A),
                 lambda: eb.emulator_block_grid_cuda(trained, v, gn, CASE_A)],
                iters=5 if M <= 8 else 2, reps=5, warmup=1)
            pms = None
            if M <= 8:
                pms = cuda_ms(lambda: eb.emulator_block_grid_plain(
                    trained, v, gn, CASE_A), iters=1, warmup=1)
            b3_shapes.append(dict(shape=f"{tag} K={plan.K} N={plan.N} M={M} "
                                  f"({rows} rail rows)", ms=ms,
                                  call_ms=call_ms, plain_ms=pms,
                                  bound_ms=bms, bound_by=by, bytes=nbytes,
                                  flops=flops, bound_share=bms / ms))
            print(f"[time] B3 {tag} M={M} ({rows} rail rows): kernel {ms:.3f} ms, "
                  f"call (pack, checks, launch) {call_ms:.3f} ms, "
                  f"plain {'not timed' if pms is None else f'{pms:.3f} ms'}, "
                  f"bound {bms:.3f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.1f} GFLOP), {100 * bms / ms:.1f}% of the "
                  f"bound [{card}]", flush=True)
    torch.cuda.empty_cache()

    # ---- phase 7: serve under a device corner -----------------------------
    ni = nonideal_phase(dev, card, npz, trained, (pre_ms, dec_ms))
    torch.cuda.empty_cache()

    # ---- phase 8: the kernels' own entry points ---------------------------
    t7 = time.perf_counter()
    b4, b5, b6 = entry_points_phase(dev, card)
    print(f"[entry points] phase 8 took {time.perf_counter() - t7:.1f} s",
          flush=True)

    # ---- phase 9: the recurrent families ----------------------------------
    rec = recurrent_phase(dev, card, npz)
    torch.cuda.empty_cache()

    # ---- phase 10: the serving plane ---------------------------------------
    serv = serving_phase(dev, card, npz)
    torch.cuda.empty_cache()

    # ---- phase 11: lifetime management and the fleet twin -----------------
    life = lifetime_phase(dev, card, npz, ni["cond_npz"])
    torch.cuda.empty_cache()

    # ---- phase 12: training ------------------------------------------------
    train = training_phase(dev, card, npz)
    torch.cuda.empty_cache()

    # ---- phase 13: the dense and MoE families at full width --------------
    dec = decoder_phase(dev, card, npz)
    torch.cuda.empty_cache()

    # ---- phase 14: the frontend archs at full width ---------------------
    front = frontend_phase(dev, card, npz)
    torch.cuda.empty_cache()

    # ---- phase 16: the tensor-parallel plane and the tuner ---------------
    mesh = mesh_phase(dev, card, npz, unsharded, b1_shapes)
    torch.cuda.empty_cache()

    # ---- phase 17: training on a mesh --------------------------------------
    mt = mesh_train_phase(dev, card, npz)

    # ---- phase 15: the kernels line --------------------------------------
    ebk = "emulator_block/emulator_block.py:"
    b1_head = next(r for r in b1_shapes if r["shape"].startswith("mlp.up")
                   and r["shape"].endswith(" M=4"))
    b1_bf16_head = next(r for r in b1_bf16_shapes if r["shape"].startswith(
        "mlp.up") and r["shape"].endswith(" M=4 bf16 mode"))
    src = "emulator_block/csrc/"
    kernels = [
        entry("emulator_block_unified", src + "emulator_block_unified.cu",
              ebk + "295",
              b1_launches + serv["b1"] + sum(life["b1"].values())
              + train["b1"]["training"] + sum(dec["b1"].values())
              + sum(front["b1"].values()) + sum(mesh["b1"].values())
              + sum(mt["b1"].values()),
              max(max_abs["B1"], ni["b1_err"], rec["b1_err"], serv["b1_err"],
                  life["b1_err"], train["b1_err"], dec["b1_err"],
                  front["b1_err"], mesh["b1_err"], mt["b1_err"]),
              b1_head, b1_shapes, nonideal_launches=ni["b1"],
              model_launches=rec["b1"], model_path=rec["b1_rows"],
              engine_launches=serv["b1"], engine_path=serv["b1_rows"],
              lifetime_launches=life["b1"], lifetime_path=life["b1_rows"],
              training_launches=train["b1"], training_path=train["b1_rows"],
              decoder_launches=dec["b1"], decoder_path=dec["b1_rows"],
              frontend_launches=front["b1"], frontend_path=front["b1_rows"],
              mesh_launches=mesh["b1"], mesh_path=mesh["rows"],
              tuner=mesh["tuner"], train_mesh_launches=mt["b1"]),
        entry("emulator_block_unified (bf16 mode)",
              src + "emulator_block_unified.cu", ebk + "295", b1_bf16_launches,
              max_abs["B1 bf16"], b1_bf16_head, b1_bf16_shapes),
        entry("emulator_block", src + "emulator_block.cu", ebk + "182",
              b2_launches, max(max_abs["B2"], ni["b2_err"]), b2_shapes[-1],
              b2_shapes, nonideal_launches={
                  "conditioned_training": ni["b2_train"],
                  "slow_path_stressed": ni["b2"]},
              slow_vs_fast_volts_err=ni["b2_slow_err"]),
        entry("emulator_block_grid", src + "emulator_block.cu", ebk + "137",
              b3_launches, max(max_abs["B3"], ni["b3_err"]), b3_shapes[0],
              b3_shapes, nonideal_launches={"slow_path_stressed": ni["b3"]},
              slow_vs_fast_volts_err=ni["b3_slow_err"]),
        b4, b5, b6,
    ]
    b6["max_abs_err"] = max(b6["max_abs_err"], rec["b6_err"], serv["b6_err"],
                            train["b6_err"], mt["b6_err"])
    b6["model_launches"] = rec["b6"]
    b6["model_path"] = rec["rows"]
    b6["launches"] += (serv["b6"] + sum(train["b6"].values())
                       + sum(mt["b6"].values()))
    b6["engine_launches"] = serv["b6"]
    b6["engine_path"] = serv["rows"][1:]
    b6["training_launches"] = train["b6"]
    b6["training_backward"] = train["b6_rows"]
    b6["train_mesh_launches"] = mt["b6"]
    print(json.dumps({"serving": serv["rows"][0]}), flush=True)
    print(json.dumps({"lifetime": life["rows"]}), flush=True)
    print(json.dumps({"training": train["row"]}), flush=True)
    print(json.dumps({"decoders": dec["rows"]}), flush=True)
    print(json.dumps({"frontends": front["rows"]}), flush=True)
    print(json.dumps({"mesh": mesh["rows"]}), flush=True)
    print(json.dumps({"train_mesh": mt["rows"]}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def ptxas_stats(log):
    """``kernel -> "registers, spills"`` from an ``-Xptxas -v`` log."""
    import re
    stats, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
            continue
        if kernel and ("registers" in line or "spill" in line):
            stats[kernel] = (stats.get(kernel, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return stats


def tensor_core_counts(built):
    """Print the count of tensor-core instructions (HMMA, HGMMA) in each
    built library's SASS; fail if B4's or B5's library has none."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for src, (lib, _) in built.items():
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300)
        if sass.returncode != 0:
            fail(f"cuobjdump -sass {lib.name} failed: {sass.stderr.strip()}")
        # as grep -cE 'HMMA|HGMMA' counts them: lines that hold either
        counts[src.stem] = sum(1 for line in sass.stdout.splitlines()
                               if "HMMA" in line or "HGMMA" in line)
        print(f"[build] {lib.name}: {counts[src.stem]} tensor-core "
              f"instructions (HMMA|HGMMA) in its SASS", flush=True)
    for stem in ("xbar_mac", "flash_attention"):
        if not counts.get(stem):
            fail(f"{stem}'s library has no tensor-core instruction")


def entry(name, source, replaces, launches, err, head, shapes, **extra):
    """One kernel's record of the ``kernels`` line: ``source`` under the
    port's kernels, ``replaces`` under the JAX package's; ``head`` is the
    shape whose numbers stand at the top level; ``extra`` (e.g. the
    launches on phase 7's non-ideal path) is added as it is."""
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/" + source,
           "replaces": "src/repro/kernels/" + replaces, "launches": launches,
           "max_abs_err": err, "ms": head["ms"], "plain_ms": head["plain_ms"],
           "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
           "library_ms": head.get("library_ms"), "shapes": shapes}
    if "call_ms" in head:         # ms is the kernel alone, call_ms the call
        row["call_ms"] = head["call_ms"]
    if "copy_ms" in head:         # B6's yardstick: torch.add(a, b, out=h)
        row["copy_ms"] = head["copy_ms"]
    row.update(extra)
    return row


# the conditioned emulator's training budget on the card (a CASE_A net,
# P = 2 + 13): the Table 1 set size, 20 epochs
COND_TRAIN = dict(n_train=50_000, n_test=5_000, epochs=20, lr=2e-3,
                  lr_halve_at=(12, 17))


def remap_damage(plan, off, gperm, acfg):
    """Instant damage of a group assignment on the host: the protected
    (top-decile |w|) cells and the conductance excess (weight units) that
    land on stuck-off cells, as ``fault_aware_group_perm`` scores them."""
    import numpy as np
    g = plan.g_feat.double().cpu().numpy()
    span = acfg.g_max - acfg.g_min
    excess = np.where(g > 0, (g - acfg.g_min) / span, 0.0)
    thr = np.quantile(excess[excess > 0], 0.9)
    top = excess >= thr
    ginv = np.argsort(np.asarray(gperm))
    o = off.cpu().numpy()
    return (int((o & top[:, ginv]).sum()),
            float((o * excess[:, ginv]).sum()))


def nonideal_phase(dev, card, npz, trained, ideal_ms):
    """The new path: gemma3-1b served at full width under a device corner,
    through the serve CLI, twice -- (a) the phase-3 net under ``stressed``
    with fault remapping, (b) a conditioned CASE_A net trained here under
    a tiled corner (each tile its own prog and read sigma; B1 takes a
    per-block fc0 shift), saved with ``--state-save`` and served again
    with ``--state-load``.  B1's launches are counted per run (set to 0
    just before, read just after).  Then the checks on the card: B1
    against its plain version on each run's full-width ``mlp.up`` state
    (one read draw given to both), the conditioned net at the ideal
    corner bit-equal to the same net with no shift, B2 against its plain
    version on the conditioned net's test blocks (the shape its training
    evaluations ran at), and the slow path (B3 for the plain net, B2 at
    P = 15 for the conditioned one) against the fast path on the
    calibrated bench matmul under ``stressed``, one read draw given to
    both, with each slow-path kernel call held against its plain version
    on the inputs the path gave it.  Returns the launch counts and the
    errors: ``b*_err`` of each kernel against its plain version,
    ``b*_slow_err`` of the slow path against the fast path."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import nonideal as NI
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A, EmulatorTrainConfig
    from repro_torch.core import conv4xbar
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.core.circuit import CircuitParams
    from repro_torch.core.crossbar import build_conductance_plan
    from repro_torch.interop import save_emulator_npz
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.launch import serve
    from repro_torch.nonideal import data as nidata
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    cp = CircuitParams()
    build = ROOT / "build"
    t_phase = time.perf_counter()
    out = {"b1": {}, "b1_err": 0.0, "b2": 0, "b3": 0, "b2_err": 0.0,
           "b3_err": 0.0, "b2_slow_err": 0.0, "b3_slow_err": 0.0}
    common = ["--arch", "gemma3-1b", "--layers", "2", "--batch", "4",
              "--prompt-len", "32", "--gen", "8", "--seed", "0",
              "--analog-backend", "emulator"]
    n_fwd = 8

    def b1_vs_plain(label, ex, sess, site, sfeat):
        """B1 against its plain version at one full-width mlp.up call on
        the run's state of ``site``, the read draw made once."""
        st = sess._last_states[site]
        w = sess.sites()[site]
        plan = ex._plan_for(w, site)
        noisy = plan.with_g(ex._read(st), ex.acfg)
        g = torch.Generator(device=dev)
        g.manual_seed(901)
        x = torch.randn((4, plan.K), generator=g, device=dev)
        xs = x.abs().max()
        u = noisy.tile_v(ex._drive01(x.abs() / xs), 1.0).contiguous()
        pos = noisy.tile_v((x > 0).float(), 1.0).contiguous()
        aux = ex._blocklast_aux(st.eparams)
        shift = None
        if sfeat is not None:
            shift = (st.sfeat @ aux["f0_scen"])
            shift = shift.reshape(-1, shift.shape[-1]).contiguous()
        gn = noisy.g_norm.contiguous()
        got = eb.emulator_block_unified_cuda(aux, gn, u, pos, shift=shift)
        torch.cuda.synchronize()
        want = eb.emulator_block_unified_plain(aux, gn, u, pos, shift=shift)
        return compare(f"B1 {label} {site} K={plan.K} N={plan.N} M=4, "
                       f"{'per-block shift ' + str(tuple(shift.shape)) if shift is not None else 'no shift'}",
                       got, want)

    def report(label, sess, res):
        ex = sess.ex
        pm, dm = res["prefill_s"] * 1e3, res["decode_s"] * 1e3
        print(f"[nonideal] {label}: prefill 4x32 {pm:.1f} ms, decode 7 steps "
              f"{dm:.1f} ms ({dm / 7:.2f} ms a step); ideal serve (warm) "
              f"{ideal_ms[0]:.1f} / {ideal_ms[1]:.1f} ms [{card}]", flush=True)
        for site in sorted(ex.materialize_s):
            tot, rem = ex.materialize_s[site]
            print(f"[nonideal] {label}: device state of {site} materialized "
                  f"in {tot * 1e3:.1f} ms on the host, remap {rem * 1e3:.1f} "
                  f"ms of it [{card}]", flush=True)
        if not np_isfinite(res["logits"]):
            fail(f"{label}: non-finite logits")
        if res["tokens"].shape != (4, 8):
            fail(f"{label}: tokens shape {res['tokens'].shape} != (4, 8)")

    def read_cost(label, sess):
        """The ms one read of every analog site's state (the read-noise
        redraw and ``with_g``) takes, noisy against the same state without
        read noise (the clamp only).  The executor keeps the read plan
        while the state stays (``_read_plan``), so a generate pays it once,
        at its first forward, and a decode step reuses it: checked here
        on the sites' cached read plans."""
        ex = sess.ex
        pairs = [(ex._plan_for(w, s), sess._last_states[s])
                 for s, w in sess.sites().items()]
        kept = sum(ex._read_cache[s][1] is sess._last_states[s]
                   for s in sess.sites())
        if kept != len(pairs):
            fail(f"{label}: {len(pairs) - kept} sites served without their "
                 f"state's kept read plan")
        quiet = [(p, st.replace(read_sigma=torch.zeros_like(st.read_sigma)))
                 for p, st in pairs]
        noisy_ms, quiet_ms = paired_ms(
            [lambda: [p.with_g(ex._read(st), ex.acfg) for p, st in pairs],
             lambda: [p.with_g(ex._read(st), ex.acfg) for p, st in quiet]],
            iters=5, reps=5)
        print(f"[nonideal] {label}: read of {len(pairs)} sites (the redraw "
              f"and with_g) {noisy_ms:.3f} ms with read noise, "
              f"{quiet_ms:.3f} ms without (clamp and with_g), paid once a "
              f"generate: the redraw adds {noisy_ms - quiet_ms:.3f} ms to the "
              f"first forward and none to a decode step, whose {kept} sites "
              f"reuse their kept read plans [{card}]", flush=True)
        return noisy_ms, quiet_ms

    # -- the ideal serve again, warm, as the baseline of this phase ---------
    _, res = serve.main(common + ["--emulator-params", str(npz)])
    print(f"[nonideal] ideal corner (warm): prefill 4x32 "
          f"{res['prefill_s'] * 1e3:.1f} ms, decode 7 steps "
          f"{res['decode_s'] * 1e3:.1f} ms; phase 3 (the process's first "
          f"serve) {ideal_ms[0]:.1f} / {ideal_ms[1]:.1f} ms [{card}]",
          flush=True)
    ideal_ms = (res["prefill_s"] * 1e3, res["decode_s"] * 1e3)
    out["ms_ideal"] = ideal_ms

    # -- (a) the phase-3 net under stressed, fault-remapped -----------------
    eb.emulator_block_unified_cuda.launches = 0
    sess, res = serve.main(common + ["--emulator-params", str(npz),
                                     "--scenario", "stressed",
                                     "--fault-remap"])
    n_a = eb.emulator_block_unified_cuda.launches
    out["b1"]["stressed_remap"] = n_a
    report("(a) stressed, fault remap", sess, res)
    if n_a != 3 * 2 * n_fwd:
        fail(f"(a): B1 launched {n_a} times, expected {3 * 2 * n_fwd}")
    ex = sess.ex
    sc = ex.scenario
    if not (sc.name == "stressed" and ex.fault_remap):
        fail("(a) did not serve the stressed corner with remapping")
    site = "mlp.up#0"
    w = sess.sites()[site]
    plan = ex._plan_for(w, site)
    _, off = NI.realized_fault_masks(plan, sc, ex._tag_key(site))
    gperm = sess._last_states[site].out_perm.cpu().numpy()   # no = 1
    t0 = time.perf_counter()
    h_id, d_id = remap_damage(plan, off, np.arange(plan.NO), ex.acfg)
    h_re, d_re = remap_damage(plan, off, gperm, ex.acfg)
    print(f"[nonideal] (a) remap of {site} (NB={plan.NB}, NO={plan.NO}, "
          f"{int(off.sum())} stuck-off cells): protected cells on stuck-off "
          f"{h_id} -> {h_re}, excess there {d_id:.2f} -> {d_re:.2f} (weight "
          f"units); {int((gperm != np.arange(plan.NO)).sum())} groups moved "
          f"[{card}]", flush=True)
    if not (h_re <= h_id and d_re <= d_id):
        fail("(a) the remap put more damage on stuck-off cells")
    out["remap"] = dict(hits=(h_id, h_re), excess=(d_id, d_re))
    out["b1_err"] = max(out["b1_err"], b1_vs_plain("(a) stressed", ex, sess,
                                                   site, None))
    out["read_a"] = read_cost("(a)", sess)
    out["ms_a"] = (res["prefill_s"] * 1e3, res["decode_s"] * 1e3)
    del sess, res, ex
    torch.cuda.empty_cache()

    # -- (b) a conditioned CASE_A net, trained here -------------------------
    times = {}
    gen_data = nidata.generate_dataset_conditioned

    def timed_data(*a, **k):
        t = time.perf_counter()
        r = gen_data(*a, **k)
        torch.cuda.synchronize()
        times["label"] = time.perf_counter() - t
        times["data"] = r
        return r

    tcfg = EmulatorTrainConfig(
        n_train=COND_TRAIN["n_train"], n_test=COND_TRAIN["n_test"],
        epochs=COND_TRAIN["epochs"], lr=COND_TRAIN["lr"],
        lr_halve_at=COND_TRAIN["lr_halve_at"], batch_size=256)
    eb.emulator_block_cuda.launches = 0
    nidata.generate_dataset_conditioned = timed_data
    t0 = time.perf_counter()
    try:
        cres = NI.train_conditioned_emulator(0, CASE_A, acfg, cp, tcfg,
                                             log_every=5, device=dev)
    finally:
        nidata.generate_dataset_conditioned = gen_data
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    b2_train = eb.emulator_block_cuda.launches
    out["b2_train"] = b2_train
    cond = cres.params
    npf = conv4xbar.n_periph_of(cond, CASE_A)
    print(f"[nonideal] conditioned CASE_A net (P={npf}): labelled "
          f"{tcfg.n_train + tcfg.n_test} blocks over the corner manifold in "
          f"{times['label']:.2f} s, trained {tcfg.epochs} epochs in "
          f"{t_all - times['label']:.1f} s; test MSE {cres.test_mse:.4e} V^2, "
          f"MAE {cres.test_mae * 1e3:.3f} mV; B2 launches {b2_train} [{card}]",
          flush=True)
    if npf != 15 or not np_isfinite(cres.test_mse):
        fail(f"the conditioned net has P={npf}, test MSE {cres.test_mse}")
    if b2_train != len(cres.history["epoch"]) + 1:
        fail(f"B2 launched {b2_train} times in conditioned training")
    # B2 against its plain version on the test blocks the evaluations
    # above ran on (CASE_A, P = 15, N = n_test), with the trained net
    X, Pf, _ = times.pop("data")
    xte, pte = X[tcfg.n_train:], Pf[tcfg.n_train:]
    got = eb.emulator_block_cuda(cond, xte, pte, CASE_A)
    torch.cuda.synchronize()
    want = eb.emulator_block_plain(cond, xte, pte)
    out["b2_err"] = max(out["b2_err"], compare(
        f"B2 conditioned net's test blocks, CASE_A P={pte.shape[1]} "
        f"N={xte.shape[0]}", got, want))
    del X, Pf, xte, pte, got, want
    cnpz = build / "chip_smoke_conv4xbar_a_conditioned.npz"
    save_emulator_npz(str(cnpz), cond)
    out["cond_npz"] = cnpz
    # the tiled corner on mlp.up/gate's lattice: stressed, each tile its
    # own prog and read sigma
    K, N = GEMMA["d_model"], GEMMA["d_ff"]
    n_tiles = -(-K // acfg.rows)
    nb, no = -(-n_tiles // CASE_A.tiles), N // CASE_A.outputs
    g = np.random.default_rng(21)
    tiled = NI.tile_scenarios(
        nb, no, base=NI.get_scenario("stressed"), name="smoke_tiled",
        prog_sigma=g.uniform(0.02, 0.12, (nb, no)).astype(np.float32),
        read_sigma=g.uniform(0.0, 0.05, (nb, no)).astype(np.float32))
    NI.register_scenario(tiled, overwrite=True)
    dep_npz = build / "chip_smoke_deployment.npz"
    cargs = common + ["--emulator-params", str(cnpz), "--conditioned-emulator",
                      "--analog-layers", "mlp.up,mlp.gate"]
    eb.emulator_block_unified_cuda.launches = 0
    sess, res = serve.main(cargs + ["--scenario", "smoke_tiled",
                                    "--state-save", str(dep_npz)])
    n_b = eb.emulator_block_unified_cuda.launches
    out["b1"]["tiled_conditioned_save"] = n_b
    report("(b) conditioned, tiled corner, --state-save", sess, res)
    st = sess._last_states["mlp.up#0"]
    if tuple(st.sfeat.shape) != (nb, no, 13):
        fail(f"(b): sfeat {tuple(st.sfeat.shape)}, expected per-tile")
    out["b1_err"] = max(out["b1_err"], b1_vs_plain("(b) tiled", sess.ex, sess,
                                                   "mlp.up#0", st.sfeat))
    out["read_b"] = read_cost("(b)", sess)
    eb.emulator_block_unified_cuda.launches = 0
    sess2, res2 = serve.main(cargs + ["--state-load", str(dep_npz)])
    n_l = eb.emulator_block_unified_cuda.launches
    out["b1"]["tiled_conditioned_load"] = n_l
    report("(b) --state-load", sess2, res2)
    for n, lab in ((n_b, "save"), (n_l, "load")):
        if n != 2 * 2 * n_fwd:
            fail(f"(b) {lab}: B1 launched {n} times, expected {2 * 2 * n_fwd}")
    same_tok = np.array_equal(res["tokens"], res2["tokens"])
    same_log = np.array_equal(res["logits"], res2["logits"])
    print(f"[nonideal] (b) --state-save then --state-load: tokens equal "
          f"{same_tok}, logits bit-equal {same_log}", flush=True)
    if not (same_tok and same_log):
        fail("--state-load did not reproduce the saved run bit for bit")
    out["ms_b"] = (res["prefill_s"] * 1e3, res["decode_s"] * 1e3)
    out["ms_b_load"] = (res2["prefill_s"] * 1e3, res2["decode_s"] * 1e3)
    del sess, res, sess2, res2
    torch.cuda.empty_cache()

    # -- the conditioned net at the ideal corner vs no shift, through B1 ---
    gi = torch.Generator(device=dev)
    gi.manual_seed(902)
    w = torch.randn((K, N), generator=gi, device=dev) * K ** -0.5
    x = torch.randn((4, K), generator=gi, device=dev)
    exc = AnalogExecutor(acfg, geom=CASE_A, emulator_params=cond)
    y_none, _ = exc.raw_matmul(x, w, "u")
    y_zero, _ = exc.raw_matmul(x, w, "u", sfeat=torch.zeros(13, device=dev))
    y_plain = exc.matmul(x, w, "u")
    exc.deploy(scenario="ideal", key=5)
    y_ideal = exc.matmul(x, w, "u")
    eq = torch.equal(y_none, y_zero) and torch.equal(y_plain, y_ideal)
    print(f"[nonideal] conditioned net at the ideal corner vs no shift "
          f"(B1, mlp.up M=4): bit-equal {eq}", flush=True)
    if not eq:
        fail("the conditioned net at the ideal corner is not bit-equal to "
             "the net with no shift")

    # -- slow path vs fast path under stressed, one read draw ---------------
    gs = torch.Generator(device=dev)
    gs.manual_seed(0)
    w = torch.randn((512, 32), generator=gs, device=dev) * 0.2
    xin = torch.randn((16, 512), generator=gs, device=dev) * 0.5
    xc = torch.randn((256, 512), generator=gs, device=dev) * 0.5
    base = AnalogConfig()
    # the slow path's kernel calls, recorded with their inputs and outputs
    # through the executor's names for the two entry points
    import repro_torch.core.analog as analog_mod
    entry_fns = {n: getattr(analog_mod, n)
                 for n in ("emulator_block", "emulator_block_grid")}
    seen = []

    def recorded(n):
        def call(*a, **k):
            y = entry_fns[n](*a, **k)
            seen.append((n, a, k, y))
            return y
        return call

    for name, params, key in (("plain net (B3)", trained, "b3"),
                              ("conditioned net (B2, P=15)", cond, "b2")):
        exf = AnalogExecutor(base, geom=CASE_A, cp=cp, emulator_params=params)
        exs = AnalogExecutor(base, geom=CASE_A, cp=cp, emulator_params=params,
                             fast_path=False)
        for e in (exf, exs):
            e.deploy(scenario="stressed", key=7)
        exf.calibrate(xc, w, "bench")
        st = exf.state_for("bench", w)
        if not st.has_read_noise:
            fail("the stressed bench state draws no read noise")
        # one read cycle of the state's conductances, given to both paths;
        # the gate holds the volts (raw_matmul), as phase 6 does, and the
        # calibrated outputs, (cal_a * volts + cal_b) * max|x|, are printed
        plan = exf._read_plan(w, "bench", st)
        seen.clear()
        for n in entry_fns:
            setattr(analog_mod, n, recorded(n))
        eb.emulator_block_cuda.launches = 0
        eb.emulator_block_grid_cuda.launches = 0
        try:
            vs, xs = exs.raw_matmul(xin, w, "bench", plan=plan,
                                    eparams=st.eparams, sfeat=st.sfeat)
        finally:
            for n, fn in entry_fns.items():
                setattr(analog_mod, n, fn)
        n2, n3 = (eb.emulator_block_cuda.launches,
                  eb.emulator_block_grid_cuda.launches)
        vf, _ = exf.raw_matmul(xin, w, "bench", plan=plan,
                               eparams=st.eparams, sfeat=st.sfeat)
        ys = exs.matmul(xin, w, "bench", state=st)
        yf = exf.matmul(xin, w, "bench", state=st)
        torch.cuda.synchronize()
        want = (0, 1) if key == "b3" else (1, 0)
        if (n2, n3) != want:
            fail(f"slow path of the {name}: (B2, B3) launches {(n2, n3)}, "
                 f"expected {want}")
        out[key] += n2 + n3
        if len(seen) != 1:
            fail(f"slow path of the {name}: {len(seen)} kernel calls recorded")
        n, a, k, y = seen[0]
        if n == "emulator_block":
            p_, x_, per_, _ = a
            want_y = eb.emulator_block_plain(p_, x_, per_)
            what = f"B2 P={per_.shape[1]} N={x_.shape[0]}"
        else:
            p_, v_, g_, geom_ = a
            want_y = eb.emulator_block_grid_plain(p_, v_, g_, geom_)
            what = f"B3 M={v_.shape[0]} NB={v_.shape[1]} blocks={g_.shape[0]}"
        out[key + "_err"] = max(out[key + "_err"], compare(
            f"{what} on the slow path's inputs under stressed ({name})",
            y, want_y))
        seen.clear()
        out[key + "_slow_err"] = compare(
            f"slow path vs fast path, bench (16, 512) @ (512, 32) under "
            f"stressed, {name}, volts", vs, vf, SLOW_RTOL, SLOW_ATOL)
        print(f"[nonideal] the same, calibrated (cal_a {float(st.cal_a):.3f}, "
              f"max|x| {float(xs):.3f}): max |slow - fast| "
              f"{float((ys - yf).abs().max()):.3e} of max |y| "
              f"{float(yf.abs().max()):.3e}", flush=True)
    print(f"[nonideal] B1 launches on this path: {out['b1']}; B2 launches "
          f"{out['b2_train']} in conditioned training, {out['b2']} on the "
          f"slow path; B3 {out['b3']} on the slow path", flush=True)
    print(f"[nonideal] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# phase 9's serves: (arch, layers, prompt length, MLPs on the emulator);
# batch 4, 8 tokens, full published widths, depth cut: recurrentgemma-2b
# to one (R, R, L) period, falcon-mamba-7b to two M layers
REC_SERVES = (("recurrentgemma-2b", 3, 32, True),
             ("falcon-mamba-7b", 2, 512, False))
REC_B, REC_G, REC_DECODE = 4, 8, 3
# prefill + decode against one forward over the same tokens, fp32, TF32
# off: rtol, and atol as a share of the logits' largest magnitude
REC_RTOL, REC_ATOL = 1e-3, 1e-3


def _decode_vs_forward(dev, cfg, B, P, seed, label, note="", inputs=None):
    """Digitally in fp32 (TF32 off): prefill ``P`` tokens + ``REC_DECODE``
    decode steps against one forward over the same tokens (drawn from
    ``seed``) on fresh weights, within ``REC_RTOL`` and ``REC_ATOL`` of
    the logits' scale.  ``inputs``: a frontend arch's ``image_embeds`` or
    ``enc_frames``, given to both (the frames' length is the cross
    caches').  Prints the errors, fails on a disagreement; returns (the
    largest error, the logits' scale)."""
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    f32 = torch.float32
    inputs = inputs or {}
    cross = inputs["enc_frames"].shape[1] if "enc_frames" in inputs else 0
    params = S.init_model_params(1, cfg, dev)
    pcfg = ParallelConfig(compute_dtype="float32", attn_block_kv=min(1024, P))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    T = REC_DECODE
    toks = torch.randint(0, cfg.vocab_size, (B, P + T), generator=g,
                         device=dev)
    with torch.no_grad():
        hs, _, _ = M.forward(params, toks, cfg=cfg, pcfg=pcfg, mode="prefill",
                             compute_dtype=f32, **inputs)
        want = M.compute_logits(params, hs[:, P - 1:], cfg)[..., :cfg.vocab_size]
        del hs
        logits, pc = M.prefill(params, toks[:, :P], cfg=cfg, pcfg=pcfg,
                               compute_dtype=f32, **inputs)
        cache = serve._splice_tree(M.zeros_cache(M.model_cache_schema(
            cfg, B, P + T, cross_len=cross, dtype=f32), dev), pc)
        del pc
        steps = [logits]
        for i in range(T):
            logits, cache = M.decode_step(params, toks[:, P + i:P + i + 1],
                                          cache, P + i, cfg=cfg, pcfg=pcfg,
                                          compute_dtype=f32)
            steps.append(logits)
    scale = float(want.abs().max())
    errs = []
    for i, got in enumerate(steps):
        d = (got[:, :cfg.vocab_size] - want[:, i]).abs()
        errs.append(float(d.max()))
        if not bool((d <= REC_ATOL * scale + REC_RTOL * want[:, i].abs()).all()):
            fail(f"{label}: step {i} of prefill + decode disagrees with the "
                 f"full forward (max abs {errs[-1]:.3e}, logits' scale "
                 f"{scale:.3e})")
    print(f"{label} prefill({P}) + {T} decode steps vs one forward over "
          f"{P + T} tokens (fp32, TF32 off{note}): max abs per step "
          f"{', '.join(f'{e:.2e}' for e in errs)}; logits' scale {scale:.3e} "
          f"(gate rtol {REC_RTOL}, atol {REC_ATOL} of scale) ok", flush=True)
    return max(errs), scale


def recurrent_phase(dev, card, npz):
    """Phase 9: recurrentgemma-2b (RG-LRU) and falcon-mamba-7b (Mamba-1)
    served at full width through the serve CLI, B6 (the linear scan) on
    their prefill recurrence, B1 on recurrentgemma's MLPs (the phase-3
    net).  The launch counts are set to 0 just before each serve and read
    just after; a recording wrapper around the ``ops.linear_scan`` that
    ``models/ssm.py`` calls keeps the first call at the prompt's length,
    which is then held bit for bit against the plain version and timed.
    On an analog serve a recording wrapper around the B1 wrapper that the
    dispatcher calls keeps the first prefill call (M = batch x prompt) of
    each MLP shape (the gate/up projection, the down projection), held
    against the plain version at the fp32 gate and timed.  Then,
    digitally in fp32, prefill + ``REC_DECODE`` decode steps against one
    forward over the same tokens.  Returns the launches per arch, the
    path calls' errors, B1's path-call rows and one row per arch for the
    ``kernels`` line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA, RECURRENT
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.launch import serve
    lsm = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
    eb_ops = importlib.import_module("repro_torch.kernels.emulator_block.ops")
    out = {"b1": {}, "b1_err": 0.0, "b1_rows": [], "b6": {}, "b6_err": 0.0,
           "rows": []}
    B, G = REC_B, REC_G
    t_phase = time.perf_counter()
    for arch, layers, P, analog in REC_SERVES:
        argv = ["--arch", arch, "--layers", str(layers), "--batch", str(B),
                "--prompt-len", str(P), "--gen", str(G), "--seed", "0"]
        if analog:
            argv += ["--analog-backend", "emulator", "--emulator-params",
                     str(npz)]
        real = scan_ops.linear_scan
        path_calls = []

        def recording(a, b, h0=None, **kw):
            h, h_last = real(a, b, h0, **kw)
            if a.shape[1] == P and not path_calls:
                path_calls.append((a, b, h0, h))
            return h, h_last

        real_b1 = eb_ops.emulator_block_unified_cuda
        b1_calls = {}

        def recording_b1(aux, g_norm, u01, pos01, **kw):
            y = real_b1(aux, g_norm, u01, pos01, **kw)
            key = tuple(g_norm.shape)
            if u01.shape[0] == B * P and key not in b1_calls:
                b1_calls[key] = (aux, g_norm, u01, pos01, kw, y)
            return y

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        scan_ops.linear_scan = recording
        eb_ops.emulator_block_unified_cuda = recording_b1
        lsm.linear_scan_cuda.launches = 0
        eb.emulator_block_unified_cuda.launches = 0
        try:
            sess, res = serve.main(argv)
        finally:
            scan_ops.linear_scan = real
            eb_ops.emulator_block_unified_cuda = real_b1
        b6 = lsm.linear_scan_cuda.launches
        b1 = eb.emulator_block_unified_cuda.launches
        peak = torch.cuda.max_memory_allocated(dev)
        cfg = sess.cfg
        full = get_config(arch)
        n_rec = sum(k in (RECURRENT, MAMBA) for k in cfg.layer_kinds)
        n_sites = len(sess.sites())
        # one B6 launch a recurrent layer at prefill; with an executor, the
        # session's site discovery (a one-token digital forward) adds one
        # a layer more
        want_b6 = n_rec * (2 if analog else 1)
        want_b1 = n_sites * G
        print(f"[recurrent] {cfg.name}: d_model={cfg.d_model} d_ff={cfg.d_ff} "
              f"vocab={cfg.vocab_size} layers={cfg.num_layers} "
              f"({''.join(cfg.layer_kinds)}) sites={n_sites}; B6 launches {b6} "
              f"(expected {want_b6}), B1 launches {b1} (expected {want_b1})",
              flush=True)
        if (cfg.d_model, cfg.d_ff, cfg.vocab_size) != (
                full.d_model, full.d_ff, full.vocab_size):
            fail(f"{arch} was not served at full width")
        if b6 != want_b6 or not b6:
            fail(f"B6 launched {b6} times serving {arch}, expected {want_b6}")
        if b1 != want_b1 or (analog and not b1):
            fail(f"B1 launched {b1} times serving {arch}, expected {want_b1}")
        if res["tokens"].shape != (B, G) or not np_isfinite(res["logits"]):
            fail(f"{arch}: tokens {res['tokens'].shape} or non-finite logits")
        out["b6"][arch] = b6
        if analog:
            out["b1"][arch] = b1
            if len(b1_calls) != 2:
                fail(f"{arch}: B1 prefill calls recorded at "
                     f"{len(b1_calls)} MLP shapes, expected 2")
        for key, (aux, gn, u, pos, kw, y) in b1_calls.items():
            # the gate and up projections share a shape; down reads d_ff
            NB, NO, D, H, W = key
            tag = "mlp.down" if NB * D * H >= cfg.d_ff else "mlp.up"
            if kw.get("shift") is not None or kw.get("compute_dtype",
                                                     torch.float32) != torch.float32:
                fail(f"{arch} {tag}: B1 path call is not the fp32 ideal "
                     f"corner ({sorted(kw)})")
            a0, a1 = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a0.record()
            want = eb.emulator_block_unified_plain(aux, gn, u, pos)
            a1.record()
            torch.cuda.synchronize()
            pms = a0.elapsed_time(a1)
            label = (f"B1 {arch} {tag} path call M={u.shape[0]} "
                     f"NB={NB} NO={NO}")
            err = compare(label, y, want)
            out["b1_err"] = max(out["b1_err"], err)
            del want
            ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, gn, u, pos),
                         iters=3, warmup=1)
            O = aux["fcs"][-1][0].shape[1]
            flat = aux["fcs"][0][0].shape[0]
            nbytes, gemm, other = unified_work(u.shape[0], NB, NO, D, W, O,
                                               flat, None)
            bms, by = bound_ms(nbytes, (gemm + other, FP32_FLOP_S))
            print(f"[time] {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                  f"bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
                  f"{(gemm + other) / 1e9:.2f} GFLOP at fp32) [{card}]",
                  flush=True)
            out["b1_rows"].append(dict(
                shape=f"{arch} {tag} M={u.shape[0]} NB={NB} NO={NO}", ms=ms,
                plain_ms=pms, bound_ms=bms, bound_by=by, bytes=nbytes,
                flops=gemm + other, max_abs_err=err))
        b1_calls.clear()
        if not path_calls:
            fail(f"{arch}: no linear_scan call at the prompt's length")
        a, b, h0, h = path_calls.pop()
        b0 = None if h0 is None else lsm.fold_h0(a, b, h0)
        t0 = time.perf_counter()
        want = lsm.linear_scan_plain(a, b, b0)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = torch.equal(h, want)
        err = float((h.float() - want.float()).abs().max())
        out["b6_err"] = max(out["b6_err"], err)
        Bp, Sp, Dp = a.shape
        ms = cuda_ms(lambda: scan_ops.linear_scan(a, b, h0), iters=10)
        nbytes = 3 * Bp * Sp * Dp * a.element_size()
        bms, by = bound_ms(nbytes, (2 * Bp * Sp * Dp, FP32_FLOP_S))
        pre_ms = res["prefill_s"] * 1e3
        dec_ms = res["decode_s"] * 1e3 / (G - 1)
        share = n_rec * ms / pre_ms
        print(f"[recurrent] {arch} B6 path call ({Bp}, {Sp}, {Dp}) "
              f"{str(a.dtype).split('.')[-1]} h0={'yes' if h0 is not None else 'none'}: "
              f"bit-equal to the plain version {equal} (max_abs {err:.3e}); "
              f"{ms:.4f} ms, bound {bms:.4f} ms ({by}: {nbytes / 1e9:.3f} GB), "
              f"plain {plain_ms:.1f} ms (host clock); {n_rec} launches "
              f"{100 * share:.1f}% of prefill [{card}]", flush=True)
        if not equal:
            fail(f"{arch}: B6's path call is not bit-equal to its plain version")
        print(f"[recurrent] {arch} serve {B}x{P} + {G - 1} decode steps: "
              f"prefill {pre_ms:.1f} ms ({B * P / res['prefill_s']:.0f} tok/s), "
              f"decode {dec_ms:.2f} ms a step; peak memory {peak / 2**30:.2f} "
              f"GiB [{card}]", flush=True)
        del a, b, h0, h, b0, want
        # the same session again, warm; then once more under the profiler,
        # for the breakdown of PERF.md section 5
        warm = sess.generate()
        wpre_ms = warm["prefill_s"] * 1e3
        wdec_ms = warm["decode_s"] * 1e3 / (G - 1)
        traced, wall_ms, busy_ms, top = profiled(sess.generate)
        print(f"[recurrent] {arch} warm serve: prefill {wpre_ms:.1f} ms "
              f"(B6 {100 * n_rec * ms / wpre_ms:.1f}% of it), decode "
              f"{wdec_ms:.2f} ms a step; under the profiler the card was "
              f"busy {busy_ms:.1f} of {wall_ms:.1f} ms [{card}]", flush=True)
        for name, t, n in top:
            print(f"[recurrent] {arch}   {t:9.3f} ms {n:5d}x  {name[:90]}",
                  flush=True)
        row = dict(arch=arch, layers=layers, batch=B, prompt=P, gen=G,
                   analog=analog, b6_launches=b6, b1_launches=b1,
                   shape=f"B6 {arch} path call B={Bp} S={Sp} D={Dp}",
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   share_of_prefill=share, prefill_ms=pre_ms,
                   decode_ms_step=dec_ms, warm_prefill_ms=wpre_ms,
                   warm_decode_ms_step=wdec_ms, profiled_ms=wall_ms,
                   device_busy_ms=busy_ms,
                   top_kernels=top, peak_gib=peak / 2**30)
        del sess, res, warm, traced
        torch.cuda.empty_cache()

        row["consistency_max_abs"], row["logits_scale"] = _decode_vs_forward(
            dev, cfg, B, P, 900, f"[recurrent] {arch}")
        out["rows"].append(row)
        torch.cuda.empty_cache()
    print(f"[recurrent] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# phase 10's engine serve: gemma3-1b at full width, depth 2, its MLPs on
# the phase-3 net; 16 requests with prompt lengths drawn from the seed in
# [16, 64], 16 new tokens each, through an 8-slot engine (max_len 96,
# 16-position pages), submitted in two waves of 8 through the async server
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PAGE = 8, 96, 16
SERVE_N, SERVE_WAVE, SERVE_NEW, SERVE_PROMPT = 16, 8, 16, (16, 64)
SERVE_MID_TICK = 8           # the tick whose rows are decoded one at a time
SERVE_TURNS = 2              # telemetry off / on runs, in turns
SERVE_PACKED = 4             # requests through the packed engine
# (f): falcon-mamba-7b, digital, full width, depth 2, through a 4-slot
# engine: 8 requests, prompts in [64, 256], 8 new tokens each
REC_ENGINE = dict(arch="falcon-mamba-7b", layers=2, slots=4, n=8,
                  prompt=(64, 256), new=8)


def _row_cache(cache, i):
    """Row ``i`` of an engine cache as a batch-1 cache (copies): the
    stacked periods' leaves are (n_periods, B, ...), the tail's (B, ...)."""
    def walk(node, axis):
        if isinstance(node, dict):
            return {k: walk(v, axis) for k, v in node.items()}
        return node.narrow(axis, i, 1).clone()
    return {"scan": walk(cache["scan"], 1), "tail": walk(cache["tail"], 0)}


def _hist_quantile(series, q):
    """The upper edge of the bucket that holds quantile ``q`` of a snapshot
    histogram series (Prometheus' reading; +Inf past the last edge)."""
    buckets, counts = series["buckets"], series["bucket_counts"]
    need, run = q * series["count"], 0
    for edge, c in zip(list(buckets) + [float("inf")], counts):
        run += c
        if run >= need:
            return edge
    return float("inf")


class _StepSpy:
    """Spy on a session's step functions, as an engine calls them: counts
    the prefill and decode calls, and keeps the inputs (each row's cache
    as a batch-1 cache) and logits of decode call ``SERVE_MID_TICK``."""

    def __init__(self, sess):
        self.sess, self.calls, self.mid = sess, {"prefill": 0, "decode": 0}, {}
        self.real = (sess._prefill_step, sess._decode_step)

    def install(self):
        real_pre, real_dec = self.real

        def prefill(params, b):
            self.calls["prefill"] += 1
            return real_pre(params, b)

        def decode(params, tok, cache, pos):
            self.calls["decode"] += 1
            if self.calls["decode"] != SERVE_MID_TICK:
                return real_dec(params, tok, cache, pos)
            self.mid["in"] = (tok.clone(), pos.clone())
            self.mid["rows"] = [_row_cache(cache, i)
                                for i in range(tok.shape[0])]
            logits, c = real_dec(params, tok, cache, pos)
            self.mid["logits"] = logits.clone()
            return logits, c

        self.sess._prefill_step, self.sess._decode_step = prefill, decode

    def remove(self):
        self.sess._prefill_step, self.sess._decode_step = self.real


def _against_sessions(sess, prompts, outs, new, states):
    """Each prompt through a batch-1 ``generate`` of ``sess`` on
    ``states``, against the engine's tokens ``outs``; prints and returns
    the mismatches."""
    import numpy as np
    import torch
    mism = []
    for i, (p, o) in enumerate(zip(prompts, outs)):
        sess.batch = {"tokens": torch.as_tensor(p[None], device=sess.device)}
        sess.P, sess.G = len(p), new
        ref = sess.generate(states=states)["tokens"][0]
        if not np.array_equal(ref, o):
            mism.append((i, ref.tolist(), o.tolist()))
    print(f"[serving] {sess.cfg.name} engine tokens equal batch-1 sessions "
          f"for {len(prompts) - len(mism)} of {len(prompts)} requests",
          flush=True)
    for i, ref, got in mism:
        print(f"[serving]   request {i}: session {ref} engine {got}",
              flush=True)
    return mism


def _tick_gap(sess, mid, states, card):
    """The largest |logit| gap between the recorded tick's rows and the
    same rows decoded one at a time (batch 1, from the same cache rows)."""
    import torch
    tok, pos = mid["in"]
    real_dec = sess._decode_step
    gaps = []
    for i in range(tok.shape[0]):
        with torch.no_grad(), sess._bound(states):
            li, _ = real_dec(sess.params, tok[i:i + 1], mid["rows"][i],
                             pos[i:i + 1])
        gaps.append(float((li[0] - mid["logits"][i]).abs().max()))
    scale = float(mid["logits"][:, :sess.cfg.vocab_size].abs().max())
    print(f"[serving] tick {SERVE_MID_TICK} (positions {pos.tolist()}): max "
          f"|logit| gap of its {tok.shape[0]} rows decoded one at a time "
          f"{max(gaps):.3e} of a {scale:.3e} scale (per row "
          f"{', '.join(f'{g:.2e}' for g in gaps)}); zero: {max(gaps) == 0.0} "
          f"[{card}]", flush=True)
    return max(gaps)


class _Ticks:
    """Spy on an engine's ``step``: each tick's host time (a tick ends with
    its argmax read to the host, so this is its whole time)."""

    def __init__(self, eng):
        self.ms, self._real = [], eng.step

        def step():
            t0 = time.perf_counter()
            out = self._real()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        eng.step = step


def _serve_waves(eng, prompts, new, wave, ticks):
    """Submit ``prompts`` through an ``AsyncBatchServer`` in waves of
    ``wave``, each after the engine has run 4 more ticks (the earlier
    waves still decoding); returns the tokens in submit order and the
    wall seconds from the first submit to the last result."""
    from repro_torch.launch.batching import AsyncBatchServer
    t0 = time.perf_counter()
    with AsyncBatchServer(eng) as srv:
        futs = []
        for k in range(0, len(prompts), wave):
            if k:
                mark, deadline = len(ticks.ms) + 4, time.time() + 300
                while len(ticks.ms) < mark and any(not f.done() for f in futs):
                    if time.time() > deadline:
                        fail("the engine made no progress for 300 s")
                    time.sleep(0.002)
            futs += [srv.submit(p, new) for p in prompts[k:k + wave]]
        outs = [f.result(timeout=900) for f in futs]
    return outs, time.perf_counter() - t0


def _engine_under_the_tuner(sess, states, prompts, outs, card):
    """Phase 10 (g): the first wave's requests through a fresh engine with
    the tuner at its default setting (``REPRO_AUTOTUNE`` unset: B1's row
    tile swept at each new shape, on a cache file of its own), then again
    with the swept tiles in memory; telemetry on in both.  The tokens
    must be (a)'s; returns each run's figures."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.emulator_block.emulator_block import (
        default_block_m)
    from repro_torch.launch.batching import ContinuousBatchEngine
    from repro_torch.obs import OBS, snapshot
    import numpy as np
    saved = {k: os.environ.pop(k, None)
             for k in ("REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE")}
    cache = ROOT / "build" / "chip_smoke_engine_tuned.json"
    cache.unlink(missing_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache)
    autotune.clear()
    runs = []
    try:
        for run in ("sweeping", "tiles in memory"):
            OBS.reset()
            OBS.enable()
            eng = ContinuousBatchEngine(sess, max_slots=SERVE_SLOTS,
                                        max_len=SERVE_MAX_LEN,
                                        page_size=SERVE_PAGE)
            eng.refresh_states(states)
            ticks = _Ticks(eng)
            n0 = eb.emulator_block_unified_cuda.launches
            got, wall = _serve_waves(eng, prompts[:SERVE_WAVE], SERVE_NEW,
                                     SERVE_WAVE, ticks)
            b1 = eb.emulator_block_unified_cuda.launches - n0
            if not all(np.array_equal(a, b) for a, b in zip(got, outs)):
                fail(f"[serving] (g) {run}: the tuner changed the tokens")
            met = snapshot()["metrics"]
            sw = met.get("autotune_sweep_seconds", {"series": []})["series"]
            tiles = {}
            for key, cfg in autotune._MEM.items():
                m = int(key.split("|")[2])
                tiles.setdefault((cfg["block_m"] == default_block_m(m)), []
                                 ).append(m)
            r = dict(run=run, wall_s=wall,
                     tokens_s=SERVE_WAVE * SERVE_NEW / wall,
                     tick_ms_median=float(np.median(ticks.ms)),
                     tick_ms_max=float(max(ticks.ms)), b1_launches=b1,
                     sweeps=int(sum(x["count"] for x in sw)),
                     sweep_s=float(sum(x["sum"] for x in sw)),
                     keys_default=len(tiles.get(True, [])),
                     keys_other=sorted(tiles.get(False, [])))
            runs.append(r)
            print(f"[serving] (g) tuner at its default, {run}: "
                  f"{SERVE_WAVE} requests in {wall:.3f} s, "
                  f"{r['tokens_s']:.1f} generated tokens/s, median tick "
                  f"{r['tick_ms_median']:.2f} ms (max {r['tick_ms_max']:.1f})"
                  f", {r['sweeps']} sweeps in {r['sweep_s']:.2f} s, B1 "
                  f"launches {b1} (sweeps' included); {len(autotune._MEM)} "
                  f"keys, {r['keys_default']} kept the default tile, the "
                  f"others at M = {r['keys_other']}; tokens equal to (a) "
                  f"[{card}]", flush=True)
    finally:
        OBS.disable()
        OBS.reset()
        autotune.clear()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return runs


def serving_phase(dev, card, npz):
    """Phase 10: the serving plane (``launch.batching``) at full width on
    the card, telemetry on.  (a) gemma3-1b (depth 2, MLPs on the phase-3
    net: 6 sites, B1 fp32) through an 8-slot ``ContinuousBatchEngine``,
    16 requests in two waves through ``AsyncBatchServer``; every request's
    tokens against a batch-1 ``ServeSession.generate`` of its prompt on
    the same params and states; one mid-run tick's logits against its
    rows decoded one at a time; the same two printed for a digital
    engine on the same params; B1's first tick call at each MLP shape
    (M = 8) held against its plain version.  (b) packed prefill: 4
    requests against packed-solo runs.  (c) a ``RecompileSentinel`` over
    (a).  (d) (a)'s snapshot and a ``ServeSession``'s through
    ``tools/check_telemetry.py`` (``serve`` / ``session`` profiles).  (e)
    the same requests with telemetry off, in turns with it on: the same
    tokens, and each run's tokens/s.  (f) falcon-mamba-7b (digital, depth
    2) through a 4-slot engine, bulk (B6 at each prefill, its first path
    call held bit for bit) against batch-1 sessions, packed with slot
    reuse against packed-solo runs.  (g) the first wave through a fresh
    engine with the tuner at its default setting, sweeping, then with its
    tiles in memory (``_engine_under_the_tuner``).  Returns B1's and B6's
    launches on the engine runs (a) and (f), their path-call errors and
    rows."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    import check_telemetry
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.interop import load_emulator_npz
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.launch.batching import ContinuousBatchEngine
    from repro_torch.launch.serve import ServeSession
    from repro_torch.obs import OBS, RecompileSentinel, snapshot, write_snapshot
    lsm = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
    eb_ops = importlib.import_module("repro_torch.kernels.emulator_block.ops")
    with open(ROOT / "tools" / "telemetry_schema.json") as f:
        schema = json.load(f)
    out = {"b1_err": 0.0, "b1_rows": [], "b6_err": 0.0, "rows": []}
    errors = []
    t_phase = time.perf_counter()

    # -- (a) the engine at full width, telemetry on ------------------------
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                     layers=("mlp",)),
                        geom=CASE_A, emulator_params=load_emulator_npz(npz, dev))
    sess = ServeSession("gemma3-1b", reduced=False, reduced_layers=2, batch=1,
                        prompt_len=SERVE_PROMPT[1], gen=SERVE_NEW, seed=0,
                        executor=ex, device=dev)
    cfg = sess.cfg
    if (cfg.d_model, cfg.d_ff, cfg.vocab_size) != (1152, 6912, 262144):
        fail("phase 10 did not serve gemma3-1b at full width")
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_N)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    eng = ContinuousBatchEngine(sess, max_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE)
    ticks = _Ticks(eng)
    n_sites = len(sess.sites())         # site discovery: a digital forward

    # spies: the model calls the engine makes, B1's first tick call at each
    # MLP shape, and the inputs and logits of one mid-run tick
    spy = _StepSpy(sess)
    real_b1 = eb_ops.emulator_block_unified_cuda
    b1_calls = {}

    def recording_b1(aux, g_norm, u01, pos01, **kw):
        y = real_b1(aux, g_norm, u01, pos01, **kw)
        key = tuple(g_norm.shape)
        if u01.shape[0] == SERVE_SLOTS and key not in b1_calls:
            b1_calls[key] = (aux, g_norm, u01, pos01, kw, y)
        return y

    OBS.reset()
    OBS.enable()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    spy.install()
    eb_ops.emulator_block_unified_cuda = recording_b1
    try:
        with RecompileSentinel(session=eng, executor=ex, strict=False,
                               label="engine") as sent:
            eng.refresh_states()
            eb.emulator_block_unified_cuda.launches = 0
            outs, wall = _serve_waves(eng, prompts, SERVE_NEW, SERVE_WAVE, ticks)
            b1 = eb.emulator_block_unified_cuda.launches
    finally:
        spy.remove()
        eb_ops.emulator_block_unified_cuda = real_b1
    peak = torch.cuda.max_memory_allocated(dev)
    snap = snapshot()
    want_b1 = n_sites * (spy.calls["prefill"] + spy.calls["decode"])
    n_ticks = len(ticks.ms)
    print(f"[serving] gemma3-1b d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} sites={n_sites}, "
          f"{SERVE_SLOTS} slots, max_len {SERVE_MAX_LEN}: {SERVE_N} requests "
          f"(prompts {min(lens)}-{max(lens)}, {SERVE_NEW} new tokens) in two "
          f"waves; {spy.calls['prefill']} bulk prefills, {spy.calls['decode']} batched "
          f"decode ticks ({n_ticks} engine steps); B1 launches {b1} (expected "
          f"{want_b1})", flush=True)
    if spy.calls["prefill"] != SERVE_N or b1 != want_b1 or not b1:
        fail(f"B1 launched {b1} times on the engine path, expected {want_b1} "
             f"({n_sites} sites x {spy.calls['prefill']} prefills + "
             f"{spy.calls['decode']} ticks)")
    if len(b1_calls) != 2:
        fail(f"B1 tick calls recorded at {len(b1_calls)} MLP shapes, expected 2")
    for key, (aux, gn, u, pos, kw, y) in b1_calls.items():
        NB, NO, D, H, W = key
        tag = "mlp.down" if NB * D * H >= cfg.d_ff else "mlp.up"
        if kw.get("shift") is not None or kw.get(
                "compute_dtype", torch.float32) != torch.float32:
            fail(f"engine {tag}: B1 tick call is not the fp32 ideal corner")
        want = eb.emulator_block_unified_plain(aux, gn, u, pos)
        label = f"B1 engine {tag} tick call M={u.shape[0]} NB={NB} NO={NO}"
        err = compare(label, y, want)
        out["b1_err"] = max(out["b1_err"], err)
        # the row tile is min(M, 128): a row's result should not depend on M
        alone = torch.cat([eb.emulator_block_unified_cuda(
            aux, gn, u[i:i + 1], pos[i:i + 1]) for i in range(u.shape[0])],
            dim=1)
        row_free = torch.equal(alone, y)
        print(f"[serving] {label}: each row launched alone (M = 1) bit-equal "
              f"to its row at M = {u.shape[0]}: {row_free}", flush=True)
        ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, gn, u, pos),
                     iters=10, warmup=2)
        pms = cuda_ms(lambda: eb.emulator_block_unified_plain(aux, gn, u, pos),
                      iters=3, warmup=1)
        O = aux["fcs"][-1][0].shape[1]
        flat = aux["fcs"][0][0].shape[0]
        nbytes, gemm, other = unified_work(u.shape[0], NB, NO, D, W, O, flat,
                                           None)
        bms, by = bound_ms(nbytes, (gemm + other, FP32_FLOP_S))
        print(f"[time] {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
              f"{bms:.4f} ms ({by}) [{card}]", flush=True)
        out["b1_rows"].append(dict(
            shape=f"engine {tag} M={u.shape[0]} NB={NB} NO={NO}", ms=ms,
            plain_ms=pms, bound_ms=bms, bound_by=by, bytes=nbytes,
            flops=gemm + other, max_abs_err=err, rows_alone_equal=row_free))
        del want, alone
    b1_calls.clear()
    out["b1"] = b1

    met = snap["metrics"]
    (ttft,) = met["serve_request_ttft_seconds"]["series"]
    (lat,) = met["serve_request_latency_seconds"]["series"]
    (occ,) = met["serve_batch_occupancy"]["series"]
    for s, m in ((ttft, "serve_request_ttft_seconds"),
                 (lat, "serve_request_latency_seconds")):
        s["buckets"] = met[m]["buckets"]
    reqs = [r for r in eng.requests.values() if r.status == "done"]
    exact_ttft = np.array([r.t_first - r.t_submit for r in reqs])
    exact_lat = np.array([r.t_done - r.t_submit for r in reqs])
    gen_tok = SERVE_N * SERVE_NEW
    row = dict(arch=cfg.name, layers=cfg.num_layers, slots=SERVE_SLOTS,
               max_len=SERVE_MAX_LEN, requests=SERVE_N, new=SERVE_NEW,
               prompts=[int(n) for n in lens], wall_s=wall,
               requests_s=SERVE_N / wall, tokens_s=gen_tok / wall,
               ttft_p50_le=_hist_quantile(ttft, 0.5),
               ttft_p90_le=_hist_quantile(ttft, 0.9),
               latency_p50_le=_hist_quantile(lat, 0.5),
               latency_p90_le=_hist_quantile(lat, 0.9),
               ttft_p50=float(np.percentile(exact_ttft, 50)),
               ttft_p90=float(np.percentile(exact_ttft, 90)),
               latency_p50=float(np.percentile(exact_lat, 50)),
               latency_p90=float(np.percentile(exact_lat, 90)),
               tick_ms_median=float(np.median(ticks.ms)),
               occupancy_mean=occ["sum"] / occ["count"],
               b1_launches=b1, peak_gib=peak / 2**30)
    print(f"[serving] engine: {wall:.3f} s, {row['requests_s']:.2f} requests/s, "
          f"{row['tokens_s']:.1f} generated tokens/s; TTFT p50 "
          f"{row['ttft_p50'] * 1e3:.1f} ms / p90 {row['ttft_p90'] * 1e3:.1f} ms "
          f"(histogram buckets le {row['ttft_p50_le']:g} / "
          f"{row['ttft_p90_le']:g} s); latency p50 {row['latency_p50'] * 1e3:.1f}"
          f" ms / p90 {row['latency_p90'] * 1e3:.1f} ms (le "
          f"{row['latency_p50_le']:g} / {row['latency_p90_le']:g} s); median "
          f"tick {row['tick_ms_median']:.2f} ms; mean occupancy "
          f"{row['occupancy_mean']:.2f} of {SERVE_SLOTS}; peak memory "
          f"{row['peak_gib']:.2f} GiB [{card}]", flush=True)

    # (c) no rebuild past the first: each watched count grew at most once
    worst = {}
    for k, v in sent.new_counts.items():
        kind = k.split("[")[0]
        worst[kind] = max(worst.get(kind, 0), v)
    print(f"[serving] sentinel over (a): most new builds per watched count "
          f"{worst}; ok {sent.ok}", flush=True)
    if not sent.ok:
        errors.append(f"the engine rebuilt past its first build: "
                      f"{sent.violations}")

    # (d) the engine's snapshot through the reference's checker
    snap_path = ROOT / "build" / "phase10_engine_telemetry.json"
    write_snapshot(str(snap_path))
    rc = check_telemetry.main([str(snap_path), "--profile", "serve"])
    if rc != 0:
        errors.append("the engine's telemetry snapshot fails the serve profile")

    # (a) each request against a batch-1 ServeSession on the same params
    # and states; then the mid-run tick against its rows one at a time
    states = eng._st()
    mism = _against_sessions(sess, prompts, outs, SERVE_NEW, states)
    if mism:
        errors.append(f"{len(mism)} engine requests differ from their "
                      "batch-1 sessions")
    row["tick_row_gap"] = _tick_gap(sess, spy.mid, states, card)

    # the same requests through a digital engine on the same params (no
    # executor: nothing couples a row to its batch-mates but the kernels)
    dsess = ServeSession("gemma3-1b", reduced=False, reduced_layers=2,
                         batch=1, prompt_len=SERVE_PROMPT[1], gen=SERVE_NEW,
                         device=dev, params=sess.params)
    dspy = _StepSpy(dsess)
    dspy.install()
    try:
        douts = ContinuousBatchEngine(
            dsess, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
            page_size=SERVE_PAGE).run(prompts, SERVE_NEW)
    finally:
        dspy.remove()
    print("[serving] the same requests, digital:", flush=True)
    row["digital_mismatches"] = len(_against_sessions(dsess, prompts, douts,
                                                      SERVE_NEW, {}))
    row["digital_tick_row_gap"] = _tick_gap(dsess, dspy.mid, {}, card)
    del dsess, dspy, douts

    # (d) a ServeSession's snapshot through the session profile
    OBS.reset()
    s1 = ServeSession("gemma3-1b", reduced=False, reduced_layers=2, batch=1,
                      prompt_len=len(prompts[0]), gen=SERVE_NEW, executor=ex,
                      device=dev, params=sess.params,
                      prompt=torch.as_tensor(prompts[0][None], device=dev))
    with RecompileSentinel(session=s1, executor=ex, strict=False,
                           label="session"):
        s1.generate(states=states)
    snap_path = ROOT / "build" / "phase10_session_telemetry.json"
    write_snapshot(str(snap_path))
    if check_telemetry.main([str(snap_path)]) != 0:
        errors.append("the session's telemetry snapshot fails the session "
                      "profile")
    del s1

    # (e) the same requests with telemetry off, in turns with it on
    tps = {"off": [], "on": []}
    for turn in range(SERVE_TURNS):
        for mode in ("off", "on"):
            OBS.reset()
            (OBS.enable if mode == "on" else OBS.disable)()
            e2 = ContinuousBatchEngine(sess, max_slots=SERVE_SLOTS,
                                       max_len=SERVE_MAX_LEN,
                                       page_size=SERVE_PAGE)
            e2.refresh_states(states)
            t2 = _Ticks(e2)
            o2, w2 = _serve_waves(e2, prompts, SERVE_NEW, SERVE_WAVE, t2)
            tps[mode].append(gen_tok / w2)
            if not all(np.array_equal(a, b) for a, b in zip(o2, outs)):
                errors.append(f"telemetry {mode} (turn {turn}) changed tokens")
            if mode == "off" and snapshot()["metrics"]:
                errors.append("telemetry off recorded metrics")
            del e2
    OBS.disable()
    OBS.reset()
    row["tokens_s_on"], row["tokens_s_off"] = tps["on"], tps["off"]
    print(f"[serving] generated tokens/s in turns, telemetry off "
          f"{', '.join(f'{v:.1f}' for v in tps['off'])}; on "
          f"{', '.join(f'{v:.1f}' for v in tps['on'])}; tokens equal to (a) "
          f"in every run [{card}]", flush=True)
    row["tuner_runs"] = _engine_under_the_tuner(sess, states, prompts, outs,
                                                card)

    # (b) packed prefill: batched against packed-solo runs
    ep = ContinuousBatchEngine(sess, max_slots=SERVE_SLOTS,
                               max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE,
                               prefill_mode="packed")
    ep.refresh_states(states)
    pk = prompts[:SERVE_PACKED]
    half = SERVE_PACKED // 2
    t0 = time.perf_counter()
    rids = [ep.submit(p, SERVE_NEW) for p in pk[:half]]
    for _ in range(int(min(lens[:half])) // 2):
        ep.step()
    rids += [ep.submit(p, SERVE_NEW) for p in pk[half:]]
    ep.drain()
    packed_s = time.perf_counter() - t0
    solo = [ep.run([p], SERVE_NEW)[0] for p in pk]
    same = [np.array_equal(ep.result(r), s) for r, s in zip(rids, solo)]
    print(f"[serving] packed engine: {SERVE_PACKED} requests (2 admitted "
          f"mid-prefill) in {packed_s:.3f} s; equal to packed-solo runs "
          f"{sum(same)} of {SERVE_PACKED}; bulk prefill builds "
          f"{ep.prefill_traces}, decode builds {ep.decode_traces}", flush=True)
    if not all(same) or ep.prefill_traces != 0 or ep.decode_traces != 1:
        errors.append("the packed engine differs from its packed-solo runs")
    del ep, eng, sess, ex, states
    torch.cuda.empty_cache()

    # -- (f) falcon-mamba-7b through a 4-slot engine, digital ---------------
    rc_ = REC_ENGINE
    fs = ServeSession(rc_["arch"], reduced=False, reduced_layers=rc_["layers"],
                      batch=1, prompt_len=rc_["prompt"][1], gen=rc_["new"],
                      seed=0, device=dev)
    fcfg = fs.cfg
    flens = rng.integers(rc_["prompt"][0], rc_["prompt"][1] + 1, rc_["n"])
    fprompts = [rng.integers(0, fcfg.vocab_size, n) for n in flens]
    fe = ContinuousBatchEngine(fs, max_slots=rc_["slots"],
                               max_len=rc_["prompt"][1] + rc_["new"])
    real_scan = scan_ops.linear_scan
    scan_calls = []

    def recording_scan(a, b, h0=None, **kw):
        h, h_last = real_scan(a, b, h0, **kw)
        if not scan_calls:
            scan_calls.append((a, b, h0, h))
        return h, h_last

    torch.cuda.reset_peak_memory_stats(dev)
    scan_ops.linear_scan = recording_scan
    try:
        lsm.linear_scan_cuda.launches = 0
        t0 = time.perf_counter()
        fouts = fe.run(fprompts, rc_["new"])
        torch.cuda.synchronize()
        f_wall = time.perf_counter() - t0
        b6 = lsm.linear_scan_cuda.launches
    finally:
        scan_ops.linear_scan = real_scan
    fpeak = torch.cuda.max_memory_allocated(dev)
    n_rec = fcfg.num_layers
    print(f"[serving] {fcfg.name} d_model={fcfg.d_model} vocab="
          f"{fcfg.vocab_size} layers={n_rec}: {rc_['n']} requests (prompts "
          f"{min(flens)}-{max(flens)}, {rc_['new']} new) through a "
          f"{rc_['slots']}-slot engine in {f_wall:.3f} s "
          f"({rc_['n'] * rc_['new'] / f_wall:.1f} generated tokens/s); B6 "
          f"launches {b6} (expected {n_rec * rc_['n']}); peak memory "
          f"{fpeak / 2**30:.2f} GiB [{card}]", flush=True)
    if b6 != n_rec * rc_["n"]:
        fail(f"B6 launched {b6} times on the engine path, expected "
             f"{n_rec * rc_['n']}")
    out["b6"] = b6
    a, b, h0, h = scan_calls.pop()
    b0 = None if h0 is None else lsm.fold_h0(a, b, h0)
    want = lsm.linear_scan_plain(a, b, b0)
    equal = torch.equal(h, want)
    out["b6_err"] = float((h.float() - want.float()).abs().max())
    ms = cuda_ms(lambda: scan_ops.linear_scan(a, b, h0), iters=10)
    Bp, Sp, Dp = a.shape
    nbytes = 3 * Bp * Sp * Dp * a.element_size()
    bms, by = bound_ms(nbytes, (2 * Bp * Sp * Dp, FP32_FLOP_S))
    print(f"[serving] B6 engine prefill call ({Bp}, {Sp}, {Dp}): bit-equal to "
          f"the plain version {equal}; {ms:.4f} ms, bound {bms:.4f} ms ({by}) "
          f"[{card}]", flush=True)
    if not equal:
        fail("B6's engine path call is not bit-equal to its plain version")
    out["rows"].append(dict(shape=f"B6 engine {fcfg.name} prefill B={Bp} "
                            f"S={Sp} D={Dp}", ms=ms, bound_ms=bms,
                            bound_by=by, max_abs_err=out["b6_err"]))
    del a, b, h0, h, b0, want
    fmism, frefs = [], []
    for i, (p, o) in enumerate(zip(fprompts, fouts)):
        fs.batch = {"tokens": torch.as_tensor(p[None], device=dev)}
        fs.P, fs.G = len(p), rc_["new"]
        frefs.append(fs.generate()["tokens"][0])
        if not np.array_equal(frefs[-1], o):
            fmism.append((i, frefs[-1].tolist(), o.tolist()))
    fp = ContinuousBatchEngine(fs, max_slots=rc_["slots"],
                               max_len=rc_["prompt"][1] + rc_["new"],
                               prefill_mode="packed")
    t0 = time.perf_counter()
    pouts = fp.run(fprompts, rc_["new"])
    p_wall = time.perf_counter() - t0
    psolo = [fp.run([p], rc_["new"])[0] for p in fprompts]
    # the packed contract (the reference's): packed equals packed-solo, the
    # slot reuse included; against the bulk sessions it is printed, since
    # a prompt fed one token a tick runs other products than its prefill
    pmism = [(i, s_.tolist(), p.tolist()) for i, (s_, p) in
             enumerate(zip(psolo, pouts)) if not np.array_equal(s_, p)]
    psess = [i for i, (r, p) in enumerate(zip(frefs, pouts))
             if not np.array_equal(r, p)]
    print(f"[serving] {fcfg.name}: bulk engine tokens equal batch-1 sessions "
          f"for {rc_['n'] - len(fmism)} of {rc_['n']}; packed engine (slot "
          f"reuse, rows zeroed at admission; {p_wall:.3f} s) equal to "
          f"packed-solo runs for {rc_['n'] - len(pmism)} of {rc_['n']}, to "
          f"the batch-1 (bulk) sessions for {rc_['n'] - len(psess)} of "
          f"{rc_['n']}", flush=True)
    for i, ref, got in fmism + pmism:
        print(f"[serving]   request {i}: alone {ref} engine {got}", flush=True)
    for i in psess:
        print(f"[serving]   request {i} packed: session {frefs[i].tolist()} "
              f"engine {pouts[i].tolist()}", flush=True)
    if fmism or pmism:
        errors.append(f"{fcfg.name}: {len(fmism)} bulk engine requests differ "
                      f"from their batch-1 sessions, {len(pmism)} packed ones "
                      "from their packed-solo runs")
    row.update(rec_arch=fcfg.name, rec_wall_s=f_wall,
               rec_tokens_s=rc_["n"] * rc_["new"] / f_wall,
               rec_packed_s=p_wall, rec_b6_launches=b6,
               rec_packed_vs_sessions_mismatches=len(psess),
               rec_peak_gib=fpeak / 2**30)
    out["rows"].insert(0, row)
    del fs, fe, fp
    torch.cuda.empty_cache()
    print(f"[serving] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if errors:
        fail("; ".join(errors))
    return out


# phase 11's sizes: the lifetime walk at full width on gemma3-1b's mlp.up
# (bench_lifetime's per-tile corner on its lattice); (b) at bench_lifetime's
# quick size; the sweep's sigma levels; the fleet campaign at
# bench_fleet's default size, its BASE corner and SLO rule
LIFE_TAG = "mlp.up"
LIFE_SMALL = (64, 8, 4)                # (K, N, B), calib_n 32
SWEEP_SIGMAS = (0.0, 0.02, 0.05, 0.1, 0.2)
SWEEP_DRAWS = 8
FLEET_N, FLEET_CHUNK, FLEET_SHAPE = 100_000, 256, (128, 16, 8)
FLEET_SLO_OVER_FLOOR = 2.0
FLEET_CHECK_N, FLEET_CHECK_CHUNK = 1_000, 64


def _fleet_scenario(nb, no):
    """bench_lifetime's per-tile aging corner on an (NB, NO) lattice: a
    programming-sigma gradient 0.02 -> 0.08 across output groups, stuck-off
    rate 0.04 and drift exponent 0.05 everywhere."""
    import numpy as np
    from repro_torch.nonideal import tile_scenarios
    sig = np.broadcast_to(np.linspace(0.02, 0.08, no), (nb, no))
    return tile_scenarios(nb, no, name="fleet", prog_sigma=sig,
                          p_stuck_off=0.04, drift_nu=0.05)


def _rel(y, ref):
    import torch
    return float(torch.linalg.norm(y.float() - ref) / torch.linalg.norm(ref))


def _walk(sched, w, tag, x, ref, label, card):
    """Drive a LifetimeScheduler checkpoint by checkpoint, printing the
    error against ``ref``, calib_n, whether it retrained, the fine-tune
    and materialization times and B1's launches; returns the records."""
    import torch
    from repro_torch.kernels.emulator_block import emulator_block as eb
    ex, recs = sched.ex, []
    steps = [("t0", 0.0)] + list(sched.timeline)
    for i, (lab, t) in enumerate(steps):
        eb.emulator_block_unified_cuda.launches = 0
        sched._ft_s = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            sched.deploy(w, tag)
        else:
            sched.step(w, tag, lab, t)
        y = ex.matmul(x, w, tag)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = sched.history[-1]
        tot, rem = ex.materialize_s.get(tag, (0.0, 0.0))
        rec = dict(label=lab, t=t, rel_err=_rel(y, ref),
                   calib_n=h["calib_n"], retrained=h["retrained"],
                   finetune_s=sched._ft_s, materialize_ms=tot * 1e3,
                   remap_ms=rem * 1e3, b1=eb.emulator_block_unified_cuda.launches,
                   wall_s=wall)
        recs.append(rec)
        print(f"[lifetime] {label} {lab}: rel err vs the ideal device "
              f"{rec['rel_err']:.5f}, calib_n {rec['calib_n']}, retrained "
              f"{rec['retrained']}, fine-tune {rec['finetune_s']:.2f} s, "
              f"state materialized in {rec['materialize_ms']:.1f} ms on the "
              f"host (remap {rec['remap_ms']:.1f} ms), B1 launches "
              f"{rec['b1']}, checkpoint {wall:.2f} s [{card}]", flush=True)
        if not all(map(np_isfinite, (rec["rel_err"],))):
            fail(f"lifetime {label} {lab}: non-finite error")
    return recs


def _stacked_vs_plain(label, aux, gn, u, pos, kw, y, C):
    """Hold B1's output ``y`` on C states stacked along NO against its plain
    version on each state's slice of the lattice; returns the max abs
    error."""
    from repro_torch.kernels.emulator_block import emulator_block as eb
    NB, NO = gn.shape[:2]
    no = NO // C
    sh = kw.get("shift")
    M = u.shape[0]
    yc = y.reshape(2, M, NB, C, no, -1)
    worst = 0.0
    for c in range(C):
        s_c = (None if sh is None or sh.dim() == 1 else
               sh.reshape(NB, C, no, -1)[:, c].reshape(NB * no, -1))
        want = eb.emulator_block_unified_plain(
            aux, gn[:, c * no:(c + 1) * no].contiguous(), u, pos,
            shift=sh if s_c is None else s_c.contiguous())
        worst = max(worst, compare(f"{label}, state {c}",
                                   yc[:, :, :, c].reshape(want.shape), want))
    return worst


def _timed_retrain(sched, fn):
    """Wrap a retrain callback to record its seconds on ``sched._ft_s``."""
    import torch

    def retrain(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = fn(*a)
        torch.cuda.synchronize()
        sched._ft_s += time.perf_counter() - t0
        return p

    return retrain


def lifetime_phase(dev, card, npz, cnpz):
    """Phase 11: fleet lifetime management and the fleet twin on the card.
    (a) the drift walk of gemma3-1b's full-width ``mlp.up`` under
    bench_lifetime's per-tile corner, unmitigated, with remap and
    recalibration, and mitigated (remap, recalibration, the noise-aware
    retrainer); (b) the field retrainer and
    the conditioned field calibrator at (64, 8, 4); (c) ``ScenarioSweep``
    at full width, stacked and one draw at a time; (d) the 10^5-device
    maintenance campaign at bench_fleet's size on the conditioned net,
    telemetry on; (e) ``ServeSession.calibrate`` on gemma3-1b at full
    width under ``stressed`` at one month.  Returns B1's launches per part
    and its path rows."""
    import numpy as np
    import torch
    from repro_torch import nonideal as NI
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core import prng
    from repro_torch.core.analog import AnalogExecutor, calibration_probes
    from repro_torch.core.circuit import CircuitParams
    from repro_torch.interop import load_emulator_npz
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.emulator_block import ops as eb_ops
    from repro_torch.launch.serve import ServeSession
    from repro_torch.obs import RecompileSentinel
    t_phase = time.perf_counter()
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    cp = CircuitParams()
    trained = load_emulator_npz(str(npz), dev)
    cond = load_emulator_npz(str(cnpz), dev)
    out = {"b1": {}, "b1_err": 0.0, "b1_rows": [], "rows": {}}
    errors = []

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    # -- (a) the drift walk at full width -----------------------------------
    t_a = time.perf_counter()
    K, N = GEMMA["d_model"], GEMMA["d_ff"]
    w = torch.randn((K, N), generator=gen(1101), device=dev) * K ** -0.5
    x = torch.randn((4, K), generator=gen(1102), device=dev)
    exi = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained)
    exi.calibrate(calibration_probes(prng.key(9), 128, K, dev), w, LIFE_TAG)
    ref = exi.matmul(x, w, LIFE_TAG).float()
    plan = exi._plan_for(w, LIFE_TAG)
    corner = _fleet_scenario(plan.NB, plan.NO)
    kf = prng.fold_in(prng.key(0), 2)
    walks = {}
    for mode in ("unmitigated", "remap+recalibrate", "mitigated"):
        ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained)
        mit = mode != "unmitigated"
        sched = NI.LifetimeScheduler(ex, corner, remap=mit, recalibrate=mit,
                                     key=kf, calib_n=128)
        if mode == "mitigated":
            sched.retrain = _timed_retrain(sched, NI.make_noise_aware_retrainer(
                CASE_A, acfg, cp, prng.key(4), n=4096, epochs=30))
        walks[mode] = _walk(sched, w, LIFE_TAG, x, ref,
                            f"(a) {mode} {LIFE_TAG} K={K} N={N}", card)
        print(f"[lifetime] (a) {mode}: plan builds per tag {ex.builds['plan']}",
              flush=True)
        if ex.builds["plan"] != {LIFE_TAG: 1}:
            errors.append(f"(a) {mode}: plan builds {ex.builds['plan']}, "
                          "expected 1 for the tag")
        del ex, sched
        torch.cuda.empty_cache()
    for mode in ("remap+recalibrate", "mitigated"):
        dom = [m["rel_err"] < u["rel_err"] for u, m in
               zip(walks["unmitigated"][1:], walks[mode][1:])]
        print(f"[lifetime] (a) {mode} lowers the error against the "
              f"unmitigated walk at every drift checkpoint: {all(dom)} {dom}",
              flush=True)
    out["b1"]["walk"] = sum(r["b1"] for v in walks.values() for r in v)
    out["rows"]["walk"] = walks
    print(f"[lifetime] (a) B1 launches {out['b1']['walk']}; "
          f"{time.perf_counter() - t_a:.1f} s [{card}]", flush=True)
    del exi, w, x, ref
    torch.cuda.empty_cache()

    # -- (b) the field retrainer and the conditioned field calibrator -------
    t_b = time.perf_counter()
    Ks, Ns, Bs = LIFE_SMALL
    w = torch.randn((Ks, Ns), generator=gen(1201), device=dev) * 0.2
    x = torch.randn((Bs, Ks), generator=gen(1202), device=dev) * 0.5
    exc = AnalogExecutor(AnalogConfig(enabled=True, backend="circuit",
                                      layers=("mlp",)), geom=CASE_A)
    exc.calibrate(calibration_probes(prng.key(9), 32, Ks, dev), w, "ref")
    ref = exc.matmul(x, w, "ref").float()       # the young ideal circuit
    sp = AnalogExecutor(acfg, geom=CASE_A,
                        emulator_params={})._plan_for(w, "probe")
    corner = _fleet_scenario(sp.NB, sp.NO)
    small = {}
    for mode, params, fn in (
            ("field", trained, NI.make_field_retrainer(prng.key(4))),
            ("conditioned", cond,
             NI.make_conditioned_field_calibrator(prng.key(5)))):
        ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params=params)
        sched = NI.LifetimeScheduler(ex, corner, key=kf, calib_n=32)
        sched.retrain = _timed_retrain(sched, fn)
        small[mode] = _walk(sched, w, "life", x, ref,
                            f"(b) {mode} K={Ks} N={Ns}", card)
        if mode == "conditioned" and [r["retrained"] for r in small[mode]] \
                != [True, False, False, False]:
            errors.append("(b) the conditioned walk retrained between "
                          f"checkpoints: {[r['retrained'] for r in small[mode]]}")
    for f, c in zip(small["field"], small["conditioned"]):
        print(f"[lifetime] (b) {f['label']}: per-checkpoint field fine-tunes "
              f"{f['rel_err']:.5f}, conditioned (deploy-only calibration) "
              f"{c['rel_err']:.5f} [{card}]", flush=True)
    out["b1"]["field_and_conditioned"] = sum(
        r["b1"] for v in small.values() for r in v)
    out["rows"]["small"] = small
    print(f"[lifetime] (b) took {time.perf_counter() - t_b:.1f} s", flush=True)
    del exc, ex, sched
    torch.cuda.empty_cache()

    # -- (c) ScenarioSweep at full width -------------------------------------
    t_c = time.perf_counter()
    w = torch.randn((K, N), generator=gen(1101), device=dev) * K ** -0.5
    x = torch.randn((4, K), generator=gen(1102), device=dev)
    ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained)
    ex.calibrate(calibration_probes(prng.key(9), 128, K, dev), w, LIFE_TAG)
    ideal = ex.matmul(x, w, LIFE_TAG).float()
    sweep = NI.ScenarioSweep(ex, w, LIFE_TAG, n_draws=SWEEP_DRAWS)
    skey = prng.key(11)
    curve = []
    eb.emulator_block_unified_cuda.launches = 0
    with RecompileSentinel(fns=(sweep,), strict=False,
                           label="sweep") as sent:
        for s in SWEEP_SIGMAS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = sweep(x, NI.Scenario(name="sw", prog_sigma=s), skey)
            torch.cuda.synchronize()
            errs = [_rel(y, ideal) for y in ys]
            curve.append(dict(sigma=s, mean_rel_err=float(np.mean(errs)),
                              ms=(time.perf_counter() - t0) * 1e3))
            if not all(map(np_isfinite, errs)):
                errors.append(f"(c) non-finite sweep error at sigma {s}")
    n_sweep = eb.emulator_block_unified_cuda.launches
    for r in curve:
        print(f"[lifetime] (c) sweep {LIFE_TAG} sigma {r['sigma']}: mean rel "
              f"err over {SWEEP_DRAWS} draws {r['mean_rel_err']:.5f}, "
              f"{r['ms']:.1f} ms [{card}]", flush=True)
    mono = all(a["mean_rel_err"] <= b["mean_rel_err"]
               for a, b in zip(curve, curve[1:]))
    sc = NI.Scenario(name="sw", prog_sigma=0.1, read_sigma=0.02)
    keys = prng.split(skey, SWEEP_DRAWS)
    real_b1 = eb_ops.emulator_block_unified_cuda
    rec = []

    def recording_b1(aux, g_norm, u01, pos01, **kw):
        y = real_b1(aux, g_norm, u01, pos01, **kw)
        rec.append((aux, g_norm, u01, pos01, kw, y))
        return y

    eb_ops.emulator_block_unified_cuda = recording_b1
    try:
        stacked = sweep.run(x, sc, keys)
    finally:
        eb_ops.emulator_block_unified_cuda = real_b1
    alone = torch.cat([sweep.run(x, sc, [k]) for k in keys])
    bit_equal = torch.equal(stacked, alone)
    aux, gn, u, pos, kw, y = rec[0]
    err = _stacked_vs_plain(f"B1 sweep {LIFE_TAG} {SWEEP_DRAWS} draws "
                            f"stacked NB={gn.shape[0]} NO={gn.shape[1]} "
                            f"M={u.shape[0]}", aux, gn, u, pos, kw, y,
                            SWEEP_DRAWS)
    out["b1_err"] = max(out["b1_err"], err)
    ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, gn, u, pos, **kw),
                 iters=5)
    nbytes, gemm, other = unified_work(u.shape[0], gn.shape[0], gn.shape[1],
                                       gn.shape[2], gn.shape[4], 1, 128, None)
    bms, by = bound_ms(nbytes, (gemm + other, FP32_FLOP_S))
    out["b1_rows"].append(dict(
        shape=f"sweep {LIFE_TAG} {SWEEP_DRAWS} draws M={u.shape[0]} "
        f"NB={gn.shape[0]} NO={gn.shape[1]}", ms=ms, bound_ms=bms,
        bound_by=by, max_abs_err=err))
    del rec[:], stacked, alone
    out["b1"]["sweep"] = n_sweep
    out["rows"]["sweep"] = dict(curve=curve, builds=sweep.builds,
                                monotone=mono, bit_equal=bit_equal, b1_ms=ms,
                                b1_bound_ms=bms)
    print(f"[lifetime] (c) sweep: builds {sweep.builds} (sentinel ok "
          f"{sent.ok}), mean error non-decreasing in sigma {mono}, B1 "
          f"launches {n_sweep} ({len(SWEEP_SIGMAS)} levels), stacked draws "
          f"bit-equal to one draw at a time {bit_equal}; the stacked B1 call "
          f"{ms:.3f} ms, bound {bms:.3f} ms ({by}); {time.perf_counter() - t_c:.1f}"
          f" s [{card}]", flush=True)
    if sweep.builds != 1 or not sent.ok:
        errors.append(f"(c) the sweep built {sweep.builds} times")
    if not mono:
        errors.append(f"(c) the sweep's mean error decreased with sigma: "
                      f"{[r['mean_rel_err'] for r in curve]}")
    if not bit_equal:
        errors.append("(c) the stacked sweep is not bit-equal to one draw "
                      "at a time")
    if n_sweep != len(SWEEP_SIGMAS):
        errors.append(f"(c) B1 launched {n_sweep} times for "
                      f"{len(SWEEP_SIGMAS)} sweep levels")
    del ex, sweep, w, x, ideal
    torch.cuda.empty_cache()

    # -- (d) the fleet campaign ----------------------------------------------
    fc = _fleet_campaign(dev, card, cond, errors)
    out["b1"]["fleet"] = fc["b1"]
    out["b1_err"] = max(out["b1_err"], fc["b1_err"])
    out["b1_rows"] += fc["b1_rows"]
    out["rows"]["fleet"] = fc["row"]

    # -- (e) ServeSession.calibrate on a served model -------------------------
    t_e = time.perf_counter()
    ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained)
    ex.deploy(scenario="stressed", key=prng.fold_in(prng.key(0), 0xDEF))
    sess = ServeSession("gemma3-1b", reduced=False, reduced_layers=2, batch=4,
                        prompt_len=32, gen=8, seed=0, executor=ex, device=dev)
    sess.calibrate(n=16)                       # at deployment: cold
    ex.deploy(age=2_592_000.0)
    eb.emulator_block_unified_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.calibrate(n=16, warm_start=True)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    n_cal = eb.emulator_block_unified_cuda.launches
    states = sess.states()
    r1 = sess.generate(states=states)
    r2 = sess.generate(states=states)
    n_serve = eb.emulator_block_unified_cuda.launches
    n_sites = len(sess.sites())
    same = bool(np.array_equal(r1["tokens"], r2["tokens"]))
    print(f"[lifetime] (e) gemma3-1b d_model={sess.cfg.d_model} layers="
          f"{sess.cfg.num_layers}, {n_sites} sites under stressed at 1 month: "
          f"warm calibration {cal_s:.3f} s ({ex._last_calib_n} probes a site, "
          f"{n_cal} B1 launches); prefill 4x32 {r1['prefill_s'] * 1e3:.1f} / "
          f"{r2['prefill_s'] * 1e3:.1f} ms, decode 7 steps "
          f"{r1['decode_s'] * 1e3:.1f} / {r2['decode_s'] * 1e3:.1f} ms; the "
          f"second run's tokens equal {same} [{card}]", flush=True)
    if sess.cfg.d_model != GEMMA["d_model"] or n_sites != 6:
        errors.append("(e) did not serve gemma3-1b at full width, 6 sites")
    if not same or not np_isfinite(r1["logits"]):
        errors.append("(e) the calibrated serve is not reproducible")
    if ex._last_calib_n != 8:
        errors.append(f"(e) warm calibration used {ex._last_calib_n} probes")
    out["b1"]["serve_calibrate"] = n_serve
    out["rows"]["serve"] = dict(calibrate_s=cal_s, prefill_ms=(
        r1["prefill_s"] * 1e3, r2["prefill_s"] * 1e3), decode_ms=(
        r1["decode_s"] * 1e3, r2["decode_s"] * 1e3), tokens_equal=same)
    del sess, ex, states
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"[lifetime] phase 11 took {secs:.1f} s; B1 launches {out['b1']}",
          flush=True)
    if errors:
        fail("; ".join(errors))
    return out


def _fleet_campaign(dev, card, cond, errors):
    """(d): bench_fleet's campaign on the conditioned net: the SLO floor
    on a 512-device subsample, ``MaintenancePlanner.plan`` (the surrogate
    fitted on 256 probed devices), ``simulate_policy`` for the never,
    always and planned policies, one chunk-step build across it
    (``RecompileSentinel``), telemetry on and its snapshot through the
    fleet profile; then 1,000 devices at chunk 256 against chunk 64, one
    timed full evaluation (B1 launches a chunk, devices/s), one chunk's
    draws and B1 calls timed, B1 at the stacked shape against its plain
    version and a device alone against its stacked blocks."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    import check_telemetry
    from repro_torch import fleet as FL
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core import prng
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.emulator_block import ops as eb_ops
    from repro_torch.nonideal import DEFAULT_TIMELINE, Scenario
    from repro_torch.obs import OBS, RecompileSentinel, snapshot
    t_d = time.perf_counter()
    K, N, B = FLEET_SHAPE
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    w = torch.randn((K, N), generator=g, device=dev) * 0.2
    x = torch.randn((B, K), generator=g, device=dev) * 0.5
    ages = [t for _, t in DEFAULT_TIMELINE]
    base = Scenario(name="fleet-base", prog_sigma=0.05, read_sigma=0.01,
                    p_stuck_off=0.02, drift_nu=0.04, drift_t=0.0)
    ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params=cond)
    if not ex.emulator_conditioned:
        errors.append("(d) the campaign's net is not conditioned")
    fkey = prng.fold_in(prng.key(0), 2)
    out = {"b1_err": 0.0}
    OBS.reset()
    OBS.enable()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)    # earlier phases' tensors
    eb.emulator_block_unified_cuda.launches = 0
    try:
        fleet = FL.Fleet(ex, w, "fleet", FL.FleetSpec(
            n_devices=FLEET_N, base=base, chunk=FLEET_CHUNK), key=fkey)
        t0 = time.perf_counter()
        with RecompileSentinel(fns=(fleet,), max_traces=1, strict=False,
                               label="fleet:chunk") as sent:
            probe_ids = np.arange(0, FLEET_N, max(1, FLEET_N // 512),
                                  dtype=np.int32)
            floor = fleet.evaluate(x, ages[0], ids=probe_ids,
                                   cal_age=ages[0])
            slo = FLEET_SLO_OVER_FLOOR * float(np.median(floor))
            planner = FL.MaintenancePlanner(fleet, ages,
                                            costs=FL.ActionCosts(), slo=slo,
                                            n_probe=256)
            t1 = time.perf_counter()
            plan = planner.plan(x)
            plan_s = time.perf_counter() - t1
            replays = {}
            for name, acts in (
                    ("never", FL.never_policy(FLEET_N, ages)),
                    ("always", FL.always_recalibrate_policy(FLEET_N, ages)),
                    ("plan", plan.actions)):
                t1 = time.perf_counter()
                replays[name] = FL.simulate_policy(fleet, x, ages, acts,
                                                   planner.costs, slo,
                                                   policy=name)
                replays[name + "_s"] = time.perf_counter() - t1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_campaign = eb.emulator_block_unified_cuda.launches
        snap = snapshot()
    finally:
        OBS.disable()
        OBS.reset()
    peak = torch.cuda.max_memory_allocated(dev)
    snap_path = ROOT / "build" / "phase11_fleet_telemetry.json"
    with open(snap_path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
    with open(ROOT / "tools" / "telemetry_schema.json") as f:
        schema = json.load(f)
    terrs = check_telemetry.check(snap, schema, profile="fleet")
    counts = {n: int((plan.actions == a).sum())
              for a, n in enumerate(FL.ACTION_NAMES)}
    dominates = [all(replays["plan"][i]["cost_adjusted_acc"]
                     >= replays[b][i]["cost_adjusted_acc"]
                     for b in ("never", "always")) for i in range(len(ages))]
    for i, (lab, _) in enumerate(DEFAULT_TIMELINE):
        cols = ", ".join(f"{p} {replays[p][i]['cost_adjusted_acc']:.5f} "
                         f"({replays[p][i]['violations']} violations, mean "
                         f"err {replays[p][i]['mean_err']:.5f})"
                         for p in ("never", "always", "plan"))
        print(f"[fleet] (d) {lab}: cost-adjusted accuracy {cols}", flush=True)
    finite = all(np_isfinite(r[k]) for p in ("never", "always", "plan")
                 for r in replays[p] for k in ("mean_err", "p95_err"))
    finite = finite and np_isfinite(floor)
    print(f"[fleet] (d) {FLEET_N} devices of ({K}, {N}), chunk {FLEET_CHUNK}, "
          f"the conditioned net: SLO {slo:.5f} (2x the median fresh error at "
          f"1h on {probe_ids.size} devices); plan actions {counts}, expected "
          f"cost {plan.expected_cost:.1f}, remap horizon {plan.remap_horizon},"
          f" surrogate pinball {planner.ranker.train_pinball:.6f}; the planner "
          f"matches or beats both baselines at every checkpoint: "
          f"{all(dominates)} {dominates}; campaign {wall:.1f} s (plan "
          f"{plan_s:.1f} s, replays never {replays['never_s']:.1f} / always "
          f"{replays['always_s']:.1f} / plan {replays['plan_s']:.1f} s), B1 "
          f"launches {n_campaign}; chunk-step builds {fleet.builds} "
          f"(sentinel ok {sent.ok}); peak memory {peak / 2**30:.2f} GiB, "
          f"{(peak - held) / 2**30:.2f} GiB over what was held before; "
          f"every error finite {finite}; telemetry snapshot, fleet profile: "
          f"{'ok' if not terrs else terrs} [{card}]", flush=True)
    if fleet.builds != 1 or not sent.ok:
        errors.append(f"(d) the chunk step was built {fleet.builds} times")
    if terrs:
        errors.append(f"(d) the campaign's snapshot fails the fleet profile: "
                      f"{terrs}")
    if not finite:
        errors.append("(d) a non-finite fleet error")

    # 1,000 devices at chunk 256 against chunk 64
    ids = np.arange(FLEET_CHECK_N, dtype=np.int32)
    small = FL.Fleet(ex, w, "fleet", FL.FleetSpec(
        n_devices=FLEET_N, base=base, chunk=FLEET_CHECK_CHUNK), key=fkey)
    eb.emulator_block_unified_cuda.launches = 0
    a = fleet.evaluate(x, ages[1], ids=ids, cal_age=ages[0])
    b = small.evaluate(x, ages[1], ids=ids, cal_age=ages[0])
    n_check = eb.emulator_block_unified_cuda.launches
    chunk_equal = bool(np.array_equal(a, b))
    print(f"[fleet] (d) {FLEET_CHECK_N} devices at chunk {FLEET_CHUNK} and "
          f"chunk {FLEET_CHECK_CHUNK} bit-equal: {chunk_equal} (max |diff| "
          f"{float(np.abs(a - b).max()):.3e})", flush=True)
    if not chunk_equal or not np_isfinite(a):
        errors.append("(d) devices differ between chunk sizes")

    # one timed full evaluation: seconds, devices/s, B1 launches a chunk
    n_chunks = -(-FLEET_N // FLEET_CHUNK)
    eb.emulator_block_unified_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = fleet.evaluate(x, ages[-1])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    n_full = eb.emulator_block_unified_cuda.launches
    per_chunk = n_full / n_chunks
    if not np_isfinite(full):
        errors.append("(d) a non-finite error in the full evaluation")
    if per_chunk != 2:
        errors.append(f"(d) B1 launched {per_chunk} times a chunk, expected 2")

    # one chunk's parts: its draws (host and card), its B1 calls, the whole
    st = fleet._step((B, K))
    cid = np.arange(FLEET_CHUNK, dtype=np.int32)
    cal = np.zeros(FLEET_CHUNK, np.float32)
    age_t = torch.full((FLEET_CHUNK,), ages[-1], device=dev)
    cal_t = torch.zeros((FLEET_CHUNK,), device=dev)
    draw_host = host_ms(lambda: fleet._draws(cid, cal), iters=5)
    draw_ms = cuda_ms(lambda: fleet._draws(cid, cal), iters=5)
    d = fleet._draws(cid, cal)
    chunk_ms = cuda_ms(lambda: fleet._errors(st, x, d, age_t, cal_t), iters=5)
    chunk_host = host_ms(lambda: fleet._errors(st, x, d, age_t, cal_t), iters=5)
    real_b1 = eb_ops.emulator_block_unified_cuda
    rec = []

    def recording_b1(aux, g_norm, u01, pos01, **kw):
        y = real_b1(aux, g_norm, u01, pos01, **kw)
        rec.append((aux, g_norm, u01, pos01, kw, y))
        return y

    eb_ops.emulator_block_unified_cuda = recording_b1
    try:
        fleet._errors(st, x, d, age_t, cal_t)
    finally:
        eb_ops.emulator_block_unified_cuda = real_b1
    b1_ms, rows = 0.0, []
    for part, (aux, gn, u, pos, kw, y) in zip(("fit", "serve"), rec):
        NB, NO = gn.shape[:2]
        label = (f"B1 fleet chunk {part} M={u.shape[0]} NB={NB} NO={NO} "
                 f"({FLEET_CHUNK} devices stacked)")
        # the launch's keywords less its row tile, which the plain
        # version has no use for
        err = compare(label, y, eb.emulator_block_unified_plain(
            aux, gn, u, pos, **{k: v for k, v in kw.items()
                                if k != "block_m"}))
        out["b1_err"] = max(out["b1_err"], err)
        # device 7 alone: its (NB, NO/256) slice of the stacked lattice
        no = NO // FLEET_CHUNK
        c = 7
        sh = kw.get("shift")
        sh_c = (None if sh is None else sh.reshape(NB, FLEET_CHUNK, no, -1)
                [:, c].reshape(NB * no, -1).contiguous())
        one = eb.emulator_block_unified_cuda(
            aux, gn[:, c * no:(c + 1) * no].contiguous(), u, pos, shift=sh_c)
        want = y.reshape(2, u.shape[0], NB, FLEET_CHUNK, no, -1)[:, :, :, c]
        alone_equal = torch.equal(one.reshape(want.shape), want)
        ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, gn, u, pos,
                                                            **kw), iters=10)
        b1_ms += ms
        nbytes, gemm, other = unified_work(u.shape[0], NB, NO, gn.shape[2],
                                           gn.shape[4], 1, 128, sh)
        bms, by = bound_ms(nbytes, (gemm + other, FP32_FLOP_S))
        print(f"[time] {label}: kernel {ms:.3f} ms, bound {bms:.4f} ms ({by}); "
              f"device {c} launched alone bit-equal to its stacked blocks "
              f"{alone_equal} [{card}]", flush=True)
        if not alone_equal:
            errors.append(f"(d) {label}: a device alone differs from its "
                          "stacked blocks")
        rows.append(dict(shape=f"fleet chunk {part} M={u.shape[0]} NB={NB} "
                         f"NO={NO}", ms=ms, bound_ms=bms, bound_by=by,
                         max_abs_err=err, device_alone_equal=alone_equal))
    del rec[:], d
    row = dict(devices=FLEET_N, chunk=FLEET_CHUNK, slo=slo,
               actions=counts, dominates=dominates,
               replays={p: replays[p] for p in ("never", "always", "plan")},
               campaign_s=wall, plan_s=plan_s, eval_s=eval_s,
               devices_per_s=FLEET_N / eval_s, b1_per_chunk=per_chunk,
               chunk_ms=chunk_ms, chunk_host_ms=chunk_host,
               draws_ms=draw_ms, draws_host_ms=draw_host, b1_chunk_ms=b1_ms,
               peak_gib=peak / 2**30, peak_over_held_gib=(peak - held) / 2**30,
               builds=fleet.builds,
               chunk_bit_equal=chunk_equal, campaign_b1=n_campaign)
    print(f"[fleet] (d) full evaluation of {FLEET_N} devices {eval_s:.2f} s "
          f"({FLEET_N / eval_s:.0f} devices/s), B1 launches a chunk "
          f"{per_chunk:g}; one chunk: card {chunk_ms:.3f} ms, host "
          f"{chunk_host:.3f} ms, of which B1 {b1_ms:.3f} ms (fit + serve) "
          f"and the draws card {draw_ms:.3f} / host {draw_host:.3f} ms; "
          f"(d) took {time.perf_counter() - t_d:.1f} s [{card}]", flush=True)
    out["row"] = row
    out["b1_rows"] = rows
    out["b1"] = n_campaign + n_check + n_full
    del fleet, small, ex
    torch.cuda.empty_cache()
    return out


# phase 12's training runs, random weights at full published widths:
# (a) gemma3-1b at full depth (26 layers), digital, bf16 compute, remat
# "full", 10 steps; (b) gemma3-1b cut to one stacked period (6 layers, every
# layer under remat, so B1 runs in the forward and again in its recompute),
# MLPs on the phase-3 net, fp32, 3 steps; (c) recurrentgemma-2b cut to one
# (R, R, L) period, digital, fp32, 3 steps; (d) the trainer on gemma3-1b at
# depth 2, digital, fp32, a checkpoint every 2 steps, a failure injected at
# step 3, 6 steps.  lr 1e-3 with a 2-step warmup (tests/test_substrates.py's
# TrainConfig: the default warmup of 100 would keep 10 steps near lr 0).
TRAIN_FULL = dict(arch="gemma3-1b", B=4, S=256, steps=10)
TRAIN_EMU = dict(arch="gemma3-1b", layers=6, B=4, S=32, steps=3)
TRAIN_REC = dict(arch="recurrentgemma-2b", layers=3, B=2, S=128, steps=3)
TRAIN_CKPT = dict(arch="gemma3-1b", layers=2, B=4, S=32, steps=6, fail_at=3)
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
# grad_accum=2 against 1 (fp32, a mask of equal counts): grads within
# rtol 1e-4 plus 1e-5 of each leaf's largest |grad|; grad_accum=2's train
# step against a step from the same state on the two microbatches' grads
# averaged by hand: the new params within rtol 1e-4
ACCUM_RTOL, ACCUM_ATOL_SHARE = 1e-4, 1e-5


def _to_dev(batch, dev):
    import torch
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.long() if k in ("tokens", "targets") else t).to(dev)
    return out


def _n_params(tree):
    from repro_torch.models.common import tree_leaves
    return sum(p.numel() for p in tree_leaves(tree))


def _timed_steps(step, state, data, dev, n):
    """``n`` steps from batch 0, each timed on the host clock around work
    ending in a synchronize; returns (state, losses, seconds)."""
    import torch
    losses, secs = [], []
    for t in range(n):
        batch = _to_dev(data.batch(t), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
    return state, losses, secs


def training_phase(dev, card, npz):
    """Phase 12: training on the card (``runtime.steps``, ``optim``,
    ``checkpoint``, ``runtime.trainer``), random weights at full widths
    (``TRAIN_*``).  The launch counts are set to 0 just before each run
    and read just after.  (a) full-depth gemma3-1b's loss falls; step ms,
    tokens/s, peak memory, the model-FLOPs share, the step split into
    gradient and update.  (b) B1 under autograd with a remat recompute:
    its launches (sites x 2 a step), its first training call held against
    the plain version, the straight-through products bit for bit, each
    step's plans built from the weights the previous step updated in
    place (against a fresh executor).  (c) B6's forward and backward
    launches; the backward's launch bit-equal to the plain version on the
    reversed inputs, one layer's input gradients against autograd of the
    plain loop, the backward timed beside its bound.  (d) the trainer
    recovers from an injected failure; checkpoint save and restore
    seconds; grad_accum=2 against 1 (grads gated) and its step against a
    step on the microbatches' grads averaged by hand (gated).
    Returns the launches, the held
    calls' errors and rows, and a summary row."""
    import dataclasses
    import shutil
    import statistics
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config, with_depth
    from repro_torch.configs.base import (AnalogConfig, ParallelConfig,
                                          TrainConfig)
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.analog import AnalogExecutor, _STMatmul
    from repro_torch.core.crossbar import build_conductance_plan
    from repro_torch.data import SyntheticLMData
    from repro_torch.interop import load_emulator_npz
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_items, tree_map, use_dense_hook
    from repro_torch.optim import adamw_update
    from repro_torch.runtime import steps as S
    from repro_torch.runtime.trainer import SimulatedFailure, Trainer
    lsm = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
    eb_ops = importlib.import_module("repro_torch.kernels.emulator_block.ops")
    out = {"b1": {}, "b1_err": 0.0, "b1_rows": [], "b6": {}, "b6_err": 0.0,
           "b6_rows": [], "row": {}}
    row = out["row"]
    t_phase = time.perf_counter()

    def tcfg_for(steps, **kw):
        return TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=steps, **kw)

    # -- (a) full-depth gemma3-1b, digital, bf16 -----------------------------
    a = TRAIN_FULL
    cfg = get_config(a["arch"])
    pcfg = ParallelConfig(compute_dtype="bfloat16", remat="full",
                          attn_block_kv=min(1024, a["S"]),
                          xent_chunk=min(2048, a["S"]))
    tcfg = tcfg_for(a["steps"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = S.init_train_state(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _n_params(state["params"])
    data = SyntheticLMData(cfg, a["S"], a["B"])
    step = S.make_train_step(cfg, pcfg, tcfg)
    state, losses, secs = _timed_steps(step, state, data, dev, a["steps"])
    peak = torch.cuda.max_memory_allocated(dev)
    first3, last3 = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not all(np.isfinite(losses)) or not last3 < first3:
        fail(f"full-depth {cfg.name}: the loss did not fall over "
             f"{a['steps']} steps ({losses})")
    step_s = statistics.median(secs[1:])
    tokens = a["B"] * a["S"]
    mfu = 6 * n_params * tokens / step_s / BF16_FLOP_S
    # one more step, split into the gradient and the update
    grad_fn = S.make_grad_fn(cfg, pcfg, tcfg)
    batch = _to_dev(data.batch(a["steps"]), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = grad_fn(state["params"], batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(state["params"], grads, state["opt"], state["step"], tcfg)
    torch.cuda.synchronize()
    grad_s, upd_s = t1 - t0, time.perf_counter() - t1
    # and one under the profiler: the card's busy time and its top kernels
    batch = _to_dev(data.batch(a["steps"] + 1), dev)
    _, wall_ms, busy_ms, top = profiled(lambda: step(state, batch))
    print(f"[train] (a) {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
          f"params; B={a['B']} S={a['S']} bf16, remat full; loss "
          f"{' '.join(f'{l:.4f}' for l in losses)} (first 3 {first3:.4f}, "
          f"last 3 {last3:.4f}); step {step_s * 1e3:.1f} ms (median of steps "
          f"2-{a['steps']}; step 1 {secs[0] * 1e3:.1f} ms), "
          f"{tokens / step_s:.0f} tokens/s, model-FLOPs share "
          f"{100 * mfu:.2f}% of 989 TFLOP/s; a step split: gradient "
          f"{grad_s * 1e3:.1f} ms, AdamW {upd_s * 1e3:.1f} ms; under the "
          f"profiler the card was busy {busy_ms:.1f} of {wall_ms:.1f} ms; "
          f"peak memory {peak / 2**30:.2f} GiB; init {init_s:.1f} s "
          f"[{card}]", flush=True)
    for name, t, n in top:
        print(f"[train] (a)   {t:9.3f} ms {n:5d}x  {name[:90]}", flush=True)
    row["full"] = dict(arch=cfg.name, layers=cfg.num_layers, params=n_params,
                       batch=a["B"], seq=a["S"], dtype="bfloat16",
                       remat="full", losses=losses, step_ms=step_s * 1e3,
                       first_step_ms=secs[0] * 1e3,
                       tokens_per_s=tokens / step_s, mfu=mfu,
                       grad_ms=grad_s * 1e3, adamw_ms=upd_s * 1e3,
                       profiled_ms=wall_ms, device_busy_ms=busy_ms,
                       top_kernels=top, peak_gib=peak / 2**30)
    del state, grads, batch, step, grad_fn
    torch.cuda.empty_cache()

    # -- (b) B1 under autograd with a remat recompute ------------------------
    b = TRAIN_EMU
    cfg = with_depth(get_config(b["arch"]), b["layers"])
    if cfg.num_periods != 1 or cfg.tail_kinds:
        fail(f"(b) {cfg.name} is not one stacked period")
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    trained = load_emulator_npz(str(npz), dev)
    ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained)
    pcfg = ParallelConfig(compute_dtype="float32", remat="full",
                          attn_block_kv=b["S"], xent_chunk=b["S"])
    tcfg = tcfg_for(b["steps"])
    state = S.init_train_state(0, cfg, dev)
    data = SyntheticLMData(cfg, b["S"], b["B"])
    step = S.make_train_step(cfg, pcfg, tcfg)
    n_sites = 3 * b["layers"]
    real_b1 = eb_ops.emulator_block_unified_cuda
    b1_calls = []
    in_step = [False]

    def recording_b1(aux, g_norm, u01, pos01, **kw):
        y = real_b1(aux, g_norm, u01, pos01, **kw)
        if in_step[0] and not b1_calls:
            b1_calls.append((aux, g_norm, u01, pos01, kw, y))
        return y

    def fresh_loss(params, batch):
        """The loss of a forward through a fresh executor (no grad: no
        remat, one B1 launch a site)."""
        fresh_ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained)
        with torch.no_grad(), use_dense_hook(fresh_ex.hook):
            return float(M.lm_loss(params, batch, cfg=cfg, pcfg=pcfg,
                                   compute_dtype=torch.float32,
                                   z_coef=tcfg.z_loss)[0])

    w_key = "['decoder']['scan']['p5']['ff']['w_up']"
    losses, plan_builds, fresh_err = [], [], []
    # B1's launches are read around each train step (the training count)
    # and around each fresh executor's forward (a check, kept apart)
    train_b1 = fresh_b1 = 0
    eb.emulator_block_unified_cuda.launches = 0
    eb_ops.emulator_block_unified_cuda = recording_b1
    try:
        with use_dense_hook(ex.hook):
            for t in range(b["steps"]):
                batch = _to_dev(data.batch(t), dev)
                w_before = dict(tree_items(state["params"]))[w_key][0].clone()
                n0 = eb.emulator_block_unified_cuda.launches
                fresh = fresh_loss(state["params"], batch)
                n1 = eb.emulator_block_unified_cuda.launches
                in_step[0] = True
                state, met = step(state, batch)
                in_step[0] = False
                n2 = eb.emulator_block_unified_cuda.launches
                fresh_b1 += n1 - n0
                train_b1 += n2 - n1
                losses.append(float(met["loss"]))
                plan_builds.append(sum(ex.builds["plan"].values()))
                fresh_err.append(abs(losses[-1] - fresh))
                # the last mlp.up call of the step (layer 5, in the
                # recompute) served a plan of the weights before this
                # step's update
                want_g = build_conductance_plan(w_before, acfg,
                                                CASE_A).g_norm
                if not torch.equal(ex._plans["mlp.up"][2].g_norm, want_g):
                    fail(f"(b) step {t}: mlp.up's plan is not the one of "
                         "the weights the step started from")
                if fresh_err[-1] > 1e-6 * abs(fresh):
                    fail(f"(b) step {t}: loss {losses[-1]} against a fresh "
                         f"executor's {fresh}")
    finally:
        eb_ops.emulator_block_unified_cuda = real_b1
    b1 = eb.emulator_block_unified_cuda.launches
    if b1 != train_b1 + fresh_b1:
        fail(f"(b) B1 launched {b1} times, {b1 - train_b1 - fresh_b1} of "
             "them outside the train steps and the fresh forwards")
    if train_b1 != b["steps"] * 2 * n_sites:
        fail(f"(b) B1 launched {train_b1} times in the train steps, "
             f"expected {b['steps'] * 2 * n_sites} ({b['steps']} steps x "
             f"{n_sites} sites x (forward + remat recompute))")
    if fresh_b1 != b["steps"] * n_sites:
        fail(f"(b) B1 launched {fresh_b1} times in the fresh executors' "
             f"forwards, expected {b['steps'] * n_sites} (one a site a step)")
    if any(b2 <= b1_ for b1_, b2 in zip(plan_builds, plan_builds[1:])):
        fail(f"(b) plan builds did not grow every step: {plan_builds}")
    if not all(np.isfinite(losses)):
        fail(f"(b) non-finite loss {losses}")
    aux, gn, u, pos, kw, y = b1_calls[0]
    NB, NO, D, H, W = gn.shape
    a0, a1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a0.record()
    want = eb.emulator_block_unified_plain(aux, gn, u, pos)
    a1.record()
    torch.cuda.synchronize()
    pms = a0.elapsed_time(a1)
    label = f"B1 training call (first, {cfg.name}) M={u.shape[0]} NB={NB} NO={NO}"
    err = compare(label, y, want)
    out["b1_err"] = err
    ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, gn, u, pos),
                 iters=3, warmup=1)
    O = aux["fcs"][-1][0].shape[1]
    flat = aux["fcs"][0][0].shape[0]
    nbytes, gemm, other = unified_work(u.shape[0], NB, NO, D, W, O, flat, None)
    bms, by = bound_ms(nbytes, (gemm + other, FP32_FLOP_S))
    out["b1_rows"].append(dict(shape=f"training {cfg.name} M={u.shape[0]} "
                               f"NB={NB} NO={NO}", ms=ms, plain_ms=pms,
                               bound_ms=bms, bound_by=by, bytes=nbytes,
                               flops=gemm + other, max_abs_err=err))
    del want, b1_calls[:]
    # the straight-through products, bit for bit
    p = dict(tree_items(state["params"]))
    w = p[w_key][0]
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    x2 = torch.randn((b["B"] * b["S"], w.shape[0]), generator=g,
                     device=dev).requires_grad_()
    wr = w.detach().clone().requires_grad_()
    st = ex.state_for("mlp.up", wr)
    y2 = _STMatmul.apply(ex, "mlp.up", x2, wr, st)
    ct = torch.randn(y2.shape, generator=g, device=dev)
    gx, gw = torch.autograd.grad(y2, (x2, wr), ct)
    st_equal = (torch.equal(gx, ct @ wr.detach().T)
                and torch.equal(gw, x2.detach().T @ ct))
    if not st_equal:
        fail("(b) the straight-through gradient is not ct @ w.T / x.T @ ct")
    print(f"[train] (b) {cfg.name} on the phase-3 net ({n_sites} MLP sites, "
          f"one stacked period under remat full), B={b['B']} S={b['S']} fp32: "
          f"loss {' '.join(f'{l:.4f}' for l in losses)}; B1 launches "
          f"{train_b1} in the train steps ({n_sites} sites x 2 a step, as "
          f"expected) + {fresh_b1} by the fresh executors; plan "
          f"builds after each step {plan_builds} (the 6 layers of a tag "
          f"share its cache entry, so each call builds); each step's "
          f"mlp.up plan is its starting weights', its loss within "
          f"{max(fresh_err):.2e} of a fresh executor's; straight-through "
          f"products bit-equal; {label}: {ms:.3f} ms, plain {pms:.3f} ms, "
          f"bound {bms:.3f} ms ({by}) [{card}]", flush=True)
    out["b1"] = {"training": train_b1, "fresh_forwards": fresh_b1}
    row["emulator"] = dict(arch=cfg.name, layers=b["layers"], sites=n_sites,
                           batch=b["B"], seq=b["S"], losses=losses,
                           b1_training_launches=train_b1,
                           b1_fresh_launches=fresh_b1,
                           plan_builds=plan_builds,
                           fresh_loss_err=max(fresh_err),
                           straight_through_bit_equal=st_equal)
    del state, ex, step, x2, wr, y2, gx, gw, p, w
    torch.cuda.empty_cache()

    # -- (c) recurrentgemma-2b: B6 forward and backward ----------------------
    c = TRAIN_REC
    cfg = with_depth(get_config(c["arch"]), c["layers"])
    pcfg = ParallelConfig(compute_dtype="float32", remat="full",
                          attn_block_kv=c["S"], xent_chunk=c["S"])
    tcfg = tcfg_for(c["steps"])
    n_rec = sum(k == "R" for k in cfg.layer_kinds)
    state = S.init_train_state(0, cfg, dev)
    data = SyntheticLMData(cfg, c["S"], c["B"])
    step = S.make_train_step(cfg, pcfg, tcfg)
    fn = scan_ops._LinearScan
    real_fwd, real_bwd = fn.forward, fn.backward
    real_ls = scan_ops.linear_scan
    n6 = {"forward": 0, "backward": 0}
    path = []

    def counted(name, real):
        """``real`` with B6's launches during it added to ``n6[name]``."""
        def run(*args):
            n0 = lsm.linear_scan_cuda.launches
            try:
                return real(*args)
            finally:
                n6[name] += lsm.linear_scan_cuda.launches - n0
        return staticmethod(run)

    def recording_ls(a_, b_, h0=None, **kw):
        if not path:
            path.append((a_.detach().clone(), b_.detach().clone(), h0))
        return real_ls(a_, b_, h0, **kw)

    lsm.linear_scan_cuda.launches = 0
    fn.forward = counted("forward", real_fwd)
    fn.backward = counted("backward", real_bwd)
    scan_ops.linear_scan = recording_ls
    try:
        state, losses, secs = _timed_steps(step, state, data, dev, c["steps"])
    finally:
        fn.forward, fn.backward = (staticmethod(real_fwd),
                                   staticmethod(real_bwd))
        scan_ops.linear_scan = real_ls
    b6 = lsm.linear_scan_cuda.launches
    want = {"forward": c["steps"] * n_rec * 2, "backward": c["steps"] * n_rec}
    if n6 != want or b6 != sum(n6.values()):
        fail(f"(c) B6 launched {n6['forward']} times in _LinearScan's "
             f"forward and {n6['backward']} in its backward ({b6} in all), "
             f"expected {want['forward']} / {want['backward']}")
    if not all(np.isfinite(losses)):
        fail(f"(c) non-finite loss {losses}")
    out["b6"] = dict(n6)
    del state, step
    torch.cuda.empty_cache()
    # one layer's recurrence (the first, at step 0): its backward
    a_, b_, h0 = path[0]
    if h0 is not None:
        fail("(c) the training recurrence got an h0")
    Bp, Sp, Dp = a_.shape
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    G = torch.randn(a_.shape, generator=g, device=dev)
    ar = a_.clone().requires_grad_()
    br = b_.clone().requires_grad_()
    calls = []
    real_scan = scan_ops._scan

    def recording_scan(*args):
        o = real_scan(*args)
        calls.append((args, o))
        return o

    scan_ops._scan = recording_scan
    try:
        h, _ = scan_ops.linear_scan(ar, br)
        da, db = torch.autograd.grad(h, (ar, br), G)
    finally:
        scan_ops._scan = real_scan
    (ra, rg, rb0), rout = calls[1]
    ea, eg = scan_ops.reverse_inputs(a_, G)
    p0, p1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    p0.record()
    plain_rev = lsm.linear_scan_plain(ea, eg)
    p1.record()
    torch.cuda.synchronize()
    plain_ms = p0.elapsed_time(p1)
    bwd_equal = (rb0 is None and torch.equal(ra, ea) and torch.equal(rg, eg)
                 and torch.equal(rout, plain_rev))
    if not bwd_equal:
        fail("(c) B6's backward launch is not bit-equal to the plain version "
             "on the reversed inputs")
    al = a_.clone().requires_grad_()
    bl = b_.clone().requires_grad_()
    hl = lsm.linear_scan_plain(al, bl)
    want_da, want_db = torch.autograd.grad(hl, (al, bl), G)
    err_a = compare(f"B6 backward da, one layer ({Bp}, {Sp}, {Dp}) vs "
                    "autograd of the plain loop", da, want_da)
    err_b = compare(f"B6 backward db, one layer ({Bp}, {Sp}, {Dp}) vs "
                    "autograd of the plain loop", db, want_db)
    out["b6_err"] = max(err_a, err_b)
    h, _ = scan_ops.linear_scan(ar, br)
    # the backward's own work (its Function's body) apart from the engine
    saved = types.SimpleNamespace(saved_tensors=(a_, h.detach()),
                                  has_b0=False,
                                  needs_input_grad=(True, True, False))
    bwd_ms, fn_ms, flip_ms, kern_ms, fwd_ms = paired_ms([
        lambda: torch.autograd.grad(h, (ar, br), G, retain_graph=True),
        lambda: scan_ops._LinearScan.backward(saved, G),
        lambda: (scan_ops.reverse_inputs(a_, G), rout.flip(1)),
        lambda: lsm.linear_scan_cuda(ea, eg),
        lambda: lsm.linear_scan_cuda(a_, b_)], iters=10)
    it = a_.element_size()
    nbytes = 5 * Bp * Sp * Dp * it         # read a, h, G; write da, db
    bms, by = bound_ms(nbytes, (3 * Bp * Sp * Dp, FP32_FLOP_S))
    print(f"[train] (c) {cfg.name} ({''.join(cfg.layer_kinds)}), B={c['B']} "
          f"S={c['S']} fp32, remat full: loss "
          f"{' '.join(f'{l:.4f}' for l in losses)}; B6 launches "
          f"{n6['forward']} in _LinearScan's forward ({n_rec} layers x "
          f"(forward + recompute) x {c['steps']} steps) + {n6['backward']} in "
          f"its backward; step "
          f"{statistics.median(secs) * 1e3:.1f} ms; the backward's launch "
          f"bit-equal to the plain version on the reversed inputs; backward "
          f"({Bp}, {Sp}, {Dp}) through the engine {bwd_ms:.4f} ms, its "
          f"Function's body {fn_ms:.4f} ms (its flips and the reversed a "
          f"{flip_ms:.4f} ms, the launch alone {kern_ms:.4f} ms; the forward "
          f"launch {fwd_ms:.4f} ms; the plain version on the reversed inputs "
          f"{plain_ms:.1f} ms), bound {bms:.4f} ms ({by}: "
          f"{nbytes / 1e6:.1f} MB) [{card}]", flush=True)
    out["b6_rows"].append(dict(
        shape=f"B6 backward {cfg.name} B={Bp} S={Sp} D={Dp}", ms=fn_ms,
        engine_ms=bwd_ms, flips_ms=flip_ms, kernel_ms=kern_ms,
        forward_kernel_ms=fwd_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, bytes=nbytes, max_abs_err=out["b6_err"],
        bit_equal=bwd_equal))
    row["recurrent"] = dict(arch=cfg.name, layers=c["layers"], batch=c["B"],
                            seq=c["S"], losses=losses,
                            step_ms=statistics.median(secs) * 1e3,
                            b6=out["b6"])
    del h, ar, br, da, db, al, bl, hl, want_da, want_db, calls, path
    torch.cuda.empty_cache()

    # -- (d) the trainer: checkpoints, an injected failure, grad_accum -------
    d = TRAIN_CKPT
    cfg = with_depth(get_config(d["arch"]), d["layers"])
    pcfg = ParallelConfig(compute_dtype="float32", attn_block_kv=d["S"],
                          xent_chunk=d["S"])
    tcfg = tcfg_for(d["steps"], checkpoint_every=2, keep_checkpoints=1)
    armed = [True]

    def fault(step_):
        if step_ == d["fail_at"] and armed[0]:
            armed[0] = False
            raise SimulatedFailure("injected")

    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="phase12_ckpt_", dir=ROOT / "build")
    try:
        tr = Trainer(cfg=cfg, pcfg=pcfg, tcfg=tcfg, mesh=None,
                     data=SyntheticLMData(cfg, d["S"], d["B"]),
                     ckpt_dir=ckdir, fault_hook=fault, device=dev)
        saves = []
        real_save = tr.ckpt.save

        def timed_save(state_, step_, extra=None):
            real_save(state_, step_, extra)
            saves.append(tr.ckpt.last_save_s)

        tr.ckpt.save = timed_save
        t0 = time.perf_counter()
        summary = tr.run(d["steps"])
        run_s = time.perf_counter() - t0
        write_s, restore_s = tr.ckpt.last_write_s, tr.ckpt.last_restore_s
        steps_run = [m["step"] for m in tr.metrics_log]
        with open(Path(ckdir) / f"step_{d['steps']:08d}" / "MANIFEST.json") as f:
            man = json.load(f)
        state_bytes = sum(int(np.prod(s)) * 4 for s in man["shapes"].values())
        if summary["restarts"] != 1 or summary["final_step"] != d["steps"]:
            fail(f"(d) the trainer did not recover: {summary}")
        # the failure comes while step fail_at - 1's save is being written:
        # the recovery resumes from it
        want_run = (list(range(d["fail_at"]))
                    + list(range(d["fail_at"] - 1, d["steps"])))
        if steps_run != want_run or tr.builds != 1 or not restore_s > 0:
            fail(f"(d) steps run {steps_run} (expected {want_run}), builds "
                 f"{tr.builds}, restore {restore_s} s")
        # grad_accum=2 against 1 on the restored state, a mask of equal counts
        state, _ = tr.ckpt.restore(S.abstract_train_state(cfg), device=dev)
        batch = _to_dev(tr.data.batch(0), dev)
        batch["mask"] = torch.ones_like(batch["mask"])
        l1, _, g1 = S.make_grad_fn(cfg, pcfg, tcfg)(state["params"], batch)
        l2, _, g2 = S.make_grad_fn(cfg, dataclasses.replace(pcfg, grad_accum=2),
                                   tcfg)(state["params"], batch)
        use = 0.0
        for (k, x1), (_, x2_) in zip(tree_items(g1), tree_items(g2)):
            tol = ACCUM_RTOL * x1.abs() + ACCUM_ATOL_SHARE * x1.abs().max()
            use = max(use, float(((x2_ - x1).abs() / tol.clamp_min(1e-30)).max()))
        lerr = abs(float(l2) - float(l1)) / abs(float(l1))
        if use > 1.0 or lerr > 1e-5:
            fail(f"(d) grad_accum=2 disagrees with 1: gate use {use:.2f}, "
                 f"loss rel {lerr:.2e}")
        del g1, g2
        # grad_accum=2's train step against its definition: a step from the
        # same state on the mean of the two microbatches' own grads
        # (grad_accum=1 each), taken by hand; each on copies of the state
        n = d["B"] // 2
        acc = None
        for i in range(2):
            _, _, gi = S.make_grad_fn(cfg, pcfg, tcfg)(
                state["params"], {k: v[i * n:(i + 1) * n]
                                  for k, v in batch.items()})
            gi = [x for _, x in tree_items(gi)]
            acc = gi if acc is None else [a + x for a, x in zip(acc, gi)]
        by_hand = S._unflatten(state["params"], [a / 2 for a in acc])
        del acc, gi

        def copy_of_state():
            return {"params": tree_map(torch.clone, state["params"]),
                    "opt": tree_map(torch.clone, state["opt"]),
                    "step": state["step"].clone()}

        stepped = copy_of_state()
        S.make_train_step(cfg, dataclasses.replace(pcfg, grad_accum=2),
                          tcfg)(stepped, batch)
        want_p = copy_of_state()
        adamw_update(want_p["params"], by_hand, want_p["opt"], state["step"],
                     tcfg)
        upd_use, upd_equal = 0.0, True
        for (k, got), (_, want) in zip(tree_items(stepped["params"]),
                                       tree_items(want_p["params"])):
            diff = (got - want).abs()
            upd_equal = upd_equal and bool(torch.equal(got, want))
            upd_use = max(upd_use, float((diff / (ACCUM_RTOL * want.abs())
                                          .clamp_min(1e-30)).max()))
        if upd_use > 1.0:
            fail(f"(d) grad_accum=2's step disagrees with the step on the "
                 f"microbatches' grads averaged by hand: {upd_use:.2f} of "
                 f"rtol {ACCUM_RTOL}")
        del state, batch, stepped, want_p, by_hand
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"[train] (d) Trainer on {cfg.name}, fp32, B={d['B']} S={d['S']}: "
          f"{summary}; steps run {steps_run}; {len(saves)} checkpoints of "
          f"{state_bytes / 1e9:.2f} GB: device-to-host "
          f"{', '.join(f'{s:.2f}' for s in saves)} s, the last write "
          f"{write_s:.2f} s, restore {restore_s:.2f} s; run {run_s:.1f} s; "
          f"grad_accum=2 against 1: grads within {use:.2f} of the gate "
          f"(rtol {ACCUM_RTOL} + {ACCUM_ATOL_SHARE} of each leaf's max), "
          f"loss rel {lerr:.1e}; its step's new params against a step on "
          f"the microbatches' grads averaged by hand {upd_use:.2f} of rtol "
          f"{ACCUM_RTOL} (bit-equal {upd_equal}) [{card}]", flush=True)
    row["trainer"] = dict(arch=cfg.name, summary=summary, steps_run=steps_run,
                          state_gb=state_bytes / 1e9, save_s=saves,
                          write_s=write_s, restore_s=restore_s, run_s=run_s,
                          accum_gate_use=use, accum_loss_rel=lerr,
                          accum_step_use=upd_use, accum_step_equal=upd_equal)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    row["phase_s"] = secs
    print(f"[train] phase 12 took {secs:.1f} s", flush=True)
    return out


# phase 13's serves, random weights at full published widths, depth cut:
# (arch, layers, batch, prompt, tokens, analog layers).  The dense archs'
# MLPs and the MoE archs' attention projections run on the phase-3 net
# (B1); the MoE archs' experts never call dense() and stay digital, as in
# the reference.  llama4-scout's 4 layers are one (C, C, C, G) period; its
# published chunk (8192) is longer than the prompt, so its serve never
# crosses a chunk (the CPU tests hold the boundary).
DEC_SERVES = (("qwen1.5-110b", 1, 2, 16, 4, "mlp"),
              ("command-r-plus-104b", 1, 2, 16, 4, "mlp"),
              ("deepseek-coder-33b", 2, 2, 16, 4, "mlp"),
              ("phi3.5-moe-42b-a6.6b", 2, 4, 32, 8, "attn"),
              ("llama4-scout-17b-a16e", 4, 4, 32, 8, "attn"))
# the plain version of B1 holds ~130 KB of per-plan tensors a block: at
# the 1.6 M-block sites it runs on column chunks of at most this many blocks
PLAIN_CHUNK_BLOCKS = 16_384


def _plain_by_columns(aux, gn, u, pos):
    """B1's plain version on ``gn`` (NB, NO, ...) in chunks of output
    columns of at most ``PLAIN_CHUNK_BLOCKS`` blocks: the same (2,
    M*NB*NO, O) rows as one call (M-major, the block ``nb*NO + no``
    innermost)."""
    import torch
    from repro_torch.kernels.emulator_block import emulator_block as eb
    NB, NO = gn.shape[:2]
    M = u.shape[0]
    step = max(1, PLAIN_CHUNK_BLOCKS // NB)
    outs = []
    for a in range(0, NO, step):
        b = min(NO, a + step)
        y = eb.emulator_block_unified_plain(aux, gn[:, a:b].contiguous(), u,
                                            pos)
        outs.append(y.reshape(2, M, NB, b - a, -1))
    return torch.cat(outs, dim=3).reshape(2, M * NB * NO, -1)


def _holding_every_assignment(cfg):
    """``cfg`` with an evaluation capacity of every token (factor E / K):
    no assignment is dropped, so a token's output does not depend on how
    many batch-mates its call has."""
    import dataclasses
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, eval_capacity_factor=m.num_experts / m.top_k))


def decoder_phase(dev, card, npz):
    """Phase 13: the dense and MoE decoder families (qwen1.5-110b,
    command-r-plus-104b, deepseek-coder-33b; phi3.5-moe-42b-a6.6b,
    llama4-scout-17b-a16e) served at full width through the serve CLI
    on the phase-3 net (``DEC_SERVES``).  B1's launch count is set to 0
    just before each serve and read just after (one launch a site a
    forward).  A recording wrapper around the B1 wrapper the dispatcher
    calls keeps the first prefill call and the first decode call (M =
    batch) of each site shape: the decode call is held against the plain
    version at the fp32 gate (in column chunks, ``_plain_by_columns``),
    and both are timed beside their bounds.  A wrapper around
    ``models.moe.slots`` counts the routed assignments dropped at
    prefill.  Then, digitally in fp32, prefill + ``REC_DECODE`` decode
    steps against one forward over the same tokens (an MoE arch at a
    capacity that holds every assignment: a token's output depends on
    its batch-mates through the capacity).  Returns B1's launches per
    arch, its largest error, its rows and one row per serve."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod
    eb_ops = importlib.import_module("repro_torch.kernels.emulator_block.ops")
    out = {"b1": {}, "b1_err": 0.0, "b1_rows": [], "rows": []}
    t_phase = time.perf_counter()
    for arch, layers, B, P, G, analog in DEC_SERVES:
        t_serve = time.perf_counter()
        argv = ["--arch", arch, "--layers", str(layers), "--batch", str(B),
                "--prompt-len", str(P), "--gen", str(G), "--seed", "0",
                "--analog-backend", "emulator", "--emulator-params", str(npz),
                "--analog-layers", analog]
        real_b1, real_slots = eb_ops.emulator_block_unified_cuda, moe_mod.slots
        calls = {}
        routed = []

        def recording_b1(aux, g_norm, u01, pos01, **kw):
            y = real_b1(aux, g_norm, u01, pos01, **kw)
            key = (u01.shape[0], tuple(g_norm.shape[:2]))
            if u01.shape[0] in (B, B * P) and key not in calls:
                calls[key] = (aux, g_norm, u01, pos01, kw, y)
            return y

        def recording_slots(expert_idx, E, C):
            slot, keep = real_slots(expert_idx, E, C)
            if expert_idx.shape[0] == B * P:
                routed.append(keep)
            return slot, keep

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        eb_ops.emulator_block_unified_cuda = recording_b1
        moe_mod.slots = recording_slots
        eb.emulator_block_unified_cuda.launches = 0
        try:
            sess, res = serve.main(argv)
        finally:
            eb_ops.emulator_block_unified_cuda = real_b1
            moe_mod.slots = real_slots
        b1 = eb.emulator_block_unified_cuda.launches
        peak = torch.cuda.max_memory_allocated(dev)
        plan_b, held_b = sess.ex.cache_bytes()
        cfg, full = sess.cfg, get_config(arch)
        sites = sess.sites()
        n_weights = sum(w.numel() for w in sites.values())
        want_b1 = len(sites) * G
        pre_ms = res["prefill_s"] * 1e3
        dec_ms = res["decode_s"] * 1e3 / (G - 1)
        dropped = (float(sum(int((~k).sum()) for k in routed))
                   / max(1, sum(k.numel() for k in routed)))
        print(f"[decoders] {cfg.name}: d_model={cfg.d_model} d_ff={cfg.d_ff} "
              f"vocab={cfg.vocab_size} layers={cfg.num_layers} "
              f"({''.join(cfg.layer_kinds)}) sites={len(sites)} ({analog}, "
              f"{n_weights / 1e9:.3f} G analog weights); B1 launches {b1} "
              f"(expected {want_b1})", flush=True)
        if (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_heads) != (
                full.d_model, full.d_ff, full.vocab_size, full.num_heads):
            fail(f"{arch} was not served at full width")
        if not b1 or b1 != want_b1:
            fail(f"B1 launched {b1} times serving {arch}, expected {want_b1}")
        if res["tokens"].shape != (B, G) or not np_isfinite(res["logits"]):
            fail(f"{arch}: tokens {res['tokens'].shape} or non-finite logits")
        if cfg.moe is not None and not routed:
            fail(f"{arch}: no MoE routing recorded at prefill")
        # the site shapes: (NB, NO) -> the tags of that shape, and the
        # number of sites of each
        rows_a_block = sess.ex.acfg.rows * sess.ex.geom.tiles
        shapes, n_of = {}, {}
        for sk, w in sites.items():
            nbno = (-(-w.shape[0] // rows_a_block), w.shape[1])
            shapes.setdefault(nbno, set()).add(sk.split(":")[-1].split("#")[0])
            n_of[nbno] = n_of.get(nbno, 0) + 1
        if {k[1] for k in calls} != set(shapes) or len(calls) != 2 * len(shapes):
            fail(f"{arch}: B1 calls recorded at {sorted(calls)}, expected a "
                 f"prefill and a decode call at each of {sorted(shapes)}")
        b1_rows, b1_ms = [], {}
        for (m, (NB, NO)), (aux, gn, u, pos, kw, y) in sorted(calls.items()):
            tag = "/".join(sorted(shapes[(NB, NO)]))
            if kw.get("shift") is not None or kw.get(
                    "compute_dtype", torch.float32) != torch.float32:
                fail(f"{arch} {tag}: B1 call is not the fp32 ideal corner")
            label = f"B1 {arch} {tag} M={m} NB={NB} NO={NO}"
            pms, err = None, None
            if m == B:                       # the decode call: held
                a0, a1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                a0.record()
                want = _plain_by_columns(aux, gn, u, pos)
                a1.record()
                torch.cuda.synchronize()
                pms = a0.elapsed_time(a1)
                err = compare(label + " (decode call)", y, want)
                out["b1_err"] = max(out["b1_err"], err)
                del want
            ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, gn, u, pos),
                         iters=3 if m == B else 1, warmup=1)
            b1_ms[(m, NB, NO)] = ms
            D, W = gn.shape[2], gn.shape[4]
            O = aux["fcs"][-1][0].shape[1]
            flat = aux["fcs"][0][0].shape[0]
            nbytes, gemm, other = unified_work(m, NB, NO, D, W, O, flat, None)
            bms, by = bound_ms(nbytes, (gemm + other, FP32_FLOP_S))
            print(f"[time] {label}: kernel {ms:.3f} ms, plain "
                  f"{'not run' if pms is None else f'{pms:.3f} ms (column chunks)'}"
                  f", bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
                  f"{(gemm + other) / 1e9:.2f} GFLOP at fp32) [{card}]",
                  flush=True)
            b1_rows.append(dict(
                shape=f"{arch} {tag} M={m} NB={NB} NO={NO}", ms=ms,
                plain_ms=pms, bound_ms=bms, bound_by=by, bytes=nbytes,
                flops=gemm + other, max_abs_err=err))
        calls.clear()
        out["b1"][arch] = b1
        out["b1_rows"].extend(b1_rows)
        # B1's share: each site launches once a forward at its shape's time
        per_fwd = {m: sum(b1_ms[(m,) + k] * n for k, n in n_of.items())
                   for m in (B, B * P)}
        print(f"[decoders] {arch} serve {B}x{P} + {G - 1} decode steps: "
              f"prefill {pre_ms:.1f} ms (B1 {per_fwd[B * P]:.1f} ms of it), "
              f"decode {dec_ms:.2f} ms a step (B1 {per_fwd[B]:.2f} ms); "
              f"plans {plan_b / 1e9:.2f} GB, executor caches "
              f"{held_b / 1e9:.2f} GB ({held_b / max(1, n_weights):.1f} B an "
              f"analog weight); peak memory {peak / 2**30:.2f} GiB"
              + (f"; {100 * dropped:.2f}% of routed assignments dropped at "
                 f"prefill" if cfg.moe is not None else "")
              + f" [{card}]", flush=True)
        row = dict(arch=arch, layers=layers, batch=B, prompt=P, gen=G,
                   analog_layers=analog, sites=len(sites),
                   analog_weights=n_weights, b1_launches=b1,
                   prefill_ms=pre_ms, decode_ms_step=dec_ms,
                   b1_prefill_ms=per_fwd[B * P], b1_decode_ms=per_fwd[B],
                   plan_gb=plan_b / 1e9, held_gb=held_b / 1e9,
                   peak_gib=peak / 2**30,
                   dropped_share=dropped if cfg.moe is not None else None)
        del sess, res, routed
        torch.cuda.empty_cache()

        moe = cfg.moe is not None
        row["consistency_max_abs"], row["logits_scale"] = _decode_vs_forward(
            dev, _holding_every_assignment(cfg) if moe else cfg, B, P, 901,
            f"[decoders] {arch}",
            ", capacity of every assignment" if moe else "")
        row["serve_s"] = time.perf_counter() - t_serve
        out["rows"].append(row)
        torch.cuda.empty_cache()
        print(f"[decoders] {arch} took {row['serve_s']:.1f} s", flush=True)
    print(f"[decoders] phase 13 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# phase 14's serves, random weights at full published widths on the
# phase-3 net (B1): (arch, decoder layers or None for the published depth,
# batch, prompt, tokens, analog layers).  internvl2-76b's 256 image
# positions and 16 text tokens make its prompt; its MLPs are qwen's class,
# which phase 13 measures, so its analog sites are the vision projection
# and the attention.  seamless-m4t-large-v2 runs whole (24 encoder + 24
# decoder layers), one frame a prompt position.
FRONT_SERVES = (("internvl2-76b", 1, 1, 272, 8, "frontend.proj,attn"),
                ("seamless-m4t-large-v2", None, 2, 32, 8, "mlp,attn"))


def _prefill_only(cfg, site_key):
    """A site that launches B1 at prefill alone: the vision projection,
    the encoder's, and the cross attention's k / v projections of the
    encoder's output (decode reads them from the cross cache).  Every
    other site launches once a forward."""
    tag = site_key.split(":")[-1]
    return (site_key.startswith(("frontend.", "enc."))
            or (cfg.encoder_layers > 0 and tag in ("attn.k#1", "attn.v#1")))


def frontend_phase(dev, card, npz):
    """Phase 14: the frontend archs (internvl2-76b's vision stub,
    seamless-m4t-large-v2's encoder and cross attention) served at full
    width through the serve CLI on the phase-3 net (``FRONT_SERVES``).
    B1's launch count is set to 0 just before each serve and read just
    after, and must equal what the sites imply (``_prefill_only``: once,
    else once a forward).  A recording wrapper around the B1 wrapper the
    dispatcher calls counts the calls at each (M, site shape) and keeps
    every decode call (M = batch; inputs and output copied): each is held
    against the plain version at the fp32 gate after the serve (in
    column chunks, ``_plain_by_columns``); the first call at each (M,
    shape) is timed beside its bound.  Then, digitally in fp32, prefill +
    ``REC_DECODE`` decode steps against one forward over the same tokens,
    the same image embeddings or frames given to both.  Returns B1's
    launches per arch, its largest error, its rows and one row per
    serve."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.launch import serve
    eb_ops = importlib.import_module("repro_torch.kernels.emulator_block.ops")
    out = {"b1": {}, "b1_err": 0.0, "b1_rows": [], "rows": []}
    t_phase = time.perf_counter()
    for arch, layers, B, P, G, analog in FRONT_SERVES:
        t_serve = time.perf_counter()
        argv = (["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
                 "--gen", str(G), "--seed", "0", "--analog-backend",
                 "emulator", "--emulator-params", str(npz), "--analog-layers",
                 analog] + (["--layers", str(layers)] if layers else []))
        real_b1 = eb_ops.emulator_block_unified_cuda
        counts, first, decode_calls = {}, {}, []

        def recording_b1(aux, g_norm, u01, pos01, **kw):
            y = real_b1(aux, g_norm, u01, pos01, **kw)
            key = (u01.shape[0], tuple(g_norm.shape[:2]))
            counts[key] = counts.get(key, 0) + 1
            first.setdefault(key, (aux, g_norm, u01, pos01, kw))
            if u01.shape[0] == B:
                decode_calls.append((key, g_norm, u01.clone(), pos01.clone(),
                                     y.clone()))
            return y

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        eb_ops.emulator_block_unified_cuda = recording_b1
        eb.emulator_block_unified_cuda.launches = 0
        try:
            sess, res = serve.main(argv)
        finally:
            eb_ops.emulator_block_unified_cuda = real_b1
        b1 = eb.emulator_block_unified_cuda.launches
        peak = torch.cuda.max_memory_allocated(dev)
        held_calls = sum(t.numel() * t.element_size()
                         for c in decode_calls for t in c[2:])
        plan_b, held_b = sess.ex.cache_bytes()
        cfg, full = sess.cfg, get_config(arch)
        sites = sess.sites()
        n_weights = sum(w.numel() for w in sites.values())
        once = sum(_prefill_only(cfg, sk) for sk in sites)
        want_b1 = once + (len(sites) - once) * G
        pre_ms = res["prefill_s"] * 1e3
        dec_ms = res["decode_s"] * 1e3 / (G - 1)
        print(f"[frontends] {cfg.name}: d_model={cfg.d_model} d_ff={cfg.d_ff} "
              f"vocab={cfg.vocab_size} heads={cfg.num_heads}/"
              f"{cfg.num_kv_heads} decoder layers={cfg.num_layers} encoder "
              f"layers={cfg.encoder_layers} frontend={cfg.frontend}"
              + (f" ({cfg.frontend_tokens} image positions)"
                 if cfg.frontend == "vision" else "")
              + f"; sites={len(sites)} ({analog}; {once} at prefill alone; "
              f"{n_weights / 1e9:.3f} G analog weights); B1 launches {b1} "
              f"(expected {once} + {len(sites) - once} x {G} = {want_b1})",
              flush=True)
        widths = ("d_model", "d_ff", "vocab_size", "num_heads",
                  "num_kv_heads", "head_dim", "frontend_tokens",
                  "encoder_layers")
        if any(getattr(cfg, f) != getattr(full, f) for f in widths) or (
                layers is None and cfg.num_layers != full.num_layers):
            fail(f"{arch} was not served at its published widths and depth")
        if not b1 or b1 != want_b1 or sum(counts.values()) != b1:
            fail(f"B1 launched {b1} times serving {arch} ({sum(counts.values())}"
                 f" calls recorded), expected {want_b1}")
        if res["tokens"].shape != (B, G) or not np_isfinite(res["logits"]):
            fail(f"{arch}: tokens {res['tokens'].shape} or non-finite logits")
        if any(kw.get("shift") is not None or kw.get(
                "compute_dtype", torch.float32) != torch.float32
               for *_, kw in first.values()):
            fail(f"{arch}: a B1 call is not the fp32 ideal corner")
        # the site shapes: (NB, NO) -> the tags of that shape
        rows_a_block = sess.ex.acfg.rows * sess.ex.geom.tiles
        shapes = {}
        for sk, w in sites.items():
            nbno = (-(-w.shape[0] // rows_a_block), w.shape[1])
            shapes.setdefault(nbno, set()).add(sk.split(":")[-1])
        n_dec = sum(n for (m, _), n in counts.items() if m == B)
        if len(decode_calls) != n_dec or n_dec != (len(sites) - once) * (G - 1):
            fail(f"{arch}: {len(decode_calls)} decode calls kept, "
                 f"{n_dec} counted")
        # every decode call against the plain version
        errs, plain = {}, {}
        for key, gn, u, pos, y in decode_calls:
            a0, a1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a0.record()
            want = _plain_by_columns(first[key][0], gn, u, pos)
            a1.record()
            err = (y - want).abs()
            if not bool((err <= ATOL + RTOL * want.abs()).all()) or not bool(
                    torch.isfinite(y).all()):
                fail(f"{arch}: a B1 decode call at (M, (NB, NO)) = {key} "
                     f"disagrees with its plain version beyond rtol {RTOL} / "
                     f"atol {ATOL} (max abs {float(err.max()):.3e})")
            errs[key] = max(errs.get(key, 0.0), float(err.max()))
            if key not in plain:
                torch.cuda.synchronize()
                plain[key] = a0.elapsed_time(a1)
            del want, err
        for key in sorted(errs):
            print(f"[kernel vs plain] B1 {arch} decode calls at M={key[0]} "
                  f"(NB, NO)={key[1]} ({'/'.join(sorted(shapes[key[1]]))}): "
                  f"{counts[key]} calls, max_abs={errs[key]:.3e} (gate rtol "
                  f"{RTOL}, atol {ATOL}) ok", flush=True)
        out["b1_err"] = max([out["b1_err"]] + list(errs.values()))
        del decode_calls
        # the first call at each (M, shape) timed beside its bound
        b1_rows, b1_ms = [], {}
        for (m, (NB, NO)), (aux, gn, u, pos, kw) in sorted(first.items()):
            tags = "/".join(sorted(shapes[(NB, NO)]))
            ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, gn, u, pos),
                         iters=3 if m == B else 1, warmup=1)
            b1_ms[(m, NB, NO)] = ms
            D, W = gn.shape[2], gn.shape[4]
            O = aux["fcs"][-1][0].shape[1]
            flat = aux["fcs"][0][0].shape[0]
            nbytes, gemm, other = unified_work(m, NB, NO, D, W, O, flat, None)
            bms, by = bound_ms(nbytes, (gemm + other, FP32_FLOP_S))
            pms = plain.get((m, (NB, NO)))
            print(f"[time] B1 {arch} {tags} M={m} NB={NB} NO={NO}: kernel "
                  f"{ms:.3f} ms ({counts[(m, (NB, NO))]} calls), plain "
                  f"{'not run' if pms is None else f'{pms:.3f} ms (column chunks)'}"
                  f", bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
                  f"{(gemm + other) / 1e9:.2f} GFLOP at fp32) [{card}]",
                  flush=True)
            b1_rows.append(dict(
                shape=f"{arch} {tags} M={m} NB={NB} NO={NO}", ms=ms,
                plain_ms=pms, bound_ms=bms, bound_by=by, bytes=nbytes,
                flops=gemm + other, calls=counts[(m, (NB, NO))],
                max_abs_err=errs.get((m, (NB, NO)))))
        first.clear()
        out["b1"][arch] = b1
        out["b1_rows"].extend(b1_rows)
        # B1's share: each call at its (M, shape)'s time
        b1_pre = sum(b1_ms[(m,) + k] * n for (m, k), n in counts.items()
                     if m != B)
        b1_dec = sum(b1_ms[(m,) + k] * n for (m, k), n in counts.items()
                     if m == B) / (G - 1)
        print(f"[frontends] {arch} serve {B}x{P} + {G - 1} decode steps: "
              f"prefill {pre_ms:.1f} ms (B1 {b1_pre:.1f} ms of it), decode "
              f"{dec_ms:.2f} ms a step (B1 {b1_dec:.2f} ms); plans "
              f"{plan_b / 1e9:.2f} GB, executor caches {held_b / 1e9:.2f} GB "
              f"({held_b / max(1, n_weights):.1f} B an analog weight); peak "
              f"memory {peak / 2**30:.2f} GiB (of it {held_calls / 2**30:.2f} "
              f"GiB of decode calls kept for the check) [{card}]", flush=True)
        row = dict(arch=arch, layers=cfg.num_layers,
                   encoder_layers=cfg.encoder_layers, batch=B, prompt=P,
                   gen=G, analog_layers=analog, sites=len(sites),
                   prefill_only_sites=once, analog_weights=n_weights,
                   b1_launches=b1, prefill_ms=pre_ms, decode_ms_step=dec_ms,
                   b1_prefill_ms=b1_pre, b1_decode_ms=b1_dec,
                   plan_gb=plan_b / 1e9, held_gb=held_b / 1e9,
                   peak_gib=peak / 2**30, kept_calls_gib=held_calls / 2**30)
        del sess, res
        torch.cuda.empty_cache()

        # prefill + decode == one forward, digital, fp32, the same
        # image embeddings or frames given to both
        g = torch.Generator(device=dev)
        g.manual_seed(902)
        n = cfg.frontend_tokens if cfg.frontend == "vision" else P
        key = "image_embeds" if cfg.frontend == "vision" else "enc_frames"
        inputs = {key: torch.randn((B, n, cfg.d_model), generator=g,
                                   device=dev)}
        row["consistency_max_abs"], row["logits_scale"] = _decode_vs_forward(
            dev, cfg, B, P, 902, f"[frontends] {arch}", f", the same {key}",
            inputs)
        row["serve_s"] = time.perf_counter() - t_serve
        out["rows"].append(row)
        del inputs
        torch.cuda.empty_cache()
        print(f"[frontends] {arch} took {row['serve_s']:.1f} s", flush=True)
    print(f"[frontends] phase 14 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def profiled(fn, n_top=8):
    """Run ``fn`` under ``torch.profiler``; return its result, its host
    time (ms, from before the call to after a synchronize), the card's
    busy time within it (ms, the sum of the device-side events: kernels
    and copies) and the ``n_top`` of those by device time as (name, ms,
    count).  The host-side operators that launched them are left out:
    they carry their kernels' device time too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return result, wall_ms, sum(r[1] for r in rows), rows[:n_top]


def attention_pairs(S, causal, window):
    """Unmasked (query, key) pairs of one head of length S."""
    import numpy as np
    q = np.arange(S)
    hi = q + 1 if causal else np.full(S, S)                   # keys k < hi
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def entry_points_phase(dev, card):
    """Phase 8: B4, B5 and B6 launched through their ``ops`` entry points
    at full model widths and at a ragged shape, fp32 and bf16, with the
    launch counts set to 0 just before each call and read just after;
    each output held against the plain version, then timed.  Returns the
    three kernels' records for the ``kernels`` line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.xbar_mac.ops import xbar_mac
    xm = importlib.import_module("repro_torch.kernels.xbar_mac.xbar_mac")
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    lsm = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
    gen = torch.Generator(device=dev)
    gen.manual_seed(700)
    dtypes = (("fp32", torch.float32, RTOL, ATOL, FP32_FLOP_S),
              ("bf16", torch.bfloat16, BF16_RTOL, BF16_ATOL, BF16_FLOP_S))

    def shape_row(shape, dname, ms, pms, lms, nbytes, ops, peak,
                  fp32_rate=None, **extra):
        """One timed shape, with its ratio to the library call where there
        is one.  ``fp32_rate``: the rate the kernel's fp32 mode runs its
        products at (3xTF32 for B4 and B5); the fp32 row's bound is taken
        at that rate, with the one at fp32's CUDA-core rate beside it."""
        tf32x3 = fp32_rate is not None and dname == "fp32"
        rate = fp32_rate if tf32x3 else peak
        bms, by = bound_ms(nbytes, (ops, rate))
        note = ""
        if tf32x3:
            extra["bound_rate"] = "3xTF32, 495/3 = 165 TFLOP/s"
            extra["bound_ms_fp32_cores"] = bound_ms(nbytes, (ops, peak))[0]
            note = (f"; at fp32's CUDA-core {peak / 1e12:.0f} TFLOP/s "
                    f"{extra['bound_ms_fp32_cores']:.4f} ms")
        if lms is not None:
            extra["vs_library"] = ms / lms
            note += f"; kernel / library {ms / lms:.2f}x"
        print(f"[time] {shape} {dname}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"library {'none' if lms is None else f'{lms:.4f} ms'}, bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
              f"GFLOP at {rate / 1e12:.0f} TFLOP/s{note}) [{card}]", flush=True)
        return dict(shape=shape, dtype=dname, ms=ms, plain_ms=pms,
                    library_ms=lms, bound_ms=bms, bound_by=by, bytes=nbytes,
                    flops=ops, peak_tflop_s=rate / 1e12, **extra)

    # -- B4: a gemma3-1b MLP projection as one nonlinear crossbar MAC ------
    d_model, d_ff = GEMMA["d_model"], GEMMA["d_ff"]
    cases = [("ragged", 100, 70, 130),
             ("ragged, split K, element-wise staging", 5, 1001, 77),
             ("ragged, split K", 100, d_model, 1000),
             ("gemma3-1b mlp.up", 4, d_model, d_ff),
             ("gemma3-1b mlp.up", 128, d_model, d_ff),
             ("gemma3-1b mlp.up", 2048, d_model, d_ff),
             ("gemma3-1b mlp.down", 128, d_ff, d_model)]
    launches, err, shapes = 0, 0.0, []
    for dname, dt, rtol, atol, peak in dtypes:
        for label, M, K, N in cases:
            # v ~ U(0, 0.2) drives relu(v - 0.08) * (1 + 0.6 v) = 0.0395 on
            # average; g ~ U(0, g_hi) puts gain * acc / v_sat near 0.8, in
            # tanh's working range rather than its saturation
            v = (0.2 * torch.rand((M, K), generator=gen, device=dev)).to(dt)
            g_hi = 2 * 0.8 / (3200.0 * K * 0.0395)
            g = (g_hi * torch.rand((K, N), generator=gen, device=dev)).to(dt)
            xm.xbar_mac_cuda.launches = 0
            got = xbar_mac(v, g)
            torch.cuda.synchronize()
            launches += xm.xbar_mac_cuda.launches
            want = xm.xbar_mac_plain(v, g)
            shape = f"B4 {label} ({M}, {K}) @ ({K}, {N})"
            plan = xm.launch_plan(M, K, N)
            if dname == "fp32":
                print(f"[B4] {shape}: launch plan {plan}", flush=True)
            err = max(err, compare(f"{shape} {dname}", got.float(), want.float(),
                                   rtol, atol))
            vf = v.float()
            drive = torch.clamp_min(vf - 0.08, 0.0) * (1.0 + 0.6 * vf)
            med = float((3200.0 * (drive @ g.float())).abs().median())
            print(f"[B4] {shape} {dname}: median |gain * acc / v_sat| {med:.3f}",
                  flush=True)
            it = 20 if M * K * N < 1e9 else 5
            dl = drive.to(dt)
            ms, lms = paired_ms([lambda: xbar_mac(v, g),
                                 lambda: torch.matmul(dl, g)], iters=it)
            pms = cuda_ms(lambda: xm.xbar_mac_plain(v, g), iters=it)
            shapes.append(shape_row(
                shape, dname, ms, pms, lms,
                (M * K + K * N + M * N) * v.element_size(),
                2 * M * K * N + 5 * M * K + 4 * M * N, peak,
                fp32_rate=TF32X3_FLOP_S,
                median_gain_acc=med, plan=plan,
                library="torch.matmul(drive, g): cuBLAS, the product alone"))
            del v, g, got, want, drive, dl
    head = next(r for r in shapes if r["shape"].startswith("B4 gemma3-1b mlp.up "
                                                           "(128,")
                and r["dtype"] == "fp32")
    b4 = entry("xbar_mac", "xbar_mac/csrc/xbar_mac.cu", "xbar_mac/xbar_mac.py:36",
               launches, err, head, shapes)
    torch.cuda.empty_cache()

    # -- B5: attention of gemma3-1b and recurrentgemma-2b at full width ----
    cases = [("gemma3-1b global", 4, 4096, 256, True, 0),
             ("gemma3-1b local", 4, 4096, 256, True, 512),
             ("recurrentgemma-2b local", 10, 4096, 256, True, 2048),
             ("ragged bidirectional", 2, 1000, 100, False, 0),
             ("ragged window", 3, 333, 64, True, 100)]
    launches, err, shapes = 0, 0.0, []
    for dname, dt, rtol, atol, peak in dtypes:
        for label, H, S, D, causal, window in cases:
            q, k, v = (torch.randn((1, H, S, D), generator=gen, device=dev).to(dt)
                       for _ in range(3))
            fa.flash_attention_cuda.launches = 0
            got = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            launches += fa.flash_attention_cuda.launches
            flat = [t.reshape(H, S, D) for t in (q, k, v)]
            want = fa.flash_attention_plain(*flat, causal=causal, window=window)
            shape = (f"B5 {label} H={H} S={S} D={D} causal={causal} "
                     f"window={window}")
            err = max(err, compare(f"{shape} {dname}", got.reshape(H, S, D).float(),
                                   want.float(), rtol, atol))
            del got, want
            it = 5 if S >= 4096 else 20
            pms = cuda_ms(lambda: fa.flash_attention_plain(
                *flat, causal=causal, window=window),
                iters=2, warmup=1)
            if window:
                qi = torch.arange(S, device=dev)[:, None]
                ki = torch.arange(S, device=dev)[None, :]
                band = (qi - ki) < window
                if causal:
                    band &= ki <= qi
                sdpa = dict(attn_mask=band)
            else:
                sdpa = dict(is_causal=causal)
            ms, lms = paired_ms(
                [lambda: flash_attention(q, k, v, causal=causal, window=window),
                 lambda: F.scaled_dot_product_attention(q, k, v, **sdpa)],
                iters=it)
            del sdpa
            pairs = H * attention_pairs(S, causal, window)
            shapes.append(shape_row(
                shape, dname, ms, pms, lms, 4 * H * S * D * q.element_size(),
                4 * D * pairs, peak, fp32_rate=TF32X3_FLOP_S, pairs=pairs,
                library="F.scaled_dot_product_attention (causal flag or a "
                        "boolean band mask)"))
            del q, k, v, flat
    head = next(r for r in shapes if r["shape"].startswith("B5 gemma3-1b global")
                and r["dtype"] == "fp32")
    b5 = entry("flash_attention", "flash_attention/csrc/flash_attention.cu",
               "flash_attention/flash_attention.py:65", launches, err, head,
               shapes)
    torch.cuda.empty_cache()

    # -- B6: falcon-mamba-7b's selective-scan state, recurrentgemma's RG-LRU
    # (D = 1001: a row pitch that is not a multiple of 16 B, whose rows the
    # kernel copies as the 16-byte chunks that hold them)
    cases = [("falcon-mamba-7b selective scan", 1, 2048, 8192 * 16, False),
             ("falcon-mamba-7b selective scan", 1, 2048, 8192 * 16, True),
             ("recurrentgemma-2b RG-LRU", 4, 2048, 2560, False),
             ("ragged", 3, 37, 1000, True),
             ("ragged, odd pitch", 3, 37, 1001, True)]
    launches, err, shapes = 0, 0.0, []
    for dname, dt, rtol, atol, peak in dtypes:
        for label, B, S, D, with_h0 in cases:
            a = (0.5 + 0.499 * torch.rand((B, S, D), generator=gen,
                                          device=dev)).to(dt)
            b = (0.1 * torch.randn((B, S, D), generator=gen, device=dev)).to(dt)
            h0 = (torch.randn((B, D), generator=gen, device=dev).to(dt)
                  if with_h0 else None)
            lsm.linear_scan_cuda.launches = 0
            h, h_last = linear_scan(a, b, h0)
            torch.cuda.synchronize()
            launches += lsm.linear_scan_cuda.launches
            b0 = None if h0 is None else lsm.fold_h0(a, b, h0)
            want = lsm.linear_scan_plain(a, b, b0)
            shape = f"B6 {label} B={B} S={S} D={D}{' h0' if with_h0 else ''}"
            plan = lsm._card_plan(B, D, a.element_size(), dev.index or 0)
            fill = ("tensor copies" if D * a.element_size() % 16 == 0
                    else "16-byte chunks by cp.async")
            # the gate is bit-equality: the kernel steps each lane as the
            # plain version does
            mabs = float((h.float() - want.float()).abs().max())
            equal = torch.equal(h, want)
            print(f"[kernel vs plain] {shape} {dname}: max_abs={mabs:.3e} "
                  f"bit-equal {equal}; plan C={plan['C']} R={plan['R']} "
                  f"K={plan['K']}, {plan['blocks']} thread blocks, "
                  f"{plan['smem']} B of shared memory, {fill}", flush=True)
            if not equal:
                fail(f"[{shape} {dname}] B6 is not bit-equal to its plain version")
            err = max(err, mabs)
            if not torch.equal(h_last, h[:, -1]):
                fail(f"[{shape}] h_last is not h[:, -1]")
            del h, h_last, want
            # in turns: the kernel alone (on a b0 folded once), the call
            # (the fold included), and the yardstick torch.add(a, b, out=),
            # which moves the same 3 elements per element
            it = 10 if B * S * D > 1e6 else 50
            out = torch.empty_like(a)
            ms, call_ms, copy_ms = paired_ms(
                [lambda: lsm.linear_scan_cuda(a, b, b0),
                 lambda: linear_scan(a, b, h0),
                 lambda: torch.add(a, b, out=out)], iters=it)
            pms = cuda_ms(lambda: lsm.linear_scan_plain(a, b, b0), iters=1,
                          warmup=1)
            nbytes = (3 * B * S * D + (B * D if with_h0 else 0)) * a.element_size()
            print(f"[time] {shape} {dname}: call {call_ms:.4f} ms, "
                  f"torch.add(a, b, out=) {copy_ms:.4f} ms", flush=True)
            shapes.append(shape_row(shape, dname, ms, pms, None, nbytes,
                                    2 * B * S * D, peak, call_ms=call_ms,
                                    copy_ms=copy_ms, plan=plan, fill=fill))
            del a, b, h0, b0, out
            torch.cuda.empty_cache()
    head = next(r for r in shapes if r["shape"].startswith("B6 falcon")
                and r["dtype"] == "fp32")
    b6 = entry("linear_scan", "linear_scan/csrc/linear_scan.cu",
               "linear_scan/linear_scan.py:45", launches, err, head, shapes)
    for rec in (b4, b5, b6):
        if rec["launches"] != len(rec["shapes"]):
            fail(f"{rec['name']} launched {rec['launches']} times for "
                 f"{len(rec['shapes'])} entry-point calls")
    return b4, b5, b6


# phase 16's sizes: (a) and (c) serve gemma3-1b at full width as phase 3
# does; (b) the row scheme at phi3.5-moe's q projection (K = N = 4096:
# (NB, NO) = (16, 4096)); (d) the tuner at full-width mlp.up
MESH_SERVE = ["--arch", "gemma3-1b", "--layers", "2", "--batch", "4",
              "--prompt-len", "32", "--gen", "8", "--seed", "0",
              "--analog-backend", "emulator"]
MESH_SHAPES = ("1,2", "2,1", "2,2")
MESH_B1_LAUNCHES = 3 * 2 * 8          # 3 MLP sites x 2 layers x 8 forwards
ROW_SITE = (4096, 4096)
ROW_M = (2, 32)
ROW_TPS = (2, 4)
ROW_RTOL, ROW_ATOL = 1e-5, 2e-6      # the reference's row-scheme tolerance
TUNE_M = (4, 128)


def _bits_equal(a, b) -> bool:
    """Same shape and the same bits (a sign of zero included)."""
    import numpy as np
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint32),
        np.ascontiguousarray(b).view(np.uint32))


def _mesh_serve(extra, card, label, want=None):
    """One ``serve --mesh`` run: rank 0's output and each rank's figures,
    printed; the tokens and logits held against ``want`` if given."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    sess, out = serve.main(MESH_SERVE + extra)
    secs = time.perf_counter() - t0
    if sess is not None or "ranks" not in out:
        fail(f"[mesh] {label}: the serve did not run on a mesh")
    if not np_isfinite(out["logits"]) or out["tokens"].shape != (4, 8):
        fail(f"[mesh] {label}: non-finite logits or tokens of shape "
             f"{out['tokens'].shape}")
    if want is not None:
        if not (out["tokens"] == want["tokens"]).all():
            fail(f"[mesh] {label}: tokens differ from the unsharded serve")
        if not _bits_equal(out["logits"], want["logits"]):
            fail(f"[mesh] {label}: logits are not bit-equal to the "
                 "unsharded serve's")
    dp, tp = (int(v) for v in extra[extra.index("--mesh") + 1].split(","))
    rows = []
    for r in out["ranks"]:
        if r["b1_launches"] != MESH_B1_LAUNCHES:
            fail(f"[mesh] {label} rank {r['rank']}: B1 launched "
                 f"{r['b1_launches']} times, expected {MESH_B1_LAUNCHES}")
        if r["gf_bytes"] * tp != r["full_gf_bytes"]:
            fail(f"[mesh] {label} rank {r['rank']}: holds {r['gf_bytes']} B "
                 f"of gf, not 1/{tp} of {r['full_gf_bytes']} B")
        if want is not None and r["cache_bytes"] * tp != want["cache_bytes"]:
            fail(f"[mesh] {label} rank {r['rank']}: its executor caches "
                 f"{r['cache_bytes']} B, not 1/{tp} of the unsharded "
                 f"executor's {want['cache_bytes']} B")
        timed = ("" if "b1_ms" not in r else
                 f"; timed generate: B1 {r['b1_ms']:.3f} ms a call "
                 f"({r['b1_calls']} calls), all_reduce "
                 f"{r['all_reduce_ms']:.3f} ms a call "
                 f"({r['all_reduce_calls']} calls)")
        print(f"[mesh] {label} rank {r['rank']} (data, model) = "
              f"{tuple(r['coords'])}: B1 launches {r['b1_launches']}, gf "
              f"{r['gf_bytes'] / 1e6:.1f} MB of {r['full_gf_bytes'] / 1e6:.1f}"
              f" MB, executor caches {r['cache_bytes'] / 1e6:.1f} MB"
              + ("" if want is None else
                 f" of {want['cache_bytes'] / 1e6:.1f} unsharded")
              + f", allocated {r['resident_bytes'] / 2**30:.2f} GiB after the"
              f" generate (peak {r['peak_bytes'] / 2**30:.2f}), prefill "
              f"{r['prefill_ms']:.1f} ms, decode "
              f"{r['decode_ms_step']:.2f} ms a step{timed} [{card}]",
              flush=True)
        rows.append(dict(run=label, mesh=[dp, tp], **{
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in r.items()}))
    print(f"[mesh] {label}: tokens "
          f"{'equal' if want is not None else 'not compared'}, "
          f"{secs:.1f} s with the ranks' start [{card}]", flush=True)
    return out, rows


def _row_rank(rank, world, device, payload):
    """One rank of phase 16 (b): the forced row scheme at the q
    projection on a (1, world) mesh; every B1 call of the rank held
    against the plain version; the outputs, launches and times back."""
    import torch
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.interop import load_emulator_npz
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.emulator_block import ops
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh(1, world, device)
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                     layers=("attn",)), geom=CASE_A,
                        emulator_params=load_emulator_npz(payload["npz"],
                                                          device),
                        mesh=mesh, shard_scheme="row")
    calls = []
    kernel = ops.emulator_block_unified_cuda

    def recorded(aux, g, u, pos, **kw):
        y = kernel(aux, g, u, pos, **kw)
        calls.append((aux, g, u, pos, kw.get("shift"), y))
        return y

    ops.emulator_block_unified_cuda = recorded
    w, xs = _row_inputs(device, payload["site"], payload["m"])
    eb.emulator_block_unified_cuda.launches = 0
    ys = [ex.matmul(x, w, "attn.q").cpu().numpy() for x in xs]
    launches = eb.emulator_block_unified_cuda.launches
    err = 0.0
    for aux, g, u, pos, sh, y in calls:
        want = eb.emulator_block_unified_plain(aux, g, u, pos, shift=sh)
        err = max(err, compare(f"B1 row rank {rank}/{world} M={u.shape[0]} "
                               f"NB={g.shape[0]} NO={g.shape[1]}", y, want))
    ops.emulator_block_unified_cuda = kernel
    ex.mesh_times = {}
    for _ in range(3):
        for x in xs:
            ex.matmul(x, w, "attn.q")
    times = {k: sum(v) / len(v) for k, v in ex.mesh_times.items()}
    return dict(ys=ys, launches=launches, calls=len(calls), err=err,
                times=times)


def _row_inputs(device, site, ms):
    """The (K, N) weight and the rows of each M of ``ms``, from seeds."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(1616)
    K, N = site
    w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
    return w, [torch.randn((M, K), generator=g, device=device) for M in ms]


def _tune_inputs(dev):
    """Full-width mlp.up's B1 operands (a random net, seeded weights)."""
    import torch
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core import conv4xbar
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.core.crossbar import build_conductance_plan
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    aux = conv4xbar.blocklast_weights(rand_params(CASE_A, 0, 7, dev), CASE_A)
    g = torch.Generator(device=dev)
    g.manual_seed(1617)
    K, N = GEMMA["d_model"], GEMMA["d_ff"]
    plan = build_conductance_plan(
        torch.randn((K, N), generator=g, device=dev) * K ** -0.5, acfg, CASE_A)
    ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params={})
    out = {}
    for M in TUNE_M:
        x = torch.randn((M, K), generator=g, device=dev)
        u = plan.tile_v(ex._drive01(x.abs() / x.abs().max()), 1.0).contiguous()
        pos = plan.tile_v((x > 0).float(), 1.0).contiguous()
        out[M] = (aux, plan.g_norm.contiguous(), u, pos)
    return out


_DISK_CHECK = r"""
import json, sys
sys.path.insert(0, SRC)
import torch
import chip_smoke
from repro_torch.kernels import autotune
from repro_torch.kernels.emulator_block.ops import emulator_block_unified
dev = torch.device("cuda", 0)
out = {}
for M, (aux, gn, u, pos) in chip_smoke._tune_inputs(dev).items():
    emulator_block_unified(aux, gn, u, pos)
    out[M] = autotune.report()["emulator_unified"]
print("REPORT " + json.dumps(out))
"""


def mesh_phase(dev, card, npz, unsharded, b1_shapes):
    """Phase 16 (module docstring): returns B1's launches per mesh run,
    the rows of the ``mesh`` JSON line, B1's largest error and the
    tuner's record."""
    import torch
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.interop import load_emulator_npz
    from repro_torch.kernels import autotune
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.emulator_block.emulator_block import (
        default_block_m)
    from repro_torch.kernels.emulator_block.ops import (block_m_candidates,
                                                        emulator_block_unified)
    from repro_torch.launch.mesh import launch
    t_phase = time.perf_counter()
    launches, rows, err = {}, [], 0.0

    # -- (a) the ideal serve on three meshes -------------------------------
    for m in MESH_SHAPES:
        _, r = _mesh_serve(["--emulator-params", str(npz), "--mesh", m,
                            "--mesh-times"], card, f"(a) --mesh {m}",
                           want=unsharded)
        launches[f"(a) {m}"] = sum(x["b1_launches"] for x in r)
        rows += r

    # -- (b) the row scheme, forced, at the q projection --------------------
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                     layers=("attn",)), geom=CASE_A,
                        emulator_params=load_emulator_npz(str(npz), dev))
    w, xs = _row_inputs(dev, ROW_SITE, ROW_M)
    want = [ex.matmul(x, w, "attn.q") for x in xs]
    plan = ex._plan_for(w, "attn.q")
    print(f"[mesh] (b) q projection K={plan.K} N={plan.N}: (NB, NO) = "
          f"({plan.NB}, {plan.NO})", flush=True)
    for tp in ROW_TPS:
        res = launch(_row_rank, tp, device=dev, args=(dict(
            npz=str(npz), site=ROW_SITE, m=ROW_M),))
        for r, rr in enumerate(res):
            if rr["launches"] != len(ROW_M) or rr["calls"] != len(ROW_M):
                fail(f"[mesh] (b) tp={tp} rank {r}: {rr['launches']} B1 "
                     f"launches for {len(ROW_M)} matmuls")
            err = max(err, rr["err"])
            for M, y, yw in zip(ROW_M, rr["ys"], want):
                compare(f"row scheme tp={tp} rank {r} M={M} vs unsharded",
                        torch.from_numpy(y), yw.cpu(), ROW_RTOL, ROW_ATOL)
            print(f"[mesh] (b) tp={tp} rank {r}: B1 {rr['times']['b1']:.3f} ms "
                  f"a call, all_reduce {rr['times']['all_reduce']:.3f} ms a "
                  f"call (M = {', '.join(map(str, ROW_M))}) [{card}]",
                  flush=True)
            rows.append(dict(run=f"(b) row tp={tp}", mesh=[1, tp], rank=r,
                             b1_launches=rr["launches"], b1_err=rr["err"],
                             b1_ms=rr["times"]["b1"],
                             all_reduce_ms=rr["times"]["all_reduce"]))
        launches[f"(b) row 1,{tp}"] = sum(rr["launches"] for rr in res)
    del ex, w, xs, want

    # -- (c) a stressed, remapped deployment re-sharded on load --------------
    dep = ROOT / "build" / "chip_smoke_mesh_dep.npz"
    dep.unlink(missing_ok=True)
    saved, r = _mesh_serve(["--emulator-params", str(npz), "--scenario",
                            "stressed", "--fault-remap", "--state-save",
                            str(dep), "--mesh", "1,2"], card,
                           "(c) stressed, saved under --mesh 1,2")
    launches["(c) save 1,2"] = sum(x["b1_launches"] for x in r)
    rows += r
    # the saved deployment served unsharded: the yardstick of both meshes
    from repro_torch.launch import serve
    n0 = eb.emulator_block_unified_cuda.launches
    sess, out = serve.main(MESH_SERVE + ["--emulator-params", str(npz),
                                         "--state-load", str(dep)])
    launches["(c) load unsharded"] = eb.emulator_block_unified_cuda.launches - n0
    loaded = {"tokens": out["tokens"], "logits": out["logits"],
              "cache_bytes": sess.ex.cache_bytes()[1]}
    del sess, out
    if not ((saved["tokens"] == loaded["tokens"]).all()
            and _bits_equal(saved["logits"], loaded["logits"])):
        fail("[mesh] (c): the serve under --mesh 1,2 that saved the "
             "deployment is not bit-equal to the deployment served unsharded")
    print(f"[mesh] (c) the saved deployment served unsharded: tokens equal "
          f"and logits bit-equal to the --mesh 1,2 serve that saved it; "
          f"executor caches {loaded['cache_bytes'] / 1e6:.1f} MB [{card}]",
          flush=True)
    _, r = _mesh_serve(["--emulator-params", str(npz), "--state-load",
                        str(dep), "--mesh", "2,2"], card,
                       "(c) loaded under --mesh 2,2", want=loaded)
    launches["(c) load 2,2"] = sum(x["b1_launches"] for x in r)
    rows += r

    # -- (d) the tuner on the card --------------------------------------------
    os.environ["REPRO_AUTOTUNE"] = "1"
    cache = ROOT / "build" / "chip_smoke_tuned.json"
    cache.unlink(missing_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache)
    autotune.clear()
    tuner = {"rows": []}
    n0 = eb.emulator_block_unified_cuda.launches
    for M, (aux, gn, u, pos) in _tune_inputs(dev).items():
        t0 = time.perf_counter()
        y = emulator_block_unified(aux, gn, u, pos)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        rep = autotune.report()["emulator_unified"]
        if rep["source"] != "swept":
            fail(f"[tuner] mlp.up M={M}: the first resolution came from "
                 f"{rep['source']}, not a sweep")
        emulator_block_unified(aux, gn, u, pos)
        if autotune.report()["emulator_unified"]["source"] != "memory":
            fail(f"[tuner] mlp.up M={M}: the second resolution was no "
                 "memory hit")
        for bm in block_m_candidates(M):
            if not torch.equal(eb.emulator_block_unified_cuda(
                    aux, gn, u, pos, block_m=bm), y):
                fail(f"[tuner] mlp.up M={M}: B1 under block_m={bm} is not "
                     "bit-equal to the tuned call")
        bound = next(b for b in b1_shapes if b["shape"].startswith("mlp.up")
                     and b["shape"].endswith(f" M={M}"))
        print(f"[tuner] mlp.up M={M}: swept block_m {rep['config']['block_m']}"
              f" in {sweep_s:.2f} s; candidates "
              + ", ".join(f"{json.loads(k)['block_m']}: {v:.3f} ms"
                          for k, v in rep["ms"].items())
              + f"; default {default_block_m(M)}; bound {bound['bound_ms']:.3f} ms "
              f"({bound['bound_by']}); bit-equal under every tile [{card}]",
              flush=True)
        tuner["rows"].append(dict(shape=f"mlp.up M={M}", sweep_s=sweep_s,
                                  block_m=rep["config"]["block_m"],
                                  candidates_ms=rep["ms"],
                                  bound_ms=bound["bound_ms"]))
    tuner["launches"] = eb.emulator_block_unified_cuda.launches - n0
    fresh = subprocess.run(
        [sys.executable, "-c", f"SRC={str(ROOT / 'src')!r}\n" + _DISK_CHECK],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    if fresh.returncode != 0:
        fail(f"[tuner] the fresh process failed: {fresh.stderr[-2000:]}")
    reps = json.loads(next(line for line in fresh.stdout.splitlines()
                           if line.startswith("REPORT "))[len("REPORT "):])
    for M in TUNE_M:
        got = reps[str(M)]
        want_bm = next(r["block_m"] for r in tuner["rows"]
                       if r["shape"] == f"mlp.up M={M}")
        if got["source"] != "disk" or got["config"]["block_m"] != want_bm:
            fail(f"[tuner] a fresh process resolved mlp.up M={M} to "
                 f"{got}, not block_m {want_bm} from disk")
        print(f"[tuner] a fresh process: mlp.up M={M} -> block_m "
              f"{got['config']['block_m']} from {got['source']}", flush=True)
    os.environ["REPRO_AUTOTUNE"] = "0"
    secs = time.perf_counter() - t_phase
    print(f"[mesh] phase 16 took {secs:.1f} s; B1 launches {launches}",
          flush=True)
    return dict(b1=launches, rows=rows, b1_err=err, tuner=tuner)



# phase 17's runs, random weights at full published widths, every rank on
# the one card over gloo: (a) gemma3-1b at depth 2, bf16 compute, remat
# "full", batch 4 x 256, 3 steps on the unsharded trainer and on each of
# ``MT_MESHES``; (b) the (2, 2) run's step-2 checkpoint onto (4, 1) and
# onto one process; (c) phase 12 (b)'s model (gemma3-1b cut to one period,
# MLPs on the phase-3 net, fp32) and recurrentgemma-2b cut to one (R, R, L)
# period (B6, fp32), one step each on (1, 2); (d) a gemma3-1b global
# layer's cache (S_max 32,768, fp32) on (1, 2) and (1, 4).
MT = dict(arch="gemma3-1b", layers=2, B=4, S=256, steps=3)
MT_MESHES = ((2, 1), (1, 2), (2, 2))
MT_LOSS_ATOL = 1e-2          # bf16 compute: the loss within 1e-2
MT_GNORM_RTOL = 5e-2         # and the clip norm within 5%
MT_EMU = dict(arch="gemma3-1b", layers=6, B=4, S=32)
# (c)'s analog loss on the mesh against the unsharded step: the split
# digital products round their last bits otherwise than the whole ones,
# and the emulated MLPs amplify that (a drive at exactly zero maps to 0 V,
# any other to at least v_th, and gelu's exact zeros sit on that edge);
# with the digital products whole on every rank the gate is rtol 1e-5
MT_EMU_RTOL, MT_EMU_WHOLE_RTOL = 1e-2, 1e-5
MT_REC = dict(arch="recurrentgemma-2b", layers=3, B=2, S=128)
MT_FLASH = dict(B=4, S_max=32768, pos=20001, reps=10)


def _mt_setup(kind, every=100):
    """(cfg, pcfg, tcfg, data) of a phase-17 run: ``kind`` "dense" (bf16),
    "emu" or "rec" (fp32); a checkpoint every ``every`` steps."""
    from repro_torch.configs import get_config, with_depth
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data import SyntheticLMData
    spec = {"dense": MT, "emu": MT_EMU, "rec": MT_REC}[kind]
    cfg = with_depth(get_config(spec["arch"]), spec["layers"])
    pcfg = ParallelConfig(
        compute_dtype="bfloat16" if kind == "dense" else "float32",
        remat="full", attn_block_kv=min(1024, spec["S"]),
        xent_chunk=min(2048, spec["S"]))
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=spec.get("steps", 1), checkpoint_every=every)
    return cfg, pcfg, tcfg, SyntheticLMData(cfg, spec["S"], spec["B"])


def _mt_trainer(cfg, pcfg, tcfg, data, mesh, ckpt, device, steps):
    """A ``Trainer`` run to ``steps`` (on ``mesh``, or none) over the
    checkpoints in ``ckpt`` -- or, with ``ckpt=None``, the train step run
    ``steps`` times from the seed's state on the batches the trainer
    feeds, no checkpoint written: its losses, clip norms and step
    seconds, each step's synchronized collective ms, the bytes of the
    state it holds (and, on a mesh, the leaves that do not hold
    1/(dp*tp) of a leaf whose spec divides every axis), its peak
    memory."""
    import torch
    from repro_torch.models.common import (mesh_axes, spec_axes, tree_items,
                                           tree_leaves)
    from repro_torch.parallel.train_mesh import batch_rows, collective_times
    from repro_torch.runtime import steps as S
    from repro_torch.runtime.trainer import Trainer
    coll, held = [], {}

    def timed(real):
        def step(state, batch):
            with collective_times() as c:
                out = real(state, batch)
            torch.cuda.synchronize()
            coll.append(sum(c))
            held["state"] = out[0]
            return out
        return step

    torch.cuda.reset_peak_memory_stats()
    if ckpt is None:
        step = timed(S.make_train_step(cfg, pcfg, tcfg, mesh=mesh))
        state, log = S.init_train_state(tcfg.seed, cfg, device, mesh=mesh), []
        for i in range(steps):
            t0 = time.perf_counter()
            batch = data.batch(i)
            if mesh is not None:
                rows = batch_rows(next(iter(batch.values())).shape[0],
                                  mesh).numpy()
                batch = {k: v[rows] for k, v in batch.items()}
            state, met = step(state, _to_dev(batch, device))
            log.append(dict(step=i, loss=float(met["loss"]),
                            gnorm=float(met["gnorm"]),
                            dt=time.perf_counter() - t0))
        del state
    else:
        tr = Trainer(cfg=cfg, pcfg=pcfg, tcfg=tcfg, mesh=mesh, data=data,
                     ckpt_dir=ckpt, device=device)
        tr._build()
        tr._step = timed(tr._step)
        tr.run(steps)
        log = tr.metrics_log
    st = held["state"]
    nbytes = {k: sum(t.nbytes for t in tree_leaves(v)) for k, v in (
        ("params", st["params"]), ("m", st["opt"]["m"]),
        ("v", st["opt"]["v"]))}
    bad, dividing = [], 0
    if mesh is not None:
        axes = {a for a, n in mesh_axes(mesh).items() if n > 1}
        n = 1
        for a in axes:
            n *= mesh_axes(mesh)[a]
        specs = dict(tree_items(S.train_state_specs(cfg, mesh)["params"]))
        full = dict(tree_items(S.abstract_train_state(cfg)["params"]))
        for k, t in tree_items(st["params"]):
            if axes <= set(spec_axes(specs[k])):
                dividing += 1
                if t.numel() * n != full[k].numel():
                    bad.append(k)
    del held, st
    return dict(losses=[r["loss"] for r in log],
                gnorms=[r["gnorm"] for r in log],
                steps=[r["step"] for r in log],
                dt_ms=[r["dt"] * 1e3 for r in log], coll_ms=coll,
                bytes=nbytes, dividing=dividing, not_divided=bad,
                peak=torch.cuda.max_memory_allocated())


def _mt_flash(mesh, device):
    """(d) on ``mesh``: this rank's ``sharded_flash_decode`` of its block
    of a seeded cache against ``decode_attention`` on the whole cache; the
    largest error and both calls' synchronized ms."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.attention import (decode_attention,
                                              sharded_flash_decode)
    from repro_torch.parallel.train_mesh import model_index, model_size
    cfg, f = get_config("gemma3-1b"), MT_FLASH
    g = torch.Generator(device=device)
    g.manual_seed(1717)
    shape = (f["B"], f["S_max"], cfg.num_kv_heads, cfg.head_dim)
    q = torch.randn((f["B"], 1, cfg.num_heads, cfg.head_dim), generator=g,
                    device=device)
    ck = torch.randn(shape, generator=g, device=device)
    cv = torch.randn(shape, generator=g, device=device)
    n = f["S_max"] // model_size(mesh)
    t = model_index(mesh)
    lk, lv = ck[:, t * n:(t + 1) * n].contiguous(), cv[:, t * n:(t + 1) * n].contiguous()
    valid = torch.arange(f["S_max"], device=device) <= f["pos"]

    def sharded():
        return sharded_flash_decode(q, lk, lv, f["pos"], cfg, mesh=mesh)

    def whole():
        return decode_attention(q, ck, cv, valid, cfg)

    y, want = sharded(), whole()
    err = float((y - want).abs().max())
    ok = bool(torch.allclose(y, want, rtol=RTOL, atol=ATOL))
    times = {}
    for name, fn in (("sharded", sharded), ("whole", whole)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(f["reps"]):
            fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3 / f["reps"]
    return dict(err=err, ok=ok, ms=times["sharded"], whole_ms=times["whole"],
                S_local=n)


def _mt_rank(rank, world, device, payload):
    """One rank of phase 17: (a) on each mesh of ``payload["meshes"]``
    (every one over the ``world`` ranks), then where the payload asks for
    them (b), (d) on a (1, tp) mesh of each ``payload["flash"]`` and (c)."""
    import gc
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.common import mesh_coords
    out = {"rank": rank, "secs": {}}
    t0 = time.perf_counter()
    for m in payload["meshes"]:
        mesh = make_mesh_for(world, model_axis=m[1], device=device)
        cfg, pcfg, tcfg, data = _mt_setup("dense", every=2 if m == (2, 2)
                                          else 100)
        # the trainer (and its checkpoints) where (b) restarts from them
        ckpt = f"{payload['ckpt']}_22" if m == (2, 2) else None
        out[f"a {m}"] = _mt_trainer(cfg, pcfg, tcfg, data, mesh, ckpt,
                                    device, MT["steps"])
        out[f"a {m}"]["coords"] = mesh_coords(mesh)
        gc.collect()
        torch.cuda.empty_cache()
        out["secs"][f"(a) {m}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    if payload.get("elastic"):
        if rank == 0:
            shutil.copytree(Path(f"{payload['ckpt']}_22") / "step_00000002",
                            Path(payload["elastic"]) / "step_00000002")
        dist.barrier()
        out["b"] = _mt_trainer(cfg, pcfg, tcfg, data,
                               make_mesh_for(world, model_axis=1,
                                             device=device),
                               payload["elastic"], device, MT["steps"])
        gc.collect()
        torch.cuda.empty_cache()
        out["secs"]["(b)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    for ftp in payload.get("flash", ()):
        out[f"flash {ftp}"] = _mt_flash(
            make_mesh_for(world, model_axis=ftp, device=device), device)
        out["secs"][f"(d) 1,{ftp}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    if payload.get("npz"):
        out.update(_mt_emu(world, device, payload["npz"]))
        out["secs"]["(c)"] = time.perf_counter() - t0
    return out


def _mt_step(kind, device, mesh=None, eparams=None):
    """One step of a phase-17 (c) run from the seed-0 state on batch 0 --
    on ``mesh`` this rank's windows and rows; ``eparams``: the MLPs on
    the emulator.  Returns (metrics, B1's and B6's launches, their first
    and last calls, the step's seconds)."""
    import torch
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.models.common import use_dense_hook
    from repro_torch.parallel.train_mesh import batch_rows
    from repro_torch.runtime import steps as S
    lsm = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
    b1_ops = importlib.import_module("repro_torch.kernels.emulator_block.ops")
    b6_ops = importlib.import_module("repro_torch.kernels.linear_scan.ops")
    cfg, pcfg, tcfg, data = _mt_setup(kind)
    state = S.init_train_state(0, cfg, device, mesh=mesh)
    batch = data.batch(0)
    if mesh is not None:
        rows = batch_rows(next(iter(batch.values())).shape[0], mesh).numpy()
        batch = {k: v[rows] for k, v in batch.items()}
    batch = _to_dev(batch, device)
    step = S.make_train_step(cfg, pcfg, tcfg, mesh=mesh)
    calls = {"b1": [], "b6": []}
    real_b1, real_b6 = b1_ops.emulator_block_unified_cuda, b6_ops.linear_scan_cuda

    def rec_b1(aux, g, u, pos, **kw):
        y = real_b1(aux, g, u, pos, **kw)
        calls["b1"][1:] = [(aux, g, u, pos, kw.get("shift"), y)]
        return y

    def rec_b6(a, b, b0=None):
        h = real_b6(a, b, b0)
        calls["b6"][1:] = [(a, b, b0, h)]
        return h

    hook = None
    if eparams is not None:
        hook = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                           layers=("mlp",)), geom=CASE_A,
                              emulator_params=eparams, mesh=mesh).hook
    b1_ops.emulator_block_unified_cuda, b6_ops.linear_scan_cuda = rec_b1, rec_b6
    eb.emulator_block_unified_cuda.launches = 0
    lsm.linear_scan_cuda.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (use_dense_hook(hook) if hook else contextlib.nullcontext()):
            state, met = step(state, batch)
        met = {k: float(v) for k, v in met.items()}
        secs = time.perf_counter() - t0
    finally:
        b1_ops.emulator_block_unified_cuda = real_b1
        b6_ops.linear_scan_cuda = real_b6
    return (met, eb.emulator_block_unified_cuda.launches,
            lsm.linear_scan_cuda.launches, calls, secs)


def _mt_kernel_errs(calls):
    """The largest error of the recorded B1 calls against B1's plain
    version (by column chunks) and of the B6 calls against B6's."""
    from repro_torch.kernels.emulator_block import emulator_block as eb
    lsm = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
    e1 = e6 = 0.0
    for aux, g, u, pos, sh, y in calls["b1"]:
        want = (_plain_by_columns(aux, g, u, pos) if sh is None else
                eb.emulator_block_unified_plain(aux, g, u, pos, shift=sh))
        e1 = max(e1, compare(f"B1 on a mesh M={u.shape[0]} NB={g.shape[0]} "
                             f"NO={g.shape[1]}", y, want))
    for a, b, b0, h in calls["b6"]:
        e6 = max(e6, compare(f"B6 on a mesh {tuple(a.shape)}", h,
                             lsm.linear_scan_plain(a, b, b0)))
    return e1, e6


def _mt_emu(world, device, npz):
    """Phase 17 (c) on a rank of a (1, world) mesh: the analog step and
    the recurrent step, each rank's B1 and B6 calls held against their
    plain versions; the analog step once more with every digital product
    whole on each rank ("emu whole": ``train_mesh.split_dense`` swapped
    for the whole product), the analog plane alone on the mesh."""
    from repro_torch.interop import load_emulator_npz
    from repro_torch.launch.mesh import make_mesh_for
    import gc
    import torch
    from repro_torch.parallel import train_mesh
    mesh = make_mesh_for(world, model_axis=world, device=device)
    eparams = load_emulator_npz(npz, device)
    out = {}
    split = train_mesh.split_dense

    def whole(x, w, tag, mesh):
        return torch.matmul(x, w.to(x.dtype))

    for kind, ep, dense in (("emu", eparams, split), ("rec", None, split),
                            ("emu whole", eparams, whole)):
        train_mesh.split_dense = dense
        try:
            met, b1, b6, calls, secs = _mt_step(kind.split()[0], device,
                                                mesh, ep)
        finally:
            train_mesh.split_dense = split
        e1, e6 = _mt_kernel_errs(calls)
        out[kind] = dict(metrics=met, b1=b1, b6=b6, b1_err=e1, b6_err=e6,
                         step_ms=secs * 1e3)
        del calls
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_train_phase(dev, card, npz):
    """Phase 17 (module docstring): returns B1's and B6's launches per run,
    their largest errors, and the rows of the ``train_mesh`` JSON line."""
    import shutil
    import tempfile
    import torch
    from repro_torch.interop import load_emulator_npz
    from repro_torch.launch.mesh import launch
    t_phase = time.perf_counter()
    out = {"b1": {}, "b6": {}, "b1_err": 0.0, "b6_err": 0.0, "rows": []}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mt_", dir=ROOT / "build"))
    torch.cuda.empty_cache()

    # -- (a) the unsharded trainer, the yardstick -----------------------------
    cfg, pcfg, tcfg, data = _mt_setup("dense")
    t0 = time.perf_counter()
    base = _mt_trainer(cfg, pcfg, tcfg, data, None, None, dev, MT["steps"])
    full = base["bytes"]
    print(f"[train mesh] (a) unsharded {cfg.name} ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, bf16, {MT['B']} x {MT['S']}): loss "
          f"{' '.join(f'{l:.4f}' for l in base['losses'])}, gnorm "
          f"{' '.join(f'{g:.4f}' for g in base['gnorms'])}; steps "
          f"{' '.join(f'{d:.1f}' for d in base['dt_ms'])} ms; state "
          f"{sum(full.values()) / 1e9:.3f} GB; peak "
          f"{base['peak'] / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    out["rows"].append(dict(run="(a) unsharded", mesh=None, **base))
    torch.cuda.empty_cache()

    # -- (c)'s unsharded steps: the yardsticks of (c) --------------------------
    eparams = load_emulator_npz(str(npz), dev)
    want = {}
    for kind, ep in (("emu", eparams), ("rec", None)):
        met, b1, b6, _, secs = _mt_step(kind, dev, None, ep)
        want[kind] = (met, b1, b6)
        out["b1"][f"(c) {kind} unsharded"] = b1
        out["b6"][f"(c) {kind} unsharded"] = b6
    del eparams
    import gc
    gc.collect()
    torch.cuda.empty_cache()

    # -- two worlds: (a) (2, 1), (1, 2), (d) (1, 2), (c); (a) (2, 2), (b), (d)
    runs = ((2, dict(meshes=((2, 1), (1, 2)), flash=(2,), npz=str(npz))),
            (4, dict(meshes=((2, 2),), flash=(4,),
                     elastic=str(tmp / "elastic"))))
    for world, payload in runs:
        payload["ckpt"] = str(tmp / f"w{world}")
        t0 = time.perf_counter()
        res = launch(_mt_rank, world, device=dev, args=(payload,))
        print(f"[train mesh] world of {world} ranks: {time.perf_counter() - t0:.1f} "
              f"s with the ranks' start; rank 0's parts "
              + ", ".join(f"{k} {v:.1f} s" for k, v in res[0]["secs"].items()),
              flush=True)
        for m in payload["meshes"]:
            for r in res:
                _mt_report_a(m, r, base, card, out)
        for r in res:
            if "b" in r:
                b = r["b"]
                a = r["a (2, 2)"]
                i = b["steps"].index(2)
                lw = a["losses"][a["steps"].index(2)]
                if b["steps"][0] != 2 or abs(b["losses"][i] - lw) > MT_LOSS_ATOL:
                    fail(f"[train mesh] (b) rank {r['rank']}: the (4, 1) "
                         f"restart's step 2 loss {b['losses']} against {lw}")
                print(f"[train mesh] (b) (2, 2) step-2 checkpoint on (4, 1) "
                      f"rank {r['rank']}: step 2 loss {b['losses'][i]:.4f} "
                      f"(the (2, 2) run's {lw:.4f}) [{card}]", flush=True)
                out["rows"].append(dict(run="(b) (4, 1)", rank=r["rank"],
                                        loss=b["losses"][i], want=lw))
            for k in [k for k in r if k.startswith("flash")]:
                f = r[k]
                out["rows"].append(dict(run=f"(d) {k}", rank=r["rank"], **f))
                if not f["ok"]:
                    fail(f"[train mesh] (d) {k} rank {r['rank']}: the "
                         f"combine is {f['err']} from decode_attention")
                print(f"[train mesh] (d) sharded_flash_decode on (1, "
                      f"{k.split()[1]}) rank {r['rank']}: S_local "
                      f"{f['S_local']}, max abs err {f['err']:.2e} against "
                      f"decode_attention on S_max {MT_FLASH['S_max']}; "
                      f"{f['ms']:.3f} ms a call with its collectives, the "
                      f"whole cache's {f['whole_ms']:.3f} ms [{card}]",
                      flush=True)
        if payload.get("npz"):
            _mt_report_c(res, want, card, out)
        torch.cuda.empty_cache()

    # -- (b) one process from the (2, 2) run's step-2 checkpoint --------------
    one = tmp / "one"
    shutil.copytree(tmp / "w4_22" / "step_00000002", one / "step_00000002")
    solo = _mt_trainer(cfg, pcfg, tcfg, data, None, str(one), dev,
                       MT["steps"])
    a = res[0]["a (2, 2)"]
    lw = a["losses"][a["steps"].index(2)]
    if solo["steps"][0] != 2 or abs(solo["losses"][0] - lw) > MT_LOSS_ATOL:
        fail(f"[train mesh] (b) one process: step 2 loss {solo['losses']} "
             f"against the (2, 2) run's {lw}")
    print(f"[train mesh] (b) (2, 2) step-2 checkpoint in one process: step 2 "
          f"loss {solo['losses'][0]:.4f} (the (2, 2) run's {lw:.4f}) "
          f"[{card}]", flush=True)
    out["rows"].append(dict(run="(b) one process", loss=solo["losses"][0],
                            want=lw))
    shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    print(f"[train mesh] phase 17 took {secs:.1f} s; B1 launches {out['b1']}; "
          f"B6 launches {out['b6']}", flush=True)
    return out


def _mt_report_a(m, r, base, card, out):
    """Gate and print (a) on mesh ``m`` for one rank's results ``r``."""
    a = r[f"a {m}"]
    world = m[0] * m[1]
    for i, (l, g, lw, gw) in enumerate(zip(
            a["losses"], a["gnorms"], base["losses"], base["gnorms"])):
        if not (abs(l - lw) <= MT_LOSS_ATOL
                and abs(g - gw) <= MT_GNORM_RTOL * abs(gw)):
            fail(f"[train mesh] (a) {m} rank {r['rank']} step {i}: loss {l} "
                 f"gnorm {g} against the unsharded {lw} {gw}")
    if a["not_divided"] or not a["dividing"]:
        fail(f"[train mesh] (a) {m} rank {r['rank']}: leaves not at "
             f"1/{world} of the state: {a['not_divided']}")
    held = sum(a["bytes"].values())
    share = held / sum(base["bytes"].values())
    med = statistics.median(a["dt_ms"][1:])
    coll = statistics.median(a["coll_ms"][1:])
    print(f"[train mesh] (a) {m} rank {r['rank']} {a['coords']}: loss "
          f"{' '.join(f'{l:.4f}' for l in a['losses'])}, gnorm "
          f"{' '.join(f'{g:.4f}' for g in a['gnorms'])}; params+m+v "
          f"{held / 1e9:.3f} GB = {share:.4f} of the unsharded "
          f"({a['dividing']} leaves at 1/{world}); step {med:.1f} ms (median "
          f"of steps 2-{MT['steps']}), collectives {coll:.1f} ms of it; peak "
          f"{a['peak'] / 2**30:.2f} GiB [{card}]", flush=True)
    out["rows"].append(dict(run=f"(a) {m}", mesh=list(m), rank=r["rank"],
                            share=share, step_ms_median=med,
                            coll_ms_median=coll, **a))


def _mt_report_c(res, want, card, out):
    """Gate and print (c) for each rank's results in ``res``."""
    tol = {"emu": MT_EMU_RTOL, "rec": RTOL, "emu whole": MT_EMU_WHOLE_RTOL}
    for kind in ("emu", "rec", "emu whole"):
        wm, wb1, wb6 = want[kind.split()[0]]
        for r in res:
            c = r[kind]
            if abs(c["metrics"]["loss"] - wm["loss"]) > tol[kind] * abs(wm["loss"]):
                fail(f"[train mesh] (c) {kind} rank {r['rank']}: loss "
                     f"{c['metrics']['loss']} against the unsharded "
                     f"{wm['loss']}")
            if (c["b1"], c["b6"]) != (wb1, wb6) or not (wb1 or wb6):
                fail(f"[train mesh] (c) {kind} rank {r['rank']}: B1 / B6 "
                     f"launched {c['b1']} / {c['b6']} times, the unsharded "
                     f"step {wb1} / {wb6}")
            out["b1_err"] = max(out["b1_err"], c["b1_err"])
            out["b6_err"] = max(out["b6_err"], c["b6_err"])
            print(f"[train mesh] (c) {kind} on (1, 2) rank {r['rank']}: loss "
                  f"{c['metrics']['loss']:.6f} (unsharded {wm['loss']:.6f}), "
                  f"gnorm {c['metrics']['gnorm']:.6f} (unsharded "
                  f"{wm['gnorm']:.6f}); B1 launches {c['b1']}, B6 launches "
                  f"{c['b6']} (the unsharded step's {wb1}, {wb6}); first and "
                  f"last calls against the plain versions: B1 "
                  f"{c['b1_err']:.2e}, B6 {c['b6_err']:.2e}; step "
                  f"{c['step_ms']:.1f} ms [{card}]", flush=True)
            out["rows"].append(dict(run=f"(c) {kind} (1, 2)", rank=r["rank"],
                                    loss=c["metrics"]["loss"],
                                    want=wm["loss"],
                                    gnorm=c["metrics"]["gnorm"],
                                    want_gnorm=wm["gnorm"], **{k: c[k] for k in (
                                        "b1", "b6", "b1_err", "b6_err",
                                        "step_ms")}))
        out["b1"][f"(c) {kind} (1, 2)"] = sum(r[kind]["b1"] for r in res)
        out["b6"][f"(c) {kind} (1, 2)"] = sum(r[kind]["b6"] for r in res)


def np_isfinite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(a).all())


if __name__ == "__main__":
    main()
