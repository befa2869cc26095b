#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fluidsim_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code on failure:
  1. require a CUDA device (no CPU fallback) and print the card's name and
     power limit;
  2. build the hand kernels (K1 to K14, float32 and bfloat16, K1's body at
     any window) from ``fluidsim_tpu_torch/csrc``;
  3. hold each kernel against its plain PyTorch twin on the card on inputs
     made with NumPy from a seed, bitwise: at 128³ K1 with buoyancy and K2 on
     bench128-scale fields, K1 with three substeps and the vortex128 mask
     (F = 3 and F = 1) and K3 with and without the mask on vortex128-scale
     fields; the fused variants at 128³: K1 with buoyancy and the folded
     emitter, K2s, K2o (vortex128's mask, three substeps, bf16 solve), K2
     with two substeps, K8 with one and two substeps, and K8 against the
     launched K1 → K2; at 256³ K6 (the projection's solve, and a b = 3 solve
     with diffusion coefficients), K7's divergence and gradient, K1 with two
     substeps (F = 3 and F = 1), and the slab route K7 → K6 → K7 against K3
     (float32, no mask);
  4. step bench128 at 128³ through ``Engine(cfg, device="cuda")`` for
     ``STEPS`` steps with the launch counters reset just before: K1 and K2
     must have launched, the emitter ran once a step, the fields stay
     finite, the emitted mass grows, the plume rises, and the first 10 steps
     stay within the bf16-solve bound of a rollout of the kernels' twins;
  5. step bench128 with the projection unfused (``fuse_project_advect=False``,
     the arrangement the JAX package's bench.py keeps as its tripwire) for
     10 steps: K1 and K3 (without a mask) must have launched and K2 not, and
     the state must equal the fused run's after 10 steps;
  6. step vortex128 at 128³ through ``Engine`` for ``VORTEX_STEPS`` steps
     with the counters reset just before: K1 and K3 must have launched and
     K2 not, the fields stay finite, the mass grows, the plume rises over
     the first 40 steps, interior obstacle cells hold exactly zero velocity,
     and the first 10 steps stay within the bf16-solve bound of the twins;
  7. step the fused variants at 128³ the same way: bench128 with
     ``fuse_emitter`` for ``STEPS`` steps (K1 and K2s a step each, no
     full-grid emitter pass; after 10 steps within rtol 1e-5, atol 1e-6 of
     the composed run of phase 4), bench128 with ``fuse_self_advect`` for
     ``STEPS`` steps (K8 alone; after 10 steps bitwise bench128 with
     ``fuse_buoyancy=False``, since K8 does not fold the buoyancy) and
     vortex128 with ``fuse_project_advect`` for ``VORTEX_STEPS`` steps (K1 and
     K2o, never K3; after 10 steps bitwise the unfused run of phase 6);
  8. step multi256 at 256³ through ``Engine`` for ``MULTI_STEPS`` steps with
     the counters reset just before: K1, K6 and K7 must have launched and K2
     and K3 not, the fields stay finite, the mass grows, the plume rises
     over the first 40 steps, and the first 10 steps equal a rollout of the
     twins bitwise;
  9. step sharded512 at 512³ (unsharded, one card) for ``SHARDED_STEPS``
     steps the same way and report the peak device memory; then hold its
     kernels against their twins at 512³ on seeded fields (K1 with the
     buoyancy folded and two substeps, K1 density, K6, K7's divergence and
     gradient) and its first ``SHARDED_TWIN_STEPS`` steps against a rollout
     of the twins (bitwise);
 9b. hold K1 with a window of K = 2 and 3 (F = 1 and 3, one and two
     substeps, with and without vortex128's mask) and K4 with and without
     the mask (20 sweeps from a non-zero start) against their twins at 64³
     and 128³, bitwise; step plume64 at 64³ through ``Engine`` for
     ``PLUME_STEPS`` steps (K1 with K = 3 twice a step, K3 once, nothing
     else; mass grows, the plume rises; the first 3 steps bitwise the twin
     path); step smoke32 at 32³ for 10 steps on the card (no hand kernel:
     window 0 takes the plain path, as the JAX package takes XLA) and hold
     it bitwise against the same ``Engine`` on the CPU; run the BASELINE 64³
     density gate (tests/test_oracle3d_parity.py's config) on the kernel path
     for 3 steps re-synced to tests/oracle3d.py (rtol 1e-4, atol
     2e-5·scale); step plume64 and vortex128 with ``double_project`` (K4,
     and K4 with the mask) for 10 steps each, bitwise their twin paths, every
     K4 solve on the tiles by ``k4_launches``, and time K4 on both inputs
     beside its per-sweep route in turns;
 9c. the 2D reference-parity mode: hold K9 against its twin at 192² with
     scene_a's airfoil and at 128² with scene_b's circle (b = 0, 1, 2, both
     modes, 20 and 21 sweeps), bitwise; step scene_a at 192² through
     ``Engine`` for ``STEPS`` steps (exactly eight K9 launches a step, three
     of them smoothing solves, and no 3D kernel; finite fields, the emitted mass builds up from step 1 to 40
     and stays above step 1's, interior obstacle cells at zero velocity; the
     first 10 steps bitwise the twin path) and hold 3 steps on the card
     against the CPU port (rtol 1e-5, atol 2e-6·scale); step scene_b at 128²
     from a seeded state for ``VORTEX_STEPS`` steps (eight K9 launches a
     step, three smoothing); run
     tests/test_parity_step.py::test_step_parity_resync_64's config on the
     kernel path re-synced to tests/oracle2d.py (loaded by file path: NumPy
     only) for 4 steps (rtol 1e-5, atol 2e-6·scale);
 9d. bfloat16 fields and the windowed fused kernels: K1 (F = 3 and 1, and
     with vortex128's mask and three substeps), K3 (with and without the
     mask), K2, K2o and K8 on bfloat16 fields against their twins at 128³;
     K2, K2s, K2o and K8 with a K = 2, 3 density phase (K8 in both phases;
     float32 and bfloat16) and K1 with the folded emitter at K = 2, 3
     against their twins at 64³ and 128³, all bitwise; then through
     ``Engine``: bench128 in bfloat16 (K1 and K2 once a step; the first 10
     steps bitwise the twin path and within tests/test_bf16.py's bound of
     the float32 run), unfused (K1 twice, K3 once; bitwise the fused run)
     and with ``fuse_self_advect`` (K8; bitwise the fused run), vortex128 in
     bfloat16 (K1 twice, K3 once; with ``fuse_project_advect`` K1 and K2o,
     bitwise the unfused run), multi256 in bfloat16 for 10 steps (K1, K6,
     K7 on float32 copies), plume64 with the fused kernels (the substep
     scheme at one substep: K2 with K = 3, or K8 with K = 3; bitwise the
     preset after 10 steps), the 64³ gate fused (K2 with K = 2, bitwise
     unfused), bench128 with ``advect_window=2`` and ``fuse_emitter`` (K1 and
     K2s at K = 2, no emitter pass; within rtol 1e-5, atol 1e-6 of the
     composed run after 10 steps), and plume64 with turbulent noise or the
     FFT projection and smoke32 with the FFT projection, 3 steps each
     against the CPU port (rtol 1e-5, atol 1e-5·scale);
 10. time every path (steps/s), the p50 step+raymarch frame of bench128 and
     multi256 and each kernel beside its twin, with CUDA events after
     warm-up, K8 beside K1 + K2 and K2o beside K3 + K1 on the same inputs,
     K3 (float32 and bfloat16) beside the slab route from 128³ to 256³, K4
     per sweep, K9 a solve and a sweep (and on one block beside the 16-block
     cluster), and break a step of each path down by
     device time with ``torch.profiler`` (for scene_a and scene_b with the
     host-idle share); time each kernel of phase 9d beside its twin and the
     kernel it extends (the float32 kernel on the same values, or K = 1);
 11. K5, the sweep-blocked solve, and K14: hold K3 with ``sweep_block`` 2
     and 4 (bench128's bf16 solve without a mask; vortex128's with its
     mask), K2 with 2 and 4 (bench128's bf16 solve), K8 and K4 with 4 and
     K14 at K = 1 against their twins at 128³, bitwise (and K14 against the
     launched K1 → K3), each K5 call on the tiles by its route counter (K5's
     tile program, ``solve_launches``, ``full_step_launches``,
     ``k4_launches``); step bench128 with ``jacobi_sweep_block`` 2 and 4
     (K1 + K2; unfused K1 ×2 + K3), with ``fuse_self_advect`` and 4 (K8)
     and vortex128 with 2 and 4 (K1 ×2 + K3 with the mask's coefficient
     volume) through ``Engine`` for 10 steps each: exactly those launches,
     every solve on the tiles,
     bitwise the twin path, and one step from a seeded state within the
     bf16-solve class (3e-2·max) of the ``sweep_block = 1`` step; time each
     K5 call on the tiles beside its per-stage route in turns and beside the
     same kernel at T = 1 on the tiles (ms and µs a sweep) and its twin, K14
     beside K1 + K3, and bench128's steps/s and device ms a step at T = 1,
     2, 4 in turns;
 12. the explicit halo-exchange sharded step, sharded512 on 8 shards of the
     card (each shard's slabs its own: ``shard_state`` → ``ShardedState``,
     compared after ``unshard_state``): hold K10 against its twin on
     sharded512's slabs (72 planes at
     T = 4, 68 at T = 2; the first, a middle and the last shard; b = 0 and
     3) and on a 4-shard split of 128³ with vortex128's sphere, and K11
     (F = 3 self-advection and F = 1, two substeps) on sharded512's slabs,
     with vortex128's sphere and three substeps and at K = 2 on 4-shard
     splits of 128³, all bitwise; hold the 8-shard solve against K6 (rtol =
     atol = 2e-6) and the 8-shard advection against K1 (rtol 5e-4, atol
     5e-5) on the whole 512³ volume; K7e's divergence and gradient against
     their twins on the planes and halo planes of sharded512's first, a
     middle and the last shard and of a 4-shard split of 128³, bitwise;
     step sharded512 through
     ``sharded_step_fn(halo="explicit", halo_backend="pallas")`` at T = 4
     for ``HALO_STEPS`` steps and at T = 2 for ``HALO_T2_STEPS``, the
     counters at zero just before each: exactly 8·iters/T K10, 16 K11, 8
     K7e divergence and 8 K7e gradient launches a step and nothing else, no
     op through ``parallel/halo.gathered`` (``gathered_ops`` zero, printed),
     finite fields, the mass grows, the
     plume rises, the first ``HALO_TWIN_STEPS`` steps bitwise the twin path,
     the peak device memory reported; one step from a seeded state within
     1e-5·scale of the unsharded ``Engine``'s (K7 → K6 → K7); time K10 a
     round and a solve, K11 a call, K7e a call beside its twin and
     ``conv3d`` on the same shard's one-plane extended slab, and the
     steps/s of T = 4, T = 2 and the unsharded ``Engine`` in turns; run
     ``python -m fluidsim_tpu_torch.cli bench --preset sharded512 --mesh 8
     --halo explicit ...`` as a subprocess and check its JSON line;
 13. the sharded step's ``"rdma"`` backend and bfloat16 fields: hold K12
     against its twin on sharded512's 8 slabs (T = 2, 3, 4; b = 0..3; two
     chained rounds) and with vortex128's sphere on a 4-shard split of
     128³, K13 on float32, bfloat16 and bool arrays at depths 1–4 (8 shards
     of 512³, 4 of 128³), and K11 on bfloat16 slabs (F = 3 and 1; K = 1 on
     sharded512's slabs, K = 1 with the sphere and three substeps, K = 3
     with one, K = 2 and 3 with two at 128³), all bitwise; the 8-shard rdma
     solve bitwise the pallas solve and K6 on the whole 512³ volume; step
     sharded512 through ``sharded_step_fn(halo_backend="rdma")`` at T = 4
     for ``HALO_STEPS`` and T = 2 for ``HALO_T2_STEPS`` steps: exactly
     8·iters/T K12, 24 K13 (the solve's priming, two advections; K7e reads
     the projection's halo planes in place), 16 K11 and 16 K7e launches a step
     and nothing else, no gathered op,
     bitwise the ``"pallas"`` run after the same steps; sharded512 in
     bfloat16 on both backends for ``BF16_HALO_STEPS`` steps: exactly their
     kernels, bitwise each its twin path and each other, mass grows, the
     plume rises; time K12 a launch, K13's three calls of a step beside
     ``torch.cat``, bf16 K11, and steps/s with device ms by kernel of rdma
     (T = 4, 2, bf16), pallas and the unsharded ``Engine`` in turns; run
     ``cli bench ... --halo-backend rdma`` as a subprocess;
 14. K1's body at windows K = 4 and 5 (``csrc/advect.cuh``'s runtime-K
     body): each kernel that shares it against its twin, bitwise, on the
     presets' shapes (K1 on plume64 F = 3 and 1, with buoyancy and the
     emitter at 128³, with vortex128's mask and three substeps, in bf16;
     K2, K2s, K2o, bf16 K2, K8 f32 and bf16, K14; K11 on sharded512's
     middle slab, f32 and bf16), timed beside the twin; the Engine paths
     at K = 4 (4 steps) and 5 (2 steps): plume64, bench128 (plain,
     ``fuse_emitter``, ``fuse_self_advect``, bf16, bf16 +
     ``fuse_self_advect``) and vortex128 fused, each with exactly its
     kernels and bitwise its twin path; sharded512 on 8 shards with
     ``halo_backend="rdma"`` at K = 4, 5 in f32 and bf16 for
     ``WIDE_HALO_STEPS`` steps (exactly K12, K13 and K11; against the
     unsharded ``Engine``; at K = 4 one step bitwise the twin path); then
     the entry points as a user runs them, each a subprocess: ``cli
     save-config --preset plume64``, ``advect_window`` set to 4 in its
     JSON, ``cli run --config ... --steps 20 --db ... --checkpoint ...``
     (the store holds the run and its metric rows),
     ``Engine.from_checkpoint`` and 20 more steps bitwise a continuous
     40-step run, ``cli render --preset scene_a ... --html`` (2D colormap
     and streamlines, which rasterizer ran is printed) and ``cli render
     --config ... --html`` (3D raymarch); and a ``LiveServer`` in a thread:
     a frame, a drag that stirs, ``stop()``;
 15. the tiled Jacobi solve (``csrc/solve_tiled.cuh``) inside K2, K2s, K2o
     and K3, which every earlier phase already ran: K2 (bench128 on float32
     and bfloat16 fields, plume64's fused K = 3 density phase), K2s, K2o
     (vortex128) and K3 (bench128 unfused, vortex128 with its mask, a
     float32 solve at 128³) each bitwise its twin and timed with CUDA events
     beside the per-sweep route on the same inputs (µs a sweep from the call
     at the preset's sweeps and at one, beside a sweep's byte bound); then
     bench128 through ``Engine`` with the counters at zero: exactly one
     tiled solve and no per-sweep launch a step (the counters and the
     profile), steps/s and device ms a step in turns with the per-sweep
     route.  Phases 4–6 also check that bench128, its unfused path and
     vortex128 solved in one tiled launch a step;
 16. K1 and K11 at a window of K = 1 on tiles (``csrc/advect_tiled.cuh``),
     which every earlier phase already ran: bench128's self-advection with
     the buoyancy (and with the emitter on its density), vortex128's three
     substeps with the mask (F = 3 and 1, float32 and bfloat16), multi256's
     two substeps (F = 3 and 1), 512³ with two substeps (F = 3 with the
     buoyancy, F = 1) and K11 on shard 3 of sharded512's 8 slabs (F = 3 and
     1, float32 and bfloat16), each bitwise its twin on the tiled route and
     timed beside the twin and ``F.grid_sample`` (trilinear,
     ``align_corners=True``) on the same backtrace positions, the
     interpolation alone (the K1 and K11 rows' ``library_ms``); then
     bench128, vortex128, multi256 and sharded512 through ``Engine`` and
     sharded512 on 8 shards (rdma) through ``sharded_step_fn``, the counters
     at zero just before each: every K = 1 substep on the tiled route
     (``kernels/advect.advect_launches``), none a cell a thread;
 17. the Jacobi round of K6, K10 and K12 (``csrc/jacobi_pass.cuh``, T ≤ 4
     sweeps and the faces in one launch, K12's edge pushes from the last
     sweep), which phases 10, 12 and 13 already ran: K6 at 256³ and 512³ (20
     sweeps, b = 0 and 3), K10 on sharded512's first, a middle and the last
     slab and K12 on all eight at T = 4 (with a mask, and without) and 2,
     each bitwise its twin, timed with CUDA events beside its bound with its
     pass launches a call from ``torch.profiler`` (the round kernel alone);
     then sharded512 on 8 shards (rdma, T = 4), multi256 and sharded512
     through their entry points with the counters at zero: one launch a
     round (40 a step on 8 shards, five for K6's 20 sweeps), no faces or
     exchange-stage kernel;
 18. K8 and K14 on the tiled solve (``csrc/full_step.cuh``'s tiled route:
     the tiled solve's tiles, no grid barrier inside the solve) and K9 on
     strips in the cluster's distributed shared memory
     (``csrc/resident2d.cu``), which every earlier phase already ran, in a
     process of its own (``--phase-18``), whose torch.profiler records the
     card's events: K8 on bench128 (float32 and bfloat16 fields, one and two
     substeps) and plume64 (K = 3, 20 float32 sweeps) and K14 at 128³, each
     on both routes (the grid-stride one where no tiling is taken), bitwise
     its twin and K1 → K2 (K1 → K3), one launch on the route's counter
     (``resident.full_step_launches``, ``advect_project_launches``), timed in
     turns beside the composition; K9 (scene_a's airfoil at 192², scene_b's
     circle at 128², a smoothing and a fixed-rhs solve) on both routes
     (strips, L2) bitwise its twin, timed in turns, beside the floor (a
     launch of 20 cluster barriers alone); bench128 with ``fuse_full_step``'s
     options and scene_a through ``Engine`` on each route (the counters
     show it), steps/s and device ms a step in turns; K8 (float32 and
     bfloat16 fields, both solve dtypes) and K14 at windows K = 2..5 at
     128³ on both routes bitwise their twins with every cell of every
     substep on the <= 8-tap sum (``resident.tap_routes``), and with a NaN
     velocity or an inf density at 64³ bitwise but for NaN payloads, the
     substeps that read them on the full sum and the next launch on finite
     fields on the 8 taps again; K8 and K14 at K = 1..5 timed beside K1 →
     K2 (K1 → K3) on bench128's shape; K13's three calls of a sharded512
     step on 8 shards of the card by the union of a call's kernel intervals
     in a profiler trace (where shares overlap, summed durations overstate
     the card's time), beside the same arrays by ``torch.cat`` on the same
     streams;
 19. K1, K2's density phase and K11 at windows K >= 2 on tiles widened by K
     (``csrc/advect_window.cuh``), which phases 9b, 9d and 14 already ran:
     every K >= 2 call of PERF.md's table (K1 on plume64 at K = 3, 4, 5 and
     the 64³ gate at K = 2, F = 3 and 1; bench128's folds at K = 2, 4, 5;
     vortex128's mask and three substeps, bf16 at K = 4, 5; K2, K2s, K2o and
     bf16 K2's density phase; K11 on sharded512's middle slab, F = 3 and 1,
     float32 and bfloat16, at K = 4, 5), each bitwise its twin on the window
     route (``kernels/advect.advect_launches``), timed beside the twin and,
     for K1 and K11, ``F.grid_sample`` on the same clamped positions (the
     rows' ``library_ms``); NaN and inf at zero-weight taps and a NaN
     velocity at 64³ (K = 2..5, K1 float32 and bfloat16, K11, K2), bitwise
     but for NaN payloads; then plume64, the 64³ gate, their fused paths,
     bench128 window 2 + ``fuse_emitter``, the K = 4 and 5 Engine paths and
     sharded512 on 8 shards (rdma) at K = 4 and 5, the counters at zero just
     before each: every substep on the window route.
 20. no whole volume on any shard, run right after the build in a process of
     its own (``--phase-20``; its whole-volume FFT reference takes about
     65 GB of the card): from one
     seeded sharded512 state at 512³ on 8 shards of the card, 3 steps of
     MacCormack at ``advect_window=1`` (``halo="explicit"``, rdma, T = 4:
     K11 for its forward and backward advections, K13, K12, K7e) bitwise the
     unsharded ``Engine``'s 3 steps (K1 for both advections), and 3 steps of
     the FFT projection on ``halo="auto"`` (z-pencils by all-to-all) within
     1e-5·max|ref| per field of the unsharded ``Engine`` on the same plain
     ops, the class of two float32 FFT routes (each reference run, kept and
     freed before the mesh is built); ``gathered_ops`` empty and exact launches on both; steps/s
     and peak memory beside the card's name and power limit; a sharded
     checkpoint of the 8-shard MacCormack state written and read back on 8
     shards, on 4 and unsharded, bitwise.
The line before last is a JSON object describing each kernel (with the
least time the card could take for its work, ``bound_ms``), after a line
with the script's wall time; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = 200
VORTEX_STEPS = 100
MULTI_STEPS = 100
SHARDED_STEPS = 15
SHARDED_TWIN_STEPS = 3
HALO_STEPS = 20
HALO_T2_STEPS = 10
HALO_TWIN_STEPS = 4
BF16_HALO_STEPS = 10
PLUME_STEPS = 100
BF16_STEPS = 100
BF16_VORTEX_STEPS = 50
CROSSOVER_SIZES = (128, 160, 192, 224, 256)
SEED = 128

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside
# the tensor cores (both at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Float32 operations per interior cell, counted from the kernels' code
# (csrc/advect.cuh, csrc/project.cuh); the walls copy interior cells.
FRAC_OPS = 3 * 9      # per axis: dt0*v, sub, 2 bounds, 2 clip bounds (+2 adds), sub
RELU_OPS = 3 * 3      # per axis: negate, two max
COMB_OPS = 13 * 6     # per field: 9 x-, 3 y-, 1 z-combination of 6 operations
BUOY_OPS = 6          # per buoyant value: sub, 2 mul, sub, mul, add; at K = 1 once a
#                       staged value and once at the cell (csrc/advect_tiled.cuh)
MIRROR_OPS = 6        # per solid cell and component: 2 negates, 3 adds, div
DIV_OPS = 7
SWEEP_OPS = 7         # 5 neighbour adds, the rhs add, the coefficient multiply
JACOBI_OPS = 8        # K6: 5 neighbour adds, a*nbr, the x0 add, the inv_c multiply
GRAD_OPS = 3 * 5      # per component: sub, 2 mul, sub, damp
HAT_OPS = 4           # K1, K > 1: per axis and offset: sub, abs, sub, max
K4_MASK_OPS = 11      # K4 with the mask: SWEEP_OPS, 1 - m, * inv_c, m * x_init, the add
EMIT_OPS = 15         # per cell in the emitter's ball: 3 sub, 3 mul, 2 add, sqrt,
#                       compare, div, sub, mul, add


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps



def untiled(fn):
    """fn() with no tiling found for any solve (``kernels.resident.
    solve_tiles`` returning None): K5 in K2, K3 and K8 on its per-stage
    route, K4 one launch a sweep, the routes the tile program replaced."""
    from fluidsim_tpu_torch.kernels import resident as kres

    found = kres.solve_tiles
    kres.solve_tiles = lambda *args: None
    try:
        return fn()
    finally:
        kres.solve_tiles = found


def in_turns(tiled, other, reps: int) -> tuple:
    """CUDA-event ms of tiled() and of other() run through ``untiled``, in
    turns (tiled, other, other, tiled): ([tiled ms], [other ms])."""
    a = [cuda_ms(tiled, reps=reps)]
    b = [untiled(lambda: cuda_ms(other, reps=reps)) for _ in range(2)]
    a.append(cuda_ms(tiled, reps=reps))
    return a, b

def profile_ms(fn, reps: int, launches: dict = None) -> dict:
    """Device milliseconds per call of ``fn()``, by kernel name, from
    ``torch.profiler`` over ``reps`` calls (``launches``, when given, gets
    the device launches per call by name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key.replace("(anonymous namespace)::", "").replace("void ", "")
        name = name.split("(")[0][:90]
        out[name] = out.get(name, 0.0) + us / 1e3 / reps
        if launches is not None:
            launches[name] = launches.get(name, 0.0) + evt.count / reps
    return out


def union_ms(fn, key: str, reps: int, launches: int):
    """Milliseconds a call of ``fn()`` keeps the card on the kernels whose
    name holds ``key``: the union of their device intervals in a
    ``torch.profiler`` trace of ``reps`` calls, over ``reps`` (calls that
    do not overlap one another; kernels of one call on several streams may);
    and their summed durations over it.  None where the trace does not hold
    the call's ``launches`` kernels of that name for every call (a profile
    late in a process loses events, and a union of some is too short)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and key in e.name)
    if len(spans) != launches * reps:
        return None
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total, end = total + (b - a), b
        elif b > end:
            total, end = total + (b - end), b
    summed = sum(b - a for a, b in spans)
    return total / 1e3 / reps, summed / total


def profile_parts(fn, reps: int) -> dict:
    """Device milliseconds per call of ``fn()`` by part of the sharded step
    (``utils/profiling.sharded_step_part`` of the whole kernel name), from
    ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fluidsim_tpu_torch.utils.profiling import sharded_step_part

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        part = sharded_step_part(evt.key)
        out[part] = out.get(part, 0.0) + us / 1e3 / reps
    return out


def smooth(n, rng, dev, modes=6):
    """A float32 ``(n, n, n)`` tensor on ``dev``: a sum of plane waves of
    low wavenumber and unit amplitude, drawn from the NumPy generator
    ``rng``."""
    import numpy as np
    import torch

    ax = torch.arange(n, dtype=torch.float32, device=dev)
    out = torch.zeros((n, n, n), dtype=torch.float32, device=dev)
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = float(np.float32(rng.uniform(0, 2 * np.pi)))
        w = [float(v) for v in (2 * np.pi / n) * k.astype(np.float32)]
        out += torch.sin(w[0] * ax[:, None, None] + w[1] * ax[None, :, None]
                         + w[2] * ax[None, None, :] + phase)
    return out / float(np.sqrt(modes))


def velocity_field(n, rng, dev, scale):
    import torch

    return torch.stack([smooth(n, rng, dev) for _ in range(3)]) * scale


def density_field(n, rng, dev):
    return (20.0 * (1.0 + smooth(n, rng, dev))).clamp(min=0.0)


def worst(got, ref, rtol: float, atol: float):
    """(max abs error, whether |got − ref| ≤ atol + rtol·|ref| everywhere)."""
    import torch

    diff = (got - ref).abs()
    ok = bool(torch.all(diff <= atol + rtol * ref.abs()))
    return float(diff.max()), ok


def bound(nbytes: float, nops: float):
    """(least milliseconds for the work on an H100, the resource that sets it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def as_global(state):
    """``state`` as a global ``FluidState``: a sharded state unsharded."""
    if hasattr(state, "slabs"):
        from fluidsim_tpu_torch.parallel import unshard_state

        return unshard_state(state)
    return state


def mass_and_com_y(state):
    import torch

    d = as_global(state).density.double()
    ys = torch.arange(d.shape[1], dtype=torch.float64, device=d.device)[None, :, None]
    m = d.sum()
    return float(m), float((d * ys).sum() / m)


def check_state(st, steps, n, what):
    import torch

    st = as_global(st)
    if int(st.step) != steps or tuple(st.velocity.shape) != (3, n, n, n) \
            or tuple(st.density.shape) != (n, n, n):
        fail(f"{what}: unexpected state shape or step count")
    for name in ("density", "velocity", "pressure"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            fail(f"{what}: non-finite {name}")


def ran_only(launches, ran, what):
    """Fail unless exactly the kernels ``ran`` launched."""
    if any(launches[k] <= 0 for k in ran) or any(
            v != 0 for k, v in launches.items() if k not in ran):
        fail(f"{what} did not run {', '.join(ran)} alone: {launches}")


def near_twin(at10, twin_state, what):
    """The bf16-solve bound of tests/test_torch_step.py after 10 steps;
    ``at10`` holds the kernel path's fields after 10 steps."""
    for name, bnd in (("density", 1e-5), ("velocity", 1e-3)):
        r = getattr(twin_state, name)
        err = float((at10[name] - r).abs().max())
        scale = float(r.abs().max())
        say(f"# {what}: kernel path vs twin path, 10 steps, {name}: max abs diff "
            f"{err!r} (bound {bnd} x {scale!r})")
        if err > bnd * scale:
            fail(f"{what}: kernel path drifts from the twin path in {name}")


def main() -> None:
    t_start = time.perf_counter()
    # -- 1. the card ---------------------------------------------------
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        fail(f"PyTorch and NumPy are needed: {exc}")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs the card")
    if not (ROOT / "fluidsim_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no fluidsim_tpu_torch/)")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    say(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build --------------------------------------------------------
    import torch.nn.functional as F

    from fluidsim_tpu_torch.config import (
        ObstacleShape,
        SimConfig,
        preset_bench_128,
        preset_multi_emitter_256,
        preset_plume_64,
        preset_scene_a,
        preset_scene_b,
        preset_sharded_512,
        preset_smoke_box_32,
        preset_vortex_128,
    )
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.kernels.advect import (
        advect_launches,
        advect_multi_3d_kernel,
        advect_multi_3d_plain,
    )
    from fluidsim_tpu_torch.kernels.halo import (
        NO_WALL,
        advect_ext_kernel,
        advect_ext_plain,
        ext_halo,
        halo_exchange_rdma,
        halo_exchange_rdma_plain,
        jacobi_ext_kernel,
        jacobi_ext_plain,
        jacobi_ext_rdma,
        jacobi_ext_rdma_plain,
    )
    from fluidsim_tpu_torch.kernels.jacobi import (
        composite_block,
        jacobi_3d_kernel,
        jacobi_3d_plain,
        jacobi_3d_resident,
        jacobi_3d_resident_plain,
        k4_launches,
    )
    from fluidsim_tpu_torch.kernels.project import (
        divergence_3d_kernel,
        divergence_3d_plain,
        divergence_ext_kernel,
        divergence_ext_plain,
        gradient_3d_kernel,
        gradient_ext_kernel,
        gradient_ext_plain,
        project_3d_slab_kernel,
    )
    import fluidsim_tpu_torch.engine as engine_module
    from fluidsim_tpu_torch.kernels.resident import (
        advect_project_3d_resident,
        advect_project_3d_resident_plain,
        full_step_3d,
        full_step_3d_plain,
        full_step_blocks,
        project_3d_resident,
        project_3d_resident_plain,
        project_gradient,
        project_advect_density_3d,
        project_advect_density_3d_plain,
        solve_launches,
    )
    from fluidsim_tpu_torch.kernels.resident2d import (
        lin_solve_2d_resident,
        lin_solve_2d_resident_plain,
    )
    from fluidsim_tpu_torch.models.stable2d import simulate_step_2d
    from fluidsim_tpu_torch.models.stable3d import simulate_step_3d, sink_factor
    from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS
    from fluidsim_tpu_torch.ops.boundary import interior_mask, set_bnd_3d
    from fluidsim_tpu_torch.parallel import (
        gathered_ops,
        jacobi_3d_sharded,
        make_mesh,
        shard_state,
        sharded_step_fn,
        unshard_state,
    )
    from fluidsim_tpu_torch.parallel.halo import advect_multi_3d_sharded
    from fluidsim_tpu_torch.ops.forces import (
        buoyancy_force,
        enforce_obstacle_boundaries_3d,
        vorticity_confinement_3d,
    )
    from fluidsim_tpu_torch.render.raymarch import render_frame_3d
    from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
    from fluidsim_tpu_torch.scene.sources import (
        apply_custom_source,
        emitter_fold_operand,
        src_field_add,
    )
    from fluidsim_tpu_torch.state import zeros_state

    t0 = time.perf_counter()
    _build.load_library()
    say(f"# build: {time.perf_counter() - t0:.2f} s")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Function properties" in line or "registers" in line \
                    or "spill" in line or "Compiling entry" in line:
                say(f"# ptxas: {line.strip()}")

    counters = {"K1": advect_multi_3d_kernel, "K2": project_advect_density_3d,
                "K3": project_3d_resident, "K6": jacobi_3d_kernel,
                "K7 div": divergence_3d_kernel, "K7 grad": gradient_3d_kernel,
                "K8": full_step_3d, "K4": jacobi_3d_resident, "K9": lin_solve_2d_resident}

    def counters_to_zero():
        for fn in counters.values():
            fn.launches = 0
        gathered_ops.clear()
        lin_solve_2d_resident.smooth_launches = 0
        for route in solve_launches:
            solve_launches[route] = 0
        for route in advect_launches:
            advect_launches[route] = 0
        for route in k4_launches:
            k4_launches[route] = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    # -- 20. MacCormack and the FFT projection per shard, the sharded checkpoint --
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 20")
    # First, in a process of its own: its whole-volume FFT reference at 512³
    # takes about 65 GB of the card, more than is left beside what the later
    # phases of this process hold.
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase-20"],
                           cwd=ROOT, timeout=900)
    if child.returncode != 0:
        fail(f"phase 20 failed (exit code {child.returncode})")

    # -- 3. each kernel against its twin at 128³ -------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 3")
    cfg = preset_bench_128()
    n = cfg.current_size
    vol = n ** 3
    interior = (n - 2) ** 3
    dt = cfg.effective_params()[0]
    damp = sink_factor(dt, cfg.velocity_damping)
    ddamp = sink_factor(dt, cfg.density_dissipation)
    rng = np.random.default_rng(SEED)
    # Plume-scale fields: |v| up to about 10 cells per unit time (a
    # backtrace of up to ~1.3 cells, so the window clamp is exercised) and
    # a positive density.
    vel = velocity_field(n, rng, dev, 4.0)
    dens = density_field(n, rng, dev)
    buoy = (dens, cfg.buoyancy, cfg.ambient_density, cfg.gravity)
    solve = cfg.solve_dtype

    def k1():
        return advect_multi_3d_kernel((1, 2, 3), vel, vel, dt, buoy=buoy)

    def k1_plain():
        return advect_multi_3d_plain((1, 2, 3), vel, vel, dt, buoy=buoy)

    def k2(v=vel, **kw):
        return project_advect_density_3d(v, dens, cfg.jacobi_iters, dt,
                                         solve_dtype=solve, damp=damp,
                                         dens_damp=ddamp, **kw)

    def k2_plain(**kw):
        return project_advect_density_3d_plain(vel, dens, cfg.jacobi_iters, dt,
                                               solve_dtype=solve, damp=damp,
                                               dens_damp=ddamp, **kw)

    def k8(**kw):
        return full_step_3d(vel, dens, cfg.jacobi_iters, dt, solve_dtype=solve,
                            damp=damp, dens_damp=ddamp, **kw)

    def k8_plain(**kw):
        return full_step_3d_plain(vel, dens, cfg.jacobi_iters, dt, solve_dtype=solve,
                                  damp=damp, dens_damp=ddamp, **kw)

    def k1_then_k2(n_sub=1):
        """K8's work as K1 (no buoyancy: K8 does not fold it) then K2."""
        return k2(advect_multi_3d_kernel((1, 2, 3), vel, vel, dt, n_sub=n_sub),
                  n_sub=n_sub)

    got, ref = k1(), k1_plain()
    torch.cuda.synchronize()
    k1_err, ok = worst(got, ref, 1e-5, 1e-6)
    say(f"# K1 vs twin at {n}^3: max abs err {k1_err!r} "
        f"(bitwise {torch.equal(got, ref)}; bound rtol 1e-5, atol 1e-6)")
    if not ok:
        fail("K1 disagrees with its twin")
    got, ref = k2(), k2_plain()
    torch.cuda.synchronize()
    k2_err = 0.0
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        err = float((g - r).abs().max())
        k2_err = max(k2_err, err)
        say(f"# K2 vs twin at {n}^3 ({name}): max abs err {err!r} "
            f"(bitwise {torch.equal(g, r)}; bound: bitwise)")
        if not torch.equal(g, r):
            fail(f"K2 {name} disagrees with its twin")

    # vortex128: three substeps, the preset's sphere, 20 bf16 sweeps.
    vcfg = preset_vortex_128()
    vdt = vcfg.effective_params()[0]
    n_sub = vcfg.advect_substeps
    obst = torch.from_numpy(build_obstacle_mask(vcfg)).to(dev)
    solid = obst & interior_mask(obst.shape, dev)
    n_solid = int(solid.sum())
    say(f"# vortex128 mask: {int(obst.sum())} solid cells, {n_solid} interior")
    # |v| up to about 30 cells per unit time: a backtrace of up to ~1.3
    # cells per substep.
    vvel = velocity_field(n, rng, dev, 12.0)
    vdens = density_field(n, rng, dev)

    def k1v(f=vvel, bs=(1, 2, 3)):
        return advect_multi_3d_kernel(bs, f, vvel, vdt, obst=obst, n_sub=n_sub)

    def k1v_plain(f=vvel, bs=(1, 2, 3)):
        return advect_multi_3d_plain(bs, f, vvel, vdt, obst=obst, n_sub=n_sub)

    def k1v_dens():
        return k1v(vdens[None], (0,))

    def k1v_dens_plain():
        return k1v_plain(vdens[None], (0,))

    def k3(mask=obst):
        return project_3d_resident(vvel, vcfg.jacobi_iters, obst=mask,
                                   solve_dtype=vcfg.solve_dtype)

    def k3_plain(mask=obst):
        return project_3d_resident_plain(vvel, vcfg.jacobi_iters, obst=mask,
                                         solve_dtype=vcfg.solve_dtype)

    k1v_err = 0.0
    for what, fn, plain in (("F=3", k1v, k1v_plain), ("F=1", k1v_dens, k1v_dens_plain)):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err, ok = worst(got, ref, 1e-5, 1e-6)
        k1v_err = max(k1v_err, err)
        say(f"# K1 (n_sub={n_sub}, mask, {what}) vs twin at {n}^3: max abs err "
            f"{err!r} (bitwise {torch.equal(got, ref)}; bound rtol 1e-5, atol 1e-6)")
        if not ok:
            fail(f"K1 with substeps and the mask ({what}) disagrees with its twin")
        if what == "F=1" and bool((got[0][solid] != 0).any()):
            fail("K1 left a nonzero density in an interior obstacle cell")
    k3_err = {}
    for what, mask in (("mask", obst), ("no mask", None)):
        got, ref = k3(mask), k3_plain(mask)
        torch.cuda.synchronize()
        k3_err[what] = 0.0
        for name, g, r in zip(("velocity", "pressure"), got, ref):
            err = float((g - r).abs().max())
            k3_err[what] = max(k3_err[what], err)
            say(f"# K3 ({what}) vs twin at {n}^3 ({name}): max abs err {err!r} "
                f"(bitwise {torch.equal(g, r)}; bound: bitwise)")
            if not torch.equal(g, r):
                fail(f"K3 ({what}) {name} disagrees with its twin")

    # -- 3 (cont.). the fused variants at 128³ -----------------------------------
    # bench128's emitter as the kernels read it; vortex128's sinks are off.
    src = emitter_fold_operand(cfg, torch.full((), dt, device=dev))
    vdamp = sink_factor(vdt, vcfg.velocity_damping) if vcfg.velocity_damping else 1.0
    vddamp = (sink_factor(vdt, vcfg.density_dissipation)
              if vcfg.density_dissipation else 1.0)

    def k2o():
        return project_advect_density_3d(vvel, vdens, vcfg.jacobi_iters, vdt, obst=obst,
                                         n_sub=n_sub, solve_dtype=vcfg.solve_dtype,
                                         damp=vdamp, dens_damp=vddamp)

    def k2o_plain():
        return project_advect_density_3d_plain(vvel, vdens, vcfg.jacobi_iters, vdt,
                                               obst=obst, n_sub=n_sub,
                                               solve_dtype=vcfg.solve_dtype, damp=vdamp,
                                               dens_damp=vddamp)

    def k3_then_k1():
        """K2o's work as K3 then K1 on the density."""
        v, _ = k3()
        return advect_multi_3d_kernel((0,), vdens[None], v, vdt, obst=obst, n_sub=n_sub)

    fused_fns = {
        "K1 src": (lambda: advect_multi_3d_kernel((1, 2, 3), vel, vel, dt, buoy=buoy, src=src),
                   lambda: advect_multi_3d_plain((1, 2, 3), vel, vel, dt, buoy=buoy, src=src)),
        "K2s": (lambda: k2(src=src), lambda: k2_plain(src=src)),
        "K2o": (k2o, k2o_plain),
        "K2 n_sub=2": (lambda: k2(n_sub=2), lambda: k2_plain(n_sub=2)),
        "K8": (k8, k8_plain),
        "K8 n_sub=2": (lambda: k8(n_sub=2), lambda: k8_plain(n_sub=2)),
    }
    say(f"# K8 grid: the tiled route {full_step_blocks(solve, n=n, iters=cfg.jacobi_iters)} "
        f"blocks (bf16 solve), {full_step_blocks(None, n=n, iters=cfg.jacobi_iters)} (float32 "
        f"solve); the grid-stride route {full_step_blocks(solve)} blocks of 256 threads (bf16 "
        f"solve), {full_step_blocks(None)} (float32 solve); "
        f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs")
    fused_err = {}
    for key, (fn, plain) in fused_fns.items():
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        if torch.is_tensor(got):
            got, ref = (got,), (ref,)
        fused_err[key] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        say(f"# {key} vs twin at {n}^3: max abs err {fused_err[key]!r} (bitwise {same}; "
            "bound: bitwise)")
        if not same:
            fail(f"{key} disagrees with its twin")
    for k8_sub in (1, 2):
        got, ref = k8(n_sub=k8_sub), k1_then_k2(k8_sub)
        torch.cuda.synchronize()
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        say(f"# K8 (n_sub={k8_sub}) vs launched K1 -> K2 at {n}^3: max abs diff "
            f"{max(float((g - r).abs().max()) for g, r in zip(got, ref))!r}, bitwise {same}")
        if not same:
            fail(f"K8 (n_sub={k8_sub}) differs from K1 -> K2")
    got, ref = k2o(), (*k3(), k3_then_k1()[0] * vddamp)
    torch.cuda.synchronize()
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        fail("K2o differs from K3 -> K1 density")
    del got, ref

    # -- 3 (cont.). the slab route's kernels at 256³ ---------------------------
    mcfg = preset_multi_emitter_256()
    scfg = preset_sharded_512()
    mn = mcfg.current_size
    mvol, minterior = mn ** 3, (mn - 2) ** 3
    mdt = mcfg.effective_params()[0]
    sdt = scfg.effective_params()[0]
    m_sub = mcfg.advect_substeps
    iters = mcfg.jacobi_iters
    # |v| up to about 0.5: a backtrace of up to ~1.3 cells per substep at
    # multi256's dt, so the window clamp is exercised.
    mvel = velocity_field(mn, rng, dev, 0.5)
    mdens = density_field(mn, rng, dev)
    mdiv = divergence_3d_plain(mvel)
    mzero = torch.zeros_like(mdiv)
    mp = jacobi_3d_plain(0, mzero, mdiv, 1.0, 6.0, iters)
    diff_coef = (0.13, 1.0 + 6 * 0.13)
    slab_fns = {
        "K6": (lambda: jacobi_3d_kernel(0, mzero, mdiv, 1.0, 6.0, iters),
               lambda: jacobi_3d_plain(0, mzero, mdiv, 1.0, 6.0, iters)),
        "K6 b=3": (lambda: jacobi_3d_kernel(3, mvel[2], mvel[2], *diff_coef, iters),
                   lambda: jacobi_3d_plain(3, mvel[2], mvel[2], *diff_coef, iters)),
        "K7 div": (lambda: divergence_3d_kernel(mvel), lambda: divergence_3d_plain(mvel)),
        "K7 grad": (lambda: gradient_3d_kernel(mvel, mp), lambda: project_gradient(mvel, mp)),
        "K1m": (lambda: advect_multi_3d_kernel((1, 2, 3), mvel, mvel, mdt, n_sub=m_sub),
                lambda: advect_multi_3d_plain((1, 2, 3), mvel, mvel, mdt, n_sub=m_sub)),
        "K1m density": (
            lambda: advect_multi_3d_kernel((0,), mdens[None], mvel, mdt, n_sub=m_sub),
            lambda: advect_multi_3d_plain((0,), mdens[None], mvel, mdt, n_sub=m_sub)),
    }
    slab_err = {}
    for key, (fn, plain) in slab_fns.items():
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        slab_err[key], ok = worst(got, ref, 1e-5, 1e-6 * float(ref.abs().max()))
        say(f"# {key} vs twin at {mn}^3: max abs err {slab_err[key]!r} (bitwise "
            f"{torch.equal(got, ref)}; bound rtol 1e-5, atol 1e-6 x max|ref|)")
        if not ok or got.shape != ref.shape:
            fail(f"{key} disagrees with its twin at {mn}^3")
    got, ref = project_3d_slab_kernel(mvel, iters), project_3d_resident(mvel, iters)
    torch.cuda.synchronize()
    for name, g, r in zip(("velocity", "pressure"), got, ref):
        say(f"# slab route vs K3 (float32, no mask) at {mn}^3 ({name}): max abs diff "
            f"{float((g - r).abs().max())!r}, bitwise {torch.equal(g, r)}")
        if not torch.equal(g, r):
            fail(f"the slab route differs from K3 in {name}")
    del got, ref

    # -- 4. bench128 through Engine ------------------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 4")
    # Count the engine's full-grid emitter passes (the folded paths run none).
    emitter_passes = [0]

    def counted_source(*args, **kwargs):
        emitter_passes[0] += 1
        return apply_custom_source(*args, **kwargs)

    engine_module.apply_custom_source = counted_source
    eng = Engine(cfg, device="cuda")
    counters_to_zero()
    emitter_passes[0] = 0
    eng.step(1)
    mass1, com1 = mass_and_com_y(eng.state)
    eng.step(9)
    at10 = {k: getattr(eng.state, k).clone() for k in ("density", "velocity", "pressure")}
    eng.step(30)
    mass40, com40 = mass_and_com_y(eng.state)
    eng.step(STEPS - 40)
    torch.cuda.synchronize()
    bench_launches = counts()
    mass_end, com_end = mass_and_com_y(eng.state)
    say(f"# main path: {STEPS} steps at {n}^3, launches {bench_launches}, full-grid "
        f"emitter passes {emitter_passes[0]}")
    if emitter_passes[0] != STEPS:
        fail("the bench128 path did not run its emitter once a step")
    say(f"# density mass: step 1 {mass1!r}, step 40 {mass40!r}, step {STEPS} {mass_end!r}")
    say(f"# density y centre of mass: step 1 {com1!r}, step 40 {com40!r}, "
        f"step {STEPS} {com_end!r}")
    ran_only(bench_launches, ("K1", "K2"), "the bench128 path")
    say(f"# bench128 solves: {dict(solve_launches)} (tiled solves, per-sweep launches)")
    if solve_launches != {"tiled": STEPS, "sweep": 0}:
        fail("the bench128 path did not solve in one tiled launch a step")
    check_state(eng.state, STEPS, n, "bench128")
    if not (mass_end > mass40 > mass1 > 0.0):
        fail("density mass does not grow")
    if not com40 > com1:
        fail("the plume does not rise over the first 40 steps")

    twin = Engine(cfg, device="cuda", kernels=PLAIN_TWINS)
    twin.step(10)
    near_twin(at10, twin.state, "bench128")

    # -- 5. bench128 with the projection unfused (K3 without a mask) ---------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 5")
    ucfg = cfg.replace(fuse_project_advect=False)
    ueng = Engine(ucfg, device="cuda")
    counters_to_zero()
    ueng.step(10)
    torch.cuda.synchronize()
    unfused_launches = counts()
    say(f"# bench128 unfused: 10 steps, launches {unfused_launches}")
    ran_only(unfused_launches, ("K1", "K3"), "the unfused bench128 path")
    if solve_launches != {"tiled": 10, "sweep": 0}:
        fail(f"the unfused bench128 path solved {dict(solve_launches)}, not 10 tiled")
    for name, ref in at10.items():
        err = float((getattr(ueng.state, name) - ref).abs().max())
        say(f"# bench128 unfused vs fused, 10 steps, {name}: max abs diff {err!r}")
        if err != 0.0:
            fail(f"the unfused bench128 step differs from the fused one in {name}")

    # -- 6. vortex128 through Engine -----------------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 6")
    veng = Engine(vcfg, device="cuda")
    counters_to_zero()
    veng.step(1)
    vmass1, vcom1 = mass_and_com_y(veng.state)
    vsolid_after_1 = bool((veng.state.velocity[:, solid] == 0).all())
    veng.step(9)
    vat10 = {k: getattr(veng.state, k).clone() for k in ("density", "velocity", "pressure")}
    veng.step(30)
    vmass40, vcom40 = mass_and_com_y(veng.state)
    veng.step(VORTEX_STEPS - 40)
    torch.cuda.synchronize()
    vortex_launches = counts()
    vmass_end, vcom_end = mass_and_com_y(veng.state)
    say(f"# vortex128: {VORTEX_STEPS} steps at {n}^3, launches {vortex_launches}")
    say(f"# vortex128 density mass: step 1 {vmass1!r}, step 40 {vmass40!r}, "
        f"step {VORTEX_STEPS} {vmass_end!r}")
    say(f"# vortex128 density y centre of mass: step 1 {vcom1!r}, step 40 {vcom40!r}, "
        f"step {VORTEX_STEPS} {vcom_end!r}")
    ran_only(vortex_launches, ("K1", "K3"), "the vortex128 path")
    say(f"# vortex128 solves: {dict(solve_launches)}")
    if solve_launches != {"tiled": VORTEX_STEPS, "sweep": 0}:
        fail("the vortex128 path did not solve in one tiled launch a step")
    check_state(veng.state, VORTEX_STEPS, n, "vortex128")
    if not (vmass_end > vmass1 > 0.0 and vmass40 > vmass1):
        fail("vortex128: density mass does not grow")
    if not vcom40 > vcom1:
        fail("vortex128: the plume does not rise over the first 40 steps")
    vsolid_end = bool((veng.state.velocity[:, solid] == 0).all())
    say(f"# vortex128 interior obstacle cells at zero velocity: after step 1 "
        f"{vsolid_after_1}, after step {VORTEX_STEPS} {vsolid_end}")
    if not (vsolid_after_1 and vsolid_end):
        fail("vortex128: an interior obstacle cell holds a nonzero velocity")
    vtwin = Engine(vcfg, device="cuda", kernels=PLAIN_TWINS)
    vtwin.step(10)
    near_twin(vat10, vtwin.state, "vortex128")

    # -- 7. the fused variants through Engine ------------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 7")
    def run_fused(fcfg, steps, what):
        """``steps`` steps of ``fcfg`` with the counters at zero before;
        returns the engine, the launches, the state after 10 steps and the
        mass at step 1 and at the end."""
        feng = Engine(fcfg, device="cuda")
        counters_to_zero()
        emitter_passes[0] = 0
        feng.step(1)
        fmass1, fcom1 = mass_and_com_y(feng.state)
        feng.step(9)
        fat10 = {k: getattr(feng.state, k).clone() for k in ("density", "velocity", "pressure")}
        feng.step(steps - 10)
        torch.cuda.synchronize()
        launches = counts()
        fmass_end, fcom_end = mass_and_com_y(feng.state)
        say(f"# {what}: {steps} steps at {n}^3, launches {launches}, full-grid emitter "
            f"passes {emitter_passes[0]}")
        say(f"# {what} density mass: step 1 {fmass1!r}, step {steps} {fmass_end!r}; "
            f"y centre of mass {fcom1!r} -> {fcom_end!r}")
        check_state(feng.state, steps, n, what)
        if not fmass_end > fmass1 > 0.0:
            fail(f"{what}: density mass does not grow")
        return feng, launches, fat10

    def exactly(launches, expected, what):
        if launches != {k: expected.get(k, 0) for k in launches}:
            fail(f"{what} launched {launches}, not {expected}")

    def against(at10, ref10, what, rtol=0.0, atol=0.0, steps=10):
        for name, got in at10.items():
            ref = ref10[name]
            err, ok = worst(got, ref, rtol, atol)
            say(f"# {what}, {steps} steps, {name}: max abs diff {err!r} (bitwise "
                f"{torch.equal(got, ref)}; bound rtol {rtol}, atol {atol})")
            if not ok:
                fail(f"{what} differs in {name}")

    feng_emit, emit_launches, emit10 = run_fused(
        cfg.replace(fuse_emitter=True), STEPS, "bench128 + fuse_emitter")
    exactly(emit_launches, {"K1": STEPS, "K2": STEPS}, "bench128 + fuse_emitter")
    if emitter_passes[0] != 0:
        fail("bench128 + fuse_emitter ran a full-grid emitter pass")
    against(emit10, at10, "bench128 + fuse_emitter vs composed", 1e-5, 1e-6)

    feng_k8, k8_launches, k8at10 = run_fused(
        cfg.replace(fuse_self_advect=True), STEPS, "bench128 + fuse_self_advect")
    exactly(k8_launches, {"K8": STEPS}, "bench128 + fuse_self_advect")
    nofold = Engine(cfg.replace(fuse_buoyancy=False), device="cuda")
    nofold.step(10)
    against(k8at10, {k: getattr(nofold.state, k) for k in k8at10},
            "bench128 + fuse_self_advect vs fuse_buoyancy=False")
    del nofold

    feng_v, vfused_launches, vfat10 = run_fused(
        vcfg.replace(fuse_project_advect=True), VORTEX_STEPS, "vortex128 + fuse_project_advect")
    exactly(vfused_launches, {"K1": VORTEX_STEPS, "K2": VORTEX_STEPS},
            "vortex128 + fuse_project_advect")
    against(vfat10, vat10, "vortex128 + fuse_project_advect vs unfused")
    if not bool((feng_v.state.velocity[:, solid] == 0).all()):
        fail("vortex128 + fuse_project_advect: an interior obstacle cell holds a velocity")
    engine_module.apply_custom_source = apply_custom_source

    # -- 8. multi256 through Engine -------------------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 8")
    slab_kernels = ("K1", "K6", "K7 div", "K7 grad")
    meng = Engine(mcfg, device="cuda")
    counters_to_zero()
    meng.step(1)
    mmass1, mcom1 = mass_and_com_y(meng.state)
    meng.step(9)
    mat10 = {k: getattr(meng.state, k).clone() for k in ("density", "velocity", "pressure")}
    meng.step(30)
    mmass40, mcom40 = mass_and_com_y(meng.state)
    meng.step(MULTI_STEPS - 40)
    torch.cuda.synchronize()
    multi_launches = counts()
    mmass_end, mcom_end = mass_and_com_y(meng.state)
    say(f"# multi256: {MULTI_STEPS} steps at {mn}^3, launches {multi_launches}")
    say(f"# multi256 density mass: step 1 {mmass1!r}, step 40 {mmass40!r}, "
        f"step {MULTI_STEPS} {mmass_end!r}")
    say(f"# multi256 density y centre of mass: step 1 {mcom1!r}, step 40 {mcom40!r}, "
        f"step {MULTI_STEPS} {mcom_end!r}")
    ran_only(multi_launches, slab_kernels, "the multi256 path")
    check_state(meng.state, MULTI_STEPS, mn, "multi256")
    if not (mmass_end > mmass1 > 0.0 and mmass40 > mmass1):
        fail("multi256: density mass does not grow")
    if not mcom40 > mcom1:
        fail("multi256: the plume does not rise over the first 40 steps")
    mtwin = Engine(mcfg, device="cuda", kernels=PLAIN_TWINS)
    mtwin.step(10)
    for name, got in mat10.items():
        ref = getattr(mtwin.state, name)
        say(f"# multi256: kernel path vs twin path, 10 steps, {name}: max abs diff "
            f"{float((got - ref).abs().max())!r} (bitwise {torch.equal(got, ref)})")
        if not torch.equal(got, ref):
            fail(f"multi256: the kernel path differs from the twin path in {name}")

    # -- 9. sharded512 on one card --------------------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 9")
    sn = scfg.current_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    seng = Engine(scfg, device="cuda")
    counters_to_zero()
    seng.step(1)
    smass1, scom1 = mass_and_com_y(seng.state)
    seng.step(SHARDED_TWIN_STEPS - 1)
    sat = {k: getattr(seng.state, k).clone() for k in ("density", "velocity", "pressure")}
    seng.step(SHARDED_STEPS - SHARDED_TWIN_STEPS)
    torch.cuda.synchronize()
    sharded_launches = counts()
    smass_end, scom_end = mass_and_com_y(seng.state)
    peak = torch.cuda.max_memory_allocated()
    say(f"# sharded512: {SHARDED_STEPS} steps at {sn}^3, launches {sharded_launches}")
    say(f"# sharded512 density mass: step 1 {smass1!r}, step {SHARDED_STEPS} "
        f"{smass_end!r}; y centre of mass {scom1!r} -> {scom_end!r}")
    say(f"sharded512 peak device memory: {peak!r} bytes allocated, of which "
        f"{peak - mem_before!r} above what earlier phases hold [{card}]")
    ran_only(sharded_launches, slab_kernels, "the sharded512 path")
    check_state(seng.state, SHARDED_STEPS, sn, "sharded512")
    if not smass_end > smass1 > 0.0:
        fail("sharded512: density mass does not grow")
    stwin = Engine(scfg, device="cuda", kernels=PLAIN_TWINS)
    stwin.step(SHARDED_TWIN_STEPS)
    for name, got in sat.items():
        ref = getattr(stwin.state, name)
        say(f"# sharded512: kernel path vs twin path, {SHARDED_TWIN_STEPS} steps, {name}: "
            f"max abs diff {float((got - ref).abs().max())!r} (bitwise {torch.equal(got, ref)})")
        if not torch.equal(got, ref):
            fail(f"sharded512: the kernel path differs from the twin path in {name}")
    del sat, stwin, got, ref

    # Its kernels against their twins at 512³ on seeded fields, each twin's
    # result freed before the next.  sharded512's dt·N is multi256's, so the
    # velocity's scale is the one at 256³ and the window clamp is exercised.
    s_sub = scfg.advect_substeps
    s_iters = scfg.jacobi_iters
    svel = velocity_field(sn, rng, dev, 0.5)
    sdens = density_field(sn, rng, dev)
    sbuoy = (sdens, scfg.buoyancy, scfg.ambient_density, scfg.gravity)
    sdiv = divergence_3d_plain(svel)
    szero = torch.zeros_like(sdiv)
    sp = jacobi_3d_plain(0, szero, sdiv, 1.0, 6.0, s_iters)
    sharded_fns = {
        "K1s": (lambda: advect_multi_3d_kernel((1, 2, 3), svel, svel, sdt, buoy=sbuoy,
                                               n_sub=s_sub),
                lambda: advect_multi_3d_plain((1, 2, 3), svel, svel, sdt, buoy=sbuoy,
                                              n_sub=s_sub)),
        "K1s density": (
            lambda: advect_multi_3d_kernel((0,), sdens[None], svel, sdt, n_sub=s_sub),
            lambda: advect_multi_3d_plain((0,), sdens[None], svel, sdt, n_sub=s_sub)),
        "K6s": (lambda: jacobi_3d_kernel(0, szero, sdiv, 1.0, 6.0, s_iters),
                lambda: jacobi_3d_plain(0, szero, sdiv, 1.0, 6.0, s_iters)),
        "K7s div": (lambda: divergence_3d_kernel(svel), lambda: divergence_3d_plain(svel)),
        "K7s grad": (lambda: gradient_3d_kernel(svel, sp),
                     lambda: project_gradient(svel, sp)),
    }
    for key, (fn, plain) in sharded_fns.items():
        got = fn()
        ref = plain()
        torch.cuda.synchronize()
        slab_err[key], ok = worst(got, ref, 1e-5, 1e-6 * float(ref.abs().max()))
        say(f"# {key} vs twin at {sn}^3: max abs err {slab_err[key]!r} (bitwise "
            f"{torch.equal(got, ref)}; bound rtol 1e-5, atol 1e-6 x max|ref|)")
        if not ok or got.shape != ref.shape:
            fail(f"{key} disagrees with its twin at {sn}^3")
        del got, ref
    torch.cuda.empty_cache()

    # -- 9b. plume64, smoke32, the 64³ gate and double_project -------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 9b")
    # K1 with a window of K = 2 and 3, and K4 with and without the mask,
    # against their twins at 64³ and 128³ on seeded fields.  At plume64's dt
    # a backtrace reaches up to about 3 cells, so K = 2 clamps.
    pcfg = preset_plume_64()
    pn = pcfg.current_size
    pdt = pcfg.effective_params()[0]
    win_err = {}
    for wn in (64, 128):
        wvel = velocity_field(wn, rng, dev, 30.0 / (wn - 2))
        wdens = density_field(wn, rng, dev)
        wmask = torch.from_numpy(build_obstacle_mask(vcfg.replace(size=wn))).to(dev)
        for k in (2, 3):
            for what, bs, f in (("F=3", (1, 2, 3), wvel), ("F=1", (0,), wdens[None])):
                for sub in (1, 2):
                    for mname, m in (("no mask", None), ("mask", wmask)):
                        got = advect_multi_3d_kernel(bs, f, wvel, pdt, obst=m, window=k,
                                                     n_sub=sub)
                        ref = advect_multi_3d_plain(bs, f, wvel, pdt, obst=m, window=k,
                                                    n_sub=sub)
                        torch.cuda.synchronize()
                        err = float((got - ref).abs().max())
                        key = (k, what)
                        win_err[key] = max(win_err.get(key, 0.0), err)
                        say(f"# K1 window={k} {what} n_sub={sub} {mname} vs twin at {wn}^3: "
                            f"max abs err {err!r} (bitwise {torch.equal(got, ref)}; "
                            "bound: bitwise)")
                        if not torch.equal(got, ref):
                            fail(f"K1 window={k} ({what}, n_sub={sub}, {mname}) disagrees "
                                 f"with its twin at {wn}^3")
        wx, wx0 = wvel[0].contiguous(), wvel[1].contiguous()
        for mname, m in (("no mask", None), ("mask", wmask)):
            got = jacobi_3d_resident(0, wx, wx0, 1.0, 6.0, 20, obst=m)
            ref = jacobi_3d_resident_plain(0, wx, wx0, 1.0, 6.0, 20, obst=m)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            win_err[("K4", mname)] = max(win_err.get(("K4", mname), 0.0), err)
            say(f"# K4 ({mname}, 20 sweeps from a non-zero start) vs twin at {wn}^3: max abs "
                f"err {err!r} (bitwise {torch.equal(got, ref)}; bound: bitwise)")
            if not torch.equal(got, ref):
                fail(f"K4 ({mname}) disagrees with its twin at {wn}^3")
    del wvel, wdens, wmask, wx, wx0, got, ref

    # plume64 through Engine: K1 (K = 3) twice a step, K3 once, nothing else.
    peng = Engine(pcfg, device="cuda")
    counters_to_zero()
    peng.step(1)
    pmass1, pcom1 = mass_and_com_y(peng.state)
    peng.step(2)
    pat3 = {k: getattr(peng.state, k).clone() for k in ("density", "velocity", "pressure")}
    peng.step(PLUME_STEPS - 3)
    torch.cuda.synchronize()
    plume_launches = counts()
    pmass_end, pcom_end = mass_and_com_y(peng.state)
    say(f"# plume64: {PLUME_STEPS} steps at {pn}^3, launches {plume_launches}")
    say(f"# plume64 density mass: step 1 {pmass1!r}, step {PLUME_STEPS} {pmass_end!r}; "
        f"y centre of mass {pcom1!r} -> {pcom_end!r}")
    exactly(plume_launches, {"K1": 2 * PLUME_STEPS, "K3": PLUME_STEPS}, "plume64")
    check_state(peng.state, PLUME_STEPS, pn, "plume64")
    if not (pmass_end > pmass1 > 0.0 and pcom_end > pcom1):
        fail("plume64: density mass does not grow or the plume does not rise")
    ptwin = Engine(pcfg, device="cuda", kernels=PLAIN_TWINS)
    ptwin.step(3)
    against(pat3, {k: getattr(ptwin.state, k) for k in pat3},
            "plume64 kernel path vs twin path", steps=3)

    # smoke32: window 0 takes the plain path on the card, as the JAX package
    # takes XLA; 10 steps against the same Engine on the CPU.
    kcfg = preset_smoke_box_32()
    keng = Engine(kcfg, device="cuda")
    counters_to_zero()
    keng.step(10)
    torch.cuda.synchronize()
    smoke_launches = counts()
    say(f"# smoke32: 10 steps at {kcfg.current_size}^3 on the card, launches {smoke_launches} "
        "(window 0: the plain path, the JAX package's routing)")
    exactly(smoke_launches, {}, "smoke32")
    check_state(keng.state, 10, kcfg.current_size, "smoke32")
    kcpu = Engine(kcfg, device="cpu")
    kcpu.step(10)
    against({k: getattr(keng.state, k).cpu() for k in ("density", "velocity", "pressure")},
            {k: getattr(kcpu.state, k) for k in ("density", "velocity", "pressure")},
            "smoke32 card vs CPU")

    # The BASELINE 64³ gate (tests/test_oracle3d_parity.py's plume_cfg) on
    # the kernel path, re-synced to the NumPy oracle every step.
    spec = importlib.util.spec_from_file_location("oracle3d", ROOT / "tests" / "oracle3d.py")
    oracle3d = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle3d)
    gcfg = SimConfig(
        size=64, ndim=3, time_step=0.02, diffusion=1e-4, viscosity=1e-4, jacobi_iters=20,
        buoyancy=1.0, ambient_density=0.0, vorticity_confinement=0.0, advect_window=2,
        enable_custom_source=True, source_strength=60.0, source_radius=3.0,
        source_position=(0.5, 0.15, 0.5), obstacle_position=(0.5, 0.5, 0.5),
        enable_obstacle=False, double_project=False).validate()
    gdt, gdiff, gvisc = gcfg.effective_params()
    gn = gcfg.current_size
    grng = np.random.default_rng(SEED)
    gd = np.abs(grng.standard_normal((gn, gn, gn))).astype(np.float32)
    gv = np.stack([oracle3d.set_bnd_3d(b, (0.2 * grng.standard_normal((gn, gn, gn))
                                            ).astype(np.float32), None) for b in (1, 2, 3)])
    gt = np.float32(0.0)
    counters_to_zero()
    gate_worst = 0.0
    for k in range(3):
        gt = gt + np.float32(gdt)
        sd, sv = apply_custom_source(torch.from_numpy(gd).to(dev), torch.from_numpy(gv).to(dev),
                                     gcfg, torch.tensor(gt, device=dev))
        gstate = zeros_state(gcfg, dev).replace(
            density=sd, velocity=sv, time=torch.tensor(gt - np.float32(gdt), device=dev))
        gstate = simulate_step_3d(gstate, gcfg)
        od, ov, op = oracle3d.simulate_step_3d(
            sd.cpu().numpy(), sv.cpu().numpy(), gdt, gdiff, gvisc, gcfg.jacobi_iters,
            buoy=gcfg.buoyancy, ambient=gcfg.ambient_density, advect_window=gcfg.advect_window)
        for name, got, exp in (("density", gstate.density, od), ("velocity", gstate.velocity, ov),
                               ("pressure", gstate.pressure, op)):
            exp_t = torch.from_numpy(exp).to(dev)
            scale = max(1.0, float(np.abs(exp).max()))
            err, ok = worst(got, exp_t, 1e-4, 2e-5 * scale)
            gate_worst = max(gate_worst, err / scale)
            say(f"# 64^3 gate, kernel path, step {k}, {name}: max abs diff {err!r} against the "
                f"oracle (scale {scale!r}; bound rtol 1e-4, atol 2e-5 x scale)")
            if not ok:
                fail(f"the 64^3 gate: {name} diverged from the oracle at step {k}")
        gd, gv = od, ov
    torch.cuda.synchronize()
    gate_launches = counts()
    say(f"# 64^3 gate: 3 re-synced steps, launches {gate_launches}")
    exactly(gate_launches, {"K1": 6, "K3": 3}, "the 64^3 gate")

    # double_project: plume64 (K4) and vortex128 (K4 with the mask), each
    # 10 steps on the kernel path against the twin path, bitwise.
    dp_engines, dp_launches = {}, {}
    for what, dcfg in (("plume64 + double_project", pcfg.replace(double_project=True)),
                       ("vortex128 + double_project", vcfg.replace(double_project=True))):
        deng = Engine(dcfg, device="cuda")
        counters_to_zero()
        deng.step(10)
        torch.cuda.synchronize()
        dp_launches[what] = counts()
        say(f"# {what}: 10 steps at {dcfg.current_size}^3, launches {dp_launches[what]}, "
            f"K4 by route {dict(k4_launches)}")
        exactly(dp_launches[what], {"K1": 20, "K3": 10, "K4": 10}, what)
        if dict(k4_launches) != {"tiled": 10, "sweep": 0}:
            fail(f"{what}: K4 did not solve on the tiles every step: {dict(k4_launches)}")
        check_state(deng.state, 10, dcfg.current_size, what)
        dtwin = Engine(dcfg, device="cuda", kernels=PLAIN_TWINS)
        dtwin.step(10)
        against({k: getattr(deng.state, k) for k in ("density", "velocity", "pressure")},
                {k: getattr(dtwin.state, k) for k in ("density", "velocity", "pressure")},
                f"{what} kernel path vs twin path")
        dp_engines[what] = deng
        del dtwin

    # -- 9c. the 2D reference-parity mode: scene_a and scene_b (K9) ----------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 9c")
    # K9 against its twin on seeded fields: scene_a's airfoil at 192² and
    # scene_b's circle at 128², b = 0, 1, 2 in both modes, 20 and 21 sweeps.
    acfg, bcfg = preset_scene_a(), preset_scene_b()
    an, bn = acfg.current_size, bcfg.current_size
    amask = torch.from_numpy(build_obstacle_mask(acfg)).to(dev)
    bmask = torch.from_numpy(build_obstacle_mask(bcfg)).to(dev)
    say(f"# scene_a mask: {int(amask.sum())} solid cells at {an}^2; scene_b: "
        f"{int(bmask.sum())} at {bn}^2")

    def diffusion_coefficients(scfg):
        sdt, _, svisc = scfg.effective_params()
        m = scfg.current_size
        a = float(np.float32(sdt) * np.float32(svisc) * np.float32(m - 2) * np.float32(m - 2))
        return a, float(np.float32(1.0) + np.float32(6.0) * np.float32(a))

    k9_err = {}
    for what, m, mask, scfg in (("scene_a", an, amask, acfg), ("scene_b", bn, bmask, bcfg)):
        a9, c9 = diffusion_coefficients(scfg)
        k9_err[what] = 0.0
        for b in (0, 1, 2):
            x0 = (torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32)) * 3.0).to(dev)
            x = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32)).to(dev)
            for smoothing in (True, False):
                for it9 in (20, 21):
                    start = x0 if smoothing else x
                    got = lin_solve_2d_resident(b, start, x0, a9, c9, mask, it9, smooth=smoothing)
                    ref = lin_solve_2d_resident_plain(b, start, x0, a9, c9, mask, it9,
                                                      smooth=smoothing)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    k9_err[what] = max(k9_err[what], err)
                    say(f"# K9 b={b} {'smooth' if smoothing else 'fixed-rhs'} {it9} sweeps, "
                        f"{what}'s mask, vs twin at {m}^2: max abs err {err!r} (bitwise "
                        f"{torch.equal(got, ref)}; bound: bitwise)")
                    if not torch.equal(got, ref):
                        fail(f"K9 (b={b}, smooth={smoothing}, {it9} sweeps) disagrees with its "
                             f"twin at {m}^2")

    def mass_2d(st):
        return float(st.density.double().sum())

    def check_2d(st, steps, m, what):
        if int(st.step) != steps or tuple(st.velocity.shape) != (2, m, m) \
                or tuple(st.density.shape) != (m, m):
            fail(f"{what}: unexpected state shape or step count")
        for name in ("density", "velocity", "pressure"):
            if not bool(torch.isfinite(getattr(st, name)).all()):
                fail(f"{what}: non-finite {name}")

    # scene_a through Engine: eight K9 launches a step and nothing else.
    aeng = Engine(acfg, device="cuda")
    counters_to_zero()
    aeng.step(1)
    amass = [mass_2d(aeng.state)]
    aeng.step(9)
    aat10 = {k: getattr(aeng.state, k).clone() for k in ("density", "velocity", "pressure")}
    aeng.step(30)
    amass.append(mass_2d(aeng.state))
    aeng.step(STEPS - 40)
    torch.cuda.synchronize()
    scene_a_launches = counts()
    scene_a_smooth = lin_solve_2d_resident.smooth_launches
    amass.append(mass_2d(aeng.state))
    say(f"# scene_a: {STEPS} steps at {an}^2, launches {scene_a_launches}, of them "
        f"{scene_a_smooth} K9 smoothing solves")
    say(f"# scene_a density mass: step 1 {amass[0]!r}, step 40 {amass[1]!r}, step {STEPS} "
        f"{amass[2]!r}")
    exactly(scene_a_launches, {"K9": 8 * STEPS}, "scene_a")
    # Three smoothing solves a step (vx, vy, density); the other five are
    # fixed-rhs (double_diffuse's three and the two pressure solves).
    if scene_a_smooth != 3 * STEPS:
        fail(f"scene_a launched {scene_a_smooth} K9 smoothing solves, not {3 * STEPS}")
    check_2d(aeng.state, STEPS, an, "scene_a")
    # The mass builds up over the first 40 steps, then levels off: the
    # reference's diffusion (c = 1 + 6a on a 2D grid) loses mass each sweep.
    if not (amass[1] > amass[0] > 0.0 and amass[2] > amass[0]):
        fail("scene_a: the emitted density mass does not build up")
    asolid = amask & interior_mask(amask.shape, dev)
    if bool((aeng.state.velocity[:, asolid] != 0).any()):
        fail("scene_a: an interior obstacle cell holds a nonzero velocity")
    atwin = Engine(acfg, device="cuda", kernels=PLAIN_TWINS)
    atwin.step(10)
    against(aat10, {k: getattr(atwin.state, k) for k in aat10},
            "scene_a kernel path vs twin path")
    # The card against the CPU port after 3 steps, in the re-synced step's
    # class of tests/test_parity_step.py (rtol 1e-5, atol 2e-6·scale).
    acard, acpu = Engine(acfg, device="cuda"), Engine(acfg, device="cpu")
    acard.step(3)
    acpu.step(3)
    for name in ("density", "velocity", "pressure"):
        got, ref = getattr(acard.state, name).cpu(), getattr(acpu.state, name)
        scale = max(1.0, float(ref.abs().max()))
        err, ok = worst(got, ref, 1e-5, 2e-6 * scale)
        say(f"# scene_a card vs CPU, 3 steps, {name}: max abs diff {err!r} (scale {scale!r}; "
            f"bound rtol 1e-5, atol 2e-6 x scale; bitwise {torch.equal(got, ref)})")
        if not ok:
            fail(f"scene_a on the card drifts from the CPU port in {name}")
    del acard, acpu

    # scene_b (the stock defaults) from a seeded velocity and density: its
    # stock config has no emitter, so from zeros it stays zero.
    beng = Engine(bcfg, device="cuda")
    beng.state = beng.state.replace(
        velocity=torch.stack([smooth(bn, rng, dev)[0] for _ in range(2)]) * 0.5,
        density=density_field(bn, rng, dev)[0])
    bmass0 = mass_2d(beng.state)
    counters_to_zero()
    beng.step(VORTEX_STEPS)
    torch.cuda.synchronize()
    scene_b_launches = counts()
    scene_b_smooth = lin_solve_2d_resident.smooth_launches
    say(f"# scene_b: {VORTEX_STEPS} steps at {bn}^2 from a seeded state, launches "
        f"{scene_b_launches}, of them {scene_b_smooth} K9 smoothing solves; density mass "
        f"{bmass0!r} -> {mass_2d(beng.state)!r}")
    exactly(scene_b_launches, {"K9": 8 * VORTEX_STEPS}, "scene_b")
    if scene_b_smooth != 3 * VORTEX_STEPS:
        fail(f"scene_b launched {scene_b_smooth} K9 smoothing solves, not {3 * VORTEX_STEPS}")
    check_2d(beng.state, VORTEX_STEPS, bn, "scene_b")

    # The oracle gate (tests/test_parity_step.py::test_step_parity_resync_64's
    # config) on the kernel path, re-synced to tests/oracle2d.py for 4 steps.
    spec = importlib.util.spec_from_file_location("oracle2d", ROOT / "tests" / "oracle2d.py")
    oracle2d = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle2d)
    ocfg = SimConfig(
        size=64, resolution_multiplier=1.0, time_step=0.05, diffusion=1e-4, viscosity=1e-4,
        enable_custom_source=True, source_strength=80.0, source_emits_velocity=True,
        source_direction=0.0, source_velocity=12.0, source_radius=2.5,
        source_position=(0.2, 0.5), enable_obstacle=True, obstacle_shape=ObstacleShape.CIRCLE,
        obstacle_position=(0.6, 0.5), obstacle_radius=0.12).validate()
    on = ocfg.current_size
    oobst = build_obstacle_mask(ocfg)
    od, ovx, ovy = (np.zeros((on, on), np.float32) for _ in range(3))
    ot, oframe = np.float32(0.0), np.float32(ocfg.effective_params()[0])
    counters_to_zero()
    for k in range(4):
        ot = ot + oframe
        oracle2d.custom_source(od, ovx, ovy, ocfg, ot)
        ostate = zeros_state(ocfg, dev, obstacles=oobst).replace(
            density=torch.from_numpy(od).to(dev),
            velocity=torch.from_numpy(np.stack([ovx, ovy])).to(dev))
        od, ovx, ovy, op = oracle2d.simulate_step(od, ovx, ovy, oobst, ocfg)
        ostate = simulate_step_2d(ostate, ocfg)
        for name, got, exp in (("density", ostate.density, od), ("vel_x", ostate.velocity[0], ovx),
                               ("vel_y", ostate.velocity[1], ovy),
                               ("pressure", ostate.pressure, op)):
            scale = max(1.0, float(np.abs(exp).max()))
            err, ok = worst(got, torch.from_numpy(exp).to(dev), 1e-5, 2e-6 * scale)
            say(f"# 2D oracle gate, kernel path, step {k}, {name}: max abs diff {err!r} "
                f"(scale {scale!r}; bound rtol 1e-5, atol 2e-6 x scale)")
            if not ok:
                fail(f"the 2D oracle gate: {name} diverged from the oracle at step {k}")
    torch.cuda.synchronize()
    gate2d_launches = counts()
    exactly(gate2d_launches, {"K9": 32}, "the 2D oracle gate")

    # -- 9d. bfloat16 fields and the windowed fused kernels ----------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 9d")
    # Each bf16 kernel against its twin at 128³ on bench128's and vortex128's
    # seeded fields rounded to bfloat16, bitwise.
    bf = torch.bfloat16
    bvel, bdens = vel.to(bf), dens.to(bf)
    bvvel, bvdens = vvel.to(bf), vdens.to(bf)
    bf16_fns = {
        "K1 bf16": (lambda: advect_multi_3d_kernel((1, 2, 3), bvel, bvel, dt),
                    lambda: advect_multi_3d_plain((1, 2, 3), bvel, bvel, dt)),
        "K1 bf16 density": (
            lambda: advect_multi_3d_kernel((0,), bdens[None], bvel, dt),
            lambda: advect_multi_3d_plain((0,), bdens[None], bvel, dt)),
        "K1v bf16": (
            lambda: advect_multi_3d_kernel((1, 2, 3), bvvel, bvvel, vdt, obst=obst, n_sub=n_sub),
            lambda: advect_multi_3d_plain((1, 2, 3), bvvel, bvvel, vdt, obst=obst, n_sub=n_sub)),
        "K1v bf16 density": (
            lambda: advect_multi_3d_kernel((0,), bvdens[None], bvvel, vdt, obst=obst,
                                           n_sub=n_sub),
            lambda: advect_multi_3d_plain((0,), bvdens[None], bvvel, vdt, obst=obst,
                                          n_sub=n_sub)),
        "K3 bf16": (lambda: project_3d_resident(bvvel, vcfg.jacobi_iters, obst=obst,
                                                solve_dtype=vcfg.solve_dtype),
                    lambda: project_3d_resident_plain(bvvel, vcfg.jacobi_iters, obst=obst,
                                                      solve_dtype=vcfg.solve_dtype)),
        "K3 bf16 no mask": (
            lambda: project_3d_resident(bvel, cfg.jacobi_iters, solve_dtype=solve),
            lambda: project_3d_resident_plain(bvel, cfg.jacobi_iters, solve_dtype=solve)),
        "K2 bf16": (lambda: project_advect_density_3d(
            bvel, bdens, cfg.jacobi_iters, dt, solve_dtype=solve, damp=damp,
            dens_damp=ddamp),
                    lambda: project_advect_density_3d_plain(
            bvel, bdens, cfg.jacobi_iters, dt, solve_dtype=solve, damp=damp,
            dens_damp=ddamp)),
        "K2o bf16": (lambda: project_advect_density_3d(
            bvvel, bvdens, vcfg.jacobi_iters, vdt, obst=obst, n_sub=n_sub,
            solve_dtype=vcfg.solve_dtype, damp=vdamp, dens_damp=vddamp),
                     lambda: project_advect_density_3d_plain(
            bvvel, bvdens, vcfg.jacobi_iters, vdt, obst=obst, n_sub=n_sub,
            solve_dtype=vcfg.solve_dtype, damp=vdamp, dens_damp=vddamp)),
        "K8 bf16": (lambda: full_step_3d(bvel, bdens, cfg.jacobi_iters, dt, solve_dtype=solve,
                                         damp=damp, dens_damp=ddamp),
                    lambda: full_step_3d_plain(bvel, bdens, cfg.jacobi_iters, dt,
                                               solve_dtype=solve, damp=damp,
                                               dens_damp=ddamp)),
    }
    # The float32 kernel each extends, on the same values widened.
    wvel_, wdens_ = bvel.float(), bdens.float()
    wvvel_, wvdens_ = bvvel.float(), bvdens.float()
    f32_of = {
        "K1 bf16": lambda: advect_multi_3d_kernel((1, 2, 3), wvel_, wvel_, dt),
        "K1 bf16 density": lambda: advect_multi_3d_kernel((0,), wdens_[None], wvel_, dt),
        "K1v bf16": lambda: advect_multi_3d_kernel((1, 2, 3), wvvel_, wvvel_, vdt, obst=obst,
                                                   n_sub=n_sub),
        "K1v bf16 density": lambda: advect_multi_3d_kernel(
            (0,), wvdens_[None], wvvel_, vdt, obst=obst, n_sub=n_sub),
        "K3 bf16": lambda: project_3d_resident(wvvel_, vcfg.jacobi_iters, obst=obst,
                                               solve_dtype=vcfg.solve_dtype),
        "K3 bf16 no mask": lambda: project_3d_resident(wvel_, cfg.jacobi_iters,
                                                       solve_dtype=solve),
        "K2 bf16": lambda: project_advect_density_3d(
            wvel_, wdens_, cfg.jacobi_iters, dt, solve_dtype=solve, damp=damp,
            dens_damp=ddamp),
        "K2o bf16": lambda: project_advect_density_3d(
            wvvel_, wvdens_, vcfg.jacobi_iters, vdt, obst=obst, n_sub=n_sub,
            solve_dtype=vcfg.solve_dtype, damp=vdamp, dens_damp=vddamp),
        "K8 bf16": lambda: full_step_3d(wvel_, wdens_, cfg.jacobi_iters, dt,
                                        solve_dtype=solve, damp=damp, dens_damp=ddamp),
    }
    new_err = {}

    def twin_check(key, fn, plain, where):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        if torch.is_tensor(got):
            got, ref = (got,), (ref,)
        err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        new_err[key] = max(new_err.get(key, 0.0), err)
        same = all(g.dtype == r.dtype and torch.equal(g, r) for g, r in zip(got, ref))
        say(f"# {key} vs twin {where}: max abs err {err!r} (bitwise {same}; bound: bitwise; "
            f"dtypes {[str(g.dtype) for g in got]})")
        if not same:
            fail(f"{key} disagrees with its twin {where}")

    for key, (fn, plain) in bf16_fns.items():
        twin_check(key, fn, plain, f"at {n}^3")

    # The fused kernels with a K = 2, 3 density phase (K8: both phases) and
    # K1 with the folded emitter at K = 2, 3, against their twins at 64³ and
    # 128³ on seeded fields (a backtrace of up to about 3 cells at plume64's
    # dt), float32 and (K2, K2o, K8) bfloat16; K8 against the launched
    # K1 -> K2 too.
    for wn in (64, 128):
        wvel = velocity_field(wn, rng, dev, 30.0 / (wn - 2))
        wdens = density_field(wn, rng, dev)
        wmask = torch.from_numpy(build_obstacle_mask(vcfg.replace(size=wn))).to(dev)
        wsrc = emitter_fold_operand(cfg.replace(size=wn), torch.full((), pdt, device=dev))
        wbuoy = (wdens, cfg.buoyancy, cfg.ambient_density, cfg.gravity)
        for k in (2, 3):
            kw = dict(window=k, damp=damp, dens_damp=ddamp)
            cases = {
                f"K2w{k}": (lambda kw=kw, v=wvel, d=wdens: project_advect_density_3d(
                    v, d, 20, pdt, **kw), lambda kw=kw, v=wvel, d=wdens:
                    project_advect_density_3d_plain(v, d, 20, pdt, **kw)),
                f"K2w{k} bf16": (lambda kw=kw, v=wvel, d=wdens: project_advect_density_3d(
                    v.to(bf), d.to(bf), 20, pdt, solve_dtype="bfloat16", **kw),
                    lambda kw=kw, v=wvel, d=wdens: project_advect_density_3d_plain(
                    v.to(bf), d.to(bf), 20, pdt, solve_dtype="bfloat16", **kw)),
                f"K2sw{k}": (lambda kw=kw, v=wvel, d=wdens, s=wsrc: project_advect_density_3d(
                    v, d, 20, pdt, src=s, **kw), lambda kw=kw, v=wvel, d=wdens, s=wsrc:
                    project_advect_density_3d_plain(v, d, 20, pdt, src=s, **kw)),
                f"K2ow{k}": (lambda kw=kw, v=wvel, d=wdens, m=wmask:
                             project_advect_density_3d(v, d, 20, pdt, obst=m, n_sub=2, **kw),
                             lambda kw=kw, v=wvel, d=wdens, m=wmask:
                             project_advect_density_3d_plain(v, d, 20, pdt, obst=m, n_sub=2,
                                                             **kw)),
                f"K8w{k}": (lambda kw=kw, v=wvel, d=wdens: full_step_3d(v, d, 20, pdt, **kw),
                            lambda kw=kw, v=wvel, d=wdens: full_step_3d_plain(v, d, 20, pdt,
                                                                              **kw)),
                f"K8w{k} bf16": (lambda kw=kw, v=wvel, d=wdens: full_step_3d(
                    v.to(bf), d.to(bf), 20, pdt, n_sub=2, **kw),
                    lambda kw=kw, v=wvel, d=wdens: full_step_3d_plain(
                    v.to(bf), d.to(bf), 20, pdt, n_sub=2, **kw)),
                f"K1 srcw{k}": (lambda k=k, v=wvel, b=wbuoy, s=wsrc: advect_multi_3d_kernel(
                    (1, 2, 3), v, v, pdt, buoy=b, src=s, window=k),
                    lambda k=k, v=wvel, b=wbuoy, s=wsrc: advect_multi_3d_plain(
                    (1, 2, 3), v, v, pdt, buoy=b, src=s, window=k)),
            }
            for key, (fn, plain) in cases.items():
                twin_check(key, fn, plain, f"at {wn}^3")
            got = full_step_3d(wvel, wdens, 20, pdt, **kw)
            adv = advect_multi_3d_kernel((1, 2, 3), wvel, wvel, pdt, window=k)
            ref = project_advect_density_3d(adv, wdens, 20, pdt, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                fail(f"K8 window={k} differs from the launched K1 -> K2 at {wn}^3")
    del wvel, wdens, wmask, got, ref, adv

    # The paths through Engine, each with the counters at zero just before.
    engine_module.apply_custom_source = counted_source

    def run_path(pcfg_, steps, what, expected, at=10):
        """``steps`` steps of ``pcfg_`` (the counters at zero before): checks
        the launches, finite fields and a growing mass; returns the engine
        and its fields after ``at`` steps."""
        peng_ = Engine(pcfg_, device="cuda")
        counters_to_zero()
        emitter_passes[0] = 0
        peng_.step(1)
        m1, c1 = mass_and_com_y(peng_.state)
        peng_.step(at - 1)
        snap = {k: getattr(peng_.state, k).clone() for k in ("density", "velocity", "pressure")}
        peng_.step(steps - at)
        torch.cuda.synchronize()
        launches = counts()
        m_end, c_end = mass_and_com_y(peng_.state)
        say(f"# {what}: {steps} steps at {pcfg_.current_size}^3, launches {launches}, "
            f"full-grid emitter passes {emitter_passes[0]}")
        say(f"# {what} density mass: step 1 {m1!r}, step {steps} {m_end!r}; y centre of "
            f"mass {c1!r} -> {c_end!r}")
        exactly(launches, {k: v * steps for k, v in expected.items()}, what)
        check_state(peng_.state, steps, pcfg_.current_size, what)
        if not m_end > m1 > 0.0:
            fail(f"{what}: density mass does not grow")
        return peng_, snap, launches, (c1, c_end)

    def twin_path(pcfg_, steps=10):
        t = Engine(pcfg_, device="cuda", kernels=PLAIN_TWINS)
        t.step(steps)
        return {k: getattr(t.state, k) for k in ("density", "velocity", "pressure")}

    def tracks(b16, f32, what):
        """tests/test_bf16.py's audit of a bf16 run against its f32 run."""
        d16, d32 = b16["density"].double(), f32["density"].double()
        m16, m32 = float(d16.sum()), float(d32.sum())
        ys = torch.arange(d32.shape[1], dtype=torch.float64, device=dev)[None, :, None]
        c16, c32 = float((d16 * ys).sum() / m16), float((d32 * ys).sum() / m32)
        dscale = max(1.0, float(d32.abs().max()))
        ddiff = float((d16 - d32).abs().mean())
        v16, v32 = b16["velocity"].double(), f32["velocity"].double()
        vscale = max(1e-3, float(v32.abs().max()))
        vdiff = float((v16 - v32).abs().mean())
        say(f"# {what} bf16 vs f32 after 10 steps: mass {m16!r} / {m32!r}, y centre "
            f"{c16!r} / {c32!r}, mean |d| diff {ddiff!r} (bound 2e-2 x {dscale!r}), mean |v| "
            f"diff {vdiff!r} (bound 2e-2 x {vscale!r})")
        if not (abs(m16 - m32) < 3e-2 * abs(m32) and abs(c16 - c32) < 0.5
                and ddiff < 2e-2 * dscale and vdiff < 2e-2 * vscale):
            fail(f"{what}: the bf16 run leaves its f32 run's bound")

    b16cfg = cfg.replace(dtype="bfloat16")
    p1, p1at10, p1_launches, (p1c1, p1c_end) = run_path(
        b16cfg, BF16_STEPS, "bench128 bf16", {"K1": 1, "K2": 1})
    if not p1c_end > p1c1:
        fail("bench128 bf16: the plume does not rise")
    if emitter_passes[0] != BF16_STEPS:
        fail("bench128 bf16 did not run its emitter once a step")
    against(p1at10, twin_path(b16cfg), "bench128 bf16 kernel path vs twin path")
    tracks(p1at10, at10, "bench128")
    p1u, p1uat10, p1u_launches, _ = run_path(
        b16cfg.replace(fuse_project_advect=False), 10, "bench128 bf16 unfused",
        {"K1": 2, "K3": 1})
    against(p1uat10, p1at10, "bench128 bf16 unfused vs fused")
    p1k8, p1k8at10, p1k8_launches, _ = run_path(
        b16cfg.replace(fuse_self_advect=True), BF16_STEPS, "bench128 bf16 + fuse_self_advect",
        {"K8": 1})
    # bf16 fields never fold the buoyancy, so K8 is the fused bf16 step.
    against(p1k8at10, p1at10, "bench128 bf16 + fuse_self_advect vs K1 -> K2")

    v16cfg = vcfg.replace(dtype="bfloat16")
    p2, p2at10, p2_launches, _ = run_path(v16cfg, BF16_VORTEX_STEPS, "vortex128 bf16",
                                          {"K1": 2, "K3": 1})
    if not bool((p2.state.velocity[:, solid] == 0).all()):
        fail("vortex128 bf16: an interior obstacle cell holds a nonzero velocity")
    against(p2at10, twin_path(v16cfg), "vortex128 bf16 kernel path vs twin path")
    tracks(p2at10, vat10, "vortex128")
    p2f, p2fat10, p2f_launches, _ = run_path(
        v16cfg.replace(fuse_project_advect=True), BF16_VORTEX_STEPS,
        "vortex128 bf16 + fuse_project_advect", {"K1": 1, "K2": 1})
    against(p2fat10, p2at10, "vortex128 bf16 + fuse_project_advect vs unfused")

    m16cfg = mcfg.replace(dtype="bfloat16")
    p3, p3at10, p3_launches, _ = run_path(
        m16cfg, 10, "multi256 bf16", {"K1": 2, "K6": 1, "K7 div": 1, "K7 grad": 1})
    against(p3at10, twin_path(m16cfg), "multi256 bf16 kernel path vs twin path")
    tracks(p3at10, mat10, "multi256")
    del p3

    fused_sub = dict(advection_scheme="substep", advect_substeps=1, fuse_project_advect=True)
    plain10 = Engine(pcfg, device="cuda")
    plain10.step(10)
    plain10 = {k: getattr(plain10.state, k) for k in ("density", "velocity", "pressure")}
    p4, p4at10, p4_launches, (p4c1, p4c_end) = run_path(
        pcfg.replace(**fused_sub), PLUME_STEPS, "plume64 fused (K2, K = 3)",
        {"K1": 1, "K2": 1})
    if not p4c_end > p4c1:
        fail("plume64 fused: the plume does not rise")
    against(p4at10, plain10, "plume64 fused vs the preset")
    p4k8, p4k8at10, p4k8_launches, _ = run_path(
        pcfg.replace(fuse_self_advect=True, **fused_sub), PLUME_STEPS,
        "plume64 + fuse_self_advect (K8, K = 3)", {"K8": 1})
    against(p4k8at10, plain10, "plume64 + fuse_self_advect vs the preset")
    gfcfg = gcfg.replace(**fused_sub)
    p4g, p4gat10, p4g_launches, _ = run_path(gfcfg, 10, "the 64^3 gate fused (K2, K = 2)",
                                             {"K1": 1, "K2": 1})
    gplain = Engine(gcfg, device="cuda")
    gplain.step(10)
    against(p4gat10, {k: getattr(gplain.state, k) for k in p4gat10},
            "the 64^3 gate fused vs unfused")
    del gplain

    w2cfg = cfg.replace(advect_window=2)
    p5, p5at10, p5_launches, _ = run_path(
        w2cfg.replace(fuse_emitter=True), BF16_STEPS, "bench128 window 2 + fuse_emitter",
        {"K1": 1, "K2": 1})
    if emitter_passes[0] != 0:
        fail("bench128 window 2 + fuse_emitter ran a full-grid emitter pass")
    composed = Engine(w2cfg, device="cuda")
    composed.step(10)
    against(p5at10, {k: getattr(composed.state, k) for k in p5at10},
            "bench128 window 2 + fuse_emitter vs composed", 1e-5, 1e-6)
    del composed
    engine_module.apply_custom_source = apply_custom_source

    # Turbulent noise and the FFT projection on the card against the CPU
    # port, 3 steps (rtol 1e-5, atol 1e-5·scale: float32 ulps of the card's
    # transcendentals and FFT reduction order).
    option_engines = {}
    for what, ocfg in (("plume64 + noise", pcfg.replace(apply_turbulent_noise=True)),
                       ("plume64 + fft", pcfg.replace(pressure_solver="fft")),
                       ("smoke32 + fft", kcfg.replace(pressure_solver="fft"))):
        oeng = Engine(ocfg, device="cuda")
        counters_to_zero()
        oeng.step(3)
        torch.cuda.synchronize()
        olaunch = counts()
        expected = {} if ocfg.advect_window == 0 else {"K1": 6}
        if ocfg.pressure_solver != "fft":
            expected["K3"] = 3
        exactly(olaunch, expected, what)
        ocpu = Engine(ocfg, device="cpu")
        ocpu.step(3)
        for name in ("density", "velocity", "pressure"):
            ref = getattr(ocpu.state, name)
            err, ok = worst(getattr(oeng.state, name).cpu(), ref, 1e-5,
                            1e-5 * max(1.0, float(ref.abs().max())))
            say(f"# {what}, 3 steps, card vs CPU, {name}: max abs diff {err!r} (bound rtol "
                f"1e-5, atol 1e-5 x scale)")
            if not ok:
                fail(f"{what}: the card leaves the CPU port's class in {name}")
        check_state(oeng.state, 3, ocfg.current_size, what)
        option_engines[what] = oeng
    bf16_paths = (("bench128 bf16", p1, 200), ("bench128 bf16 unfused", p1u, 50),
                  ("bench128 bf16 + fuse_self_advect", p1k8, 200),
                  ("vortex128 bf16", p2, 100), ("vortex128 bf16 + fuse_project_advect", p2f, 100),
                  ("plume64 fused (K2, K = 3)", p4, 100),
                  ("plume64 + fuse_self_advect (K8, K = 3)", p4k8, 100),
                  ("bench128 window 2 + fuse_emitter", p5, 100),
                  *((what, e, 20) for what, e in option_engines.items()))

    # -- 10. timing ------------------------------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 10")
    say(f"# timing on {card}")
    step_ms = cuda_ms(lambda: eng.step(1), reps=200, warmup=20)
    twin_ms = cuda_ms(lambda: twin.step(1), reps=10, warmup=2)
    say(f"steps/s kernel path: {1e3 / step_ms!r} ({step_ms!r} ms/step) [{card}]")
    say(f"steps/s twin path: {1e3 / twin_ms!r} ({twin_ms!r} ms/step) [{card}]")

    def frame():
        eng.step(1)
        return render_frame_3d(eng.state, cfg).mean()

    chunks = []
    for _ in range(7):
        chunks.append(cuda_ms(frame, reps=50, warmup=0 if chunks else 5))
    p50 = float(np.percentile(chunks, 50))
    say(f"p50 step+raymarch frame: {p50!r} ms (chunks {chunks}) [{card}]")

    t = eng.state.time + dt
    emitter_ms = cuda_ms(lambda: apply_custom_source(
        eng.state.density, eng.state.velocity, cfg, t), reps=50)
    say(f"emitter (plain torch) at {n}^3: {emitter_ms!r} ms [{card}]")

    vstep_ms = cuda_ms(lambda: veng.step(1), reps=100, warmup=10)
    vtwin_ms = cuda_ms(lambda: vtwin.step(1), reps=5, warmup=1)
    say(f"vortex128 steps/s kernel path: {1e3 / vstep_ms!r} ({vstep_ms!r} ms/step) [{card}]")
    say(f"vortex128 steps/s twin path: {1e3 / vtwin_ms!r} ({vtwin_ms!r} ms/step) [{card}]")
    vs = veng.state
    plain_passes = {
        "buoyancy_force": lambda: buoyancy_force(vs.velocity, vs.density, vdt,
                                                 vcfg.buoyancy, vcfg.ambient_density,
                                                 vcfg.gravity),
        "vorticity_confinement_3d": lambda: vorticity_confinement_3d(
            vs.velocity, vdt, vcfg.vorticity_confinement),
        "enforce_obstacle_boundaries_3d": lambda: enforce_obstacle_boundaries_3d(
            vs.velocity, vs.obstacles, vcfg.cell_size, vcfg.viscosity),
    }
    for name, fn in plain_passes.items():
        say(f"vortex128 {name} (plain torch) at {n}^3: {cuda_ms(fn, reps=20)!r} ms "
            f"[{card}]")

    mstep_ms = cuda_ms(lambda: meng.step(1), reps=30, warmup=5)
    mtwin_ms = cuda_ms(lambda: mtwin.step(1), reps=3, warmup=1)
    say(f"multi256 steps/s kernel path: {1e3 / mstep_ms!r} ({mstep_ms!r} ms/step) [{card}]")
    say(f"multi256 steps/s twin path: {1e3 / mtwin_ms!r} ({mtwin_ms!r} ms/step) [{card}]")

    def mframe():
        meng.step(1)
        return render_frame_3d(meng.state, mcfg).mean()

    chunks = [cuda_ms(mframe, reps=20, warmup=0 if i else 3) for i in range(7)]
    say(f"multi256 p50 step+raymarch frame: {float(np.percentile(chunks, 50))!r} ms "
        f"(7 chunks of 20 frames: {chunks}) [{card}]")
    mt = meng.state.time + mdt
    memit_ms = cuda_ms(lambda: apply_custom_source(meng.state.density, meng.state.velocity,
                                                   mcfg, mt), reps=20)
    say(f"multi256 emitters (plain torch) at {mn}^3: {memit_ms!r} ms [{card}]")
    sstep_ms = cuda_ms(lambda: seng.step(1), reps=10, warmup=2)
    say(f"sharded512 steps/s kernel path: {1e3 / sstep_ms!r} ({sstep_ms!r} ms/step) [{card}]")
    new_paths = (("plume64", peng, 100), ("smoke32", keng, 100),
                 *((what, engine, 20) for what, engine in dp_engines.items()))
    for what, engine, reps in new_paths:
        ms = cuda_ms(lambda: engine.step(1), reps=reps, warmup=reps // 10)
        say(f"{what} steps/s kernel path: {1e3 / ms!r} ({ms!r} ms/step) [{card}]")
    ptwin_ms = cuda_ms(lambda: ptwin.step(1), reps=5, warmup=1)
    say(f"plume64 steps/s twin path: {1e3 / ptwin_ms!r} ({ptwin_ms!r} ms/step) [{card}]")
    fused_paths = (("bench128 + fuse_emitter", feng_emit, 200),
                   ("bench128 + fuse_self_advect", feng_k8, 200),
                   ("vortex128 + fuse_project_advect", feng_v, 100))
    for what, engine, reps in fused_paths:
        ms = cuda_ms(lambda: engine.step(1), reps=reps, warmup=reps // 10)
        say(f"{what} steps/s kernel path: {1e3 / ms!r} ({ms!r} ms/step) [{card}]")
    # The persistent K8 beside the launches it replaces, and K2o beside K3 +
    # K1 on the density, on the same inputs.
    k8_ms, k1k2_ms = cuda_ms(k8, reps=50), cuda_ms(k1_then_k2, reps=50)
    say(f"K8 at {n}^3: {k8_ms!r} ms; K1 + K2 on the same input {k1k2_ms!r} ms [{card}]")
    # What a sweep costs inside K8 (a grid-stride pass and a grid barrier)
    # and in K2 (a launch): each at 1 and at 61 sweeps on the same input.
    for what, fn in (("K8", full_step_3d), ("K2", project_advect_density_3d)):
        one = cuda_ms(lambda: fn(vel, dens, 1, dt, solve_dtype=solve, damp=damp,
                                 dens_damp=ddamp), reps=50)
        many = cuda_ms(lambda: fn(vel, dens, 61, dt, solve_dtype=solve, damp=damp,
                                  dens_damp=ddamp), reps=20)
        say(f"{what} per sweep at {n}^3 (bf16 solve): {(many - one) / 60 * 1e3!r} us "
            f"(1 sweep {one!r} ms, 61 sweeps {many!r} ms) [{card}]")
    k2o_ms, k3k1_ms = cuda_ms(k2o, reps=50), cuda_ms(k3_then_k1, reps=50)
    say(f"K2o at {n}^3: {k2o_ms!r} ms; K3 + K1 density on the same input {k3k1_ms!r} ms "
        f"[{card}]")

    k3_256 = cuda_ms(lambda: project_3d_resident(mvel, iters), reps=10)
    slab_256 = cuda_ms(lambda: project_3d_slab_kernel(mvel, iters), reps=10)
    say(f"projection at {mn}^3 (float32, no mask, {iters} sweeps): K3 {k3_256!r} ms, "
        f"slab route K7 -> K6 -> K7 {slab_256!r} ms [{card}]")
    # Where the slab route overtakes K3: both at each size on one seeded
    # velocity, K3 with a float32 and a bfloat16 solve, the slab route in
    # float32, multi256's sweeps.
    for cn in CROSSOVER_SIZES:
        cvel = velocity_field(cn, rng, dev, 0.5)
        k3_f32 = cuda_ms(lambda: project_3d_resident(cvel, iters), reps=20)
        k3_bf16 = cuda_ms(lambda: project_3d_resident(cvel, iters, solve_dtype="bfloat16"),
                          reps=20)
        slab = cuda_ms(lambda: project_3d_slab_kernel(cvel, iters), reps=20)
        say(f"crossover at {cn}^3 ({iters} sweeps, no mask): K3 float32 {k3_f32!r} ms, "
            f"K3 bfloat16 {k3_bf16!r} ms, slab route {slab!r} ms [{card}]")
    del cvel
    # bench128's fused K2 beside what the slab route would put in its place.
    k2_alt = cuda_ms(lambda: advect_multi_3d_kernel(
        (0,), dens[None], project_3d_slab_kernel(vel, cfg.jacobi_iters)[0] * damp, dt),
        reps=20)
    say(f"bench128 at {n}^3: K2 {cuda_ms(k2, reps=20)!r} ms; slab route ({cfg.jacobi_iters} "
        f"float32 sweeps) + damping + K1 density {k2_alt!r} ms [{card}]")
    # The divergence is one float32 convolution of the three components.

    def div_weights(size):
        w = torch.zeros((1, 3, 3, 3, 3), dtype=torch.float32, device=dev)
        for c, (kz, ky, kx) in enumerate(((1, 1, 2), (1, 2, 1), (2, 1, 1))):
            w[0, c, kz, ky, kx] = -0.5 / size
            w[0, c, 2 - kz, 2 - ky, 2 - kx] = 0.5 / size
        return w

    div_w, sdiv_w = div_weights(mn), div_weights(sn)
    conv = F.conv3d(mvel[None], div_w)[0, 0]
    say(f"# K7 div vs its library yardstick (conv3d) at {mn}^3: max abs diff "
        f"{float((conv - divergence_3d_kernel(mvel)[1:-1, 1:-1, 1:-1]).abs().max())!r}")
    del conv
    library = {"K7 div": cuda_ms(lambda: F.conv3d(mvel[None], div_w), reps=20),
               "K7s div": cuda_ms(lambda: F.conv3d(svel[None], sdiv_w), reps=5)}

    # K1 with K = 3 (plume64) and K = 2 (the 64³ gate) and K4 (plume64's
    # pre-projection; vortex128's with the mask) on the paths' shapes.
    pvol, pint = pn ** 3, (pn - 2) ** 3
    tvel = velocity_field(pn, rng, dev, 30.0 / (pn - 2))
    tdens = density_field(pn, rng, dev)
    tdiv, vdiv = divergence_3d_plain(tvel), divergence_3d_plain(vvel)
    new_fns = {
        "K1w3": (lambda: advect_multi_3d_kernel((1, 2, 3), tvel, tvel, pdt, window=3),
                 lambda: advect_multi_3d_plain((1, 2, 3), tvel, tvel, pdt, window=3)),
        "K1w3 density": (
            lambda: advect_multi_3d_kernel((0,), tdens[None], tvel, pdt, window=3),
            lambda: advect_multi_3d_plain((0,), tdens[None], tvel, pdt, window=3)),
        "K1w2": (lambda: advect_multi_3d_kernel((1, 2, 3), tvel, tvel, gdt, window=2),
                 lambda: advect_multi_3d_plain((1, 2, 3), tvel, tvel, gdt, window=2)),
        "K1w2 density": (
            lambda: advect_multi_3d_kernel((0,), tdens[None], tvel, gdt, window=2),
            lambda: advect_multi_3d_plain((0,), tdens[None], tvel, gdt, window=2)),
        "K4": (lambda: jacobi_3d_resident(0, torch.zeros_like(tdiv), tdiv, 1.0, 6.0,
                                          pcfg.jacobi_iters),
               lambda: jacobi_3d_resident_plain(0, torch.zeros_like(tdiv), tdiv, 1.0, 6.0,
                                                pcfg.jacobi_iters)),
        "K4 mask": (lambda: jacobi_3d_resident(0, torch.zeros_like(vdiv), vdiv, 1.0, 6.0,
                                               vcfg.jacobi_iters, obst=obst),
                    lambda: jacobi_3d_resident_plain(0, torch.zeros_like(vdiv), vdiv, 1.0,
                                                     6.0, vcfg.jacobi_iters, obst=obst)),
    }
    for key, (fn, plain) in new_fns.items():
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"{key} disagrees with its twin on the timing inputs")
    del got, ref
    # What a sweep of K4 costs: 1 and 61 sweeps on plume64's input.
    k4_one = cuda_ms(lambda: jacobi_3d_resident(0, torch.zeros_like(tdiv), tdiv, 1.0, 6.0, 1),
                     reps=50)
    k4_many = cuda_ms(lambda: jacobi_3d_resident(0, torch.zeros_like(tdiv), tdiv, 1.0, 6.0,
                                                 61), reps=20)
    say(f"K4 per sweep at {pn}^3: {(k4_many - k4_one) / 60 * 1e3!r} us (1 sweep {k4_one!r} "
        f"ms, 61 sweeps {k4_many!r} ms) [{card}]")
    # K4 on the tiles beside the per-sweep route it replaced, in turns; that
    # route held bitwise against the twin once, by its counter.
    k4_turns = {}
    for key, sweeps in (("K4", pcfg.jacobi_iters), ("K4 mask", vcfg.jacobi_iters)):
        before = dict(k4_launches)
        swept, ref = untiled(new_fns[key][0]), new_fns[key][1]()
        torch.cuda.synchronize()
        moved = {k: k4_launches[k] - before[k] for k in k4_launches}
        if moved != {"tiled": 0, "sweep": sweeps}:
            fail(f"{key} did not take the per-sweep route with no tiling: {moved}")
        if not torch.equal(swept, ref):
            fail(f"{key} on its per-sweep route disagrees with its twin")
        del swept, ref
        k4_turns[key] = in_turns(new_fns[key][0], new_fns[key][0], reps=50)
        say(f"{key}: tiled {k4_turns[key][0]!r} ms, per-sweep route {k4_turns[key][1]!r} ms, "
            f"in turns [{card}]")

    # The 2D mode: steps/s of both scenes and of scene_a's twin path, device
    # time a step by kernel and the host's share, and K9 a solve and a sweep
    # beside its twin on each scene's mask with its diffusion coefficients.
    for what, engine, reps in (("scene_a", aeng, 200), ("scene_b", beng, 100)):
        ms = cuda_ms(lambda: engine.step(1), reps=reps, warmup=reps // 10)
        launched = {}
        by_kernel = profile_ms(lambda: engine.step(1), reps=20, launches=launched)
        device = sum(by_kernel.values())
        k9_dev = sum(v for k, v in by_kernel.items() if "solve2d" in k)
        n_launched = sum(launched.values())
        say(f"{what} steps/s kernel path: {1e3 / ms!r} ({ms!r} ms/step) [{card}]")
        say(f"# profile {what}: device time {device!r} ms/step in {n_launched!r} device "
            f"launches ({len(by_kernel)} names, the 8 of K9 included), K9 {k9_dev!r} ms/step, "
            f"host-idle share {1.0 - device / ms!r}, step time per device launch "
            f"{ms / n_launched * 1e3!r} us [{card}]")
        for name, kms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:14]:
            say(f"#   {kms!r} ms/step  {name}")
    atwin_ms = cuda_ms(lambda: atwin.step(1), reps=5, warmup=1)
    say(f"scene_a steps/s twin path: {1e3 / atwin_ms!r} ({atwin_ms!r} ms/step) [{card}]")
    k9_fns, k9_sweep = {}, {}
    for what, m, mask, scfg in (("scene_a", an, amask, acfg), ("scene_b", bn, bmask, bcfg)):
        a9, c9 = diffusion_coefficients(scfg)
        x9 = (torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32)) * 3.0).to(dev)
        div9 = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32) * 1e-3).to(dev)
        p9 = torch.zeros_like(div9)
        # A viscous diffusion solve of vx (b = 1, smoothing) and a pressure
        # solve (b = 0, fixed rhs, a = 1, c = 6), as the step launches them.
        it9 = scfg.jacobi_iters
        k9_fns[what + " smoothing"] = (
            lambda x9=x9, mask=mask, a9=a9, c9=c9, it9=it9: lin_solve_2d_resident(
                1, x9, x9, a9, c9, mask, it9, smooth=True),
            lambda x9=x9, mask=mask, a9=a9, c9=c9, it9=it9: lin_solve_2d_resident_plain(
                1, x9, x9, a9, c9, mask, it9, smooth=True))
        k9_fns[what + " fixed-rhs"] = (
            lambda p9=p9, div9=div9, mask=mask, it9=it9: lin_solve_2d_resident(
                0, p9, div9, 1.0, 6.0, mask, it9),
            lambda p9=p9, div9=div9, mask=mask, it9=it9: lin_solve_2d_resident_plain(
                0, p9, div9, 1.0, 6.0, mask, it9))
        one = cuda_ms(lambda: lin_solve_2d_resident(1, x9, x9, a9, c9, mask, 1, smooth=True),
                      reps=100)
        many = cuda_ms(lambda: lin_solve_2d_resident(1, x9, x9, a9, c9, mask, 61, smooth=True),
                       reps=50)
        k9_sweep[what] = (many - one) / 60 * 1e3
        say(f"K9 per sweep at {m}^2 ({what}'s mask): {k9_sweep[what]!r} us (1 sweep {one!r} "
            f"ms, 61 sweeps {many!r} ms) [{card}]")
        # The one-block form (the simplest barrier) beside the step's cluster.
        one1 = cuda_ms(lambda: lin_solve_2d_resident(1, x9, x9, a9, c9, mask, 1, smooth=True,
                                                     blocks=1), reps=100)
        many1 = cuda_ms(lambda: lin_solve_2d_resident(1, x9, x9, a9, c9, mask, 61, smooth=True,
                                                      blocks=1), reps=20)
        solve1 = cuda_ms(lambda: lin_solve_2d_resident(1, x9, x9, a9, c9, mask, it9, smooth=True,
                                                       blocks=1), reps=50)
        got1 = lin_solve_2d_resident(1, x9, x9, a9, c9, mask, it9, smooth=True, blocks=1)
        if not torch.equal(got1, k9_fns[what + " smoothing"][1]()):
            fail(f"K9 on one block disagrees with its twin at {m}^2")
        say(f"K9 on one block of 1024 threads at {m}^2: {(many1 - one1) / 60 * 1e3!r} "
            f"us a sweep (1 sweep {one1!r} ms, 61 sweeps {many1!r} ms), {solve1!r} ms a "
            f"{it9}-sweep smoothing solve [{card}]")
    for key, (fn, plain) in k9_fns.items():
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"K9 ({key}) disagrees with its twin on the timing inputs")

    times = {
        **{key: (cuda_ms(fn, reps=50), cuda_ms(plain, reps=3, warmup=1))
           for key, (fn, plain) in new_fns.items()},
        **{"K9 " + key: (cuda_ms(fn, reps=100), cuda_ms(plain, reps=3, warmup=1))
           for key, (fn, plain) in k9_fns.items()},
        "K6": (cuda_ms(slab_fns["K6"][0], reps=20), cuda_ms(slab_fns["K6"][1], reps=3)),
        "K7 div": (cuda_ms(slab_fns["K7 div"][0], reps=50),
                   cuda_ms(slab_fns["K7 div"][1], reps=5)),
        "K7 grad": (cuda_ms(slab_fns["K7 grad"][0], reps=50),
                    cuda_ms(slab_fns["K7 grad"][1], reps=5)),
        "K1m": (cuda_ms(slab_fns["K1m"][0], reps=20), cuda_ms(slab_fns["K1m"][1], reps=3)),
        "K1m density": (cuda_ms(slab_fns["K1m density"][0], reps=20),
                        cuda_ms(slab_fns["K1m density"][1], reps=3)),
        **{key: (cuda_ms(fn, reps=10), cuda_ms(plain, reps=2, warmup=1))
           for key, (fn, plain) in sharded_fns.items()},
        "K1": (cuda_ms(k1, reps=100), cuda_ms(k1_plain, reps=10)),
        "K2": (cuda_ms(k2, reps=50), cuda_ms(k2_plain, reps=3)),
        "K1v": (cuda_ms(k1v, reps=50), cuda_ms(k1v_plain, reps=3)),
        "K1v density": (cuda_ms(k1v_dens, reps=50), cuda_ms(k1v_dens_plain, reps=3)),
        "K3": (cuda_ms(k3, reps=50), cuda_ms(k3_plain, reps=3)),
        "K3 no mask": (cuda_ms(lambda: k3(None), reps=50),
                       cuda_ms(lambda: k3_plain(None), reps=3)),
        "K1 src": (cuda_ms(fused_fns["K1 src"][0], reps=100),
                   cuda_ms(fused_fns["K1 src"][1], reps=10)),
        "K2s": (cuda_ms(fused_fns["K2s"][0], reps=50), cuda_ms(fused_fns["K2s"][1], reps=3)),
        "K2o": (k2o_ms, cuda_ms(k2o_plain, reps=3)),
        "K8": (k8_ms, cuda_ms(k8_plain, reps=3)),
    }
    # The new kernels at their paths' shapes, each beside its twin, and
    # beside the kernel it extends: the float32 kernel on the same values
    # widened, or the same call at K = 1.
    win_fns = {
        "K2w3": (lambda w=3: project_advect_density_3d(tvel, tdens, pcfg.jacobi_iters, pdt,
                                                       window=w),
                 lambda: project_advect_density_3d_plain(tvel, tdens, pcfg.jacobi_iters, pdt,
                                                         window=3)),
        "K8w3": (lambda w=3: full_step_3d(tvel, tdens, pcfg.jacobi_iters, pdt, window=w),
                 lambda: full_step_3d_plain(tvel, tdens, pcfg.jacobi_iters, pdt, window=3)),
        "K2w2": (lambda w=2: project_advect_density_3d(tvel, tdens, gcfg.jacobi_iters, gdt,
                                                       window=w),
                 lambda: project_advect_density_3d_plain(tvel, tdens, gcfg.jacobi_iters, gdt,
                                                         window=2)),
        "K1 srcw2": (lambda w=2: advect_multi_3d_kernel((1, 2, 3), vel, vel, dt, buoy=buoy,
                                                        src=src, window=w),
                     lambda: advect_multi_3d_plain((1, 2, 3), vel, vel, dt, buoy=buoy, src=src,
                                                   window=2)),
        "K2sw2": (lambda w=2: k2(src=src, window=w), lambda: k2_plain(src=src, window=2)),
    }
    for key, (fn, plain) in win_fns.items():
        twin_check(key, fn, plain, "on the timing inputs")
    for key, (fn, plain) in {**bf16_fns, **win_fns}.items():
        times[key] = (cuda_ms(fn, reps=20), cuda_ms(plain, reps=2, warmup=1))
        base = f32_of[key] if key in f32_of else (lambda fn=fn: fn(w=1))
        say(f"{key}: kernel {times[key][0]!r} ms beside the kernel it extends "
            f"({'float32 on the same values' if key in f32_of else 'K = 1'}) "
            f"{cuda_ms(base, reps=20)!r} ms [{card}]")
    for what, engine, reps in bf16_paths:
        ms = cuda_ms(lambda: engine.step(1), reps=reps, warmup=reps // 10)
        say(f"{what} steps/s kernel path: {1e3 / ms!r} ({ms!r} ms/step) [{card}]")
    for name, (ms, plain_ms) in times.items():
        say(f"{name}: kernel {ms!r} ms, twin {plain_ms!r} ms [{card}]")

    # Where a step's device time goes, by kernel.
    for what, engine, reps in (("bench128", eng, 20), ("vortex128", veng, 20),
                               ("multi256", meng, 5), ("sharded512", seng, 2),
                               *((what, engine, 20) for what, engine, _ in fused_paths),
                               *((what, engine, 20) for what, engine, _ in new_paths),
                               *((what, engine, 10) for what, engine, _ in bf16_paths)):
        by_kernel = profile_ms(lambda: engine.step(1), reps=reps)
        total = sum(by_kernel.values())
        say(f"# profile {what}: device time {total!r} ms/step [{card}]")
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:14]:
            say(f"#   {ms!r} ms/step  {name}")
    for name, fn in plain_passes.items():
        by_kernel = profile_ms(fn, reps=10)
        say(f"# profile vortex128 {name}: device time {sum(by_kernel.values())!r} "
            f"ms/call in {len(by_kernel)} kernel names [{card}]")

    # -- the kernels line ---------------------------------------------------
    f32 = 4
    fluid = interior - n_solid
    svol, sinterior = sn ** 3, (sn - 2) ** 3
    # The cells the emitter's ball covers (falloff above zero) in this run.
    ball = int((src_field_add(torch.zeros_like(dens), src) > 0).sum())
    k1_ops = FRAC_OPS + RELU_OPS + 3 * COMB_OPS
    k2_ops = (DIV_OPS + cfg.jacobi_iters * SWEEP_OPS + GRAD_OPS + FRAC_OPS + RELU_OPS
              + COMB_OPS + 1)
    entries = [
        ("K1", "K1 advect_multi_3d_kernel (n_sub=1, buoyancy folded; bench128 self-advection)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         bench_launches["K1"], k1_err,
         bound(7 * vol * f32,
               interior * (FRAC_OPS + RELU_OPS + 3 * COMB_OPS + 2 * BUOY_OPS))),
        # vortex128 launches K1 twice a step, once for each of these two.
        ("K1v", f"K1 advect_multi_3d_kernel (n_sub={n_sub}, obstacle mask; vortex128 "
                "self-advection, F=3)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         vortex_launches["K1"], k1v_err,
         bound(6 * vol * f32 + vol,
               n_sub * (fluid * (FRAC_OPS + RELU_OPS + 3 * COMB_OPS)
                        + n_solid * 3 * MIRROR_OPS))),
        ("K1v density", f"K1 advect_multi_3d_kernel (n_sub={n_sub}, obstacle mask; "
                        "vortex128 density, F=1)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         vortex_launches["K1"], k1v_err,
         bound(5 * vol * f32 + vol, n_sub * fluid * (FRAC_OPS + RELU_OPS + COMB_OPS))),
        ("K2", "K2 project_advect_density_3d (projection + density advection; bench128)",
         "fluidsim_tpu_torch/csrc/project_advect.cu",
         "fluidsim_tpu/pallas/resident.py:1155", bench_launches["K2"], k2_err,
         bound(9 * vol * f32,
               interior * (DIV_OPS + cfg.jacobi_iters * SWEEP_OPS + GRAD_OPS
                           + FRAC_OPS + RELU_OPS + COMB_OPS + 1))),
        ("K3", "K3 project_3d_resident (obstacle mask; vortex128 projection)",
         "fluidsim_tpu_torch/csrc/project.cu", "fluidsim_tpu/pallas/resident.py:907",
         vortex_launches["K3"], k3_err["mask"],
         bound(7 * vol * f32 + vol,
               interior * (DIV_OPS + vcfg.jacobi_iters * SWEEP_OPS + GRAD_OPS)
               + n_solid * 3 * MIRROR_OPS)),
        ("K3 no mask", "K3 project_3d_resident (no mask; bench128 with the projection "
                       "unfused)",
         "fluidsim_tpu_torch/csrc/project.cu", "fluidsim_tpu/pallas/resident.py:894",
         unfused_launches["K3"], k3_err["no mask"],
         bound(7 * vol * f32,
               interior * (DIV_OPS + vcfg.jacobi_iters * SWEEP_OPS + GRAD_OPS))),
        # multi256 launches K1 twice a step, once for each of these two.
        ("K1m", f"K1 advect_multi_3d_kernel (n_sub={m_sub}, no mask; multi256 "
                "self-advection, F=3, 256^3)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         multi_launches["K1"], slab_err["K1m"],
         bound(6 * mvol * f32, m_sub * minterior * (FRAC_OPS + RELU_OPS + 3 * COMB_OPS))),
        ("K1m density", f"K1 advect_multi_3d_kernel (n_sub={m_sub}, no mask; multi256 "
                        "density, F=1, 256^3)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         multi_launches["K1"], slab_err["K1m density"],
         bound(5 * mvol * f32, m_sub * minterior * (FRAC_OPS + RELU_OPS + COMB_OPS))),
        # sharded512 launches K1 twice a step, once for each of these two.
        ("K1s", f"K1 advect_multi_3d_kernel (n_sub={s_sub}, buoyancy folded; sharded512 "
                "self-advection, F=3, 512^3)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         sharded_launches["K1"], slab_err["K1s"],
         bound(7 * svol * f32, sinterior * (s_sub * (FRAC_OPS + RELU_OPS + 3 * COMB_OPS)
                                            + 3 * BUOY_OPS))),
        ("K1s density", f"K1 advect_multi_3d_kernel (n_sub={s_sub}, no mask; sharded512 "
                        "density, F=1, 512^3)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         sharded_launches["K1"], slab_err["K1s density"],
         bound(5 * svol * f32, s_sub * sinterior * (FRAC_OPS + RELU_OPS + COMB_OPS))),
        ("K6", f"K6 jacobi_3d_kernel ({iters} sweeps, b=0, a=1, c=6; multi256 "
               "projection solve, 256^3)",
         "fluidsim_tpu_torch/csrc/jacobi.cu", "fluidsim_tpu/pallas/jacobi.py:127",
         multi_launches["K6"], slab_err["K6"],
         bound(3 * mvol * f32, iters * minterior * JACOBI_OPS)),
        ("K7 div", "K7 divergence_3d_kernel (multi256 projection, 256^3)",
         "fluidsim_tpu_torch/csrc/project_slab.cu", "fluidsim_tpu/pallas/project.py:43",
         multi_launches["K7 div"], slab_err["K7 div"],
         bound(4 * mvol * f32, minterior * DIV_OPS)),
        ("K7 grad", "K7 gradient_3d_kernel (multi256 projection, 256^3)",
         "fluidsim_tpu_torch/csrc/project_slab.cu", "fluidsim_tpu/pallas/project.py:85",
         multi_launches["K7 grad"], slab_err["K7 grad"],
         bound(7 * mvol * f32, minterior * GRAD_OPS)),
        ("K6s", f"K6 jacobi_3d_kernel ({s_iters} sweeps, b=0, a=1, c=6; sharded512 "
                "projection solve, 512^3)",
         "fluidsim_tpu_torch/csrc/jacobi.cu", "fluidsim_tpu/pallas/jacobi.py:127",
         sharded_launches["K6"], slab_err["K6s"],
         bound(3 * svol * f32, s_iters * sinterior * JACOBI_OPS)),
        ("K7s div", "K7 divergence_3d_kernel (sharded512 projection, 512^3)",
         "fluidsim_tpu_torch/csrc/project_slab.cu", "fluidsim_tpu/pallas/project.py:43",
         sharded_launches["K7 div"], slab_err["K7s div"],
         bound(4 * svol * f32, sinterior * DIV_OPS)),
        ("K7s grad", "K7 gradient_3d_kernel (sharded512 projection, 512^3)",
         "fluidsim_tpu_torch/csrc/project_slab.cu", "fluidsim_tpu/pallas/project.py:85",
         sharded_launches["K7 grad"], slab_err["K7s grad"],
         bound(7 * svol * f32, sinterior * GRAD_OPS)),
        ("K1 src", "K1 advect_multi_3d_kernel (n_sub=1, buoyancy and emitter folded; "
                   "bench128 + fuse_emitter self-advection)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         emit_launches["K1"], fused_err["K1 src"],
         bound(7 * vol * f32 + 5 * f32, interior * (k1_ops + 2 * BUOY_OPS) + ball * EMIT_OPS)),
        ("K2s", "K2s project_advect_density_3d (projection + density advection with the "
                "emitter folded; bench128 + fuse_emitter)",
         "fluidsim_tpu_torch/csrc/project_advect.cu", "fluidsim_tpu/pallas/resident.py:1219",
         emit_launches["K2"], fused_err["K2s"],
         bound(9 * vol * f32 + 5 * f32, interior * k2_ops + ball * EMIT_OPS)),
        ("K2o", f"K2o project_advect_density_3d (obstacle mask, n_sub={n_sub}, bf16 solve; "
                "vortex128 + fuse_project_advect)",
         "fluidsim_tpu_torch/csrc/project_advect.cu", "fluidsim_tpu/pallas/resident.py:1226",
         vfused_launches["K2"], fused_err["K2o"],
         bound(9 * vol * f32 + vol,
               interior * (DIV_OPS + vcfg.jacobi_iters * SWEEP_OPS + GRAD_OPS)
               + n_solid * 3 * MIRROR_OPS
               + n_sub * fluid * (FRAC_OPS + RELU_OPS + COMB_OPS) + interior)),
        ("K8", "K8 full_step_3d (self-advection + projection + density advection in one "
               "cooperative launch on the tiled solve's tiles; bench128 + fuse_self_advect)",
         "fluidsim_tpu_torch/csrc/full_step.cu", "fluidsim_tpu/pallas/resident.py:1531",
         k8_launches["K8"], fused_err["K8"],
         bound(9 * vol * f32, interior * (k1_ops + k2_ops))),
    ]
    def win_ops(n_fields):
        """The float32 operations a cell that K1's function needs for a
        window of K > 1 cells, whatever K: after the clamp only two hats per
        axis are non-zero, so the backtrace, those six hats, the 4 + 8
        products of the 8 taps' weights, and a multiply and an add a tap and
        field."""
        return FRAC_OPS + 3 * 2 * HAT_OPS + 4 + 8 + n_fields * 8 * 2

    gate_k1 = gate_launches["K1"]
    dp_plume = dp_launches["plume64 + double_project"]["K4"]
    dp_vortex = dp_launches["vortex128 + double_project"]["K4"]
    entries += [
        # plume64 launches K1 twice a step, once for each of these two.
        ("K1w3", "K1 advect_multi_3d_kernel (window K=3, n_sub=1; plume64 self-advection, "
                 "F=3, 64^3)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         plume_launches["K1"], win_err[(3, "F=3")],
         bound(6 * pvol * f32, pint * win_ops(3))),
        ("K1w3 density", "K1 advect_multi_3d_kernel (window K=3, n_sub=1; plume64 density, "
                         "F=1, 64^3)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         plume_launches["K1"], win_err[(3, "F=1")],
         bound(5 * pvol * f32, pint * win_ops(1))),
        # The 64³ gate launches K1 twice a step, once for each of these two.
        ("K1w2", "K1 advect_multi_3d_kernel (window K=2, n_sub=1; the 64^3 gate's "
                 "self-advection, F=3)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         gate_k1, win_err[(2, "F=3")], bound(6 * pvol * f32, pint * win_ops(3))),
        ("K1w2 density", "K1 advect_multi_3d_kernel (window K=2, n_sub=1; the 64^3 gate's "
                         "density, F=1)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         gate_k1, win_err[(2, "F=1")], bound(5 * pvol * f32, pint * win_ops(1))),
        ("K4", f"K4 jacobi_3d_resident ({pcfg.jacobi_iters} sweeps, b=0, a=1, c=6; plume64 + "
               "double_project pre-projection, 64^3)",
         "fluidsim_tpu_torch/csrc/jacobi_resident.cu", "fluidsim_tpu/pallas/resident.py:618",
         dp_plume, win_err[("K4", "no mask")],
         bound(3 * pvol * f32, pcfg.jacobi_iters * pint * SWEEP_OPS)),
        ("K4 mask", f"K4 jacobi_3d_resident (obstacle mask, {vcfg.jacobi_iters} sweeps; "
                    "vortex128 + double_project pre-projection, 128^3)",
         "fluidsim_tpu_torch/csrc/jacobi_resident.cu", "fluidsim_tpu/pallas/resident.py:638",
         dp_vortex, win_err[("K4", "mask")],
         bound(3 * vol * f32 + vol, vcfg.jacobi_iters * interior * K4_MASK_OPS)),
    ]
    # K9's function a sweep, by cell: 6 operations an interior fluid cell
    # (3 neighbour adds, a*nbr, the rhs add, the division), MIRROR_OPS an
    # interior solid cell of a velocity component, 2 a corner.  Bytes: a
    # smoothing solve starts from its rhs (x is x0 on the path), so it reads
    # x0 and the mask and writes the result (9·n²); a fixed-rhs solve reads
    # x as well (13·n²).
    def k9_bound(m, mask, b, iters, smoothing):
        n_solid2d = int((mask & interior_mask(mask.shape, dev)).sum())
        ops = (m - 2) ** 2 - n_solid2d
        ops = 6 * ops + (MIRROR_OPS * n_solid2d if b else 0) + 4 * 2
        return bound((9 if smoothing else 13) * m * m, iters * ops)

    for what, m, mask, launches, smooth_launches in (
            ("scene_a", an, amask, scene_a_launches["K9"], scene_a_smooth),
            ("scene_b", bn, bmask, scene_b_launches["K9"], scene_b_smooth)):
        entries += [
            ("K9 " + what + " smoothing",
             f"K9 lin_solve_2d_resident (strips route, smoothing, 20 sweeps, timed on "
             f"{what}'s viscous diffusion b=1; launches: the path's smoothing solves, {m}^2)",
             "fluidsim_tpu_torch/csrc/resident2d.cu", "fluidsim_tpu/pallas/resident2d.py:77",
             smooth_launches, k9_err[what], k9_bound(m, mask, 1, 20, True)),
            ("K9 " + what + " fixed-rhs",
             f"K9 lin_solve_2d_resident (strips route, fixed rhs, 20 sweeps, timed on {what}'s "
             f"pressure b=0, "
             f"a=1, c=6; launches: the path's fixed-rhs solves, diffusion's and pressure's, "
             f"{m}^2)", "fluidsim_tpu_torch/csrc/resident2d.cu",
             "fluidsim_tpu/pallas/resident2d.py:77", launches - smooth_launches, k9_err[what],
             k9_bound(m, mask, 0, 20, False)),
        ]
    # PR 8's rows: bfloat16 storage halves the field bytes (2 a value; the
    # operations are the float32 kernels'), and the fused kernels at K = 2, 3
    # count the windowed backtrace as K1's rows do (win_ops).
    bf2 = 2
    gint = pint
    k2_core = DIV_OPS + cfg.jacobi_iters * SWEEP_OPS + GRAD_OPS
    entries += [
        ("K1 bf16", "K1 advect_multi_3d_kernel (bf16 fields, n_sub=1; bench128 bf16 "
                    "self-advection, F=3)",
         "fluidsim_tpu_torch/csrc/advect_bf16.cu", "fluidsim_tpu/pallas/advect.py:256",
         p1_launches["K1"], new_err["K1 bf16"],
         bound(6 * vol * bf2, interior * (FRAC_OPS + RELU_OPS + 3 * COMB_OPS))),
        ("K1 bf16 density", "K1 advect_multi_3d_kernel (bf16 fields, n_sub=1; bench128 bf16 "
                            "unfused density, F=1)",
         "fluidsim_tpu_torch/csrc/advect_bf16.cu", "fluidsim_tpu/pallas/advect.py:256",
         p1u_launches["K1"], new_err["K1 bf16 density"],
         bound(5 * vol * bf2, interior * (FRAC_OPS + RELU_OPS + COMB_OPS))),
        ("K1v bf16", f"K1 advect_multi_3d_kernel (bf16 fields, n_sub={n_sub}, obstacle mask; "
                     "vortex128 bf16 self-advection, F=3)",
         "fluidsim_tpu_torch/csrc/advect_bf16.cu", "fluidsim_tpu/pallas/advect.py:256",
         p2_launches["K1"], new_err["K1v bf16"],
         bound(6 * vol * bf2 + vol,
               n_sub * (fluid * (FRAC_OPS + RELU_OPS + 3 * COMB_OPS)
                        + n_solid * 3 * MIRROR_OPS))),
        ("K1v bf16 density", f"K1 advect_multi_3d_kernel (bf16 fields, n_sub={n_sub}, "
                             "obstacle mask; vortex128 bf16 density, F=1)",
         "fluidsim_tpu_torch/csrc/advect_bf16.cu", "fluidsim_tpu/pallas/advect.py:256",
         p2_launches["K1"], new_err["K1v bf16 density"],
         bound(5 * vol * bf2 + vol, n_sub * fluid * (FRAC_OPS + RELU_OPS + COMB_OPS))),
        ("K2 bf16", "K2 project_advect_density_3d (bf16 fields, bf16 solve; bench128 bf16)",
         "fluidsim_tpu_torch/csrc/project_advect.cu", "fluidsim_tpu/pallas/resident.py:1155",
         p1_launches["K2"], new_err["K2 bf16"],
         bound(9 * vol * bf2, interior * (k2_core + FRAC_OPS + RELU_OPS + COMB_OPS + 1))),
        ("K3 bf16", "K3 project_3d_resident (bf16 fields, obstacle mask; vortex128 bf16)",
         "fluidsim_tpu_torch/csrc/project.cu", "fluidsim_tpu/pallas/resident.py:907",
         p2_launches["K3"], new_err["K3 bf16"],
         bound(7 * vol * bf2 + vol,
               interior * (DIV_OPS + vcfg.jacobi_iters * SWEEP_OPS + GRAD_OPS)
               + n_solid * 3 * MIRROR_OPS)),
        ("K3 bf16 no mask", "K3 project_3d_resident (bf16 fields, no mask; bench128 bf16 "
                            "unfused)",
         "fluidsim_tpu_torch/csrc/project.cu", "fluidsim_tpu/pallas/resident.py:894",
         p1u_launches["K3"], new_err["K3 bf16 no mask"],
         bound(7 * vol * bf2, interior * k2_core)),
        ("K2o bf16", f"K2o project_advect_density_3d (bf16 fields, obstacle mask, n_sub={n_sub}; "
                     "vortex128 bf16 + fuse_project_advect)",
         "fluidsim_tpu_torch/csrc/project_advect.cu", "fluidsim_tpu/pallas/resident.py:1226",
         p2f_launches["K2"], new_err["K2o bf16"],
         bound(9 * vol * bf2 + vol,
               interior * (DIV_OPS + vcfg.jacobi_iters * SWEEP_OPS + GRAD_OPS)
               + n_solid * 3 * MIRROR_OPS
               + n_sub * fluid * (FRAC_OPS + RELU_OPS + COMB_OPS) + interior)),
        ("K8 bf16", "K8 full_step_3d (bf16 fields; bench128 bf16 + fuse_self_advect)",
         "fluidsim_tpu_torch/csrc/full_step_bf16.cu", "fluidsim_tpu/pallas/resident.py:1531",
         p1k8_launches["K8"], new_err["K8 bf16"],
         bound(9 * vol * bf2, interior * (k1_ops + k2_ops))),
        ("K2w3", f"K2 project_advect_density_3d (K=3 density phase, {pcfg.jacobi_iters} float32 "
                 "sweeps; plume64 fused, 64^3)",
         "fluidsim_tpu_torch/csrc/project_advect.cu", "fluidsim_tpu/pallas/resident.py:1155",
         p4_launches["K2"], max(new_err["K2w3"], new_err["K2w3 bf16"]),
         bound(9 * pvol * f32, pint * (DIV_OPS + pcfg.jacobi_iters * SWEEP_OPS + GRAD_OPS
                                       + win_ops(1) + 1))),
        ("K8w3", "K8 full_step_3d (K=3 in both advections; plume64 + fuse_self_advect, 64^3)",
         "fluidsim_tpu_torch/csrc/full_step.cu", "fluidsim_tpu/pallas/resident.py:1531",
         p4k8_launches["K8"], max(new_err["K8w3"], new_err["K8w3 bf16"]),
         bound(9 * pvol * f32, pint * (win_ops(3) + DIV_OPS + pcfg.jacobi_iters * SWEEP_OPS
                                       + GRAD_OPS + win_ops(1) + 1))),
        ("K2w2", f"K2 project_advect_density_3d (K=2 density phase, {gcfg.jacobi_iters} float32 "
                 "sweeps; the 64^3 gate fused)",
         "fluidsim_tpu_torch/csrc/project_advect.cu", "fluidsim_tpu/pallas/resident.py:1155",
         p4g_launches["K2"], max(new_err["K2w2"], new_err["K2w2 bf16"]),
         bound(9 * pvol * f32, gint * (DIV_OPS + gcfg.jacobi_iters * SWEEP_OPS + GRAD_OPS
                                       + win_ops(1) + 1))),
        ("K1 srcw2", "K1 advect_multi_3d_kernel (K=2, buoyancy and emitter folded; bench128 "
                     "window 2 + fuse_emitter self-advection)",
         "fluidsim_tpu_torch/csrc/advect.cu", "fluidsim_tpu/pallas/advect.py:256",
         p5_launches["K1"], new_err["K1 srcw2"],
         bound(7 * vol * f32 + 5 * f32, interior * (win_ops(3) + 9 * BUOY_OPS)
               + ball * EMIT_OPS)),
        ("K2sw2", "K2s project_advect_density_3d (K=2 density phase with the emitter folded; "
                  "bench128 window 2 + fuse_emitter)",
         "fluidsim_tpu_torch/csrc/project_advect.cu", "fluidsim_tpu/pallas/resident.py:1219",
         p5_launches["K2"], new_err["K2sw2"],
         bound(9 * vol * f32 + 5 * f32, interior * (k2_core + win_ops(1) + 1)
               + ball * EMIT_OPS)),
    ]
    # -- 11. K5 (the sweep-blocked solve) in K2, K3, K4 and K8, and K14 ---------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 11")
    say("# phase 11: K5 (jacobi_sweep_block) in K2, K3, K4 and K8, and K14")
    counters["K14"] = advect_project_3d_resident
    k5_err = {}
    iters = cfg.jacobi_iters
    sdt_bytes = 2 if cfg.solve_dtype == "bfloat16" else 4
    vsdt_bytes = 2 if vcfg.solve_dtype == "bfloat16" else 4
    wvel = velocity_field(n, rng, dev, 4.0)
    wdens = density_field(n, rng, dev)
    wvvel = velocity_field(n, rng, dev, 12.0)
    wdiv = divergence_3d_plain(wvel)
    wzero = torch.zeros_like(wdiv)
    # key: (kernel at block T, its twin at T, T, sweeps, solve bytes, mask).
    k5_cases = {
        f"K5 K3 T{t}": (lambda t: project_3d_resident(wvel, iters, solve_dtype=cfg.solve_dtype,
                                                      damp=damp, sweep_block=t),
                        lambda t: project_3d_resident_plain(
                            wvel, iters, solve_dtype=cfg.solve_dtype, damp=damp,
                            sweep_block=t), t, iters, sdt_bytes, False)
        for t in (2, 4)}
    k5_cases.update({
        f"K5 K3o T{t}": (lambda t: project_3d_resident(wvvel, vcfg.jacobi_iters, obst=obst,
                                                       solve_dtype=vcfg.solve_dtype,
                                                       sweep_block=t),
                         lambda t: project_3d_resident_plain(
                             wvvel, vcfg.jacobi_iters, obst=obst,
                             solve_dtype=vcfg.solve_dtype, sweep_block=t),
                         t, vcfg.jacobi_iters, vsdt_bytes, True)
        for t in (2, 4)})
    k5_cases.update({
        f"K5 K2 T{t}": (lambda t: project_advect_density_3d(
                            wvel, wdens, iters, dt, solve_dtype=cfg.solve_dtype, damp=damp,
                            dens_damp=ddamp, sweep_block=t),
                        lambda t: project_advect_density_3d_plain(
                            wvel, wdens, iters, dt, solve_dtype=cfg.solve_dtype, damp=damp,
                            dens_damp=ddamp, sweep_block=t), t, iters, sdt_bytes, False)
        for t in (2, 4)})
    k5_cases["K5 K8 T4"] = (
        lambda t: full_step_3d(wvel, wdens, iters, dt, solve_dtype=cfg.solve_dtype, damp=damp,
                               dens_damp=ddamp, sweep_block=t),
        lambda t: full_step_3d_plain(wvel, wdens, iters, dt, solve_dtype=cfg.solve_dtype,
                                     damp=damp, dens_damp=ddamp, sweep_block=t),
        4, iters, sdt_bytes, False)
    k5_cases["K5 K4 T4"] = (
        lambda t: jacobi_3d_resident(0, wzero, wdiv, 1.0, 6.0, iters, sweep_block=t),
        lambda t: jacobi_3d_resident_plain(0, wzero, wdiv, 1.0, 6.0, iters, sweep_block=t),
        4, iters, 4, False)

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    # Each case's route counter and its count for one call on the tiles
    # (K5's tile program, csrc/solve_tiled.cuh: block_tile).
    from fluidsim_tpu_torch.kernels.resident import full_step_launches

    def k5_counter(key):
        if " K8 " in key:
            return full_step_launches, {"tiled": 1, "grid": 0}
        if " K4 " in key:
            return k4_launches, {"tiled": 1, "sweep": 0}
        return solve_launches, {"tiled": 1, "sweep": 0}

    for key, (fn, plain, t, sweeps, _, _) in k5_cases.items():
        if composite_block(n, sweeps, t) != t:
            fail(f"{key}: the gate refuses T={t} at {n}^3 and {sweeps} sweeps")
        counter, once = k5_counter(key)
        before = dict(counter)
        got = as_tuple(fn(t))
        torch.cuda.synchronize()
        moved = {k: counter[k] - before[k] for k in counter}
        say(f"# {key}: route by counter {moved}")
        if moved != once:
            fail(f"{key} did not take the tiled route: {moved}")
        ref, seq = as_tuple(plain(t)), as_tuple(fn(1))
        torch.cuda.synchronize()
        k5_err[key] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        say(f"# {key} vs its twin at {n}^3: max abs diff {k5_err[key]!r}")
        if not same:
            fail(f"{key} disagrees with its twin")
        if all(torch.equal(g, r) for g, r in zip(got, seq)):
            fail(f"{key} equals the sequential solve bitwise: the composite did not run")
        # The per-stage route the tile program replaced (no tiling found):
        # its counter, and its result bitwise the twin's.
        before = dict(counter)
        staged = as_tuple(untiled(lambda: fn(t)))
        torch.cuda.synchronize()
        moved = {k: counter[k] - before[k] for k in counter}
        per_stage = ({"tiled": 0, "grid": 1} if " K8 " in key
                     else {"tiled": 0, "sweep": sweeps % t})
        say(f"# {key} on the per-stage route: by counter {moved}")
        if moved != per_stage:
            fail(f"{key} did not take the per-stage route with no tiling: {moved}")
        if not all(torch.equal(g, r) for g, r in zip(staged, ref)):
            fail(f"{key} on its per-stage route disagrees with its twin")
        del got, ref, seq, staged
    k14_got = advect_project_3d_resident(wvel, iters, dt)
    k14_twin = advect_project_3d_resident_plain(wvel, iters, dt)
    k14_comp = project_3d_resident(advect_multi_3d_kernel((1, 2, 3), wvel, wvel, dt), iters)
    torch.cuda.synchronize()
    k5_err["K14"] = max(float((g - r).abs().max()) for g, r in zip(k14_got, k14_twin))
    say(f"# K14 vs its twin at {n}^3: max abs diff {k5_err['K14']!r}")
    if not all(torch.equal(g, r) for g, r in zip(k14_got, k14_twin)):
        fail("K14 disagrees with its twin")
    if not all(torch.equal(g, r) for g, r in zip(k14_got, k14_comp)):
        fail("K14 disagrees with the launched K1 -> K3")
    del k14_got, k14_twin, k14_comp

    # Through Engine: each path runs exactly its kernels, equals its twin path
    # bitwise after 10 steps, and one step from a seeded state stays within
    # the bf16-solve class (3e-2 x max, the JAX package's bound for its bf16
    # composite, tests/test_pallas_interpret.py) of the sweep_block = 1 step.
    k5_paths = [
        ("bench128 T=2", cfg.replace(jacobi_sweep_block=2), {"K1": 10, "K2": 10}),
        ("bench128 T=4", cfg.replace(jacobi_sweep_block=4), {"K1": 10, "K2": 10}),
        ("bench128 unfused T=2", cfg.replace(jacobi_sweep_block=2, fuse_project_advect=False),
         {"K1": 20, "K3": 10}),
        ("bench128 unfused T=4", cfg.replace(jacobi_sweep_block=4, fuse_project_advect=False),
         {"K1": 20, "K3": 10}),
        ("bench128 K8 T=4", cfg.replace(jacobi_sweep_block=4, fuse_self_advect=True),
         {"K8": 10}),
        ("vortex128 T=2", vcfg.replace(jacobi_sweep_block=2), {"K1": 20, "K3": 10}),
        ("vortex128 T=4", vcfg.replace(jacobi_sweep_block=4), {"K1": 20, "K3": 10}),
    ]
    k5_launches = {}
    for what, pcfg_k5, ran in k5_paths:
        keng = Engine(pcfg_k5, device="cuda")
        counters_to_zero()
        step_routes = dict(full_step_launches)
        keng.step(10)
        torch.cuda.synchronize()
        got_launches = counts()
        k5_launches[what] = got_launches
        k8_routes = {k: full_step_launches[k] - step_routes[k] for k in step_routes}
        say(f"# {what}: 10 steps, launches {got_launches}, solves by route "
            f"{dict(solve_launches)}, K8 by route {k8_routes}")
        if got_launches != {k: ran.get(k, 0) for k in got_launches}:
            fail(f"{what} did not run exactly {ran}: {got_launches}")
        tiled = (k8_routes == {"tiled": 10, "grid": 0} if "K8" in ran
                 else dict(solve_launches) == {"tiled": 10, "sweep": 0})
        if not tiled:
            fail(f"{what} did not solve on the tiles every step")
        check_state(keng.state, 10, n, what)
        ktwin = Engine(pcfg_k5, device="cuda", kernels=PLAIN_TWINS)
        ktwin.step(10)
        for name in ("density", "velocity", "pressure"):
            if not torch.equal(getattr(keng.state, name), getattr(ktwin.state, name)):
                fail(f"{what}: the kernel path differs from its twin path after 10 steps "
                     f"in {name}")
        del ktwin
        seq = Engine(pcfg_k5.replace(jacobi_sweep_block=1), device="cuda")
        seeded = keng.state.replace(density=density_field(n, rng, dev),
                                    velocity=velocity_field(n, rng, dev, 4.0),
                                    step=torch.zeros_like(keng.state.step),
                                    time=torch.zeros_like(keng.state.time))
        keng.state, seq.state = seeded, seeded
        keng.step(1)
        seq.step(1)
        for name in ("density", "velocity", "pressure"):
            r = getattr(seq.state, name)
            err = float((getattr(keng.state, name) - r).abs().max())
            scale = float(r.abs().max())
            say(f"# {what}: one step vs sweep_block=1, {name}: max abs diff {err!r} "
                f"(bound 3e-2 x {scale!r})")
            if err > 3e-2 * scale:
                fail(f"{what}: one step leaves the bf16-solve class of sweep_block=1 "
                     f"in {name}")
        del keng, seq
    # K4 and K14 lie on no Engine path (the JAX step passes K4 no sweep block
    # and dispatches K14 nowhere): their launches are one direct call each.
    counters_to_zero()
    jacobi_3d_resident(0, wzero, wdiv, 1.0, 6.0, iters, sweep_block=4)
    advect_project_3d_resident(wvel, iters, dt)
    torch.cuda.synchronize()
    direct_launches = counts()
    say(f"# K4 with sweep_block=4 and K14, one direct call each: launches {direct_launches}")
    if direct_launches["K4"] != 1 or direct_launches["K14"] != 1:
        fail("K4 (sweep_block=4) or K14 did not launch")

    # Times: each kernel beside the same kernel at T = 1 on the same inputs
    # and its twin, K14 beside K1 + K3, and bench128's steps/s and device ms a
    # step at T = 1, 2, 4 in turns.
    for key, (fn, plain, t, sweeps, _, _) in k5_cases.items():
        # On the tiles, beside the per-stage route it replaced and the same
        # call at T = 1 on the tiles, in turns.
        tiled, stage = in_turns(lambda: fn(t), lambda: fn(t), reps=20)
        ms, ms1 = min(tiled), cuda_ms(lambda: fn(1), reps=20)
        times[key] = (ms, cuda_ms(lambda: plain(t), reps=1, warmup=1))
        say(f"{key}: kernel on the tiles {tiled!r} ms ({1e3 * ms / sweeps!r} us a sweep), "
            f"per-stage route {stage!r} ms, the same kernel at T=1 on the tiles {ms1!r} ms "
            f"({1e3 * ms1 / sweeps!r} us a sweep), twin {times[key][1]!r} ms [{card}]")
    k14_ms = cuda_ms(lambda: advect_project_3d_resident(wvel, iters, dt), reps=20)
    k1k3_ms = cuda_ms(lambda: project_3d_resident(
        advect_multi_3d_kernel((1, 2, 3), wvel, wvel, dt), iters), reps=20)
    times["K14"] = (k14_ms, cuda_ms(lambda: advect_project_3d_resident_plain(wvel, iters, dt),
                                    reps=2, warmup=1))
    say(f"K14: kernel {k14_ms!r} ms, K1 + K3 {k1k3_ms!r} ms, twin {times['K14'][1]!r} ms "
        f"({iters} float32 sweeps) [{card}]")
    ab = {t: Engine(cfg.replace(jacobi_sweep_block=t), device="cuda") for t in (1, 2, 4)}
    for t, e in ab.items():
        e.step(10)
    rounds = {t: [] for t in ab}
    for _ in range(3):
        for t, e in ab.items():
            rounds[t].append(cuda_ms(lambda: e.step(1), reps=50, warmup=5))
    for t, e in ab.items():
        dev_ms = sum(profile_ms(lambda: e.step(1), reps=10).values())
        best = min(rounds[t])
        say(f"bench128 jacobi_sweep_block={t}: steps/s {1e3 / best!r} (ms/step in 3 turns "
            f"{rounds[t]!r}), device {dev_ms!r} ms/step [{card}]")
    del ab, wvvel, wdiv, wzero

    def k5_solve(sweeps, t, masked, sbytes):
        """(bytes of a model, float32 operations) of K5's solve at T = t.
        The operations, counted from the code of csrc/sweep_block.cuh (the
        shell planes and corrections on the (n - 2)^2 cells of their
        planes), enter the bound.  The bytes do not: the bound reads the
        kernel's inputs and writes its outputs once, as every row's does.
        They are the pass model, printed apart: per block one iterate read,
        one X read and one write, per sweep left over one iterate read, one
        rhs read and one write, each from DRAM."""
        blocks, left = divmod(sweeps, t)
        plane = (n - 2) ** 2
        nbytes = blocks * vol * (2 * sbytes + f32) + left * vol * 3 * sbytes
        if t == 2:
            pre = vol * (15 if masked else 8)
            per = vol * 5 + interior * (14 if masked else 7) + 6 * plane * 9
        else:
            pre = sum(vol * (5 + 3 + (6 if k == 1 else 0)) for k in range(1, t))
            shell = sum(2 * t - 1 - k for k in range(1, t + 1)) * 6 * plane * 8
            per = vol * 5 + (t - 2) * vol * 11 + interior * 14 + shell
        return nbytes, pre + blocks * per + left * interior * SWEEP_OPS

    def k5_row(key, label, replaces, launches, base_bytes, base_ops):
        t, sweeps, sbytes, masked = k5_cases[key][2:]
        model_bytes, nops = k5_solve(sweeps, t, masked, sbytes)
        model_ms = bound(base_bytes + model_bytes, 0)[0]
        say(f"{key}: pass model (every block's iterate and X through DRAM) "
            f"{model_ms!r} ms, {times[key][0]!r} ms measured [{card}]")
        return (key, label, "fluidsim_tpu_torch/csrc/sweep_block.cuh", replaces, launches,
                k5_err[key], bound(base_bytes, base_ops + nops))

    solve_at = "fluidsim_tpu/pallas/resident.py:341"
    k3_rest = interior * (DIV_OPS + GRAD_OPS)
    entries += [
        k5_row(f"K5 K3 T{t}", f"K5 in K3 project_3d_resident (sweep_block={t}, "
               f"{cfg.solve_dtype} solve, {iters} sweeps, no mask; bench128 unfused "
               f"jacobi_sweep_block={t})", solve_at,
               k5_launches[f"bench128 unfused T={t}"]["K3"], 7 * vol * f32, k3_rest)
        for t in (2, 4)]
    entries += [
        k5_row(f"K5 K3o T{t}", f"K5 in K3 project_3d_resident (sweep_block={t}, "
               f"{vcfg.solve_dtype} solve, {vcfg.jacobi_iters} sweeps, obstacle mask; "
               f"vortex128 jacobi_sweep_block={t})", solve_at,
               k5_launches[f"vortex128 T={t}"]["K3"], 7 * vol * f32 + vol,
               k3_rest + n_solid * 3 * MIRROR_OPS)
        for t in (2, 4)]
    entries += [
        k5_row(f"K5 K2 T{t}", f"K5 in K2 project_advect_density_3d (sweep_block={t}, "
               f"{cfg.solve_dtype} solve, {iters} sweeps; bench128 jacobi_sweep_block={t})",
               solve_at, k5_launches[f"bench128 T={t}"]["K2"], 9 * vol * f32,
               k3_rest + interior * (FRAC_OPS + RELU_OPS + COMB_OPS + 1))
        for t in (2, 4)]
    entries += [
        k5_row("K5 K8 T4", f"K5 in K8 full_step_3d (sweep_block=4, {cfg.solve_dtype} solve, "
               f"{iters} sweeps; bench128 fuse_self_advect + jacobi_sweep_block=4)",
               solve_at, k5_launches["bench128 K8 T=4"]["K8"], 9 * vol * f32,
               k3_rest + interior * (k1_ops + FRAC_OPS + RELU_OPS + COMB_OPS + 1)),
        k5_row("K5 K4 T4", f"K5 in K4 jacobi_3d_resident (sweep_block=4, float32, {iters} "
               "sweeps, b=0; one direct call: no Engine path passes K4 a sweep block)",
               solve_at, direct_launches["K4"], 3 * vol * f32, 0),
        ("K14", f"K14 advect_project_3d_resident (K=1, n_sub=1, {iters} float32 sweeps on the "
                "tiled solve's tiles; one direct call: no Engine path, as in the JAX package)",
         "fluidsim_tpu_torch/csrc/full_step.cu", "fluidsim_tpu/pallas/resident.py:915",
         direct_launches["K14"], k5_err["K14"],
         bound(7 * vol * f32, interior * (FRAC_OPS + RELU_OPS + 3 * COMB_OPS + DIV_OPS
                                          + iters * SWEEP_OPS + GRAD_OPS))),
    ]

    # -- 12. the explicit halo-exchange sharded step: K10 and K11 ------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 12")
    say("# phase 12: the explicit halo-exchange sharded step (K10, K11) on 8 shards")
    counters["K10"] = jacobi_ext_kernel
    counters["K11"] = advect_ext_kernel
    counters["K7e div"] = divergence_ext_kernel
    counters["K7e grad"] = gradient_ext_kernel
    torch.cuda.empty_cache()
    hcfg = preset_sharded_512()
    hn = hcfg.current_size
    hdt = hcfg.effective_params()[0]
    h_sub = hcfg.advect_substeps
    h_iters = hcfg.jacobi_iters
    hmesh = make_mesh(["cuda"] * 8)
    hlz = hn // hmesh.shape["z"]
    ext_err = {}

    def ext_slab(v, shard, lz, h):
        """Shard ``shard``'s halo-extended slab of the global ``v`` (z on axis
        -3), zeros past the global ends."""
        pad = torch.zeros_like(v.narrow(-3, 0, h))
        return torch.cat([pad, v, pad], -3).narrow(-3, shard * lz, lz + 2 * h).contiguous()

    def walls(shard, shards, lz, t):
        return (t if shard == 0 else NO_WALL, t + lz - 1 if shard == shards - 1 else NO_WALL)

    def held(key, got, ref):
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ext_err[key] = max(ext_err.get(key, 0.0), err)
        say(f"# {key}: kernel vs twin, max abs diff {err!r}")
        if not torch.equal(got, ref):
            fail(f"{key} disagrees with its twin")

    # 12a. K10 on sharded512's slabs (72 planes at T = 4, 68 at T = 2) of the
    # first, a middle and the last shard, b = 0 and 3, and on a 4-shard split
    # of 128³ with vortex128's sphere; inputs with set_bnd-consistent faces.
    hx0 = smooth(hn, rng, dev)
    for b in (0, 3):
        hx = set_bnd_3d(b, smooth(hn, rng, dev))
        for t in (4, 2):
            for shard in (0, 3, 7):
                xe, x0e = ext_slab(hx, shard, hlz, t), ext_slab(hx0, shard, hlz, t)
                args = (xe, x0e, 1.0, 6.0, t, *walls(shard, 8, hlz, t), b)
                held(f"K10 T={t}", jacobi_ext_kernel(*args), jacobi_ext_plain(*args))
        del hx, xe, x0e
    v4cfg = preset_vortex_128()
    vn, v4dt = v4cfg.current_size, v4cfg.effective_params()[0]
    vmask = torch.as_tensor(build_obstacle_mask(v4cfg), device=dev)
    vdiv = divergence_3d_plain(velocity_field(vn, rng, dev, 12.0))
    vp = set_bnd_3d(0, torch.zeros_like(vdiv), vmask)
    for shard in range(4):
        args = (ext_slab(vp, shard, vn // 4, 2), ext_slab(vdiv, shard, vn // 4, 2), 1.0, 6.0,
                2, *walls(shard, 4, vn // 4, 2), 0, ext_slab(vmask, shard, vn // 4, 2))
        held("K10 mask", jacobi_ext_kernel(*args), jacobi_ext_plain(*args))
    # The 8-shard solve against K6 on the whole volume: 20 sweeps from zero.
    hvel = velocity_field(hn, rng, dev, 0.5)
    hdiv = divergence_3d_plain(hvel)
    hzero = torch.zeros_like(hdiv)
    k6_whole = jacobi_3d_kernel(0, hzero, hdiv, 1.0, 6.0, h_iters)
    for t in (4, 2):
        got = jacobi_3d_sharded(hzero, hdiv, 1.0, 6.0, h_iters, hmesh, block_iters=t,
                                backend="pallas")
        err, ok = worst(got, k6_whole, 2e-6, 2e-6)
        say(f"# 8-shard K10 solve (T={t}) vs K6 on the whole {hn}^3 volume, {h_iters} sweeps: "
            f"max abs diff {err!r} (bitwise {torch.equal(got, k6_whole)}; bound rtol = atol = "
            f"2e-6)")
        if not ok:
            fail(f"the 8-shard K10 solve at T={t} leaves the bound of K6")
        del got
    del k6_whole

    # K7e on the planes and halo planes of sharded512's first, a middle and
    # the last shard at 512³, and of a 4-shard split of 128³.
    def shard_planes(v, shards, shard):
        """Shard ``shard``'s planes of the global ``v`` (z on axis -3), and
        the halo planes (below, above) of its last component, None past the
        global ends."""
        lz_ = v.shape[-1] // shards
        last = v.reshape(-1, *v.shape[-3:])[-1]
        return (v.narrow(-3, shard * lz_, lz_).contiguous(),
                last[shard * lz_ - 1].contiguous() if shard > 0 else None,
                last[(shard + 1) * lz_].contiguous() if shard < shards - 1 else None)

    hp = smooth(hn, rng, dev)
    for shards, vv, pp in ((8, hvel, hp),
                           (4, velocity_field(vn, rng, dev, 12.0), smooth(vn, rng, dev))):
        lz_ = vv.shape[-1] // shards
        for shard in ((0, 3, 7) if shards == 8 else range(4)):
            v, *vz_h = shard_planes(vv, shards, shard)
            q, *p_h = shard_planes(pp, shards, shard)
            w = walls(shard, shards, lz_, 0)
            # The planes contiguous, and as the step passes them: a view of
            # a wider slab (K11's kept planes), the components further apart.
            wide = torch.zeros((3, lz_ + 4, vv.shape[-1], vv.shape[-1]), device=dev)
            wide[:, 2:-2] = v
            for vel_in in (v, wide[:, 2:-2]):
                held("K7e div", divergence_ext_kernel(vel_in, *vz_h, *w),
                     divergence_ext_plain(v, *vz_h, *w))
                held("K7e grad", gradient_ext_kernel(vel_in, q, *p_h, *w),
                     gradient_ext_plain(v, q, *p_h, *w))
    del v, q, vz_h, p_h, hp, vv, pp, wide, vel_in

    # 12b. K11: F = 3 self-advection and F = 1 at window 1, two substeps, on
    # sharded512's slabs; vortex128's sphere with three substeps on a 4-shard
    # split of 128³ (a halo of 6 planes); K = 2 at 128³; then the 8-shard
    # advection against K1 on the whole volume.
    hdens = density_field(hn, rng, dev)
    hh = ext_halo(hcfg.advect_window, h_sub, False)
    for shard in (0, 3, 7):
        ve = ext_slab(hvel, shard, hlz, hh)
        de = ext_slab(hdens[None], shard, hlz, hh)
        zoff = shard * hlz - hh
        held("K11 F=3", advect_ext_kernel((1, 2, 3), ve, ve, hn, hdt, zoff, 1, h_sub),
             advect_ext_plain((1, 2, 3), ve, ve, hn, hdt, zoff, 1, h_sub))
        held("K11 F=1", advect_ext_kernel((0,), de, ve, hn, hdt, zoff, 1, h_sub),
             advect_ext_plain((0,), de, ve, hn, hdt, zoff, 1, h_sub))
        del ve, de
    vvel = velocity_field(vn, rng, dev, 30.0)
    vdens = density_field(vn, rng, dev)
    for window, v_sub, mask in ((1, v4cfg.advect_substeps, vmask), (2, 2, None)):
        vh = ext_halo(window, v_sub, mask is not None)
        for shard in range(4):
            ve = ext_slab(vvel, shard, vn // 4, vh)
            de = ext_slab(vdens[None], shard, vn // 4, vh)
            me = None if mask is None else ext_slab(mask, shard, vn // 4, vh)
            zoff = shard * (vn // 4) - vh
            what = "K11 mask" if mask is not None else "K11 K=2"
            for bs, f in (((1, 2, 3), ve), ((0,), de)):
                held(what, advect_ext_kernel(bs, f, ve, vn, v4dt, zoff, window, v_sub, me),
                     advect_ext_plain(bs, f, ve, vn, v4dt, zoff, window, v_sub, me))
    del ve, de, vvel, vdens, vdiv, vp
    got = advect_multi_3d_sharded((1, 2, 3), hvel, hvel, hdt, hmesh, window=1, n_sub=h_sub)
    k1_whole = advect_multi_3d_kernel((1, 2, 3), hvel, hvel, hdt, n_sub=h_sub)
    err, ok = worst(got, k1_whole, 5e-4, 5e-5)
    say(f"# 8-shard K11 advection vs K1 on the whole {hn}^3 volume: max abs diff {err!r} "
        f"(bitwise {torch.equal(got, k1_whole)}; bound rtol 5e-4, atol 5e-5)")
    if not ok:
        fail("the 8-shard K11 advection leaves the bound of K1")
    del got, k1_whole

    # 12c. sharded512 on 8 shards of the card through sharded_step_fn, at
    # T = 4 for HALO_STEPS steps and T = 2 for HALO_T2_STEPS, the counters at
    # zero just before each run.
    def halo_step(t, kernels=None):
        kw = {} if kernels is None else {"kernels": kernels}
        return sharded_step_fn(hcfg, hmesh, halo="explicit", halo_block_iters=t,
                               halo_backend="pallas", **kw)

    hstart = shard_state(zeros_state(hcfg, dev), hmesh)
    halo_launches = {}
    for t, steps in ((4, HALO_STEPS), (2, HALO_T2_STEPS)):
        step = halo_step(t)
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st = hstart
        counters_to_zero()
        st = step(st)
        hmass1, hcom1 = mass_and_com_y(st)
        for i in range(1, steps):
            st = step(st)
            if i + 1 == HALO_TWIN_STEPS:
                hat = {k: getattr(as_global(st), k) for k in ("density", "velocity", "pressure")}
        torch.cuda.synchronize()
        got_launches = counts()
        halo_launches[t] = got_launches
        peak = torch.cuda.max_memory_allocated()
        hmass_end, hcom_end = mass_and_com_y(st)
        say(f"# sharded512, 8 shards, T={t}: {steps} steps, launches {got_launches}")
        say(f"# sharded512 8 shards T={t} density mass: step 1 {hmass1!r}, step {steps} "
            f"{hmass_end!r}; y centre of mass {hcom1!r} -> {hcom_end!r}")
        say(f"sharded512 8 shards T={t} peak device memory: {peak - mem_before!r} bytes above "
            f"what earlier phases hold ({peak!r} in all) [{card}]")
        want = {"K10": 8 * (h_iters // t) * steps, "K11": 8 * 2 * steps,
                "K7e div": 8 * steps, "K7e grad": 8 * steps}
        if got_launches != {k: want.get(k, 0) for k in got_launches}:
            fail(f"sharded512 on 8 shards (T={t}) did not run exactly {want}: {got_launches}")
        say(f"# sharded512 8 shards T={t}: gathered ops {dict(gathered_ops)}")
        if sum(gathered_ops.values()):
            fail(f"sharded512 on 8 shards (T={t}) gathered a whole volume: {dict(gathered_ops)}")
        check_state(st, steps, hn, f"sharded512 8 shards T={t}")
        if not hmass_end > hmass1 > 0.0:
            fail(f"sharded512 8 shards T={t}: density mass does not grow")
        if not hcom_end > hcom1:
            fail(f"sharded512 8 shards T={t}: the plume does not rise")
        twin_step = halo_step(t, PLAIN_TWINS)
        tw = hstart
        for _ in range(HALO_TWIN_STEPS):
            tw = twin_step(tw)
        tw = as_global(tw)
        for name, got in hat.items():
            if not torch.equal(got, getattr(tw, name)):
                fail(f"sharded512 8 shards T={t}: the kernel path differs from its twin path "
                     f"after {HALO_TWIN_STEPS} steps in {name}")
        say(f"# sharded512 8 shards T={t}: kernel path bitwise the twin path after "
            f"{HALO_TWIN_STEPS} steps")
        del st, tw, hat, got
    # One step from a seeded state against the unsharded Engine (K7 -> K6 -> K7).
    seeded = zeros_state(hcfg, dev).replace(density=hdens, velocity=hvel)
    hone = unshard_state(halo_step(4)(shard_state(seeded, hmesh)))
    seng.state = seeded
    seng.step(1)
    for name in ("density", "velocity", "pressure"):
        r = getattr(seng.state, name)
        err = float((getattr(hone, name) - r).abs().max())
        scale = float(r.abs().max())
        say(f"# sharded512: one 8-shard step vs the unsharded Engine step, {name}: max abs "
            f"diff {err!r} (bound 1e-5 x {scale!r})")
        if err > 1e-5 * scale:
            fail(f"sharded512: the 8-shard step leaves 1e-5 of the unsharded step in {name}")
    del hone, seeded

    # 12d. Times: K10 a round per shard and a solve, K11 a call, K7e a
    # call, and steps/s of the 8-shard path at T = 2 and 4 beside
    # the unsharded Engine, in turns.
    for t in (4, 2):
        xe, x0e = ext_slab(hzero, 3, hlz, t), ext_slab(hdiv, 3, hlz, t)
        args = (xe, x0e, 1.0, 6.0, t, NO_WALL, NO_WALL, 0)
        times[f"K10 T{t}"] = (cuda_ms(lambda: jacobi_ext_kernel(*args), reps=50),
                              cuda_ms(lambda: jacobi_ext_plain(*args), reps=3, warmup=1))
        solve_ms = cuda_ms(lambda: jacobi_3d_sharded(hzero, hdiv, 1.0, 6.0, h_iters, hmesh,
                                                     block_iters=t, backend="pallas"), reps=5)
        say(f"K10 T={t}: {times[f'K10 T{t}'][0]!r} ms a round of one shard ({xe.shape[0]} "
            f"planes), twin {times[f'K10 T{t}'][1]!r} ms; the 8-shard solve ({h_iters} sweeps, "
            f"{8 * h_iters // t} launches) {solve_ms!r} ms [{card}]")
    ve = ext_slab(hvel, 3, hlz, hh)
    de = ext_slab(hdens[None], 3, hlz, hh)
    k11_args = {"K11 F=3": ((1, 2, 3), ve, ve, hn, hdt, 3 * hlz - hh, 1, h_sub),
                "K11 F=1": ((0,), de, ve, hn, hdt, 3 * hlz - hh, 1, h_sub)}
    for key, args in k11_args.items():
        times[key] = (cuda_ms(lambda: advect_ext_kernel(*args), reps=20),
                      cuda_ms(lambda: advect_ext_plain(*args), reps=2, warmup=1))
        say(f"{key}: {times[key][0]!r} ms a call on one shard's slab {tuple(args[1].shape)}, "
            f"twin {times[key][1]!r} ms [{card}]")

    # K7e on shard 3's planes and halo planes as the step passes them (the
    # velocity K11's kept planes, a view of its (3, lz + 2h, n, n) result),
    # and on contiguous planes; conv3d computes the divergence of the same
    # shard from its one-plane extended slab (its interior cells), the
    # library's yardstick.
    v3c, *vz3 = shard_planes(hvel, 8, 3)
    v3 = ext_slab(hvel, 3, hlz, hh)[:, hh:hh + hlz]
    p3, *p3h = shard_planes(hdiv, 8, 3)
    times["K7e div"] = (
        cuda_ms(lambda: divergence_ext_kernel(v3, *vz3, NO_WALL, NO_WALL), reps=50),
        cuda_ms(lambda: divergence_ext_plain(v3, *vz3, NO_WALL, NO_WALL), reps=5))
    times["K7e grad"] = (
        cuda_ms(lambda: gradient_ext_kernel(v3, p3, *p3h, NO_WALL, NO_WALL), reps=50),
        cuda_ms(lambda: gradient_ext_plain(v3, p3, *p3h, NO_WALL, NO_WALL), reps=5))
    contiguous_ms = {
        "K7e div": cuda_ms(lambda: divergence_ext_kernel(v3c, *vz3, NO_WALL, NO_WALL), reps=50),
        "K7e grad": cuda_ms(lambda: gradient_ext_kernel(v3c, p3, *p3h, NO_WALL, NO_WALL),
                            reps=50)}
    ve1 = ext_slab(hvel, 3, hlz, 1)
    hdiv_w = div_weights(hn)
    library["K7e div"] = cuda_ms(lambda: F.conv3d(ve1[None], hdiv_w), reps=20)
    for key in ("K7e div", "K7e grad"):
        say(f"{key}: {times[key][0]!r} ms a call on one shard's {tuple(v3.shape)} planes "
            f"(components {v3.stride(0)} floats apart, as K11 leaves them) and halo planes, "
            f"{contiguous_ms[key]!r} ms on contiguous planes, twin {times[key][1]!r} ms, "
            f"conv3d {library.get(key)!r} ms on its {tuple(ve1.shape)} extended slab [{card}]")
    del v3, v3c, vz3, p3, p3h, ve1
    hsteps = {"8 shards T=4": halo_step(4), "8 shards T=2": halo_step(2)}
    hstates = {k: hstart for k in hsteps}
    for k in hsteps:
        hstates[k] = hsteps[k](hstates[k])
    seng.state = zeros_state(hcfg, dev)
    halo_rounds = {k: [] for k in (*hsteps, "unsharded Engine")}
    for _ in range(3):
        for k, fn in hsteps.items():
            def adv(k=k, fn=fn):
                hstates[k] = fn(hstates[k])
            halo_rounds[k].append(cuda_ms(adv, reps=5, warmup=1))
        halo_rounds["unsharded Engine"].append(cuda_ms(lambda: seng.step(1), reps=5, warmup=1))
    for k, ms in halo_rounds.items():
        if k == "unsharded Engine":
            by_kernel = profile_ms(lambda: seng.step(1), reps=3)
        else:
            def adv(k=k):
                hstates[k] = hsteps[k](hstates[k])
            by_kernel = profile_ms(adv, reps=3)
        say(f"sharded512 {k}: steps/s {1e3 / min(ms)!r} (ms/step in 3 turns {ms!r}), device "
            f"{sum(by_kernel.values())!r} ms/step [{card}]")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        say(f"# sharded512 {k}, device ms a step by kernel: "
            + "; ".join(f"{name} {t!r}" for name, t in top))
    del hstates, hsteps

    # 12e. The CLI's bench on 8 shards, as a subprocess.
    torch.cuda.empty_cache()
    cli = subprocess.run(
        [sys.executable, "-m", "fluidsim_tpu_torch.cli", "bench", "--preset", "sharded512",
         "--mesh", "8", "--halo", "explicit", "--halo-block-iters", "4", "--halo-backend",
         "pallas", "--steps", "4"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    if cli.returncode != 0:
        fail(f"the CLI's bench --mesh 8 failed: {cli.stderr[-2000:]}")
    bench_line = json.loads(cli.stdout.strip().splitlines()[-1])
    say(f"cli bench --preset sharded512 --mesh 8 --halo explicit --halo-block-iters 4: "
        f"{json.dumps(bench_line)} [{card}]")
    if bench_line.get("mesh") != 8 \
            or bench_line.get("devices") != min(8, torch.cuda.device_count()) \
            or not bench_line.get("steps_per_sec", 0) > 0:
        fail(f"the CLI's bench line is not the 8-shard run's: {bench_line}")
    del ve, de, hvel, hdens, hdiv, hzero, hx0, hstart

    hplane = hn * hn
    hcells = (hn - 2) ** 2
    entries += [
        ("K7e div", f"K7e divergence_ext_kernel (one shard's (3, {hlz}, {hn}, {hn}) velocity "
                    f"and two halo planes of its z component in, its ({hlz}, {hn}, {hn}) "
                    f"planes out; sharded512 on 8 shards, the projection's divergence)",
         "fluidsim_tpu_torch/csrc/project_slab.cu", "fluidsim_tpu/pallas/project.py:43",
         halo_launches[4]["K7e div"], ext_err["K7e div"],
         bound((2 * hlz + (hlz + 2) + hlz) * hplane * f32, hlz * hcells * DIV_OPS)),
        ("K7e grad", f"K7e gradient_ext_kernel (one shard's (3, {hlz}, {hn}, {hn}) velocity, "
                     f"its ({hlz}, {hn}, {hn}) pressure and two halo planes of it in, "
                     f"(3, {hlz}, {hn}, {hn}) out; sharded512 on 8 shards)",
         "fluidsim_tpu_torch/csrc/project_slab.cu", "fluidsim_tpu/pallas/project.py:85",
         halo_launches[4]["K7e grad"], ext_err["K7e grad"],
         bound((3 * hlz + (hlz + 2) + 3 * hlz) * hplane * f32, hlz * hcells * GRAD_OPS)),
    ]
    entries += [
        (f"K10 T{t}", f"K10 jacobi_ext_kernel (T={t} sweeps a round on one shard's "
                      f"({hlz + 2 * t}, {hn}, {hn}) slab, b=0; sharded512 on 8 shards, "
                      f"halo_block_iters={t})",
         "fluidsim_tpu_torch/csrc/jacobi_ext.cu", "fluidsim_tpu/pallas/halo_kernel.py:66",
         halo_launches[t]["K10"], ext_err[f"K10 T={t}"],
         bound(3 * (hlz + 2 * t) * hplane * f32, t * (hlz + 2 * t) * hcells * JACOBI_OPS))
        for t in (4, 2)]
    # sharded512 launches K11 twice a shard and a step, once for each of these two.
    entries += [
        ("K11 F=3", f"K11 advect_ext_kernel (F=3 self-advection, K=1, n_sub={h_sub}, on one "
                    f"shard's (3, {hlz + 2 * hh}, {hn}, {hn}) slab; sharded512 on 8 shards)",
         "fluidsim_tpu_torch/csrc/advect_ext.cu", "fluidsim_tpu/pallas/halo_kernel.py:226",
         halo_launches[4]["K11"], ext_err["K11 F=3"],
         bound(6 * (hlz + 2 * hh) * hplane * f32,
               h_sub * (hlz + 2 * hh) * hcells * (FRAC_OPS + RELU_OPS + 3 * COMB_OPS))),
        ("K11 F=1", f"K11 advect_ext_kernel (F=1 density, K=1, n_sub={h_sub}, on one shard's "
                    f"({hlz + 2 * hh}, {hn}, {hn}) slab; sharded512 on 8 shards)",
         "fluidsim_tpu_torch/csrc/advect_ext.cu", "fluidsim_tpu/pallas/halo_kernel.py:226",
         halo_launches[4]["K11"], ext_err["K11 F=1"],
         bound(5 * (hlz + 2 * hh) * hplane * f32,
               h_sub * (hlz + 2 * hh) * hcells * (FRAC_OPS + RELU_OPS + COMB_OPS))),
    ]

    # -- 13. the "rdma" backend (K12, K13) and bfloat16 fields (K11) -------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 13")
    say("# phase 13: the rdma backend (K12, K13) and K11 on bfloat16 slabs, 8 shards")
    counters["K12"] = jacobi_ext_rdma
    counters["K13"] = halo_exchange_rdma
    torch.cuda.empty_cache()
    bf16 = torch.bfloat16

    def held_all(key, got, ref):
        """Every shard's outputs of a call over all shards, bitwise."""
        flat_got = [t for g in got for t in (g if isinstance(g, list) else [g])]
        flat_ref = [t for r in ref for t in (r if isinstance(r, list) else [r])]
        torch.cuda.synchronize()
        err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(flat_got, flat_ref))
        ext_err[key] = max(ext_err.get(key, 0.0), err)
        if not all(torch.equal(g, r) for g, r in zip(flat_got, flat_ref)):
            fail(f"{key} disagrees with its twin (max abs diff {err!r})")

    def shard_slabs(v, shards, h):
        lz = v.shape[-3] // shards
        return [ext_slab(v, r, lz, h) for r in range(shards)]

    # 13a. K12 on sharded512's 8 slabs, T = 2, 3, 4 and b = 0..3 (every rank
    # kind in each call: the first, the middle and the last shard), and with
    # vortex128's sphere on a 4-shard split of 128³; two chained rounds each.
    hx0 = smooth(hn, rng, dev)
    for b in (0, 1, 2, 3):
        hx = set_bnd_3d(b, smooth(hn, rng, dev))
        for t in (4, 3, 2):
            xps, x0s = shard_slabs(hx, 8, t), shard_slabs(hx0, 8, t)
            for _ in range(2):
                got = jacobi_ext_rdma(xps, x0s, 1.0, 6.0, t, b)
                held_all(f"K12 T={t}", got, jacobi_ext_rdma_plain(xps, x0s, 1.0, 6.0, t, b))
                xps = got
            del xps, x0s, got
        say(f"# K12 b={b}: 8 shards of sharded512, T = 4, 3, 2, two rounds: kernel bitwise "
            f"its twin")
        del hx
    vdiv = divergence_3d_plain(velocity_field(vn, rng, dev, 12.0))
    vp = set_bnd_3d(0, torch.zeros_like(vdiv), vmask)
    for t in (4, 3, 2):
        xps, x0s, ms = (shard_slabs(v, 4, t) for v in (vp, vdiv, vmask))
        for _ in range(2):
            got = jacobi_ext_rdma(xps, x0s, 1.0, 6.0, t, 0, ms)
            held_all("K12 mask", got, jacobi_ext_rdma_plain(xps, x0s, 1.0, 6.0, t, 0, ms))
            xps = got
    say(f"# K12 with vortex128's sphere, 4 shards of 128^3, T = 4, 3, 2: max abs diff "
        f"{ext_err['K12 mask']!r} (bitwise)")
    del xps, x0s, ms, got, vdiv, vp

    # K13 on float32 (the velocity's channels as views of the global tensor),
    # bfloat16 and the bool mask, depth 1-4, three arrays a call, on 8 shards
    # of 512³ and 4 of 128³ (vortex128's sphere).
    hvel = velocity_field(hn, rng, dev, 0.5)
    hdens = density_field(hn, rng, dev)
    hmask = hdens > 30.0
    vvel = velocity_field(vn, rng, dev, 30.0)
    for shards, arrays in ((8, [hvel, hdens[None].to(bf16), hmask[None]]),
                           (4, [vvel, vvel[:1].to(bf16), vmask[None]])):
        for depth in (1, 2, 3, 4):
            by_shard = [[torch.chunk(a, shards, 1)[r] for a in arrays] for r in range(shards)]
            held_all(f"K13 {shards} shards", halo_exchange_rdma(by_shard, depth),
                     halo_exchange_rdma_plain(by_shard, depth))
        say(f"# K13 on {shards} shards (float32, bfloat16, bool; depth 1-4): kernel bitwise "
            f"its twin")
    del by_shard, hmask

    # K11 on bfloat16 slabs: F = 3 self-advection and F = 1 at K = 1, two
    # substeps, on sharded512's slabs of the first, a middle and the last
    # shard; on 4-shard splits of 128³ with vortex128's sphere and three
    # substeps (and at K = 3 with one), and at K = 2, 3 with two substeps.
    hvel_b, hdens_b = hvel.to(bf16), hdens.to(bf16)
    for shard in (0, 3, 7):
        ve = ext_slab(hvel_b, shard, hlz, hh)
        de = ext_slab(hdens_b[None], shard, hlz, hh)
        zoff = shard * hlz - hh
        held("K11 bf16 F=3", advect_ext_kernel((1, 2, 3), ve, ve, hn, hdt, zoff, 1, h_sub),
             advect_ext_plain((1, 2, 3), ve, ve, hn, hdt, zoff, 1, h_sub))
        held("K11 bf16 F=1", advect_ext_kernel((0,), de, ve, hn, hdt, zoff, 1, h_sub),
             advect_ext_plain((0,), de, ve, hn, hdt, zoff, 1, h_sub))
    vvel_b, vdens_b = vvel.to(bf16), density_field(vn, rng, dev).to(bf16)
    for window, v_sub, mask in ((1, v4cfg.advect_substeps, vmask), (3, 1, vmask),
                                (2, 2, None), (3, 2, None)):
        vh = ext_halo(window, v_sub, mask is not None)
        for shard in range(4):
            ve = ext_slab(vvel_b, shard, vn // 4, vh)
            de = ext_slab(vdens_b[None], shard, vn // 4, vh)
            me = None if mask is None else ext_slab(mask, shard, vn // 4, vh)
            zoff = shard * (vn // 4) - vh
            for bs, f in (((1, 2, 3), ve), ((0,), de)):
                held("K11 bf16 128", advect_ext_kernel(bs, f, ve, vn, v4dt, zoff, window, v_sub,
                                                       me),
                     advect_ext_plain(bs, f, ve, vn, v4dt, zoff, window, v_sub, me))
    del ve, de, me, vvel, vvel_b, vdens_b

    # 13b. The 8-shard rdma solve against the pallas solve and K6 on the whole
    # 512³ volume, 20 sweeps from zero, at T = 4 and 2.
    hdiv = divergence_3d_plain(hvel)
    hzero = torch.zeros_like(hdiv)
    k6_whole = jacobi_3d_kernel(0, hzero, hdiv, 1.0, 6.0, h_iters)
    for t in (4, 2):
        got = jacobi_3d_sharded(hzero, hdiv, 1.0, 6.0, h_iters, hmesh, block_iters=t,
                                backend="rdma")
        pal = jacobi_3d_sharded(hzero, hdiv, 1.0, 6.0, h_iters, hmesh, block_iters=t,
                                backend="pallas")
        say(f"# 8-shard rdma solve (T={t}) vs the pallas solve and K6 on the whole {hn}^3 "
            f"volume: bitwise {torch.equal(got, pal)} and {torch.equal(got, k6_whole)}")
        if not (torch.equal(got, pal) and torch.equal(got, k6_whole)):
            fail(f"the 8-shard rdma solve at T={t} differs from the pallas solve or K6")
        del got, pal
    del k6_whole

    # sharded512 on 8 shards with halo_backend="rdma" against "pallas": T = 4
    # for HALO_STEPS steps and T = 2 for HALO_T2_STEPS, the counters at zero
    # just before each run; then bfloat16 fields on both backends at T = 4
    # for BF16_HALO_STEPS, each bitwise its twin path.
    def backend_step(cfg, t, backend, kernels=None):
        kw = {} if kernels is None else {"kernels": kernels}
        return sharded_step_fn(cfg, hmesh, halo="explicit", halo_block_iters=t,
                               halo_backend=backend, **kw)

    def run_counted(step, start, steps, what):
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counters_to_zero()
        st = step(start)
        mass1, com1 = mass_and_com_y(st)
        for _ in range(1, steps):
            st = step(st)
        torch.cuda.synchronize()
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        mass_end, com_end = mass_and_com_y(st)
        say(f"# {what}: {steps} steps, launches {got}; density mass {mass1!r} -> "
            f"{mass_end!r}, y centre of mass {com1!r} -> {com_end!r}")
        say(f"{what} peak device memory: {peak - mem_before!r} bytes above what earlier "
            f"phases hold ({peak!r} in all) [{card}]")
        check_state(st, steps, hn, what)
        if not mass_end > mass1 > 0.0:
            fail(f"{what}: density mass does not grow")
        if not com_end > com1:
            fail(f"{what}: the plume does not rise")
        return st, got

    rdma_launches = {}
    hstart = shard_state(zeros_state(hcfg, dev), hmesh)
    for t, steps in ((4, HALO_STEPS), (2, HALO_T2_STEPS)):
        st, got = run_counted(backend_step(hcfg, t, "rdma"), hstart, steps,
                              f"sharded512 8 shards rdma T={t}")
        rdma_launches[t] = got
        # K13: the solve's priming and the two advections' slabs (K7e reads
        # the projection's halo planes in place).
        want = {"K12": 8 * (h_iters // t) * steps, "K13": 8 * 3 * steps, "K11": 8 * 2 * steps,
                "K7e div": 8 * steps, "K7e grad": 8 * steps}
        if got != {k: want.get(k, 0) for k in got}:
            fail(f"sharded512 rdma on 8 shards (T={t}) did not run exactly {want}: {got}")
        say(f"# sharded512 8 shards rdma T={t}: gathered ops {dict(gathered_ops)}")
        if sum(gathered_ops.values()):
            fail(f"sharded512 rdma on 8 shards (T={t}) gathered a whole volume")
        pal = hstart
        pal_step = backend_step(hcfg, t, "pallas")
        for _ in range(steps):
            pal = pal_step(pal)
        st, pal = as_global(st), as_global(pal)
        for name in ("density", "velocity", "pressure"):
            if not torch.equal(getattr(st, name), getattr(pal, name)):
                fail(f"sharded512 8 shards T={t}: rdma differs from pallas after {steps} steps "
                     f"in {name}")
        say(f"# sharded512 8 shards T={t}: rdma bitwise pallas after {steps} steps")
        del st, pal
    bcfg = hcfg.replace(dtype="bfloat16")
    bstart = shard_state(zeros_state(bcfg, dev), hmesh)
    bf16_launches, bf16_states = {}, {}
    for backend, ran in (("pallas", ("K10", "K11", "K7e div", "K7e grad")),
                         ("rdma", ("K12", "K13", "K11", "K7e div", "K7e grad"))):
        st, got = run_counted(backend_step(bcfg, 4, backend), bstart, BF16_HALO_STEPS,
                              f"sharded512 bf16 8 shards {backend} T=4")
        bf16_launches[backend] = got
        per_step = {"K10": 8 * (h_iters // 4), "K12": 8 * (h_iters // 4), "K13": 8 * 3,
                    "K11": 8 * 2, "K7e div": 8, "K7e grad": 8}
        want = {k: per_step[k] * BF16_HALO_STEPS for k in ran}
        if got != {k: want.get(k, 0) for k in got}:
            fail(f"sharded512 bf16 {backend} on 8 shards did not run exactly {want}: {got}")
        st = as_global(st)
        if st.density.dtype != bf16 or st.velocity.dtype != bf16:
            fail(f"sharded512 bf16 {backend}: the fields left bfloat16")
        tw = bstart
        twin_step = backend_step(bcfg, 4, backend, PLAIN_TWINS)
        for _ in range(BF16_HALO_STEPS):
            tw = twin_step(tw)
        tw = as_global(tw)
        for name in ("density", "velocity", "pressure"):
            if not torch.equal(getattr(st, name), getattr(tw, name)):
                fail(f"sharded512 bf16 {backend}: the kernel path differs from its twin path "
                     f"after {BF16_HALO_STEPS} steps in {name}")
        say(f"# sharded512 bf16 8 shards {backend}: kernel path bitwise the twin path after "
            f"{BF16_HALO_STEPS} steps")
        bf16_states[backend] = st
        del tw
    for name in ("density", "velocity", "pressure"):
        if not torch.equal(getattr(bf16_states["rdma"], name),
                           getattr(bf16_states["pallas"], name)):
            fail(f"sharded512 bf16: rdma differs from pallas in {name}")
    del bf16_states, st

    # 13c. Times: K12 a round of the 8 shards (a launch is one shard's share),
    # K13's three calls of a T = 4 step beside their torch.cat, K11 on
    # bfloat16 slabs, what is left of the copies, and steps/s of rdma, pallas
    # and the unsharded Engine in turns, with device ms a step by kernel.
    k12_planes = {}
    for t in (4, 2):
        xps, x0s = shard_slabs(hzero, 8, t), shard_slabs(hdiv, 8, t)
        k12_planes[t] = xps[0].shape[0]
        times[f"K12 T{t}"] = tuple(ms / 8 for ms in (
            cuda_ms(lambda: jacobi_ext_rdma(xps, x0s, 1.0, 6.0, t, 0), reps=20),
            cuda_ms(lambda: jacobi_ext_rdma_plain(xps, x0s, 1.0, 6.0, t, 0), reps=3,
                    warmup=1)))
        say(f"K12 T={t}: {times[f'K12 T{t}'][0]!r} ms a launch (an 8-shard round / 8, "
            f"{k12_planes[t]} planes a slab), twin {times[f'K12 T{t}'][1]!r} ms [{card}]")
        del xps, x0s
    k13_calls = {
        "K13 prime": ([[z[None], d[None]] for z, d in
                       zip(torch.chunk(hzero, 8), torch.chunk(hdiv, 8))], 4),
        "K13 self": ([[v] for v in torch.chunk(hvel, 8, 1)], hh),
        "K13 density": ([[d, v] for d, v in zip(torch.chunk(hdens[None], 8, 1),
                                                torch.chunk(hvel, 8, 1))], hh),
    }

    def cat_only(by_shard, h, zeros):
        """The same extended arrays by torch.cat alone (the zero halos made
        beforehand)."""
        k = len(by_shard)
        return [[torch.cat([by_shard[r - 1][j][:, -h:] if r > 0 else zeros[j], x,
                            by_shard[r + 1][j][:, :h] if r < k - 1 else zeros[j]], 1)
                 for j, x in enumerate(arrays)] for r, arrays in enumerate(by_shard)]

    for key, (by_shard, h) in k13_calls.items():
        zeros = [torch.zeros_like(x[:, :h]) for x in by_shard[0]]
        times[key] = tuple(ms / 8 for ms in (
            cuda_ms(lambda: halo_exchange_rdma(by_shard, h), reps=20),
            cuda_ms(lambda: halo_exchange_rdma_plain(by_shard, h), reps=5)))
        library[key] = cuda_ms(lambda: cat_only(by_shard, h, zeros), reps=20) / 8
        say(f"{key}: {times[key][0]!r} ms a launch (a call / 8; {len(by_shard[0])} arrays, "
            f"depth {h}), twin {times[key][1]!r} ms, torch.cat {library[key]!r} ms [{card}]")
    hvel_b, hdens_b = hvel.to(bf16), hdens.to(bf16)
    ve = ext_slab(hvel_b, 3, hlz, hh)
    de = ext_slab(hdens_b[None], 3, hlz, hh)
    k11b_args = {"K11 bf16 F=3": ((1, 2, 3), ve, ve, hn, hdt, 3 * hlz - hh, 1, h_sub),
                 "K11 bf16 F=1": ((0,), de, ve, hn, hdt, 3 * hlz - hh, 1, h_sub)}
    for key, args in k11b_args.items():
        times[key] = (cuda_ms(lambda: advect_ext_kernel(*args), reps=20),
                      cuda_ms(lambda: advect_ext_plain(*args), reps=2, warmup=1))
        say(f"{key}: {times[key][0]!r} ms a call on one shard's slab {tuple(args[1].shape)}, "
            f"twin {times[key][1]!r} ms (float32 K11: {times[key.replace(' bf16', '')][0]!r}) "
            f"[{card}]")
    del ve, de, hvel_b, hdens_b
    seng.state = zeros_state(hcfg, dev)
    rsteps = {"rdma T=4": backend_step(hcfg, 4, "rdma"),
              "pallas T=4": backend_step(hcfg, 4, "pallas"),
              "rdma T=2": backend_step(hcfg, 2, "rdma"),
              "rdma bf16 T=4": backend_step(bcfg, 4, "rdma")}
    rstates = {k: (bstart if "bf16" in k else hstart) for k in rsteps}
    for k in rsteps:
        rstates[k] = rsteps[k](rstates[k])
    rdma_rounds = {k: [] for k in (*rsteps, "unsharded Engine")}
    for _ in range(3):
        for k, fn in rsteps.items():
            def adv(k=k, fn=fn):
                rstates[k] = fn(rstates[k])
            rdma_rounds[k].append(cuda_ms(adv, reps=5, warmup=1))
        rdma_rounds["unsharded Engine"].append(cuda_ms(lambda: seng.step(1), reps=5, warmup=1))
    for k, ms in rdma_rounds.items():
        if k == "unsharded Engine":
            by_kernel = profile_ms(lambda: seng.step(1), reps=3)
        else:
            def adv(k=k):
                rstates[k] = rsteps[k](rstates[k])
            by_kernel = profile_ms(adv, reps=3)
        copies = sum(v for name, v in by_kernel.items()
                     if "cat" in name.lower() or "copy" in name.lower()
                     or "memcpy" in name.lower())
        say(f"sharded512 {k}: steps/s {1e3 / min(ms)!r} (ms/step in 3 turns {ms!r}), device "
            f"{sum(by_kernel.values())!r} ms/step, of it copies and cat {copies!r} ms [{card}]")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        say(f"# sharded512 {k}, device ms a step by kernel: "
            + "; ".join(f"{name} {t!r}" for name, t in top))
        if k != "unsharded Engine":
            parts = profile_parts(adv, reps=3)
            say(f"sharded512 {k}, device ms a step by part: "
                + "; ".join(f"{name} {t!r}" for name, t in sorted(parts.items(),
                                                                  key=lambda kv: -kv[1]))
                + f" [{card}]")
    del rstates, rsteps

    # 13d. The CLI's bench on 8 shards with the rdma backend, as a subprocess.
    torch.cuda.empty_cache()
    cli = subprocess.run(
        [sys.executable, "-m", "fluidsim_tpu_torch.cli", "bench", "--preset", "sharded512",
         "--mesh", "8", "--halo", "explicit", "--halo-block-iters", "4", "--halo-backend",
         "rdma", "--steps", "4"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    if cli.returncode != 0:
        fail(f"the CLI's bench --mesh 8 --halo-backend rdma failed: {cli.stderr[-2000:]}")
    bench_line = json.loads(cli.stdout.strip().splitlines()[-1])
    say(f"cli bench --preset sharded512 --mesh 8 --halo explicit --halo-block-iters 4 "
        f"--halo-backend rdma: {json.dumps(bench_line)} [{card}]")
    if bench_line.get("mesh") != 8 or bench_line.get("halo_backend") != "rdma" \
            or bench_line.get("devices") != min(8, torch.cuda.device_count()) \
            or not bench_line.get("steps_per_sec", 0) > 0:
        fail(f"the CLI's rdma bench line is not the 8-shard run's: {bench_line}")
    del hvel, hdens, hdiv, hzero, hx0, hstart, bstart

    entries += [
        (f"K12 T{t}", f"K12 jacobi_ext_rdma (T={t} sweeps and the push of 2T edge planes, one "
                      f"shard's ({k12_planes[t]}, {hn}, {hn}) slab a launch, b=0; sharded512 "
                      f"on 8 shards, halo_backend=rdma, halo_block_iters={t})",
         "fluidsim_tpu_torch/csrc/jacobi_ext.cu", "fluidsim_tpu/pallas/halo_kernel.py:498",
         rdma_launches[t]["K12"], ext_err[f"K12 T={t}"],
         # K10's bytes: the next extended slab is lz planes of the shard's own
         # and 2T pushed into the neighbours', so the pushes are inside them.
         bound(3 * (hlz + 2 * t) * hplane * f32, t * (hlz + 2 * t) * hcells * JACOBI_OPS))
        for t in (4, 2)]
    # sharded512 launches K13 three times a shard and a step, once for each of
    # these; bytes: every local plane read (the 2h edge planes twice), every
    # output plane written.
    k13_channels = {"K13 prime": (2, 4), "K13 self": (3, hh), "K13 density": (4, hh)}
    k13_what = {"K13 prime": "the solve's priming: x and x0",
                "K13 self": "self-advection: the velocity",
                "K13 density": "the density call: the density and the velocity"}
    entries += [
        (key, f"K13 halo_exchange_rdma ({k13_what[key]}, depth {h}, one shard's share a "
              f"launch; sharded512 on 8 shards, halo_backend=rdma; launches: all three calls)",
         "fluidsim_tpu_torch/csrc/halo_exchange.cu", "fluidsim_tpu/pallas/halo_kernel.py:774",
         rdma_launches[4]["K13"], max(ext_err["K13 8 shards"], ext_err["K13 4 shards"]),
         bound(c * (2 * hlz + 2 * h) * hplane * f32, 0))
        for key, (c, h) in k13_channels.items()]
    entries += [
        ("K11 bf16 F=3", f"K11 advect_ext_kernel on bfloat16 (F=3 self-advection, K=1, "
                         f"n_sub={h_sub}, one shard's (3, {hlz + 2 * hh}, {hn}, {hn}) slab; "
                         f"sharded512 bf16 on 8 shards, halo_backend=rdma)",
         "fluidsim_tpu_torch/csrc/advect_ext.cu", "fluidsim_tpu/pallas/halo_kernel.py:226",
         bf16_launches["rdma"]["K11"], max(ext_err["K11 bf16 F=3"], ext_err["K11 bf16 128"]),
         bound(6 * (hlz + 2 * hh) * hplane * 2,
               h_sub * (hlz + 2 * hh) * hcells * (FRAC_OPS + RELU_OPS + 3 * COMB_OPS))),
        ("K11 bf16 F=1", f"K11 advect_ext_kernel on bfloat16 (F=1 density, K=1, n_sub={h_sub}, "
                         f"one shard's ({hlz + 2 * hh}, {hn}, {hn}) slab; sharded512 bf16 on 8 "
                         f"shards, halo_backend=rdma)",
         "fluidsim_tpu_torch/csrc/advect_ext.cu", "fluidsim_tpu/pallas/halo_kernel.py:226",
         bf16_launches["rdma"]["K11"], ext_err["K11 bf16 F=1"],
         bound(5 * (hlz + 2 * hh) * hplane * 2,
               h_sub * (hlz + 2 * hh) * hcells * (FRAC_OPS + RELU_OPS + COMB_OPS))),
    ]

    # -- 13e. the mesh's streams and cards ------------------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 13e")
    phase_streams(card, dev, counters_to_zero, counts)

    # -- 14. K1's body at K >= 4 and the host entry points ----------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 14")
    phase_wide(card, dev, counters_to_zero, counts, entries, times)
    phase_entry_points(card, counters_to_zero, counts)

    # -- 15. the tiled solve of K2 and K3 ----------------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 15")
    phase_tiled_solve(card, dev, counters_to_zero, counts)

    # -- 16. K1 and K11 at K = 1 on tiles -----------------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 16")
    phase_advect_tiles(card, dev, counters_to_zero, library)

    # -- 17. the Jacobi round of K6, K10 and K12 ----------------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 17")
    phase_jacobi_round(card, dev, counters_to_zero, counts)

    # -- 18. K8 and K14 on the tiled solve, K9 on strips --------------------------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 18")
    # In a process of its own: late in this one torch.profiler records no
    # device events.
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase-18"],
                           cwd=ROOT, timeout=900)
    if child.returncode != 0:
        fail(f"phase 18 failed (exit code {child.returncode})")

    # -- 19. K1, K2's density phase and K11 at K >= 2 on windowed tiles ----------
    say(f"# {time.perf_counter() - t_start:.1f} s into the run: phase 19")
    phase_window_tiles(card, dev, counters_to_zero, counts, library, gcfg)

    report = []
    for key, name, source, replaces, launches, err, (bound_ms, bound_by) in entries:
        ms, plain_ms = times[key]
        say(f"{name}: {ms!r} ms, bound {bound_ms!r} ms ({bound_by}) [{card}]")
        # K7's divergence is one PyTorch call (a convolution), K13 torch.cat.
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": library.get(key)})
    say(f"# chip_smoke.py wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


WIDE_STEPS = {4: 4, 5: 2}
WIDE_HALO_STEPS = 2
# Cycles that hold a shard's stream back before each of its ops (~1 ms on an
# H100's clock).
HOLD_CYCLES = 2_000_000
SHARD_ENTRIES = {"K10": "fs_jacobi_ext", "K11": "fs_advect_ext", "K12": "fs_jacobi_ext_rdma",
                 "K13": "fs_halo_exchange", "K7e div": "fs_divergence_ext",
                 "K7e grad": "fs_gradient_ext"}


def phase_streams(card, dev, counters_to_zero, counts):
    """Phase 13e: the mesh's streams and cards (``parallel/streams.
    ShardOrder``).  The kernel library's runtime sees the device PyTorch
    makes current on every card (``fs_current_device``).  sharded512 at 512³
    on 8 shards of the card, each on its own stream: one step from a seeded
    state on both backends at T = 4, bitwise the unsharded ``Engine`` step,
    and again with shard 3 held back by a sleep of ``HOLD_CYCLES`` before
    each of its ops; one step a backend with every launch of K10–K13 and
    K7e counted by the stream it was given (each shard's share on its own
    stream, none elsewhere).  Where more than one card is visible, the
    8-shard mesh over 2 and 4 cards (``cli.mesh_devices``) two steps bitwise
    the one-card mesh, steps/s beside each card's name and power limit."""
    import collections
    import contextlib

    import numpy as np
    import torch

    from fluidsim_tpu_torch.cli import mesh_devices
    from fluidsim_tpu_torch.config import preset_sharded_512
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn, unshard_state
    from fluidsim_tpu_torch.parallel.streams import ShardOrder
    from fluidsim_tpu_torch.state import zeros_state

    t_phase = time.perf_counter()
    say("# phase 13e: the mesh's streams: 8 shards on 8 streams of the card, a shard held "
        "back, launches by stream, the cards")
    lib = _build.load_library()
    n_cards = torch.cuda.device_count()
    for d in range(n_cards):
        with torch.cuda.device(d):
            seen = lib.fs_current_device()
        if seen != d:
            fail(f"the kernel library sees device {seen} where PyTorch made cuda:{d} current")
    say(f"# fs_current_device: the library's runtime sees each of {n_cards} card(s) as PyTorch "
        f"makes it current")

    cfg = preset_sharded_512()
    n = cfg.current_size
    rng = np.random.default_rng(SEED + 13)
    torch.cuda.empty_cache()
    seeded = zeros_state(cfg, dev).replace(density=density_field(n, rng, dev),
                                           velocity=velocity_field(n, rng, dev, 0.5))
    eng = Engine(cfg, device="cuda")
    eng.state = seeded
    eng.step(1)
    ref = {f: getattr(eng.state, f) for f in ("density", "velocity", "pressure")}
    del eng
    mesh = make_mesh(["cuda"] * 8)
    if len({s.cuda_stream for s in mesh.streams}) != 8:
        fail("the 8-shard mesh did not get a stream a shard")

    def step_fn(m, backend):
        return sharded_step_fn(cfg, m, halo="explicit", halo_block_iters=4,
                               halo_backend=backend)

    orig_on = ShardOrder.on

    @contextlib.contextmanager
    def held_on(order, r, count=True):
        with orig_on(order, r, count):
            if count and r == 3 and order.cuda:
                torch.cuda._sleep(HOLD_CYCLES)
            yield

    for backend in ("pallas", "rdma"):
        for held in (False, True):
            ShardOrder.on = held_on if held else orig_on
            try:
                t0 = time.perf_counter()
                got = unshard_state(step_fn(mesh, backend)(shard_state(seeded, mesh)))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                ShardOrder.on = orig_on
            same = all(torch.equal(getattr(got, f), r) for f, r in ref.items())
            what = "shard 3 held back" if held else "no shard held back"
            say(f"# sharded512 8 streams {backend} T=4, {what}: one seeded step bitwise the "
                f"unsharded Engine step: {same} ({ms:.1f} ms with the shard/unshard copies)")
            if not same:
                fail(f"sharded512 on 8 streams ({backend}, {what}) differs from the unsharded "
                     "Engine step")
            del got

    # Every launch of the shards' kernels by the stream it was given.
    by_stream = collections.Counter()
    saved = {name: getattr(lib, name) for name in SHARD_ENTRIES.values()}

    def counted(name):
        fn = saved[name]

        def launch(*args):
            by_stream[(name, args[-1])] += 1
            return fn(*args)
        return launch

    shard_of = {s.cuda_stream: r for r, s in enumerate(mesh.streams)}
    rounds = cfg.jacobi_iters // 4
    for backend in ("pallas", "rdma"):
        by_stream.clear()
        for name in saved:
            setattr(lib, name, counted(name))
        try:
            st = shard_state(seeded, mesh)
            counters_to_zero()
            st = step_fn(mesh, backend)(st)
            torch.cuda.synchronize()
            launches = counts()
        finally:
            for name, fn in saved.items():
                setattr(lib, name, fn)
        per_shard = {"K11": 2, "K7e div": 1, "K7e grad": 1}
        per_shard.update({"K12": rounds, "K13": 3} if backend == "rdma" else {"K10": rounds})
        table = {key: [by_stream[(entry, s.cuda_stream)] for s in mesh.streams]
                 for key, entry in SHARD_ENTRIES.items() if key in per_shard}
        say(f"# sharded512 8 streams {backend} T=4, one step, launches by shard stream "
            f"(shards 0-7): {table}; counters {launches}")
        stray = {k: v for k, v in by_stream.items() if k[1] not in shard_of}
        if stray or any(table[k] != [per_shard[k]] * 8 for k in per_shard):
            fail(f"sharded512 8 streams {backend}: launches not one share a shard stream: "
                 f"{table}, elsewhere {stray}")
        if launches != {k: 8 * per_shard.get(k, 0) for k in launches}:
            fail(f"sharded512 8 streams {backend}: counters {launches}")
        del st

    if n_cards < 2:
        say(f"# multi-card: {n_cards} CUDA device visible, not run")
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        one = {}
        for backend in ("pallas", "rdma"):
            step = step_fn(mesh, backend)
            one[backend] = unshard_state(step(step(shard_state(seeded, mesh))))
        for cards in (c for c in (2, 4) if c <= n_cards):
            over = make_mesh([torch.device("cuda", i) for i in mesh_devices(8, cards)])
            for backend in ("pallas", "rdma"):
                step = step_fn(over, backend)
                st = step(step(shard_state(seeded, over)))
                got = unshard_state(st)
                for f in ("density", "velocity", "pressure"):
                    if not torch.equal(getattr(got, f), getattr(one[backend], f)):
                        fail(f"sharded512 over {cards} cards ({backend}) differs from the "
                             f"one-card mesh in {f}")

                def adv(step=step):
                    nonlocal st
                    st = step(st)
                ms = cuda_ms(adv, reps=5, warmup=1)
                say(f"sharded512 8 shards over {cards} cards {backend} T=4: bitwise the "
                    f"one-card mesh after 2 steps; steps/s {1e3 / ms!r} "
                    f"[{'; '.join(smi[:cards])}]")
                del st, got
        del one
    del seeded, ref
    torch.cuda.empty_cache()
    say(f"# phase 13e: {time.perf_counter() - t_phase:.1f} s")


def phase_wide(card, dev, counters_to_zero, counts, entries, times):
    """Phases 14a-c: K1's body at windows K = 4 and 5 (the runtime-K body of
    csrc/advect.cuh) in every kernel that shares it, against its twin, and
    the Engine and sharded paths that run it (``phase_entry_points`` is
    14d).  Appends the K >= 4 rows to ``entries`` and their times to
    ``times``."""
    import numpy as np
    import torch

    from fluidsim_tpu_torch.config import (
        preset_bench_128,
        preset_plume_64,
        preset_sharded_512,
        preset_vortex_128,
    )
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel, advect_multi_3d_plain
    from fluidsim_tpu_torch.kernels.halo import advect_ext_kernel, advect_ext_plain, ext_halo
    from fluidsim_tpu_torch.kernels.resident import (
        advect_project_3d_resident,
        advect_project_3d_resident_plain,
        full_step_3d,
        full_step_3d_plain,
        full_step_blocks,
        project_advect_density_3d,
        project_advect_density_3d_plain,
    )
    from fluidsim_tpu_torch.models.stable3d import sink_factor
    from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS
    from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn
    from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
    from fluidsim_tpu_torch.scene.sources import emitter_fold_operand, src_field_add
    from fluidsim_tpu_torch.state import zeros_state

    say("# phase 14: K1's body at K = 4, 5 in K1, K2/K2s/K2o, K8, K14 and K11; the paths "
        "that run it; the host entry points")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    f32, bf2 = 4, 2
    bf16 = torch.bfloat16
    err = {}

    def reach(n, dt, cells, n_sub=1):
        """A velocity whose backtrace reaches about ``cells`` cells a substep."""
        return velocity_field(n, rng, dev, cells * n_sub / (2.0 * dt * (n - 2)))

    def held(key, fn, plain):
        """Kernel against twin, bitwise; the twin's time of this one call."""
        got = fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = plain()
        end.record()
        end.synchronize()
        if torch.is_tensor(got):
            got, ref = (got,), (ref,)
        e = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        err[key] = e
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            fail(f"phase 14: {key} disagrees with its twin (max abs diff {e!r})")
        times[key] = (cuda_ms(fn, reps=10, warmup=1), start.elapsed_time(end))
        say(f"{key}: kernel {times[key][0]!r} ms, twin {times[key][1]!r} ms (one call), "
            f"bitwise [{card}]")

    # 14a. Each kernel at K = 4 and 5 against its twin on the presets' shapes.
    pcfg, bcfg, vcfg, hcfg = (preset_plume_64(), preset_bench_128(), preset_vortex_128(),
                              preset_sharded_512())
    pn, bn, vn, hn = (c.current_size for c in (pcfg, bcfg, vcfg, hcfg))
    pdt, bdt, vdt, hdt = (c.effective_params()[0] for c in (pcfg, bcfg, vcfg, hcfg))
    bdamp, bddamp = sink_factor(bdt, bcfg.velocity_damping), sink_factor(bdt,
                                                                        bcfg.density_dissipation)
    vdamp, vddamp = sink_factor(vdt, vcfg.velocity_damping), sink_factor(vdt,
                                                                        vcfg.density_dissipation)
    v_sub, h_sub = vcfg.advect_substeps, hcfg.advect_substeps
    vmask = torch.as_tensor(build_obstacle_mask(vcfg), device=dev)
    src = emitter_fold_operand(bcfg, torch.zeros((), device=dev))
    b_iters, v_iters, h_iters = bcfg.jacobi_iters, vcfg.jacobi_iters, hcfg.jacobi_iters
    hmesh = make_mesh(["cuda"] * 8)
    hlz = hn // 8
    for k in (4, 5):
        pvel, pdens = reach(pn, pdt, k + 2), density_field(pn, rng, dev)
        bvel, bdens = reach(bn, bdt, k + 2), density_field(bn, rng, dev)
        vvel, vdens = reach(vn, vdt, k + 1, v_sub), density_field(vn, rng, dev)
        buoy = (bdens, bcfg.buoyancy, bcfg.ambient_density, bcfg.gravity)
        held(f"K1w{k}", lambda: advect_multi_3d_kernel((1, 2, 3), pvel, pvel, pdt, window=k),
             lambda: advect_multi_3d_plain((1, 2, 3), pvel, pvel, pdt, window=k))
        held(f"K1w{k} density",
             lambda: advect_multi_3d_kernel((0,), pdens[None], pvel, pdt, window=k),
             lambda: advect_multi_3d_plain((0,), pdens[None], pvel, pdt, window=k))
        held(f"K1 srcw{k}",
             lambda: advect_multi_3d_kernel((1, 2, 3), bvel, bvel, bdt, buoy=buoy, src=src,
                                            window=k),
             lambda: advect_multi_3d_plain((1, 2, 3), bvel, bvel, bdt, buoy=buoy, src=src,
                                           window=k))
        held(f"K1v w{k}",
             lambda: advect_multi_3d_kernel((1, 2, 3), vvel, vvel, vdt, obst=vmask, window=k,
                                            n_sub=v_sub),
             lambda: advect_multi_3d_plain((1, 2, 3), vvel, vvel, vdt, obst=vmask, window=k,
                                           n_sub=v_sub))
        held(f"K1v w{k} density",
             lambda: advect_multi_3d_kernel((0,), vdens[None], vvel, vdt, obst=vmask, window=k,
                                            n_sub=v_sub),
             lambda: advect_multi_3d_plain((0,), vdens[None], vvel, vdt, obst=vmask, window=k,
                                           n_sub=v_sub))
        bvb, bdb = bvel.to(bf16), bdens.to(bf16)
        held(f"K1 bf16 w{k}", lambda: advect_multi_3d_kernel((1, 2, 3), bvb, bvb, bdt, window=k),
             lambda: advect_multi_3d_plain((1, 2, 3), bvb, bvb, bdt, window=k))
        held(f"K1 bf16 w{k} density",
             lambda: advect_multi_3d_kernel((0,), bdb[None], bvb, bdt, window=k),
             lambda: advect_multi_3d_plain((0,), bdb[None], bvb, bdt, window=k))
        kw = dict(solve_dtype=bcfg.solve_dtype, damp=bdamp, dens_damp=bddamp, window=k)
        held(f"K2w{k}", lambda: project_advect_density_3d(bvel, bdens, b_iters, bdt, **kw),
             lambda: project_advect_density_3d_plain(bvel, bdens, b_iters, bdt, **kw))
        held(f"K2sw{k}",
             lambda: project_advect_density_3d(bvel, bdens, b_iters, bdt, src=src, **kw),
             lambda: project_advect_density_3d_plain(bvel, bdens, b_iters, bdt, src=src, **kw))
        held(f"K2 bf16 w{k}", lambda: project_advect_density_3d(bvb, bdb, b_iters, bdt, **kw),
             lambda: project_advect_density_3d_plain(bvb, bdb, b_iters, bdt, **kw))
        vkw = dict(solve_dtype=vcfg.solve_dtype, damp=vdamp, dens_damp=vddamp, window=k,
                   n_sub=v_sub, obst=vmask)
        held(f"K2ow{k}", lambda: project_advect_density_3d(vvel, vdens, v_iters, vdt, **vkw),
             lambda: project_advect_density_3d_plain(vvel, vdens, v_iters, vdt, **vkw))
        held(f"K8w{k}", lambda: full_step_3d(bvel, bdens, b_iters, bdt, **kw),
             lambda: full_step_3d_plain(bvel, bdens, b_iters, bdt, **kw))
        held(f"K8 bf16 w{k}", lambda: full_step_3d(bvb, bdb, b_iters, bdt, **kw),
             lambda: full_step_3d_plain(bvb, bdb, b_iters, bdt, **kw))
        held(f"K14w{k}", lambda: advect_project_3d_resident(bvel, b_iters, bdt, window=k),
             lambda: advect_project_3d_resident_plain(bvel, b_iters, bdt, window=k))
        for dtype, blocks in ((None, full_step_blocks(None, dev, torch.float32, k)),
                              ("bf16", full_step_blocks("bfloat16", dev, bf16, k))):
            say(f"# K8 at K={k} ({dtype or 'float32'} fields and solve): a cooperative grid "
                f"of {blocks} blocks")
            if blocks <= 0:
                fail(f"K8 at K={k} cannot be co-resident")
        del pvel, pdens, bvel, bdens, vvel, vdens, bvb, bdb, buoy
        # K11 on the middle shard's slab of sharded512 (8 shards, two substeps,
        # a halo of 2K planes), float32 and bfloat16.
        h = ext_halo(k, h_sub, False)
        hvel = reach(hn, hdt, k + 1, h_sub)
        hdens = density_field(hn, rng, dev)
        zoff = 3 * hlz - h
        for dtype, tag in ((torch.float32, ""), (bf16, " bf16")):
            ve = hvel.to(dtype).narrow(1, zoff, hlz + 2 * h).contiguous()
            de = hdens.to(dtype)[None].narrow(1, zoff, hlz + 2 * h).contiguous()
            held(f"K11{tag} w{k}",
                 lambda: advect_ext_kernel((1, 2, 3), ve, ve, hn, hdt, zoff, k, h_sub),
                 lambda: advect_ext_plain((1, 2, 3), ve, ve, hn, hdt, zoff, k, h_sub))
            held(f"K11{tag} w{k} density",
                 lambda: advect_ext_kernel((0,), de, ve, hn, hdt, zoff, k, h_sub),
                 lambda: advect_ext_plain((0,), de, ve, hn, hdt, zoff, k, h_sub))
            del ve, de
        del hvel, hdens
        torch.cuda.empty_cache()
    say(f"# phase 14a (kernels at K = 4, 5): {time.perf_counter() - t_phase:.1f} s")

    # 14b. The paths through Engine at K = 4 (4 steps) and 5 (2 steps), the
    # counters at zero just before each: exactly their kernels, finite
    # fields, bitwise the twin path.
    def exact_path(cfg_, steps, ran, what):
        eng = Engine(cfg_, device="cuda")
        counters_to_zero()
        eng.step(steps)
        torch.cuda.synchronize()
        got = counts()
        want = {key: per * steps for key, per in ran.items()}
        say(f"# {what}: {steps} steps at {cfg_.current_size}^3, launches {got}")
        if got != {key: want.get(key, 0) for key in got}:
            fail(f"{what} launched {got}, not {want}")
        check_state(eng.state, steps, cfg_.current_size, what)
        twin = Engine(cfg_, device="cuda", kernels=PLAIN_TWINS)
        twin.step(steps)
        for name in ("density", "velocity", "pressure"):
            if not torch.equal(getattr(eng.state, name), getattr(twin.state, name)):
                e = float((getattr(eng.state, name).float()
                           - getattr(twin.state, name).float()).abs().max())
                fail(f"{what}: kernel path differs from the twin path after {steps} steps in "
                     f"{name} (max abs diff {e!r})")
        say(f"# {what}: kernel path bitwise the twin path after {steps} steps")
        return got

    t_paths = time.perf_counter()
    path_launches = {}
    for k, steps in WIDE_STEPS.items():
        paths = {
            "plume64": (pcfg.replace(advect_window=k), {"K1": 2, "K3": 1}),
            "bench128": (bcfg.replace(advect_window=k), {"K1": 1, "K2": 1}),
            "bench128 fuse_emitter": (bcfg.replace(advect_window=k, fuse_emitter=True),
                                      {"K1": 1, "K2": 1}),
            "bench128 fuse_self_advect": (bcfg.replace(advect_window=k, fuse_self_advect=True),
                                          {"K8": 1}),
            "vortex128 fuse_project_advect": (vcfg.replace(advect_window=k,
                                                           fuse_project_advect=True),
                                              {"K1": 1, "K2": 1}),
            "bench128 bf16": (bcfg.replace(advect_window=k, dtype="bfloat16"),
                              {"K1": 1, "K2": 1}),
            "bench128 bf16 fuse_self_advect": (bcfg.replace(advect_window=k, dtype="bfloat16",
                                                            fuse_self_advect=True), {"K8": 1}),
        }
        for name, (cfg_, ran) in paths.items():
            path_launches[(name, k)] = exact_path(cfg_, steps, ran, f"{name} K={k}")
    say(f"# phase 14b (Engine paths at K = 4, 5): {time.perf_counter() - t_paths:.1f} s")

    # 14c. sharded512 on 8 shards with halo_backend="rdma" at K = 4 and 5 for
    # WIDE_HALO_STEPS steps (float32 and bfloat16): exactly K12, K13 and K11,
    # against the unsharded Engine; at K = 4 the first step bitwise the twin
    # path.
    t_sharded = time.perf_counter()
    sharded_launches = {}
    for k in (4, 5):
        for dtype in ("float32", "bfloat16"):
            kcfg = hcfg.replace(advect_window=k, dtype=dtype)
            what = f"sharded512 8 shards rdma K={k} {dtype}"
            step = sharded_step_fn(kcfg, hmesh, halo="explicit", halo_block_iters=4,
                                   halo_backend="rdma")
            start = shard_state(zeros_state(kcfg, dev), hmesh)
            counters_to_zero()
            st = step(start)
            first = {n_: getattr(as_global(st), n_) for n_ in ("density", "velocity", "pressure")}
            for _ in range(1, WIDE_HALO_STEPS):
                st = step(st)
            torch.cuda.synchronize()
            got = counts()
            sharded_launches[(k, dtype)] = got
            want = {"K12": 8 * (h_iters // 4) * WIDE_HALO_STEPS, "K13": 8 * 3 * WIDE_HALO_STEPS,
                    "K11": 8 * 2 * WIDE_HALO_STEPS, "K7e div": 8 * WIDE_HALO_STEPS,
                    "K7e grad": 8 * WIDE_HALO_STEPS}
            say(f"# {what}: {WIDE_HALO_STEPS} steps, launches {got}")
            if got != {key: want.get(key, 0) for key in got}:
                fail(f"{what} did not run exactly {want}: {got}")
            check_state(st, WIDE_HALO_STEPS, hn, what)
            ueng = Engine(kcfg, device="cuda")
            ueng.state = zeros_state(kcfg, dev)
            ueng.step(WIDE_HALO_STEPS)
            st = as_global(st)
            for name in ("density", "velocity", "pressure"):
                r = getattr(ueng.state, name).float()
                e = float((getattr(st, name).float() - r).abs().max())
                scale = float(r.abs().max())
                bound_ = 1e-5 if dtype == "float32" else 3e-2
                say(f"# {what} vs the unsharded Engine after {WIDE_HALO_STEPS} steps, {name}: "
                    f"max abs diff {e!r} (bitwise {e == 0.0}; bound {bound_} x {scale!r})")
                if e > bound_ * scale:
                    fail(f"{what}: leaves the unsharded Engine's bound in {name}")
            del ueng
            if k == 4 and dtype == "float32":
                tw = as_global(sharded_step_fn(kcfg, hmesh, halo="explicit",
                                               halo_block_iters=4, halo_backend="rdma",
                                               kernels=PLAIN_TWINS)(start))
                for name, got_ in first.items():
                    if not torch.equal(got_, getattr(tw, name)):
                        fail(f"{what}: the kernel path differs from its twin path after one "
                             f"step in {name}")
                say(f"# {what}: kernel path bitwise the twin path after one step")
                del tw
            del st, start, first
            torch.cuda.empty_cache()
    say(f"# phase 14c (sharded512 at K = 4, 5): {time.perf_counter() - t_sharded:.1f} s")

    # K14 lies on no Engine path (the JAX package dispatches it nowhere): its
    # launches at K = 4 and 5 are one direct call each.
    k14_launches = {}
    wvel = reach(bn, bdt, 5)
    for k in (4, 5):
        counters_to_zero()
        advect_project_3d_resident(wvel, b_iters, bdt, window=k)
        torch.cuda.synchronize()
        k14_launches[k] = counts()["K14"]
        if k14_launches[k] != 1:
            fail(f"K14 at K={k} did not launch")
    del wvel

    # The rows: the operations a cell counted as for K1 at K > 1 (win_ops:
    # after the clamp two hats an axis are non-zero, so 8 taps a field), the
    # compulsory bytes in and out.
    def win_ops(n_fields):
        return FRAC_OPS + 3 * 2 * HAT_OPS + 4 + 8 + n_fields * 8 * 2

    def inner(n):
        return (n - 2) ** 3

    pvol, bvol = pn ** 3, bn ** 3
    n_solid = int((vmask[1:-1, 1:-1, 1:-1]).sum())
    vfluid = inner(vn) - n_solid
    ball = int((src_field_add(torch.zeros((bn,) * 3, device=dev), src) > 0).sum())
    k2_core = DIV_OPS + b_iters * SWEEP_OPS + GRAD_OPS
    v2_core = DIV_OPS + v_iters * SWEEP_OPS + GRAD_OPS
    replaces = {"advect.cu": "fluidsim_tpu/pallas/advect.py:256",
                "advect_bf16.cu": "fluidsim_tpu/pallas/advect.py:256",
                "project_advect.cu": "fluidsim_tpu/pallas/resident.py:1155",
                "full_step.cu": "fluidsim_tpu/pallas/resident.py:1531",
                "full_step_bf16.cu": "fluidsim_tpu/pallas/resident.py:1531",
                "advect_ext.cu": "fluidsim_tpu/pallas/halo_kernel.py:226"}
    k1, k2, k8 = ("K1 advect_multi_3d_kernel", "K2 project_advect_density_3d", "K8 full_step_3d")
    k11 = "K11 advect_ext_kernel"
    for k in (4, 5):
        pl = {name: got for (name, kk), got in path_launches.items() if kk == k}
        h = ext_halo(k, h_sub, False)
        hcells = (hlz + 2 * h) * hn * hn
        s32, s16 = sharded_launches[(k, "float32")], sharded_launches[(k, "bfloat16")]
        steps = f"{WIDE_STEPS[k]} steps"
        rows = [
            # plume64 launches K1 twice a step, once for each of these two.
            (f"K1w{k}", k1, f"plume64 self-advection, F=3, n_sub=1, {pn}^3", "advect.cu",
             pl["plume64"]["K1"], bound(6 * pvol * f32, inner(pn) * win_ops(3))),
            (f"K1w{k} density", k1, f"plume64 density, F=1, n_sub=1, {pn}^3", "advect.cu",
             pl["plume64"]["K1"], bound(5 * pvol * f32, inner(pn) * win_ops(1))),
            (f"K1 srcw{k}", k1, f"buoyancy and emitter folded, F=3; bench128 + fuse_emitter",
             "advect.cu", pl["bench128 fuse_emitter"]["K1"],
             bound(7 * bvol * f32 + 5 * f32,
                   inner(bn) * (win_ops(3) + 9 * BUOY_OPS) + ball * EMIT_OPS)),
            (f"K1v w{k}", k1, f"obstacle mask, n_sub={v_sub}, F=3; vortex128 + "
                              f"fuse_project_advect", "advect.cu",
             pl["vortex128 fuse_project_advect"]["K1"],
             bound(6 * vn ** 3 * f32 + vn ** 3,
                   v_sub * (vfluid * win_ops(3) + n_solid * 3 * MIRROR_OPS))),
            (f"K1 bf16 w{k}", k1, "bf16 fields, F=3; bench128 bf16", "advect_bf16.cu",
             pl["bench128 bf16"]["K1"], bound(6 * bvol * bf2, inner(bn) * win_ops(3))),
            (f"K2w{k}", k2, f"K={k} density phase, {b_iters} bf16 sweeps; bench128",
             "project_advect.cu", pl["bench128"]["K2"],
             bound(9 * bvol * f32, inner(bn) * (k2_core + win_ops(1) + 1))),
            (f"K2sw{k}", k2.replace("K2", "K2s"), f"emitter folded, K={k} density phase; "
                                                  f"bench128 + fuse_emitter",
             "project_advect.cu", pl["bench128 fuse_emitter"]["K2"],
             bound(9 * bvol * f32 + 5 * f32,
                   inner(bn) * (k2_core + win_ops(1) + 1) + ball * EMIT_OPS)),
            (f"K2ow{k}", k2.replace("K2", "K2o"), f"vortex128's mask, n_sub={v_sub}, K={k} "
                                                  f"density phase; vortex128 + "
                                                  f"fuse_project_advect", "project_advect.cu",
             pl["vortex128 fuse_project_advect"]["K2"],
             bound(9 * vn ** 3 * f32 + vn ** 3, inner(vn) * v2_core + n_solid * 3 * MIRROR_OPS
                   + v_sub * vfluid * win_ops(1) + inner(vn))),
            (f"K2 bf16 w{k}", k2, f"bf16 fields, K={k} density phase; bench128 bf16",
             "project_advect.cu", pl["bench128 bf16"]["K2"],
             bound(9 * bvol * bf2, inner(bn) * (k2_core + win_ops(1) + 1))),
            (f"K8w{k}", k8, f"K={k} in both advections; bench128 + fuse_self_advect",
             "full_step.cu", pl["bench128 fuse_self_advect"]["K8"],
             bound(9 * bvol * f32, inner(bn) * (win_ops(3) + k2_core + win_ops(1) + 1))),
            (f"K8 bf16 w{k}", k8, f"bf16 fields, K={k}; bench128 bf16 + fuse_self_advect",
             "full_step_bf16.cu", pl["bench128 bf16 fuse_self_advect"]["K8"],
             bound(9 * bvol * bf2, inner(bn) * (win_ops(3) + k2_core + win_ops(1) + 1))),
            (f"K14w{k}", "K14 advect_project_3d_resident",
             f"K={k}, n_sub=1, {b_iters} float32 sweeps, {bn}^3; one direct call",
             "full_step.cu", k14_launches[k],
             bound(7 * bvol * f32, inner(bn) * (win_ops(3) + k2_core))),
            (f"K11 w{k}", k11, f"F=3 self-advection, n_sub={h_sub}, one shard's (3, "
                               f"{hlz + 2 * h}, {hn}, {hn}) slab; sharded512 rdma, 8 shards",
             "advect_ext.cu", s32["K11"], bound(6 * hcells * f32, h_sub * hcells * win_ops(3))),
            (f"K11 w{k} density", k11, f"F=1 density, n_sub={h_sub}, one shard's slab; "
                                       f"sharded512 rdma, 8 shards", "advect_ext.cu",
             s32["K11"], bound(5 * hcells * f32, h_sub * hcells * win_ops(1))),
            (f"K11 bf16 w{k}", k11, f"bf16 slab, F=3, n_sub={h_sub}; sharded512 bf16 rdma, 8 "
                                    f"shards", "advect_ext.cu", s16["K11"],
             bound(6 * hcells * bf2, h_sub * hcells * win_ops(3))),
            (f"K11 bf16 w{k} density", k11, f"bf16 slab, F=1, n_sub={h_sub}; sharded512 bf16 "
                                            f"rdma, 8 shards", "advect_ext.cu", s16["K11"],
             bound(5 * hcells * bf2, h_sub * hcells * win_ops(1))),
        ]
        for key, label, what, source, launches, bnd in rows:
            run_len = (f"{WIDE_HALO_STEPS} steps" if key.startswith("K11")
                       else "a direct call" if key.startswith("K14") else steps)
            body = ("runtime-K body" if key.startswith(("K8", "K14"))
                    else "windowed tiles, advect_window.cuh")
            entries.append((key, f"{label} (window K={k}, {body}; {what}; launches "
                                 f"in {run_len})",
                            f"fluidsim_tpu_torch/csrc/{source}",
                            replaces[source] if not key.startswith("K14")
                            else "fluidsim_tpu/pallas/resident.py:917",
                            launches, err[key], bnd))
    say(f"# phase 14a-c: {time.perf_counter() - t_phase:.1f} s")


def phase_entry_points(card, counters_to_zero, counts):
    """Phase 14d: the entry points as a user runs them: ``cli save-config``,
    the window edited to 4 in its JSON, ``cli run`` with the store and a
    checkpoint, ``Engine.from_checkpoint`` and 20 more steps against a
    continuous run, ``cli render`` (2D with streamlines, 3D), and the live
    viewer in a thread."""
    import shutil
    import sqlite3
    import urllib.request

    import torch

    from fluidsim_tpu_torch.config import preset_scene_a
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.io.checkpoint import load_config
    from fluidsim_tpu_torch.render.live import LiveServer
    from fluidsim_tpu_torch.render.streamlines import native_rasterizer_available

    t_cli = time.perf_counter()
    work = ROOT / "_scratch" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    def cli(*argv):
        res = subprocess.run([sys.executable, "-m", "fluidsim_tpu_torch.cli", *argv],
                             capture_output=True, text=True, timeout=600, cwd=ROOT)
        if res.returncode != 0:
            fail(f"cli {' '.join(argv)} failed: {res.stderr[-2000:]} {res.stdout[-500:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        say(f"cli {' '.join(argv)}: {json.dumps(line)} [{card}]")
        return line

    cfg_path, db, ckpt = work / "plume64.json", work / "runs.db", work / "s20.npz"
    cli("save-config", "--preset", "plume64", "--out", str(cfg_path))
    user = json.loads(cfg_path.read_text())
    user["advect_window"] = 4
    cfg_path.write_text(json.dumps(user, indent=2))
    run = cli("run", "--config", str(cfg_path), "--steps", "20", "--db", str(db),
              "--checkpoint", str(ckpt))
    if run["steps"] != 20 or not run["steps_per_sec"] > 0 or run["run_id"] != 1:
        fail(f"cli run did not run 20 steps as run 1: {run}")
    with sqlite3.connect(str(db)) as conn:
        runs = conn.execute("SELECT RunID, Size, TimeStep FROM SimulationRuns").fetchall()
        rows = conn.execute("SELECT RunID, Step, AverageDensity, MaxVelocityMagnitude, "
                            "FrameRate FROM RuntimeMetrics ORDER BY MetricID").fetchall()
    say(f"# the store after cli run: runs {runs}, metric rows {rows}")
    ucfg = load_config(str(cfg_path))
    every = ucfg.logging_interval
    if len(runs) != 1 or runs[0][1] != ucfg.size or [r[:2] for r in rows] != [
            (1, s) for s in range(every, 21, every)] or not all(
                r[2] > 0 and r[3] > 0 and r[4] >= 0 for r in rows) or not rows[-1][4] > 0:
        fail(f"the store does not hold the run and its metrics: {runs}, {rows}")
    resumed = Engine.from_checkpoint(str(ckpt))
    if resumed.cfg.advect_window != 4 or int(resumed.state.step) != 20:
        fail("Engine.from_checkpoint did not restore the K = 4 run at step 20")
    counters_to_zero()
    resumed.step(20)
    resumed_launches = counts()
    whole = Engine(ucfg)
    whole.step(40)
    for name in ("density", "velocity", "pressure", "step", "time"):
        if not torch.equal(getattr(resumed.state, name), getattr(whole.state, name)):
            fail(f"resume from the checkpoint differs from the continuous run in {name}")
    say(f"# cli run 20 steps + Engine.from_checkpoint + 20 steps: bitwise a continuous 40-step "
        f"run (plume64 K=4; launches after the resume {resumed_launches})")
    del resumed, whole
    r2d = cli("render", "--preset", "scene_a", "--steps", "20", "--render-every", "10",
              "--html", "-o", str(work / "out2d"))
    r3d = cli("render", "--config", str(cfg_path), "--steps", "20", "--render-every", "10",
              "--html", "-o", str(work / "out3d"))
    for res, shape in ((r2d, [192, 192, 4]), (r3d, [64, 64, 3])):
        if res["frames"] != 2 or res["shape"] != shape or not Path(res["html"]).exists():
            fail(f"cli render did not write its frames and player: {res}")
    say(f"# 2D streamlines rasterized by the "
        f"{'native library' if native_rasterizer_available() else 'NumPy fallback'}")
    scfg = preset_scene_a()
    srv = LiveServer(Engine(scfg), port=0, steps_per_frame=1, config_out=str(work / "l.json"))
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/frame.png", timeout=60) as r:
            png = r.read()
        if r.status != 200 or png[:8] != b"\x89PNG\r\n\x1a\n":
            fail("the live viewer served no PNG frame")
        def post(event):
            req = urllib.request.Request(base + "/event", method="POST",
                                         data=json.dumps(event).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                if r.status != 200:
                    fail(f"the live viewer refused {event}")

        post({"type": "pause", "paused": True})
        with srv.lock:
            v0 = float(srv.engine.state.velocity.abs().max())
        post({"type": "drag", "prev": [60, 90], "cur": [80, 95]})
        with srv.lock:
            v1 = float(srv.engine.state.velocity.abs().max())
        say(f"# live viewer (scene_a on the card): a {len(png)}-byte frame; max |v| "
            f"{v0!r} -> {v1!r} after the drag")
        if not v1 > v0:
            fail("the live viewer's drag did not stir the fluid")
    finally:
        srv.stop()
    if srv._sim_thread.is_alive():
        fail("the live viewer's simulation thread did not stop")
    shutil.rmtree(work, ignore_errors=True)
    say(f"# phase 14d (entry points): {time.perf_counter() - t_cli:.1f} s")


def phase_tiled_solve(card, dev, counters_to_zero, counts):
    """Phase 15: the tiled Jacobi solve (csrc/solve_tiled.cuh) in K2, K2s,
    K2o and K3 on the presets' shapes: each bitwise its twin, timed with
    CUDA events beside the per-sweep route on the same inputs (µs a sweep
    from the call at the preset's sweeps and at one), and bench128 through
    ``Engine``: one tiled solve a step, no per-sweep launch, steps/s and
    device ms a step by kernel in turns with the per-sweep route."""
    import numpy as np
    import torch

    from fluidsim_tpu_torch.config import preset_bench_128, preset_plume_64, preset_vortex_128
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.kernels import resident as kres
    from fluidsim_tpu_torch.models.stable3d import sink_factor
    from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
    from fluidsim_tpu_torch.scene.sources import emitter_fold_operand

    t_phase = time.perf_counter()
    say("# phase 15: the tiled Jacobi solve in K2, K2s, K2o and K3")
    rng = np.random.default_rng(SEED + 15)
    bf = torch.bfloat16
    bcfg, vcfg, pcfg = preset_bench_128(), preset_vortex_128(), preset_plume_64()
    bn, pn = bcfg.current_size, pcfg.current_size
    bdt, vdt, pdt = (c.effective_params()[0] for c in (bcfg, vcfg, pcfg))
    bdamp, bddamp = (sink_factor(bdt, k) for k in (bcfg.velocity_damping,
                                                   bcfg.density_dissipation))
    vdamp = sink_factor(vdt, vcfg.velocity_damping) if vcfg.velocity_damping else 1.0
    vddamp = sink_factor(vdt, vcfg.density_dissipation) if vcfg.density_dissipation else 1.0
    bvel, bdens = velocity_field(bn, rng, dev, 4.0), density_field(bn, rng, dev)
    vvel, vdens = velocity_field(bn, rng, dev, 12.0), density_field(bn, rng, dev)
    pvel, pdens = velocity_field(pn, rng, dev, 30.0 / (pn - 2)), density_field(pn, rng, dev)
    vmask = torch.from_numpy(build_obstacle_mask(vcfg)).to(dev)
    src = emitter_fold_operand(bcfg, torch.full((), bdt, device=dev))
    b_it, v_it, p_it = bcfg.jacobi_iters, vcfg.jacobi_iters, pcfg.jacobi_iters
    k2, k2p = kres.project_advect_density_3d, kres.project_advect_density_3d_plain
    k3, k3p = kres.project_3d_resident, kres.project_3d_resident_plain
    bk = dict(solve_dtype=bcfg.solve_dtype, damp=bdamp, dens_damp=bddamp)
    vk = dict(obst=vmask, n_sub=vcfg.advect_substeps, solve_dtype=vcfg.solve_dtype,
              damp=vdamp, dens_damp=vddamp)
    # key: (call with the sweeps, its twin, the preset's sweeps, n, solve bytes)
    cases = {
        "K2 bench128": (lambda it: k2(bvel, bdens, it, bdt, **bk),
                        lambda it: k2p(bvel, bdens, it, bdt, **bk), b_it, bn, 2),
        "K2 bench128 bf16 fields": (lambda it: k2(bvel.to(bf), bdens.to(bf), it, bdt, **bk),
                                    lambda it: k2p(bvel.to(bf), bdens.to(bf), it, bdt, **bk),
                                    b_it, bn, 2),
        "K2 plume64 fused K=3": (lambda it: k2(pvel, pdens, it, pdt, window=3),
                                 lambda it: k2p(pvel, pdens, it, pdt, window=3), p_it, pn, 4),
        "K2s bench128": (lambda it: k2(bvel, bdens, it, bdt, src=src, **bk),
                         lambda it: k2p(bvel, bdens, it, bdt, src=src, **bk), b_it, bn, 2),
        "K2o vortex128": (lambda it: k2(vvel, vdens, it, vdt, **vk),
                          lambda it: k2p(vvel, vdens, it, vdt, **vk), v_it, bn, 2),
        "K3 bench128 unfused": (lambda it: k3(bvel, it, solve_dtype=bcfg.solve_dtype,
                                              damp=bdamp),
                                lambda it: k3p(bvel, it, solve_dtype=bcfg.solve_dtype,
                                               damp=bdamp), b_it, bn, 2),
        "K3 vortex128": (lambda it: k3(vvel, it, obst=vmask, solve_dtype=vcfg.solve_dtype,
                                       damp=vdamp),
                         lambda it: k3p(vvel, it, obst=vmask, solve_dtype=vcfg.solve_dtype,
                                        damp=vdamp), v_it, bn, 2),
        "K3 f32 solve 128^3": (lambda it: k3(bvel, it), lambda it: k3p(bvel, it), b_it, bn, 4),
    }
    gate = kres.solve_tiles

    def per_sweep_route(on):
        kres.solve_tiles = (lambda *args: None) if on else gate

    for key, (fn, plain, it, n, sbytes) in cases.items():
        got, ref = fn(it), plain(it)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if not torch.equal(g, r):
                fail(f"phase 15: {key} through the tiled solve differs from its twin "
                     f"(max abs diff {float((g.float() - r.float()).abs().max())!r})")
        del got, ref
        ms = {}
        for route in ("tiled", "per-sweep", "per-sweep", "tiled"):
            per_sweep_route(route == "per-sweep")
            for sweeps in (it, 1):
                ms.setdefault((route, sweeps), []).append(
                    cuda_ms(lambda: fn(sweeps), reps=20, warmup=3))
        per_sweep_route(False)
        ms = {k: sum(v) / len(v) for k, v in ms.items()}
        us = {route: (ms[(route, it)] - ms[(route, 1)]) / (it - 1) * 1e3
              for route in ("tiled", "per-sweep")}
        bound_us = 3 * n ** 3 * sbytes / HBM_BYTES_PER_S * 1e6
        plain_ms = cuda_ms(lambda: plain(it), reps=1, warmup=1)
        say(f"{key} ({it} sweeps, {n}^3): tiled {ms[('tiled', it)]!r} ms "
            f"({us['tiled']!r} us a sweep), per-sweep route {ms[('per-sweep', it)]!r} ms "
            f"({us['per-sweep']!r} us a sweep), twin {plain_ms!r} ms; a sweep's bound "
            f"{bound_us!r} us (iterate read and written, rhs read, at 3.35 TB/s); bitwise "
            f"the twin [{card}]")

    # bench128 through Engine: one tiled solve a step and no per-sweep launch.
    eng = Engine(bcfg, device="cuda")
    eng.step(10)
    counters_to_zero()
    eng.step(20)
    torch.cuda.synchronize()
    launched = counts()
    say(f"# bench128, 20 steps: launches {launched}, solves {dict(kres.solve_launches)}")
    if launched["K2"] != 20 or kres.solve_launches != {"tiled": 20, "sweep": 0}:
        fail("phase 15: bench128 did not solve in one tiled launch a step")
    by_name = {}
    device = profile_ms(lambda: eng.step(1), reps=20, launches=by_name)
    tiled = sum(v for k, v in by_name.items() if "solve_tiled_kernel" in k)
    sweeps = sum(v for k, v in by_name.items() if "jacobi_sweep_kernel" in k)
    grads = sum(v for k, v in by_name.items() if "gradient_kernel" in k)
    say(f"# profile bench128 (tiled solve): device time {sum(device.values())!r} ms/step; "
        f"solve_tiled_kernel {tiled!r} launches a step, jacobi_sweep_kernel {sweeps!r}, "
        f"gradient_kernel {grads!r} [{card}]")
    for name, t in sorted(device.items(), key=lambda kv: -kv[1])[:8]:
        say(f"#   {t!r} ms/step  {name}  ({by_name[name]!r} launches a step)")
    # The profiler may miss a step's events at the edge of its window: the
    # solve is held to the gradient's count, one of each a step.
    if not (tiled > 0 and tiled == grads and sweeps == 0):
        fail("phase 15: the bench128 step's profile does not show one tiled solve a step")
    steps = {}
    for route in ("tiled", "per-sweep", "per-sweep", "tiled"):
        per_sweep_route(route == "per-sweep")
        steps.setdefault(route, []).append(1e3 / cuda_ms(lambda: eng.step(1), reps=100,
                                                         warmup=10))
    per_sweep_route(True)
    sweep_device = sum(profile_ms(lambda: eng.step(1), reps=20).values())
    per_sweep_route(False)
    say(f"bench128 steps/s: tiled solve {steps['tiled']!r}, per-sweep route "
        f"{steps['per-sweep']!r} (in turns); device ms a step: tiled "
        f"{sum(device.values())!r}, per-sweep {sweep_device!r} [{card}]")
    # 10 + 20 steps, 20 profiled, 4 x (10 + 100) timed, 20 profiled.
    check_state(eng.state, 10 + 20 + 20 + 4 * 110 + 20, bn, "bench128 (phase 15)")
    say(f"# phase 15: {time.perf_counter() - t_phase:.1f} s")


def backtrace_grid(vel, dt: float, n: int, n_sub: int, zoff: int = 0, window: int = 1):
    """The ``(1, nz, n, n, 3)`` sample positions of one substep's backtrace
    (``frac`` of the twins: clamped to [0.5, n - 1.5] and to ``window``
    cells of each axis' coordinate, z global), normalised for
    ``F.grid_sample`` with ``align_corners=True``."""
    import torch

    from fluidsim_tpu_torch.kernels.advect import substep_dt0

    nz = vel.shape[1]
    dt0 = substep_dt0(dt, n, n_sub)
    ar = torch.arange(n, dtype=torch.float32, device=vel.device)
    zs = torch.arange(nz, dtype=torch.float32, device=vel.device) + zoff
    out = []
    for axis, coord in ((0, ar[None, None, :]), (1, ar[None, :, None]), (2, zs[:, None, None])):
        t = (coord - dt0 * vel[axis]).clamp(0.5, n - 1.5)
        t = torch.minimum(torch.maximum(t, coord - window), coord + window)
        if axis == 2:
            t = t - zoff
        out.append(2.0 * t / ((nz if axis == 2 else n) - 1) - 1.0)
    return torch.stack(out, -1)[None]


def phase_advect_tiles(card, dev, counters_to_zero, library):
    """Phase 16: K1 and K11 at K = 1 on tiles (csrc/advect_tiled.cuh): each
    preset's call bitwise its twin, timed with CUDA events beside the twin and
    ``F.grid_sample`` (trilinear, ``align_corners=True``) on the same
    backtrace positions, the interpolation alone (the K1 rows' library time);
    every call takes the tiled route by ``advect_launches``; then bench128,
    vortex128, multi256 and sharded512 (unsharded, and on 8 shards) through
    their entry points, each with exactly its substeps on the tiled route and
    none a cell a thread."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from fluidsim_tpu_torch.config import (
        preset_bench_128,
        preset_multi_emitter_256,
        preset_sharded_512,
        preset_vortex_128,
    )
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.kernels.advect import (
        advect_launches,
        advect_multi_3d_kernel,
        advect_multi_3d_plain,
    )
    from fluidsim_tpu_torch.kernels.halo import advect_ext_kernel, advect_ext_plain
    from fluidsim_tpu_torch.ops.forces import buoyancy_force
    from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn
    from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
    from fluidsim_tpu_torch.scene.sources import emitter_fold_operand
    from fluidsim_tpu_torch.state import zeros_state

    t_phase = time.perf_counter()
    say("# phase 16: K1 and K11 at K = 1 on tiles (csrc/advect_tiled.cuh)")
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 16)
    bf = torch.bfloat16
    bcfg, vcfg = preset_bench_128(), preset_vortex_128()
    mcfg, scfg = preset_multi_emitter_256(), preset_sharded_512()
    bn, mn, sn = bcfg.current_size, mcfg.current_size, scfg.current_size
    bdt, vdt, mdt, sdt = (c.effective_params()[0] for c in (bcfg, vcfg, mcfg, scfg))
    bvel, bdens = velocity_field(bn, rng, dev, 4.0), density_field(bn, rng, dev)
    vvel, vdens = velocity_field(bn, rng, dev, 12.0), density_field(bn, rng, dev)
    vmask = torch.from_numpy(build_obstacle_mask(vcfg)).to(dev)
    bbuoy = (bdens, bcfg.buoyancy, bcfg.ambient_density, bcfg.gravity)
    src = emitter_fold_operand(bcfg, torch.full((), bdt, device=dev))
    v_sub, m_sub, s_sub = vcfg.advect_substeps, mcfg.advect_substeps, scfg.advect_substeps
    k1, k1p, k11, k11p = (advect_multi_3d_kernel, advect_multi_3d_plain, advect_ext_kernel,
                          advect_ext_plain)

    def held(key, fn, plain, n_sub, sample=None, reps=20):
        """Bitwise the twin, on the tiled route, timed beside the twin and
        (``sample``: grid_sample's input and positions) the interpolation."""
        before = dict(advect_launches)
        got = fn()
        launched = {k: advect_launches[k] - before[k] for k in before}
        ref = plain()
        torch.cuda.synchronize()
        if launched != {"tiled": n_sub, "window": 0, "cell": 0}:
            fail(f"phase 16: {key} did not take the tiled route: {launched}")
        if not torch.equal(got, ref):
            fail(f"phase 16: {key} differs from its twin "
                 f"(max abs diff {float((got.float() - ref.float()).abs().max())!r})")
        del got, ref
        ms = cuda_ms(fn, reps=reps)
        plain_ms = cuda_ms(plain, reps=1, warmup=1)
        line = f"{key}: tiled {ms!r} ms, twin {plain_ms!r} ms"
        if sample is not None:
            inp, g = sample
            lib = cuda_ms(lambda: [F.grid_sample(inp, g, mode="bilinear", padding_mode="border",
                                                 align_corners=True) for _ in range(n_sub)],
                          reps=reps)
            library[key] = lib
            line += f", F.grid_sample x{n_sub} (interpolation only) {lib!r} ms"
        say(f"{line}; bitwise the twin [{card}]")

    def sample_input(fields, vel, dt, n, n_sub, zoff=0, buoy=None):
        if buoy is not None:
            vel = buoyancy_force(vel, buoy[0], dt, *buoy[1:])
        return fields[None].contiguous(), backtrace_grid(vel, dt, n, n_sub, zoff)

    # 16a. bench128 (buoyancy; with the emitter on its density), vortex128
    # (three substeps and the mask, float32 and bfloat16), multi256 (two
    # substeps), 512^3 (two substeps, buoyancy for F = 3).
    held("K1", lambda: k1((1, 2, 3), bvel, bvel, bdt, buoy=bbuoy),
         lambda: k1p((1, 2, 3), bvel, bvel, bdt, buoy=bbuoy), 1,
         sample_input(bvel, bvel, bdt, bn, 1, buoy=bbuoy))
    held("K1 src", lambda: k1((1, 2, 3), bvel, bvel, bdt, buoy=bbuoy, src=src),
         lambda: k1p((1, 2, 3), bvel, bvel, bdt, buoy=bbuoy, src=src), 1)
    for tag, dtype in (("", torch.float32), (" bf16", bf)):
        v, d = vvel.to(dtype), vdens.to(dtype)
        held(f"K1v{tag}", lambda: k1((1, 2, 3), v, v, vdt, obst=vmask, n_sub=v_sub),
             lambda: k1p((1, 2, 3), v, v, vdt, obst=vmask, n_sub=v_sub), v_sub,
             sample_input(v, v, vdt, bn, v_sub) if not tag else None)
        held(f"K1v{tag} density", lambda: k1((0,), d[None], v, vdt, obst=vmask, n_sub=v_sub),
             lambda: k1p((0,), d[None], v, vdt, obst=vmask, n_sub=v_sub), v_sub,
             sample_input(d[None], v, vdt, bn, v_sub) if not tag else None)
    del bvel, bdens, vvel, vdens, bbuoy
    mvel, mdens = velocity_field(mn, rng, dev, 8.0), density_field(mn, rng, dev)
    held("K1m", lambda: k1((1, 2, 3), mvel, mvel, mdt, n_sub=m_sub),
         lambda: k1p((1, 2, 3), mvel, mvel, mdt, n_sub=m_sub), m_sub,
         sample_input(mvel, mvel, mdt, mn, m_sub))
    held("K1m density", lambda: k1((0,), mdens[None], mvel, mdt, n_sub=m_sub),
         lambda: k1p((0,), mdens[None], mvel, mdt, n_sub=m_sub), m_sub,
         sample_input(mdens[None], mvel, mdt, mn, m_sub))
    del mvel, mdens
    torch.cuda.empty_cache()
    svel, sdens = velocity_field(sn, rng, dev, 16.0), density_field(sn, rng, dev)
    sbuoy = (sdens, scfg.buoyancy, scfg.ambient_density, scfg.gravity)
    held("K1s", lambda: k1((1, 2, 3), svel, svel, sdt, buoy=sbuoy, n_sub=s_sub),
         lambda: k1p((1, 2, 3), svel, svel, sdt, buoy=sbuoy, n_sub=s_sub), s_sub,
         sample_input(svel, svel, sdt, sn, s_sub, buoy=sbuoy), reps=5)
    torch.cuda.empty_cache()
    held("K1s density", lambda: k1((0,), sdens[None], svel, sdt, n_sub=s_sub),
         lambda: k1p((0,), sdens[None], svel, sdt, n_sub=s_sub), s_sub,
         sample_input(sdens[None], svel, sdt, sn, s_sub), reps=5)
    torch.cuda.empty_cache()

    # 16b. K11: shard 3 of sharded512 on 8 shards, its 64 planes between h of
    # each neighbour's, float32 and bfloat16.
    h, lz = s_sub, sn // 8
    zoff = 3 * lz - h
    ve = svel[:, zoff:zoff + lz + 2 * h].contiguous()
    de = sdens[None, zoff:zoff + lz + 2 * h].contiguous()
    del svel, sdens, sbuoy
    torch.cuda.empty_cache()
    for tag, dtype in (("", torch.float32), (" bf16", bf)):
        v, d = ve.to(dtype), de.to(dtype)
        held(f"K11{tag} F=3", lambda: k11((1, 2, 3), v, v, sn, sdt, zoff, 1, s_sub),
             lambda: k11p((1, 2, 3), v, v, sn, sdt, zoff, 1, s_sub), s_sub,
             sample_input(v, v, sdt, sn, s_sub, zoff) if not tag else None)
        held(f"K11{tag} F=1", lambda: k11((0,), d, v, sn, sdt, zoff, 1, s_sub),
             lambda: k11p((0,), d, v, sn, sdt, zoff, 1, s_sub), s_sub,
             sample_input(d, v, sdt, sn, s_sub, zoff) if not tag else None)
    del ve, de
    torch.cuda.empty_cache()

    # 16c. The presets' paths: every K = 1 substep on tiles, exactly.
    paths = (("bench128", bcfg, 3, 2 * 1), ("vortex128", vcfg, 3, 2 * v_sub),
             ("multi256", mcfg, 2, 2 * m_sub), ("sharded512", scfg, 1, 2 * s_sub))
    for name, cfg, steps, per_step in paths:
        eng = Engine(cfg, device="cuda")
        counters_to_zero()
        eng.step(steps)
        torch.cuda.synchronize()
        say(f"# {name}, {steps} steps: substep launches by route {dict(advect_launches)}")
        if advect_launches != {"tiled": per_step * steps, "window": 0, "cell": 0}:
            fail(f"phase 16: {name} did not take the tiled route for every K = 1 substep")
        check_state(eng.state, steps, cfg.current_size, f"{name} (phase 16)")
        del eng
        torch.cuda.empty_cache()
    step = sharded_step_fn(scfg, make_mesh(["cuda"] * 8), halo="explicit", halo_block_iters=4,
                           halo_backend="rdma")
    start = shard_state(zeros_state(scfg, dev), make_mesh(["cuda"] * 8))
    counters_to_zero()
    st = step(start)
    torch.cuda.synchronize()
    say(f"# sharded512 on 8 shards (rdma), 1 step: substep launches by route "
        f"{dict(advect_launches)}")
    if advect_launches != {"tiled": 8 * 2 * s_sub, "window": 0, "cell": 0}:
        fail("phase 16: sharded512 on 8 shards did not take the tiled route for every K11 "
             "substep")
    check_state(st, 1, sn, "sharded512 on 8 shards (phase 16)")
    del st, start, step
    torch.cuda.empty_cache()
    say(f"# phase 16: {time.perf_counter() - t_phase:.1f} s")


def phase_window_tiles(card, dev, counters_to_zero, counts, library, gcfg):
    """Phase 19: K1, K2's density phase and K11 at windows K >= 2 on tiles
    widened by K (csrc/advect_window.cuh): every K >= 2 call of PERF.md's
    table bitwise its twin on the window route by ``advect_launches``, timed
    with CUDA events beside its twin (one call) and, for K1 and K11, beside
    ``F.grid_sample`` (trilinear, ``align_corners=True``) on the same clamped
    positions, the interpolation alone (the rows' ``library_ms``); NaN and inf
    at zero-weight taps (inside the grid and read wrapped) and a NaN velocity
    bitwise the twin on the full sum; then plume64, the 64³ gate and the
    windowed fused paths, the K = 4 and 5 Engine paths and sharded512 on 8
    shards at K = 4 and 5 through their entry points, the counters at zero
    just before each: every substep on the window route, none tiled or a
    cell a thread."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from fluidsim_tpu_torch.config import (
        preset_bench_128,
        preset_plume_64,
        preset_sharded_512,
        preset_vortex_128,
    )
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.kernels.advect import (
        advect_launches,
        advect_multi_3d_kernel,
        advect_multi_3d_plain,
    )
    from fluidsim_tpu_torch.kernels.halo import advect_ext_kernel, advect_ext_plain, ext_halo
    from fluidsim_tpu_torch.kernels.resident import (
        project_advect_density_3d,
        project_advect_density_3d_plain,
    )
    from fluidsim_tpu_torch.models.stable3d import sink_factor
    from fluidsim_tpu_torch.ops.forces import buoyancy_force
    from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn
    from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
    from fluidsim_tpu_torch.scene.sources import emitter_fold_operand
    from fluidsim_tpu_torch.state import zeros_state

    t_phase = time.perf_counter()
    say("# phase 19: K1, K2's density phase and K11 at K >= 2 on windowed tiles "
        "(csrc/advect_window.cuh)")
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 19)
    bf = torch.bfloat16
    pcfg, bcfg, vcfg, hcfg = (preset_plume_64(), preset_bench_128(), preset_vortex_128(),
                              preset_sharded_512())
    pn, bn, vn, hn = (c.current_size for c in (pcfg, bcfg, vcfg, hcfg))
    pdt, bdt, vdt, hdt, gdt = (c.effective_params()[0] for c in (pcfg, bcfg, vcfg, hcfg, gcfg))
    v_sub, h_sub = vcfg.advect_substeps, hcfg.advect_substeps
    vmask = torch.from_numpy(build_obstacle_mask(vcfg)).to(dev)
    src = emitter_fold_operand(bcfg, torch.full((), bdt, device=dev))
    kb = dict(solve_dtype=bcfg.solve_dtype, damp=sink_factor(bdt, bcfg.velocity_damping),
              dens_damp=sink_factor(bdt, bcfg.density_dissipation))
    kv = dict(solve_dtype=vcfg.solve_dtype, damp=sink_factor(vdt, vcfg.velocity_damping),
              dens_damp=sink_factor(vdt, vcfg.density_dissipation), n_sub=v_sub, obst=vmask)

    def reach(n, dt, cells, n_sub=1):
        """A velocity whose backtrace reaches about ``cells`` cells a substep."""
        return velocity_field(n, rng, dev, cells * n_sub / (2.0 * dt * (n - 2)))

    def same(got, ref):
        """Bitwise, NaN payloads aside: NaN in the same cells."""
        got, ref = (got,) if torch.is_tensor(got) else got, (ref,) if torch.is_tensor(ref) \
            else ref
        for g, r in zip(got, ref):
            if not torch.equal(g.isnan(), r.isnan()):
                return False
            if not torch.equal(torch.where(g.isnan(), 0.0, g), torch.where(r.isnan(), 0.0, r)):
                return False
        return True

    def held(key, fn, plain, n_sub, sample=None, reps=20):
        """Bitwise the twin, on the window route; timed beside the twin (the
        one call) and (``sample``: grid_sample's input, positions and dtype)
        the interpolation."""
        before = dict(advect_launches)
        got = fn()
        launched = {k: advect_launches[k] - before[k] for k in before}
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = plain()
        end.record()
        end.synchronize()
        if launched != {"tiled": 0, "window": n_sub, "cell": 0}:
            fail(f"phase 19: {key} did not take the window route: {launched}")
        if not same(got, ref):
            g, r = (got, ref) if torch.is_tensor(got) else (got[-1], ref[-1])
            fail(f"phase 19: {key} differs from its twin (max abs diff "
                 f"{float((g.float() - r.float()).abs().nan_to_num().max())!r})")
        del got, ref
        ms = cuda_ms(fn, reps=reps, warmup=1)
        line = f"{key}: window tiles {ms!r} ms, twin {start.elapsed_time(end)!r} ms (one call)"
        if sample is not None:
            inp, g = sample
            lib = cuda_ms(lambda: [F.grid_sample(inp, g, mode="bilinear", padding_mode="border",
                                                 align_corners=True) for _ in range(n_sub)],
                          reps=reps, warmup=1)
            library[key] = lib
            line += f", F.grid_sample x{n_sub} (interpolation only) {lib!r} ms"
        say(f"{line}; bitwise the twin [{card}]")

    def sample_input(fields, vel, dt, n, n_sub, k, zoff=0, buoy=None):
        if buoy is not None:
            vel = buoyancy_force(vel, buoy[0], dt, *buoy[1:])
        g = backtrace_grid(vel.float(), dt, n, n_sub, zoff, window=k).to(fields.dtype)
        return fields[None].contiguous(), g

    # 19a. Each K >= 2 row: plume64 (K = 3; 4, 5), the 64³ gate (K = 2),
    # bench128's folds (K = 2; 4, 5), vortex128's mask and three substeps, bf16
    # (4, 5), K2/K2s/K2o's density phase, K11 on sharded512's middle shard.
    pvel, pdens = reach(pn, pdt, 3), density_field(pn, rng, dev)
    for k, (fkey, dkey) in ((3, ("K1w3", "K1w3 density")), (2, ("K1w2", "K1w2 density")),
                            (4, ("K1w4", "K1w4 density")), (5, ("K1w5", "K1w5 density"))):
        dt = gdt if k == 2 else pdt
        held(fkey, lambda: advect_multi_3d_kernel((1, 2, 3), pvel, pvel, dt, window=k),
             lambda: advect_multi_3d_plain((1, 2, 3), pvel, pvel, dt, window=k), 1,
             sample_input(pvel, pvel, dt, pn, 1, k))
        held(dkey, lambda: advect_multi_3d_kernel((0,), pdens[None], pvel, dt, window=k),
             lambda: advect_multi_3d_plain((0,), pdens[None], pvel, dt, window=k), 1,
             sample_input(pdens[None], pvel, dt, pn, 1, k))
    held("K2w3", lambda: project_advect_density_3d(pvel, pdens, pcfg.jacobi_iters, pdt,
                                                   window=3),
         lambda: project_advect_density_3d_plain(pvel, pdens, pcfg.jacobi_iters, pdt,
                                                 window=3), 1)
    held("K2w2", lambda: project_advect_density_3d(pvel, pdens, gcfg.jacobi_iters, gdt,
                                                   window=2),
         lambda: project_advect_density_3d_plain(pvel, pdens, gcfg.jacobi_iters, gdt,
                                                 window=2), 1)
    del pvel, pdens
    for k in (2, 4, 5):
        bvel, bdens = reach(bn, bdt, k + 2), density_field(bn, rng, dev)
        buoy = (bdens, bcfg.buoyancy, bcfg.ambient_density, bcfg.gravity)
        held(f"K1 srcw{k}",
             lambda: advect_multi_3d_kernel((1, 2, 3), bvel, bvel, bdt, buoy=buoy, src=src,
                                            window=k),
             lambda: advect_multi_3d_plain((1, 2, 3), bvel, bvel, bdt, buoy=buoy, src=src,
                                           window=k), 1,
             sample_input(bvel, bvel, bdt, bn, 1, k, buoy=buoy))
        held(f"K2sw{k}", lambda: project_advect_density_3d(bvel, bdens, bcfg.jacobi_iters, bdt,
                                                           src=src, window=k, **kb),
             lambda: project_advect_density_3d_plain(bvel, bdens, bcfg.jacobi_iters, bdt,
                                                     src=src, window=k, **kb), 1)
        if k == 2:
            continue
        held(f"K2w{k}", lambda: project_advect_density_3d(bvel, bdens, bcfg.jacobi_iters, bdt,
                                                          window=k, **kb),
             lambda: project_advect_density_3d_plain(bvel, bdens, bcfg.jacobi_iters, bdt,
                                                     window=k, **kb), 1)
        bvb, bdb = bvel.to(bf), bdens.to(bf)
        held(f"K1 bf16 w{k}", lambda: advect_multi_3d_kernel((1, 2, 3), bvb, bvb, bdt, window=k),
             lambda: advect_multi_3d_plain((1, 2, 3), bvb, bvb, bdt, window=k), 1,
             sample_input(bvb, bvb, bdt, bn, 1, k))
        held(f"K1 bf16 w{k} density",
             lambda: advect_multi_3d_kernel((0,), bdb[None], bvb, bdt, window=k),
             lambda: advect_multi_3d_plain((0,), bdb[None], bvb, bdt, window=k), 1,
             sample_input(bdb[None], bvb, bdt, bn, 1, k))
        held(f"K2 bf16 w{k}", lambda: project_advect_density_3d(bvb, bdb, bcfg.jacobi_iters, bdt,
                                                                window=k, **kb),
             lambda: project_advect_density_3d_plain(bvb, bdb, bcfg.jacobi_iters, bdt,
                                                     window=k, **kb), 1)
        del bvel, bdens, bvb, bdb, buoy
        vvel, vdens = reach(vn, vdt, k + 1, v_sub), density_field(vn, rng, dev)
        held(f"K1v w{k}",
             lambda: advect_multi_3d_kernel((1, 2, 3), vvel, vvel, vdt, obst=vmask, window=k,
                                            n_sub=v_sub),
             lambda: advect_multi_3d_plain((1, 2, 3), vvel, vvel, vdt, obst=vmask, window=k,
                                           n_sub=v_sub), v_sub,
             sample_input(vvel, vvel, vdt, vn, v_sub, k))
        held(f"K2ow{k}", lambda: project_advect_density_3d(vvel, vdens, vcfg.jacobi_iters, vdt,
                                                           window=k, **kv),
             lambda: project_advect_density_3d_plain(vvel, vdens, vcfg.jacobi_iters, vdt,
                                                     window=k, **kv), v_sub)
        del vvel, vdens
        # K11 on the middle shard's slab of sharded512 on 8 shards (two
        # substeps, a halo of 2K planes), float32 and bfloat16.
        h, hlz = ext_halo(k, h_sub, False), hn // 8
        zoff = 3 * hlz - h
        hvel = reach(hn, hdt, k + 1, h_sub).narrow(1, zoff, hlz + 2 * h).contiguous()
        hdens = density_field(hn, rng, dev)[None].narrow(1, zoff, hlz + 2 * h).contiguous()
        torch.cuda.empty_cache()
        for tag, dtype in (("", torch.float32), (" bf16", bf)):
            ve, de = hvel.to(dtype), hdens.to(dtype)
            held(f"K11{tag} w{k}",
                 lambda: advect_ext_kernel((1, 2, 3), ve, ve, hn, hdt, zoff, k, h_sub),
                 lambda: advect_ext_plain((1, 2, 3), ve, ve, hn, hdt, zoff, k, h_sub), h_sub,
                 sample_input(ve, ve, hdt, hn, h_sub, k, zoff), reps=5)
            held(f"K11{tag} w{k} density",
                 lambda: advect_ext_kernel((0,), de, ve, hn, hdt, zoff, k, h_sub),
                 lambda: advect_ext_plain((0,), de, ve, hn, hdt, zoff, k, h_sub), h_sub,
                 sample_input(de, ve, hdt, hn, h_sub, k, zoff), reps=5)
            del ve, de
        del hvel, hdens
        torch.cuda.empty_cache()
    say(f"# phase 19a (each K >= 2 row): {time.perf_counter() - t_phase:.1f} s")

    # 19b. NaN and inf at taps the clamp leaves at zero weight (the far
    # walls, read wrapped past the opposite wall; K planes from a still cell)
    # and a NaN backtrace, at 64³: the full sum, bitwise the twin.
    n = pn
    c = n // 2
    for k in (2, 3, 4, 5):
        vel, dens = reach(n, pdt, k + 1), density_field(n, rng, dev)
        taps = [(c, c - 1, n - 1, float("inf")), (c + 1, n - 1, 2, float("-inf")),
                (n - 1, 3, c, float("nan")), (c + k, c, c, float("nan"))]
        f1, v1 = dens[None].clone(), vel.clone()
        for z, y, x, val in taps:
            f1[:, z, y, x] = val
        v1[:, c, c, c] = 0.0
        v1[0, c - 2, c + 1, c] = float("nan")
        v3 = v1.clone()
        for z, y, x, val in taps:
            v3[:, z, y, x] = val
        for tag, dtype in (("", torch.float32), (" bf16", bf)):
            a1, b1, a3 = f1.to(dtype), v1.to(dtype), v3.to(dtype)
            held(f"K1 non-finite F=3{tag} K={k}",
                 lambda: advect_multi_3d_kernel((1, 2, 3), a3, a3, pdt, window=k, n_sub=2),
                 lambda: advect_multi_3d_plain((1, 2, 3), a3, a3, pdt, window=k, n_sub=2), 2,
                 reps=2)
            held(f"K1 non-finite F=1{tag} K={k}",
                 lambda: advect_multi_3d_kernel((0,), a1, b1, pdt, window=k, n_sub=2),
                 lambda: advect_multi_3d_plain((0,), a1, b1, pdt, window=k, n_sub=2), 2, reps=2)
            e1, ev = a1[:, 2:n - 2].contiguous(), b1[:, 2:n - 2].contiguous()
            held(f"K11 non-finite{tag} K={k}",
                 lambda: advect_ext_kernel((0,), e1, ev, n, pdt, 2, k, 2),
                 lambda: advect_ext_plain((0,), e1, ev, n, pdt, 2, k, 2), 2, reps=2)
        held(f"K2 non-finite K={k}",
             lambda: project_advect_density_3d(vel, f1[0], pcfg.jacobi_iters, pdt, window=k),
             lambda: project_advect_density_3d_plain(vel, f1[0], pcfg.jacobi_iters, pdt,
                                                     window=k), 1, reps=2)
    say(f"# phase 19b (non-finite taps): {time.perf_counter() - t_phase:.1f} s")

    # 19c. The paths through their entry points, the counters at zero just
    # before each: every substep on the window route.
    fused_sub = dict(advection_scheme="substep", advect_substeps=1, fuse_project_advect=True)
    paths = [("plume64", pcfg), ("the 64^3 gate", gcfg),
             ("plume64 fused", pcfg.replace(**fused_sub)),
             ("the 64^3 gate fused", gcfg.replace(**fused_sub)),
             ("bench128 window 2 + fuse_emitter", bcfg.replace(advect_window=2,
                                                                fuse_emitter=True))]
    for k in (4, 5):
        paths += [(f"plume64 K={k}", pcfg.replace(advect_window=k)),
                  (f"bench128 K={k}", bcfg.replace(advect_window=k)),
                  (f"bench128 fuse_emitter K={k}", bcfg.replace(advect_window=k,
                                                                 fuse_emitter=True)),
                  (f"vortex128 fuse_project_advect K={k}",
                   vcfg.replace(advect_window=k, fuse_project_advect=True)),
                  (f"bench128 bf16 K={k}", bcfg.replace(advect_window=k, dtype="bfloat16"))]
    steps = 3
    for name, cfg_ in paths:
        eng = Engine(cfg_, device="cuda")
        counters_to_zero()
        eng.step(steps)
        torch.cuda.synchronize()
        calls = counts()
        say(f"# {name}, {steps} steps: substep launches by route {dict(advect_launches)}, "
            f"launches {calls}")
        if (advect_launches["tiled"] or advect_launches["cell"]
                or advect_launches["window"] < (calls["K1"] + calls["K2"])):
            fail(f"phase 19: {name} did not take the window route for every K >= 2 substep")
        check_state(eng.state, steps, cfg_.current_size, f"{name} (phase 19)")
        del eng
        torch.cuda.empty_cache()
    mesh = make_mesh(["cuda"] * 8)
    for k in (4, 5):
        kcfg = hcfg.replace(advect_window=k)
        step = sharded_step_fn(kcfg, mesh, halo="explicit", halo_block_iters=4,
                               halo_backend="rdma")
        start = shard_state(zeros_state(kcfg, dev), mesh)
        counters_to_zero()
        st = step(start)
        torch.cuda.synchronize()
        say(f"# sharded512 on 8 shards (rdma) K={k}, 1 step: substep launches by route "
            f"{dict(advect_launches)}")
        if advect_launches != {"tiled": 0, "window": 8 * 2 * h_sub, "cell": 0}:
            fail(f"phase 19: sharded512 on 8 shards at K={k} did not take the window route "
                 "for every K11 substep")
        check_state(st, 1, hn, f"sharded512 on 8 shards K={k} (phase 19)")
        del st, start, step
        torch.cuda.empty_cache()
    say(f"# phase 19: {time.perf_counter() - t_phase:.1f} s")


def round_kernels(fn, reps: int = 5):
    """The kernels a call of ``fn()`` launched, by name, from ``reps`` calls
    under ``torch.profiler`` (``profile_ms``; ``"round"``: the Jacobi
    round), rounded: the profiler may miss an event at its window's edge."""
    launches = {}
    profile_ms(fn, reps=reps, launches=launches)
    names = {}
    for name, count in launches.items():
        key = "round" if "jacobi_round_kernel" in name else name
        names[key] = names.get(key, 0.0) + count
    return {k: round(v) for k, v in names.items()}


def phase_jacobi_round(card, dev, counters_to_zero, counts):
    """Phase 17: the Jacobi round (csrc/jacobi_pass.cuh) that K6, K10 and K12
    run: K6 at 256³ and 512³ (20 sweeps), K10 and K12 on sharded512's 8-shard
    slabs at T = 4 and 2 (K10 on the first, a middle and the last shard,
    K12 on all eight; masked once), each bitwise its twin, timed with CUDA
    events beside its bound, its pass launches a call counted from
    ``torch.profiler``'s kernel events (no other kernel may launch); then
    sharded512 on 8 shards (rdma, T = 4) and multi256 through their entry
    points with the counters at zero: exactly their rounds a step."""
    import numpy as np
    import torch

    from fluidsim_tpu_torch.config import preset_multi_emitter_256, preset_sharded_512
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.kernels.halo import (
        NO_WALL,
        jacobi_ext_kernel,
        jacobi_ext_plain,
        jacobi_ext_rdma,
        jacobi_ext_rdma_plain,
        rank_walls,
    )
    from fluidsim_tpu_torch.kernels.jacobi import jacobi_3d_kernel, jacobi_3d_plain, round_passes
    from fluidsim_tpu_torch.ops.boundary import set_bnd_3d
    from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn
    from fluidsim_tpu_torch.state import zeros_state

    t_phase = time.perf_counter()
    say("# phase 17: the Jacobi round of K6, K10 and K12 (csrc/jacobi_pass.cuh)")
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 17)
    f32 = 4
    scfg = preset_sharded_512()
    iters = scfg.jacobi_iters

    def held(key, got, ref):
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if not torch.equal(g, r):
                fail(f"phase 17: {key} differs from its twin "
                     f"(max abs diff {float((g - r).abs().max())!r})")

    # Late in this process torch.profiler has been seen to record no device
    # events on the H100; the launches a round are then held by the card
    # tests (tests/test_torch_cuda.py::test_round_is_one_launch) and the
    # wrappers' counters.
    profiled = bool(round_kernels(lambda: torch.ones(1, device=dev) + 1, reps=1))
    say(f"# torch.profiler records device events in this process: {profiled}")

    def report(key, fn, reps, launches, nbytes, nops, calls=1):
        """Times ``fn`` (``calls`` launches of the kernel a call), checks its
        pass launches against the profile and prints them beside the bound."""
        seen = round_kernels(fn, reps=3) if profiled else None
        if seen is not None and seen != {"round": launches * calls}:
            fail(f"phase 17: {key} launched {seen}, expected {launches * calls} rounds alone")
        ms = cuda_ms(fn, reps=reps) / calls
        bound_ms, by = bound(nbytes, nops)
        say(f"{key}: {ms!r} ms a launch, {launches} pass launch(es) a call "
            f"({'profiled' if seen else 'round_passes'}); bound {bound_ms!r} ms ({by}), "
            f"{100 * bound_ms / ms:.1f}% of bound; bitwise the twin [{card}]")

    # 17a. K6: 20 sweeps at 256^3 (multi256) and 512^3 (sharded512 unsharded),
    # b = 0 from zero as the projection, and b = 3 from a face-consistent start.
    for n in (256, 512):
        x0 = smooth(n, rng, dev)
        for b, x in ((0, torch.zeros_like(x0)), (3, set_bnd_3d(3, smooth(n, rng, dev)))):
            held(f"K6 {n}^3 b={b}", [jacobi_3d_kernel(b, x, x0, 1.0, 6.0, iters)],
                 [jacobi_3d_plain(b, x, x0, 1.0, 6.0, iters)])
            if b == 0:
                report(f"K6 {n}^3, {iters} sweeps", lambda: jacobi_3d_kernel(
                    b, x, x0, 1.0, 6.0, iters), 10 if n == 256 else 5, round_passes(iters),
                    3 * n ** 3 * f32, iters * n ** 3 * JACOBI_OPS)
            del x
        del x0
        torch.cuda.empty_cache()

    # 17b. K10 and K12 on sharded512's slabs: lz = 64 planes a shard between T
    # of each neighbour's, T = 4 (72 planes) and 2 (68).
    sn, shards = scfg.current_size, 8
    lz = sn // shards
    gx, gx0 = smooth(sn, rng, dev), smooth(sn, rng, dev)
    gmask = smooth(sn, rng, dev) > 1.2

    def slabs(v, t):
        pad = torch.zeros_like(v[:t])
        return [torch.cat([pad, v, pad]).narrow(0, r * lz, lz + 2 * t).contiguous()
                for r in range(shards)]

    for t in (4, 2):
        xps, x0s = slabs(gx, t), slabs(gx0, t)
        ms = slabs(gmask, t) if t == 4 else None
        nz = lz + 2 * t
        for r in (0, 3, 7):
            args = (xps[r], x0s[r], 1.0, 6.0, t, *rank_walls(r, shards, t, lz), 0,
                    None if ms is None else ms[r])
            held(f"K10 T={t} shard {r}", [jacobi_ext_kernel(*args)], [jacobi_ext_plain(*args)])
        held(f"K12 T={t}", jacobi_ext_rdma(xps, x0s, 1.0, 6.0, t, 0, ms),
             jacobi_ext_rdma_plain(xps, x0s, 1.0, 6.0, t, 0, ms))
        if ms is not None:  # and unmasked, as the step runs it
            held(f"K12 T={t} no mask", jacobi_ext_rdma(xps, x0s, 1.0, 6.0, t),
                 jacobi_ext_rdma_plain(xps, x0s, 1.0, 6.0, t))
        slab_bytes, slab_ops = 3 * nz * sn * sn * f32, t * nz * sn * sn * JACOBI_OPS
        report(f"K10 T={t} ({nz}, {sn}, {sn})", lambda: jacobi_ext_kernel(
            xps[3], x0s[3], 1.0, 6.0, t, NO_WALL, NO_WALL), 50, round_passes(t), slab_bytes,
            slab_ops)
        report(f"K12 T={t} ({nz}, {sn}, {sn}) a shard", lambda: jacobi_ext_rdma(
            xps, x0s, 1.0, 6.0, t), 10, round_passes(t), slab_bytes, slab_ops, calls=shards)
        del xps, x0s, ms
    del gx, gx0, gmask
    torch.cuda.empty_cache()

    # 17c. The paths: sharded512 on 8 shards (rdma, T = 4) and multi256 and
    # sharded512 unsharded through Engine, the counters at zero just before.
    step = sharded_step_fn(scfg, make_mesh(["cuda"] * shards), halo="explicit",
                           halo_block_iters=4, halo_backend="rdma")
    st = shard_state(zeros_state(scfg, dev), make_mesh(["cuda"] * shards))
    st = step(st)
    counters_to_zero()
    kernels = round_kernels(lambda: step(st), reps=3) if profiled else {}
    if not profiled:
        for _ in range(3):
            step(st)
        torch.cuda.synchronize()
    launched = {k: v / 3 for k, v in counts().items()}
    rounds = shards * (iters // 4)
    say(f"# sharded512 on 8 shards (rdma), 1 step: K12 {launched.get('K12')} launches, "
        f"K13 {launched.get('K13')}, kernels {kernels}")
    # The plane moves are K13's alone: K12 pushes its edges from its last sweep.
    moves = sum(v for k, v in kernels.items() if "exchange_kernel" in k)
    if launched.get("K12") != rounds or (profiled and (
            kernels.get("round") != rounds or moves != launched.get("K13")
            or any("faces_kernel" in k for k in kernels))):
        fail("phase 17: the 8-shard rdma step did not run its rounds as one launch each")
    del st, step
    torch.cuda.empty_cache()
    for cfg, name in ((preset_multi_emitter_256(), "multi256"), (scfg, "sharded512")):
        eng = Engine(cfg, device="cuda")
        eng.step(1)
        counters_to_zero()
        kernels = round_kernels(lambda: eng.step(1), reps=3) if profiled else {}
        if not profiled:
            eng.step(3)
            torch.cuda.synchronize()
        launched = {k: v / 3 for k, v in counts().items()}
        say(f"# {name}, 1 step: K6 {launched['K6']} launch(es), kernels {kernels}")
        if launched["K6"] != 1 or (profiled and (
                kernels.get("round") != round_passes(cfg.jacobi_iters)
                or any("faces_kernel" in k for k in kernels))):
            fail(f"phase 17: {name} did not solve in {round_passes(cfg.jacobi_iters)} rounds")
        check_state(eng.state, 4, cfg.current_size, f"{name} (phase 17)")
        del eng
        torch.cuda.empty_cache()
    say(f"# phase 17: {time.perf_counter() - t_phase:.1f} s")


FUSED_REPS = 20
K9_REPS = 200


def phase_step_and_2d_tiles(card, dev):
    """Phase 18, in a process of its own (``--phase-18``), whose
    torch.profiler records the card's events: K8 and K14 on the tiled solve
    (csrc/full_step.cuh's tiled route) and K9 on strips in the cluster's
    distributed shared memory (csrc/resident2d.cu), each on both of its
    routes, bitwise its twin and its composition, timed in turns with CUDA
    events; the floor of a K9 launch; bench128 with ``fuse_full_step``'s
    options and scene_a through ``Engine`` on both routes in turns."""
    import numpy as np
    import torch

    from fluidsim_tpu_torch.config import (
        preset_bench_128,
        preset_plume_64,
        preset_scene_a,
        preset_scene_b,
    )
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.kernels import resident as kres
    from fluidsim_tpu_torch.kernels import resident2d as k2d
    from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
    from fluidsim_tpu_torch.models.stable3d import sink_factor
    from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask

    t_phase = time.perf_counter()
    _build.load_library()
    say("# phase 18: K8 and K14 on the tiled solve, K9 on strips in distributed shared memory")
    # First: a profile late in a process can lose the card's events.
    phase_k13_union(card)
    rng = np.random.default_rng(SEED + 18)
    bf = torch.bfloat16
    bcfg, pcfg = preset_bench_128(), preset_plume_64()
    bn, pn = bcfg.current_size, pcfg.current_size
    bdt, pdt = bcfg.effective_params()[0], pcfg.effective_params()[0]
    bk = dict(solve_dtype=bcfg.solve_dtype, damp=sink_factor(bdt, bcfg.velocity_damping),
              dens_damp=sink_factor(bdt, bcfg.density_dissipation))
    bvel, bdens = velocity_field(bn, rng, dev, 4.0), density_field(bn, rng, dev)
    pvel, pdens = velocity_field(pn, rng, dev, 30.0 / (pn - 2)), density_field(pn, rng, dev)
    b_it, p_it = bcfg.jacobi_iters, pcfg.jacobi_iters
    k8, k8p = kres.full_step_3d, kres.full_step_3d_plain
    k2 = kres.project_advect_density_3d

    def k1(vel, dt, **kw):
        return advect_multi_3d_kernel((1, 2, 3), vel, vel, dt, **kw)

    bvb, bdb = bvel.to(bf), bdens.to(bf)
    # key: (kernel call, its twin, its composition (each with the sweeps),
    # the preset's sweeps, route counter)
    cases = {
        "K8 bench128": (
            lambda it: k8(bvel, bdens, it, bdt, **bk),
            lambda it: k8p(bvel, bdens, it, bdt, **bk),
            lambda it: k2(k1(bvel, bdt), bdens, it, bdt, **bk), b_it, kres.full_step_launches),
        "K8 bench128 bf16 fields": (
            lambda it: k8(bvb, bdb, it, bdt, **bk),
            lambda it: k8p(bvb, bdb, it, bdt, **bk),
            lambda it: k2(k1(bvb, bdt), bdb, it, bdt, **bk), b_it, kres.full_step_launches),
        "K8 bench128 n_sub=2": (
            lambda it: k8(bvel, bdens, it, bdt, n_sub=2, **bk),
            lambda it: k8p(bvel, bdens, it, bdt, n_sub=2, **bk),
            lambda it: k2(k1(bvel, bdt, n_sub=2), bdens, it, bdt, n_sub=2, **bk), b_it,
            kres.full_step_launches),
        "K8 plume64 K=3": (
            lambda it: k8(pvel, pdens, it, pdt, window=3),
            lambda it: k8p(pvel, pdens, it, pdt, window=3),
            lambda it: k2(k1(pvel, pdt, window=3), pdens, it, pdt, window=3), p_it,
            kres.full_step_launches),
        "K14 128^3": (
            lambda it: kres.advect_project_3d_resident(bvel, it, bdt),
            lambda it: kres.advect_project_3d_resident_plain(bvel, it, bdt),
            lambda it: kres.project_3d_resident(k1(bvel, bdt), it), b_it,
            kres.advect_project_launches),
    }
    gate = kres.solve_tiles

    def on_route(route):
        kres.solve_tiles = gate if route == "tiled" else (lambda *args: None)

    for key, (fn, plain, composed, it, routes) in cases.items():
        ref = plain(it)
        for route in ("tiled", "grid"):
            on_route(route)
            before = dict(routes)
            got, two = fn(it), composed(it)
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in routes.items()}
            if moved != {"tiled": int(route == "tiled"), "grid": int(route == "grid")}:
                fail(f"phase 18: {key} did not launch on the {route} route: {moved}")
            for g, r, c in zip(got, ref, two):
                if not (torch.equal(g, r) and torch.equal(g, c)):
                    fail(f"phase 18: {key} on the {route} route differs from its twin or its "
                         f"composition (max abs diff {float((g.float() - r.float()).abs().max())!r})")
        on_route("tiled")
        del got, ref, two
        ms = {}
        for route in ("tiled", "grid", "grid", "tiled"):
            on_route(route)
            ms.setdefault(route, []).append(cuda_ms(lambda: fn(it), reps=FUSED_REPS, warmup=3))
        on_route("tiled")
        ms["composed"] = [cuda_ms(lambda: composed(it), reps=FUSED_REPS, warmup=3)]
        # Device time (torch.profiler) at the preset's sweeps and at one: the
        # solve's share and the rest (advection, gradient, barriers).
        dev_ms = {(what, sweeps): sum(profile_ms(lambda: call(sweeps), reps=10).values())
                  for what, call in (("kernel", fn), ("composed", composed))
                  for sweeps in (it, 1)}
        comp = "K1 -> K3" if key.startswith("K14") else "K1 -> K2"
        # A profile that lost events reads below the events' time: not a
        # device time.
        short = dev_ms[("kernel", it)] < 0.5 * min(ms["tiled"])
        say(f"{key}: tiled route {ms['tiled']!r} ms, grid-stride route {ms['grid']!r} ms (in "
            f"turns), {comp} on the same inputs {ms['composed']!r} ms; device time, tiled "
            f"route {dev_ms[('kernel', it)]!r} ms at {it} sweeps and {dev_ms[('kernel', 1)]!r} "
            f"at one, {comp} {dev_ms[('composed', it)]!r} and {dev_ms[('composed', 1)]!r}"
            f"{' (not measured: the profile lost events)' if short else ''}; "
            f"bitwise the twin and the composition on both routes [{card}]")

    phase_fused_window(card, dev, on_route, rng)

    # K9: scene_a's viscous diffusion (b = 1, smoothing) and pressure solve
    # (b = 0, fixed rhs) at 192², scene_b's at 128², on both routes.
    route_of = k2d.solve2d_route
    for name, preset in (("scene_a", preset_scene_a), ("scene_b", preset_scene_b)):
        scfg = preset()
        m = scfg.current_size
        mask = torch.from_numpy(build_obstacle_mask(scfg)).to(dev)
        sdt, _, svisc = scfg.effective_params()
        a9 = float(np.float32(sdt) * np.float32(svisc) * np.float32(m - 2) * np.float32(m - 2))
        c9 = float(np.float32(1.0) + np.float32(6.0) * np.float32(a9))
        x9 = (torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32)) * 3.0).to(dev)
        div9 = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32) * 1e-3).to(dev)
        p9 = torch.zeros_like(div9)
        it9 = scfg.jacobi_iters
        blocks = k2d.CLUSTER_BLOCKS
        solves = {
            "smoothing": (lambda b=blocks: k2d.lin_solve_2d_resident(
                1, x9, x9, a9, c9, mask, it9, smooth=True, blocks=b),
                lambda: k2d.lin_solve_2d_resident_plain(1, x9, x9, a9, c9, mask, it9,
                                                        smooth=True)),
            "fixed-rhs": (lambda b=blocks: k2d.lin_solve_2d_resident(
                0, p9, div9, 1.0, 6.0, mask, it9, blocks=b),
                lambda: k2d.lin_solve_2d_resident_plain(0, p9, div9, 1.0, 6.0, mask, it9)),
        }
        if route_of(m, k2d.CLUSTER_BLOCKS, dev) != "strips":
            fail(f"phase 18: {name} at {m}^2 is not on the strips route")
        for mode, (fn, plain) in solves.items():
            ref = plain()
            for route in ("strips", "l2"):
                k2d.solve2d_route = lambda *args, route=route: route
                before = dict(k2d.solve2d_launches)
                got = fn()
                torch.cuda.synchronize()
                if k2d.solve2d_launches[route] != before[route] + 1 or not torch.equal(got, ref):
                    fail(f"phase 18: K9 {mode} at {m}^2 on the {route} route is not its twin")
            ms = {}
            for route in ("strips", "l2", "l2", "strips"):
                k2d.solve2d_route = lambda *args, route=route: route
                ms.setdefault(route, []).append(cuda_ms(fn, reps=K9_REPS, warmup=10))
            k2d.solve2d_route = route_of
            # The portable cluster of 8 beside the step's 16, on the strips route.
            got8 = fn(8)
            torch.cuda.synchronize()
            if not torch.equal(got8, ref):
                fail(f"phase 18: K9 {mode} at {m}^2 on 8 blocks is not its twin")
            ms8 = [cuda_ms(lambda b=b: fn(b), reps=K9_REPS, warmup=10)
                   for b in (8, blocks, blocks, 8)]
            by_kernel = profile_ms(fn, reps=20)
            say(f"K9 {mode} at {m}^2 ({it9} sweeps, {name}'s mask): strips route "
                f"{ms['strips']!r} ms, L2 route {ms['l2']!r} ms (in turns); strips on 8 "
                f"blocks {[ms8[0], ms8[3]]!r} ms beside {blocks} {[ms8[1], ms8[2]]!r} (in "
                f"turns); device time on the strips route {sum(by_kernel.values())!r} ms "
                f"({len(by_kernel)} kernel names in the profile); bitwise the twin on both "
                f"routes and on 8 blocks [{card}]")
    # The floor: a launch of the cluster's barriers alone, as many as a
    # solve's sweeps, and one barrier's cost from a launch of 2000.
    floor = {syncs: cuda_ms(lambda syncs=syncs: k2d.cluster_barriers(syncs), reps=K9_REPS,
                            warmup=10) for syncs in (0, 20, 2000)}
    floor_dev = sum(profile_ms(lambda: k2d.cluster_barriers(20), reps=20).values())
    say(f"K9 floor: a launch of 20 cluster barriers on {k2d.CLUSTER_BLOCKS} blocks of 1024 "
        f"threads {floor[20]!r} ms by CUDA events, device time {floor_dev!r} ms; no barrier "
        f"{floor[0]!r} ms; a barrier {(floor[2000] - floor[0]) / 2000 * 1e3!r} us [{card}]")

    # Through Engine: bench128 with fuse_full_step's options (K8 alone) and
    # scene_a (eight K9 a step), each route in turns.
    fcfg = bcfg.replace(fuse_project_advect=True, fuse_self_advect=True)
    feng = Engine(fcfg, device="cuda")
    aeng = Engine(preset_scene_a(), device="cuda")
    for what, eng, routes, switch, counter, per_step, reps, prof in (
            ("bench128 + fuse_full_step", feng, ("tiled", "grid"), on_route,
             kres.full_step_launches, 1, 100, 10),
            ("scene_a", aeng, ("strips", "l2"),
             lambda r: setattr(k2d, "solve2d_route", route_of if r == "strips"
                               else (lambda *args: "l2")),
             k2d.solve2d_launches, 8, 30, 3)):
        eng.step(5)
        for route in routes:
            switch(route)
            before = dict(counter)
            eng.step(10)
            torch.cuda.synchronize()
            if counter[route] - before[route] != 10 * per_step:
                fail(f"phase 18: {what} did not step on the {route} route: {dict(counter)}")
        steps, device = {}, {}
        for route in (*routes, *routes[::-1]):
            switch(route)
            steps.setdefault(route, []).append(
                1e3 / cuda_ms(lambda: eng.step(1), reps=reps, warmup=reps // 10))
            device.setdefault(route, []).append(
                sum(profile_ms(lambda: eng.step(1), reps=prof).values()))
        switch(routes[0])
        # 5 + 20 steps, then four turns of the timed and the profiled.
        st = eng.state
        if int(st.step) != 5 + 20 + 4 * (reps + reps // 10 + prof) or not all(
                bool(torch.isfinite(getattr(st, name)).all())
                for name in ("density", "velocity", "pressure")):
            fail(f"phase 18: {what} ended at step {int(st.step)} or with non-finite fields")
        say(f"{what} steps/s: " + ", ".join(f"{r} route {steps[r]!r}" for r in routes)
            + " (in turns); device ms a step: "
            + ", ".join(f"{r} {device[r]!r}" for r in routes)
            + (" (the profiler recorded no device events)" if not any(
                sum(v) for v in device.values()) else "") + f" [{card}]")
    say(f"# phase 18: {time.perf_counter() - t_phase:.1f} s")


def phase_k13_union(card):
    """Phase 18, K13's yardstick on 8 streams, where its shares overlap one
    another and summed durations overstate the card's time: the union of a
    call's kernel intervals in a ``torch.profiler`` trace (this process's
    profiler records the card's events) for each of K13's three calls of a
    sharded512 step (8 shards of the card, seeded fields), beside the union
    of the same extended arrays by ``torch.cat`` on the same streams after
    the same waits, and the call's bytes over each."""
    import torch

    from fluidsim_tpu_torch.config import preset_sharded_512
    from fluidsim_tpu_torch.kernels.halo import halo_exchange_rdma
    from fluidsim_tpu_torch.parallel.streams import order_of

    n = preset_sharded_512().current_size
    lz = n // 8
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x, x0, dens = (torch.randn((n, n, n), device="cuda", generator=g) for _ in range(3))
    vel = torch.randn((3, n, n, n), device="cuda", generator=g)
    calls = {"K13 prime": ([[a[None], b[None]] for a, b in zip(torch.chunk(x, 8),
                                                                torch.chunk(x0, 8))], 4),
             "K13 self": ([[v] for v in torch.chunk(vel, 8, 1)], 2),
             "K13 density": ([[d, v] for d, v in zip(torch.chunk(dens[None], 8, 1),
                                                     torch.chunk(vel, 8, 1))], 2)}

    def cat_streams(by_shard, h, zeros):
        order = order_of([a[0] for a in by_shard])
        with order.scope():
            marks = order.marks()
            for r in range(8):
                order.wait(r, marks, r - 1, r + 1)
            for r in range(8):
                with order.on(r):
                    [torch.cat([by_shard[r - 1][j][:, -h:] if r > 0 else zeros[j], a,
                                by_shard[r + 1][j][:, :h] if r < 7 else zeros[j]], 1)
                     for j, a in enumerate(by_shard[r])]

    for key, (by_shard, h) in calls.items():
        zeros = [torch.zeros_like(a[:, :h]) for a in by_shard[0]]
        call_bytes = 8 * sum(a.shape[0] * (2 * lz + 2 * h) * n * n * a.element_size()
                             for a in by_shard[0])
        unions = {name: union_ms(fn, kernel, reps=10, launches=launches)
                  for name, fn, kernel, launches in (
                      ("K13", lambda: halo_exchange_rdma(by_shard, h), "exchange_kernel", 8),
                      ("torch.cat", lambda: cat_streams(by_shard, h, zeros),
                       "CatArrayBatchedCopy", 8 * len(by_shard[0])))}
        say(f"{key} on 8 streams, the union of a call's kernels: " + "; ".join(
            f"{name} not measured (the profile lost events)" if u is None else
            f"{name} {u[0]!r} ms ({call_bytes / (u[0] * 1e-3) / 1e12:.3f} TB/s; summed "
            f"durations {u[1]:.2f}x the union)" for name, u in unions.items())
            + f"; bound {call_bytes / HBM_BYTES_PER_S * 1e3!r} ms [{card}]")
    del x, x0, dens, vel, calls
    torch.cuda.empty_cache()


def phase_fused_window(card, dev, on_route, rng):
    """Phase 18, K8 and K14 at windows K = 2..5 (csrc/full_step.cuh's vote
    and the <= 8-tap sum): at 128³ K8 on float32 and bfloat16 fields with
    either solve dtype and K14, on both routes, bitwise the twin, every cell
    of every substep on the 8 taps (``resident.tap_routes``); at 64³ a NaN
    velocity and an inf density (K8, float32 and bfloat16 fields; K14 the
    NaN) bitwise the twin but for NaN payloads, with the substeps whose
    source held them on the full sum, and the launch after each on finite
    fields all on the 8 taps again; then K8 on bench128's shape (60
    bfloat16 sweeps) and K14 (60 float32 sweeps) timed beside K1 → K2 (K1 →
    K3) on the same inputs, and K8 at K = 1 beside them."""
    import torch

    from fluidsim_tpu_torch.config import preset_bench_128
    from fluidsim_tpu_torch.kernels import resident as kres
    from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
    from fluidsim_tpu_torch.models.stable3d import sink_factor

    bcfg = preset_bench_128()
    n, dt = bcfg.current_size, bcfg.effective_params()[0]
    damp = dict(damp=sink_factor(dt, bcfg.velocity_damping),
                dens_damp=sink_factor(dt, bcfg.density_dissipation))
    bf = torch.bfloat16
    k8, k8p, k14, k14p = (kres.full_step_3d, kres.full_step_3d_plain,
                          kres.advect_project_3d_resident, kres.advect_project_3d_resident_plain)

    def same(got, ref):
        torch.cuda.synchronize()
        return all(torch.equal(g.isnan(), r.isnan()) and torch.equal(
            torch.where(g.isnan(), 0.0, g), torch.where(r.isnan(), 0.0, r))
            for g, r in zip(got, ref))

    def taps(fn):
        torch.cuda.synchronize()
        return kres.tap_routes(fn.votes)

    def fields(size, k, n_sub=1):
        return (velocity_field(size, rng, dev, (k + 1) * n_sub / (2.0 * dt * (size - 2))),
                density_field(size, rng, dev))

    t0 = time.perf_counter()
    held = 0
    for k in (2, 3, 4, 5):
        vel, dens = fields(n, k)
        for route in ("tiled", "grid"):
            on_route(route)
            for dtype in (torch.float32, bf):
                v, d = vel.to(dtype), dens.to(dtype)
                for solve in ("bfloat16", None):
                    kw = dict(window=k, solve_dtype=solve, **damp)
                    got = k8(v, d, 60, dt, **kw)
                    counts = taps(k8)
                    if not same(got, k8p(v, d, 60, dt, **kw)) or counts != {
                            "eight": 2 * n ** 3, "full": 0}:
                        fail(f"phase 18: K8 K={k} {dtype} fields, {solve or 'float32'} solve, "
                             f"{route} route: not its twin or not on the 8 taps ({counts})")
                    held += 1
            got = k14(vel, 60, dt, window=k)
            counts = taps(k14)
            if not same(got, k14p(vel, 60, dt, window=k)) or counts != {"eight": n ** 3,
                                                                       "full": 0}:
                fail(f"phase 18: K14 K={k} {route} route: not its twin or not on the 8 taps "
                     f"({counts})")
            held += 1
        on_route("tiled")
    say(f"# K8 and K14 at K = 2..5 on the 8 taps: {held} launches (f32 and bf16 fields, both "
        f"solve dtypes, both routes) bitwise their twins, every cell of every substep on the "
        f"8 taps ({time.perf_counter() - t0:.1f} s) [{card}]")

    # Non-finite fields at 64³ (two substeps), then the same launch on
    # finite ones: no vote outlives its launch.
    m, n_sub = 64, 2
    c = m // 2
    for k in (2, 3, 4, 5):
        vel, dens = fields(m, k, n_sub)
        for dtype in (torch.float32, bf):
            for where in ("tap", "source"):
                v, d = vel.to(dtype).clone(), dens.to(dtype).clone()
                if where == "tap":
                    d[c, c - 1, c] = float("inf")
                else:
                    v[1, c, c, c] = float("nan")
                kw = dict(window=k, n_sub=n_sub, solve_dtype="bfloat16", **damp)
                got = k8(v, d, 4, dt, **kw)
                counts = taps(k8)
                ref = k8p(v, d, 4, dt, **kw)
                full = 2 * m ** 3 if where == "tap" else 3 * m ** 3
                if not same(got, ref) or counts["full"] < full:
                    fail(f"phase 18: K8 K={k} {dtype} with a non-finite {where}: not its "
                         f"twin, or too few cells on the full sum ({counts})")
                got = k8(vel.to(dtype), dens.to(dtype), 4, dt, **kw)
                if not same(got, k8p(vel.to(dtype), dens.to(dtype), 4, dt, **kw)) or taps(
                        k8) != {"eight": 2 * n_sub * m ** 3, "full": 0}:
                    fail(f"phase 18: K8 K={k} after a non-finite {where}: a vote outlived "
                         f"its launch")
        v = vel.clone()
        v[1, c, c, c] = float("nan")
        got = k14(v, 60, dt, window=k, n_sub=n_sub)
        if not same(got, k14p(v, 60, dt, window=k, n_sub=n_sub)) or taps(k14) != {
                "eight": 0, "full": n_sub * m ** 3}:
            fail(f"phase 18: K14 K={k} with a NaN velocity: not its twin or not on the "
                 f"full sum")
    say(f"# K8 and K14 at K = 2..5 with NaN and inf: bitwise their twins (but NaN "
        f"payloads), the substeps that read them on the full sum [{card}]")

    # Times: K8 on bench128's shape beside K1 -> K2, K14 beside K1 -> K3,
    # and one call of each twin.
    def k1(v, k):
        return advect_multi_3d_kernel((1, 2, 3), v, v, dt, window=k)

    for k in (1, 2, 3, 4, 5):
        vel, dens = fields(n, k)
        row = {}
        for dtype, tag in ((torch.float32, "f32"), (bf, "bf16")):
            v, d = vel.to(dtype), dens.to(dtype)
            kw = dict(window=k, solve_dtype="bfloat16", **damp)
            row[f"K8 {tag}"] = cuda_ms(lambda: k8(v, d, 60, dt, **kw), reps=FUSED_REPS)
            row[f"K1 -> K2 {tag}"] = cuda_ms(lambda: kres.project_advect_density_3d(
                k1(v, k), d, 60, dt, **kw), reps=FUSED_REPS)
            row[f"K8 {tag} twin"] = cuda_ms(lambda: k8p(v, d, 60, dt, **kw), reps=1, warmup=0)
        row["K14"] = cuda_ms(lambda: k14(vel, 60, dt, window=k), reps=FUSED_REPS)
        row["K1 -> K3"] = cuda_ms(lambda: kres.project_3d_resident(k1(vel, k), 60),
                                  reps=FUSED_REPS)
        row["K14 twin"] = cuda_ms(lambda: k14p(vel, 60, dt, window=k), reps=1, warmup=0)
        say(f"K = {k} at 128^3 (60 sweeps), ms by CUDA events: " + ", ".join(
            f"{key} {ms!r}" for key, ms in row.items()) + f" [{card}]")


PARTITIONED_STEPS = 3
PARTITIONED_TIMED = 5


def phase_partitioned(card, dev, counters_to_zero, counts):
    """Phase 20: no whole volume on any shard.  sharded512 at 512³ on 8
    shards of the card from one seeded state, two options that gathered a
    whole volume onto each shard before:

    * MacCormack at ``advect_window=1`` on ``halo="explicit"``, rdma, T = 4
      (``parallel/halo.advect_maccormack_shards``: K11 for the forward and
      the backward advection, the velocity exchanged once by K13, the
      forward field once more), ``PARTITIONED_STEPS`` steps bitwise the
      unsharded ``Engine`` (K1 for both advections, the slab projection);
      exactly 4 K11 launches a shard and a step;
    * the FFT projection on ``halo="auto"`` (``ops/fft_poisson.
      project_3d_fft_shards``: the x and y transforms per shard, z-pencils
      by all-to-all), ``PARTITIONED_STEPS`` steps within 1e-5·max|ref| per
      field of the unsharded ``Engine`` on the same plain ops
      (``kernel_backend="xla"``, as the sharded step runs them): the class
      of two float32 FFT routes (tests/test_torch_options.py), since the
      split transforms round apart from cuFFT's 3D ones by about the
      route's own float32 error (``tools/torch_fft_shards_accuracy.py``);
      the deviation against rtol 1e-5, atol 1e-6·max is printed too; no
      kernel launches.

    Each reference runs first and is freed, but for its fields, before the
    mesh's state is built, so the whole-volume FFT never sits beside the
    mesh.  Both: ``gathered_ops`` empty; steps/s over ``PARTITIONED_TIMED``
    more steps by CUDA events; ``torch.cuda.max_memory_allocated`` over the
    checked steps.  Then the 8-shard MacCormack state goes through
    ``save_checkpoint_sharded`` and back with ``load_checkpoint_sharded`` on
    8 shards, on 4 and unsharded, bitwise."""
    import shutil

    import numpy as np
    import torch

    from fluidsim_tpu_torch.config import preset_sharded_512
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.io.checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )
    from fluidsim_tpu_torch.parallel import (
        gathered_ops,
        make_mesh,
        shard_state,
        sharded_step_fn,
        unshard_state,
    )
    from fluidsim_tpu_torch.state import zeros_state

    t_phase = time.perf_counter()
    say("# phase 20: MacCormack and the FFT projection per shard, the sharded checkpoint "
        "(sharded512 at 512^3, 8 shards of the card)")
    fields = ("density", "velocity", "pressure")
    base = preset_sharded_512()
    n = base.current_size
    steps = PARTITIONED_STEPS
    rng = np.random.default_rng(SEED + 20)
    seeded = zeros_state(base, dev).replace(density=density_field(n, rng, dev),
                                            velocity=velocity_field(n, rng, dev, 0.5))
    mesh = make_mesh(["cuda"] * 8)
    cases = (
        ("maccormack", base.replace(advection_scheme="maccormack", advect_window=1),
         dict(halo="explicit", halo_block_iters=4, halo_backend="rdma"), "auto"),
        ("fft", base.replace(pressure_solver="fft"), dict(halo="auto"), "xla"),
    )
    kept = None
    for name, cfg, kw, ref_backend in cases:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg.replace(kernel_backend=ref_backend), device="cuda")
        eng.state = seeded
        eng.step(steps)
        ref = {f: getattr(eng.state, f).clone() for f in fields}
        torch.cuda.synchronize()
        ref_peak = torch.cuda.max_memory_allocated()
        del eng
        torch.cuda.empty_cache()
        say(f"# {name}: the unsharded Engine ({ref_backend} kernel backend) ran {steps} steps "
            f"before the mesh was built, peak {ref_peak!r} bytes")

        step = sharded_step_fn(cfg, mesh, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st = shard_state(seeded, mesh)
        counters_to_zero()
        for _ in range(steps):
            st = step(st)
        torch.cuda.synchronize()
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        gathered = dict(gathered_ops)
        say(f"# {name} on 8 shards: {steps} steps, launches {launches}, gathered {gathered}")
        if gathered:
            fail(f"phase 20: {name} on 8 shards gathered a whole volume: {gathered}")
        want = ({"K11": 8 * 4 * steps, "K12": 8 * (cfg.jacobi_iters // 4) * steps,
                 "K13": 8 * 5 * steps, "K7e div": 8 * steps, "K7e grad": 8 * steps}
                if name == "maccormack" else {})
        if launches != {k: want.get(k, 0) for k in launches}:
            fail(f"phase 20: {name} on 8 shards did not launch exactly {want}: {launches}")
        check_state(st, steps, n, f"{name} on 8 shards (phase 20)")
        got = unshard_state(st)
        off = []
        for f in fields:
            g, r = getattr(got, f), ref[f]
            scale = float(r.abs().max())
            if name == "maccormack":
                err, ok = float((g - r).abs().max()), torch.equal(g, r)
                say(f"# maccormack on 8 shards vs the unsharded Engine after {steps} steps, "
                    f"{f}: bitwise {ok} (max abs diff {err!r})")
            else:
                # Two float32 FFT routes differ by the transforms' rounding:
                # the FFT class (tests/test_torch_options.py), 1e-5 x max.
                err, ok = worst(g, r, 0.0, 1e-5 * scale)
                _, step_class = worst(g, r, 1e-5, 1e-6 * scale)
                say(f"# fft on 8 shards vs the unsharded Engine after {steps} steps, {f}: max "
                    f"abs diff {err!r}, {err / max(scale, 1e-30)!r} of max |ref| {scale!r} "
                    f"(bound 1e-5 x max: {ok}; within rtol 1e-5, atol 1e-6 x max: "
                    f"{step_class})")
            if not ok:
                off.append(f)
        if off:
            fail(f"phase 20: {name} on 8 shards differs from the unsharded Engine in {off}")
        del got, ref

        def adv():
            nonlocal st
            st = step(st)
        ms = cuda_ms(adv, reps=PARTITIONED_TIMED, warmup=0)
        say(f"sharded512 {name} 8 shards ({', '.join(f'{k}={v}' for k, v in kw.items())}): "
            f"steps/s {1e3 / ms!r}, peak device memory {peak!r} bytes over the checked steps "
            f"(unsharded Engine {ref_peak!r}) [{card}]")
        if name == "maccormack":
            kept = st
        del st, step

    # The sharded checkpoint of the 8-shard MacCormack state.
    work = ROOT / "_scratch" / "chip_smoke_sharded_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    path = str(work / "sharded512")
    t0 = time.perf_counter()
    save_checkpoint_sharded(path, kept, cases[0][1])
    t_save = time.perf_counter() - t0
    files = sorted(p.name for p in Path(path).iterdir())
    if len(files) != 4 * 8 + 3:
        fail(f"phase 20: the sharded checkpoint holds {len(files)} files, not 4 a slab + 3")
    for shards in (8, 4, None):
        t0 = time.perf_counter()
        back, back_cfg = load_checkpoint_sharded(
            path, None if shards is None else make_mesh(["cuda"] * shards), device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        if back_cfg != cases[0][1]:
            fail("phase 20: the sharded checkpoint's config differs")
        if shards == 8:
            same = all(torch.equal(getattr(a, f), getattr(b, f))
                       for a, b in zip(back.slabs, kept.slabs)
                       for f in fields + ("obstacles", "step", "time"))
        else:
            ref = unshard_state(kept)
            glob = back if shards is None else unshard_state(back)
            same = all(torch.equal(getattr(glob, f), getattr(ref, f))
                       for f in fields + ("obstacles", "step", "time"))
            del ref, glob
        say(f"# sharded checkpoint, 8 shards -> {shards or 'unsharded'}: bitwise {same} "
            f"(written in {t_save:.1f} s, {len(files)} files; read in {t_load:.1f} s)")
        if not same:
            fail(f"phase 20: the sharded checkpoint read on {shards} shards is not bitwise")
        del back
    shutil.rmtree(work, ignore_errors=True)
    del kept, seeded
    torch.cuda.empty_cache()
    say(f"# phase 20: {time.perf_counter() - t_phase:.1f} s")


def phase_20_main() -> None:
    """``python3 chip_smoke.py --phase-20``: phase 20 alone, on the card."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs the card")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"
    say(card)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.kernels.halo import (
        advect_ext_kernel,
        halo_exchange_rdma,
        jacobi_ext_rdma,
    )
    from fluidsim_tpu_torch.kernels.project import divergence_ext_kernel, gradient_ext_kernel
    from fluidsim_tpu_torch.parallel import gathered_ops

    t0 = time.perf_counter()
    _build.load_library()
    say(f"# build: {time.perf_counter() - t0:.2f} s")
    counters = {"K11": advect_ext_kernel, "K12": jacobi_ext_rdma, "K13": halo_exchange_rdma,
                "K7e div": divergence_ext_kernel, "K7e grad": gradient_ext_kernel}

    def counters_to_zero():
        for fn in counters.values():
            fn.launches = 0
        gathered_ops.clear()

    phase_partitioned(card, dev, counters_to_zero,
                      lambda: {k: fn.launches for k, fn in counters.items()})


def phase_18_main() -> None:
    """``python3 chip_smoke.py --phase-18``: phase 18 alone, on the card."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs the card")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    phase_step_and_2d_tiles(card, dev)


if __name__ == "__main__":
    if sys.argv[1:] == ["--phase-18"]:
        phase_18_main()
    elif sys.argv[1:] == ["--phase-20"]:
        phase_20_main()
    else:
        main()
