#!/usr/bin/env python3
"""Drive the PyTorch port (ilqr_tpu_torch) on one CUDA GPU and check it.

Run from the root of the repository, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ilqr_tpu_torch/csrc`` with nvcc
(sm_90a), then:

1. prints the GPU's name and power limit, the torch and CUDA versions and
   the kernel build time (with each kernel's registers and spills; the
   chain and look-back kernels must not spill; `python3 chip_smoke.py
   --sass` prints the loops of the DP flagship's rollout kernels, the wide
   implicit rules and a tracking form in SASS: instructions, loads from
   shared, global, constant and local memory); and counts by torch.profiler
   the kernels a call launches: one for B1, B1d, B3, B6, B7, B4, each B5
   entry, B6 and B3 over the batch, and the wide forms (the kernels line's
   launches per call);
2. checks the fused backward pass (B1, one launch) against its plain
   version on the double-pendulum, pendulum and under-actuated
   double-pendulum expansions, at N = 500, at the tile edges (N + 1 = T - 1,
   T, T + 1 for the kernel's T-step tiles) and N = 1, at a horizon that
   crosses several tiles and ends mid-tile, at T + 2 tiles (more tiles
   than one look-back poll round covers; whether a second round runs
   depends on the order the blocks start in, so the case does not prove
   it ran), and at N = 131072 (the N = 500 expansion tiled
   along time), each twice with equal bits required (the fixed-order
   reductions and the look-back's fixed carry order);
3. checks the B = 1 rollout kernels (B2a costs, B2b trajectory and its
   open-loop mode, csrc/chain_rollout.cu) against their plain versions on
   the double pendulum at N = 500 with the 10-α schedule, then in all 15
   instantiations (pendulum, under-actuated and full DP; euler, midpoint,
   rk4, backward_euler, trapezoidal) at N = 1, a ring chunk less and plus
   one and an N that wraps the ring twice and ends mid-chunk, with 1,
   10 and 33 alphas (their plain versions in f32 on the host, in child
   processes), the UA-DP's backward Euler also at newton_iters 1 and 10, and
   at N = 50000 against the plain versions in f64 on the host on a damped
   pendulum (rk4; costs summed in f32 in time order, as the kernels sum);
4. solves the double-pendulum swing-up (N = 500, maxiter 200, tol 1e-6,
   euler) with backward='pallas' and rollout='pallas', with the launch
   counts reset just before and read just after, and gates the result
   (the initial rollout launches open_loop_rollout once); then the
   pendulum golden (backward_euler, N = 400) with rollout='pallas' (every
   B2 kernel, the open loop once); the under-actuated double-pendulum
   golden (backward_euler, N = 800, maxiter 700) through the kernels under
   tests/test_solver.py's gate, warm-started from the reference's
   controls; a solve
   whose U_init is a misaligned row view; and the pendulum MPC example
   (backward-Euler solver, midpoint plant, H = 200, cut to MPC_STEPS
   steps) through the kernels;
5. times B1 (device time per call by CUDA events around calls queued
   behind a spin kernel, the wrapper's host time per call, CUDA events
   over back-to-back calls) at N = 500, 1411 and 131072 and with defects
   at 100000; each kernel and its
   plain version with CUDA events; the initial rollout by kernel and by
   host loop; the double-pendulum solve per iteration with kernels against
   plain engines and B1's share of it; the B2 kernels on the bench's DP
   line-search cell at N = 500 and 100000 (ns per step and fixed µs beside
   the bound); and the implicit instantiations' ns per step on the
   pendulum and UA-DP goldens;
6. checks the affine prefix scan (B3, one launch) against its plain
   version on seeded random chains at N = 1, T - 1, T, T + 1 for its
   T-step tiles, 5T + T/2 + 3 (crosses 5 tile edges, ends mid-tile),
   T (T + 1) + 1 (T + 2 tiles), more tiles than are resident at once (from
   the occupancy the CUDA runtime reports, printed), 500 and 100000, with
   1 and 10 candidates and n = 2 and 4, and on the DP closed-loop
   transition f_x + f_u K along the solved trajectory, each call twice
   with equal bits required;
7. checks the backward pass with multiple-shooting defects (B1d) against
   its plain version on the DP and pendulum expansions with seeded gaps at
   N = 500 (400), 1411 and 131072;
8. solves the DP swing-up through the parallel-in-time path
   (backward='pallas', init_rollout='defect', defect_engine='pallas',
   rollout='defect' and then 'chunked') under phase 4's gates;
9. solves the pendulum golden by multiple shooting (backward='pallas',
   update_engine='pallas'): cost within 1e-3 of 23.435774, defect < 1e-5;
10. runs the DP line search and the open-loop rollout by defect sweeps at
   N = 100000 (the bench's size) with the kernel against the plain scan;
11. runs the multiple-shooting pendulum solve at N = 100000 (rk4, maxiter
   60, tol 1e-5, init_rollout='defect') with the kernels and with the plain
   engines and holds the two to each other;
12. times B3 (device µs, host µs, events, as B1 in phase 5) at the DP
   defect solve's shape (N = 500, 10 candidates) and at N = 100000, B3
   and B1d against their plain versions, and the stages of the
   parallel-in-time solves;
13. checks the batched backward pass (B4) against its plain version on
   double-pendulum expansions along seeded random-control rollouts from
   bench.py's batched initial states, at B = 1024, 1000 and 1 (N = 128),
   with a scalar and a per-instance reg, on pendulum and under-actuated
   double-pendulum expansions at B = 1024, at its chunk edges (N = 1,
   T - 1, T, T + 1 and across five chunk edges) at B = 1001, and on the
   pendulum at an odd N (misaligned instance rows), each call twice with
   equal bits required;
14. prints how B5 splits B = 1024 instances over chain warps and blocks,
   and checks the batched rollouts (B5: line-search costs with 1, 10 and
   33 alphas, trajectories at seeded per-instance alphas, the open loop)
   against their plain versions at B = 1024, 1000 and 1, and in all 15
   model and integrator instantiations (the implicit ones at newton_iters
   1 and 10; 10 alphas) at B = 5 with misaligned instance rows, each call
   twice with equal bits required;
15. runs bench.py's batched-solve cell at full size (B = 1024, N = 128,
   maxiter 10) with rollout='scan' and 'pallas', gates the costs, traces
   and launch counts (B4 and B5's costs and trajectory once per
   iteration, its open loop once per solve), holds four sampled
   instances (cost, X and U) to single-instance solves with the plain
   engines, and times B4 and B5 (device µs, host µs, events) against
   their plain versions at the solved trajectories;
16. runs bench.py's batched-MPC cell (B = 512, H = 64) cut from 50 to
   MPC_SIM steps with rollout='pallas', and to 5 with rollout='auto',
   holds two sampled instances to single-instance run_mpc over every
   step of each run, and times B4 and B5 at the cell's shape;
16b. runs the reference's pendulum MPC (examples/pendulum_mpc.py:
   backward-Euler solver, midpoint plant, H = 200) as a batch of 8
   initial angles for 3 steps through B4 and B5 (the implicit step),
   gates the launch counts, and holds two instances to single-instance
   run_mpc (B2) over every step;
17. runs run_mpc on the double pendulum through B1 and B2 and run_mpc_ms
   on the pendulum through B1d and B3;
18. checks the standalone suffix scan, B6 (layout 'sub') and B7 ('lane'),
   one launch each, against its plain version in all five fields, on the
   Riccati elements of the pendulum and double-pendulum expansions of
   bench.py's limited cell, at each layout's tile edges (M = 1, T - 1, T,
   T + 1), 5T + T/2 + 3, T (T + 1) + 1 and more tiles than are resident,
   and tiled to M = 1411, 32769 and 131073 with and without the terminal
   element, each call twice with equal bits required; and times both at
   M = 301 (the limited pendulum solve's), the DP's 151 (the limited-DDP
   swing-up's), 32769 and the DP's 131073;
19. runs bench.py's limited-backward cell at full size (pendulum rk4,
   N = 32768, U = clip(2.5 sin, +-2)) through backward_pass_limited_parallel
   with the kernel engine and the plain one, prints their sweep counts and
   clamped controls (none: the cell's optimal step stays inside +-2), and
   holds both to the sequential box-QP pass at N = 1024; then the same
   expansion under +-1, where about a quarter of the controls clamp, both
   engines field by field with the same clamped set, and the sequential
   pass with about half its controls clamped (+-0.5) against f64;
20. runs the limited-DDP cell (the same with the dynamics Hessians, at +-2
   and +-1) and the unconstrained DDP parallel pass with both engines;
21. solves through solve(..., backward='pallas'): the torque-limited
   pendulum (N = 300, +-2; then with rollout='defect', B6 and B3), the
   limited-DDP double-pendulum swing-up (N = 150, +-12, adaptive_reg)
   and the DDP pendulum (4 sweeps), each against the cost of its
   sequential solve (the JAX package's f32 result for the two pendulums,
   a golden value for the DP), and the backward pass through B7
   (backward_pass_suffix_scan(layout='lane'));
22. solves the pendulum golden through the compat facade (`compat.iLQR`,
   whose 'auto' engines are host loops: no kernel) and evaluates its 13
   derivative functions on the card;
23. runs the reference drivers of examples_torch/ through their
   main(plot=False): the pendulum and DP open loops under phase 4's gates
   (phase 4 solves the open-loop drivers' problem()s), the UA-DP open loop
   at its smoke depth (ILQR_TPU_SMOKE=1; phase 4 holds its problem to the
   golden), and the FA and UA double-pendulum MPC at
   full horizon cut to DRIVER_STEPS steps, the FA loop's first
   DRIVER_REF_STEPS held to the same loop with backward='scan',
   rollout='scan';
24. solves examples_torch/constrained_pendulum.py at full size (N = 400,
   rk4, |u| <= 3 and the exact goal) by the augmented Lagrangian with
   backward='pallas' (B1, one launch per backward pass), by AL x multiple
   shooting (B1d, B3) and, on the box
   alone, by the barrier solver, each against the JAX package's f32
   results on a CPU; and times B1, B1d and B3 at these
   solves' shapes;
25. runs examples_torch/constrained_mpc.py's AL and barrier loops (H =
   200, backward-Euler solver, midpoint plant, |u| <= 6) cut to MPC_STEPS
   steps with backward='pallas', held to the JAX package's f32
   closed-loop costs, their first MPC_REF_STEPS steps held to
   backward='scan';
26. checks the wide form of the fused backward pass (B1w, a warp a step
   in tiles of 16, group_linalg.cuh) against its
   plain version at (n_x, n_u) = (6, 2), (12, 4), (16, 4) (the quadrotors'
   expansions), (3, 1), (5, 2) (the tracking wrappers') and (16, 6) (a
   seeded expansion): N = 1, the tile edges, across 5 tile edges, T + 2
   tiles, 150 and 8192 (more tiles than are resident), and with defects
   (B1d) at (12, 4), each call twice with equal bits required;
27. checks the suffix scan's wide form (B6w, a warp an element in tiles
   of 16, group_linalg.cuh) at n = 6, 12 and 16 at its tile edges (read
   from the library), beyond the resident tiles, the flight's M = 151, the
   dash's 301 and 8193, with the terminal element and (some M) stage
   elements only, each call twice;
28. checks B2's new device models (cart-pole, quadrotor, 3-D quadrotor,
   its rotor variant, car) under euler, midpoint and rk4 at N = 1, 31,
   33 and 129 with 1, 10 and 33 alphas against the plain rollouts in
   f64 (in child processes), each call twice, along seeded nominals (the
   cart-pole and both quadrotors at dt 0.005, the 3-D ones with noise
   0.003, where a rounding does not grow);
29. runs this slice's path through the kernels: the 3-D quadrotor flight
   (examples_torch/quadrotor3d_flight.py: N = 150, thrust limits,
   adaptive_reg; B6w launches equal the limited pass's sweeps) and its
   MPC (H = 50, rk4 solver, euler plant) cut to WIDE_STEPS steps (B1w,
   B2; the first MPC_REF_STEPS held to scan/scan), the planar quadrotor
   dash (B6w) with TVLQR gains through B1w, the bench's cart-pole MPC
   (H = 200) cut to WIDE_STEPS steps and the car's AL solve, each gated
   on its status and its cost against the JAX package's f32 result;
30. times B1w at N = 8192 and at its paths' shapes, B6w at the flight's
   and the dash's M, B2's 3-D quadrotor (rk4) at N = 50, 150, 500, the
   cart-pole's costs at H = 200 and the car's trajectory at N = 120;
31. checks the wide form of the batched backward pass (B4w, a warp an
   instance, group_linalg.cuh) against its plain version at (n_x, n_u) =
   (6, 2), (8, 2), (12, 4), (16, 4) and (16, 16) (the quadrotors'
   expansions along noisy hover rollouts, seeded ones elsewhere) at B =
   256 and N = 80 with a scalar and a per-instance reg, at B + 1 with N =
   1, 2, the ring's chunk edges (read from the library) and an odd N
   (instance rows at every 4-byte phase), and with a singular Q_uu in two
   instances (ok false there, as the plain version's), each call twice
   with equal bits required; and re-times B4's register form at (2, 1),
   (4, 1), (4, 2);
32. checks B5's batched entries on the cart-pole, the planar and 3-D
   quadrotors, the rotor variant and the car (B5n) under euler, midpoint
   and rk4 at B = 1, 3 and 64 (N = 33, across the ring's chunk edge; 1,
   10 and 33 alphas at B = 3) against the plain batched rollouts, each
   call twice;
33. checks the wide form of the affine scan (B3w, a warp a product or a
   candidate in tiles of 32, group_linalg.cuh) at n = 6, 12, 16 with 1,
   10, 17 and 33 candidates at its tile edges (read from the library),
   across five, past the
   resident tiles and at N = 20000, and at n = 2, 4 past 16 candidates;
34. runs the paths through them: P1, batched solves of the 3-D quadrotor
   (tests/test_quadrotor3d.py's problem, B = 256, N = 80: B4w at (12, 4),
   B5 on model 4 under rk4) and of its rotor variant (B = 16: (16, 4)),
   three instances held to the JAX package's f32 costs and to `solve`
   under 'scan'; P2, batched MPC of the planar quadrotor (B4w at (6, 2))
   and the cart-pole (B4 at (4, 1)), B = 64, H = 100, WB_MPC_STEPS
   steps, two instances each held to `run_mpc`; P3, P1's problem at B = 1
   by the defect line search (B3w at n = 12, 10 candidates, B1w) and by
   multiple shooting (B1w with defects, B3w), held to 'scan' and to the JAX
   package's f32 costs; a float64 batched solve of the planar quadrotor
   under 'auto' (the plain route, no B4 launch); and times B4w, B5n and
   B3w at the paths' shapes;
35. runs the rollout kernels on every system JAX's kernels take: the LTI
   systems at (2, 1) ... (16, 4) under euler, midpoint, rk4 and
   'discrete', the tracking and rate wrappers over the register models and
   the LTI systems, the implicit rules of the cart-pole, the quadrotors and
   the car, and the spring chain (16 masses): 119 instantiations, each at
   N = 1, its ring chunk less and plus one, and WR_N: B2a with 1, 10 and 33
   alphas, B2b and the open loop, and B5's three entries on 3 instances
   (but for the implicit rules), against the plain rollouts in f64 on the
   host (in child processes) under phase 28's rule, every call twice, bit
   for bit; B7w (the suffix scan's 'lane' layout at n = 6, 12, 16) at its
   tile edges, past the resident tiles, M = 151 and 32769; the paths P4
   (examples/reference_tracking_mpc.py's tracking MPC through B1w (3, 1)
   and B2's tracking form, cut to 50 of its 600 steps), P5 (batched
   solves of bench.py's cart-pole with a rate penalty, B = 256, N = 100:
   B4w (5, 1), B5 on the rate form) and P6 (examples/linear_lqr.py's
   double integrator under 'discrete': B1 and B2's LTI form), each against
   the JAX package's f32 results; and times each family at its path's
   shape or alone;
36. runs the solvers beyond iLQR at their drivers' sizes: P7,
   examples_torch/inverse_optimal_control.py (pendulum rk4, N = 60, four
   demonstrations by solve, then the loss and its gradient through
   solve_implicit, cut to P7_OUTER_STEPS outer steps) through B1 and B2,
   solve_implicit's forward pass equal to solve's bit for bit, the
   gradient held to the sequential engines' on the card and to the JAX
   package's f32 gradient, and run_mpc_implicit (H = 20, 3 steps) held to
   the sequential engines'; P8, examples_torch/mppi_pendulum.py's MPPI MPC
   at full size (S = 512, 4 updates, H = 30, 120 steps: B5's open loop
   exactly 480 times) under tests/test_mppi.py's swing-up gate, one update
   on fixed noise through B5 and through the plain rollouts, MPPI as an
   optimizer on tests/test_mppi.py's problem, and the driver's explore
   (S = 1024, N = 80, 60 updates) polished by iLQR to the JAX package's
   limited optimum; P9, examples_torch/parallel_estimation.py's record at
   N = 100000 through run_ekf_parallel and run_eks_parallel (B3 in their
   defect sweeps, X_lin held to the plain scan's), RMS-to-truth within
   1.1x of the JAX package's f32, the sequential EKF and smoother on its
   first P9_SEQ_N steps (each step a replay of one CUDA graph) against
   JAX's, and the UKF's captured steps against its eager loop; and holds
   B1, B2, B5 and B3 to their plain versions at these paths' shapes and
   times them;
37. runs batched solves with limits, DDP and adaptive_reg: (a) B6 over
   the batch (one launch for B sequences) against its plain version in
   both forms, n = 2, 4, 6, 12, at B = 1, 3, 512 and M = 1, each form's
   tile edge and edge + 1, 65, 301 and 4097 (B <= 3), every call twice
   bit for bit, one launch a call, and every instance bit for bit a
   single-instance B6 call; timed at (b)'s and (c)'s shapes beside B
   single launches; (b) the batched-MPC cell's DP (B = 512, H = 64,
   MPC_SIM steps) under box limits at which at least a tenth of the
   first solve's controls clamp, backward='pallas' and adaptive_reg (B6
   over the batch once a sweep), two instances held to single-instance
   run_mpc over the loop's first step; (c) a batched DDP + adaptive_reg pendulum solve (B = 256,
   N = 300, rk4; B5, B6 over the batch, and B4 with a (B,) reg on its
   adaptive_reg-only twin), eight instances held to single-instance
   solves.  `python3 chip_smoke.py --batch-options` runs it alone;
38. runs the batched parallel-in-time line searches: (a) B3 over the
   batch (one launch for B chains) against its plain version in both
   forms, n = 2, 4, 6, 12 with 1, 10 and 17 candidates, at B = 1, 3, 64
   and N = 1, each form's tile edge and edge +- 1 and 5T + T/2 + 3, every
   call twice bit for bit, one launch a call, and every instance bit for
   bit a single-instance B3 call; (b) the DP flagship's problem (phase 8's
   config) as a batch of 16 initial states with rollout='defect' (B4, B3
   over the batch once a sweep, no single-instance B3) and 'chunked',
   instance 0 under phase 4's gates and held to phase 8's single-instance
   solves (in f64 where f32 rounding parts them), instance 11 held to a
   single-instance solve in f64; (c) phase 16b's pendulum
   MPC with rollout='defect' as a batch of 8 for 3 steps, two instances
   held to single-instance run_mpc; examples_torch/long_horizon.py's main
   at a cut horizon (B1, B1d, B3); and times B3 over the batch at (b)'s
   and (c)'s shapes beside B single launches.  `python3 chip_smoke.py
   --batch-parallel` runs it alone;
39. runs learned dynamics (models/neural.py) and the collocation oracle:
   (c) examples_torch/neural_sysid.py at full size in f32 (1000 Adam steps
   on B = 32, N = 60, horizon 10, the loss below a hundredth of its start;
   closed-loop MPC on the true plant, H = 40, 80 steps, maxiter 8, with
   the nominal, learned and true models through B1 and B2 on the neural
   form, under tests/test_neural.py's gates; the learned model's first
   LEARNED_SCAN_STEPS steps again under 'scan'); (b) B5's three entries on
   the fitted model at (512, 30) and (64, 40) against the f64 plain
   rollouts, one mppi_update through B5 (and through the plain rollouts),
   and a batched solve of 64 (B4, B5) held to a single solve; (a) B2's
   three entries on the neural form at the fitted pendulum and a 3-D
   quadrotor with a (64, 64, 64) residual, N = 1, the ring's chunk and
   ring edges +- 1, 40 and 500, against the f64 plain rollouts, every
   call twice, bit for bit, and a zero output layer giving the base
   form's bits; (d) solve_collocation on the card against the card's
   solve (tests/test_cross_validation.py:117-131's pendulum); and times
   the neural form's entries at the paths' shapes.  `python3
   chip_smoke.py --learned` runs it alone.
Phases 13-37 and 39 run in three child processes (`PHASE_GROUPS`) beside
the main process's phases 2-12 and 38, started after phase 1's build; each
group's output is printed when it ends.  Every phase prints its seconds.
Each solve phase resets the launch counts just before it and reads them
just after.  The kernels line gives every kernel's time, its plain
version's, and its bound: the larger of the bytes it must move over the
H100's memory rate and the operations of the sequential recursion over its
f32 rate.

Any failed check raises, and the script exits non-zero.  Without a CUDA
device it exits non-zero before printing any result.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

# The reference's own f32 golden cost of the double-pendulum swing-up
# (tests/golden/double_pendulum_ol.npz), gated at 1.02x as the JAX test does.
DP_GOLDEN_COST = 214.310
# The reference's pendulum swing-up cost (tests/golden/pendulum_ol.npz).
PENDULUM_GOLDEN_COST = 23.435774
# The reference's under-actuated swing-up (tests/golden/
# ua_double_pendulum_ol.npz, read at run time), gated as
# tests/test_solver.py:96-101 gates it: cost <= 1.05x, final angles 0.2.
UA_GOLDEN = Path(__file__).resolve().parent / "tests" / "golden" / \
    "ua_double_pendulum_ol.npz"
# Phase 4's pendulum MPC (examples/pendulum_mpc.py, H = 200, 400 steps in
# the example) and phase 25's constrained MPC loops are cut to MPC_STEPS
# steps (20 until phase 38 came; the first step was held to rollout='scan'
# until the time limit cut it: backward-Euler host loops, 12.5 s on an
# H100).
MPC_STEPS = 10
# Phase 23 runs the FA and UA double-pendulum MPC drivers for DRIVER_STEPS
# steps (cut from MPC_STEPS when phases 31-34 came, from 10 when phases
# 27-35 checked the entry-parallel forms, from 5 when phase 36 came and
# from 3 when phase 38 came, for the time limit).
DRIVER_STEPS = 2
# Phases 25 and 29 hold MPC_REF_STEPS of their MPC loops to scan/scan
# (cut from 3 when phase 35 came, and from 2 with DRIVER_STEPS, for the
# time limit).
MPC_REF_STEPS = 1
# Phase 23 holds the first DRIVER_REF_STEPS of the FA DP MPC driver to its
# scan loop (backward='scan', rollout='scan'; ~10 s a step on an H100),
# cut from 3 when phase 35 came, for the time limit; the UA driver's scan
# loop (28 s a step) was cut for it too.
DRIVER_REF_STEPS = 1
LONG_N = 131072

# B1 tolerance: max|kernel - plain| <= max(RTOL_B1 * max|plain|,
# F32_FLOOR * max|plain - plain in f64|).  Both are f32 parallel suffix
# scans of the same elements, associated differently (the kernel scans
# 256-step blocks and carries a value across them; the plain version
# doubles over the whole horizon).  The double pendulum's Riccati recursion
# (Q_f / R = 1e4) amplifies that rounding to ~1e-4 of the gains; near a
# solution u_ff is itself a small difference of large terms, so there the
# bound is the plain version's own f32 error against its f64 evaluation.
# Largest error seen on the H100 outside that case: 7e-5 of max|plain|.
RTOL_B1 = 5e-4
F32_FLOOR = 4.0
# B2 tolerance: the kernels and the plain rollouts run the same recursion in
# f32 with other operation orders (fused multiply-adds, the K(x - x_old)
# sum); near a solved trajectory the feedback keeps that rounding from
# growing along the horizon.
RTOL_B2 = 1e-4
# B3 tolerance: max|kernel - plain| <= max(RTOL_B3 * max|plain|,
# F32_FLOOR * max|plain - plain in f64|).  The kernel scans 256-step
# blocks and carries a state across them, the plain version doubles over
# the whole horizon: the same f32 products, associated differently.
RTOL_B3 = 1e-5
# Phase 10/11: candidate costs of one line search, and final costs of one
# MS solve, between the kernel and the plain engines (f32 sums over 1e5
# steps in other orders, Newton iterates at their f32 floor).
RTOL_LS = 1e-4
RTOL_MS = 1e-4
BENCH_N = 100_000
# Phase 3 holds B2 to its plain versions in f64 on the host at this N (a
# child process that took 42 s at BENCH_N on the H100 machine's host, the
# phase's longest part; cut from BENCH_N when phase 35 came, and from
# 25000 when phase 36 came, for the time limit; phase 10 runs B2's
# neighbours B3 and the defect sweeps at BENCH_N).
CHAIN_LONG_N = 10_000
# B4 tolerance: max|kernel - plain| <= max(RTOL_B4 * max|plain|,
# F32_FLOOR * max|plain - plain in f64|).  Both run the same sequential
# recursion in f32 with other operation orders (closed-form inverse against
# an LU solve, fused multiply-adds); the double pendulum's recursion
# (Q_f / R = 1e4) amplifies that rounding as much as it amplifies the plain
# version's own error against f64 (up to 2.4e-4 of max|plain| on
# random-control DP expansions, host build of the kernel).
RTOL_B4 = 5e-4
# B5 tolerance: B2's (the same recursion per instance).
RTOL_B5 = RTOL_B2
# Phases 15-16: the sizes of bench.py's batched cells (bench.py:700-723).
BATCH_B, BATCH_N, BATCH_MAXITER = 1024, 128, 10
# Phase 16 runs the batched-MPC cell for MPC_SIM of its 50 steps (cut
# from 50 when phases 31-34 came, and from 25 when phase 36 came, for the
# script's time limit; each step is also held to single-instance run_mpc
# for two instances).
MPC_B, MPC_H, MPC_SIM = 512, 64, 5
RAGGED_B = 1000   # phases 13-14: a batch that does not fill its last block
# Phase 16b: the reference's pendulum MPC (examples/pendulum_mpc.py, H = 200)
# as a batch of PEND_BATCH initial angles, cut to PEND_STEPS steps.
PEND_BATCH, PEND_H, PEND_STEPS = 8, 200, 3
# Phase 16 runs the batched-MPC cell with rollout='auto' (the plain batched
# rollouts) for MPC_SIM_AUTO of its MPC_SIM steps: its single-instance
# references take ~0.85 s a step with the plain engines on an H100, against
# ~0.3 s with B2.  The rollout='pallas' run keeps all MPC_SIM steps.  (Cut
# from 10 to 5 when phases 22-25 came, and to 2 when phase 37 came, whose
# limited batched MPC of the same cell runs the plain batched rollouts.)
MPC_SIM_AUTO = 2
# Phase 15: four sampled instances (eight until phase 38 came) of the
# batched solve against the same problems solved one at a time with the
# plain engines (B4 against the
# plain sequential pass, batched against single rollouts: f32 in other
# operation orders, carried over 10 iterations).  Readings on an H100: sound
# runs at most 6.2e-7 (cost), 3.1e-5 (X), 1.4e-4 (U); with the materialized
# trajectory rounded to f16, 1.2e-5 / 1.8e-2 / 2.3e-1; at α·(1 − 1e-3),
# 1.0e-6 / 9.1e-4 / 1.3e-3; with B4's gains rounded to bf16, 6.2e-7 /
# 2.8e-4 / 2.8e-3.  Near an optimum the cost is flat, so X and U carry the
# gate.  Gains rounded to f16 (7.2e-7 / 6.2e-5 / 3.6e-4) stay within the
# sound scatter here; phase 13 holds B4 itself to its plain version.
RTOL_BATCH = 2e-6
ATOL_BATCH_X = 1e-4
ATOL_BATCH_U = 5e-4
# Phase 16: every closed-loop state of two sampled instances, batched loop
# against the single-instance loop, within ATOL_MPC (rad, rad/s).  With tol
# 1e-4 below the f32 resolution of the costs, rounding decides some
# iteration counts, and one solve's extra iteration moves the applied
# control.  Readings on an H100: sound runs up to 5.6e-3 (1.6e-3 over all
# 50 steps of four instances); with the materialized trajectory rounded to
# f16 1.9e-2, at α·(1 − 1e-3) 1.2e-2, with B4's gains rounded to bf16
# 4.5e-2.  Gains rounded to f16 (2.8e-3) stay within the sound scatter.
ATOL_MPC = 1e-2


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel: its mangled name, registers, spills."""
    lines, name, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line and "'" in line:
            name, spills = line.split("'")[1], ""
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            lines.append(f"  {name}: {regs}; {spills}")
            name = None
    return lines


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((got.double() - ref.double()).abs().max())
    scale = max(float(ref.double().abs().max()), 1e-30)
    return err, err / scale


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_name(key: str) -> str:
    """A profiler kernel key cut to its function name and template."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0][:56]


def device_us(fn, reps: int) -> dict:
    """{kernel name: (device µs per call, launches per call)} of the kernels
    fn launches, from torch.profiler's CUDA activity over reps calls after
    one warm-up call, the calls padded by 20 ms of host time on each side
    inside the profiled window.  Raises when the profiler recorded no
    device time.  Late in a long run it can lose kernel records (a
    fractional launch count shows it), so only phase 1 uses it, to count
    launches; `queued_us` times the device without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():   # "Profiler clears events ..."
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            out[e.key] = (t / reps, e.count / reps)
    if not out:
        raise AssertionError("torch.profiler recorded no device time")
    return out


# Cycles of the spin kernel that `queued_us` queues its calls behind:
# ~11 ms at the H100's 1.755 GHz boost clock, longer than the host takes
# to queue 20 calls of any wrapper timed here.  A turn whose queueing
# outlasts the spin is taken again behind a 4x and a 16x longer spin.
SPIN_CYCLES = 20_000_000


def queued_us(fn, reps: int = 20) -> float | None:
    """Device µs per call by CUDA events around reps back-to-back calls
    queued behind a spin kernel (torch.cuda._sleep), so that the device
    runs them without waiting for the host: a call's device time, launch
    gaps included, without CUPTI.  None when the host's queueing outlasted
    even the longest spin (the window would then hold host time)."""
    fn()
    torch.cuda.synchronize()
    for cycles in (SPIN_CYCLES, 4 * SPIN_CYCLES, 16 * SPIN_CYCLES):
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        queued = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize()
        if queued < spin.elapsed_time(start):
            return start.elapsed_time(end) * 1e3 / reps
    return None


def host_us(fn, reps: int) -> float:
    """Host time per call (µs): the wall clock over reps calls with no
    synchronisation between them, the queue drained before and after.  A
    kernel's wrapper returns once its launches are queued, so this is the
    wrapper's own cost unless the queue fills."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return host


def ms_text(us: float | None) -> str:
    """A device time in µs as ms for a printed line, or "not measured"."""
    return "not measured" if us is None else f"{us * 1e-3:.4f}"


def design_timing(smi, kernel: str, cases, turns: int = 4) -> dict:
    """A kernel timed in ``turns`` turns on each case {label: fn}.  Each turn
    gives device µs per call by CUDA events around calls queued behind a
    spin kernel (`queued_us`), the wrapper's host µs per call, and
    CUDA-event ms per call over 50 back-to-back calls.  Returns, per
    label, the medians; the device time is None when a turn could not
    measure it.  Launches per call are counted in phase 1."""
    out = {}
    print(f"{kernel} timing on {smi}, {turns} turns: device µs per call "
          f"(CUDA events behind a spin kernel), wrapper host µs per call, "
          f"CUDA-event ms per call:")
    for label, fn in cases.items():
        runs = [(queued_us(fn), host_us(fn, 100), cuda_ms(fn, 50, 2))
                for _ in range(turns)]
        queued = [r[0] for r in runs]
        device = None if None in queued else float(np.median(queued))
        host, event = (float(np.median([r[i] for r in runs])) for i in (1, 2))
        out[label] = dict(device_us=device, host_us=host, event_ms=event)
        print(f"  {kernel} {label}: device "
              f"{'not measured' if device is None else f'{device:.1f} µs'}"
              f" by queued events ("
              f"{'/'.join('-' if q is None else f'{q:.1f}' for q in queued)}"
              f"); host {host:.1f} µs "
              f"({'/'.join(f'{r[1]:.1f}' for r in runs)}); events "
              f"{event:.4f} ms ({'/'.join(f'{r[2]:.4f}' for r in runs)})")
    return out


def timing_columns(t: dict, launches: float | None = None
                   ) -> tuple[float, dict]:
    """A kernels-line row's ms (CUDA events over back-to-back calls, as
    every row) and its other timings from one `design_timing` case: device
    ms by queued events (null where not measured), the wrapper's host ms,
    and the launches per call that phase 1 counted."""
    dev_us = t["device_us"]
    cols = {"device_ms": None if dev_us is None else dev_us * 1e-3,
            "wrapper_host_ms": t["host_us"] * 1e-3}
    if launches is not None:
        cols["launches_per_call"] = launches
    return t["event_ms"], cols


def implicit_timing(itt, dev, smi, runs) -> dict:
    """Phase 5 for the implicit instantiations: B2a (10 alphas), B2b and
    the open loop along each solved golden runs[label] = (system, x0, sol)
    at its horizon N and at N/2 (prefixes of the same trajectory): ms per
    call by CUDA events, ns per step (the slope) and fixed µs."""
    out = {}
    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(),
                          dtype=torch.float32, device=dev)
    print(f"implicit instantiations on {smi} (CUDA events, ms per call):")
    for label, (system, x0, sol) in runs.items():
        X, U = sol.X.contiguous(), sol.U.contiguous()
        u_ff, K = sol.u_ff.contiguous(), sol.K.contiguous()
        N = U.shape[0]

        def cut(n):
            return X[:n + 1], U[:n], u_ff[:n], K[:n]

        kernels = {
            "linesearch_costs": lambda n: itt.linesearch_costs_fused(
                system, x0, alphas, *cut(n)),
            "closed_loop_rollout": lambda n: itt.closed_loop_rollout_fused(
                system, x0, 1.0, *cut(n)),
            "open_loop_rollout": lambda n: itt.open_loop_rollout_fused(
                system, x0, U[:n]),
        }
        for name, fn in kernels.items():
            t_n = cuda_ms(lambda: fn(N), 10, 1)
            t_h = cuda_ms(lambda: fn(N // 2), 10, 1)
            slope = (t_n - t_h) / (N - N // 2)
            out[label, name] = dict(ms=t_n, ns_per_step=slope * 1e6,
                                    fixed_us=(t_n - slope * N) * 1e3)
            print(f"  {label} {system.integrator} {name} N={N}: {t_n:.4f} "
                  f"(N={N // 2}: {t_h:.4f}), {slope * 1e6:.1f} ns per step, "
                  f"{(t_n - slope * N) * 1e3:.2f} µs fixed")
    return out


def dp_system(itt, f32, underactuated=False, integrator="euler", dt=0.01):
    """The double pendulum of the reference's flagship (fully actuated; also
    bench.py's system) or of its under-actuated swing-up."""
    if underactuated:
        return itt.make_double_pendulum(
            dt, [np.pi, 0, 0, 0], Q=np.diag([1.0, 1.0, 0.1, 0.1]),
            R=np.diag([1.0]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
            d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12,
            underactuated=True, integrator=integrator, **f32)
    return itt.make_double_pendulum(
        dt, [np.pi, 0, 0, 0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1, 0.1]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12,
        integrator=integrator, **f32)


def tile_expansion(exp, N: int):
    """``exp`` repeated along time and cut to N steps (terminal unchanged)."""
    reps = -(-N // exp.f_x.shape[0])

    def tile(t):
        return t.repeat((reps,) + (1,) * (t.ndim - 1))[:N].contiguous()

    return dataclasses.replace(
        exp, **{f: tile(getattr(exp, f)) for f in
                ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu")})


def batched_phases(itt, dev, smi, launches_per_call, B=BATCH_B, N=BATCH_N,
                   ragged=RAGGED_B, B_mpc=MPC_B, H=MPC_H, n_sim=MPC_SIM,
                   n_sim_auto=MPC_SIM_AUTO, n_sim_ms=20, samples=(4, 2),
                   B_pend=PEND_BATCH, H_pend=PEND_H, n_sim_pend=PEND_STEPS):
    """Phases 13-17 and 16b: batched solving and MPC through B4 and B5, and
    the single-instance MPC loops.  ``launches_per_call`` is phase 1's
    count.  Returns the kernels line's entries of B4 and B5."""
    from ilqr_tpu_torch.ops import _build, batched
    from ilqr_tpu_torch.ops.integrators import IMPLICIT

    lib = _build.load().lib
    f32 = dict(dtype=torch.float32, device=dev)
    dp = dp_system(itt, f32)
    ua = dp_system(itt, f32, underactuated=True)
    pend = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.zeros((2, 2)), d=0.0, integrator="rk4",
                             **f32)
    rng = np.random.default_rng(23)
    names = ("batched_riccati", "linesearch_costs_batched",
             "closed_loop_rollout_batched", "open_loop_rollout_batched")
    errors = dict.fromkeys(names, 0.0)
    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    # Phase 14's alpha counts: one lane, the solver's schedule, more than a
    # warp (grid.y = 2).
    alpha_all = torch.tensor([0.5 ** i for i in range(max(CHAIN_ALPHA_COUNTS))],
                             **f32)
    edge_b = ragged + 1   # fills no whole block of B4 (8 instances)
    t_start = t_lap = time.perf_counter()

    def lap(phase) -> None:
        """Print the wall time of a phase (these phases aim at ~90 s)."""
        nonlocal t_lap
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_lap:.1f} s")
        t_lap = now

    def bench_x0s(n, column, lo, hi):
        """bench.py's batched initial states: rest, with one coordinate
        spread evenly over [lo, hi]."""
        x = torch.zeros((n, 4), **f32)
        x[:, column] += torch.linspace(lo, hi, n, **f32)
        return x

    def random_expansion(system, x0s, n):
        U = torch.tensor(0.5 * rng.standard_normal((x0s.shape[0], n,
                                                    system.n_u)), **f32)
        X, _ = itt.rollout(system, x0s, U)
        return itt.linearize_trajectory_batched(system, X, U)

    def first_steps(exp, n):
        """The first n steps of every stage field (terminal unchanged)."""
        return dataclasses.replace(exp, **{
            f: getattr(exp, f)[:, :n].contiguous()
            for f in ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu")})

    def twice(label, fn):
        """fn's outputs, called twice with equal bits required."""
        torch.cuda.synchronize()
        got, again = fn(), fn()
        if not all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None):
            raise AssertionError(f"{label}: a repeated call gave other bits")
        return got

    # ---- 13. B4 against its plain version --------------------------------
    T4 = lib.ilqr_batched_riccati_chunk_steps()
    print(f"B4 tolerance: max|kernel - plain| <= max({RTOL_B4} * max|plain|,"
          f" {F32_FLOOR} * max|plain - plain in f64|); chunks of {T4} steps;"
          f" every call twice, bit for bit")

    def check_b4(label, exp, reg):
        got = twice(f"B4 {label}", lambda: itt.backward_pass_batched(exp, reg))
        plain = batched.vmap_backward(itt.backward_pass, exp, reg)
        ref64 = batched.vmap_backward(
            itt.backward_pass, as_f64(exp),
            reg.double() if torch.is_tensor(reg) else reg)
        torch.cuda.synchronize()
        notes = check_fields(f"B4 {label}", got[:3], plain[:3], ref64[:3],
                             RTOL_B4, errors, "batched_riccati")
        if not (torch.equal(got[3], plain[3]) and bool(got[3].all())):
            raise AssertionError(f"B4 {label}: ok flags differ from the "
                                 f"plain version's or gains not finite")
        print(f"B4 {label}: B={exp.f_x.shape[0]} N={exp.f_x.shape[1]} max "
              f"abs error " + "; ".join(notes)
              + "; repeated call bit-identical")

    exp_dp = random_expansion(dp, bench_x0s(B, 0, 0.0, 0.5), N)
    check_b4("DP, random controls, reg 0", exp_dp, 0.0)
    check_b4("DP, random controls, per-instance reg",
             exp_dp, torch.linspace(0.0, 0.2, B, **f32))
    for n in (ragged, 1):
        check_b4("DP, random controls, reg 0.1",
                 random_expansion(dp, bench_x0s(n, 0, 0.0, 0.5), N), 0.1)
    check_b4("pendulum rk4, random controls",
             random_expansion(pend, bench_x0s(B, 0, 0.0, 0.5)[:, :2], N), 0.0)
    check_b4("UA-DP, random controls",
             random_expansion(ua, bench_x0s(B, 0, 0.0, 0.5), N), 0.0)
    # The chunk edges (N = 1, T - 1, T, T + 1, and across five chunk edges
    # ending mid-chunk) at a batch that fills no whole block; the pendulum
    # (n_u = 1) at an odd N, where every instance's l_u, l_uu and u_ff rows
    # start at another 4-byte phase.
    mid4 = 5 * T4 + T4 // 2 + 3
    exp_e = random_expansion(dp, bench_x0s(edge_b, 0, 0.0, 0.5), mid4)
    for n in (1, T4 - 1, T4, T4 + 1, mid4):
        check_b4(f"DP chunk edges, reg 0.1", first_steps(exp_e, n), 0.1)
    check_b4("pendulum rk4, odd N (misaligned rows)",
             random_expansion(pend, bench_x0s(edge_b, 0, 0.0, 0.5)[:, :2],
                              N - 1), 0.0)

    lap(13)

    # ---- 14. B5 against its plain versions --------------------------------
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mode, what, A in ((0, "costs", 10), (0, "costs", 33),
                          (1, "trajectory", 1), (2, "open loop", 1)):
        per = lib.ilqr_chain_instances_per_warp(mode, 4, 2, B, A)
        warps = lib.ilqr_chain_warps_per_block(mode, 4, 2, B, A)
        blocks = -(-B // (per * warps)) * -(-A // 32)
        print(f"B5 split at B={B} (DP): {what}, {A} alphas: {per} instances "
              f"a chain warp, {warps} chain warps a block, {blocks} blocks "
              f"({blocks / sms:.2f} an SM)")
    print(f"B5 tolerance: max|kernel - plain| <= {RTOL_B5} * max|plain| "
          f"(B2's recursion per instance); every call twice, bit for bit")

    def check_b5_pair(kernel, label, got, ref):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"B5 {label}: non-finite kernel output")
        err, rel = rel_err(got, ref)
        errors[kernel] = max(errors[kernel], err)
        if not rel <= RTOL_B5:
            raise AssertionError(f"B5 {label}: max error {err:.3e} is "
                                 f"{rel:.3e} of max |plain|")
        return rel

    def check_b5_all(label, system, x0s, X0, U0, u0, K0, counts,
                     U_open=None):
        """Costs at each alpha count, the trajectory at seeded
        per-instance alphas and the open loop (of U_open, else U0)
        against the plain versions."""
        n = x0s.shape[0]
        worst = 0.0
        for A in counts:
            got = twice(f"B5 {label}", lambda: (itt.linesearch_costs_batched(
                system, x0s, alpha_all[:A], X0, U0, u0, K0),))
            ref = itt.linesearch_rollouts(system, x0s, alpha_all[:A], X0, U0,
                                          u0, K0)[2]
            worst = max(worst, check_b5_pair(
                "linesearch_costs_batched", f"{label} costs, {A} alphas",
                got[0], ref))
        alpha_b = alphas[torch.tensor(rng.integers(0, alphas.numel(), n),
                                      device=dev)]
        got = twice(f"B5 {label}", lambda: itt.closed_loop_rollout_batched(
            system, x0s, alpha_b, X0, U0, u0, K0))
        ref = itt.linesearch_rollouts(system, x0s, alpha_b[:, None], X0, U0,
                                      u0, K0)
        for what, g, r in zip(("X", "U", "cost"), got, ref):
            worst = max(worst, check_b5_pair(
                "closed_loop_rollout_batched", f"{label} trajectory {what}",
                g, r[:, 0]))
        U_o = U0 if U_open is None else U_open
        got = twice(f"B5 {label}", lambda: itt.open_loop_rollout_batched(
            system, x0s, U_o))
        for what, g, r in zip(("X", "cost"), got, itt.rollout(system, x0s,
                                                              U_o)):
            worst = max(worst, check_b5_pair(
                "open_loop_rollout_batched", f"{label} open loop {what}", g,
                r))
        return worst

    def first_iteration(system, x0s, n_steps):
        """The first iteration of a batched solve: the trajectories of zero
        controls and their B4 gains."""
        U0 = torch.zeros((x0s.shape[0], n_steps, system.n_u), **f32)
        X0, _ = itt.rollout(system, x0s, U0)
        u0, K0, _, _ = itt.backward_pass_batched(
            itt.linearize_trajectory_batched(system, X0, U0), 0.0)
        return x0s, X0.contiguous(), U0, u0, K0

    for n in (B, ragged, 1):
        args = first_iteration(dp, bench_x0s(n, 0, 0.0, 0.5), N)
        U_rand = torch.tensor(0.5 * rng.standard_normal((n, N, 2)), **f32)
        worst = check_b5_all(f"DP first iteration B={n}", dp, *args,
                             CHAIN_ALPHA_COUNTS, U_open=U_rand)
        print(f"B5 DP first iteration: B={n} N={N}, {CHAIN_ALPHA_COUNTS} "
              f"alphas, per-instance alphas, open loop of random controls: "
              f"max rel error {worst:.3e}")
    # Every instantiation (three models, five integrators; the implicit
    # ones at newton_iters 1 and 10) at a small batch, at N = 34 for the
    # pendulum and 35 for the double pendulums (across a chunk edge):
    # X_old rows (n_x = 2) or U rows (n_u = 2) and U, u_ff rows (n_u = 1)
    # of every instance start at another 4-byte phase.  Nominal: seeded
    # random controls and their B4 gains at reg CHAIN_REG.
    for integ in CHAIN_INTEGRATORS:
        for name, system in chain_systems(itt, f32, integ).items():
            n_steps = 34 if system.n_x == 2 else 35
            x0s = torch.tensor(0.3 * rng.standard_normal((5, system.n_x)),
                               **f32)
            U_r = torch.tensor(0.5 * rng.standard_normal(
                (5, n_steps, system.n_u)), **f32)
            for iters in ((1, 10) if integ in IMPLICIT else (None,)):
                sys_i = (system if iters is None
                         else system.replace(newton_iters=iters))
                X_r, _ = itt.rollout(sys_i, x0s, U_r)
                u_r, K_r, _, _ = itt.backward_pass_batched(
                    itt.linearize_trajectory_batched(sys_i, X_r, U_r),
                    CHAIN_REG)
                label = (f"{name} {integ}"
                         + ("" if iters is None else f" newton_iters {iters}"))
                worst = check_b5_all(label, sys_i, x0s, X_r.contiguous(), U_r,
                                     u_r, K_r, (10,))
                print(f"B5 {label}: B=5 N={n_steps}: max rel error "
                      f"{worst:.2e}")

    lap(14)

    # ---- 15. the batched-solve cell (bench.py:700-709) ---------------------
    x0s = bench_x0s(B, 0, 0.0, 0.5)
    U0 = torch.zeros((N, 2), **f32)
    _, cost0 = itt.rollout(dp, x0s, U0.expand(B, N, 2))
    sols, counts15 = {}, {}
    for rollout in ("scan", "pallas"):
        cfg = itt.IlqrConfig(maxiter=BATCH_MAXITER, tol=1e-5,
                             backward="scan", rollout=rollout)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        sol = itt.solve_batched(dp, x0s, U0, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        loops = int((sol.iterations
                     + (sol.status == itt.LINESEARCH_FAILED)).max())
        status = {int(k): int(v) for k, v in zip(
            *torch.unique(sol.status, return_counts=True))}
        print(f"batched solve B={B} N={N} (backward=scan, rollout={rollout}):"
              f" {wall:.3f} s, {B / wall:.1f} solves/s, {loops} iterations, "
              f"{wall * 1e3 / max(loops, 1):.1f} ms per iteration, statuses "
              f"{status}, cost mean {float(sol.cost.mean()):.4f}, launches "
              f"{counts}")
        want = {"batched_riccati": loops}
        if rollout == "pallas":
            want.update(linesearch_costs_batched=loops,
                        closed_loop_rollout_batched=loops,
                        open_loop_rollout_batched=1)
        for kernel, n in want.items():
            if counts.get(kernel, 0) != n:
                raise AssertionError(f"batched solve ({rollout}): {kernel} "
                                     f"launched {counts.get(kernel, 0)} "
                                     f"times, expected {n}")
        costs = sol.cost
        if not (bool(torch.isfinite(costs).all())
                and bool((costs <= cost0).all())):
            raise AssertionError(f"batched solve ({rollout}): a cost is not "
                                 f"finite or above its initial cost")
        trace = torch.cat([cost0[:, None], sol.cost_trace], dim=1)
        steps = trace[:, 1:] - trace[:, :-1]
        if bool((steps > 0).any()):
            raise AssertionError(f"batched solve ({rollout}): a cost trace "
                                 f"increased")
        sols[rollout], counts15[rollout] = sol, counts

    picks = np.sort(rng.choice(B, samples[0], replace=False))
    plain_cfg = itt.IlqrConfig(maxiter=BATCH_MAXITER, tol=1e-5,
                               backward="scan", rollout="scan")
    limits = {"cost": RTOL_BATCH, "X": ATOL_BATCH_X, "U": ATOL_BATCH_U}
    worst = {r: dict.fromkeys(limits, 0.0) for r in sols}
    for i in picks:
        one = itt.solve(dp, x0s[i], U0, plain_cfg)
        for rollout, sol in sols.items():
            c1, cb = float(one.cost), float(sol.cost[i])
            diffs = {"cost": abs(cb - c1) / abs(c1),
                     "X": float((sol.X[i] - one.X).abs().max()),
                     "U": float((sol.U[i] - one.U).abs().max())}
            for key, d in diffs.items():
                worst[rollout][key] = max(worst[rollout][key], d)
                if not d <= limits[key]:
                    raise AssertionError(
                        f"batched solve ({rollout}) instance {i}: {key} "
                        f"differs from the instance solved alone (plain "
                        f"engines) by {d:.2e}, limit {limits[key]}")
    for rollout, w in worst.items():
        print(f"batched solve ({rollout}): {samples[0]} sampled instances "
              f"{picks.tolist()} agree with solves alone (plain engines): "
              f"cost rel {w['cost']:.2e}, X {w['X']:.2e}, U {w['U']:.2e} "
              f"(limits {RTOL_BATCH}, {ATOL_BATCH_X}, {ATOL_BATCH_U})")

    def kernel_timing(label, system, x0s_t, X_t, U_t):
        """B4 and B5 at one shape, each by `design_timing`, with the plain
        versions by CUDA events: the expansion at (X_t, U_t), its B4 gains,
        10 alphas, the trajectory at alpha 0.5 and the open loop of U_t."""
        exp_t = itt.linearize_trajectory_batched(system, X_t, U_t)
        u_t, K_t, _, _ = itt.backward_pass_batched(exp_t, 0.0)
        alpha_t = torch.full((x0s_t.shape[0],), 0.5, **f32)
        t_lin = cuda_ms(lambda: itt.linearize_trajectory_batched(
            system, X_t, U_t), 3, 1)
        dt = {}
        for kernel, fn in {
                "batched_riccati": lambda: itt.backward_pass_batched(
                    exp_t, 0.0),
                "linesearch_costs_batched": lambda:
                    itt.linesearch_costs_batched(system, x0s_t, alphas, X_t,
                                                 U_t, u_t, K_t),
                "closed_loop_rollout_batched": lambda:
                    itt.closed_loop_rollout_batched(system, x0s_t, alpha_t,
                                                    X_t, U_t, u_t, K_t),
                "open_loop_rollout_batched": lambda:
                    itt.open_loop_rollout_batched(system, x0s_t, U_t)}.items():
            dt[kernel] = design_timing(smi, kernel, {label: fn})[label]
        plain = {
            "batched_riccati": cuda_ms(lambda: batched.vmap_backward(
                itt.backward_pass, exp_t, 0.0), 2, 1),
            "linesearch_costs_batched": cuda_ms(
                lambda: itt.linesearch_rollouts(system, x0s_t, alphas, X_t,
                                                U_t, u_t, K_t), 2, 1),
            "closed_loop_rollout_batched": cuda_ms(
                lambda: itt.linesearch_rollouts(system, x0s_t,
                                                alpha_t[:, None], X_t, U_t,
                                                u_t, K_t), 2, 1),
            "open_loop_rollout_batched": cuda_ms(
                lambda: itt.rollout(system, x0s_t, U_t), 2, 1),
        }
        print(f"timing on {smi} (ms per call), {label}: "
              f"linearize_trajectory_batched {t_lin:.4f}; "
              + "; ".join(f"{k} events {dt[k]['event_ms']:.4f}, device "
                          f"{ms_text(dt[k]['device_us'])}, host "
                          f"{dt[k]['host_us'] * 1e-3:.4f}, plain "
                          f"{plain[k]:.4f}" for k in names))
        return dt, plain

    # The kernels at the solved trajectories of the cell.
    sol = sols["pallas"]
    t15 = kernel_timing(f"batched-solve cell B={B} N={N}", dp, x0s, sol.X,
                        sol.U)

    lap(15)

    # ---- 16. the batched-MPC cell (bench.py:711-723) -----------------------
    x0m = bench_x0s(B_mpc, 1, -0.3, 0.3)
    Um = torch.zeros((H, 2), **f32)
    refs = np.sort(rng.choice(B_mpc, samples[1], replace=False))
    print(f"batched MPC: rollout='auto' cut to {n_sim_auto} of {n_sim} "
          f"steps; instances {refs.tolist()} re-run alone over every step")
    counts16 = {}
    for rollout, steps in (("auto", n_sim_auto), ("pallas", n_sim)):
        cfg = itt.IlqrConfig(maxiter=5, tol=1e-4, rollout=rollout)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = itt.run_mpc_batched(dp, dp, x0m, Um, steps, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts16[rollout] = counts = _build.launch_counts()
        print(f"batched MPC B={B_mpc} H={H} n_sim={steps} (rollout={rollout})"
              f": {wall:.3f} s, {B_mpc * steps / wall:.1f} step-solves/s, "
              f"{float(res.solve_iters.float().mean()):.2f} iterations per "
              f"solve, closed-loop cost mean {float(res.cost.mean()):.4f}, "
              f"launches {counts}")
        kernels = ["batched_riccati"]
        if rollout == "pallas":
            kernels += ["linesearch_costs_batched",
                        "closed_loop_rollout_batched",
                        "open_loop_rollout_batched"]
        for kernel in kernels:
            if counts.get(kernel, 0) < steps:
                raise AssertionError(f"batched MPC ({rollout}): {kernel} "
                                     f"launched {counts.get(kernel, 0)} "
                                     f"times in {steps} steps")
        if not (bool(torch.isfinite(res.cost).all())
                and bool(torch.isfinite(res.X).all())
                and res.X.shape == (B_mpc, steps + 1, 4)):
            raise AssertionError(f"batched MPC ({rollout}): closed loop not "
                                 f"finite or of the wrong shape")
        dx_worst, dc_worst, flips = 0.0, 0.0, 0
        for i in refs:
            one = itt.run_mpc(dp, dp, x0m[i], Um, steps, cfg)
            dx = float((res.X[i] - one.X).abs().max())
            dx_worst = max(dx_worst, dx)
            dc_worst = max(dc_worst, abs(float(res.cost[i] - one.cost))
                           / abs(float(one.cost)))
            flips += int((res.solve_iters[i] != one.solve_iters).sum())
            if not dx <= ATOL_MPC:
                raise AssertionError(
                    f"batched MPC ({rollout}) instance {i}: closed loop "
                    f"differs from the single-instance loop by {dx:.2e}")
        print(f"batched MPC ({rollout}): instances {refs.tolist()} agree with "
              f"single-instance run_mpc over all {steps} steps to "
              f"{dx_worst:.2e} (limit {ATOL_MPC}); closed-loop cost rel "
              f"{dc_worst:.2e}; {flips} of {len(refs) * steps} solves ended "
              f"at another iteration count")
    # The kernels at the cell's shape: its first solve's first iteration.
    x0m_, Xm, Um_, _, _ = first_iteration(dp, x0m, H)
    t16 = kernel_timing(f"batched-MPC cell B={B_mpc} N={H}", dp, x0m_, Xm,
                        Um_)

    lap(16)

    # ---- 16b. the reference's pendulum MPC as a batch (B4, B5i) ----------
    # examples/pendulum_mpc.py: backward-Euler solver, midpoint plant,
    # H = 200, maxiter 10; B_pend initial angles, n_sim_pend steps; two
    # instances held to single-instance run_mpc (B2m) over every step.
    def mpc_pendulum(integrator):
        return itt.make_pendulum(
            0.01, [np.pi, 0.0], Q=np.diag([10.0, 1.0]), R=np.eye(1),
            Q_f=np.diag([10.0, 10.0]), d=0.0, integrator=integrator, **f32)

    p_solver, p_plant = (mpc_pendulum("backward_euler"),
                         mpc_pendulum("midpoint"))
    x0p = torch.zeros((B_pend, 2), **f32)
    x0p[:, 0] = torch.linspace(0.0, 0.7, B_pend, **f32)
    Up = torch.zeros((H_pend, 1), **f32)
    cfg = itt.IlqrConfig(maxiter=10, tol=1e-5, rollout="pallas")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = itt.run_mpc_batched(p_solver, p_plant, x0p, Up, n_sim_pend, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    print(f"batched pendulum MPC (backward-Euler solver, midpoint plant) "
          f"B={B_pend} H={H_pend} n_sim={n_sim_pend}: {wall:.3f} s, "
          f"{float(res.solve_iters.float().mean()):.2f} iterations per solve,"
          f" closed-loop cost mean {float(res.cost.mean()):.4f}, launches "
          f"{counts}")
    if counts.get("open_loop_rollout_batched", 0) != n_sim_pend:
        raise AssertionError(f"batched pendulum MPC: open_loop_rollout_"
                             f"batched launched "
                             f"{counts.get('open_loop_rollout_batched', 0)} "
                             f"times, expected one a solve ({n_sim_pend})")
    for kernel in names[:3]:
        if counts.get(kernel, 0) < n_sim_pend:
            raise AssertionError(f"batched pendulum MPC: {kernel} launched "
                                 f"{counts.get(kernel, 0)} times in "
                                 f"{n_sim_pend} steps")
    if not (bool(torch.isfinite(res.X).all())
            and res.X.shape == (B_pend, n_sim_pend + 1, 2)):
        raise AssertionError("batched pendulum MPC: closed loop not finite "
                             "or of the wrong shape")
    dx_worst = 0.0
    for i in (0, B_pend - 1):
        _build.reset_launch_counts()
        one = itt.run_mpc(p_solver, p_plant, x0p[i], Up, n_sim_pend, cfg)
        one_counts = _build.launch_counts()
        for kernel in ("linesearch_costs", "closed_loop_rollout",
                       "open_loop_rollout"):
            if one_counts.get(kernel, 0) < 1:
                raise AssertionError(f"pendulum MPC instance {i} alone never "
                                     f"launched {kernel}")
        dx = float((res.X[i] - one.X).abs().max())
        dx_worst = max(dx_worst, dx)
        if not dx <= ATOL_MPC:
            raise AssertionError(f"batched pendulum MPC instance {i}: closed "
                                 f"loop differs from run_mpc alone by "
                                 f"{dx:.2e}")
    print(f"batched pendulum MPC: instances 0 and {B_pend - 1} agree with "
          f"single-instance run_mpc (B2m) over all {n_sim_pend} steps to "
          f"{dx_worst:.2e} (limit {ATOL_MPC})")

    lap("16b")

    # ---- 17. single-instance MPC through B1/B2 and B1d/B3 ------------------
    cfg = itt.IlqrConfig(maxiter=5, tol=1e-4, backward="pallas",
                         rollout="pallas")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = itt.run_mpc(dp, dp, torch.zeros(4, **f32), Um, n_sim, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    print(f"run_mpc DP H={H} n_sim={n_sim} (pallas/pallas): {wall:.3f} s, "
          f"{wall * 1e3 / n_sim:.1f} ms per step, cost {float(res.cost):.4f},"
          f" launches {counts}")
    for kernel in ("fused_riccati", "linesearch_costs", "closed_loop_rollout"):
        if counts.get(kernel, 0) < 1:
            raise AssertionError(f"run_mpc never launched {kernel}")
    if not bool(torch.isfinite(res.cost)):
        raise AssertionError("run_mpc: closed-loop cost not finite")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = itt.run_mpc_ms(pend, pend, torch.tensor([1.0, 0.0], **f32),
                         torch.zeros((H, 1), **f32), n_sim_ms,
                         itt.IlqrConfig(maxiter=3, tol=1e-5,
                                        backward="pallas"),
                         ms=itt.MsConfig(update_engine="pallas"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    print(f"run_mpc_ms pendulum rk4 H={H} n_sim={n_sim_ms} (B1d, B3): "
          f"{wall:.3f} s, cost {float(res.cost):.4f}, launches {counts}")
    for kernel in ("fused_riccati", "affine_prefix_scan"):
        if counts.get(kernel, 0) < 1:
            raise AssertionError(f"run_mpc_ms never launched {kernel}")
    if not bool(torch.isfinite(res.cost)):
        raise AssertionError("run_mpc_ms: closed-loop cost not finite")

    lap(17)
    print(f"phases 13-17: {time.perf_counter() - t_start:.1f} s")

    # Rows at the batched-solve cell's shape, with its launches, and at the
    # batched-MPC cell's, with the pallas run's.
    replaces = {"batched_riccati": "ilqr_tpu/ops/pallas_batched.py:114"}
    rows = []
    for suffix, (b_n, n_n), (dt, plain), launches in (
            ("", (B, N), t15, {"batched_riccati": counts15["scan"],
                               **dict.fromkeys(names[1:],
                                               counts15["pallas"])}),
            ("_mpc", (B_mpc, H), t16, dict.fromkeys(names,
                                                    counts16["pallas"]))):
        bounds = batched_bounds(b_n, n_n, alphas.numel())
        for name in names:
            ms, more = timing_columns(dt[name], launches_per_call[name])
            rows.append(dict(
                name=name + suffix, route="cuda",
                source="ilqr_tpu_torch/csrc/" + (
                    "batched_riccati.cu" if name == "batched_riccati"
                    else "chain_rollout.cu"),
                replaces=replaces.get(name,
                                      "ilqr_tpu/ops/pallas_batched.py:377"),
                launches=launches[name].get(name, 0),
                max_abs_err=errors[name], ms=ms, plain_ms=plain[name],
                bound_ms=bounds[name][0], bound_by=bounds[name][1],
                library_ms=None, B=b_n, N=n_n, **more))
    return rows


# ---- bounds: the least time the card could take for a kernel's work ------
# NVIDIA's H100 SXM data sheet, at the 700 W power limit: 3.35 TB/s of HBM3
# and 67 TFLOP/s in float32 outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


def bound(n_bytes: float, ops: float) -> tuple[float, str]:
    """(bound ms, what binds): the larger of bytes over the memory rate
    and operations over the f32 rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b3_bound(N: int, n: int, A: int) -> tuple[float, str]:
    """B3's bound: P, q and delta_0 read and delta written once; the
    sequential recursion's A N matrix-vector products (2 n^2 each)."""
    return bound(4 * (N * n * n + A * N * n + A * n + A * (N + 1) * n),
                 A * N * 2 * n * n)


def riccati_step_ops(n_x: int, n_u: int) -> int:
    """The operations of one step of the sequential Riccati recursion as
    ops/riccati.py's backward_pass (and B4's step) performs it, a
    multiply-add counting two: f_x' V_xx and (f_x' V_xx) f_x (4 n_x^3);
    F = f_u' V_xx, F f_x and the V_xx update K'W + Q_ux'K (8 n_u n_x^2);
    F f_u, the gains K and W = Q_uu K + Q_ux (6 n_u^2 n_x); the inverse of
    Q_uu + reg I (2 n_u^3); Q_x (2 n_x^2), Q_u and V_x (6 n_x n_u), u_ff
    and w (4 n_u^2) and dV (4 n_u)."""
    return (4 * n_x ** 3 + 8 * n_u * n_x ** 2 + 6 * n_u ** 2 * n_x
            + 2 * n_u ** 3 + 2 * n_x ** 2 + 6 * n_x * n_u + 4 * n_u ** 2
            + 4 * n_u)


def combine_ops(n_x: int) -> int:
    """One combine of two Riccati elements, JAX's estimate
    (ilqr_tpu/ops/pallas_riccati.py:549)."""
    return 40 * n_x ** 3


# Operations of one evaluation of the register models' f (csrc/models.cuh,
# whose constants are loaded once), the least the step needs: an add or a
# multiply counts as one, a sine, cosine or reciprocal as one (sincosf as
# two), a negation as none.  [0] over float, [1] over Dual<n_x> (df/dx
# beside f), where a sum, difference or scaling adds n_x tangent
# operations, a product of two duals 3 n_x, and sin, cos or the reciprocal
# the other of sincosf's outputs (or r r) and n_x products.  The double
# pendulum's torque S u adds 4 n_u to both.
FCONT_OPS = {"pendulum": (5, 16), "double_pendulum": (46, 302)}
# The evaluations and state updates of one explicit integrator step
# ('discrete': the map itself).
INTEGRATOR_EVALS = {"euler": (1, 2), "midpoint": (2, 5), "rk4": (4, 14),
                    "discrete": (1, 0)}
# smallmat.cuh's inv<n>: at n = 2 the determinant (3), its reciprocal and
# four products; at n = 4 two of those, six 2 x 2 products (12 each) and
# eight sums.
INV_OPS = {2: 8, 4: 2 * 8 + 6 * 12 + 8}
NEWTON_ITERS = 10   # System.newton_iters, the implicit rules' corrections


def fcont_ops(model: str, n_u: int, dual: bool = False, n_x: int = 0
              ) -> int:
    """One evaluation of a model's f (FCONT_OPS); the LTI systems' two
    products (2 n_x^2 + 2 n_x n_u - n_x) and the spring chain's 10 an
    oscillator (S u is formed once a step) from their shapes; a neural
    residual "neural:<base>:<widths>" (`neural_name`) its base's and its
    MLP's (`mlp_ops`, explicit rules only)."""
    if model == "lti":
        return 2 * n_x * n_x + 2 * n_x * n_u - n_x
    if model == "spring_chain":
        return 10 * (n_x // 2)
    if model.startswith("neural:"):
        _, base, widths = model.split(":")
        return (fcont_ops(base, n_u, dual, n_x)
                + mlp_ops([int(w) for w in widths.split("-")]))
    torque = 4 * n_u if model == "double_pendulum" else 0
    return FCONT_OPS[model][dual] + torque


def gauss_jordan_ops(n: int) -> int:
    """models.cuh's gauss_jordan on [M | I] (n x 2n): at pivot k the
    search (n - k - 1 comparisons), the pivot row scaled (2n - k and the
    reciprocal) and n - 1 rows updated (2 (2n - k) each)."""
    return sum((n - k - 1) + (2 * n - k + 1) + (n - 1) * 2 * (2 * n - k)
               for k in range(n))


def integrator_ops(model: str, integrator: str, n_x: int, n_u: int) -> int:
    """One integrator step.  The implicit rules (models.cuh, integrate):
    the predictor (one evaluation and 2 n_x), df/dx, I - h df/dx (2 n_x^2)
    and its inverse, and NEWTON_ITERS corrections of one evaluation, the
    residual (3 n_x for backward Euler, 4 n_x for trapezoidal), a
    matrix-vector product (2 n_x^2) and the update (n_x) each.  Up to
    n_x = 4 df/dx is one Dual<n_x> evaluation and the inverse a closed
    form; wider, n_x Dual<1> evaluations (FCONT_OPS's dual count is then a
    column's) and Gauss-Jordan."""
    f = fcont_ops(model, n_u, n_x=n_x)
    if integrator in INTEGRATOR_EVALS:
        evals, axpy = INTEGRATOR_EVALS[integrator]
        return evals * f + axpy * n_x
    residual = 4 * n_x if integrator == "trapezoidal" else 3 * n_x
    if n_x <= 4:
        jac = fcont_ops(model, n_u, dual=True) + INV_OPS[n_x]
    else:
        jac = n_x * fcont_ops(model, n_u, dual=True) + gauss_jordan_ops(n_x)
    return (f + 2 * n_x + jac + 2 * n_x * n_x
            + NEWTON_ITERS * (f + residual + 2 * n_x * n_x + n_x))


def rollout_step_ops(model: str, integrator: str, n_x: int, n_u: int,
                     feedback: bool = True) -> int:
    """One closed-loop (or open-loop) rollout step: the control law
    u = u_old + a u_ff + K (x - x_old), the dynamics step and the stage
    cost.  ``model``: a name of FCONT_OPS under the quadratic costs, "lti",
    "spring_chain" (its diagonal costs, S u once a step), or a wrapper
    "tracking:<base>" (the base's step and the clock's update; the cost
    about the reference row: the rounded clock, its clamps, dx and du) or
    "rate:<base>" (the base's step on n_x - n_u states; its cost and the
    rate term 0.5 du' S du dt)."""
    control = 2 * n_u * n_x + 3 * n_u + n_x if feedback else 0
    if model.startswith("tracking:"):
        base, n_b = model.split(":")[1], n_x - 1
        step = (integrator_ops(base, integrator, n_b, n_u)
                + INTEGRATOR_EVALS[integrator][1])
        cost = 3 * (n_b * n_b + n_u * n_u) + n_b + n_u + 8
    elif model.startswith("rate:"):
        base, n_b = model.split(":")[1], n_x - n_u
        step = integrator_ops(base, integrator, n_b, n_u)
        cost = (3 * (n_b * n_b + n_u * n_u) + n_b + 4
                + n_u + 3 * n_u * n_u + 3)
    elif model == "spring_chain":
        m = n_x // 2
        step = integrator_ops(model, integrator, n_x, n_u) + 2 * m * n_u
        cost = 5 * m + 2 * n_u + 6
    else:
        step = integrator_ops(model, integrator, n_x, n_u)
        cost = 3 * (n_x * n_x + n_u * n_u) + n_x + 4
    return control + step + cost


def batched_bounds(B: int, N: int, A: int, n_x: int = 4, n_u: int = 2,
                   model: str = "double_pendulum", integrator: str = "euler",
                   extra_floats: int = 0):
    """Bounds of B4 and the B5 entries on B instances of N steps (the DP
    under euler unless ``model`` and ``integrator`` say otherwise), A
    alphas; ``extra_floats``: parameters the rollouts read beyond
    `params_floats` (a tracking reference's rows)."""
    step_ops = rollout_step_ops(model, integrator, n_x, n_u)
    traj_in = B * ((N + 1) * n_x + 2 * N * n_u + N * n_u * n_x + n_x)
    traj_out = B * ((N + 1) * n_x + N * n_u + 1)
    p_in = params_floats(n_x, n_u) + extra_floats
    return {
        "batched_riccati": bound(
            4 * B * (expansion_floats(N, n_x, n_u) + N * (n_u + n_u * n_x)
                     + 3), B * N * riccati_step_ops(n_x, n_u)),
        "linesearch_costs_batched": bound(
            4 * (traj_in + A + p_in + B * A), B * A * N * step_ops),
        "closed_loop_rollout_batched": bound(
            4 * (traj_in + B + p_in + traj_out), B * N * step_ops),
        "open_loop_rollout_batched": bound(
            4 * (B * (n_x + N * n_u) + p_in + B * ((N + 1) * n_x + 1)),
            B * N * rollout_step_ops(model, integrator, n_x, n_u,
                                     feedback=False)),
    }


def expansion_floats(N: int, n_x: int, n_u: int) -> int:
    """Floats of a TrajectoryExpansion (the seven stage blocks and the
    terminal v_x, v_xx)."""
    stage = 2 * n_x * n_x + 2 * n_x * n_u + n_x + n_u + n_u * n_u
    return N * stage + n_x + n_x * n_x


def params_floats(n_x: int, n_u: int) -> int:
    """Floats of the rollout kernels' parameter buffer (an upper bound of
    its model block)."""
    return 1 + n_x + 2 * n_x * n_x + n_u * n_u + 9 + 2 * n_u


def chain_bounds(n_x: int, n_u: int, N: int, A: int, model="double_pendulum",
                 integrator="euler", extra_floats: int = 0):
    """Bounds of the B = 1 chain kernels at horizon N: the costs of A
    alphas, the trajectory of one, and the open loop; ``extra_floats`` as
    in `batched_bounds`."""
    ops = rollout_step_ops(model, integrator, n_x, n_u)
    p_in = params_floats(n_x, n_u) + extra_floats
    traj_in = ((N + 1) * n_x + 2 * N * n_u + N * n_u * n_x + p_in + n_x)
    return {
        "linesearch_costs": bound(4 * (traj_in + 2 * A), A * N * ops),
        "closed_loop_rollout": bound(
            4 * (traj_in + 1 + (N + 1) * n_x + N * n_u + 1), N * ops),
        "open_loop_rollout": bound(
            4 * (n_x + N * n_u + p_in + (N + 1) * n_x + 1),
            N * rollout_step_ops(model, integrator, n_x, n_u, feedback=False)),
    }


# ---- Phases 3 and 5: the B = 1 chain kernels (B2a, B2b, open loop) --------
# Phase 3's alpha counts: one lane, the solver's schedule, and more
# candidates than one warp holds (grid.y = 2).
CHAIN_ALPHA_COUNTS = (1, 10, 33)
CHAIN_INTEGRATORS = ("euler", "midpoint", "rk4", "backward_euler",
                     "trapezoidal")
CHAIN_REG = 1.0   # the regularization of phase 3's B1 gains
# The SASS report's instantiations: the DP flagship's chain kernel (double
# pendulum, n_u = 2, euler), B4 at (4, 2) and the wide forms of B6w and B4w
# at P = 16, by demangled or mangled name.
SASS_KERNELS = {
    "chain_kernel DP (4,2) euler": (
        "chain_kernel<ilqr::DoublePendulumRegs<2>, 4, 2, 0,",
        "chain_kernelINS_18DoublePendulumRegsILi2EEELi4ELi2ELi0E"),
    # The wide implicit rules (df/dx by columns, Gauss-Jordan in shared
    # memory) and a wrapper (the tracked pendulum, rk4).
    "chain_kernel 3-D quadrotor (12,4) backward Euler": (
        "chain_kernel<ilqr::Quadrotor3dRegs<4>, 12, 4, 3,",
        "chain_kernelINS_15Quadrotor3dRegsILi4EEELi12ELi4ELi3E"),
    "chain_kernel rotor variant (16,4) trapezoidal": (
        "chain_kernel<ilqr::Quadrotor3dRotorRegs<4>, 16, 4, 4,",
        "chain_kernelINS_20Quadrotor3dRotorRegsILi4EEELi16ELi4ELi4E"),
    "chain_kernel tracked 3-D quadrotor (13,4) rk4": (
        "chain_kernel<ilqr::TrackingForm<ilqr::Quadrotor3dRegs<4>, 12, 4, 2>,"
        " 13,",
        "chain_kernelINS_12TrackingFormINS_15Quadrotor3dRegsILi4EEELi12ELi4E"
        "Li2EEELi13ELi4ELi2E"),
    "batched_riccati_kernel (4,2)": (
        "batched_riccati_kernel<4, 2>", "batched_riccati_kernelILi4ELi2EE"),
    # The entry-parallel wide forms at P = 16 (B6w/B7w; B4w at n_u <= 8;
    # B1w; B3w).
    "wide_scan_kernel P=16": (
        "wide_scan_kernel<16>", "wide_scan_kernelILi16EE"),
    "wide_riccati_kernel P=16 U=8": (
        "wide_riccati_kernel<16, 8>", "wide_riccati_kernelILi16ELi8EE"),
    "wide_fused_kernel P=16": (
        "wide_fused_kernel<16>", "wide_fused_kernelILi16EE"),
    "wide_prefix_kernel P=16": (
        "wide_prefix_kernel<16>", "wide_prefix_kernelILi16EE"),
}


def chain_systems(itt, f32, integrator):
    """The chain kernels' three models under one integrator: the pendulum
    (n_x 2, n_u 1), the under-actuated (4, 1) and the fully actuated (4, 2)
    double pendulum."""
    return {
        "pendulum": itt.make_pendulum(
            0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
            Q_f=10.0 * np.eye(2), d=0.1, integrator=integrator, **f32),
        "UA-DP": dp_system(itt, f32, underactuated=True,
                           integrator=integrator),
        "DP": dp_system(itt, f32, integrator=integrator),
    }


def long_pendulum(itt, opts):
    """Phase 3's system at N = 1e5: the pendulum (rk4), damped, so that the
    open loop settles: an undamped pendulum's phase drifts by f32 rounding
    (3.8e-5 of max|X| against f64 at N = 20000 on the CPU)."""
    return itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.zeros((2, 2)), d=0.1, integrator="rk4",
                             **opts)


def long_plain_f64(X, U, u_ff, K, alphas) -> dict:
    """The plain versions of phase 3's N = 1e5 check, in f64 on the host:
    the closed loops of every alpha along (X, U, u_ff, K) from [1, 0], the
    one of alphas[1], and the open loop of U (numpy in, numpy out; run in a
    child process).  A cost is a sum over 1e5 steps, which the kernels (as
    the TPU kernels, ilqr_tpu/ops/pallas_rollout.py:117) accumulate in f32
    in time order, ~N u of it in rounding (9e-4 of the cost here): the
    costs' reference ("*32") is the plain f64 stage costs summed in f32 in
    time order, beside the f64 sums."""
    import ilqr_tpu_torch as itt
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    host64 = dict(dtype=torch.float64, device="cpu")
    pend = long_pendulum(itt, dict(dtype=torch.float32, device="cpu"))
    pend = pend.replace(params={k: v.to(**host64)
                                for k, v in pend.params.items()})

    def f32_sum(Xs, Us):
        p = pend.params
        terms = pend.stage_cost(p, Xs[..., :-1, :], Us).numpy()
        run = np.cumsum(terms.astype(np.float32), axis=-1,
                        dtype=np.float32)[..., -1]
        term = pend.terminal_cost(p, Xs[..., -1, :]).numpy()
        return np.asarray(run + term.astype(np.float32))

    x0 = torch.tensor([1.0, 0.0], **host64)
    X, U, u_ff, K, alphas = (torch.from_numpy(a).to(**host64)
                             for a in (X, U, u_ff, K, alphas))
    X_o, _ = itt.rollout(pend, x0, U)
    X_P, U_P, c_P = itt.linesearch_rollouts(pend, x0, alphas, X, U, u_ff, K)
    c_P32 = f32_sum(X_P, U_P)
    return dict(c_P=c_P.numpy(), c_P32=c_P32, X_t=X_P[1].numpy(),
                U_t=U_P[1].numpy(), c_t32=c_P32[1], X_o=X_o.numpy(),
                c_o32=f32_sum(X_o, U), seconds=time.perf_counter() - t0)


def chain_plain(integ: str, name: str, Ns, seed: int) -> dict:
    """Phase 3's inputs and plain versions for one instantiation, in f32 on
    the host (numpy out; run in a child process, where the eager loops
    take a few ms a step against tens on the card): a seeded random
    nominal near rest over max(Ns) steps, its gains at reg CHAIN_REG, the
    closed loops of every alpha of phase 3 along it, and at each N the
    costs of their prefixes and of the nominal's (the recursion is causal:
    step t reads row t of the nominal and gains)."""
    import ilqr_tpu_torch as itt
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    f32 = dict(dtype=torch.float32, device="cpu")
    system = chain_systems(itt, f32, integ)[name]
    rng = np.random.default_rng(seed)
    n_max = max(Ns)
    x0 = torch.tensor(0.3 * rng.standard_normal(system.n_x), **f32)
    U_n = torch.tensor(0.5 * rng.standard_normal((n_max, system.n_u)), **f32)
    X_n, _ = itt.rollout(system, x0, U_n)
    u_n, K_n, _, _ = itt.backward_pass(
        itt.linearize_trajectory(system, X_n, U_n), CHAIN_REG)
    alphas = torch.tensor([0.5 ** i for i in range(max(CHAIN_ALPHA_COUNTS))],
                          **f32)
    X_P, U_P, _ = itt.linesearch_rollouts(system, x0, alphas, X_n, U_n, u_n,
                                          K_n)

    def prefix_cost(X, U):
        p = system.params
        return (system.stage_cost(p, X[..., :-1, :], U).sum(-1)
                + system.terminal_cost(p, X[..., -1, :]))

    return dict(
        x0=x0.numpy(), X_n=X_n.numpy(), U_n=U_n.numpy(), u_n=u_n.numpy(),
        K_n=K_n.numpy(), X_P=X_P.numpy(), U_P=U_P.numpy(),
        c_P={N: prefix_cost(X_P[:, :N + 1], U_P[:, :N]).numpy() for N in Ns},
        c_o={N: prefix_cost(X_n[:N + 1], U_n[:N]).numpy() for N in Ns},
        seconds=time.perf_counter() - t0)


# Child processes of phase 3's plain versions (the host has 8 cores).
CHAIN_WORKERS = 6


def chain_checks(itt, dev, errors, Ns=None, long_n=BENCH_N, seed=31):
    """Phase 3: B2a, B2b and its open-loop mode against their plain versions
    in all 15 instantiations (three models, CHAIN_INTEGRATORS), at N =
    1, a chunk less one and plus one, an N that wraps the ring twice
    and ends mid-chunk, and the flagship's N = 500, with 1, 10 and 33
    alphas; the open loop of
    the UA-DP under backward Euler at newton_iters 1 and 10, where the two
    differ by ~1e-2 of max|X| (dt 0.05), so that an ignored argument shows;
    then, at N = long_n, against the plain versions in f64 on the host
    (`long_plain_f64`) on a damped pendulum (rk4, zero nominal, gains from
    B1).  The instantiations' inputs and plain versions come from
    `chain_plain`, in f32 on the host; they and the N = long_n check run
    in CHAIN_WORKERS child processes while the kernels run.  Inputs: a
    seeded random nominal near rest and its gains at reg CHAIN_REG, a
    closed loop in which f32 rounding does not grow (its plain f32 costs
    within 1e-6 of f64 on the CPU; at reg 0 the under-actuated DP's
    terminal weight gives gains near 70 and 5e-5).  Records the largest
    kernel-against-plain errors in ``errors``."""
    from ilqr_tpu_torch.ops import _build, fused_rollout

    f32 = dict(dtype=torch.float32, device=dev)
    if Ns is None:
        lib = _build.load().lib
        chunk = fused_rollout.chunk_steps(lib)
        stages = fused_rollout.ring_stages(lib)
        # N = 500 (the DP flagship's) was cut for the time limit when phase
        # 38 came: the DP's N = 500 check above and phases 4-5 hold it.
        Ns = (1, chunk - 1, chunk + 1, 2 * stages * chunk + chunk // 2 + 3)
        print(f"B2 chain kernels: a ring of {stages} stages of {chunk} "
              f"steps")
    alphas = torch.tensor([0.5 ** i for i in range(max(CHAIN_ALPHA_COUNTS))],
                          **f32)
    i_traj = 3
    rng = np.random.default_rng(seed)
    print(f"B2 chain kernels: N in {Ns}, alpha counts {CHAIN_ALPHA_COUNTS}; "
          f"tolerance max|kernel - plain| <= {RTOL_B2} * max|plain|")

    # At N = long_n: the kernels now, their plain versions in f64 in a
    # child process, beside the instantiations' plain versions.
    pend = long_pendulum(itt, f32)
    x0 = torch.tensor([1.0, 0.0], **f32)
    U = torch.zeros((long_n, 1), **f32)
    X, cost = itt.open_loop_rollout_fused(pend, x0, U)
    u_ff, K, _, _ = itt.backward_pass_fused(
        itt.linearize_trajectory(pend, X, U), 0.0)
    a10 = alphas[:10].contiguous()
    long_k = (itt.linesearch_costs_fused(pend, x0, a10, X, U, u_ff, K),
              itt.closed_loop_rollout_fused(pend, x0, float(a10[1]), X, U,
                                            u_ff, K),
              (X, cost))
    pool = multiprocessing.get_context("spawn").Pool(CHAIN_WORKERS)
    t_pool = time.perf_counter()
    plain = pool.apply_async(long_plain_f64, tuple(
        t.cpu().numpy() for t in (X, U, u_ff, K, a10)))
    cases = [(integ, name) for integ in CHAIN_INTEGRATORS
             for name in ("pendulum", "UA-DP", "DP")]
    jobs = {case: pool.apply_async(chain_plain, case + (Ns, seed + 1 + i))
            for i, case in enumerate(cases)}

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(**f32)

    def gate(kernel, label, got, ref, key=True):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"B2 {label}: non-finite kernel output")
        err, rel = rel_err(got, ref)
        if key:
            errors[kernel] = max(errors.get(kernel, 0.0), err)
        if not rel <= RTOL_B2:
            raise AssertionError(f"B2 {label}: max error {err:.3e} is "
                                 f"{rel:.3e} of max |reference| (limit "
                                 f"{RTOL_B2})")
        return rel

    host_s = 0.0
    for integ in CHAIN_INTEGRATORS:
        # The explicit instantiations' errors under the kernel's name, the
        # implicit ones' under kernel_integrator (the kernels line's rows).
        def ek(kernel):
            return kernel if integ in INTEGRATOR_EVALS else f"{kernel}_{integ}"

        for name, system in chain_systems(itt, f32, integ).items():
            ref = jobs[integ, name].get(timeout=1200)
            host_s += ref["seconds"]
            x0, X_n, U_n, u_n, K_n, X_P, U_P = (t(ref[k]) for k in (
                "x0", "X_n", "U_n", "u_n", "K_n", "X_P", "U_P"))
            worst = 0.0
            for N in Ns:
                label = f"{name} {integ} N={N}"
                X, U, u_ff, K = X_n[:N + 1], U_n[:N], u_n[:N], K_n[:N]
                X_p, U_p = X_P[:, :N + 1], U_P[:, :N]
                c_p = t(ref["c_P"][N])
                for A in CHAIN_ALPHA_COUNTS:
                    c_k = itt.linesearch_costs_fused(system, x0, alphas[:A], X,
                                                     U, u_ff, K)
                    worst = max(worst, gate(ek("linesearch_costs"),
                                            f"{label} costs, {A} alphas", c_k,
                                            c_p[:A]))
                got = itt.closed_loop_rollout_fused(
                    system, x0, float(alphas[i_traj]), X, U, u_ff, K)
                for what, g, r in zip(("X", "U", "cost"), got,
                                      (X_p[i_traj], U_p[i_traj], c_p[i_traj])):
                    worst = max(worst, gate(ek("closed_loop_rollout"),
                                            f"{label} trajectory {what}", g, r))
                got = itt.open_loop_rollout_fused(system, x0, U)
                for what, g, r in zip(("X", "cost"), got,
                                      (X, t(ref["c_o"][N]))):
                    worst = max(worst, gate(ek("open_loop_rollout"),
                                            f"{label} open loop {what}", g, r))
            print(f"B2 {name} {integ}: costs, trajectory and open loop at N "
                  f"{Ns}: max rel error {worst:.2e}")
    print(f"B2 plain versions of the 15 instantiations: {host_s:.1f} s of "
          f"host time in {CHAIN_WORKERS} child processes, "
          f"{time.perf_counter() - t_pool:.1f} s of wall time")

    # newton_iters reaches the kernels: 1 and 10 corrections, each against
    # the plain rollout at the same count.
    ua = dp_system(itt, f32, underactuated=True, integrator="backward_euler",
                   dt=0.05)
    x0 = torch.tensor([2.0, 0.0, 0.0, 0.0], **f32)
    U = torch.tensor(0.5 * rng.standard_normal((500, 1)), **f32)
    runs = {}
    for iters in (1, 10):
        sys_i = ua.replace(newton_iters=iters)
        X_k, c_k = itt.open_loop_rollout_fused(sys_i, x0, U)
        X_p, c_p = itt.rollout(sys_i, x0, U)
        rel = max(gate("open_loop_rollout_backward_euler",
                       f"UA-DP backward_euler dt 0.05 "
                       f"newton_iters {iters} open loop {w}", g, r)
                  for w, g, r in (("X", X_k, X_p), ("cost", c_k, c_p)))
        runs[iters] = (X_k, X_p, rel)
    apart_k = rel_err(runs[1][0], runs[10][0])[1]
    apart_p = rel_err(runs[1][1], runs[10][1])[1]
    print(f"B2 UA-DP backward_euler dt 0.05 open loop N=500: newton_iters 1 "
          f"and 10 each within {max(runs[1][2], runs[10][2]):.2e} of the "
          f"plain rollout; 1 against 10: kernel {apart_k:.2e}, plain "
          f"{apart_p:.2e} of max|X|")
    if not apart_k > 10 * RTOL_B2:
        raise AssertionError("B2: newton_iters 1 and 10 give the same open "
                             "loop: the kernel ignores newton_iters")

    # At the bench's length, against the plain versions in f64 on the host.
    res = plain.get(timeout=1200)
    pairs = [("costs", long_k[0], res["c_P32"])]
    pairs += [(f"trajectory {w}", g, res[r]) for w, g, r in zip(
        ("X", "U", "cost"), long_k[1], ("X_t", "U_t", "c_t32"))]
    pairs += [(f"open loop {w}", g, res[r]) for w, g, r in zip(
        ("X", "cost"), long_k[2], ("X_o", "c_o32"))]
    notes = [f"{what} {gate(None, f'pendulum rk4 N={long_n} {what}', g.cpu(), torch.from_numpy(np.asarray(r)), key=False):.1e}"
             for what, g, r in pairs]
    print(f"B2 against the plain versions in f64 on the host "
          f"({res['seconds']:.1f} s in a child process; costs summed in f32 "
          f"in time order), damped pendulum rk4 N={long_n} (zero nominal "
          f"from x0 = [1, 0], B1 gains, 10 alphas, trajectory alpha 0.5): "
          f"max rel " + ", ".join(notes) + f"; costs against the f64 sums "
          f"{rel_err(long_k[0].cpu(), torch.from_numpy(res['c_P']))[1]:.1e}")
    pool.close()
    pool.join()
    return Ns


def chain_timing(itt, dev, smi, n_short=500, n_long=BENCH_N):
    """Phase 5 for the chain kernels, in two turns, on bench.py's DP
    line-search cell (bench.py:596-605: DP euler, the rest nominal under
    zero controls, gains from its expansion by B1, alpha = 0.5^i, i < 10)
    at N = n_short and n_long; the trajectory at alpha = 1 and the open
    loop of the zero controls.  Prints each kernel's time at both N, its
    ns per step (the slope) and fixed µs (the intercept) beside its
    bound's."""
    f32 = dict(dtype=torch.float32, device=dev)
    dp = dp_system(itt, f32)
    x0 = torch.zeros(4, **f32)
    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    U = torch.zeros((n_long, 2), **f32)
    X = torch.zeros((n_long + 1, 4), **f32)   # the DP rests exactly
    u_ff, K, _, _ = itt.backward_pass_fused(
        itt.linearize_trajectory(dp, X, U), 0.0)

    def cut(n):
        return X[:n + 1], U[:n], u_ff[:n], K[:n]

    kernels = {
        "linesearch_costs": lambda n: itt.linesearch_costs_fused(
            dp, x0, alphas, *cut(n)),
        "closed_loop_rollout": lambda n: itt.closed_loop_rollout_fused(
            dp, x0, 1.0, *cut(n)),
        "open_loop_rollout": lambda n: itt.open_loop_rollout_fused(
            dp, x0, U[:n]),
    }
    t = {(name, n): [cuda_ms(lambda: fn(n), reps, 1) for _ in range(2)]
         for n, reps in ((n_short, 50), (n_long, 3))
         for name, fn in kernels.items()}
    bounds = {n: chain_bounds(4, 2, n, alphas.numel()) for n in (n_short,
                                                                n_long)}
    print(f"timing on {smi} (CUDA events, ms per call), B = 1 chain kernels "
          f"on the DP line-search cell, two turns:")
    for name in kernels:
        b_s, b_l = bounds[n_short][name][0], bounds[n_long][name][0]
        b_slope = (b_l - b_s) / (n_long - n_short) * 1e6
        ts, tl = np.mean(t[name, n_short]), np.mean(t[name, n_long])
        slope = (tl - ts) / (n_long - n_short)
        print(f"  {name}: N={n_short} {ts:.4f} "
              f"({'/'.join(f'{v:.4f}' for v in t[name, n_short])}), "
              f"N={n_long} {tl:.3f} "
              f"({'/'.join(f'{v:.3f}' for v in t[name, n_long])}), "
              f"{slope * 1e6:.1f} ns per step, "
              f"{(ts - slope * n_short) * 1e3:.2f} µs fixed; bound "
              f"{b_s:.2e} / {b_l:.2e} ms ({bounds[n_long][name][1]}), "
              f"{b_slope:.3f} ns per step")
    return t


def sass_report(lib_path, ptxas_log: str) -> list[str]:
    """The step loop of the SASS_KERNELS instantiations from
    `cuobjdump -sass`, asked for by their mangled names in the build's
    ptxas report (the whole library's SASS takes a minute), a line each: its static instruction count and its loads from
    shared (LDS), global (LDG), constant (LDC) and local (LDL) memory,
    shared and local stores (STS, STL), calls, special-function (MUFU) and barrier (SYNCS,
    BAR) instructions.  The count includes the sines' large-argument
    reductions, which run only past |angle| ~ 1e5 (their LDG read a table).
    Never fails the script; runs before the timed phases."""
    import re
    import shutil
    lines = []
    try:
        tool = (shutil.which("cuobjdump")
                or next((p for p in ("/usr/local/cuda/bin/cuobjdump",)
                         if Path(p).exists()), None))
        if tool is None:
            return ["SASS: cuobjdump not found"]
        pats = [p for ps in SASS_KERNELS.values() for p in ps]
        entries = [line.split("'")[1] for line in ptxas_log.splitlines()
                   if "Compiling entry function" in line and "'" in line]
        entries = sorted({e for e in entries if any(p in e for p in pats)})
        if not entries:
            return ["SASS: no SASS_KERNELS entry in the build"]
        out = subprocess.run([tool, "-sass", "-fun", ",".join(entries),
                              str(lib_path)],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
        bodies = re.split(r"\n\s*Function : ", out)[1:]
        names = [b.split("\n", 1)[0].strip() for b in bodies]
        filt = shutil.which("cu++filt") or shutil.which("c++filt")
        if filt:
            demangled = subprocess.run(
                [filt], input="\n".join(names), capture_output=True,
                text=True, timeout=60).stdout.splitlines()
            names = [f"{m} {d}" for m, d in zip(names, demangled)]
        for label, pats in SASS_KERNELS.items():
            for name, body in zip(names, bodies):
                hit = [p for p in pats if p in name]
                if not hit:
                    continue
                # The mode (costs 0, trajectory 1, open loop 2) and, for the
                # chain kernels, whether the runs' shifts are read at run
                # time (Lb1) or are 0 (Lb0).
                kind = name.split(hit[0], 1)[1][:13]
                bases, at, branches = [], {}, []
                for line in body.splitlines():
                    m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
                    if not m:
                        continue
                    at[int(m.group(1), 16)] = len(bases)
                    tok = m.group(2).split()
                    op = tok[1] if tok[0].startswith("@") else tok[0]
                    bases.append(op.split(".")[0])
                    b = re.search(r"\bBRA\b.*?\b0x([0-9a-f]+)\b",
                                  m.group(2))
                    if b:
                        branches.append((len(bases) - 1,
                                         int(b.group(1), 16)))
                # MUFU before each instruction: a loop's count in O(1).
                mufu = [0]
                for op in bases:
                    mufu.append(mufu[-1] + (op == "MUFU"))

                def ops(lo, hi):
                    counts = {}
                    for base in bases[lo:hi + 1]:
                        counts[base] = counts.get(base, 0) + 1
                    return counts

                # The step loop: the innermost backward branch around the
                # dynamics' MUFU (the reciprocal of det).
                loops = [(at[t], i) for i, t in branches
                         if t in at and at[t] < i
                         and mufu[i + 1] > mufu[at[t]]]
                inner = [(lo, hi) for lo, hi in loops
                         if not any(lo <= a < b <= hi and (a, b) != (lo, hi)
                                    for a, b in loops)]
                desc = []
                for lo, hi in sorted(inner):
                    c = ops(lo, hi)
                    desc.append(f"[{lo}-{hi}] {hi - lo + 1} instructions, "
                                + ", ".join(f"{k} {c.get(k, 0)}" for k in (
                                    "LDS", "STS", "LDG", "LDC", "LDL", "STL",
                                    "CALL", "MUFU", "SYNCS", "BAR")))
                lines.append(f"SASS {label} ({kind}...): {len(bases)} "
                             f"instructions; step loop "
                             + ("; ".join(desc) or "not found"))
    except Exception as exc:  # the report is informative only
        lines.append(f"SASS: report failed ({type(exc).__name__}: {exc})")
    return lines


# ---- Phase 6: the affine prefix scan (B3) -------------------------------
def random_chain(N, n, A, seed, f32):
    """A seeded contractive chain P ~ 0.9 I + 0.05 N(0, 1), drives and
    initial states ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    P = 0.9 * np.eye(n) + 0.05 * rng.standard_normal((N, n, n))
    return (torch.tensor(P, **f32),
            torch.tensor(rng.standard_normal((A, N, n)), **f32),
            torch.tensor(rng.standard_normal((A, n)), **f32))


def check_b3(itt, label, P, q, d0, errors):
    """B3 against its plain version, max|kernel - plain| <= max(RTOL_B3 *
    max|plain|, F32_FLOOR * max|plain - plain in f64|), called twice with
    equal bits required."""
    torch.cuda.synchronize()
    got = itt.affine_prefix_scan_multi(P, q, d0, engine="pallas")
    again = itt.affine_prefix_scan_multi(P, q, d0, engine="pallas")
    plain = itt.affine_prefix_scan_multi(P, q, d0, engine="xla")
    ref64 = itt.affine_prefix_scan_multi(P.double(), q.double(), d0.double(),
                                         engine="xla")
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"B3 {label} N={P.shape[0]}: a repeated call "
                             f"gave other bits")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"B3 {label}: non-finite output")
    err, rel = rel_err(got, plain)
    floor = rel_err(plain, ref64)[0]
    limit = max(RTOL_B3 * float(plain.abs().max()), F32_FLOOR * floor)
    errors["affine_prefix_scan"] = max(errors["affine_prefix_scan"], err)
    note = (f"N={P.shape[0]} n={P.shape[-1]} A={q.shape[0]}: max abs "
            f"error {err:.2e} (rel {rel:.1e}, limit {limit:.2e}; kernel "
            f"vs f64 {rel_err(got, ref64)[0]:.2e}, plain vs f64 "
            f"{floor:.2e}); repeated call bit-identical")
    if not err <= limit:
        raise AssertionError(f"B3 {label}: {note}")
    print(f"B3 {label}: {note}")


def resident_tiles(occupancy: int, label: str) -> int:
    """Tiles resident at once on the card: blocks per SM (the CUDA
    occupancy calculator's, for the kernel as built) times the SMs."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if occupancy < 1:
        raise AssertionError(f"{label}: occupancy query failed ({occupancy})")
    print(f"{label}: {occupancy} blocks per SM (cudaOccupancyMaxActiveBlocks"
          f"PerMultiprocessor) x {sms} SMs = {occupancy * sms} tiles resident")
    return occupancy * sms


def b3_checks(itt, lib, f32, errors, long_n=BENCH_N):
    """Phase 6: B3 on seeded random chains, n = 2 and 4, 1 and 10
    candidates, at N = 1, T - 1, T, T + 1 for its T-step tiles, across 5
    tile edges ending mid-tile, at T (T + 1) + 1 (T + 2 tiles: the last
    tile's predecessors take two poll rounds of T unless the first finds
    an inclusive state), at more tiles than are resident at once, at the
    DP flagship's N = 500 and at long_n."""
    from ilqr_tpu_torch.ops import affine_scan
    tile = affine_scan.tile_steps(lib, 2, 1)
    if any(affine_scan.tile_steps(lib, n, A) != tile
           for n in (2, 4) for A in (1, 10)):
        raise AssertionError("B3: the register form's tiles differ by shape")
    resident = max(resident_tiles(lib.ilqr_affine_prefix_scan_occupancy(n, A),
                                  f"B3 n={n} A={A}")
                   for n in (2, 4) for A in (1, 10))
    sizes = (1, tile - 1, tile, tile + 1, 5 * tile + tile // 2 + 3,
             tile * (tile + 1) + 1, (resident + 3) * tile + tile // 2, 500,
             long_n)
    print(f"B3 tolerance: max|kernel - plain| <= max({RTOL_B3} * max|plain|, "
          f"{F32_FLOOR} * max|plain - plain in f64|); tile {tile} steps; "
          f"horizons {sizes}")
    for N in sizes:
        for n in (2, 4):
            for A in (1, 10):
                check_b3(itt, "random chain",
                         *random_chain(N, n, A, N + 10 * n + A, f32), errors)


def one_launch_check(itt, f32) -> dict:
    """Phase 1: B1, B1d, B3, B6, B7, B4, the three B5 entries, B6 and B3
    over the batch (B3's in both forms) and the wide forms B1w, B6w, B4w, B3w, B5n and B7w each
    launch one kernel a call, and no other
    device work, by torch.profiler over five calls early in the run: at N =
    M = 600 (a seeded expansion with n_x = 4, n_u = 2, and 10 candidates),
    for B4 and B5 on a batch of 300 such expansions cut to N = 37 with the
    DP flagship's system, and for B1w and B6w at (12, 4), N = 200.  Returns the launches per
    call, {kernel: launches}, for the kernels line."""
    from ilqr_tpu_torch.ops import parallel_riccati
    rng = np.random.default_rng(3)
    N, n_x, n_u, B, N_b = 600, 4, 2, 300, 37
    W = rng.standard_normal((N, n_u, n_u))

    def t(a):
        return torch.tensor(a, **f32)

    exp = itt.TrajectoryExpansion(
        f_x=t(np.eye(n_x) + 0.05 * rng.standard_normal((N, n_x, n_x))),
        f_u=t(0.3 * rng.standard_normal((N, n_x, n_u))),
        l_x=t(rng.standard_normal((N, n_x))),
        l_u=t(rng.standard_normal((N, n_u))),
        l_xx=t(np.broadcast_to(np.eye(n_x), (N, n_x, n_x)).copy()),
        l_ux=t(0.1 * rng.standard_normal((N, n_u, n_x))),
        l_uu=t(W @ W.transpose(0, 2, 1) / n_u + np.eye(n_u)),
        v_x=t(rng.standard_normal(n_x)), v_xx=t(10.0 * np.eye(n_x)))
    gaps = t(0.01 * rng.standard_normal((N, n_x)))
    elems = parallel_riccati.make_elements(exp, 0.0)
    P, q, d0 = random_chain(N, n_x, 10, 3, f32)
    # The batch: the stage fields cut to N_b steps and repeated B times.
    exp_b = dataclasses.replace(exp, **{
        f.name: getattr(exp, f.name)[:N_b].expand(
            (B, N_b) + getattr(exp, f.name).shape[1:]).contiguous()
        for f in dataclasses.fields(exp) if f.name not in ("v_x", "v_xx")},
        v_x=exp.v_x.expand(B, n_x).contiguous(),
        v_xx=exp.v_xx.expand(B, n_x, n_x).contiguous())
    dp = dp_system(itt, f32)
    x0s = t(0.1 * rng.standard_normal((B, n_x)))
    U_b = t(0.3 * rng.standard_normal((B, N_b, n_u)))
    X_b = itt.rollout(dp, x0s, U_b)[0].contiguous()
    u_b, K_b, _, _ = itt.backward_pass_batched(exp_b, 1.0)
    elems_b = parallel_riccati.make_elements(exp_b, 0.0)
    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    alpha_b = alphas[torch.arange(B, device=alphas.device) % alphas.numel()]
    cases = {
        "fused_riccati": lambda: itt.backward_pass_fused(exp, 0.0),
        "fused_riccati_defects": lambda: itt.backward_pass_fused(
            exp, 0.0, gaps),
        "affine_prefix_scan": lambda: itt.affine_prefix_scan_multi(
            P, q, d0, engine="pallas"),
        "suffix_scan": lambda: itt.suffix_scan_fused(elems, "sub"),
        "suffix_scan_lane": lambda: itt.suffix_scan_fused(elems, "lane"),
        # B6 over the batch: B = 300 sequences of N_b + 1 elements.
        "suffix_scan_batched": lambda: itt.suffix_scan_fused(elems_b),
        # B3 over the batch: 16 chains of N steps at n = 4 (the register
        # form) and 4 at n = 12 (the wide form), 10 candidates.
        "affine_prefix_scan_batched": lambda: itt.affine_prefix_scan_batched(
            *chains_b, engine="pallas"),
        "affine_prefix_scan_batched_wide": lambda: (
            itt.affine_prefix_scan_batched(*chains_bw, engine="pallas")),
        "batched_riccati": lambda: itt.backward_pass_batched(exp_b, 0.1),
        "linesearch_costs_batched": lambda: itt.linesearch_costs_batched(
            dp, x0s, alphas, X_b, U_b, u_b, K_b),
        "closed_loop_rollout_batched": lambda: itt.closed_loop_rollout_batched(
            dp, x0s, alpha_b, X_b, U_b, u_b, K_b),
        "open_loop_rollout_batched": lambda: itt.open_loop_rollout_batched(
            dp, x0s, U_b),
        # The wide forms (B1w, B6w) at the 3-D quadrotor's (12, 4).
        "fused_riccati_wide": lambda: itt.backward_pass_fused(exp_w, 0.0),
        "suffix_scan_wide": lambda: itt.suffix_scan_fused(elems_w, "sub"),
        # B4w, B3w and B5n at the 3-D quadrotor's (12, 4), rk4.
        "batched_riccati_wide": lambda: itt.backward_pass_batched(exp_bw,
                                                                  0.1),
        "affine_prefix_scan_wide": lambda: itt.affine_prefix_scan_multi(
            P_w, q_w, d0_w, engine="pallas"),
        "linesearch_costs_batched_models": lambda: (
            itt.linesearch_costs_batched(q3, *nom_w[:1], alphas,
                                         *nom_w[1:])),
        "closed_loop_rollout_batched_models": lambda: (
            itt.closed_loop_rollout_batched(q3, nom_w[0], alpha_b[:16],
                                            *nom_w[1:])),
        "open_loop_rollout_batched_models": lambda: (
            itt.open_loop_rollout_batched(q3, nom_w[0], nom_w[2])),
        # B7w at n = 12.
        "suffix_scan_lane_wide": lambda: itt.suffix_scan_fused(elems_w,
                                                               "lane"),
    }
    exp_w = random_expansion(itt, 200, 12, 4, 5, f32)
    elems_w = parallel_riccati.make_elements(exp_w, 0.0)
    exp_bw = batched_random_expansion(itt, 64, 40, 12, 4, 6, f32)
    P_w, q_w, d0_w = random_chain(N, 12, 10, 4, f32)
    chains_b = random_chains(16, N, n_x, 10, 5, f32)
    chains_bw = random_chains(4, N, 12, 10, 6, f32)
    q3 = wide_model_systems(itt, f32, "rk4")["quadrotor3d"]
    nom_w = model_batch(q3, "quadrotor3d", 16, N_b, 9, f32)
    out = {}
    for name, fn in cases.items():
        rec = device_us(fn, 5)
        launches = sum(v[1] for v in rec.values())
        kinds = "; ".join(f"{kernel_name(k)} x {v[1]:g}"
                          for k, v in rec.items())
        print(f"{name}: {launches:g} launches a call (torch.profiler) "
              f"[{kinds}]")
        if launches != 1:
            raise AssertionError(f"{name}: {launches:g} launches a call, "
                                 f"expected 1")
        out[name] = launches
    return out


# Phases 18-21: the standalone suffix scan (B6, B7) and the limited, DDP and
# iLQG paths.
# B6/B7 tolerance: B1's, field by field: max|kernel - plain| <=
# max(RTOL_B6 * max|plain|, F32_FLOOR * max|plain - plain in f64|).  Both
# are f32 suffix scans of the same elements in other association orders
# (blocks of 256 or 128 with a carried element against doubling over the
# whole horizon).
RTOL_B6 = 5e-4
LIMITED_N = 32768            # bench.py:620-642, the limited-backward cell
SCAN_MS = (1411, 32769, 131073)
# The sequential limited pass is a host loop of N box QPs (8 projected-Newton
# iterations each): it runs at this cut horizon (1024 until phase 37 came;
# 9.3 s a pass there on the card, three passes; at 640 steps 171 controls
# clamp under ±SEQ_TIGHT_LIMIT, the same in f32 and f64 on a CPU).
SEQ_CUT_N = 640
# Phase 19/20: the limited passes' outputs, kernel engine against the plain
# engine, field by field within max(RTOL_LIMITED * max|plain|, F32_FLOOR *
# max|plain - plain in f64|): the same sweeps on f32 scans in other orders;
# a control whose set membership flips at a bound moves its own entries, so
# the engines must also end with the same clamped set.
RTOL_LIMITED = 5e-4
# Phases 19/20: the bench cell clamps nothing within ±2; under ±1 on the
# same expansion (the nominal clipped to them) about a quarter of the 32768
# controls end clamped, the same ones in f32 and f64 (CPU, torch).
TIGHT_LIMIT = 1.0
# Phase 19: the sequential box-QP pass against the parallel pass's fixed
# point at the cut horizon (the same KKT point; f32 in other orders), and
# the sequential pass in f32 against f64 under ±0.5, where about a quarter
# of the cut's controls clamp (its first steps barely reach ±1).
RTOL_SEQ = 1e-3
SEQ_TIGHT_LIMIT = 0.5
# Phase 21: the limited-DDP double-pendulum swing-up with backward='scan'
# (the sequential box-QP/DDP recursion, a host loop of 150 box QPs an
# iteration) reached CONVERGED at this cost in 86 iterations and 66 s on an
# H100 (NVIDIA H100 80GB HBM3, 700 W), and after 40 iterations still cost
# 202.6: too slow to run here, it is held as a golden value, as
# DP_GOLDEN_COST is.  The torque-limited swing-up has neighbouring basins
# (45.6 and 57.3, tests/test_limited_parallel.py:153-161); a stall costs
# more than 200.
DP_LIMITED_SEQ_COST = 45.607353
# Phase 21's two other sequential references are the JAX package's f32
# results on a CPU (ilqr_tpu 07c4af6, jax.jit, x86 host; recomputed and
# compared by tests/test_torch_chip_refs.py), as JAX_F32 is: the
# torque-limited pendulum's sequential box-QP solve and the DDP pendulum's
# sequential solve (backward='scan' both).  The port's own sequential
# solves take 23.7 s and 10.2 s on the card (NVIDIA H100 80GB HBM3, 700 W),
# too long to keep inside the script's time with phases 26-30.
LIMITED_PEND_SEQ_COST = 182.7090606689453
DDP_PEND_SEQ_COST = 36.416297912597656


def limited_cell(itt, f32, N, model="pendulum"):
    """bench.py's limited-backward cell at horizon N: the pendulum (rk4,
    dt 0.01, Q = I, R = I, Q_f = 0, d = 0) along
    U = clip(2.5 sin(linspace(0, 40, N)), -2, 2), or the double pendulum
    (euler) along the same controls on both joints.  The nominal comes from
    B5's open-loop rollout.  Returns (system, X, U, expansion)."""
    if model == "pendulum":
        system = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2),
                                   R=np.eye(1), Q_f=np.zeros((2, 2)), d=0.0,
                                   integrator="rk4", **f32)
    else:
        system = dp_system(itt, f32)
    U = torch.clamp(2.5 * torch.sin(torch.linspace(0.0, 40.0, N, **f32)),
                    -2.0, 2.0)[:, None].expand(N, system.n_u).contiguous()
    X = itt.open_loop_rollout_batched(
        system, torch.zeros((1, system.n_x), **f32), U[None])[0][0]
    return system, X.contiguous(), U, itt.linearize_trajectory(system, X, U)


def as_f64(obj):
    """A dataclass or NamedTuple of tensors in float64."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).double()
            for f in dataclasses.fields(obj)})
    return type(obj)(*(t.double() for t in obj))


def clamped_set(U_old, out, u_lo, u_hi):
    """The controls a limited backward pass (u_ff, K, ...) left clamped: the
    new control at a bound and the feedback row zero."""
    u_ff, K = out[0], out[1]
    u_new = U_old + u_ff
    at = lambda b: (u_new - b).abs() <= 1e-5 * (1.0 + abs(b))  # noqa: E731
    return (at(u_lo) | at(u_hi)) & (K.abs().amax(-1) == 0)


def check_fields(label, got, plain, ref64, rtol, errors=None, key=None):
    """Field-by-field gate of a kernel's outputs (a RiccatiElement, or the
    (u_ff, K, dV) of a backward pass): max|got - plain| <= max(rtol *
    max|plain|, F32_FLOOR * max|plain - ref64|).  Records the largest error
    in errors[key]; returns one note per field."""
    notes = []
    names = getattr(got, "_fields", ("u_ff", "K", "dV"))
    for name, g, p, r in zip(names, got, plain, ref64):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: {name} not finite")
        err, rel = rel_err(g, p)
        floor = rel_err(p, r)[0]
        limit = max(rtol * float(p.abs().max()), F32_FLOOR * floor)
        if errors is not None:
            errors[key] = max(errors[key], err)
        notes.append(f"{name} {err:.2e} (rel {rel:.1e}, limit {limit:.2e}; "
                     f"plain vs f64 {floor:.2e})")
        if not err <= limit:
            raise AssertionError(f"{label}: {notes[-1]}")
    return notes


def scan_phase(itt, lib, f32, smi, N_lim, Ms, errors):
    """Phase 18: B6 and B7 against the plain scan on the elements of real
    expansions (the limited cell's pendulum and double pendulum, tiled
    along time), all five fields, every call made twice with equal bits
    required: at each layout's tile edges (M = 1, T - 1, T, T + 1), across
    5 tile edges ending mid-tile, at T (T + 1) + 1 elements (T + 2 tiles:
    two poll rounds unless the first finds an inclusive element) and at
    more tiles than are resident at once, without the terminal element
    (windowed products in every field); then at Ms with and without it.
    The largest errors go to ``errors``.  Then each layout is timed at the
    limited pendulum solve's M = 301, the limited-DDP double-pendulum
    solve's M = 151, the limited cell's N_lim + 1 and the double
    pendulum's Ms[-1].
    Returns the cells, the timings {layout: {label: design_timing case}}
    and the plain scan's CUDA-event ms {label: ms}."""
    from ilqr_tpu_torch.ops import parallel_riccati, suffix_scan
    from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

    print(f"B6/B7 tolerance: field by field, max|kernel - plain| <= "
          f"max({RTOL_B6} * max|plain|, {F32_FLOOR} * max|plain - plain in "
          f"f64|)")
    cells = {name: limited_cell(itt, f32, N_lim, name)
             for name in ("pendulum", "double_pendulum")}

    def elements(exp, M, terminal):
        # With the terminal element every suffix has A = b = C = 0 (the
        # terminal's), as on the path; the stage elements alone give
        # windowed products in all five fields.
        elems = parallel_riccati.make_elements(
            tile_expansion(exp, M - 1 if terminal else M), 0.0)
        return RiccatiElement(*(t[:M].contiguous() for t in elems))

    def check(label, elems, layouts):
        plain = parallel_riccati.suffix_scan(elems)
        ref64 = parallel_riccati.suffix_scan(as_f64(elems))
        for layout in layouts:
            key = "suffix_scan_lane" if layout == "lane" else "suffix_scan"
            torch.cuda.synchronize()
            got = itt.suffix_scan_fused(elems, layout)
            again = itt.suffix_scan_fused(elems, layout)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"B6/B7 {label} {layout}: a repeated "
                                     f"call gave other bits")
            notes = check_fields(f"B6/B7 {label} {layout}", got, plain,
                                 ref64, RTOL_B6, errors, key)
            print(f"{'B6' if layout == 'sub' else 'B7'} {label}: "
                  + "; ".join(notes) + "; repeated call bit-identical")

    for layout in ("sub", "lane"):
        lane = int(layout == "lane")
        T = suffix_scan.tile_steps(lib, layout, 2)
        if suffix_scan.tile_steps(lib, layout, 4) != T:
            raise AssertionError(f"{layout}: tiles differ at n = 2 and 4")
        resident = max(resident_tiles(lib.ilqr_suffix_scan_occupancy(lane, n),
                                      f"{'B7' if lane else 'B6'} n_x={n}")
                       for n in (2, 4))
        sizes = (1, T - 1, T, T + 1, 5 * T + T // 2 + 3, T * (T + 1) + 1,
                 (resident + 3) * T + T // 2)
        print(f"{'B7' if lane else 'B6'} ({layout}): tile {T} elements; "
              f"M {sizes}")
        for name, (_, _, _, exp) in cells.items():
            for M in sizes:
                check(f"{name} M={M} stages only", elements(exp, M, False),
                      (layout,))
    for name, (_, _, _, exp) in cells.items():
        for M in Ms:
            for kind, terminal in (("with terminal", True),
                                   ("stages only", False)):
                check(f"{name} M={M} {kind}", elements(exp, M, terminal),
                      ("sub", "lane"))

    timed = {"pendulum M=301": elements(cells["pendulum"][3], 301, True),
             "DP M=151": elements(cells["double_pendulum"][3], 151, True),
             f"pendulum M={N_lim + 1}": elements(cells["pendulum"][3],
                                                  N_lim + 1, True),
             f"DP M={Ms[-1]}": elements(cells["double_pendulum"][3], Ms[-1],
                                        True)}

    timings = {
        layout: design_timing(smi, kernel, {
            label: lambda el=el, ly=layout: itt.suffix_scan_fused(el, ly)
            for label, el in timed.items()})
        for layout, kernel in (("sub", "B6"), ("lane", "B7"))}
    t_plain = {label: cuda_ms(lambda el=el: parallel_riccati.suffix_scan(el),
                              3, 1) for label, el in timed.items()}
    print(f"timing on {smi} (CUDA events, ms per call):")
    for label, tp in t_plain.items():
        print(f"  suffix scan {label}: "
              + ", ".join(f"{k} {timings[ly][label]['event_ms']:.4f} "
                          f"(device "
                          f"{ms_text(timings[ly][label]['device_us'])})"
                          for ly, k in (("sub", "B6"), ("lane", "B7")))
              + f", plain {tp:.4f}")
    return cells, timings, t_plain


def suffix_phases(itt, dev, smi, launches_per_call, N_lim=LIMITED_N,
                  Ms=SCAN_MS, seq_cut=SEQ_CUT_N, solve_scale=1.0):
    """Phases 18-21: B6 and B7 against the plain scan, the bench's limited
    and limited-DDP backward cells at full size, and solves through
    ``solve(..., backward='pallas')`` with limits, DDP and adaptive_reg.
    ``solve_scale`` scales the solves' iteration budgets (1 on the GPU).
    ``launches_per_call`` is phase 1's count, {kernel: launches}.
    Returns the kernels line's entries of B6 and B7."""
    from ilqr_tpu_torch.ops import _build, limited_parallel

    f32 = dict(dtype=torch.float32, device=dev)
    errors = {"suffix_scan": 0.0, "suffix_scan_lane": 0.0}
    t_start = t_lap = time.perf_counter()

    def lap(phase: int) -> None:
        nonlocal t_lap
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_lap:.1f} s")
        t_lap = now

    # ---- 18. B6 and B7 against the plain scan ------------------------------
    cells, t_scan, t_plain = scan_phase(itt, _build.load().lib, f32, smi,
                                        N_lim, Ms, errors)
    lap(18)

    # ---- 19. the limited-backward cell at full size (bench.py:620-642) -----
    pend, X_l, U_l, exp_l = cells["pendulum"]
    lo, hi = -2.0, 2.0

    def sweeps_of(fn):
        """fn() and the number of suffix scans it ran (one per sweep, plus
        the seed of a second-order run)."""
        calls = [0]
        plain_values = limited_parallel._suffix_values

        def counted(*args, **kw):
            calls[0] += 1
            return plain_values(*args, **kw)

        limited_parallel._suffix_values = counted
        try:
            out = fn()
        finally:
            limited_parallel._suffix_values = plain_values
        return out, calls[0]

    engine_counts = {}

    def limited_engines(label, U_old, u_lo, u_hi, hess=None, min_clamped=0):
        """Both engines of the parallel limited pass on the limited cell's
        expansion, field by field against each other (f64 floor), with the
        same clamped set; fails if fewer than ``min_clamped`` controls
        end clamped."""
        out, sweeps, sets = {}, {}, {}
        for engine in ("pallas", "xla"):
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            out[engine], sweeps[engine] = sweeps_of(
                lambda: itt.backward_pass_limited_parallel(
                    exp_l, U_old, u_lo, u_hi, 0.0, engine=engine, hess=hess))
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            if engine == "pallas":
                engine_counts[label] = counts
            if (engine == "pallas"
                    and counts.get("suffix_scan", 0) != sweeps[engine]):
                raise AssertionError(f"{label} (pallas): suffix_scan launched "
                                     f"{counts.get('suffix_scan', 0)} times "
                                     f"in {sweeps[engine]} scans")
            sets[engine] = clamped_set(U_old, out[engine], u_lo, u_hi)
        exp64 = as_f64(exp_l)
        ref64, sweeps64 = sweeps_of(
            lambda: itt.backward_pass_limited_parallel(
                exp64, U_old.double(), u_lo, u_hi, 0.0, engine="xla",
                hess=None if hess is None else as_f64(hess)))
        set64 = clamped_set(U_old.double(), ref64, u_lo, u_hi)
        n_clamped = {e: int(s.sum()) for e, s in sets.items()}
        n_clamped["f64"] = int(set64.sum())
        if not bool(torch.equal(sets["pallas"], sets["xla"])):
            raise AssertionError(f"{label}: the engines' clamped sets differ "
                                 f"({n_clamped})")
        if n_clamped["pallas"] < min_clamped:
            raise AssertionError(f"{label}: {n_clamped['pallas']} controls "
                                 f"clamped, fewer than {min_clamped}")
        # A control whose set differs in f64 moves the values of every step
        # before it, not rounding: then the limit is RTOL_LIMITED alone.
        same_set = bool(torch.equal(sets["xla"], set64))
        floor_ref = (ref64[:3] if same_set
                     else tuple(t.double() for t in out["xla"][:3]))
        notes = check_fields(label, out["pallas"][:3], out["xla"][:3],
                             floor_ref, RTOL_LIMITED)
        if not same_set:
            notes.append(f"the f64 set differs, so each limit is "
                         f"{RTOL_LIMITED} * max|plain| alone")
        if not bool(out["pallas"][3]):
            raise AssertionError(f"{label}: non-finite gains")
        t = {e: cuda_ms(lambda: itt.backward_pass_limited_parallel(
            exp_l, U_old, u_lo, u_hi, 0.0, engine=e, hess=hess), 2, 1)
            for e in ("pallas", "xla")}
        print(f"{label} N={N_lim}, limits [{u_lo}, {u_hi}]: controls clamped "
              f"{n_clamped}; scans kernel {sweeps['pallas']}, plain "
              f"{sweeps['xla']}, f64 {sweeps64}; {t['pallas']:.2f} ms with "
              f"B6, {t['xla']:.2f} ms plain; kernel vs plain "
              + "; ".join(notes))
        return out

    # The bench cell clamps nothing: its nominal's optimal step pulls every
    # control inside ±2, so its one sweep is the unconstrained masked pass.
    limited_engines("limited backward", U_l, lo, hi)
    # The same expansion under tighter limits, the nominal clipped to them:
    # a mixed active set, clamp deltas and set updates over several sweeps.
    U_t = U_l.clamp(-TIGHT_LIMIT, TIGHT_LIMIT).contiguous()
    limited_engines("limited backward (tight)", U_t, -TIGHT_LIMIT,
                    TIGHT_LIMIT, min_clamped=N_lim // 10)
    # The sequential box-QP pass at a cut horizon, against both engines'
    # fixed points on the same expansion (nothing clamps there).
    exp_c = dataclasses.replace(exp_l, **{
        f: getattr(exp_l, f)[:seq_cut].contiguous() for f in
        ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu")})
    exp_c = dataclasses.replace(exp_c, v_x=torch.zeros(2, **f32),
                                v_xx=torch.zeros((2, 2), **f32))
    U_c = U_l[:seq_cut].contiguous()
    t0 = time.perf_counter()
    seq = itt.backward_pass_limited(exp_c, U_c, lo, hi, 0.0)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    n_seq = int(clamped_set(U_c, seq, lo, hi).sum())
    for engine in ("pallas", "xla"):
        par = itt.backward_pass_limited_parallel(exp_c, U_c, lo, hi, 0.0,
                                                 engine=engine)
        for name, a, b in zip(("u_ff", "K", "dV"), par, seq):
            err, rel = rel_err(a, b)
            if not rel <= RTOL_SEQ:
                raise AssertionError(
                    f"limited backward N={seq_cut}: {engine} {name} differs "
                    f"from the sequential pass by {err:.2e} ({rel:.1e} of "
                    f"max|sequential|, limit {RTOL_SEQ})")
        print(f"limited backward cut to N={seq_cut}: the {engine} engine "
              f"agrees with the sequential box-QP pass ({seq_s:.2f} s, "
              f"{n_seq} controls clamped) to rel {RTOL_SEQ}")
    # The sequential pass with an active set: the parallel pass's fixed point
    # is not the box QPs' there (the JAX package's too: their sets differ by
    # a few percent), so the card's f32 pass is held to the f64 pass.
    U_s = U_c.clamp(-SEQ_TIGHT_LIMIT, SEQ_TIGHT_LIMIT).contiguous()
    seq = itt.backward_pass_limited(exp_c, U_s, -SEQ_TIGHT_LIMIT,
                                    SEQ_TIGHT_LIMIT, 0.0)
    seq64 = itt.backward_pass_limited(as_f64(exp_c), U_s.double(),
                                      -SEQ_TIGHT_LIMIT, SEQ_TIGHT_LIMIT, 0.0)
    sets = [clamped_set(u, out, -SEQ_TIGHT_LIMIT, SEQ_TIGHT_LIMIT)
            for u, out in ((U_s, seq), (U_s.double(), seq64))]
    n_seq = int(sets[0].sum())
    if not (torch.equal(*sets) and n_seq >= seq_cut // 10):
        raise AssertionError(f"sequential limited pass N={seq_cut}, limits "
                             f"±{SEQ_TIGHT_LIMIT}: {n_seq} controls clamped "
                             f"in f32, {int(sets[1].sum())} in f64")
    for name, a, b in zip(("u_ff", "K", "dV"), seq, seq64):
        err, rel = rel_err(a, b)
        if not rel <= RTOL_SEQ:
            raise AssertionError(
                f"sequential limited pass N={seq_cut}, limits "
                f"±{SEQ_TIGHT_LIMIT}: {name} differs from f64 by {err:.2e} "
                f"({rel:.1e} of max|f64|, limit {RTOL_SEQ})")
    print(f"sequential limited pass N={seq_cut}, limits ±{SEQ_TIGHT_LIMIT}: "
          f"{n_seq} controls clamped, as in f64; f32 agrees with f64 to rel "
          f"{RTOL_SEQ}")
    lap(19)

    # ---- 20. the limited-DDP cell at full size (bench.py:644-666) ----------
    hess = itt.dynamics_hessians(pend, X_l, U_l)
    limited_engines("limited DDP backward", U_l, lo, hi, hess=hess)
    limited_engines("limited DDP backward (tight)", U_t, -TIGHT_LIMIT,
                    TIGHT_LIMIT, hess=hess, min_clamped=N_lim // 10)
    out = {}
    for engine in ("pallas", "xla"):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out[engine] = itt.backward_pass_ddp_parallel(exp_l, 0.0, hess=hess,
                                                     engine=engine)
        torch.cuda.synchronize()
        if (engine == "pallas"
                and _build.launch_counts().get("suffix_scan", 0) != 4):
            raise AssertionError("DDP parallel backward: suffix_scan not "
                                 "launched once per sweep (4)")
    ref64 = itt.backward_pass_ddp_parallel(as_f64(exp_l), 0.0,
                                           hess=as_f64(hess), engine="xla")
    notes = check_fields("DDP parallel backward", out["pallas"][:3],
                   out["xla"][:3], ref64[:3], RTOL_LIMITED)
    t = {e: cuda_ms(lambda: itt.backward_pass_ddp_parallel(
        exp_l, 0.0, hess=hess, engine=e), 2, 1) for e in ("pallas", "xla")}
    print(f"DDP parallel backward N={N_lim} (3 sweeps): {t['pallas']:.2f} ms "
          f"with B6, {t['xla']:.2f} ms plain; kernel vs plain "
          + "; ".join(notes))
    lap(20)

    # ---- 21. solves through solve(..., backward='pallas') ------------------
    def timed_solve(system, x0, N, cfg, kernels=()):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        sol = itt.solve(system, x0, torch.zeros((N, system.n_u), **f32), cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        for kernel in kernels:
            if counts.get(kernel, 0) < 1:
                raise AssertionError(f"solve ({cfg.backward}, {cfg.rollout})"
                                     f" never launched {kernel}")
        return sol, wall, counts

    def report(label, sol, wall, counts):
        print(f"{label}: status {sol.status}, {sol.iterations} iterations, "
              f"cost {float(sol.cost):.6f}, max|U| "
              f"{float(sol.U.abs().max()):.6f}, {wall:.2f} s, launches "
              f"{counts}")

    def iters(n):
        return max(1, int(n * solve_scale))

    # The torque-limited pendulum (tests/test_limited_parallel.py:66-79).
    tl_pend = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2),
                                R=0.1 * np.eye(1), Q_f=100.0 * np.eye(2),
                                d=0.0, integrator="rk4", **f32)
    base = dict(maxiter=iters(200), tol=1e-7, u_min=-2.0, u_max=2.0)
    x0 = torch.zeros(2, **f32)
    print(f"limited pendulum N=300: the sequential box-QP solve's cost "
          f"{LIMITED_PEND_SEQ_COST} is the JAX package's f32 result")
    limited_launches = None
    for rollout, kernels in (("scan", ("suffix_scan",)),
                             ("defect", ("suffix_scan",
                                         "affine_prefix_scan"))):
        sol, wall, counts = timed_solve(
            tl_pend, x0, 300, itt.IlqrConfig(backward="pallas",
                                             rollout=rollout, **base),
            kernels)
        report(f"limited pendulum N=300 (pallas/{rollout})", sol, wall,
               counts)
        if limited_launches is None:
            limited_launches = counts
        if not (float(sol.U.abs().max()) <= 2.0 + 1e-5
                and float(sol.cost) <= 1.01 * LIMITED_PEND_SEQ_COST):
            raise AssertionError(f"limited pendulum (pallas/{rollout}): cost "
                                 f"above 1.01 x sequential or |U| > 2")
    # The limited-DDP double-pendulum swing-up (:132-161), the full-width
    # system of this slice.
    dp2 = itt.make_double_pendulum(
        0.02, [np.pi, 0, 0, 0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1, 0.1]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler",
        **f32)
    base = dict(maxiter=iters(200), tol=1e-7, u_min=-12.0, u_max=12.0,
                ddp=True, adaptive_reg=True)
    x0 = torch.zeros(4, **f32)
    sol, wall, ddp_dp_launches = timed_solve(
        dp2, x0, 150, itt.IlqrConfig(backward="pallas", **base),
        ("suffix_scan",))
    report("limited DDP DP N=150 (pallas)", sol, wall, ddp_dp_launches)
    print(f"limited DDP DP: final angles {sol.X[-1, :2].tolist()}; the "
          f"sequential solve's cost {DP_LIMITED_SEQ_COST} is a golden value "
          f"(not run here)")
    if not (sol.status == itt.CONVERGED
            and float(sol.U.abs().max()) <= 12.0 + 1e-4
            and float(sol.cost) <= 1.5 * DP_LIMITED_SEQ_COST):
        raise AssertionError(f"limited DDP DP (pallas): not CONVERGED, |U| > "
                             f"12 or cost above 1.5 x {DP_LIMITED_SEQ_COST}")
    # DDP on the pendulum with the parallel backward (tests/test_ddp.py:
    # 138-150).
    ddp_pend = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2),
                                 R=np.eye(1), Q_f=100.0 * np.eye(2), d=0.1,
                                 integrator="rk4", **f32)
    base = dict(maxiter=iters(150), tol=1e-8, ddp=True, adaptive_reg=True,
                reg_init=1e-6)
    x0 = torch.zeros(2, **f32)
    print(f"DDP pendulum N=300: the sequential solve's cost "
          f"{DDP_PEND_SEQ_COST} is the JAX package's f32 result")
    sol, wall, counts = timed_solve(
        ddp_pend, x0, 300, itt.IlqrConfig(backward="pallas", ddp_sweeps=4,
                                          **base), ("suffix_scan",))
    report("DDP pendulum N=300 (pallas, 4 sweeps)", sol, wall, counts)
    rel = abs(float(sol.cost) - DDP_PEND_SEQ_COST) / DDP_PEND_SEQ_COST
    if not (sol.status == itt.CONVERGED and rel <= 1e-4):
        raise AssertionError(f"DDP pendulum (pallas): not CONVERGED or cost "
                             f"{rel:.2e} from JAX's sequential (limit 1e-4)")
    # B7's path: the backward pass through the lane-layout scan
    # (`backward_pass_suffix_scan(layout='lane')`, JAX's
    # backward_pass_pallas(layout='lane')) on the limited cell's expansion.
    plain = itt.backward_pass_associative(exp_l, 0.0)
    ref64 = itt.backward_pass_associative(as_f64(exp_l), 0.0)
    lane_launches = None
    for layout, kernel in (("lane", "suffix_scan_lane"),
                           ("sub", "suffix_scan")):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = itt.backward_pass_suffix_scan(exp_l, 0.0, layout=layout)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        if counts.get(kernel, 0) != 1:
            raise AssertionError(f"backward_pass_suffix_scan({layout}) "
                                 f"launched {counts}")
        if layout == "lane":
            lane_launches = counts
        notes = check_fields(f"backward through the {layout} scan", got[:3],
                       plain[:3], ref64[:3], RTOL_B6)
        print(f"backward_pass_suffix_scan(layout={layout!r}) N={N_lim}: "
              f"launches {counts}; against the plain pass "
              + "; ".join(notes))
    lap(21)
    print(f"phases 18-21: {time.perf_counter() - t_start:.1f} s")

    def suffix_bound(M, n_x):
        F = 3 * n_x * n_x + 2 * n_x
        return bound(2 * M * F * 4, M * combine_ops(n_x))

    def row(name, replaces, layout, label, M, launches, err_key, n_x=2):
        ms, more = timing_columns(t_scan[layout][label],
                                  launches_per_call[err_key])
        b_ms, b_by = suffix_bound(M, n_x)
        return dict(name=name, route="cuda",
                    source="ilqr_tpu_torch/csrc/suffix_scan.cu",
                    replaces=replaces, launches=launches,
                    max_abs_err=errors[err_key], ms=ms,
                    plain_ms=t_plain[label], bound_ms=b_ms, bound_by=b_by,
                    library_ms=None, **more)

    # B6 at the limited pendulum solve's shape, with that solve's launches,
    # at the limited-DDP double-pendulum solve's, with its launches, and at
    # the limited cell's, with its pass's; B7 at the shape of its path (the
    # lane-layout backward pass on the limited cell).
    sub, lane_kernel = ("ilqr_tpu/ops/pallas_riccati.py:515",
                        "ilqr_tpu/ops/pallas_riccati.py:271")
    return [
        row("suffix_scan_sub", sub, "sub", "pendulum M=301", 301,
            limited_launches.get("suffix_scan", 0), "suffix_scan"),
        row("suffix_scan_sub_dp_m151", sub, "sub", "DP M=151", 151,
            ddp_dp_launches.get("suffix_scan", 0), "suffix_scan", n_x=4),
        row(f"suffix_scan_sub_m{N_lim + 1}", sub, "sub",
            f"pendulum M={N_lim + 1}", N_lim + 1,
            engine_counts["limited backward"].get("suffix_scan", 0),
            "suffix_scan"),
        row("suffix_scan_lane", lane_kernel, "lane", f"pendulum M={N_lim + 1}",
            N_lim + 1, lane_launches.get("suffix_scan_lane", 0),
            "suffix_scan_lane"),
    ]


def dp_gates(itt, sol, label, launches, kernels):
    """Phase 4's gates of a DP flagship solve (tests/test_solver.py:88-92)."""
    trace = sol.cost_trace[:sol.iterations].cpu().numpy()
    cost = float(sol.cost)
    # Status gate.  tol = 1e-6 is below the f32 resolution of a cost
    # near 37 (one ulp is 3.8e-6), so a solve at its f32 floor stops
    # either by an exactly repeated cost (CONVERGED) or by a line search
    # in which no candidate beats the current cost by rounding
    # (LINESEARCH_FAILED).  The latter counts only when the last
    # accepted step moved the cost by at most 8 ulp.
    last_step = (abs(float(trace[-1] - trace[-2])) if len(trace) > 1
                 else np.inf)
    at_floor = last_step <= 8 * float(np.spacing(np.float32(cost)))
    if not (sol.status in (itt.CONVERGED, itt.MAXITER)
            or (sol.status == itt.LINESEARCH_FAILED and at_floor)):
        raise AssertionError(f"{label} ended with status {sol.status}, "
                             f"last accepted step {last_step:.3e}")
    if not np.all(np.diff(trace) <= 0):
        raise AssertionError(f"{label}: cost trace increased")
    if not cost <= 1.02 * DP_GOLDEN_COST:
        raise AssertionError(
            f"{label}: cost {cost} above 1.02 x {DP_GOLDEN_COST}")
    ang_err = (sol.X[-1, :2]
               - torch.tensor([np.pi, 0.0], dtype=sol.X.dtype,
                             device=sol.X.device)).abs().max()
    if not float(ang_err) <= 0.2:
        raise AssertionError(f"{label}: final angles "
                             f"{sol.X[-1, :2].tolist()} not within 0.2 "
                             f"of the target")
    if not (torch.isfinite(sol.X).all() and torch.isfinite(sol.U).all()
            and sol.X.shape == (501, 4) and sol.U.shape == (500, 2)):
        raise AssertionError(f"{label}: solution not finite or of the "
                             f"wrong shape")
    for kernel in kernels:
        if launches.get(kernel, 0) < 1:
            raise AssertionError(f"{label} never launched {kernel}")
    print(f"{label} gates passed: cost {cost:.4f} <= "
          f"{1.02 * DP_GOLDEN_COST:.4f}, final angle error "
          f"{float(ang_err):.2e}, trace non-increasing")


# Phases 22-25: the facade, the drivers and the constrained solvers.  The
# reference results they are held to are the JAX package's f32 results on
# a CPU (examples/constrained_pendulum.py at full size: cost 40.55818 by
# backward='scan', and 40.02849 by the barrier on the box alone
# (`ilqr_tpu.barrier.solve_barrier`, CONVERGED after 168 inner
# iterations); examples/constrained_mpc.py cut to MPC_STEPS = 10 steps:
# closed-loop costs 58.79672 by AL and 58.40961 by the barrier; 73.1158
# and 71.9151 at 20).
AL_PENDULUM_COST = 40.5582
BARRIER_PENDULUM_COST = 40.02849
RTOL_AL = 1e-3
AL_MPC_COST = {"AL": 58.79672, "barrier": 58.40961}
RTOL_AL_MPC = 1e-2


@contextlib.contextmanager
def counting(module, name: str):
    """Count the calls of ``module.name`` (a backward pass) in the block:
    the path's backward passes, which its B1 launches must match."""
    calls = [0]
    orig = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def timed_run(fn):
    """(result, seconds, launch counts) of fn() with the counts reset just
    before it and read just after, the device drained on both sides."""
    from ilqr_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _build.launch_counts()


def share(launches: int, dev_us: float | None, secs: float) -> str:
    """A kernel's share of a solve: launches x device time per call."""
    if dev_us is None:
        return f"{launches} launches, device time not measured"
    ms = launches * dev_us * 1e-3
    return (f"{launches} x {dev_us * 1e-3:.4f} ms = {ms:.3f} ms, "
            f"{100 * ms * 1e-3 / secs:.3f} % of the {secs:.3f} s solve")


def need(label: str, counts: dict, kernels) -> None:
    for kernel in kernels:
        if counts.get(kernel, 0) < 1:
            raise AssertionError(f"{label} never launched {kernel}")


def facade_phase(itt, dev) -> None:
    """Phase 22: the pendulum golden through `compat.iLQR` (host loops under
    the port's 'auto') and the 13 functions on CUDA tensors."""
    from ilqr_tpu_torch import compat

    t_phase = time.perf_counter()
    psys = compat.MyPendulum(
        dt=0.01, x_target=[np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
        Q_f=np.zeros((2, 2)), g=9.81, l=1.0, d=0.0,
        integrator="backward_euler", device=dev)
    x, u = np.array([0.3, -0.2]), np.array([0.2])
    names = ("f_fcn", "f_x_fcn", "f_u_fcn", "l_fcn", "l_x_fcn", "l_u_fcn",
             "l_xx_fcn", "l_ux_fcn", "l_uu_fcn", "l_f_fcn", "l_f_x_fcn",
             "l_f_xx_fcn")
    for name in names:
        out = getattr(psys, name)(*((x, u) if "_f_" not in name
                                    and name != "l_f_fcn" else (x,)))
        if not (out.is_cuda and bool(torch.isfinite(out).all())):
            raise AssertionError(f"compat {name}: not a finite CUDA tensor")
    solver = compat.iLQR(psys, T=4.0, x_0=[1.0, 0.0],
                         U_init=torch.zeros((1, 400)), tol=1e-5, maxiter=100,
                         verbose=True)
    (X, U, cost), secs, counts = timed_run(solver.optimize_trajectory)
    err = abs(float(cost) - PENDULUM_GOLDEN_COST)
    print(f"phase 22: compat.iLQR pendulum golden (backward Euler, N = 400, "
          f"'auto' engines = host loops): cost {float(cost):.6f}, "
          f"|cost - {PENDULUM_GOLDEN_COST}| {err:.2e} (limit 1e-3), X "
          f"{tuple(X.shape)} U {tuple(U.shape)} on {X.device}, {secs:.3f} s, "
          f"launches {counts}; {len(names)} derivative functions evaluated "
          f"on {dev}")
    if not (err <= 1e-3 and X.shape == (2, 401) and U.shape == (1, 400)
            and X.is_cuda and U.is_cuda):
        raise AssertionError("compat facade: cost, layout or device wrong")
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")


def driver_phase(itt, dev) -> None:
    """Phase 23: the reference drivers' main(plot=False) on the card."""
    from examples_torch import (
        double_pendulum_mpc,
        double_pendulum_open_loop,
        pendulum_open_loop,
        ua_double_pendulum_open_loop,
    )

    t_phase = time.perf_counter()
    b12 = ("fused_riccati", "linesearch_costs", "closed_loop_rollout",
           "open_loop_rollout")
    sol, secs, counts = timed_run(lambda: pendulum_open_loop.main(
        plot=False, device=dev, reps=1))
    err = abs(float(sol.cost) - PENDULUM_GOLDEN_COST)
    print(f"pendulum_open_loop.main: status {sol.status}, cost "
          f"{float(sol.cost):.6f} (|cost - {PENDULUM_GOLDEN_COST}| "
          f"{err:.2e}, limit 1e-3), {secs:.3f} s with its warm-up, launches "
          f"{counts}")
    if not (sol.status == itt.CONVERGED and err <= 1e-3):
        raise AssertionError("pendulum driver: gates not met")
    need("pendulum driver", counts, b12)
    sol, secs, counts = timed_run(lambda: double_pendulum_open_loop.main(
        plot=False, device=dev, reps=1))
    print(f"double_pendulum_open_loop.main: status {sol.status}, "
          f"{sol.iterations} iterations, cost {float(sol.cost):.6f}, "
          f"{secs:.3f} s with its warm-up, launches {counts}")
    dp_gates(itt, sol, "DP driver", counts, b12)
    # The UA-DP driver at its smoke depth (N = 20, 5 iterations, as
    # tests/test_torch_examples_smoke.py holds it to JAX's); phase 4 holds
    # its full problem to the golden.
    smoke_was = os.environ.get("ILQR_TPU_SMOKE")
    os.environ["ILQR_TPU_SMOKE"] = "1"
    try:
        sol, secs, counts = timed_run(lambda: ua_double_pendulum_open_loop.main(
            plot=False, device=dev, reps=1))
    finally:
        if smoke_was is None:
            os.environ.pop("ILQR_TPU_SMOKE")
        else:
            os.environ["ILQR_TPU_SMOKE"] = smoke_was
    trace = sol.cost_trace[:sol.iterations].cpu().numpy()
    print(f"ua_double_pendulum_open_loop.main (smoke depth): status "
          f"{sol.status}, {sol.iterations} iterations, cost "
          f"{float(sol.cost):.6f}, {secs:.3f} s with its warm-up, launches "
          f"{counts}")
    if not (bool(torch.isfinite(sol.X).all())
            and np.all(np.diff(trace) <= 0)):
        raise AssertionError("UA-DP driver: not finite or cost increased")
    need("UA-DP driver", counts, b12)

    # The FA and UA double-pendulum MPC at full horizon, cut to DRIVER_STEPS
    # steps; each solve's initial rollout is one open-loop launch.
    out, secs, counts = timed_run(lambda: double_pendulum_mpc.main(
        plot=False, device=dev, reps=(1, 1), n_sim=DRIVER_STEPS))
    passes = sum(int(r.solve_iters.sum())
                 + int((r.solve_status == itt.LINESEARCH_FAILED).sum())
                 for r in out.values())
    print(f"double_pendulum_mpc.main(n_sim={DRIVER_STEPS}): FA cost "
          f"{float(out['fa'].cost):.4f}, UA cost {float(out['ua'].cost):.4f}, "
          f"{secs:.3f} s with the warm-ups, launches {counts}; backward "
          f"passes of the timed loops {passes}")
    if counts.get("open_loop_rollout", 0) != 2 * (DRIVER_STEPS + 1):
        raise AssertionError("DP MPC driver: one open-loop launch per solve "
                             "expected, the warm-up steps included")
    if counts.get("fused_riccati", 0) < passes:
        raise AssertionError("DP MPC driver: fewer B1 launches than "
                             "backward passes")
    need("DP MPC driver", counts, b12)
    for key, ua in (("fa", False), ("ua", True)):
        p = double_pendulum_mpc.problem(dev, underactuated=ua)
        if not all(bool(torch.isfinite(t).all())
                   for t in (out[key].X, out[key].U)):
            raise AssertionError(f"DP MPC driver {key}: not finite")
        if ua:
            continue   # its scan loop: cut for the time limit (PERF.md §4)
        cfg = dataclasses.replace(p.config, backward="scan", rollout="scan")
        ref, secs, counts = timed_run(lambda: itt.run_mpc(
            p.solver, p.plant, p.x0, p.U0, DRIVER_REF_STEPS, cfg))
        dx = float((out[key].X[:DRIVER_REF_STEPS + 1] - ref.X).abs().max())
        print(f"DP MPC {key.upper()} (H = {p.U0.shape[0]}): the first "
              f"{DRIVER_REF_STEPS} steps through the kernels agree with "
              f"backward='scan', rollout='scan' to {dx:.2e} (limit "
              f"{ATOL_MPC}); the scan loop {secs:.3f} s, "
              f"{ref.solve_iters.tolist()} iterations")
        if not dx <= ATOL_MPC:
            raise AssertionError(f"DP MPC {key}: kernels and scan differ")
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")


def constrained_phases(itt, dev, smi) -> list:
    """Phases 24-25: the AL, AL-MS and barrier solves at
    examples_torch/constrained_pendulum.py's full size, and the constrained
    MPC loops of constrained_mpc.py cut to MPC_STEPS steps; returns the
    kernels-line rows of B1, B1d and B3 at these paths' shapes."""
    from examples_torch import constrained_mpc, constrained_pendulum
    from ilqr_tpu_torch import constrained, shooting

    f32 = dict(dtype=torch.float32, device=dev)
    t_phase = time.perf_counter()
    p = constrained_pendulum.problem(dev)
    N = p.U0.shape[0]
    lim = float(p.box.params["hi"])

    def al_gates(label, sol):
        rel = abs(float(sol.cost) - AL_PENDULUM_COST) / AL_PENDULUM_COST
        umax = float(sol.U.abs().max())
        print(f"{label}: status {sol.status}, {sol.outer_iterations} outer / "
              f"{sol.inner_iterations} inner iterations, cost "
              f"{float(sol.cost):.5f} ({rel:.1e} from the JAX result "
              f"{AL_PENDULUM_COST}, limit {RTOL_AL}), violation "
              f"{float(sol.violation):.2e}, max|u| {umax:.6f}")
        if not (sol.status == itt.CONVERGED and rel <= RTOL_AL
                and float(sol.violation) <= 1e-4 and umax <= lim + 1e-4):
            raise AssertionError(f"{label}: gates not met")

    # Through the kernels, held to the JAX package's f32 result.  The same
    # solve with 'pscan' (B1's plain version) was cut for the time limit
    # (9.2 s; PERF.md §4): the kernel_row below holds B1 to its plain
    # version at this path's shape, and tests/test_torch_constrained.py
    # holds the plain engines' AL solve to JAX's in f64.
    runs = {}
    for backward in ("pallas",):
        cfg = dataclasses.replace(p.config, backward=backward)
        with counting(constrained, "_backward") as passes:
            sol, secs, counts = timed_run(lambda: itt.solve_constrained(
                p.system, p.constraints, p.x0, p.U0, cfg, p.al_config))
        print(f"AL pendulum N={N} (backward={backward}, rollout=pallas): "
              f"{secs:.3f} s, {passes[0]} backward passes, launches {counts}")
        al_gates(f"AL pendulum ({backward})", sol)
        runs[backward] = (sol, secs, counts, passes[0])
    sol, secs, counts, n_pass = runs["pallas"]
    if not (counts.get("fused_riccati", 0) == n_pass
            >= sol.inner_iterations):
        raise AssertionError("AL pendulum: B1 launches differ from the "
                             "backward passes or fall below the inner "
                             "iterations")
    need("AL pendulum", counts, ("closed_loop_rollout", "open_loop_rollout"))

    # B1 at this path's shape: the augmented expansion at the solution.
    exp_al = constrained._augment_expansion(
        itt.linearize_trajectory(p.system, sol.X, sol.U), p.constraints,
        {"gi": sol.lam_stage_ineq, "he": sol.lam_stage_eq,
         "gti": sol.lam_terminal_ineq, "hte": sol.lam_terminal_eq},
        sol.mu, sol.X, sol.U)
    rows = []

    def kernel_row(name, label, fn, plain, plain64, rtol, source, replaces,
                   launches, b, secs, plain_reps=10):
        """Hold the kernel to its plain version at this path's shape
        (max|kernel - plain| <= max(rtol max|plain|, F32_FLOOR max|plain -
        plain in f64|), as phases 2 and 6), time both, and add its row."""
        got, ref, r64 = fn(), plain(), plain64()
        err, notes = 0.0, []
        for g, r, r6 in zip(got, ref, r64):
            if not g.is_floating_point():
                continue
            e = rel_err(g, r)[0]
            limit = max(rtol * float(r.abs().max()),
                        F32_FLOOR * rel_err(r, r6)[0])
            notes.append(f"{e:.2e} (limit {limit:.2e})")
            if not e <= limit:
                raise AssertionError(f"{label}: kernel against plain "
                                     f"{e:.3e}, limit {limit:.3e}")
            err = max(err, e)
        dev_us = queued_us(fn)
        ms = cuda_ms(fn, 50, 5)
        plain_ms = cuda_ms(plain, plain_reps, 1)
        print(f"  {label}: device {ms_text(dev_us)} ms, events {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b[0]:.2e} ms ({b[1]}), max "
              f"abs error against the plain version by output "
              f"{', '.join(notes)}; {share(launches, dev_us, secs)} on {smi}")
        rows.append(dict(
            name=name, route="cuda", source=f"ilqr_tpu_torch/csrc/{source}",
            replaces=f"ilqr_tpu/ops/{replaces}", launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None,
            device_ms=None if dev_us is None else dev_us * 1e-3))
        return dev_us

    def f64(exp):
        return dataclasses.replace(exp, **{
            f.name: getattr(exp, f.name).double()
            for f in dataclasses.fields(exp)})

    def b2b_row(name, label, system, x0, X, U, exp, launches, integrator,
                secs):
        """B2b (one α's trajectory, as the AL and barrier line searches
        launch it per α) along a solution, with the gains of ``exp``."""
        u_ff, K, _, _ = itt.backward_pass_fused(exp, 0.0)
        X, U = X.contiguous(), U.contiguous()
        sys64 = system.replace(params={k: v.double()
                                       for k, v in system.params.items()})
        n_x, n_u = system.n_x, system.n_u
        return kernel_row(
            name, label,
            lambda: itt.closed_loop_rollout_fused(system, x0, 0.5, X, U, u_ff,
                                                  K),
            lambda: itt.closed_loop_rollout(system, x0, 0.5, X, U, u_ff, K),
            lambda: itt.closed_loop_rollout(sys64, x0.double(), 0.5,
                                            X.double(), U.double(),
                                            u_ff.double(), K.double()),
            RTOL_B2, "chain_rollout.cu", "pallas_rollout.py:132", launches,
            chain_bounds(n_x, n_u, U.shape[0], 1,
                         model="pendulum" if n_x == 2 else "double_pendulum",
                         integrator=integrator)["closed_loop_rollout"],
            secs, plain_reps=2)

    b_al = bound(4 * (expansion_floats(N, 2, 1) + N * 3 + 2),
                 N * riccati_step_ops(2, 1))
    print(f"AL pendulum kernels at N={N} (B1's share: launches x device "
          f"time per call):")
    b1_us = kernel_row("fused_riccati_al", f"B1 AL pendulum N={N}",
                       lambda: itt.backward_pass_fused(exp_al, 0.0),
                       lambda: itt.backward_pass_associative(exp_al, 0.0),
                       lambda: itt.backward_pass_associative(f64(exp_al), 0.0),
                       RTOL_B1, "fused_riccati.cu", "pallas_riccati.py:774",
                       counts["fused_riccati"], b_al, secs)

    b2_us = b2b_row("closed_loop_rollout_al", f"B2b AL pendulum N={N}, rk4",
                    p.system, p.x0, sol.X, sol.U, exp_al,
                    counts["closed_loop_rollout"], "rk4", secs)

    # AL x multiple shooting: B1d and B3.
    ms_cfg = itt.MsConfig(update_engine="pallas")
    with counting(shooting, "_backward_ms") as passes:
        sol_ms, secs_ms, counts_ms = timed_run(lambda: itt.solve_constrained_ms(
            p.system, p.constraints, p.x0, p.U0, config=p.config,
            al_config=p.al_config, ms=ms_cfg))
    rel = abs(float(sol_ms.cost) - float(sol.cost)) / float(sol.cost)
    print(f"AL-MS pendulum N={N} (backward=pallas, update_engine=pallas): "
          f"status {sol_ms.status}, {sol_ms.outer_iterations} outer / "
          f"{sol_ms.inner_iterations} inner iterations, cost "
          f"{float(sol_ms.cost):.5f} ({rel:.1e} from the single-shooting "
          f"cost, limit {RTOL_AL}), violation {float(sol_ms.violation):.2e}, "
          f"{secs_ms:.3f} s, {passes[0]} backward passes, launches "
          f"{counts_ms}")
    if not (sol_ms.status == itt.CONVERGED and rel <= RTOL_AL):
        raise AssertionError("AL-MS pendulum: gates not met")
    need("AL-MS pendulum", counts_ms, ("fused_riccati", "affine_prefix_scan"))
    if counts_ms["fused_riccati"] != passes[0]:
        raise AssertionError("AL-MS: B1d launches differ from the passes")
    X_m, U_m = sol_ms.X.contiguous(), sol_ms.U.contiguous()
    d_m = shooting._node_defects(p.system, X_m, U_m)
    d_m = d_m + 1e-3 * torch.tensor(np.random.default_rng(9).standard_normal(
        tuple(d_m.shape)), **f32)   # gaps of an iterate still closing them
    exp_m = itt.linearize_trajectory(p.system, X_m, U_m)
    u_m, K_m, _, _ = itt.backward_pass_fused(exp_m, 0.0, d_m)
    alphas = torch.tensor(p.config.alpha_schedule(), **f32)
    P = (exp_m.f_x + exp_m.f_u @ K_m).contiguous()
    q = (alphas[:, None, None] * ((exp_m.f_u @ u_m[..., None])[..., 0]
                                  + d_m)[None]).contiguous()
    d0 = torch.zeros((alphas.numel(), 2), **f32)
    kernel_row("fused_riccati_defects_al_ms", f"B1d AL-MS N={N}",
               lambda: itt.backward_pass_fused(exp_m, 0.0, d_m),
               lambda: itt.backward_pass_associative(exp_m, 0.0, d_m),
               lambda: itt.backward_pass_associative(f64(exp_m), 0.0,
                                                     d_m.double()),
               RTOL_B1, "fused_riccati.cu", "pallas_riccati.py:774",
               counts_ms["fused_riccati"],
               bound(4 * (expansion_floats(N, 2, 1) + N * 2 + N * 3 + 2),
                     N * riccati_step_ops(2, 1)), secs_ms)
    kernel_row("affine_prefix_scan_al_ms",
               f"B3 AL-MS N={N}, {alphas.numel()} candidates",
               lambda: (itt.affine_prefix_scan_multi(P, q, d0,
                                                     engine="pallas"),),
               lambda: (itt.affine_prefix_scan_multi(P, q, d0, engine="xla"),),
               lambda: (itt.affine_prefix_scan_multi(
                   P.double(), q.double(), d0.double(), engine="xla"),),
               RTOL_B3, "affine_scan.cu", "pallas_affine.py:137",
               counts_ms["affine_prefix_scan"], b3_bound(N, 2, alphas.numel()),
               secs_ms)

    # The barrier on the box alone against the JAX package's f32 result
    # (against the 'pscan' engine, B1's plain version, until phase 38
    # came: 16.2 s; the sequential 'scan' took 49-68 s).
    cfg = dataclasses.replace(p.config, backward="pallas")
    with counting(constrained, "_backward") as passes:
        sol_b, secs_b, counts_b = timed_run(lambda: itt.solve_barrier(
            p.system, p.box, p.x0, p.U0, cfg, itt.BarrierConfig()))
    rel = abs(float(sol_b.cost) - BARRIER_PENDULUM_COST) / \
        BARRIER_PENDULUM_COST
    print(f"barrier pendulum N={N}, box alone (backward=pallas): status "
          f"{sol_b.status}, {sol_b.inner_iterations} inner iterations, cost "
          f"{float(sol_b.cost):.5f} ({rel:.1e} from the JAX result "
          f"{BARRIER_PENDULUM_COST}, limit {RTOL_AL}), violation "
          f"{float(sol_b.violation):.2e}, max|u| "
          f"{float(sol_b.U.abs().max()):.5f}, {secs_b:.3f} s, {passes[0]} "
          f"backward passes, launches {counts_b}")
    if counts_b.get("fused_riccati", 0) != passes[0]:
        raise AssertionError("barrier: B1 launches differ from passes")
    print(f"  B1's share: {share(counts_b['fused_riccati'], b1_us, secs_b)}; "
          f"B2b's: {share(counts_b['closed_loop_rollout'], b2_us, secs_b)}")
    if not (sol_b.status == itt.CONVERGED and rel <= RTOL_AL):
        raise AssertionError(f"barrier: not CONVERGED within {RTOL_AL} of "
                             f"the JAX result (cost off by {rel:.1e})")
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s")

    # ---- 25. constrained MPC (examples/constrained_mpc.py, 20 steps) ----
    t_phase = time.perf_counter()
    m = constrained_mpc.problem(dev)
    loops = {
        "AL": lambda cfg, steps=MPC_STEPS: itt.run_mpc_constrained(
            m.solver, m.plant, m.constraints, m.x0, m.U0, steps, cfg,
            m.al_config),
        "barrier": lambda cfg, steps=MPC_STEPS: itt.run_mpc_barrier(
            m.solver, m.plant, m.constraints, m.x0, m.U0, steps, cfg,
            **m.barrier)}
    base_cfg = {"AL": m.config_al, "barrier": m.config_barrier}
    # B2b (backward Euler) at the loops' shape, along the first step's
    # constrained plan.
    plan = itt.solve_constrained(m.solver, m.constraints, m.x0, m.U0,
                                 m.config_al, m.al_config)
    H = m.U0.shape[0]
    print(f"constrained MPC kernels at H={H} (backward Euler):")
    b2_mpc_us = None
    # The 'scan' loops are held to the kernels' for their first
    # MPC_REF_STEPS steps (all MPC_STEPS of them took 18-27 s a loop).
    for name, loop in loops.items():
        costs = {}
        for backward in ("pallas", "scan"):
            cfg = dataclasses.replace(base_cfg[name], backward=backward)
            if backward == "scan":
                ref, secs, _ = timed_run(lambda: loop(cfg, MPC_REF_STEPS))
                dx = float((res.X[:MPC_REF_STEPS + 1] - ref.X).abs().max())
                print(f"{name} MPC: the first {MPC_REF_STEPS} steps through "
                      f"the kernels agree with backward='scan' to {dx:.2e} "
                      f"(limit {ATOL_MPC}); the scan loop {secs:.3f} s")
                if not dx <= ATOL_MPC:
                    raise AssertionError(f"{name} MPC: kernels and scan "
                                         f"differ")
                continue
            with counting(constrained, "_backward") as passes:
                res, secs, counts = timed_run(lambda: loop(cfg))
            costs[backward] = float(res.cost)
            rel = abs(costs[backward] - AL_MPC_COST[name]) / AL_MPC_COST[name]
            umax = float(res.U.abs().max())
            print(f"{name} MPC H={m.U0.shape[0]} (cut to {MPC_STEPS} of "
                  f"{m.n_sim} steps; backward={backward}, rollout=pallas): "
                  f"cost {costs[backward]:.4f} ({rel:.1e} from the JAX "
                  f"result {AL_MPC_COST[name]}), max|u| {umax:.5f}, "
                  f"{secs:.3f} s, {secs * 1e3 / MPC_STEPS:.1f} ms per step, "
                  f"{int(res.solve_iters.sum())} inner iterations, "
                  f"{passes[0]} backward passes, launches {counts}")
            if not (rel <= RTOL_AL_MPC and umax <= m.lim + 1e-3
                    and bool(torch.isfinite(res.X).all())):
                raise AssertionError(f"{name} MPC ({backward}): gates not met")
            if backward == "pallas" and counts.get("fused_riccati", 0) != \
                    passes[0]:
                raise AssertionError(f"{name} MPC: B1 launches "
                                     f"{counts.get('fused_riccati', 0)} != "
                                     f"backward passes {passes[0]}")
            if backward == "pallas" and name == "AL":
                b2_mpc_us = b2b_row(
                    "closed_loop_rollout_al_mpc",
                    f"B2b AL MPC H={H}, backward Euler", m.solver, m.x0,
                    plan.X, plan.U,
                    itt.linearize_trajectory(m.solver, plan.X, plan.U),
                    counts["closed_loop_rollout"], "backward_euler", secs)
            if backward == "pallas":
                print(f"  B2b's share: "
                      f"{share(counts['closed_loop_rollout'], b2_mpc_us, secs)}")
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---- Phases 26-30: the other model families (B1w, B6w, B2's new models) ----
# The JAX package's f32 results on a CPU (ilqr_tpu 07c4af6, jax.jit, x86
# host) of the slice's solves, at the drivers' configurations: the
# thrust-limited 3-D quadrotor flight (examples/quadrotor3d_flight.py, N =
# 150: CONVERGED, 29 iterations), its MPC loop (H = 50, rk4 solver, euler
# plant) cut to 20 steps, the planar quadrotor dash (N = 300: CONVERGED,
# 32 iterations), the bench's cart-pole MPC (bench.py:795-810, H = 200)
# cut to 20 steps and the car's AL solve (examples/car_obstacles.py:
# CONVERGED, 4 outer / 183 inner iterations, violation 6.8e-4), recomputed
# and compared by tests/test_torch_chip_refs.py.  Gated as phase 24's
# constrained solves are, within RTOL_AL (1e-3 relative).
JAX_F32 = {"flight": 3.1779935359954834, "flight_mpc_20": 432.25994873046875,
           "dash": 5.539409160614014, "cartpole_mpc_20": 1599.4395751953125,
           "car": 12.004977226257324,
           # Phase 34: P1's sampled instances, and P3's two solves.
           "p1_0": 1.5822689533233643, "p1_127": 1.4332703351974487,
           "p1_255": 1.3097046613693237, "p3_defect": 1.5822689533233643,
           "p3_ms": 1.5822679996490479,
           # Phase 35: P4's closed-loop cost and RMS angle error, P5's
           # sampled instances, P6's cost.
           "p4_cost": 0.23593653738498688, "p4_rms": 0.03818352892994881,
           "p5_0": 0.003775405464693904, "p5_127": 0.028269486501812935,
           "p5_255": 0.21071386337280273, "p6": 3.5682594776153564,
           # Phase 36: P7's loss and gradient at log_w = 0; P9's
           # RMS-to-truth of the parallel filter and smoother at P9_N and
           # of the sequential ones at P9_SEQ_N.
           "p7": [33.15259552001953, -1.869497299194336,
                  -1.2834796905517578, 0.9669301509857178],
           "p7_sub": [16.125484466552734, -1.9681757688522339,
                      0.062303900718688965, -2.4131522178649902],
           "p9_ekf_par_rms": 0.006261312402784824,
           "p9_eks_par_rms": 0.003862272948026657,
           "p9_ekf_seq_rms": 0.02282000333070755,
           "p9_eks_seq_rms": 0.0043975296430289745,
           # P8: examples/mppi_pendulum.py's limited iLQR from zeros (N =
           # 80, |u| <= 8, maxiter 100, tol 1e-8).
           "p8_limited": 20.524015426635742}
WIDE_STEPS = 20          # the MPC loops of this slice, cut from 150 / 200
WIDE_N = 8192            # the bench's backward cells (bench.py:465-535)
# B1w's shapes: the planar quadrotor (6, 2), the 3-D quadrotor (12, 4),
# its rotor-lag variant (16, 4), the tracking wrappers of the pendulum
# (3, 1) and the double pendulum (5, 2), and the corner (16, 6).
WIDE_B1_SHAPES = ((6, 2), (12, 4), (16, 4), (3, 1), (5, 2), (16, 6))
WIDE_B2_MODELS = ("cartpole", "quadrotor", "quadrotor3d", "quadrotor3d_rotor",
                  "car")
# The ring's chunk (32) and ring edges; N = 500 (four rings) was cut for
# the time limit when phase 38 came: phase 3's N = 275 wraps the same
# chain kernel's ring twice.
WIDE_B2_NS = (1, 31, 33, 129)
# The dual counts of the implicit rules: a Dual<4> evaluation for
# the cart-pole and the car, a Dual<1> one (a column of df/dx) for the
# quadrotors.
FCONT_OPS.update({"cartpole": (22, 164), "quadrotor": (11, 17),
                  "quadrotor3d": (63, 154), "quadrotor3d_rotor": (71, 186),
                  "car": (7, 47)})


def wide_systems(itt, dev):
    """The slice's systems on the card: the drivers' problems and the
    tracking wrappers at (3, 1) and (5, 2)."""
    from examples_torch import (
        car_obstacles,
        quadrotor3d_flight,
        quadrotor_dash,
        reference_tracking_mpc,
    )
    from ilqr_tpu_torch.models import quadrotor3d

    f32 = dict(dtype=torch.float32, device=dev)
    flight = quadrotor3d_flight.problem(dev)
    Q, R, Q_f = quadrotor3d.default_weights(**f32)
    rotor = itt.make_quadrotor3d_rotor(
        0.02, [2.0, 1.0, 1.5] + [0.0] * 9 + [1.226] * 4,
        torch.block_diag(Q, 0.01 * torch.eye(4, **f32)), R,
        torch.block_diag(Q_f, torch.eye(4, **f32)), **f32)
    dp = itt.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1, 0.1]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="rk4",
        **f32)
    t = torch.arange(201, **f32) * 0.01
    X_ref = torch.stack([torch.sin(t), 0.5 * torch.cos(t), torch.zeros_like(t),
                         torch.zeros_like(t)], dim=-1)
    trk_dp = itt.make_tracking_system(dp, X_ref, torch.zeros((200, 2), **f32),
                                      torch.eye(4, **f32),
                                      0.1 * torch.eye(2, **f32),
                                      torch.eye(4, **f32))
    cart = itt.make_cartpole(
        0.01, [0.0, np.pi, 0.0, 0.0], Q=np.diag([1.0, 10.0, 0.1, 0.1]),
        R=0.1 * np.eye(1), Q_f=np.diag([100.0, 500.0, 10.0, 10.0]),
        integrator="rk4", **f32)
    return dict(flight=flight, dash=quadrotor_dash.problem(dev), rotor=rotor,
                trk_pend=reference_tracking_mpc.problem(dev).system,
                trk_dp=trk_dp, cart=cart, car=car_obstacles.problem(dev))


def hover_expansion(itt, system, N, u, f32, seed=0):
    """The expansion along a rollout of controls ``u`` (n_u,) plus seeded
    noise (0.1), from a seeded state near zero (a tracking clock rounds to
    step 0)."""
    rng = np.random.default_rng(seed)
    U = (u + torch.tensor(0.1 * rng.standard_normal((N, system.n_u)), **f32)
         ).contiguous()
    x0 = torch.tensor(0.05 * rng.standard_normal(system.n_x), **f32)
    X, _ = itt.rollout(system, x0, U)
    return itt.linearize_trajectory(system, X, U)


def random_expansion(itt, N, n_x, n_u, seed, f32):
    """A seeded expansion at (n_x, n_u) with positive definite l_uu."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((N, n_u, n_u))
    e = dict(f_x=np.eye(n_x) + 0.05 * rng.standard_normal((N, n_x, n_x)),
             f_u=0.3 * rng.standard_normal((N, n_x, n_u)),
             l_x=rng.standard_normal((N, n_x)),
             l_u=rng.standard_normal((N, n_u)),
             l_xx=np.broadcast_to(np.eye(n_x), (N, n_x, n_x)).copy(),
             l_ux=0.1 * rng.standard_normal((N, n_u, n_x)),
             l_uu=M @ M.transpose(0, 2, 1) / n_u + np.eye(n_u),
             v_x=rng.standard_normal(n_x), v_xx=10.0 * np.eye(n_x))
    return itt.TrajectoryExpansion(**{k: torch.tensor(v, **f32)
                                      for k, v in e.items()})


def wide_expansions(itt, systems, f32):
    """One expansion at each of WIDE_B1_SHAPES."""
    from ilqr_tpu_torch.models import quadrotor, quadrotor3d

    q3 = systems["flight"].system
    h3 = quadrotor3d.hover_controls(q3.params)
    dash = systems["dash"].system
    return {
        (6, 2): hover_expansion(itt, dash, 300,
                                quadrotor.hover_controls(dash.params), f32),
        (12, 4): hover_expansion(itt, q3, 150, h3, f32),
        (16, 4): hover_expansion(itt, systems["rotor"], 150, h3, f32),
        (3, 1): hover_expansion(itt, systems["trk_pend"], 50,
                                torch.zeros(1, **f32), f32),
        (5, 2): hover_expansion(itt, systems["trk_dp"], 100,
                                torch.zeros(2, **f32), f32),
        (16, 6): random_expansion(itt, 150, 16, 6, 6, f32),
    }


def wide_b1_checks(itt, lib, exps, errors) -> None:
    """Phase 26: B1w against its plain version at every shape of
    WIDE_B1_SHAPES: N = 1, the tile edges (N + 1 = T - 1, T, T + 1), across
    5 tile edges ending mid-tile, T + 2 tiles, the flight's 150 and the
    bench's WIDE_N (more tiles than the card holds at once: one 512-thread
    block of at most 228 KB of shared memory an SM), and with defects
    (B1d) at (12, 4); every call twice with equal bits required."""
    from ilqr_tpu_torch.ops import fused_riccati

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (n_x, n_u), exp in exps.items():
        T = fused_riccati.tile_steps(lib, n_x, n_u)
        Ns = (1, T - 2, T - 1, T, 5 * T + T // 2 + 3, T * (T + 2), 150,
              WIDE_N)
        print(f"B1w (n_x, n_u) = ({n_x}, {n_u}): tile {T} steps, at most "
              f"{sms} tiles resident; N {Ns}")
        for N in Ns:
            check_b1w(itt, f"({n_x}, {n_u})", tile_expansion(exp, N), errors,
                      "fused_riccati_wide")
    exp = exps[12, 4]
    rng = np.random.default_rng(12)
    for N in (150, WIDE_N):
        e = tile_expansion(exp, N)
        d = torch.tensor(1e-2 * rng.standard_normal((N, 12)),
                         dtype=torch.float32, device=e.f_x.device)
        check_b1w(itt, "(12, 4) with defects", e, errors,
                  "fused_riccati_wide_defects", defects=d)


def check_b1w(itt, label, exp, errors, key, defects=None, reg=0.0):
    """B1's gate (phase 2) at a wide shape."""
    torch.cuda.synchronize()
    got = itt.backward_pass_fused(exp, reg, defects)
    again = itt.backward_pass_fused(exp, reg, defects)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"B1w {label} N={exp.f_x.shape[0]}: a repeated "
                             f"call gave other bits")
    plain = itt.backward_pass_associative(exp, reg, defects)
    ref64 = itt.backward_pass_associative(
        as_f64(exp), reg, None if defects is None else defects.double())
    if not (bool(got[3]) and bool(plain[3])):
        raise AssertionError(f"B1w {label}: non-finite gains")
    notes = check_fields(f"B1w {label} N={exp.f_x.shape[0]}", got[:3],
                         plain[:3], ref64[:3], RTOL_B1, errors, key)
    print(f"B1w {label} N={exp.f_x.shape[0]}: " + "; ".join(notes)
          + "; repeated call bit-identical")


def wide_b6_checks(itt, lib, exps, errors) -> dict:
    """Phase 27: B6w (the suffix scan's wide form) against the plain scan
    at n = 6, 12 and 16, on the elements of the quadrotors' expansions with
    the terminal element: M = 1, T - 1, T, T + 1, across 5 tile edges,
    T (T + 1) + 1, more tiles than are resident, the flight's M = 151 and
    the dash's 301, and WIDE_N + 1; every call twice.  Returns the timed
    element sets {label: elements}."""
    from ilqr_tpu_torch.ops import parallel_riccati, suffix_scan
    from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

    def elements(exp, M, terminal=True):
        # With the terminal element every suffix has A = b = C = 0; the
        # stage elements alone give windowed products in all five fields.
        el = parallel_riccati.make_elements(
            tile_expansion(exp, M - 1 if terminal else M), 0.0)
        return RiccatiElement(*(t[:M].contiguous() for t in el))

    for n, shape in ((6, (6, 2)), (12, (12, 4)), (16, (16, 4))):
        T = suffix_scan.tile_steps(lib, "sub", n)
        resident = resident_tiles(lib.ilqr_suffix_scan_occupancy(0, n),
                                  f"B6w n={n}")
        Ms = (1, T - 1, T, T + 1, 5 * T + T // 2 + 3, T * (T + 1) + 1,
              (resident + 3) * T + T // 2, 151, 301, WIDE_N + 1)
        print(f"B6w n={n}: tile {T} elements; M {Ms}, with the terminal "
              f"element, and M {Ms[3:5] + Ms[-1:]} of stage elements only")
        for M, terminal in ([(M, True) for M in Ms]
                            + [(M, False) for M in Ms[3:5] + Ms[-1:]]):
            el = elements(exps[shape], M, terminal)
            torch.cuda.synchronize()
            got = itt.suffix_scan_fused(el)
            again = itt.suffix_scan_fused(el)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"B6w n={n} M={M}: a repeated call "
                                     f"gave other bits")
            label = f"B6w n={n} M={M}{'' if terminal else ' stages only'}"
            notes = check_fields(
                label, got, parallel_riccati.suffix_scan(el),
                parallel_riccati.suffix_scan(as_f64(el)), RTOL_B6, errors,
                "suffix_scan_wide")
            print(f"{label}: " + "; ".join(notes)
                  + "; repeated call bit-identical")
    return {"flight M=151": elements(exps[12, 4], 151),
            "dash M=301": elements(exps[6, 2], 301)}


def nominal_draws(system, name, N, seed, f32):
    """`wide_model_nominal`'s seeded x0, U, u_ff and K (f32)."""
    rng = np.random.default_rng(seed)
    # The 3-D quadrotors' torques are arm / J ~ 70 times their thrusts: a
    # thrust noise of 0.3 at dt 0.02 tumbles them within a second, and
    # there a change of 1e-7 in x0 grows 1e6-fold or more within 129 steps
    # (tests/test_torch_chain_models_host.py), so any two f32 evaluations
    # part from f64 by unrelated amounts (a chaotic nominal, not a fault).
    # Their check runs at dt 0.005 (500 steps are 2.5 s) with noise 0.003.
    scale = 0.003 if name.startswith("quadrotor3d") else 0.3
    x0 = torch.tensor(scale * rng.standard_normal(system.n_x), **f32)
    U = scale * rng.standard_normal((N, system.n_u))
    if name.startswith("quadrotor"):
        U += 9.81 * 0.5 / system.n_u * (2.0 if name == "quadrotor" else 1.0)
    if name == "quadrotor3d_rotor":
        x0[12:] += 1.226
    U = torch.tensor(U, **f32)
    u_ff = torch.tensor(scale * rng.standard_normal((N, system.n_u)), **f32)
    K = torch.tensor(-0.05 * scale / 0.3 * rng.standard_normal(
        (N, system.n_u, system.n_x)), **f32)
    return x0, U, u_ff, K


def wide_model_nominal(system, name, N, seed, f32):
    """x0, a nominal (X, U) about the model's operating point, seeded
    feedforward steps and small gains (f32 on the card)."""
    from ilqr_tpu_torch.ops.rollout import rollout

    x0, U, u_ff, K = nominal_draws(system, name, N, seed, f32)
    X, _ = rollout(system, x0, U)
    return x0, X.contiguous(), U, u_ff, K


def wide_model_systems(itt, f32, integrator):
    """The new device models under ``integrator``.  The cart-pole, the
    planar and the 3-D quadrotors run at dt 0.005: at their drivers' 0.02
    and 0.01 a relative change of 1e-7 in x0 grew up to 2199-fold along
    500 steps of phase 28's nominals (the planar quadrotor under midpoint,
    a cart-pole 255-fold under euler), where at 0.005 it grows at most
    77-fold (tests/test_torch_chain_models_host.py)."""
    from ilqr_tpu_torch.models import quadrotor3d

    Q, R, Q_f = quadrotor3d.default_weights(**f32)
    return {
        "cartpole": itt.make_cartpole(
            0.005, [0.0, np.pi, 0.0, 0.0], np.diag([1.0, 10.0, 0.1, 0.1]),
            0.1 * np.eye(1), np.diag([100.0, 100.0, 10.0, 10.0]),
            integrator=integrator, **f32),
        "quadrotor": itt.make_quadrotor(
            0.005, [3.0, 1.0, 0.0, 0.0, 0.0, 0.0],
            np.diag([1.0, 1.0, 0.5, 0.1, 0.1, 0.1]), 0.1 * np.eye(2),
            np.diag([200.0, 200.0, 50.0, 20.0, 20.0, 10.0]),
            integrator=integrator, **f32),
        "quadrotor3d": itt.make_quadrotor3d(
            0.005, [2.0, 1.0, 1.5] + [0.0] * 9, Q, R, Q_f,
            integrator=integrator, **f32),
        "quadrotor3d_rotor": itt.make_quadrotor3d_rotor(
            0.005, [2.0, 1.0, 1.5] + [0.0] * 9 + [1.226] * 4,
            torch.block_diag(Q, 0.01 * torch.eye(4, **f32)), R,
            torch.block_diag(Q_f, torch.eye(4, **f32)),
            integrator=integrator, **f32),
        "car": itt.make_car(
            0.05, [8.0, 0.0, 0.0, 0.0], np.diag([0.1, 0.1, 0.01, 0.1]),
            np.diag([1.0, 5.0]), 100.0 * np.diag([1.0, 1.0, 0.1, 1.0]),
            integrator=integrator, **f32),
    }


def wide_plain(integ: str, name: str, seed: int) -> dict:
    """Phase 28's inputs and plain versions for one instantiation, on the
    host (numpy out; run in a child process): at each N of WIDE_B2_NS a
    seeded nominal and gains in f32 (`wide_model_nominal`), the closed
    loops of 33 alphas along it and the open loop, in f64 and in f32."""
    import ilqr_tpu_torch as itt
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cpu32 = dict(dtype=torch.float32, device="cpu")
    system = wide_model_systems(itt, cpu32, integ)[name]
    s64 = system.replace(params={k: v.double()
                                 for k, v in system.params.items()})
    alphas = torch.tensor([0.5 ** i for i in range(33)], **cpu32)
    out = {}
    for N in WIDE_B2_NS:
        inputs = wide_model_nominal(system, name, N, seed + N, cpu32)
        x0, X, U, u_ff, K = inputs
        d = {"inputs": [t.numpy() for t in inputs]}
        for key, sys_, cast in (("f64", s64, torch.Tensor.double),
                                ("f32", system, lambda t: t)):
            h = [cast(t) for t in (x0, alphas, X, U, u_ff, K)]
            X_r, U_r, c_r = itt.linesearch_rollouts(sys_, *h)
            X_o, c_o = itt.rollout(sys_, h[0], h[3])
            d[key] = [t.numpy() for t in (c_r, X_r[1], U_r[1], c_r[1], X_o,
                                          c_o)]
        out[N] = d
    out["seconds"] = time.perf_counter() - t0
    return out


def wide_b2_checks(itt, dev, errors) -> None:
    """Phase 28: B2 in every new model's instantiations (WIDE_B2_MODELS
    under euler, midpoint and rk4) at WIDE_B2_NS (N = 1, a ring chunk less
    and plus one, the ring wrapped, 500) with 1, 10 and 33 alphas, against
    the plain rollouts in f64 on the host (`wide_plain`, in CHAIN_WORKERS
    child processes while the kernels run; the nominal, gains and alphas
    the kernels' f32 ones), the limit B1's rule: RTOL_B2 of the output's
    max or F32_FLOOR times the plain version's own f32 error (the 3-D
    quadrotors' costs reach ~1e3 over 500 steps, where f32 sums part from
    f64 by more than RTOL_B2 of the max): costs, one alpha's trajectory and
    the open loop, each call twice with equal bits required.  The rule
    needs nominals along which a rounding does not grow:
    tests/test_torch_chain_models_host.py holds the 3-D quadrotors' ones to
    that."""
    from ilqr_tpu_torch.ops import fused_rollout

    f32 = dict(dtype=torch.float32, device=dev)
    alphas = torch.tensor([0.5 ** i for i in range(33)], **f32)
    pool = multiprocessing.get_context("spawn").Pool(CHAIN_WORKERS)
    t_pool = time.perf_counter()
    cases = [(integ, name) for integ in ("euler", "midpoint", "rk4")
             for name in WIDE_B2_MODELS]
    jobs = {case: pool.apply_async(wide_plain, case + (7 + i,))
            for i, case in enumerate(cases)}

    def twice(fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("B2: a repeated call gave other bits")
        return a

    def gate(label, key, got, ref, ref32):
        ref, ref32 = torch.from_numpy(ref), torch.from_numpy(ref32)
        err, rel = rel_err(got.cpu(), ref)
        floor = rel_err(ref32, ref)[0]
        limit = max(RTOL_B2 * float(ref.abs().max()), F32_FLOOR * floor)
        errors[key] = max(errors[key], err)
        if not (bool(torch.isfinite(got).all()) and err <= limit):
            raise AssertionError(f"B2 {label}: {err:.3e} ({rel:.2e} of max),"
                                 f" limit {limit:.3e} (plain f32 vs f64 "
                                 f"{floor:.3e})")
        return rel

    print(f"B2 new models: against the plain rollouts in f64 on the host, "
          f"max|kernel - plain f64| <= max({RTOL_B2} * max|plain f64|, "
          f"{F32_FLOOR} * max|plain f32 - plain f64|), both plain versions "
          f"on the host")
    host_s = 0.0
    try:
        for (integ, name), job in jobs.items():
            system = wide_model_systems(itt, f32, integ)[name]
            ref = job.get(timeout=1200)
            host_s += ref["seconds"]
            worst = 0.0
            for N in WIDE_B2_NS:
                x0, X, U, u_ff, K = (torch.from_numpy(a).to(**f32)
                                     for a in ref[N]["inputs"])
                r64, r32 = ref[N]["f64"], ref[N]["f32"]
                label = f"{name} {integ} N={N}"
                for A in CHAIN_ALPHA_COUNTS:
                    (c,) = twice(lambda: (itt.linesearch_costs_fused(
                        system, x0, alphas[:A], X, U, u_ff, K),))
                    worst = max(worst, gate(f"{label} A={A} costs",
                                            "linesearch_costs_models", c,
                                            r64[0][:A], r32[0][:A]))
                got = twice(lambda: itt.closed_loop_rollout_fused(
                    system, x0, float(alphas[1]), X, U, u_ff, K))
                for what, g, i in (("X", got[0], 1), ("U", got[1], 2),
                                   ("cost", got[2], 3)):
                    worst = max(worst, gate(f"{label} trajectory {what}",
                                            "closed_loop_rollout_models", g,
                                            r64[i], r32[i]))
                got = twice(lambda: itt.open_loop_rollout_fused(system, x0,
                                                                U))
                for what, g, i in (("X", got[0], 4), ("cost", got[1], 5)):
                    worst = max(worst, gate(f"{label} open loop {what}",
                                            "open_loop_rollout_models", g,
                                            r64[i], r32[i]))
            print(f"B2 {name} {integ} (model id "
                  f"{fused_rollout.device_model(system)[0]}): N "
                  f"{WIDE_B2_NS}, alphas {CHAIN_ALPHA_COUNTS}; largest error "
                  f"{worst:.2e} of max; repeated calls bit-identical")
    finally:
        pool.terminate()
        pool.join()
    print(f"B2 new models' plain versions: {host_s:.1f} s of host time in "
          f"{CHAIN_WORKERS} child processes, "
          f"{time.perf_counter() - t_pool:.1f} s of wall time")


def wide_solves(itt, dev, systems) -> dict:
    """Phase 29: the slice's solves through the kernels, the launch counts
    reset just before each and read just after, each gated on its status
    and on its cost against the JAX package's f32 result (JAX_F32, within
    RTOL_AL).  Returns {label: (result, seconds, counts)}."""
    from ilqr_tpu_torch import constrained
    from ilqr_tpu_torch import solver as solver_module
    from ilqr_tpu_torch.mpc import run_mpc
    from ilqr_tpu_torch.ops import limited_parallel
    from ilqr_tpu_torch.tracking import track, tvlqr_gains

    out = {}

    def gate(label, key, cost, ok=True):
        rel = abs(cost - JAX_F32[key]) / abs(JAX_F32[key])
        print(f"  {label}: cost {cost:.6f}, {rel:.1e} from the JAX f32 result"
              f" {JAX_F32[key]} (limit {RTOL_AL})")
        if not (ok and rel <= RTOL_AL):
            raise AssertionError(f"{label}: gates not met")

    # The 3-D quadrotor flight's open loop: limited, adaptive_reg; every
    # sweep of the limited parallel pass is one B6w launch at n = 12.
    p = systems["flight"]
    with counting(limited_parallel, "suffix_scan_fused") as sweeps:
        sol, secs, counts = timed_run(lambda: itt.solve(p.system, p.x0, p.U0,
                                                        p.config))
    print(f"quadrotor3d flight N={p.U0.shape[0]} (backward=pallas, "
          f"limits [0, {p.f_max:.3f}], adaptive_reg): status {sol.status}, "
          f"{sol.iterations} iterations, {secs:.2f} s, {sweeps[0]} sweeps, "
          f"launches {counts}, max thrust {float(sol.U.max()):.4f}")
    gate("flight", "flight", float(sol.cost), sol.status == itt.CONVERGED
         and float(sol.U.max()) <= p.f_max + 1e-4
         and float(sol.U.min()) >= -1e-4)
    if counts.get("suffix_scan", 0) != sweeps[0] or sweeps[0] < 1:
        raise AssertionError("flight: B6 launches differ from the sweeps")
    out["flight"] = (sol, secs, counts)

    # Its MPC loop, WIDE_STEPS steps; the first MPC_REF_STEPS held to
    # backward='scan', rollout='scan'.
    with counting(solver_module, "_backward") as passes:
        res, secs, counts = timed_run(lambda: run_mpc(
            p.system, p.plant, p.x0, p.U0_mpc, WIDE_STEPS, p.config_mpc))
    print(f"quadrotor3d MPC H={p.U0_mpc.shape[0]} ({WIDE_STEPS} of "
          f"{p.n_sim} steps, rk4 solver / euler plant, pallas/pallas): "
          f"{secs:.2f} s, {secs / WIDE_STEPS * 1e3:.1f} ms per step, "
          f"{int(res.solve_iters.sum())} iterations, launches {counts}")
    gate("flight MPC", "flight_mpc_20", float(res.cost),
         bool(torch.isfinite(res.X).all()))
    need("flight MPC", counts, ("fused_riccati", "linesearch_costs",
                                "closed_loop_rollout", "open_loop_rollout"))
    if counts["fused_riccati"] != passes[0]:
        raise AssertionError("flight MPC: B1 launches differ from passes")
    cfg = dataclasses.replace(p.config_mpc, backward="scan", rollout="scan")
    ref, ref_secs, _ = timed_run(lambda: run_mpc(
        p.system, p.plant, p.x0, p.U0_mpc, MPC_REF_STEPS, cfg))
    dx = float((res.X[:MPC_REF_STEPS + 1] - ref.X).abs().max())
    print(f"  the first {MPC_REF_STEPS} steps agree with backward='scan', "
          f"rollout='scan' to {dx:.2e} (limit {ATOL_MPC}); {ref_secs:.2f} s")
    if not dx <= ATOL_MPC:
        raise AssertionError("flight MPC: kernels and scan differ")
    out["flight_mpc"] = (res, secs, counts)

    # The planar quadrotor dash (B6w at n = 6), then TVLQR gains (B1w at
    # (6, 2)) on the 20 % heavier plant.
    d = systems["dash"]
    with counting(limited_parallel, "suffix_scan_fused") as sweeps:
        sol, secs, counts = timed_run(lambda: itt.solve(d.system, d.x0, d.U0,
                                                        d.config))
    print(f"quadrotor dash N={d.U0.shape[0]}: status {sol.status}, "
          f"{sol.iterations} iterations, {secs:.2f} s, {sweeps[0]} sweeps, "
          f"launches {counts}")
    gate("dash", "dash", float(sol.cost), sol.status == itt.CONVERGED
         and float(sol.U.max()) <= d.f_max + 1e-4)
    if counts.get("suffix_scan", 0) != sweeps[0] or sweeps[0] < 1:
        raise AssertionError("dash: B6 launches differ from the sweeps")
    (K, (X_tr, _, _)), tsecs, tcounts = timed_run(lambda: (
        K := tvlqr_gains(d.system, sol.X, sol.U,
                         backward=itt.backward_pass_fused,
                         **d.track_weights),
        track(d.plant, d.x0, sol.X, sol.U, K, u_limits=(0.0, d.f_max))))
    X_ol, _ = itt.rollout(d.plant, d.x0, sol.U)
    err_tr = float((X_tr[-1] - d.target).norm())
    err_ol = float((X_ol[-1] - d.target).norm())
    print(f"  TVLQR on the heavy plant: final error {err_tr:.4f} tracked, "
          f"{err_ol:.4f} open loop; launches {tcounts}")
    if tcounts.get("fused_riccati", 0) != 1 or not err_tr < err_ol:
        raise AssertionError("dash TVLQR: one B1w launch and a smaller "
                             "error than open loop expected")
    out["dash"] = (sol, secs, counts)
    out["dash_tvlqr"] = (K, tsecs, tcounts)

    # The bench's cart-pole MPC (B1 at (4, 1), B2's cart-pole).
    cart = systems["cart"]
    cfg = itt.IlqrConfig(maxiter=10, tol=1e-5, backward="pallas",
                         rollout="pallas")
    x0 = torch.tensor([0.0, 0.3, 0.0, 0.0], dtype=torch.float32, device=dev)
    U0 = torch.zeros((200, 1), dtype=torch.float32, device=dev)
    res, secs, counts = timed_run(lambda: run_mpc(cart, cart, x0, U0,
                                                  WIDE_STEPS, cfg))
    print(f"cart-pole MPC H=200 ({WIDE_STEPS} of 200 steps, pallas/pallas): "
          f"{secs:.2f} s, {secs / WIDE_STEPS * 1e3:.1f} ms per step, "
          f"{int(res.solve_iters.sum())} iterations, launches {counts}")
    gate("cart-pole MPC", "cartpole_mpc_20", float(res.cost),
         bool(torch.isfinite(res.X).all()))
    need("cart-pole MPC", counts, ("fused_riccati", "linesearch_costs",
                                   "closed_loop_rollout",
                                   "open_loop_rollout"))
    out["cartpole_mpc"] = (res, secs, counts)

    # The car's AL solve (B1 at (4, 2), B2's car per alpha).
    c = systems["car"]
    with counting(constrained, "_backward") as passes:
        sol, secs, counts = timed_run(lambda: itt.solve_constrained(
            c.system, c.constraints, c.x0, c.U0, c.config, c.al_config))
    print(f"car AL N={c.U0.shape[0]}: status {sol.status}, "
          f"{sol.outer_iterations} outer / {sol.inner_iterations} inner, "
          f"violation {float(sol.violation):.2e}, {secs:.2f} s, "
          f"{passes[0]} backward passes, launches {counts}")
    gate("car AL", "car", float(sol.cost), sol.status == itt.CONVERGED
         and float(sol.violation) <= c.al_config.ctol)
    need("car AL", counts, ("closed_loop_rollout", "open_loop_rollout"))
    if counts.get("fused_riccati", 0) != passes[0]:
        raise AssertionError("car AL: B1 launches differ from the passes")
    out["car"] = (sol, secs, counts)
    return out


def wide_phases(itt, dev, smi, launches_per_call) -> list:
    """Phases 26-30 (this slice's kernels and solves); returns the kernels
    line's rows of B1w, B6w and B2's new models."""
    from ilqr_tpu_torch.ops import _build, parallel_riccati

    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load().lib
    errors = {k: 0.0 for k in (
        "fused_riccati_wide", "fused_riccati_wide_defects",
        "suffix_scan_wide", "linesearch_costs_models",
        "closed_loop_rollout_models", "open_loop_rollout_models")}
    t_lap = time.perf_counter()

    def lap(phase):
        nonlocal t_lap
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_lap:.1f} s")
        t_lap = now

    systems = wide_systems(itt, dev)
    exps = wide_expansions(itt, systems, f32)
    # ---- 26. B1w ----
    print(f"B1w tolerance: field by field, max|kernel - plain| <= "
          f"max({RTOL_B1} * max|plain|, {F32_FLOOR} * max|plain - plain in "
          f"f64|) (phase 2's)")
    wide_b1_checks(itt, lib, exps, errors)
    lap(26)
    # ---- 27. B6w ----
    timed_el = wide_b6_checks(itt, lib, exps, errors)
    lap(27)
    # ---- 28. B2's new models ----
    wide_b2_checks(itt, dev, errors)
    lap(28)
    # ---- 29. the slice's solves ----
    runs = wide_solves(itt, dev, systems)
    lap(29)

    # ---- 30. timing at the bench's and the paths' shapes ----
    b1_cases = {f"({n_x}, {n_u}) N={WIDE_N}": tile_expansion(exps[n_x, n_u],
                                                              WIDE_N)
                for n_x, n_u in ((6, 2), (12, 4), (16, 4))}
    b1_t = design_timing(smi, "B1w", {
        k: lambda e=e: itt.backward_pass_fused(e, 0.0)
        for k, e in b1_cases.items()}, turns=3)
    b1_plain = {k: cuda_ms(lambda e=e: itt.backward_pass_associative(e, 0.0),
                           3, 1) for k, e in b1_cases.items()}
    b6_t = design_timing(smi, "B6w", {
        k: lambda e=e: itt.suffix_scan_fused(e) for k, e in timed_el.items()},
        turns=3)
    b6_plain = {k: cuda_ms(lambda e=e: parallel_riccati.suffix_scan(e), 3, 1)
                for k, e in timed_el.items()}
    q3 = systems["flight"].system
    b2_cases = {}
    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    for N in (50, 150, 500):
        x0, X, U, u_ff, K = wide_model_nominal(q3, "quadrotor3d", N, 3, f32)
        b2_cases[N] = (x0, X, U, u_ff, K)
    rows = []
    lpc = launches_per_call
    mpc_counts = runs["flight_mpc"][2]

    def row(name, source, replaces, launches, err, t, plain_ms, b, **more):
        key = ("fused_riccati_wide" if "riccati" in name else
               "suffix_scan_wide" if "suffix" in name else None)
        ms, cols = timing_columns(t, lpc.get(key))
        rows.append(dict(
            name=name, route="cuda", source=f"ilqr_tpu_torch/csrc/{source}",
            replaces=f"ilqr_tpu/ops/{replaces}", launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None, **cols, **more))

    path_launches = {"(6, 2)": runs["dash_tvlqr"][2].get("fused_riccati", 0),
                     "(12, 4)": mpc_counts.get("fused_riccati", 0)}
    for label, e in b1_cases.items():
        n_x, n_u = e.f_x.shape[-1], e.l_u.shape[-1]
        b = bound(4 * (expansion_floats(WIDE_N, n_x, n_u)
                       + WIDE_N * (n_u + n_u * n_x) + 2),
                  WIDE_N * riccati_step_ops(n_x, n_u))
        row(f"fused_riccati_wide_{n_x}x{n_u}_n{WIDE_N}", "fused_riccati.cu",
            "pallas_riccati.py:774", 0, errors["fused_riccati_wide"],
            b1_t[label], b1_plain[label], b,
            path_launches_other_shape=path_launches.get(f"({n_x}, {n_u})",
                                                        0))
    # B1w at the paths' own shapes: the flight MPC's (12, 4), H = 50, and
    # the dash TVLQR's (6, 2), N = 300.
    path_cases = {"(12, 4) H=50": tile_expansion(exps[12, 4], 50),
                  "(6, 2) N=300": exps[6, 2]}
    pt = design_timing(smi, "B1w", {
        k: lambda e=e: itt.backward_pass_fused(e, 0.0)
        for k, e in path_cases.items()}, turns=3)
    for (label, e), key in zip(path_cases.items(), ("(12, 4)", "(6, 2)")):
        n_x, n_u, N = e.f_x.shape[-1], e.l_u.shape[-1], e.f_x.shape[0]
        row(f"fused_riccati_wide_{n_x}x{n_u}_n{N}", "fused_riccati.cu",
            "pallas_riccati.py:774", path_launches[key],
            errors["fused_riccati_wide"], pt[label],
            cuda_ms(lambda e=e: itt.backward_pass_associative(e, 0.0), 3, 1),
            bound(4 * (expansion_floats(N, n_x, n_u) + N * (n_u + n_u * n_x)
                       + 2), N * riccati_step_ops(n_x, n_u)))
    for label, el in timed_el.items():
        M, n = el.A.shape[0], el.A.shape[-1]
        F = 3 * n * n + 2 * n
        path = runs["flight" if "flight" in label else "dash"][2]
        row(f"suffix_scan_wide_n{n}_m{M}", "suffix_scan.cu",
            "pallas_riccati.py:515", path.get("suffix_scan", 0),
            errors["suffix_scan_wide"], b6_t[label], b6_plain[label],
            bound(4 * 2 * M * F, (M - 1) * combine_ops(n)))
    # B2's 3-D quadrotor under rk4: the MPC's H = 50 (its launches), and
    # N = 150 and 500.
    for N, (x0, X, U, u_ff, K) in b2_cases.items():
        bnd = chain_bounds(12, 4, N, alphas.numel(), model="quadrotor3d",
                           integrator="rk4")
        launches = mpc_counts if N == 50 else {}
        cases = {
            "linesearch_costs": (
                lambda: itt.linesearch_costs_fused(q3, x0, alphas, X, U,
                                                   u_ff, K),
                lambda: itt.linesearch_rollouts(q3, x0, alphas, X, U, u_ff,
                                                K)),
            "closed_loop_rollout": (
                lambda: itt.closed_loop_rollout_fused(q3, x0, 0.5, X, U,
                                                      u_ff, K),
                lambda: itt.closed_loop_rollout(q3, x0, 0.5, X, U, u_ff,
                                                K)),
            "open_loop_rollout": (
                lambda: itt.open_loop_rollout_fused(q3, x0, U),
                lambda: itt.rollout(q3, x0, U))}
        t = design_timing(smi, f"B2 quadrotor3d rk4 N={N}",
                          {k: v[0] for k, v in cases.items()}, turns=3)
        for name, (_, plain) in cases.items():
            row(f"{name}_quadrotor3d_n{N}", "chain_models.cu",
                "pallas_rollout.py:92" if name == "linesearch_costs"
                else "pallas_rollout.py:132", launches.get(name, 0),
                errors[f"{name}_models"], t[name], cuda_ms(plain, 1, 0),
                bnd[name])
    # B2 at the cart-pole MPC's shape (H = 200, rk4, its costs entry) and
    # the car AL's (N = 120, rk4, one alpha's trajectory a launch).
    cart, car = systems["cart"], systems["car"].system
    xc, Xc, Uc, fc, Kc = wide_model_nominal(cart, "cartpole", 200, 5, f32)
    xr, Xr, Ur, fr, Kr = wide_model_nominal(car, "car", 120, 6, f32)
    cases = {
        "cart-pole H=200 costs": (
            lambda: itt.linesearch_costs_fused(cart, xc, alphas, Xc, Uc, fc,
                                               Kc),
            lambda: itt.linesearch_rollouts(cart, xc, alphas, Xc, Uc, fc,
                                            Kc),
            "linesearch_costs_cartpole_h200", "pallas_rollout.py:92",
            runs["cartpole_mpc"][2].get("linesearch_costs", 0),
            chain_bounds(4, 1, 200, alphas.numel(), model="cartpole",
                         integrator="rk4")["linesearch_costs"],
            "linesearch_costs_models"),
        "car N=120 trajectory": (
            lambda: itt.closed_loop_rollout_fused(car, xr, 0.5, Xr, Ur, fr,
                                                  Kr),
            lambda: itt.closed_loop_rollout(car, xr, 0.5, Xr, Ur, fr, Kr),
            "closed_loop_rollout_car_n120", "pallas_rollout.py:132",
            runs["car"][2].get("closed_loop_rollout", 0),
            chain_bounds(4, 2, 120, 1, model="car",
                         integrator="rk4")["closed_loop_rollout"],
            "closed_loop_rollout_models")}
    t = design_timing(smi, "B2 cart-pole and car", {
        k: v[0] for k, v in cases.items()}, turns=3)
    for label, (_, plain, name, replaces, launches, b, ekey) in cases.items():
        row(name, "chain_models.cu", replaces, launches, errors[ekey],
            t[label], cuda_ms(plain, 1, 0), b)
    lap(30)
    return rows


# ---- Phases 31-34: the wider models' batched and parallel-in-time paths ----
# (B4w, B5n, B3w).  P1: batched solves of the 3-D quadrotor
# (tests/test_quadrotor3d.py:27-29, 146-156: dt 0.02, target (1, 1, 1),
# default_weights, hover controls, N = 80, maxiter 40, tol 1e-5), its x0
# spread over [-0.2, 0.2] in x widened to WB_B instances, and a batch of
# WB_ROTOR_B of the rotor variant; P2: batched MPC of the planar quadrotor
# of examples/quadrotor_dash.py and the cart-pole of bench.py:795-799,
# WB_MPC_B instances, H = WB_MPC_H, WB_MPC_STEPS steps; P3: P1's problem at
# B = 1 by the defect line search and by multiple shooting.
WB_B = 256
WB_N = 80
WB_ROTOR_B = 16
WB_MPC_B = 64
WB_MPC_H = 100
WB_MPC_STEPS = 5       # cut from 20 when phase 35 came, then from 10
P1_SAMPLES = (0, 127, 255)
P1_X0 = -0.2           # P3's instance: P1's first
# B4w's shapes: the planar quadrotor (6, 2), an (8, 2) corner of the
# 8 x 8 padding, the 3-D quadrotor (12, 4), its rotor variant (16, 4) and
# the widest (16, 16).
WB_B4_SHAPES = ((6, 2), (8, 2), (12, 4), (16, 4), (16, 16))
WB_B5_BATCHES = (1, 3, 64)
WB_B5_N = 33           # across the chain ring's 32-step chunk edge
# B3w: n and candidates (the solver's 10, one past the register form's
# 16, and past a block's 16 groups of 16 lanes).
WB_B3_STATES = (6, 12, 16)
WB_B3_CANDIDATES = (1, 10, 17, 33)
WB_B3_LONG = 20000     # the longest horizon, at up to 10 candidates


def batched_random_expansion(itt, B, N, n_x, n_u, seed, f32):
    """A seeded batched expansion at (n_x, n_u) with positive definite
    l_uu (B instances of `random_expansion`'s kind)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, N, n_u, n_u))
    e = dict(f_x=np.eye(n_x) + 0.05 * rng.standard_normal((B, N, n_x, n_x)),
             f_u=0.3 * rng.standard_normal((B, N, n_x, n_u)),
             l_x=rng.standard_normal((B, N, n_x)),
             l_u=rng.standard_normal((B, N, n_u)),
             l_xx=np.broadcast_to(np.eye(n_x), (B, N, n_x, n_x)).copy(),
             l_ux=0.1 * rng.standard_normal((B, N, n_u, n_x)),
             l_uu=M @ np.swapaxes(M, -1, -2) / n_u + np.eye(n_u),
             v_x=rng.standard_normal((B, n_x)),
             v_xx=10.0 * np.broadcast_to(np.eye(n_x), (B, n_x, n_x)).copy())
    return itt.TrajectoryExpansion(**{k: torch.tensor(v, **f32)
                                      for k, v in e.items()})


def model_batch(system, name, B, N, seed, f32):
    """(x0s, X, U, u_ff, K) of B instances: phase 28's nominal
    (`wide_model_nominal`) at seeds seed, seed + 1, ..., rolled out as one
    batch (tests/test_torch_chain_models_host.py bounds them)."""
    from ilqr_tpu_torch.ops.rollout import rollout

    x0s, U, u_ff, K = (torch.stack(t).contiguous() for t in zip(*(
        nominal_draws(system, name, N, seed + b, f32) for b in range(B))))
    X, _ = rollout(system, x0s, U)
    return x0s, X.contiguous(), U, u_ff, K


def p2_systems(itt, f32):
    """P2's systems: examples/quadrotor_dash.py's planar quadrotor (its
    thrust limits left out: batched solves take none) with its hover
    controls, and bench.py:795-799's cart-pole (rk4, dt 0.01)."""
    from ilqr_tpu_torch.models import quadrotor
    quad = itt.make_quadrotor(
        0.01, [3.0, 1.0, 0.0, 0.0, 0.0, 0.0],
        np.diag([1.0, 1.0, 0.5, 0.1, 0.1, 0.1]), 0.1 * np.eye(2),
        np.diag([200.0, 200.0, 50.0, 20.0, 20.0, 10.0]), **f32)
    cart = itt.make_cartpole(
        0.01, [0.0, np.pi, 0.0, 0.0], Q=np.diag([1.0, 10.0, 0.1, 0.1]),
        R=0.1 * np.eye(1), Q_f=np.diag([100.0, 500.0, 10.0, 10.0]),
        integrator="rk4", **f32)
    return {"quadrotor": quad,
            "hover_quadrotor": quadrotor.hover_controls(quad.params),
            "cartpole": cart}


def p1_problem(itt, f32, rotor=False):
    """P1's system (the rotor variant with its lag states at hover) and
    hover controls."""
    from ilqr_tpu_torch.models import quadrotor3d
    Q, R, Q_f = quadrotor3d.default_weights(**f32)
    target = [1.0, 1.0, 1.0] + [0.0] * 9
    if rotor:
        system = itt.make_quadrotor3d_rotor(
            0.02, target + [1.226] * 4,
            torch.block_diag(Q, 0.01 * torch.eye(4, **f32)), R,
            torch.block_diag(Q_f, torch.eye(4, **f32)), **f32)
    else:
        system = itt.make_quadrotor3d(0.02, target, Q, R, Q_f, **f32)
    return system, quadrotor3d.hover_controls(system.params)


def p1_x0s(B, n_x, f32):
    """tests/test_quadrotor3d.py's spread, x over [-0.2, 0.2], at B (the
    rotor variant's lag states at hover)."""
    x0s = torch.zeros((B, n_x), **f32)
    x0s[:, 0] = torch.linspace(-0.2, 0.2, B, **f32)
    if n_x == 16:
        x0s[:, 12:] = 1.226
    return x0s


def wide_batched_phases(itt, dev, smi, launches_per_call) -> list:
    """Phases 31-34: B4w, B5n and B3w against their plain versions, the
    paths P1-P3 through them, and their timing.  Returns the kernels
    line's rows of B4w, B5n and B3w."""
    from ilqr_tpu_torch import mpc as mpc_module
    from ilqr_tpu_torch.ops import _build, affine_scan, batched
    from ilqr_tpu_torch.parallel import batch as batch_module

    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load().lib
    rng = np.random.default_rng(41)
    t_lap = time.perf_counter()

    def lap(phase):
        nonlocal t_lap
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_lap:.1f} s")
        t_lap = now

    def bits(t):
        """A tensor's bits (NaN payloads compare equal to themselves)."""
        if t.dtype == torch.float32:
            return t.contiguous().view(torch.int32)
        return t

    def twice(label, fn):
        torch.cuda.synchronize()
        got, again = fn(), fn()
        torch.cuda.synchronize()
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)
                   if a is not None):
            raise AssertionError(f"{label}: a repeated call gave other bits")
        return got

    # ---- 31. B4w --------------------------------------------------------
    print(f"B4w tolerance: B4's, max|kernel - plain| <= max({RTOL_B4} * "
          f"max|plain|, {F32_FLOOR} * max|plain - plain in f64|); a warp "
          f"an instance (lanes, padded size at "
          + ", ".join(f"{s}: {lib.ilqr_batched_riccati_wide_lanes(*s)}, "
                      f"{lib.ilqr_batched_riccati_wide_pad(*s)}"
                      for s in WB_B4_SHAPES)
          + "); every call twice, bit for bit")

    def check_b4w(label, exp, reg, ok_want=None):
        got = twice(f"B4w {label}",
                    lambda: itt.backward_pass_batched(exp, reg, "pallas"))
        plain = batched.vmap_backward(itt.backward_pass, exp, reg)
        ref64 = batched.vmap_backward(
            itt.backward_pass, as_f64(exp),
            reg.double() if torch.is_tensor(reg) else reg)
        torch.cuda.synchronize()
        keep = torch.ones(exp.f_x.shape[0], dtype=torch.bool, device=dev)
        if ok_want is not None:
            keep = ok_want
        one = {"err": 0.0}
        notes = check_fields(f"B4w {label}", [g[keep] for g in got[:3]],
                             [p[keep] for p in plain[:3]],
                             [r[keep] for r in ref64[:3]], RTOL_B4, one,
                             "err")
        if not torch.equal(got[3], plain[3]):
            raise AssertionError(f"B4w {label}: ok flags differ from the "
                                 f"plain version's")
        if ok_want is None and not bool(got[3].all()):
            raise AssertionError(f"B4w {label}: gains not finite")
        print(f"B4w {label}: B={exp.f_x.shape[0]} N={exp.f_x.shape[1]} "
              f"(n_x, n_u)=({exp.f_x.shape[-1]}, {exp.l_u.shape[-1]}) max abs "
              f"error " + "; ".join(notes) + "; repeated call bit-identical")
        return one["err"]

    def rollout_expansion(system, x0s, u, steps):
        """The expansion along hover controls plus noise 0.01: at 0.1 (dt
        0.02, 80 steps) the 3-D quadrotors tumble (states reach 16), Q_uu
        turns indefinite at reg 0 and any f32 recursion parts from f64
        without bound (the plain one by 1e-4 of its max, B4w's explicit
        inverse, in a numpy model of its steps too, by overflow)."""
        U = (u + torch.tensor(0.01 * rng.standard_normal(
            (x0s.shape[0], steps, system.n_u)), **f32)).contiguous()
        X, _ = itt.rollout(system, x0s, U)
        return itt.linearize_trajectory_batched(system, X, U)

    q3, u_q3 = p1_problem(itt, f32)
    rotor, u_rot = p1_problem(itt, f32, rotor=True)
    systems = p2_systems(itt, f32)
    quad = systems["quadrotor"]
    u_quad = systems["hover_quadrotor"]
    path_exps = {
        (6, 2): rollout_expansion(quad, torch.zeros((WB_B, 6), **f32), u_quad,
                                  WB_N),
        (12, 4): rollout_expansion(q3, p1_x0s(WB_B, 12, f32), u_q3, WB_N),
        (16, 4): rollout_expansion(rotor, p1_x0s(WB_B, 16, f32), u_rot, WB_N),
    }
    chunk = lib.ilqr_batched_riccati_wide_chunk_steps()
    print(f"B4w: one instance a block, {chunk}-step chunks in its ring")
    for (n_x, n_u) in WB_B4_SHAPES:
        exp = path_exps.get((n_x, n_u))
        if exp is None:
            exp = batched_random_expansion(itt, WB_B, WB_N, n_x, n_u,
                                           n_x + n_u, f32)
        check_b4w(f"{n_x}x{n_u} reg 0", exp, 0.0)
        check_b4w(f"{n_x}x{n_u} per-instance reg", exp,
                  torch.linspace(0.0, 0.2, WB_B, **f32))
        # B + 1, N = 1 and 2, the ring's chunk edges and an odd N (instance
        # rows at every 4-byte phase).
        edge = batched_random_expansion(itt, WB_B + 1, 2 * WB_N + 1, n_x, n_u,
                                        7 * n_x + n_u, f32)
        for steps in (1, 2, chunk - 1, chunk, chunk + 1, 2 * WB_N + 1):
            check_b4w(f"{n_x}x{n_u} edges reg 0.1", dataclasses.replace(
                edge, **{f: getattr(edge, f)[:, :steps].contiguous()
                         for f in ("f_x", "f_u", "l_x", "l_u", "l_xx",
                                   "l_ux", "l_uu")}), 0.1)
    # A singular Q_uu (zero, with f_u = 0 at that step) in two instances.
    sing = batched_random_expansion(itt, 9, 12, 12, 4, 3, f32)
    f_u, l_uu = sing.f_u.clone(), sing.l_uu.clone()
    for b in (2, 7):
        f_u[b, 5] = 0.0
        l_uu[b, 5] = 0.0
    want = torch.ones(9, dtype=torch.bool, device=dev)
    want[[2, 7]] = False
    check_b4w("12x4 singular Q_uu in instances 2 and 7",
              dataclasses.replace(sing, f_u=f_u, l_uu=l_uu), 0.0,
              ok_want=want)
    # The register form, re-timed in the same call at bench.py's batched
    # cell (B = 1024, N = 128): pendulum (2, 1), UA-DP (4, 1), DP (4, 2).
    reg_cases = {f"register form ({nx}, {nu}) B=1024 N=128":
                 batched_random_expansion(itt, 1024, 128, nx, nu, nx + nu,
                                          f32)
                 for nx, nu in ((2, 1), (4, 1), (4, 2))}
    reg_t = design_timing(smi, "B4", {
        k: lambda e=e: itt.backward_pass_batched(e, 0.0)
        for k, e in reg_cases.items()}, turns=3)
    lap(31)

    # ---- 32. B5n ------------------------------------------------------------
    print(f"B5n tolerance: B5's, max|kernel - plain| <= {RTOL_B5} * "
          f"max|plain| (the plain batched rollouts in f32 on the card); "
          f"N = {WB_B5_N}, B {WB_B5_BATCHES}, along phase 28's nominals; "
          f"every call twice, bit for bit")
    alpha_all = torch.tensor([0.5 ** i for i in range(33)], **f32)

    def gate5(label, got, ref):
        """(max abs error, its share of max |plain|), within RTOL_B5."""
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"B5n {label}: non-finite kernel output")
        err, rel = rel_err(got, ref)
        if not rel <= RTOL_B5:
            raise AssertionError(f"B5n {label}: max error {err:.3e} is "
                                 f"{rel:.3e} of max |plain|")
        return err, rel

    from ilqr_tpu_torch.ops import fused_rollout
    for integ in ("euler", "midpoint", "rk4"):
        for name, system in wide_model_systems(itt, f32, integ).items():
            worst = 0.0
            for nb in WB_B5_BATCHES:
                x0s, X, U, u_ff, K = model_batch(system, name, nb, WB_B5_N,
                                                 300 + 7 * nb, f32)
                label = f"{name} {integ} B={nb}"
                for A in ((1, 10, 33) if nb == 3 else (10,)):
                    (c,) = twice(label, lambda: (itt.linesearch_costs_batched(
                        system, x0s, alpha_all[:A], X, U, u_ff, K),))
                    ref = itt.linesearch_rollouts(system, x0s, alpha_all[:A],
                                                  X, U, u_ff, K)[2]
                    worst = max(worst, gate5(f"{label} costs A={A}", c,
                                             ref)[1])
                alpha_b = alpha_all[torch.tensor(rng.integers(0, 10, nb),
                                                 device=dev)]
                got = twice(label, lambda: itt.closed_loop_rollout_batched(
                    system, x0s, alpha_b, X, U, u_ff, K))
                ref = itt.linesearch_rollouts(system, x0s, alpha_b[:, None],
                                              X, U, u_ff, K)
                for what, g, r in zip(("X", "U", "cost"), got, ref):
                    worst = max(worst, gate5(f"{label} trajectory {what}",
                                             g, r[:, 0])[1])
                got = twice(label, lambda: itt.open_loop_rollout_batched(
                    system, x0s, U))
                for what, g, r in zip(("X", "cost"), got,
                                      itt.rollout(system, x0s, U)):
                    worst = max(worst, gate5(f"{label} open loop {what}",
                                             g, r)[1])
            print(f"B5n {name} {integ} (model id "
                  f"{fused_rollout.device_model(system)[0]}): B "
                  f"{WB_B5_BATCHES}, three entries: max rel error "
                  f"{worst:.2e}; repeated calls bit-identical")
    lap(32)

    # ---- 33. B3w ------------------------------------------------------------
    T3 = affine_scan.tile_steps(lib, 12, 10)
    resident = max(resident_tiles(lib.ilqr_affine_prefix_scan_occupancy(
        n, 10), f"B3w n={n}") for n in WB_B3_STATES)
    sizes = (1, T3 - 1, T3, T3 + 1, 5 * T3 + T3 // 2 + 3,
             (resident + 3) * T3 + 5, WB_B3_LONG)
    print(f"B3w tolerance: B3's (phase 6); tiles of {T3} steps, horizons "
          f"{sizes}")
    errs = {"affine_prefix_scan": 0.0}   # check_b3's record, unread here
    for N3 in sizes:
        for n in WB_B3_STATES:
            for A in WB_B3_CANDIDATES:
                if N3 > 2000 and A > 10:
                    continue
                check_b3(itt, "wide random chain",
                         *random_chain(N3, n, A, N3 + 10 * n + A, f32), errs)
    # n in {2, 4} past 16 candidates takes the wide form too.
    for n in (2, 4):
        check_b3(itt, "register n past 16 candidates",
                 *random_chain(700, n, 17, 5 + n, f32), errs)
    lap(33)

    # ---- 34. the paths through the kernels, and their timing -----------------
    runs = {}
    sched = itt.IlqrConfig(maxiter=40, tol=1e-5, rollout="pallas")
    x0s = p1_x0s(WB_B, 12, f32)
    U0 = u_q3.expand(WB_N, 4).contiguous()
    sol, secs, counts = timed_run(lambda: batch_module.solve_batched(
        q3, x0s, U0, sched, mesh=None))
    runs["p1"] = counts
    n_conv = int((sol.status == itt.CONVERGED).sum())
    print(f"P1 3-D quadrotor B={WB_B} N={WB_N} (solve_batched, "
          f"rollout=pallas, backward auto): {secs:.2f} s, {n_conv}/{WB_B} "
          f"CONVERGED, iterations {int(sol.iterations.min())}-"
          f"{int(sol.iterations.max())}, launches {counts}")
    need("P1", counts, ("batched_riccati", "linesearch_costs_batched",
                        "closed_loop_rollout_batched",
                        "open_loop_rollout_batched"))
    if not (bool(torch.isfinite(sol.cost).all())
            and bool(torch.isfinite(sol.X).all())):
        raise AssertionError("P1: non-finite instances")
    scan = dataclasses.replace(sched, rollout="scan", backward="scan")
    for i in P1_SAMPLES:
        one = itt.solve(q3, x0s[i], U0, scan)
        c, c1 = float(sol.cost[i]), float(one.cost)
        jax_c = JAX_F32[f"p1_{i}"]
        dx = float((sol.X[i] - one.X).abs().max())
        du = float((sol.U[i] - one.U).abs().max())
        print(f"  P1 instance {i}: cost {c:.7f}, status "
              f"{int(sol.status[i])}; single-instance scan {c1:.7f} "
              f"(rel {abs(c - c1) / abs(c1):.1e}, X {dx:.1e}, U {du:.1e}); "
              f"JAX f32 {jax_c} (rel {abs(c - jax_c) / jax_c:.1e})")
        if not (int(sol.status[i]) == itt.CONVERGED
                and abs(c - jax_c) <= RTOL_AL * jax_c
                and abs(c - c1) <= RTOL_BATCH * abs(c1)
                and dx <= ATOL_BATCH_X and du <= ATOL_BATCH_U):
            raise AssertionError(f"P1 instance {i}: gates not met")
    # The rotor variant (16, 4).
    x0r = p1_x0s(WB_ROTOR_B, 16, f32)
    U0r = u_rot.expand(WB_N, 4).contiguous()
    solr, secs, counts = timed_run(lambda: batch_module.solve_batched(
        rotor, x0r, U0r, sched, mesh=None))
    runs["p1_rotor"] = counts
    print(f"P1 rotor variant B={WB_ROTOR_B} N={WB_N}: {secs:.2f} s, "
          f"{int((solr.status == itt.CONVERGED).sum())}/{WB_ROTOR_B} "
          f"CONVERGED, launches {counts}")
    need("P1 rotor", counts, ("batched_riccati", "linesearch_costs_batched",
                              "closed_loop_rollout_batched"))
    for i in (0, WB_ROTOR_B - 1):
        one = itt.solve(rotor, x0r[i], U0r, scan)
        c, c1 = float(solr.cost[i]), float(one.cost)
        dx = float((solr.X[i] - one.X).abs().max())
        print(f"  rotor instance {i}: cost {c:.7f}, single-instance scan "
              f"{c1:.7f} (rel {abs(c - c1) / abs(c1):.1e}, X {dx:.1e})")
        if not (bool(torch.isfinite(solr.cost).all())
                and abs(c - c1) <= RTOL_BATCH * abs(c1)
                and dx <= ATOL_BATCH_X):
            raise AssertionError(f"P1 rotor instance {i}: gates not met")

    # P2: batched MPC, the planar quadrotor and the cart-pole.
    mpc_cfg = itt.IlqrConfig(maxiter=10, tol=1e-5, rollout="pallas")
    # The per-instance loops run B1 and B2 (the B = 1 kernels).
    ref_cfg = dataclasses.replace(mpc_cfg, backward="pallas")
    for name, system, spread, u0 in (
            ("quadrotor", quad, (0, -0.3, 0.3), u_quad),
            ("cartpole", systems["cartpole"], (1, 0.1, 0.5),
             torch.zeros(1, **f32))):
        xs = torch.zeros((WB_MPC_B, system.n_x), **f32)
        xs[:, spread[0]] = torch.linspace(spread[1], spread[2], WB_MPC_B,
                                          **f32)
        U_h = u0.expand(WB_MPC_H, system.n_u).contiguous()
        res, secs, counts = timed_run(lambda: itt.run_mpc_batched(
            system, system, xs, U_h, WB_MPC_STEPS, mpc_cfg))
        runs[f"p2_{name}"] = counts
        print(f"P2 {name} batched MPC B={WB_MPC_B} H={WB_MPC_H}, "
              f"{WB_MPC_STEPS} steps: {secs:.2f} s, "
              f"{WB_MPC_B * WB_MPC_STEPS / secs:.1f} step-solves/s, "
              f"launches {counts}")
        need(f"P2 {name}", counts, ("batched_riccati",
                                    "linesearch_costs_batched",
                                    "closed_loop_rollout_batched",
                                    "open_loop_rollout_batched"))
        if not bool(torch.isfinite(res.X).all()):
            raise AssertionError(f"P2 {name}: non-finite states")
        for i in (0, WB_MPC_B - 1):
            one = mpc_module.run_mpc(system, system, xs[i], U_h, WB_MPC_STEPS,
                                     ref_cfg)
            dx = float((res.X[i] - one.X).abs().max())
            print(f"  P2 {name} instance {i}: against run_mpc {dx:.2e} "
                  f"(limit {ATOL_MPC})")
            if not dx <= ATOL_MPC:
                raise AssertionError(f"P2 {name} instance {i}: batched and "
                                     f"single-instance MPC differ")

    # P3: P1's problem at B = 1, by the defect line search (B3w at 10
    # candidates, B1w) and by multiple shooting (B1w with defects, B3w).
    x0 = torch.zeros(12, **f32)
    x0[0] = P1_X0
    ref = itt.solve(q3, x0, U0, scan)
    p3 = {
        "p3_defect": lambda: itt.solve(q3, x0, U0, itt.IlqrConfig(
            maxiter=40, tol=1e-5, rollout="defect", init_rollout="defect",
            backward="pallas", defect_engine="pallas")),
        "p3_ms": lambda: itt.solve_ms(
            q3, x0, U0, config=itt.IlqrConfig(maxiter=40, tol=1e-5,
                                              backward="pallas"),
            ms=itt.MsConfig(update_engine="pallas")),
    }
    for key, fn in p3.items():
        out, secs, counts = timed_run(fn)
        runs[key] = counts
        c, jax_c, c_ref = float(out.cost), JAX_F32[key], float(ref.cost)
        print(f"P3 {key}: status {out.status}, {out.iterations} iterations, "
              f"{secs:.2f} s, cost {c:.7f} (scan {c_ref:.7f}, rel "
              f"{abs(c - c_ref) / c_ref:.1e}; JAX f32 {jax_c}, rel "
              f"{abs(c - jax_c) / jax_c:.1e}), launches {counts}")
        need(key, counts, ("affine_prefix_scan", "fused_riccati"))
        if not (out.status == itt.CONVERGED
                and abs(c - c_ref) <= RTOL_AL * c_ref
                and abs(c - jax_c) <= RTOL_AL * jax_c):
            raise AssertionError(f"P3 {key}: gates not met")

    # C2's plain route on the card: a batched f64 solve of the planar
    # quadrotor under 'auto' answers (no B4 launch), equal to `solve`.
    quad64 = quad.replace(params={k: v.double()
                                  for k, v in quad.params.items()})
    xs64 = torch.zeros((4, 6), dtype=torch.float64, device=dev)
    xs64[:, 0] = torch.linspace(-0.3, 0.3, 4, dtype=torch.float64,
                                device=dev)
    U64 = u_quad.double().expand(50, 2).contiguous()
    cfg64 = itt.IlqrConfig(maxiter=10, tol=1e-6)
    sol64, secs, counts = timed_run(lambda: itt.solve_batch(quad64, xs64,
                                                            U64, cfg64))
    worst = max(abs(float(sol64.cost[i]) - float(itt.solve(
        quad64, xs64[i], U64, cfg64).cost)) for i in range(4))
    print(f"C2 f64 batched planar quadrotor under 'auto': {secs:.2f} s, "
          f"launches {counts}; against solve per instance {worst:.1e}")
    if counts.get("batched_riccati", 0) or not worst <= 1e-9:
        raise AssertionError("C2 f64: the plain route did not answer alike")

    # Timing at the paths' shapes.
    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    A10 = alphas.numel()
    rows = []

    def row(name, source, replaces, launches, err, t, plain_ms, b, lpc_key,
            **more):
        """A kernels-line row; err is the kernel's error against its plain
        version at this row's own inputs."""
        ms, cols = timing_columns(t, launches_per_call.get(lpc_key))
        rows.append(dict(
            name=name, route="cuda", source=f"ilqr_tpu_torch/csrc/{source}",
            replaces=f"ilqr_tpu/ops/{replaces}", launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None, **cols, **more))

    b4_cases = {
        "P1 (12, 4)": (path_exps[12, 4], runs["p1"], WB_B, WB_N),
        "P1 rotor (16, 4)": (rollout_expansion(rotor, x0r, u_rot, WB_N),
                             runs["p1_rotor"], WB_ROTOR_B, WB_N),
        "P2 quadrotor (6, 2)": (rollout_expansion(
            quad, torch.zeros((WB_MPC_B, 6), **f32), u_quad, WB_MPC_H),
            runs["p2_quadrotor"], WB_MPC_B, WB_MPC_H),
    }
    # Each path's shape held to the plain version before it is timed.
    e4 = {label: check_b4w(f"{label} reg 0", v[0], 0.0)
          for label, v in b4_cases.items()}
    t4 = design_timing(smi, "B4w", {
        k: lambda e=v[0]: itt.backward_pass_batched(e, 0.0)
        for k, v in b4_cases.items()}, turns=3)
    for label, (e, counts, nb, steps) in b4_cases.items():
        n_x, n_u = e.f_x.shape[-1], e.l_u.shape[-1]
        row(f"batched_riccati_wide_{n_x}x{n_u}_b{nb}_n{steps}",
            "batched_riccati.cu", "pallas_batched.py:114",
            counts.get("batched_riccati", 0), e4[label], t4[label],
            cuda_ms(lambda e=e: batched.vmap_backward(
                itt.backward_pass, e, 0.0), 1, 1),
            batched_bounds(nb, steps, A10, n_x, n_u)["batched_riccati"],
            "batched_riccati_wide")
    for label, t in reg_t.items():
        print(f"  B4 {label}: events {t['event_ms']:.4f} ms, device "
              f"{ms_text(t['device_us'])}")
    # B5n at P1's shape (3-D quadrotor, rk4) and P2's (the planar
    # quadrotor and the cart-pole), along each path's first iteration.
    b5_cases = {}
    for label, system, model, integ, x0b, u0, counts in (
            ("P1 quadrotor3d rk4", q3, "quadrotor3d", "rk4", x0s, u_q3,
             runs["p1"]),
            ("P2 quadrotor", quad, "quadrotor", quad.integrator,
             torch.zeros((WB_MPC_B, 6), **f32), u_quad, runs["p2_quadrotor"]),
            ("P2 cartpole rk4", systems["cartpole"], "cartpole", "rk4",
             torch.zeros((WB_MPC_B, 4), **f32), torch.zeros(1, **f32),
             runs["p2_cartpole"])):
        steps = WB_N if label.startswith("P1") else WB_MPC_H
        Ub = u0.expand(x0b.shape[0], steps, system.n_u).contiguous()
        Xb = itt.rollout(system, x0b, Ub)[0].contiguous()
        ub, Kb, _, _ = itt.backward_pass_batched(
            itt.linearize_trajectory_batched(system, Xb, Ub), 1.0)
        ab = torch.full((x0b.shape[0],), 0.5, **f32)
        b5_cases[label] = (system, model, integ, counts, steps, {
            "linesearch_costs_batched": (
                lambda s=system, a=(x0b, alphas, Xb, Ub, ub, Kb):
                itt.linesearch_costs_batched(s, *a),
                lambda s=system, a=(x0b, alphas, Xb, Ub, ub, Kb):
                itt.linesearch_rollouts(s, *a)),
            "closed_loop_rollout_batched": (
                lambda s=system, a=(x0b, ab, Xb, Ub, ub, Kb):
                itt.closed_loop_rollout_batched(s, *a),
                lambda s=system, a=(x0b, ab[:, None], Xb, Ub, ub, Kb):
                itt.linesearch_rollouts(s, *a)),
            "open_loop_rollout_batched": (
                lambda s=system, a=(x0b, Ub): itt.open_loop_rollout_batched(
                    s, *a),
                lambda s=system, a=(x0b, Ub): itt.rollout(s, *a))})

    def b5_outputs(entry, got, ref):
        """(output, kernel's, plain's) of one B5 entry: the plain batched
        rollouts carry an alpha axis (one alpha a row for the trajectory
        entry) and the line search's costs are their third output."""
        if entry == "linesearch_costs_batched":
            return [("costs", got[0], ref[2])]
        if entry == "closed_loop_rollout_batched":
            return [(w, g, r[:, 0])
                    for w, g, r in zip(("X", "U", "cost"), got, ref)]
        return list(zip(("X", "cost"), got, ref))

    for label, (system, model, integ, counts, steps, cases) in \
            b5_cases.items():
        nb = WB_B if label.startswith("P1") else WB_MPC_B
        # Each entry held to its plain version at the path's shape.
        e5 = {}
        for entry, (kernel, plain) in cases.items():
            got = twice(f"B5n {label} {entry}", lambda k=kernel: (
                (k(),) if entry == "linesearch_costs_batched" else k()))
            e5[entry], worst = 0.0, 0.0
            for what, g, r in b5_outputs(entry, got, plain()):
                err, rel = gate5(f"{label} {entry} {what}", g, r)
                e5[entry], worst = max(e5[entry], err), max(worst, rel)
            print(f"B5n {label} {entry} B={nb} N={steps}: max abs error "
                  f"{e5[entry]:.2e} (rel {worst:.1e}, limit {RTOL_B5}); "
                  f"repeated call bit-identical")
        t5 = design_timing(smi, f"B5n {label}",
                           {k: v[0] for k, v in cases.items()}, turns=3)
        bounds = batched_bounds(nb, steps, A10, system.n_x, system.n_u,
                                model=model, integrator=integ)
        for entry, (_, plain) in cases.items():
            row(f"{entry}_{model}_b{nb}_n{steps}", "chain_models.cu",
                "pallas_batched.py:377", counts.get(entry, 0), e5[entry],
                t5[entry], cuda_ms(plain, 1, 0), bounds[entry],
                f"{entry}_models")
    # B3w at P3's shape: the defect line search's 10 candidates and the
    # defect initial rollout's one (n = 12, N = 80).
    P3c, q3c, d3c = random_chain(WB_N, 12, A10, 17, f32)
    b3_cases = {f"P3 n=12 A={A} N={WB_N}": (P3c, q3c[:A].contiguous(),
                                            d3c[:A].contiguous())
                for A in (A10, 1)}
    e3 = {}
    for label, v in b3_cases.items():
        errs = {"affine_prefix_scan": 0.0}
        check_b3(itt, label, *v, errs)
        e3[label] = errs["affine_prefix_scan"]
    t3 = design_timing(smi, "B3w", {
        k: lambda a=v: itt.affine_prefix_scan_multi(*a, engine="pallas")
        for k, v in b3_cases.items()}, turns=3)
    for label, (Pc, qc, dc) in b3_cases.items():
        A = qc.shape[0]
        row(f"affine_prefix_scan_wide_n12_a{A}_n{WB_N}", "affine_scan.cu",
            "pallas_affine.py:137",
            runs["p3_defect"].get("affine_prefix_scan", 0), e3[label],
            t3[label],
            cuda_ms(lambda a=(Pc, qc, dc): itt.affine_prefix_scan_multi(
                *a, engine="xla"), 3, 1), b3_bound(WB_N, 12, A),
            "affine_prefix_scan_wide",
            ms_solve_launches=runs["p3_ms"].get("affine_prefix_scan", 0))
    lap(34)
    return rows


# ---- Phase 35: the rollout kernels on every system JAX's kernels take ------
# B2 and B5 on the LTI systems, the tracking and rate wrappers, the implicit
# rules of the cart-pole, the quadrotors and the car, and the spring chain
# (csrc/forms.cuh and the translation units beside chain_rollout.cu); B7w,
# the suffix scan's 'lane' layout at n outside {2, 4}.  The paths: P4, the
# reference tracking MPC (examples/reference_tracking_mpc.py: the tracked
# pendulum under rk4, H = 50, maxiter 8, backward='pallas'), with
# rollout='pallas', cut to P4_STEPS of its 600 steps; P5, batched solves of
# bench.py:795-799's cart-pole (rk4) wrapped with a rate penalty S = 0.1 I
# (n_x = 5, n_u = 1), P5_B instances from seeded x0s near the upright, N =
# P5_N; P6, examples/linear_lqr.py's double integrator (cont2disc at dt 0.1,
# make_discrete_lti, 'discrete', N = 50) by solve(rollout='pallas').  Their
# references are the JAX package's f32 results (JAX_F32, recomputed by
# tests/test_torch_chip_refs.py), gated within RTOL_AL.
# The longest kernel-edge horizon (cut from 500, and from 400 when phase 36
# came, for the time limit: the f64 plain references' host time grows with
# it; at 100 an edge check still crosses three of the ring's 32-step
# chunks).
WR_N = 100
WR_B5 = 3                # instances of the B5 edge checks
# The plain versions' child processes: the implicit rules' take up to ~50 s
# each on the host, the rest 2-10 s (324.6 s in all on the H100 machine's
# host); the main process mostly waits on the card and on them.
WR_WORKERS = 7
# The timed-only rows' horizon (the implicit rule's: WR_TIME_N // 2).
WR_TIME_N = 100
WR_REF_ROWS = 76         # a tracking reference of 75 steps: N = 100 clamps
WR_MODELS = ("pendulum", "ua_dp", "dp", "cartpole", "quadrotor",
             "quadrotor3d", "car")
WR_LTI = ((2, 1), (4, 1), (4, 2), (6, 2), (12, 4), (16, 4))
WR_IMPLICIT = ("cartpole", "quadrotor", "quadrotor3d", "quadrotor3d_rotor",
               "car")
P4_STEPS = 50            # cut from 100 when phase 36 came (time limit)
P5_B, P5_N = 256, 100
P5_SAMPLES = (0, 127, 255)
P6_N = 50
B7W_STATES = (6, 12, 16)
B7W_MS = (1, 151, 32769)


def lti_system(itt, n_x, n_u, integrator, f32):
    """A seeded LTI system at (n_x, n_u): A = S - 0.2 I with S
    skew-symmetric (a damped rotation), under 'discrete' I + 0.05 A (its
    Euler map at dt 0.05), B and x_target seeded; Q = I, R = 0.1 I,
    Q_f = 10 I."""
    rng = np.random.default_rng(10 * n_x + n_u)
    S = rng.standard_normal((n_x, n_x))
    A = (S - S.T) / np.sqrt(n_x) - 0.2 * np.eye(n_x)
    if integrator == "discrete":
        A = np.eye(n_x) + 0.05 * A
    return itt.make_lti(A, 0.5 * rng.standard_normal((n_x, n_u)), 0.05,
                        rng.standard_normal(n_x), np.eye(n_x),
                        0.1 * np.eye(n_u), 10.0 * np.eye(n_x),
                        integrator=integrator, **f32)


def wr_base(itt, name, integrator, f32):
    """A system of phase 35 by name: phase 3's pendulum and double
    pendulums ("pendulum", "ua_dp", "dp"), phase 28's models, and the LTI
    systems ("lti_{n_x}x{n_u}")."""
    if name.startswith("lti_"):
        n_x, n_u = map(int, name[4:].split("x"))
        return lti_system(itt, n_x, n_u, integrator, f32)
    if name == "pendulum":
        return chain_systems(itt, f32, integrator)["pendulum"]
    if name in ("ua_dp", "dp"):
        return dp_system(itt, f32, underactuated=name == "ua_dp",
                         integrator=integrator)
    return wide_model_systems(itt, f32, integrator)[name]


def wr_cases():
    """Every new instantiation as (kind, base, integrator): the LTI systems
    at WR_LTI under euler, midpoint, rk4 and 'discrete'; the tracking and
    rate wrappers over WR_MODELS under the explicit three and over the LTI
    systems but (16, 4) under the four; the implicit rules of WR_IMPLICIT;
    the spring chain (16 masses) under the explicit three."""
    explicit = ("euler", "midpoint", "rk4")
    lti = [f"lti_{n_x}x{n_u}" for n_x, n_u in WR_LTI]
    cases = [("lti", b, i) for i in explicit + ("discrete",) for b in lti]
    cases += [(k, m, i) for k in ("tracking", "rate") for i in explicit
              for m in WR_MODELS]
    cases += [(k, b, i) for k in ("tracking", "rate")
              for i in explicit + ("discrete",) for b in lti[:-1]]
    cases += [("model", m, i) for i in ("backward_euler", "trapezoidal")
              for m in WR_IMPLICIT]
    cases += [("chain", "chain", i) for i in explicit]
    return cases


def wr_system(itt, case, f32):
    """The system of a case of `wr_cases`.  The tracking references are
    WR_REF_ROWS seeded sinusoids (X_ref) and WR_REF_ROWS - 1 (U_ref, about
    the base's hover where it has one); Q = I, R = 0.1 I, Q_f = 10 I; the
    rate penalty S = 0.1 I."""
    kind, base, integ = case
    if kind == "chain":
        return itt.make_spring_chain(0.02, n_masses=16, integrator=integ,
                                     **f32)
    b = wr_base(itt, base, integ, f32)
    if kind == "tracking":
        t = torch.arange(WR_REF_ROWS, **f32)[:, None] * b.dt
        X_ref = 0.2 * torch.sin(t * torch.arange(1, b.n_x + 1, **f32))
        U_ref = 0.1 * torch.cos(t[:-1] * torch.arange(1, b.n_u + 1, **f32))
        if base.startswith("quadrotor"):
            U_ref = U_ref + 9.81 * 0.5 / b.n_u * (
                2.0 if base == "quadrotor" else 1.0)
        return itt.make_tracking_system(
            b, X_ref, U_ref, torch.eye(b.n_x, **f32),
            0.1 * torch.eye(b.n_u, **f32), 10.0 * torch.eye(b.n_x, **f32))
    if kind == "rate":
        return itt.make_rate_penalized_system(
            b, 0.1 * torch.eye(b.n_u, **f32))
    return b


def wr_draws(case, system, N, seed, f32):
    """x0, U, u_ff and K of a case: the base's part as phase 28 draws it
    for its models (`nominal_draws`) and at noise 0.3 (gains -0.05)
    elsewhere; a tracking clock starts at 0 with no gain on it, a rate
    wrapper's u_prev at U[0] with gains -0.05 of its noise."""
    kind, base, _ = case
    n_u = system.n_u
    n_b = (system.n_x - 1 if kind == "tracking" else
           system.n_x - n_u if kind == "rate" else system.n_x)
    if base in ("cartpole", "quadrotor", "quadrotor3d", "quadrotor3d_rotor",
                "car"):
        proxy = dataclasses.replace(system, n_x=n_b)
        x0, U, u_ff, K = nominal_draws(proxy, base, N, seed, f32)
    else:
        rng = np.random.default_rng(seed)
        x0, U, u_ff = (torch.tensor(0.3 * rng.standard_normal(s), **f32)
                       for s in (n_b, (N, n_u), (N, n_u)))
        K = torch.tensor(-0.05 * rng.standard_normal((N, n_u, n_b)), **f32)
    if kind == "tracking":
        x0 = torch.cat([x0, torch.zeros(1, **f32)])
        K = torch.cat([K, torch.zeros((N, n_u, 1), **f32)], dim=-1)
    elif kind == "rate":
        x0 = torch.cat([x0, U[0]])
        rng = np.random.default_rng(seed + 1)
        K = torch.cat([K, torch.tensor(-0.05 * rng.standard_normal(
            (N, n_u, n_u)), **f32)], dim=-1)
    return x0, U.contiguous(), u_ff, K.contiguous()


def wr_nominal(case, system, N, seed, f32, batch=None):
    """(x0, X, U, u_ff, K) of a case: `wr_draws` rolled out (``batch``
    instances at seeds seed, seed + 1, ..., stacked, when given)."""
    from ilqr_tpu_torch.ops.rollout import rollout

    if batch is None:
        x0, U, u_ff, K = wr_draws(case, system, N, seed, f32)
    else:
        x0, U, u_ff, K = (torch.stack(t).contiguous() for t in zip(*(
            wr_draws(case, system, N, seed + b, f32) for b in range(batch))))
    X, _ = rollout(system, x0, U)
    return x0, X.contiguous(), U, u_ff, K


def wr_alphas(kw):
    """Phase 3's 33 alphas, 0.5^i."""
    return torch.tensor([0.5 ** i for i in range(33)], **kw)


def params_f64(params):
    """A system's parameters (a wrapper's nested ones and a neural
    residual's layers too) in float64."""
    if isinstance(params, dict):
        return {k: params_f64(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_f64(v) for v in params)
    return params.double()


def wr_plain(case, seed: int, Ns) -> dict:
    """Phase 35's inputs and plain versions of one case, on the host (numpy
    out; run in a child process): WR_B5 instances' nominals at max(Ns) in
    f32 (one for the implicit rules, which JAX's batched kernel does not
    take), their closed loops of 33 alphas and their open loops in f64 and
    f32, and the costs of each prefix of N steps (the recursion is causal).
    Instance 0 serves B2; instance b's trajectory at alpha 0.5^b is its
    closed loop b, B5's per-instance alpha."""
    import ilqr_tpu_torch as itt
    from ilqr_tpu_torch.ops.rollout import linesearch_rollouts, rollout
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cpu32 = dict(dtype=torch.float32, device="cpu")
    system = wr_system(itt, case, cpu32)
    s64 = system.replace(params=params_f64(system.params))
    inputs = wr_nominal(case, system, max(Ns), seed, cpu32,
                        batch=1 if case[0] == "model" else WR_B5)
    out = {"inputs": [t.numpy() for t in inputs]}

    def prefix(sys_, X, U, N):
        p = sys_.params
        return (sys_.stage_cost(p, X[..., :N, :], U[..., :N, :]).sum(-1)
                + sys_.terminal_cost(p, X[..., N, :])).numpy()

    for key, sys_, cast in (("f64", s64, torch.Tensor.double),
                            ("f32", system, lambda t: t)):
        x0, X, U, u_ff, K = (cast(t) for t in inputs)
        X_P, U_P, _ = linesearch_rollouts(sys_, x0, cast(wr_alphas(cpu32)), X,
                                          U, u_ff, K)
        X_o, _ = rollout(sys_, x0, U)
        b = torch.arange(X_P.shape[0])
        out[key] = {"c_P": {N: prefix(sys_, X_P, U_P, N) for N in Ns},
                    "c_o": {N: prefix(sys_, X_o, U, N) for N in Ns},
                    "X_o": X_o.numpy(),
                    "X_t": X_P[b, b].numpy(), "U_t": U_P[b, b].numpy(),
                    "X_1": X_P[0, 1].numpy(), "U_1": U_P[0, 1].numpy()}
    out["seconds"] = time.perf_counter() - t0
    return out


def wr_family(case) -> str:
    """The kernels-line family of a case: lti, tracking, rate, implicit or
    chain."""
    return {"model": "implicit"}.get(case[0], case[0])


def wr_checks(itt, dev, lib, errors) -> None:
    """Phase 35's kernel edges: every case of `wr_cases` at N = 1, its
    ring chunk less and plus one (32 steps; the spring chain's 8) and WR_N:
    B2a with 1, 10 and 33 alphas, B2b at alpha 0.5 and the open loop, then
    (but for the implicit rules, which JAX's batched kernel does not take)
    B5's three entries on WR_B5 instances (10 alphas; instance b's
    trajectory at alpha 0.5^b), each call twice with equal bits required,
    against the plain versions in f64 on the host (`wr_plain`, in
    WR_WORKERS child processes while the kernels run; the nominals and
    gains the kernels' f32 ones) within phase 28's rule: RTOL_B2 of the
    output's max or F32_FLOOR times the plain version's own f32 error.
    Records the largest error of each entry and family in ``errors``."""
    f32 = dict(dtype=torch.float32, device=dev)
    alphas = wr_alphas(f32)
    cases = wr_cases()
    ns = {}
    for case in cases:
        s = wr_system(itt, case, f32)
        c = lib.ilqr_chain_chunk_steps_at(s.n_x, s.n_u)
        ns[case] = (1, c - 1, c + 1, WR_N)
    # The implicit rules' plain versions take longest: handed out first,
    # read last.
    pool = multiprocessing.get_context("spawn").Pool(WR_WORKERS)
    t_pool = time.perf_counter()
    jobs = {case: pool.apply_async(wr_plain, (case, 70 + i, ns[case]))
            for i, case in enumerate(sorted(cases,
                                            key=lambda c: c[0] != "model"))}

    def bits(t):
        return t.contiguous().view(torch.int32)

    def twice(fn):
        torch.cuda.synchronize()
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b)):
            raise AssertionError("phase 35: a repeated call gave other bits")
        return a

    def gate(label, key, got, ref, ref32):
        ref = torch.from_numpy(np.asarray(ref, dtype=np.float64))
        ref32 = torch.from_numpy(np.asarray(ref32, dtype=np.float64))
        got = got.cpu()
        err, rel = rel_err(got, ref)
        floor = rel_err(ref32, ref)[0]
        limit = max(RTOL_B2 * float(ref.abs().max()), F32_FLOOR * floor)
        errors[key] = max(errors.get(key, 0.0), err)
        if not (bool(torch.isfinite(got).all()) and err <= limit):
            raise AssertionError(f"{label}: {err:.3e} ({rel:.2e} of max), "
                                 f"limit {limit:.3e} (plain f32 vs f64 "
                                 f"{floor:.3e})")
        return rel

    def dev_t(arrays):
        return [torch.from_numpy(a).to(**f32) for a in arrays]

    print(f"phase 35 kernel edges: {len(cases)} instantiations, against the "
          f"plain rollouts in f64 on the host, max|kernel - plain f64| <= "
          f"max({RTOL_B2} * max|plain f64|, {F32_FLOOR} * max|plain f32 - "
          f"plain f64|); every call twice, bit for bit")
    host_s = 0.0
    try:
        for case in sorted(cases, key=lambda c: c[0] == "model"):
            system = wr_system(itt, case, f32)
            ref = jobs[case].get(timeout=1200)
            host_s += ref["seconds"]
            fam = wr_family(case)
            xb, Xb, Ub, ub, Kb = dev_t(ref["inputs"])
            x0, X, U, u_ff, K = xb[0], Xb[0], Ub[0], ub[0], Kb[0]
            r64, r32 = ref["f64"], ref["f32"]
            batch = xb.shape[0] > 1
            label = "{} {} {}".format(*case)
            worst = 0.0
            for N in ns[case]:
                Xn, Un, un, Kn = X[:N + 1], U[:N], u_ff[:N], K[:N]
                at = f"{label} N={N}"
                for A in CHAIN_ALPHA_COUNTS:
                    (c,) = twice(lambda: (itt.linesearch_costs_fused(
                        system, x0, alphas[:A], Xn, Un, un, Kn),))
                    worst = max(worst, gate(
                        f"{at} costs A={A}", f"linesearch_costs_{fam}", c,
                        r64["c_P"][N][0, :A], r32["c_P"][N][0, :A]))
                got = twice(lambda: itt.closed_loop_rollout_fused(
                    system, x0, float(alphas[1]), Xn, Un, un, Kn))
                for what, g, r, r_32 in (
                        ("X", got[0], r64["X_1"][:N + 1], r32["X_1"][:N + 1]),
                        ("U", got[1], r64["U_1"][:N], r32["U_1"][:N]),
                        ("cost", got[2], r64["c_P"][N][0, 1],
                         r32["c_P"][N][0, 1])):
                    worst = max(worst, gate(f"{at} trajectory {what}",
                                            f"closed_loop_rollout_{fam}", g,
                                            r, r_32))
                got = twice(lambda: itt.open_loop_rollout_fused(system, x0,
                                                                Un))
                for what, g, r, r_32 in (
                        ("X", got[0], r64["X_o"][0, :N + 1],
                         r32["X_o"][0, :N + 1]),
                        ("cost", got[1], r64["c_o"][N][0], r32["c_o"][N][0])):
                    worst = max(worst, gate(f"{at} open loop {what}",
                                            f"open_loop_rollout_{fam}", g, r,
                                            r_32))
                if not batch:
                    continue
                Xs, Us, us, Ks = (t[:, :n].contiguous() for t, n in zip(
                    (Xb, Ub, ub, Kb), (N + 1, N, N, N)))
                (c,) = twice(lambda: (itt.linesearch_costs_batched(
                    system, xb, alphas[:10], Xs, Us, us, Ks),))
                worst = max(worst, gate(f"{at} B5 costs",
                                        f"linesearch_costs_batched_{fam}", c,
                                        r64["c_P"][N][:, :10],
                                        r32["c_P"][N][:, :10]))
                got = twice(lambda: itt.closed_loop_rollout_batched(
                    system, xb, alphas[:WR_B5], Xs, Us, us, Ks))
                own = np.arange(WR_B5)
                for what, g, r, r_32 in (
                        ("X", got[0], r64["X_t"][:, :N + 1],
                         r32["X_t"][:, :N + 1]),
                        ("U", got[1], r64["U_t"][:, :N], r32["U_t"][:, :N]),
                        ("cost", got[2], r64["c_P"][N][own, own],
                         r32["c_P"][N][own, own])):
                    worst = max(worst, gate(
                        f"{at} B5 trajectory {what}",
                        f"closed_loop_rollout_batched_{fam}", g, r, r_32))
                got = twice(lambda: itt.open_loop_rollout_batched(system, xb,
                                                                  Us))
                for what, g, r, r_32 in (
                        ("X", got[0], r64["X_o"][:, :N + 1],
                         r32["X_o"][:, :N + 1]),
                        ("cost", got[1], r64["c_o"][N], r32["c_o"][N])):
                    worst = max(worst, gate(
                        f"{at} B5 open loop {what}",
                        f"open_loop_rollout_batched_{fam}", g, r, r_32))
            print(f"  {label} (model id {fused_rollout_id(system)}, (n_x, "
                  f"n_u) = ({system.n_x}, {system.n_u})): N {ns[case]}, "
                  f"B2{' and B5' if batch else ''}; largest error "
                  f"{worst:.2e} of max; repeated calls bit-identical")
    finally:
        pool.terminate()
        pool.join()
    print(f"phase 35 plain versions: {host_s:.1f} s of host time in "
          f"{WR_WORKERS} child processes, "
          f"{time.perf_counter() - t_pool:.1f} s of wall time")


def fused_rollout_id(system):
    from ilqr_tpu_torch.ops import fused_rollout
    return fused_rollout.device_model(system)[0]


def b7w_checks(itt, lib, f32, errors) -> dict:
    """B7w: the 'lane' layout's wide form at n = 6, 12, 16 against the
    plain scan in all five fields (phase 18's rule, RTOL_B6 or F32_FLOOR
    times the plain version's f64 error) at M = 1, its tile edges, more
    tiles than are resident and B7W_MS, every call twice; the stage
    elements of a seeded expansion, with the terminal element at the
    longest M.  Returns the timed element sets {label: elements}."""
    from ilqr_tpu_torch.ops import parallel_riccati, suffix_scan
    from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

    timed = {}
    for n in B7W_STATES:
        T = suffix_scan.tile_steps(lib, "lane", n)
        resident = resident_tiles(lib.ilqr_suffix_scan_occupancy(1, n),
                                  f"B7w n={n}")
        Ms = sorted({1, T - 1, T, T + 1, (resident + 3) * T + T // 2}
                    | set(B7W_MS))
        Ms = [M for M in Ms if M >= 1]
        el_all = parallel_riccati.make_elements(
            random_expansion(itt, max(Ms) - 1, n, 2, 50 + n, f32), 0.0)
        print(f"B7w n={n}: tile {T} elements, {resident} tiles resident; "
              f"M {Ms}")
        for M in Ms:
            el = RiccatiElement(*(t[:M].contiguous() for t in el_all))
            torch.cuda.synchronize()
            got = itt.suffix_scan_fused(el, "lane")
            again = itt.suffix_scan_fused(el, "lane")
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"B7w n={n} M={M}: a repeated call "
                                     f"gave other bits")
            label = f"B7w n={n} M={M}"
            notes = check_fields(
                label, got, parallel_riccati.suffix_scan(el),
                parallel_riccati.suffix_scan(as_f64(el)), RTOL_B6, errors,
                "suffix_scan_lane_wide")
            print(f"  {label}: " + "; ".join(notes)
                  + "; repeated call bit-identical")
            if (n, M) == (12, 151):
                timed[label] = el
    return timed


def p5_x0s(f32):
    """P5's initial states: the cart-pole near its upright target, x and
    the angle's offset drawn from numpy's generator seeded 35, u_prev = 0
    (tests/test_torch_chip_refs.py draws the same)."""
    off = np.random.default_rng(35).uniform(-0.1, 0.1, (P5_B, 2))
    x0s = np.zeros((P5_B, 5), np.float32)
    x0s[:, 0] = off[:, 0]
    x0s[:, 1] = np.float32(np.pi) + off[:, 1].astype(np.float32)
    return torch.tensor(x0s, **f32)


def p5_system(itt, f32):
    """bench.py:795-799's cart-pole (rk4, dt 0.01) with S = 0.1 I."""
    cart = itt.make_cartpole(
        0.01, [0.0, np.pi, 0.0, 0.0], Q=np.diag([1.0, 10.0, 0.1, 0.1]),
        R=0.1 * np.eye(1), Q_f=np.diag([100.0, 500.0, 10.0, 10.0]),
        integrator="rk4", **f32)
    return itt.make_rate_penalized_system(cart, 0.1 * np.eye(1))


def p6_system(itt, f32):
    """examples/linear_lqr.py's double integrator: cont2disc at dt 0.1,
    Q = R = I, Q_f = 10 I, as make_discrete_lti's system."""
    A_d, B_d = itt.cont2disc(torch.tensor([[0.0, 1.0], [0.0, 0.0]], **f32),
                             torch.tensor([[0.0], [1.0]], **f32), 0.1)
    return itt.make_discrete_lti(A_d, B_d, 0.1, np.zeros(2), np.eye(2),
                                 np.eye(1), 10.0 * np.eye(2), **f32)


def wr_paths(itt, dev) -> dict:
    """P4-P6 through the kernels, the launch counts reset just before each
    and read just after, each gated on the JAX package's f32 result within
    RTOL_AL.  Returns {label: (result, seconds, counts)}."""
    from examples_torch import reference_tracking_mpc
    from ilqr_tpu_torch import solver as solver_module
    from ilqr_tpu_torch.mpc import run_mpc

    f32 = dict(dtype=torch.float32, device=dev)
    out = {}

    def gate(label, key, value, ok=True):
        rel = abs(value - JAX_F32[key]) / abs(JAX_F32[key])
        print(f"  {label}: {value:.7f}, {rel:.1e} from the JAX f32 result "
              f"{JAX_F32[key]} (limit {RTOL_AL})")
        if not (ok and rel <= RTOL_AL):
            raise AssertionError(f"{label}: gates not met")

    # P4: the tracking MPC with rollout='pallas'.
    p = reference_tracking_mpc.problem(dev)
    cfg = dataclasses.replace(p.config, rollout="pallas")
    with counting(solver_module, "_backward") as passes:
        res, secs, counts = timed_run(lambda: run_mpc(
            p.system, p.system, p.x0, p.U0, P4_STEPS, cfg))
    theta = itt.strip_clock(res.X)[:, 0]
    rms = float(torch.sqrt(torch.mean(
        (theta - p.theta_ref[:P4_STEPS + 1]) ** 2)))
    print(f"P4 tracking MPC H={p.U0.shape[0]} ({P4_STEPS} of {p.n_sim} "
          f"steps, rk4, backward=pallas, rollout=pallas): {secs:.2f} s, "
          f"{secs / P4_STEPS * 1e3:.1f} ms per step, "
          f"{int(res.solve_iters.sum())} iterations, {passes[0]} backward "
          f"passes, launches {counts}")
    finite = bool(torch.isfinite(res.X).all())
    gate("P4 closed-loop cost", "p4_cost", float(res.cost), finite)
    gate("P4 RMS angle error", "p4_rms", rms, finite)
    need("P4", counts, ("fused_riccati", "linesearch_costs",
                        "closed_loop_rollout", "open_loop_rollout"))
    if counts.get("fused_riccati", 0) != passes[0]:
        raise AssertionError("P4: B1 launches differ from the passes")
    out["p4"] = (res, secs, counts)

    # P5: batched solves of the rate-penalized cart-pole.
    rs = p5_system(itt, f32)
    x0s = p5_x0s(f32)
    U0 = torch.zeros((P5_N, 1), **f32)
    sched = itt.IlqrConfig(maxiter=40, tol=1e-5, rollout="pallas")
    sol, secs, counts = timed_run(lambda: itt.solve_batch(rs, x0s, U0,
                                                          sched))
    n_conv = int((sol.status == itt.CONVERGED).sum())
    print(f"P5 rate-penalized cart-pole B={P5_B} N={P5_N} (solve_batch, "
          f"rollout=pallas): {secs:.2f} s, {n_conv}/{P5_B} CONVERGED, "
          f"iterations {int(sol.iterations.min())}-"
          f"{int(sol.iterations.max())}, launches {counts}")
    need("P5", counts, ("batched_riccati", "linesearch_costs_batched",
                        "closed_loop_rollout_batched",
                        "open_loop_rollout_batched"))
    if not (bool(torch.isfinite(sol.cost).all())
            and bool(torch.isfinite(sol.X).all())):
        raise AssertionError("P5: non-finite instances")
    scan = dataclasses.replace(sched, rollout="scan", backward="scan")
    for i in P5_SAMPLES:
        one = itt.solve(rs, x0s[i], U0, scan)
        c, c1 = float(sol.cost[i]), float(one.cost)
        dx = float((sol.X[i] - one.X).abs().max())
        du = float((sol.U[i] - one.U).abs().max())
        print(f"  P5 instance {i}: status {int(sol.status[i])}, "
              f"single-instance scan {c1:.7f} (rel {abs(c - c1) / abs(c1):.1e}"
              f", limit {RTOL_AL}; X {dx:.1e}, U {du:.1e})")
        gate(f"P5 instance {i} cost", f"p5_{i}", c,
             abs(c - c1) <= RTOL_AL * abs(c1))
    out["p5"] = (sol, secs, counts)

    # P6: the LTI double integrator under 'discrete'.
    lti = p6_system(itt, f32)
    x0 = torch.tensor([2.0, 0.0], **f32)
    cfg = itt.IlqrConfig(maxiter=20, tol=1e-6, backward="pallas",
                         rollout="pallas")
    sol, secs, counts = timed_run(lambda: itt.solve(
        lti, x0, torch.zeros((P6_N, 1), **f32), cfg))
    print(f"P6 LTI double integrator N={P6_N} ('discrete', pallas/pallas): "
          f"status {sol.status}, {sol.iterations} iterations, {secs:.2f} s, "
          f"launches {counts}")
    gate("P6 cost", "p6", float(sol.cost), sol.status == itt.CONVERGED)
    need("P6", counts, ("fused_riccati", "linesearch_costs",
                        "closed_loop_rollout", "open_loop_rollout"))
    out["p6"] = (sol, secs, counts)
    return out


def wr_bounds(model, integrator, n_x, n_u, N, A, B=None):
    """Bounds of B2's three entries (B = None) or B5's on B instances for
    a phase-35 system (`rollout_step_ops`'s model names); a tracking
    form also reads the reference rows of its N steps."""
    extra = N * (n_x - 1 + n_u) if model.startswith("tracking:") else 0
    if B is None:
        return chain_bounds(n_x, n_u, N, A, model=model,
                            integrator=integrator, extra_floats=extra)
    return batched_bounds(B, N, A, n_x, n_u, model=model,
                          integrator=integrator, extra_floats=extra)


def check_fields_b1(itt, label, exp) -> float:
    """B1 (B1w) at one expansion held to its plain version field by field
    (phase 2's rule); returns the largest error."""
    got = itt.backward_pass_fused(exp, 0.0)
    plain = itt.backward_pass_associative(exp, 0.0)
    ref64 = itt.backward_pass_associative(as_f64(exp), 0.0)
    one = {"err": 0.0}
    check_fields(f"B1 {label}", got[:3], plain[:3], ref64[:3], RTOL_B1, one,
                 "err")
    return one["err"]


def wrapper_phases(itt, dev, smi, launches_per_call) -> list:
    """Phase 35: the new device forms at their kernel edges (`wr_checks`),
    B7w (`b7w_checks`), the paths P4-P6 (`wr_paths`), and the timing of
    each family at its path's shape or alone.  Returns the kernels line's
    rows."""
    from ilqr_tpu_torch.ops import _build, batched, parallel_riccati

    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load().lib
    t0 = time.perf_counter()
    errors: dict[str, float] = {"suffix_scan_lane_wide": 0.0}
    wr_checks(itt, dev, lib, errors)
    print(f"phase 35 kernel edges: {time.perf_counter() - t0:.1f} s")
    timed_el = b7w_checks(itt, lib, f32, errors)
    runs = wr_paths(itt, dev)
    print(f"phase 35 kernel edges and paths: {time.perf_counter() - t0:.1f} s")

    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    A10 = alphas.numel()
    rows = []

    def row(name, source, replaces, launches, err, t, plain_ms, b, lpc_key,
            **more):
        ms, cols = timing_columns(t, launches_per_call.get(lpc_key))
        rows.append(dict(
            name=name, route="cuda", source=f"ilqr_tpu_torch/csrc/{source}",
            replaces=f"ilqr_tpu/ops/{replaces}", launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None, **cols, **more))

    def held(label, pairs):
        """The largest error of (kernel output, plain output) pairs, each
        within RTOL_B2 of its plain version's max."""
        worst = 0.0
        for g, r in pairs:
            err, rel = rel_err(g, r)
            if not (bool(torch.isfinite(g).all()) and rel <= RTOL_B2):
                raise AssertionError(f"{label}: {err:.3e} ({rel:.2e} of "
                                     f"max) against the plain version")
            worst = max(worst, err)
        return worst

    replaces = {"linesearch_costs": "pallas_rollout.py:92",
                "closed_loop_rollout": "pallas_rollout.py:132",
                "open_loop_rollout": "pallas_rollout.py:132"}

    def b2_rows(tag, source, system, model, integ, inputs, counts, turns=2):
        """B2's three entries on one system at its inputs: held to the
        plain versions, then timed in ``turns`` turns."""
        x0, X, U, u_ff, K = inputs
        N = U.shape[0]
        cases = {
            "linesearch_costs": (
                lambda: (itt.linesearch_costs_fused(system, x0, alphas, X, U,
                                                    u_ff, K),),
                lambda: (itt.linesearch_rollouts(system, x0, alphas, X, U,
                                                 u_ff, K)[2],)),
            "closed_loop_rollout": (
                lambda: itt.closed_loop_rollout_fused(system, x0, 0.5, X, U,
                                                      u_ff, K),
                lambda: itt.closed_loop_rollout(system, x0, 0.5, X, U, u_ff,
                                                K)),
            "open_loop_rollout": (
                lambda: itt.open_loop_rollout_fused(system, x0, U),
                lambda: itt.rollout(system, x0, U))}
        errs = {k: held(f"{tag} {k}", zip(kern(), plain()))
                for k, (kern, plain) in cases.items()}
        t = design_timing(smi, f"B2 {tag}", {k: v[0] for k, v in
                                             cases.items()}, turns=turns)
        bnd = wr_bounds(model, integ, system.n_x, system.n_u, N, A10)
        for k, (_, plain) in cases.items():
            row(f"{k}_{tag}", source, replaces[k], counts.get(k, 0), errs[k],
                t[k], cuda_ms(plain, 1, 0), bnd[k], None)

    # P4: B1w at (3, 1) and B2 on the tracked pendulum (rk4), H = 50, along
    # a solve's first iteration from the MPC's first state.
    from examples_torch import reference_tracking_mpc
    p = reference_tracking_mpc.problem(dev)
    trk, H = p.system, p.U0.shape[0]
    U = p.U0 + 0.3
    X = itt.rollout(trk, p.x0, U)[0].contiguous()
    exp = itt.linearize_trajectory(trk, X, U)
    e1 = check_fields_b1(itt, "P4 (3, 1) H=50", exp)
    t1 = design_timing(smi, "B1w", {"P4 (3, 1) H=50": lambda: (
        itt.backward_pass_fused(exp, 0.0))}, turns=3)
    row("fused_riccati_wide_3x1_n50", "fused_riccati.cu",
        "pallas_riccati.py:774", runs["p4"][2].get("fused_riccati", 0), e1,
        t1["P4 (3, 1) H=50"],
        cuda_ms(lambda: itt.backward_pass_associative(exp, 0.0), 3, 1),
        bound(4 * (expansion_floats(H, 3, 1) + H * (1 + 3) + 2),
              H * riccati_step_ops(3, 1)), "fused_riccati_wide")
    u_ff, K, _, _ = itt.backward_pass_fused(exp, 1.0)
    b2_rows("tracking_pendulum_rk4_h50", "tracking_models.cu", trk,
            "tracking:pendulum", "rk4", (p.x0, X, U, u_ff, K), runs["p4"][2])

    # P5: B4w at (5, 1) and B5 on the rate-penalized cart-pole, B = 256,
    # N = 100, along the first iteration.
    rs = p5_system(itt, f32)
    x0s = p5_x0s(f32)
    Ub = torch.zeros((P5_B, P5_N, 1), **f32)
    Xb = itt.rollout(rs, x0s, Ub)[0].contiguous()
    expb = itt.linearize_trajectory_batched(rs, Xb, Ub)
    got = itt.backward_pass_batched(expb, 0.0, "pallas")
    plain = batched.vmap_backward(itt.backward_pass, expb, 0.0)
    ref64 = batched.vmap_backward(itt.backward_pass, as_f64(expb), 0.0)
    one = {"err": 0.0}
    check_fields("B4w P5 (5, 1)", got[:3], plain[:3], ref64[:3], RTOL_B4,
                 one, "err")
    t4 = design_timing(smi, "B4w", {"P5 (5, 1)": lambda: (
        itt.backward_pass_batched(expb, 0.0))}, turns=3)
    p5_counts = runs["p5"][2]
    row(f"batched_riccati_wide_5x1_b{P5_B}_n{P5_N}", "batched_riccati.cu",
        "pallas_batched.py:114", p5_counts.get("batched_riccati", 0),
        one["err"], t4["P5 (5, 1)"],
        cuda_ms(lambda: batched.vmap_backward(itt.backward_pass, expb, 0.0),
                1, 1),
        batched_bounds(P5_B, P5_N, A10, 5, 1)["batched_riccati"],
        "batched_riccati_wide")
    ub, Kb, _, _ = itt.backward_pass_batched(expb, 1.0)
    ab = torch.full((P5_B,), 0.5, **f32)
    cases = {
        "linesearch_costs_batched": (
            lambda: (itt.linesearch_costs_batched(rs, x0s, alphas, Xb, Ub, ub,
                                                  Kb),),
            lambda: (itt.linesearch_rollouts(rs, x0s, alphas, Xb, Ub, ub,
                                             Kb)[2],)),
        "closed_loop_rollout_batched": (
            lambda: itt.closed_loop_rollout_batched(rs, x0s, ab, Xb, Ub, ub,
                                                    Kb),
            lambda: tuple(r[:, 0] for r in itt.linesearch_rollouts(
                rs, x0s, ab[:, None], Xb, Ub, ub, Kb))),
        "open_loop_rollout_batched": (
            lambda: itt.open_loop_rollout_batched(rs, x0s, Ub),
            lambda: itt.rollout(rs, x0s, Ub))}
    errs = {k: held(f"B5 P5 {k}", zip(kern(), plain()))
            for k, (kern, plain) in cases.items()}
    t5 = design_timing(smi, "B5 P5 rate cart-pole", {
        k: v[0] for k, v in cases.items()}, turns=3)
    bnd = wr_bounds("rate:cartpole", "rk4", 5, 1, P5_N, A10, B=P5_B)
    for k, (_, plain) in cases.items():
        row(f"{k}_rate_cartpole_b{P5_B}_n{P5_N}", "rate_models.cu",
            "pallas_batched.py:377", p5_counts.get(k, 0), errs[k], t5[k],
            cuda_ms(plain, 1, 0), bnd[k], f"{k}_models")

    # P6: B1 at (2, 1) and B2 on the LTI double integrator ('discrete'),
    # N = 50, along the first iteration.
    lti = p6_system(itt, f32)
    x0 = torch.tensor([2.0, 0.0], **f32)
    U = torch.zeros((P6_N, 1), **f32)
    X = itt.rollout(lti, x0, U)[0].contiguous()
    exp = itt.linearize_trajectory(lti, X, U)
    e1 = check_fields_b1(itt, "P6 (2, 1) N=50", exp)
    t1 = design_timing(smi, "B1", {"P6 (2, 1) N=50": lambda: (
        itt.backward_pass_fused(exp, 0.0))}, turns=3)
    row("fused_riccati_2x1_n50", "fused_riccati.cu", "pallas_riccati.py:774",
        runs["p6"][2].get("fused_riccati", 0), e1, t1["P6 (2, 1) N=50"],
        cuda_ms(lambda: itt.backward_pass_associative(exp, 0.0), 3, 1),
        bound(4 * (expansion_floats(P6_N, 2, 1) + P6_N * (1 + 2) + 2),
              P6_N * riccati_step_ops(2, 1)), "fused_riccati")
    u_ff, K, _, _ = itt.backward_pass_fused(exp, 0.0)
    b2_rows("lti_2x1_discrete_n50", "lti_rollout.cu", lti, "lti",
            "discrete", (x0, X, U, u_ff, K), runs["p6"][2])

    # Timed alone (no path runs them), along phase 35's nominals: the
    # implicit rules (the 3-D quadrotor under backward Euler, one turn at
    # WR_TIME_N // 2: ~0.1 ms a step, its plain version ~50 ms), the
    # spring chain, the rate and tracking wrappers over the 3-D quadrotor
    # and the LTI (16, 4) at WR_TIME_N (two turns each, three until phase
    # 38 came).
    n_imp = WR_TIME_N // 2
    for case, tag, source, model, n, turns in (
            (("model", "quadrotor3d", "backward_euler"),
             f"backward_euler_quadrotor3d_n{n_imp}", "implicit_models.cu",
             "quadrotor3d", n_imp, 1),
            (("chain", "chain", "rk4"), f"spring_chain_rk4_n{WR_TIME_N}",
             "spring_chain.cu", "spring_chain", WR_TIME_N, 2),
            (("rate", "quadrotor3d", "rk4"),
             f"rate_quadrotor3d_rk4_n{WR_TIME_N}", "rate_models.cu",
             "rate:quadrotor3d", WR_TIME_N, 2),
            (("tracking", "quadrotor3d", "rk4"),
             f"tracking_quadrotor3d_rk4_n{WR_TIME_N}", "tracking_models.cu",
             "tracking:quadrotor3d", WR_TIME_N, 2),
            (("lti", "lti_16x4", "rk4"), f"lti_16x4_rk4_n{WR_TIME_N}",
             "lti_rollout.cu", "lti", WR_TIME_N, 2)):
        system = wr_system(itt, case, f32)
        inputs = wr_nominal(case, system, n, 90, f32)
        b2_rows(tag, source, system, model, case[2], inputs, {}, turns)
    # B7w at n = 12, M = 151, the flight's M (at n = 16, M = 32769, one
    # call's look-back chain runs through 2049 tiles).
    tb = design_timing(smi, "B7w", {
        k: lambda e=e: itt.suffix_scan_fused(e, "lane")
        for k, e in timed_el.items()}, turns=3)
    for label, el in timed_el.items():
        M, n = el.A.shape[0], el.A.shape[-1]
        row(f"suffix_scan_lane_wide_n{n}_m{M}", "suffix_scan.cu",
            "pallas_riccati.py:271", 0, errors["suffix_scan_lane_wide"],
            tb[label], cuda_ms(lambda e=el: parallel_riccati.suffix_scan(e),
                               3, 1),
            bound(4 * 2 * M * (3 * n * n + 2 * n), (M - 1) * combine_ops(n)),
            "suffix_scan_lane_wide")
    print(f"phase 35: {time.perf_counter() - t0:.1f} s")
    return rows


# ---- Phase 36: the solvers beyond iLQR (P7-P9) ----------------------------
# P7: examples/inverse_optimal_control.py (pendulum rk4, N = 60, four
# demonstrations, maxiter 150, tol 1e-9) through B1 and B2, its descent cut
# from 60 outer steps to P7_OUTER_STEPS for the time limit (2 until phase
# 38 came; the gradient gates read the first step's gradient, which the
# cut keeps); its
# differentiable MPC (run_mpc_implicit, H = P7_MPC_H) for P7_MPC_STEPS.
# The gradient against the sequential engines is taken over the loss of
# the demonstrations P7_SEQ_DEMOS alone (the two quickest solves), for the
# time limit: the sequential solves of all four took 28 s of P7's 58 on
# the H100 machine; the full gradient is held to JAX's.
P7_OUTER_STEPS = 1
P7_SEQ_DEMOS = (2, 3)
P7_MPC_H, P7_MPC_STEPS = 20, 3
# P7's gradient gates, of max |g|: the f32 solves stop within their own
# rounding of each optimum, and the IFT gradient of the loss on U* follows
# them.  On the CPU the port's f32 gradient under the kernels' plain
# versions sat 2.3e-3 of max |g| from the sequential engines' and 1.2e-3
# from JAX's f32 constant, over P7_SEQ_DEMOS 3.5e-3 and 2.7e-3
# (tests/test_torch_ioc_gradient.py holds both engines to both constants
# within RTOL_P7); the losses within 1e-4.
RTOL_P7 = 1e-2
RTOL_P7_LOSS = 1e-3
# P8: examples/mppi_pendulum.py at full size (S = 512, 4 updates a step,
# H = 30, 120 steps, beta 0.8, |u| <= 8; the explore S = 1024, N = 80, 60
# updates) under tests/test_mppi.py:129-147's swing-up gate; the explore
# gate of tests/test_mppi.py:41-57 (within 1.2x of iLQR) on that test's
# own problem, since the driver's explore is a global search that JAX's
# MPPI leaves 2-3x above the limited optimum too (its polish is gated).
P8_SEED = 5          # the fixed-noise update's generator seed
# P9: examples/parallel_estimation.py's record at P9_N steps (the
# parallel filter and smoother, B3 in their defect sweeps), the sequential
# EKF and RTS smoother on its first P9_SEQ_N (cut from P9_N for the time
# limit: each step one replay of a CUDA graph, `estimation._scan`), the
# UKF's captured steps against its eager loop on the first P9_UKF_N.
P9_N, P9_SEQ_N, P9_UKF_N = 100_000, 2000, 200
# P9's gates: the parallel estimators' RMS-to-truth within P9_RMS_FACTOR of
# JAX's f32 RMS on the same record (the truth of each package is its own
# f32 rollout); the sequential ones within RTOL_P9_SEQ of JAX's (the same
# recursion in f32 over P9_SEQ_N steps; on the CPU the port's EKF and
# EKS sat 2.6e-6 and 1.5e-5 from JAX's, on the H100 machine 2.9e-6 and
# 3.4e-5); X_lin of the kernel's sweeps against the
# plain scan's within RTOL_LS of max |X|.
P9_RMS_FACTOR = 1.1
RTOL_P9_SEQ = 1e-3


def solver_phases(itt, dev, smi, launches_per_call) -> list:
    """Phase 36: P7 (inverse optimal control through `solve_implicit`),
    P8 (MPPI MPC and explore, B5's open loop) and P9 (parallel filter and
    smoother at N = 100000, B3), each with the launch counts reset just
    before and read just after, and the kernels line's rows at these
    paths' shapes.  Returns the rows."""
    from examples_torch import inverse_optimal_control as ioc
    from examples_torch import mppi_pendulum as mp
    from examples_torch import parallel_estimation as pe
    from ilqr_tpu_torch import diff, mppi
    from ilqr_tpu_torch import estimation, estimation_parallel as ep
    from ilqr_tpu_torch.estimation import run_ukf
    from ilqr_tpu_torch.ops.parallel_rollout import open_loop_defect_rollout

    f32 = dict(dtype=torch.float32, device=dev)
    t0 = t_lap = time.perf_counter()
    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    A10 = alphas.numel()
    rows = []

    def row(name, source, replaces, launches, err, t, plain_ms, b, lpc_key,
            **more):
        ms, cols = timing_columns(t, launches_per_call.get(lpc_key))
        rows.append(dict(
            name=name, route="cuda", source=f"ilqr_tpu_torch/csrc/{source}",
            replaces=f"ilqr_tpu/ops/{replaces}", launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None, **cols, **more))

    def gate(label, ok, text):
        print(f"  {label}: {text}")
        if not ok:
            raise AssertionError(f"phase 36 {label}: {text}")

    def rel_max(got, ref):
        return float((got - ref).abs().max()) / float(ref.abs().max())

    # ---- P7: inverse optimal control ----------------------------------
    cfg = itt.IlqrConfig(maxiter=150, tol=1e-9, backward="pallas",
                         rollout="pallas")
    seq = dataclasses.replace(cfg, backward="scan", rollout="scan")
    res, secs, counts = timed_run(lambda: ioc.main(
        plot=False, device=dev, config=cfg, outer_steps=P7_OUTER_STEPS))
    p = ioc.problem(dev, torch.float32, cfg)
    iters = [int(s.iterations) for s in res.first_sols]
    print(f"P7 inverse optimal control (pendulum rk4, N = {p.N}, 4 "
          f"demonstrations, {P7_OUTER_STEPS} of 60 outer steps, "
          f"backward=pallas, rollout=pallas): {secs:.2f} s, first "
          f"solves' iterations {iters}, loss {float(res.first_loss):.6f} -> "
          f"{float(res.loss):.6f}, launches {counts}")
    need("P7", counts, ("fused_riccati", "linesearch_costs",
                        "closed_loop_rollout", "open_loop_rollout"))
    # The four first solves' forward passes against `solve`.
    sys0 = ioc.make_system(p.log_w0, dev)
    same, t_f = [], time.perf_counter()
    for x0i, si in zip(p.x0s, res.first_sols):
        ref = itt.solve(sys0, x0i, p.U0, cfg)
        same.append(torch.equal(si.U, ref.U) and torch.equal(si.X, ref.X))
    gate("P7 forward", all(same),
         f"solve_implicit's X and U equal solve's bit for bit at log_w = 0, "
         f"demonstration by demonstration: {same} "
         f"({time.perf_counter() - t_f:.2f} s)")
    g_k, g_j = res.first_grad, torch.tensor(JAX_F32["p7"][1:], **f32)
    loss_j = JAX_F32["p7"][0]
    e_j = rel_max(g_k, g_j)
    e_l = abs(float(res.first_loss) - loss_j) / loss_j
    gate("P7 gradient", bool(torch.isfinite(g_k).all()) and e_j <= RTOL_P7
         and e_l <= RTOL_P7_LOSS,
         f"{g_k.tolist()} against JAX f32 {g_j.tolist()} ({e_j:.1e} of max "
         f"|g|, limit {RTOL_P7}); loss {float(res.first_loss):.6f} against "
         f"{loss_j:.6f} ({e_l:.1e}, limit {RTOL_P7_LOSS})")
    sub = SimpleNamespace(**{**vars(p), "x0s": p.x0s[list(P7_SEQ_DEMOS)]})
    demo_sub = res.demo_U[list(P7_SEQ_DEMOS)]
    (v_ks, g_ks, _), secs_ks, _ = timed_run(
        lambda: ioc.loss_and_grad(sub, p.log_w0, demo_sub))
    (v_s, g_s, _), secs_s, _ = timed_run(
        lambda: ioc.loss_and_grad(sub, p.log_w0, demo_sub, config=seq))
    g_js = torch.tensor(JAX_F32["p7_sub"][1:], **f32)
    e_s, e_sj = rel_max(g_ks, g_s), rel_max(g_ks, g_js)
    gate("P7 gradient, sequential engines", e_s <= RTOL_P7
         and e_sj <= RTOL_P7
         and abs(float(v_ks) - float(v_s)) <= RTOL_P7_LOSS * float(v_s),
         f"demonstrations {P7_SEQ_DEMOS}: {g_ks.tolist()} against "
         f"backward='scan', rollout='scan' {g_s.tolist()} ({e_s:.1e} of max "
         f"|g|) and JAX f32 {g_js.tolist()} ({e_sj:.1e}; limit {RTOL_P7}); "
         f"loss {float(v_ks):.6f} against {float(v_s):.6f}; {secs_ks:.2f} s "
         f"against {secs_s:.2f} s")

    def mpc_grad(config):
        log_w = p.log_w0.clone().requires_grad_(True)
        solver = ioc.make_system(log_w, dev)
        plant = ioc.make_system(p.log_w0, dev).with_integrator("midpoint")
        X, U, cost = diff.run_mpc_implicit(
            solver, plant, p.x0s[0], torch.zeros((P7_MPC_H, 1), **f32),
            P7_MPC_STEPS, config)
        (g,) = torch.autograd.grad(cost, log_w)
        return cost.detach(), g
    (c_k, gm_k), secs_m, counts_m = timed_run(lambda: mpc_grad(cfg))
    (c_s, gm_s), secs_ms, _ = timed_run(lambda: mpc_grad(seq))
    e_m = rel_max(gm_k, gm_s)
    print(f"P7 run_mpc_implicit (H = {P7_MPC_H}, {P7_MPC_STEPS} steps, "
          f"rk4 solver, midpoint plant): {secs_m:.2f} s, launches "
          f"{counts_m}")
    need("P7 MPC", counts_m, ("fused_riccati", "linesearch_costs",
                              "closed_loop_rollout", "open_loop_rollout"))
    gate("P7 MPC gradient", bool(torch.isfinite(gm_k).all())
         and e_m <= RTOL_P7,
         f"cost {float(c_k):.6f} (sequential {float(c_s):.6f}), d/dlog_w "
         f"{gm_k.tolist()} against the sequential engines' {gm_s.tolist()} "
         f"({e_m:.1e} of max |g|, limit {RTOL_P7}); sequential "
         f"{secs_ms:.2f} s")
    p7_counts = counts
    now = time.perf_counter()
    print(f"phase 36 P7: {now - t_lap:.1f} s")
    t_lap = now

    # ---- P8: MPPI ------------------------------------------------------
    q = mp.problem(dev)
    mc = q.mppi_config
    res8, secs8, counts8 = timed_run(lambda: mp.mppi_mpc(q))
    theta, omega = float(res8.X[-1, 0]), float(res8.X[-1, 1])
    u_max = float(res8.U.abs().max())
    print(f"P8 MPPI MPC (S = {mc.samples}, {mc.iters} updates a step, H = "
          f"{q.U0.shape[0]}, {q.n_sim} steps): {secs8:.2f} s, "
          f"{secs8 / q.n_sim * 1e3:.1f} ms a step, cost {float(res8.cost):.3f}"
          f", launches {counts8}")
    gate("P8 B5 launches", counts8.get("open_loop_rollout_batched", 0)
         == q.n_sim * mc.iters,
         f"{counts8.get('open_loop_rollout_batched', 0)} of B5's open loop, "
         f"n_sim x iters = {q.n_sim * mc.iters}")
    gate("P8 swing-up", abs(theta - np.pi) < 0.15 and abs(omega) < 0.5
         and u_max <= mp.U_LIM + 1e-5 and res8.X.shape == (q.n_sim + 1, 2),
         f"theta_N {theta:.4f} (|. - pi| < 0.15), thetadot_N {omega:.4f} "
         f"(< 0.5), max |u| {u_max:.4f} (<= {mp.U_LIM})")
    # One update on fixed noise (a generator seeded alike), through B5 and
    # through the plain rollouts on the card (the plain route that MPPI
    # takes for a system or dtype B5 does not take, patched in).
    U_fix = res8.U.new_zeros(q.U0.shape)
    gen = partial(torch.Generator(device=dev).manual_seed, P8_SEED)
    U_k, ess_k = mppi.mppi_update(q.system, q.x0, U_fix, gen(), mc)
    sample_costs = mppi._sample_costs
    mppi._sample_costs = lambda system, x0, U: itt.rollout(
        system, x0.expand(U.shape[0], x0.shape[0]), U)[1]
    try:
        U_p, ess_p = mppi.mppi_update(q.system, q.x0, U_fix, gen(), mc)
    finally:
        mppi._sample_costs = sample_costs
    U_cand = mppi._candidates(U_fix, gen(), mc, 1.0)
    x0s = q.x0.expand(mc.samples, 2).contiguous()
    c_b5 = itt.open_loop_rollout_batched(q.system, x0s, U_cand)[1]
    c_pl = itt.rollout(q.system, x0s, U_cand)[1]
    e_b5, r_b5 = rel_err(c_b5, c_pl)
    # A cost error Δ moves each softmax weight by at most a factor
    # exp(±2Δ/λ), so U_new by ≤ 4Δ/λ · max|U_s − U_new| and the ESS by ≤
    # 8Δ/λ, beside the f32 rounding of the weighted sum.
    spread = float((U_cand - U_p[None]).abs().max())
    lim_u = 4 * e_b5 / mc.temperature * spread + 1e-5 * mp.U_LIM
    lim_e = 8 * e_b5 / mc.temperature + 1e-5
    d_u = float((U_k - U_p).abs().max())
    d_e = abs(float(ess_k) - float(ess_p)) / float(ess_p)
    gate("P8 fixed-noise update", r_b5 <= RTOL_B5 and d_u <= lim_u
         and d_e <= lim_e,
         f"B5 sample costs {e_b5:.2e} from the plain rollouts ({r_b5:.1e} of "
         f"max, limit {RTOL_B5}); U_new {d_u:.2e} (limit {lim_u:.2e}), ESS "
         f"{float(ess_k):.5f} against {float(ess_p):.5f} ({d_e:.1e}, limit "
         f"{lim_e:.1e})")
    # tests/test_mppi.py:41-57's gate on that test's problem (x0 = (0.3,
    # 0), N = 40, S = 512, 60 updates against unconstrained iLQR).
    x0t, U0t = torch.tensor([0.3, 0.0], **f32), torch.zeros((40, 1), **f32)
    tcfg = mppi.MppiConfig(samples=512, iters=60, temperature=0.05,
                           sigma=0.6, noise_beta=0.8)
    sol_t, secs_t, counts_t = timed_run(lambda: mppi.solve_mppi(
        q.system, x0t, U0t, 1, tcfg))
    ref_t = itt.solve(q.system, x0t, U0t, itt.IlqrConfig(
        maxiter=100, tol=1e-8, backward="pallas", rollout="pallas"))
    gate("P8 MPPI as optimizer", float(sol_t.cost) < 1.2 * float(ref_t.cost)
         + 1e-3 and float(sol_t.cost_trace[-1]) < float(sol_t.cost_trace[0])
         and sol_t.X.shape == (41, 2) and sol_t.U.shape == (40, 1)
         and counts_t.get("open_loop_rollout_batched", 0) == tcfg.iters,
         f"tests/test_mppi.py's problem: cost {float(sol_t.cost):.4f} "
         f"against iLQR's {float(ref_t.cost):.4f} (< 1.2x + 1e-3), "
         f"{secs_t:.2f} s, launches {counts_t}")
    # The driver's explore (S = 1024, N = 80, 60 updates, |u| <= 8): a
    # global search, far above the limited optimum (JAX's own reaches
    # 42.7-58.3 over keys 0-2 against iLQR's 20.52): its trace must fall
    # and iLQR's polish from it reach JAX's limited optimum.
    ec = q.explore_config
    ex, secs_x, counts_x = timed_run(lambda: mp.explore(q))
    pol = itt.solve(q.system, q.x0, ex.U, dataclasses.replace(
        q.ol_config, backward="pallas", rollout="scan"))
    e_pol = abs(float(pol.cost) - JAX_F32["p8_limited"]) / JAX_F32["p8_limited"]
    print(f"P8 MPPI explore (S = {ec.samples}, N = {q.U0_ol.shape[0]}, "
          f"{ec.iters} updates): {secs_x:.2f} s, launches {counts_x}")
    gate("P8 explore", bool(torch.isfinite(ex.X).all())
         and float(ex.cost_trace[-1]) < float(ex.cost_trace[0])
         and ex.X.shape == (q.U0_ol.shape[0] + 1, 2)
         and counts_x.get("open_loop_rollout_batched", 0) == ec.iters
         and pol.status == itt.CONVERGED and e_pol <= RTOL_AL,
         f"trace {float(ex.cost_trace[0]):.3f} -> {float(ex.cost):.3f}; "
         f"iLQR polish from it {float(pol.cost):.5f}, status {pol.status}, "
         f"against JAX f32's limited optimum {JAX_F32['p8_limited']:.5f} "
         f"({e_pol:.1e}, limit {RTOL_AL})")
    now = time.perf_counter()
    print(f"phase 36 P8: {now - t_lap:.1f} s")
    t_lap = now

    # ---- P9: parallel estimation --------------------------------------
    r = pe.problem(P9_N, dev)
    x0 = r.s0.x_hat
    est = pe.estimators(r, P9_SEQ_N)
    runs9 = {}
    for name in ("EKF  parallel   ", "EKS  parallel(2)"):
        Xh, s9, c9 = timed_run(est[name])
        runs9[name.strip()] = (Xh, s9, c9)
        need(f"P9 {name.strip()}", c9, ("affine_prefix_scan",))
    X_lin_k = ep._default_x_lin(r.system, x0, r.U)
    X_pl, _, d_pl = open_loop_defect_rollout(r.system, x0, r.U, iters=8,
                                             exit_tol=1e-6, engine="xla")
    ok = bool(torch.isfinite(d_pl)) and float(d_pl) < 1e-3 * (
        1.0 + float(X_pl.abs().max()))
    X_lin_p = X_pl if ok else x0.expand(X_pl.shape)
    e_lin = rel_max(X_lin_k, X_lin_p)
    gate("P9 X_lin", e_lin <= RTOL_LS,
         f"the kernel's sweeps against the plain scan's: {e_lin:.1e} of "
         f"max |X| (limit {RTOL_LS}; plain defect {float(d_pl):.1e}, "
         f"{'certified' if ok else 'constant fallback'})")
    for name, key in (("EKF  parallel", "p9_ekf_par_rms"),
                      ("EKS  parallel(2)", "p9_eks_par_rms")):
        Xh, s9, c9 = runs9[name]
        rms = pe.rms(r, Xh)
        gate(f"P9 {name}", bool(torch.isfinite(Xh).all())
             and rms <= P9_RMS_FACTOR * JAX_F32[key],
             f"N = {P9_N}: {s9:.3f} s, RMS-to-truth {rms:.4e} (JAX f32 "
             f"{JAX_F32[key]:.4e}, limit {P9_RMS_FACTOR}x), launches {c9}")
    # The sequential estimators, each step a replay of one CUDA graph
    # (`estimation._scan`).
    for name, key in (("EKF  sequential ", "p9_ekf_seq_rms"),
                      ("EKS  sequential ", "p9_eks_seq_rms")):
        Xh, s9, c9 = timed_run(est[name])
        rms = pe.rms(r, Xh)
        e9 = abs(rms - JAX_F32[key]) / JAX_F32[key]
        gate(f"P9 {name.strip()}", e9 <= RTOL_P9_SEQ,
             f"N = {P9_SEQ_N}: {s9:.2f} s, RMS-to-truth {rms:.4e} against "
             f"JAX f32 {JAX_F32[key]:.4e} ({e9:.1e}, limit {RTOL_P9_SEQ})")
    # The UKF (not in the driver) on P9_UKF_N steps: its captured steps
    # against the eager loop of the same steps, bit for bit (its f32 sigma
    # weights cancel, W_0 = -99, so its RMS is no gate against JAX's: on
    # the CPU the two packages' f32 RMS part by 13 %).
    def ukf():
        return run_ukf(r.system, pe.obs, r.s0, r.U[:P9_UKF_N],
                       r.Y[:P9_UKF_N], r.Q_proc, r.R_obs)[1]
    Xu, s_u, _ = timed_run(ukf)
    graphed = estimation._scan
    estimation._scan = estimation._loop
    try:
        Xe, s_e, _ = timed_run(ukf)
    finally:
        estimation._scan = graphed
    gate("P9 UKF  sequential", bool(torch.isfinite(Xu).all())
         and torch.equal(Xu, Xe),
         f"N = {P9_UKF_N}: the captured steps {s_u:.2f} s, the eager loop "
         f"{s_e:.2f} s, equal bit for bit; RMS-to-truth {pe.rms(r, Xu):.4e}")
    now = time.perf_counter()
    print(f"phase 36 P9: {now - t_lap:.1f} s")
    t_lap = now

    # ---- the kernels line: each kernel at its path's shape ------------
    # B1 at (2, 1), N = 60, and B2's three entries on the pendulum (rk4)
    # along the first iteration of P7's first demonstration.
    sys7 = ioc.make_system(p.log_w0, dev)
    x7 = p.x0s[0]
    X7 = itt.rollout(sys7, x7, p.U0)[0].contiguous()
    exp7 = itt.linearize_trajectory(sys7, X7, p.U0)
    e1 = check_fields_b1(itt, "P7 (2, 1) N=60", exp7)
    t1 = design_timing(smi, "B1", {"P7 (2, 1) N=60": lambda: (
        itt.backward_pass_fused(exp7, 0.0))}, turns=3)
    N7 = p.N
    row(f"fused_riccati_2x1_n{N7}", "fused_riccati.cu",
        "pallas_riccati.py:774", p7_counts.get("fused_riccati", 0), e1,
        t1["P7 (2, 1) N=60"],
        cuda_ms(lambda: itt.backward_pass_associative(exp7, 0.0), 3, 1),
        bound(4 * (expansion_floats(N7, 2, 1) + N7 * (1 + 2) + 2),
              N7 * riccati_step_ops(2, 1)), "fused_riccati")
    u7, K7, _, _ = itt.backward_pass_fused(exp7, 0.0)
    cases = {
        "linesearch_costs": (
            lambda: (itt.linesearch_costs_fused(sys7, x7, alphas, X7, p.U0,
                                                u7, K7),),
            lambda: (itt.linesearch_rollouts(sys7, x7, alphas, X7, p.U0, u7,
                                             K7)[2],)),
        "closed_loop_rollout": (
            lambda: itt.closed_loop_rollout_fused(sys7, x7, 0.5, X7, p.U0,
                                                  u7, K7),
            lambda: itt.closed_loop_rollout(sys7, x7, 0.5, X7, p.U0, u7, K7)),
        "open_loop_rollout": (
            lambda: itt.open_loop_rollout_fused(sys7, x7, p.U0),
            lambda: itt.rollout(sys7, x7, p.U0))}
    t2 = design_timing(smi, "B2 P7", {k: v[0] for k, v in cases.items()},
                       turns=3)
    b2 = chain_bounds(2, 1, N7, A10, model="pendulum", integrator="rk4")
    src2 = {"linesearch_costs": "pallas_rollout.py:92",
            "closed_loop_rollout": "pallas_rollout.py:132",
            "open_loop_rollout": "pallas_rollout.py:132"}
    for k, (kern, plain) in cases.items():
        worst = 0.0
        for g, ref in zip(kern(), plain()):
            err, rr = rel_err(g, ref)
            gate(f"B2 {k} P7", bool(torch.isfinite(g).all())
                 and rr <= RTOL_B2, f"{err:.2e} ({rr:.1e} of max, limit "
                 f"{RTOL_B2})")
            worst = max(worst, err)
        row(f"{k}_pendulum_rk4_n{N7}", "chain_rollout.cu", src2[k],
            p7_counts.get(k, 0), worst, t2[k], cuda_ms(plain, 1, 0), b2[k],
            None)
    def held(label, got, ref, rtol):
        """Gate each output (X, cost) of a rollout kernel against its plain
        version within rtol of its max; returns the largest error."""
        worst = 0.0
        for name, g, r in zip(("X", "cost"), got, ref):
            err, rr = rel_err(g, r)
            gate(f"{label} {name}", bool(torch.isfinite(g).all())
                 and rr <= rtol, f"{err:.2e} ({rr:.1e} of max, limit {rtol})")
            worst = max(worst, err)
        return worst

    # B2's open loop at P8's mean rollouts (N = 30, the MPC's final mean
    # sequence), and B5's open loop at the MPC's (512, 30) and the
    # explore's (1024, 80), on the samples of seeded draws: each output
    # held to its plain version before it is timed.
    H8 = q.U0.shape[0]
    U_mean = res8.U.new_zeros(q.U0.shape) + 0.1
    e2m = held(f"B2 open loop P8 N={H8}",
               itt.open_loop_rollout_fused(q.system, q.x0, U_mean),
               itt.rollout(q.system, q.x0, U_mean), RTOL_B2)
    t2m = design_timing(smi, "B2 P8 mean", {"open loop": lambda: (
        itt.open_loop_rollout_fused(q.system, q.x0, U_mean))}, turns=3)
    row(f"open_loop_rollout_pendulum_rk4_n{H8}", "chain_rollout.cu",
        "pallas_rollout.py:132", counts8.get("open_loop_rollout", 0), e2m,
        t2m["open loop"],
        cuda_ms(lambda: itt.rollout(q.system, q.x0, U_mean), 1, 0),
        chain_bounds(2, 1, H8, 1, model="pendulum",
                     integrator="rk4")["open_loop_rollout"], None)
    N_ol = q.U0_ol.shape[0]
    U_x = mppi._candidates(q.U0_ol, gen(), ec, 1.0)
    x0x = q.x0.expand(ec.samples, 2).contiguous()
    e_x = held(f"B5 P8 explore ({ec.samples}, {N_ol})",
               itt.open_loop_rollout_batched(q.system, x0x, U_x),
               itt.rollout(q.system, x0x, U_x), RTOL_B5)
    e_b5 = held(f"B5 P8 MPC ({mc.samples}, {H8})",
                itt.open_loop_rollout_batched(q.system, x0s, U_cand),
                itt.rollout(q.system, x0s, U_cand), RTOL_B5)
    t5 = design_timing(smi, "B5 P8", {
        f"({mc.samples}, {H8})": lambda: itt.open_loop_rollout_batched(
            q.system, x0s, U_cand),
        f"({ec.samples}, {N_ol})": lambda: itt.open_loop_rollout_batched(
            q.system, x0x, U_x)}, turns=3)
    for (B, N, U_b, x0b, err, launches) in (
            (mc.samples, H8, U_cand, x0s, e_b5,
             counts8.get("open_loop_rollout_batched", 0)),
            (ec.samples, N_ol, U_x, x0x, e_x,
             counts_x.get("open_loop_rollout_batched", 0))):
        row(f"open_loop_rollout_batched_pendulum_rk4_b{B}_n{N}",
            "chain_rollout.cu", "pallas_batched.py:377", launches, err,
            t5[f"({B}, {N})"],
            cuda_ms(lambda U_b=U_b, x0b=x0b: itt.rollout(q.system, x0b, U_b),
                    1, 0),
            batched_bounds(B, N, 1, 2, 1, model="pendulum",
                           integrator="rk4")["open_loop_rollout_batched"],
            "open_loop_rollout_batched")
    # B3 at n = 2, one candidate, N = 100000: the first sweep of P9's
    # defect rollout (A_k = ∂f/∂x along the constant trajectory at x0).
    Xc = x0.expand(P9_N + 1, 2)
    A9 = torch.func.vmap(torch.func.jacfwd(
        lambda x, u: itt.step(r.system, x, u), argnums=0))(Xc[:-1], r.U)
    d9 = (itt.step(r.system, Xc[:-1], r.U) - Xc[1:])[None].contiguous()
    z9 = torch.zeros((1, 2), **f32)
    A9 = A9.contiguous()
    got9 = itt.affine_prefix_scan_multi(A9, d9, z9, engine="pallas")
    ref9 = itt.affine_prefix_scan_multi(A9, d9, z9, engine="xla")
    e3, r3 = rel_err(got9, ref9)
    gate("B3 P9", bool(torch.isfinite(got9).all()) and r3 <= RTOL_LS,
         f"{e3:.2e} ({r3:.1e} of max, limit {RTOL_LS})")
    t3 = design_timing(smi, "B3 P9", {f"n=2 A=1 N={P9_N}": lambda: (
        itt.affine_prefix_scan_multi(A9, d9, z9, engine="pallas"))}, turns=3)
    launches9 = sum(c.get("affine_prefix_scan", 0)
                    for _, _, c in runs9.values())
    row(f"affine_prefix_scan_n2_a1_n{P9_N}", "affine_scan.cu",
        "pallas_affine.py:137", launches9, e3, t3[f"n=2 A=1 N={P9_N}"],
        cuda_ms(lambda: itt.affine_prefix_scan_multi(A9, d9, z9,
                                                     engine="xla"), 3, 1),
        b3_bound(P9_N, 2, 1), "affine_prefix_scan")
    print(f"phase 36 kernels: {time.perf_counter() - t_lap:.1f} s")
    print(f"phase 36: {time.perf_counter() - t0:.1f} s")
    return rows


# ---- Phase 37: batched solves with limits, DDP and adaptive_reg ----------

# (a): B6 over the batch against its plain version: the register form at
# n = 2, 4 and the wide form at n = 6, 12, at B = 1, 3 and 512 and M = 1,
# the form's tile edge T and T + 1, 65 (the batched-MPC cell's H + 1), 301
# and a multi-tile 4097 (B = 1, 3 only: at B = 512 and n = 12 that is
# 3.8 GB of elements, and the plain f64 scan several times that).  Tolerance
# RTOL_B6's rule, field by field; every call twice, bit for bit; one
# launch a call; each instance bit for bit a single-instance B6 call on it.
B6B_STATES = (2, 4, 6, 12)
B6B_BATCHES = (1, 3, 512)
B6B_MS = (1, 65, 301, 4097)
B6B_LONG_BATCH = 3      # the largest B at M = 4097
# (b): the batched-MPC cell (phase 16's DP, B = MPC_B, H = MPC_H, maxiter 5,
# tol 1e-4, MPC_SIM steps) under box limits at the LIMIT_QUANTILE of the
# unconstrained first solve's |u|, with backward='pallas' and
# adaptive_reg; the first limited solve must end with at least
# MIN_CLAMPED of its controls on a bound.  Two instances are held to
# single-instance run_mpc within ATOL_MPC over the loop's first
# LIMITED_REF_STEPS steps (a single-instance loop takes 1.1-1.4 s a step
# on the card, its limited pass sweeping to the budget).
LIMIT_QUANTILE = 0.7
MIN_CLAMPED = 0.1
LIMITED_MPC_REFS = (127, 384)
LIMITED_REF_STEPS = 1
# (c): a batched DDP + adaptive_reg pendulum solve (phase 21's DDP
# pendulum, rk4, N = 300, B = DDP_B from rest with the angle spread over
# ±0.5, maxiter DDP_MAXITER, tol 1e-4 above the f32 cost's resolution)
# through B5, B6 over the batch and, on its adaptive_reg-only twin, B4
# with a (B,) reg; DDP_SAMPLES instances held to single-instance solves
# under phase 15's rule.
DDP_B, DDP_N, DDP_MAXITER = 256, 300, 10
DDP_SAMPLES = (0, 37, 74, 111, 148, 185, 222, 255)


def b6b_elements(itt, B, M, n, seed, f32, terminal):
    """(B, M) seeded Riccati elements at n: make_elements of a random
    expansion (positive definite l_uu, n_u = max(1, n // 3)) with the
    terminal element, or the M stage elements alone (windowed products
    in every field)."""
    from ilqr_tpu_torch.ops import parallel_riccati
    from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

    g = torch.Generator(device=f32["device"]).manual_seed(seed)
    N = M - 1 if terminal else M
    n_u = max(1, n // 3)

    def r(*s):
        return torch.randn(s, generator=g, **f32)

    def eye(k):
        return torch.eye(k, **f32)

    W = r(B, N, n_u, n_u)
    exp = itt.TrajectoryExpansion(
        f_x=eye(n) + 0.05 * r(B, N, n, n), f_u=0.3 * r(B, N, n, n_u),
        l_x=r(B, N, n), l_u=r(B, N, n_u),
        l_xx=eye(n).expand(B, N, n, n).contiguous(),
        l_ux=0.1 * r(B, N, n_u, n), l_uu=W @ W.mT / n_u + eye(n_u),
        v_x=r(B, n), v_xx=10.0 * eye(n).expand(B, n, n).contiguous())
    el = parallel_riccati.make_elements(exp, 0.0)
    return RiccatiElement(*(t[:, :M].contiguous() for t in el))


def b6b_bound(B, M, n):
    """B6 over the batch: every element read once and every suffix
    written once (B M F floats each way), B M combines."""
    F = 3 * n * n + 2 * n
    return bound(2 * B * M * F * 4, B * M * combine_ops(n))


def batch_option_phases(itt, dev, smi, launches_per_call) -> list:
    """Phase 37: (a) B6 over the batch against its plain version at every
    edge of B6B_*, (b) the limited batched MPC and (c) the batched DDP +
    adaptive_reg solve, each path's launch counts reset just before it
    and read just after, and the kernels line's rows of B6 over the batch
    at (b)'s and (c)'s shapes.  Returns the rows."""
    from ilqr_tpu_torch import solver
    from ilqr_tpu_torch.ops import _build, limited_parallel, parallel_riccati
    from ilqr_tpu_torch.ops import suffix_scan
    from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load().lib
    t0 = t_lap = time.perf_counter()
    errors = {"suffix_scan_batched": 0.0}

    def lap(part):
        nonlocal t_lap
        now = time.perf_counter()
        print(f"phase 37{part}: {now - t_lap:.1f} s")
        t_lap = now

    def gate(label, ok, text):
        print(f"  {label}: {text}")
        if not ok:
            raise AssertionError(f"phase 37 {label}: {text}")

    # ---- (a) B6 over the batch against its plain version ----------------
    print(f"phase 37 (a): B6 over the batch, field by field max|kernel - "
          f"plain| <= max({RTOL_B6} * max|plain|, {F32_FLOOR} * max|plain "
          f"- plain in f64|); n {B6B_STATES}, B {B6B_BATCHES}")
    cases = 0
    for n in B6B_STATES:
        T = suffix_scan.tile_steps(lib, "sub", n)
        for B in B6B_BATCHES:
            Ms = sorted({1, T, T + 1} | {M for M in B6B_MS
                                         if B <= B6B_LONG_BATCH or M < 4097})
            for M in Ms:
                label = f"B6 batched n={n} B={B} M={M}"
                el = b6b_elements(itt, B, M, n, 1000 * n + 7 * B + M, f32,
                                  terminal=M % 2 == 1)
                plain = parallel_riccati.suffix_scan(el, axis=1)
                ref64 = parallel_riccati.suffix_scan(as_f64(el), axis=1)
                torch.cuda.synchronize()
                _build.reset_launch_counts()
                got = itt.suffix_scan_fused(el)
                again = itt.suffix_scan_fused(el)
                torch.cuda.synchronize()
                launches = _build.launch_counts()
                if launches != {"suffix_scan_batched": 2}:
                    raise AssertionError(f"{label}: two calls launched "
                                         f"{launches}")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{label}: a repeated call gave "
                                         f"other bits")
                notes = check_fields(label, got, plain, ref64, RTOL_B6,
                                     errors, "suffix_scan_batched")
                singles = [itt.suffix_scan_fused(RiccatiElement(
                    *(t[i] for t in el))) for i in range(B)]
                for f, field in enumerate(got):
                    if not torch.equal(field, torch.stack(
                            [s[f] for s in singles])):
                        raise AssertionError(
                            f"{label}: {RiccatiElement._fields[f]} differs "
                            f"from single-instance B6 calls")
                cases += 1
                if B != 3 or M in (1, 65, 4097):
                    print(f"{label}: " + "; ".join(notes) + "; one launch a "
                          "call, repeated call and every instance's single "
                          "call bit-identical")
    print(f"phase 37 (a): {cases} cases pass; max abs error "
          f"{errors['suffix_scan_batched']:.3e}")
    # Timed at (b)'s shape (the DP, n = 4, B = MPC_B, M = MPC_H + 1) and
    # (c)'s (the pendulum, n = 2, B = DDP_B, M = DDP_N + 1), with the same
    # batch as B single-instance launches in the same call.
    shapes = {"b": (4, MPC_B, MPC_H + 1), "c": (2, DDP_B, DDP_N + 1)}
    timed = {k: b6b_elements(itt, B, M, n, 5 + n, f32, terminal=True)
             for k, (n, B, M) in shapes.items()}
    t_b6b = design_timing(smi, "B6 batched", {
        k: lambda el=el: itt.suffix_scan_fused(el) for k, el in timed.items()},
        turns=3)
    t_single, t_plain = {}, {}
    for k, el in timed.items():
        ones = [RiccatiElement(*(t[i] for t in el))
                for i in range(el.A.shape[0])]
        t_single[k] = cuda_ms(lambda ones=ones: [itt.suffix_scan_fused(o)
                                                 for o in ones], 3, 1)
        t_plain[k] = cuda_ms(lambda el=el: parallel_riccati.suffix_scan(
            el, axis=1), 3, 1)
        n, B, M = shapes[k]
        print(f"B6 batched n={n} B={B} M={M} on {smi}: one launch events "
              f"{t_b6b[k]['event_ms']:.4f} ms, device "
              f"{ms_text(t_b6b[k]['device_us'])}; {B} single launches "
              f"{t_single[k]:.4f} ms; plain {t_plain[k]:.4f} ms; bound "
              f"{b6b_bound(B, M, n)[0]:.2e} ms")
    lap(" (a)")

    # ---- (b) the limited batched MPC --------------------------------------
    dp = dp_system(itt, f32)
    x0m = torch.zeros((MPC_B, 4), **f32)
    x0m[:, 1] += torch.linspace(-0.3, 0.3, MPC_B, **f32)
    Um = torch.zeros((MPC_H, 2), **f32)
    free = itt.solve_batch(dp, x0m, Um, itt.IlqrConfig(
        maxiter=5, tol=1e-4, backward="pallas"))
    lim = float(torch.quantile(free.U.abs().flatten(), LIMIT_QUANTILE))
    cfg_b = itt.IlqrConfig(maxiter=5, tol=1e-4, backward="pallas",
                           adaptive_reg=True, u_min=-lim, u_max=lim)
    with counting(limited_parallel, "_suffix_values") as scans:
        first, secs, counts = timed_run(
            lambda: itt.solve_batch(dp, x0m, Um, cfg_b))
    clamped = float((first.U.abs() >= lim * (1 - 1e-6)).float().mean())
    gate("limited batched solve", clamped >= MIN_CLAMPED
         and counts.get("suffix_scan_batched", 0) == scans[0]
         and counts.get("suffix_scan", 0) == 0
         and bool(torch.isfinite(first.cost).all()),
         f"|u| <= {lim:.4f} (the {LIMIT_QUANTILE} quantile of the "
         f"unconstrained first solve's |u|): {100 * clamped:.1f} % of the "
         f"controls clamped (at least {100 * MIN_CLAMPED:.0f} %); "
         f"{scans[0]} sweeps, launches {counts}; {secs:.3f} s, "
         f"{float(first.iterations.float().mean()):.2f} iterations")
    res, secs_b, counts_b = timed_run(lambda: itt.run_mpc_batched(
        dp, dp, x0m, Um, MPC_SIM, cfg_b))
    need("limited batched MPC", counts_b, ("suffix_scan_batched",))
    gate("limited batched MPC", bool(torch.isfinite(res.X).all())
         and res.X.shape == (MPC_B, MPC_SIM + 1, 4)
         and float(res.U.abs().max()) <= lim * (1 + 1e-6)
         and counts_b.get("suffix_scan", 0) == 0,
         f"B={MPC_B} H={MPC_H} n_sim={MPC_SIM}: {secs_b:.3f} s, "
         f"{MPC_B * MPC_SIM / secs_b:.1f} step-solves/s, "
         f"{float(res.solve_iters.float().mean()):.2f} iterations a solve, "
         f"launches {counts_b}")
    n_ref = min(LIMITED_REF_STEPS, MPC_SIM)
    for i in LIMITED_MPC_REFS:
        t_one = time.perf_counter()
        one = itt.run_mpc(dp, dp, x0m[i], Um, n_ref, cfg_b)
        dx = float((res.X[i, :n_ref + 1] - one.X).abs().max())
        gate(f"limited MPC instance {i}", dx <= ATOL_MPC,
             f"the first {n_ref} closed-loop steps against single-instance "
             f"run_mpc {dx:.2e} (limit {ATOL_MPC}; "
             f"{time.perf_counter() - t_one:.2f} s alone); iterations "
             f"{res.solve_iters[i, :n_ref].tolist()} / "
             f"{one.solve_iters.tolist()}")
    lap(" (b)")

    # ---- (c) the batched DDP + adaptive_reg solve -------------------------
    pend = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=100.0 * np.eye(2), d=0.1, integrator="rk4",
                             **f32)
    x0p = torch.zeros((DDP_B, 2), **f32)
    x0p[:, 0] += torch.linspace(-0.5, 0.5, DDP_B, **f32)
    Up = torch.zeros((DDP_N, 1), **f32)
    cfg_c = itt.IlqrConfig(maxiter=DDP_MAXITER, tol=1e-4, ddp=True,
                           adaptive_reg=True, reg_init=1e-6, ddp_sweeps=3,
                           backward="pallas", rollout="pallas")
    with counting(solver, "_backward_batch") as passes:
        ddp, secs_c, counts_c = timed_run(
            lambda: itt.solve_batch(pend, x0p, Up, cfg_c))
    need("DDP batched solve", counts_c, (
        "suffix_scan_batched", "linesearch_costs_batched",
        "closed_loop_rollout_batched", "open_loop_rollout_batched"))
    gate("DDP batched solve", counts_c["suffix_scan_batched"]
         == (cfg_c.ddp_sweeps + 1) * passes[0]
         and counts_c.get("suffix_scan", 0) == 0
         and bool(torch.isfinite(ddp.cost).all()),
         f"B={DDP_B} N={DDP_N}: {secs_c:.3f} s, {passes[0]} backward passes "
         f"(one launch of B6 over the batch a sweep, {cfg_c.ddp_sweeps + 1} "
         f"a pass), iterations {int(ddp.iterations.min())}-"
         f"{int(ddp.iterations.max())}, statuses "
         f"{torch.bincount(ddp.status, minlength=4).tolist()}, launches "
         f"{counts_c}")
    twin = dataclasses.replace(cfg_c, ddp=False)
    tw, secs_t, counts_t = timed_run(
        lambda: itt.solve_batch(pend, x0p, Up, twin))
    need("adaptive_reg batched solve", counts_t, ("batched_riccati",))
    gate("adaptive_reg batched solve (B4 with a (B,) reg)",
         bool(torch.isfinite(tw.cost).all())
         and counts_t.get("suffix_scan_batched", 0) == 0,
         f"{secs_t:.3f} s, iterations {int(tw.iterations.min())}-"
         f"{int(tw.iterations.max())}, launches {counts_t}")
    limits = {"cost": RTOL_BATCH, "X": ATOL_BATCH_X, "U": ATOL_BATCH_U}
    worst = dict.fromkeys(limits, 0.0)
    flips = 0
    t_one = time.perf_counter()
    for i in DDP_SAMPLES:
        one = itt.solve(pend, x0p[i], Up, cfg_c)
        c1 = float(one.cost)
        diffs = {"cost": abs(float(ddp.cost[i]) - c1) / abs(c1),
                 "X": float((ddp.X[i] - one.X).abs().max()),
                 "U": float((ddp.U[i] - one.U).abs().max())}
        flips += int(int(ddp.iterations[i]) != one.iterations)
        for key, d in diffs.items():
            worst[key] = max(worst[key], d)
            if not d <= limits[key]:
                raise AssertionError(
                    f"phase 37 DDP batched solve instance {i}: {key} differs "
                    f"from the instance solved alone by {d:.2e}, limit "
                    f"{limits[key]}")
    print(f"  DDP batched solve: instances {list(DDP_SAMPLES)} agree with "
          f"single-instance solves: cost rel {worst['cost']:.2e}, X "
          f"{worst['X']:.2e}, U {worst['U']:.2e} (limits {RTOL_BATCH}, "
          f"{ATOL_BATCH_X}, {ATOL_BATCH_U}); {flips} of "
          f"{len(DDP_SAMPLES)} ended at another iteration count; the "
          f"solves alone {time.perf_counter() - t_one:.2f} s")
    lap(" (c)")

    rows = []
    for k, launches, path in (
            ("b", counts_b.get("suffix_scan_batched", 0),
             f"limited batched MPC, {MPC_SIM} steps"),
            ("c", counts_c.get("suffix_scan_batched", 0),
             "DDP batched solve")):
        n, B, M = shapes[k]
        ms, cols = timing_columns(t_b6b[k],
                                  launches_per_call.get("suffix_scan_batched"))
        b = b6b_bound(B, M, n)
        rows.append(dict(
            name=f"suffix_scan_batched_n{n}_b{B}_m{M}", route="cuda",
            source="ilqr_tpu_torch/csrc/suffix_scan.cu",
            replaces="ilqr_tpu/ops/pallas_riccati.py:515", launches=launches,
            max_abs_err=errors["suffix_scan_batched"], ms=ms,
            plain_ms=t_plain[k], bound_ms=b[0], bound_by=b[1],
            library_ms=None, single_launches_ms=t_single[k], path=path,
            **cols))
    print(f"phase 37: {time.perf_counter() - t0:.1f} s")
    return rows


def batch_option_turn() -> int:
    """``python3 chip_smoke.py --batch-options``: build the kernels and run
    phase 37 alone (no launches-per-call column), printing its kernels
    line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    import ilqr_tpu_torch as itt
    from ilqr_tpu_torch.ops import _build

    smi = nvidia_smi()
    print(smi)
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s (nvcc "
          f"{lib.build_seconds:.1f} s)")
    for line in ptxas_summary(lib.ptxas_log):
        if "scan_kernel" in line:
            print(line)
    rows = batch_option_phases(itt, torch.device("cuda", 0), smi, {})
    print(json.dumps({"kernels": rows}))
    return 0


# ---- Phase 38: batched parallel-in-time line searches -------------------

# (a): B3 over the batch against its plain version: the register form at
# n = 2, 4 (up to 16 candidates) and the wide form at n = 6, 12 (and at
# n = 2, 4 with 17 candidates), at B = 1, 3 and 64 and N = 1, T - 1, T,
# T + 1 and 5T + T/2 + 3 for each form's T.  Tolerance RTOL_B3's rule (as
# check_b3); every call twice, bit for bit; one launch a call; each
# instance bit for bit a single-instance B3 call on it.
B3B_STATES = (2, 4, 6, 12)
B3B_CANDIDATES = (1, 10, 17)
B3B_BATCHES = (1, 3, 64)
# (b): the DP flagship's problem (phase 8's config: N = 500, euler, maxiter
# 200, tol 1e-6, init_rollout='defect') as a batch of PAR_B initial states
# (x0 = 0 and seeded perturbations of its angles, PAR_SPREAD rad), with
# rollout='defect' and then 'chunked', backward='pallas' (B4) and
# defect_engine='pallas' (B3 over the batch).  Instance 0 meets phase 4's
# gates (dp_gates); PAR_SAMPLES are held to single-instance solves with
# the same config.  Instance 0 is held in f32 to phase 8's solves (from
# x0 = 0): iterations, status and latch equal, cost within RTOL_PAR
# relative, X and U within ATOL_PAR_X / ATOL_PAR_U.  The batch runs B4
# where a single solve runs B1, so f32 rounding can move the iteration at
# which tol = 1e-6 (below one ulp of the cost) stops an instance, or its
# basin; such instances are compared in f64 on the card instead (the
# plain engines, one batch of them against single solves, cut to
# PAR64_MAXITER iterations: both phases, the exact fallback and the
# latch's drop run in the first), as ROADMAP Queue C records for
# DP-family trajectories.  The other samples go to f64 directly: in every
# run on the card f32 parted for every sampled instance (iteration counts
# one apart), so their f32 single solves (17.2 and 7.2 s) showed rounding
# only.  Every solve here runs the exact line search's host loop of 500
# steps an iteration (the latch drops at iteration 0 under 'defect'),
# 0.5-1 s an iteration on the card.
PAR_B, PAR_SPREAD = 16, 0.05
PAR_SAMPLES = (0, 11)
PAR64_MAXITER = 3
RTOL_PAR, ATOL_PAR_X, ATOL_PAR_U = 1e-4, 1e-3, 1e-2
# In f64 a batched instance and its single solve start apart: under
# init_rollout='defect' a single solve takes the open-loop defect sweeps'
# iterate, certified to their exit tolerance 1e-3 · defect_tol = 1e-6,
# where the batch rolls out exactly (JAX's rule under vmap).  From x0 = 0
# both are the rest state; from a perturbed x0 they part by about that
# tolerance (a rehearsal on CPU tensors: cost 6.2e-8 relative, X 1.0e-6,
# U 7.8e-6 after 3 iterations, under both searches).  A wrong branch of
# the search moves the iterations, status or latch, or X by 1e-2 and
# more.
RTOL_PAR64, ATOL_PAR64_X, ATOL_PAR64_U = 1e-6, 1e-4, 1e-3
# (c): run_mpc_batched with rollout='defect' on phase 16b's pendulum MPC
# (backward-Euler solver, midpoint plant, H = PEND_H, maxiter 10, tol 1e-5)
# from PEND_BATCH initial angles for PEND_STEPS steps, two instances held
# to single-instance run_mpc over every step within ATOL_MPC.
# examples_torch/long_horizon.py's main at LONG_HORIZON_N steps (cut from
# 100000: its sequential rollout and line search are host loops of N
# steps, 1.7 ms a step on the card; N = 128 took 6.2 s).
LONG_HORIZON_N = 64


def b3b_bound(B, N, n, A):
    """B3 over the batch: B times B3's bytes and operations."""
    return bound(4 * B * (N * n * n + A * N * n + A * n + A * (N + 1) * n),
                 B * A * N * 2 * n * n)


def random_chains(B, N, n, A, seed, f32):
    """B seeded random chains (`random_chain`), stacked."""
    chains = [random_chain(N, n, A, seed + 7919 * i, f32) for i in range(B)]
    return tuple(torch.stack(t).contiguous() for t in zip(*chains))


def instance_of(sol, i):
    """Instance i of a batched `IlqrSolution`, with Python ints and bools
    as `solve` returns them."""
    fields = {f.name: getattr(sol, f.name)[i]
              for f in dataclasses.fields(sol)}
    fields.update(iterations=int(fields["iterations"]),
                  status=int(fields["status"]),
                  defect_latch=bool(fields["defect_latch"]))
    return dataclasses.replace(sol, **fields)


@contextlib.contextmanager
def recording_scans():
    """The candidate counts of the batched defect sweeps' B3 calls in the
    block (one a sweep), by wrapping the sweeps' scan."""
    from ilqr_tpu_torch.ops import parallel_rollout
    calls = []
    orig = parallel_rollout.affine_prefix_scan_batched

    def recorded(P, q, delta0, engine="auto"):
        calls.append(q.shape[1])
        return orig(P, q, delta0, engine)

    parallel_rollout.affine_prefix_scan_batched = recorded
    try:
        yield calls
    finally:
        parallel_rollout.affine_prefix_scan_batched = orig


def batch_parallel_phases(itt, dev, smi, launches_per_call,
                          singles=None) -> list:
    """Phase 38: (a) B3 over the batch against its plain version at every
    edge of B3B_*, (b) the batched defect and chunked line searches on the
    DP flagship's problem, (c) the batched pendulum MPC under
    rollout='defect', and examples_torch/long_horizon.py's main, each
    path's launch counts reset just before it and read just after.
    ``singles`` {rollout: solution} holds phase 8's single-instance solves
    from x0 = 0, which (b) takes for instance 0's references (solved here
    when absent).  Returns the kernels line's rows of B3 over the batch at
    (b)'s and (c)'s shapes."""
    from examples_torch import long_horizon
    from ilqr_tpu_torch.ops import _build, affine_scan

    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load().lib
    t0 = t_lap = time.perf_counter()
    errors = {"affine_prefix_scan": 0.0}

    def lap(part):
        nonlocal t_lap
        now = time.perf_counter()
        print(f"phase 38{part}: {now - t_lap:.1f} s")
        t_lap = now

    def gate(label, ok, text):
        print(f"  {label}: {text}")
        if not ok:
            raise AssertionError(f"phase 38 {label}: {text}")

    # ---- (a) B3 over the batch against its plain version ----------------
    print(f"phase 38 (a): B3 over the batch, max|kernel - plain| <= "
          f"max({RTOL_B3} * max|plain|, {F32_FLOOR} * max|plain - plain in "
          f"f64|); n {B3B_STATES}, A {B3B_CANDIDATES}, B {B3B_BATCHES}")
    cases = 0
    for n in B3B_STATES:
        for A in B3B_CANDIDATES:
            T = affine_scan.tile_steps(lib, n, A)
            worst = 0.0
            for B in B3B_BATCHES:
                for N in (1, T - 1, T, T + 1, 5 * T + T // 2 + 3):
                    label = f"B3 batched n={n} A={A} B={B} N={N}"
                    P, q, d0 = random_chains(B, N, n, A,
                                             1000 * n + 10 * A + B + N, f32)
                    plain = itt.affine_prefix_scan_batched(P, q, d0,
                                                           engine="xla")
                    ref64 = itt.affine_prefix_scan_batched(
                        P.double(), q.double(), d0.double(), engine="xla")
                    torch.cuda.synchronize()
                    _build.reset_launch_counts()
                    got = itt.affine_prefix_scan_batched(P, q, d0,
                                                         engine="pallas")
                    again = itt.affine_prefix_scan_batched(P, q, d0,
                                                           engine="pallas")
                    torch.cuda.synchronize()
                    launches = _build.launch_counts()
                    if launches != {"affine_prefix_scan_batched": 2}:
                        raise AssertionError(f"{label}: two calls launched "
                                             f"{launches}")
                    if not torch.equal(got, again):
                        raise AssertionError(f"{label}: a repeated call gave "
                                             f"other bits")
                    err = rel_err(got, plain)[0]
                    limit = max(RTOL_B3 * float(plain.abs().max()),
                                F32_FLOOR * rel_err(plain, ref64)[0])
                    if not (bool(torch.isfinite(got).all()) and err <= limit):
                        raise AssertionError(f"{label}: max abs error "
                                             f"{err:.2e}, limit {limit:.2e}")
                    for i in range(B):
                        one = itt.affine_prefix_scan_multi(
                            P[i], q[i], d0[i], engine="pallas")
                        if not torch.equal(got[i], one):
                            raise AssertionError(
                                f"{label}: instance {i} differs from a "
                                f"single-instance B3 call")
                    worst = max(worst, err)
                    cases += 1
            errors["affine_prefix_scan"] = max(errors["affine_prefix_scan"],
                                               worst)
            print(f"B3 batched n={n} A={A} (tile {T} steps): B "
                  f"{B3B_BATCHES}, N 1, T +- 1, 5T + T/2 + 3: max abs error "
                  f"{worst:.2e}; one launch a call, repeated calls and every "
                  f"instance's single call bit-identical")
    print(f"phase 38 (a): {cases} cases pass; max abs error "
          f"{errors['affine_prefix_scan']:.3e}")
    lap(" (a)")

    # ---- (b) the batched defect and chunked line searches (DP) -----------
    dp = dp_system(itt, f32)
    g = torch.Generator(device=dev).manual_seed(38)
    x0s = torch.zeros((PAR_B, 4), **f32)
    x0s[1:, :2] = PAR_SPREAD * torch.randn((PAR_B - 1, 2), generator=g,
                                           **f32)
    U0 = torch.zeros((500, 2), **f32)
    shapes = {}
    b_runs = {}
    for engine in ("defect", "chunked"):
        cfg = itt.IlqrConfig(maxiter=200, tol=1e-6, backward="pallas",
                             rollout=engine, init_rollout="defect",
                             defect_engine="pallas")
        with recording_scans() as scans:
            sol, secs, counts = timed_run(
                lambda: itt.solve_batch(dp, x0s, U0, cfg))
        label = f"batched DP solve ({engine})"
        b_runs[engine] = (counts, scans)
        gate(label, counts.get("affine_prefix_scan", 0) == 0
             and counts.get("affine_prefix_scan_batched", 0) == len(scans)
             and (len(scans) > 0) == (engine == "defect")
             and bool(torch.isfinite(sol.cost).all()),
             f"B={PAR_B} N=500: {secs:.3f} s, iterations "
             f"{sol.iterations.tolist()}, statuses "
             f"{torch.bincount(sol.status, minlength=4).tolist()}, latches "
             f"{int(sol.defect_latch.sum())} of {PAR_B} set; {len(scans)} "
             f"sweeps ({scans.count(1)} of one candidate, "
             f"{len(scans) - scans.count(1)} of {len(cfg.alpha_schedule())}),"
             f" launches {counts}")
        dp_gates(itt, instance_of(sol, 0), f"{label} instance 0", counts,
                 ("batched_riccati", "affine_prefix_scan_batched")
                 if engine == "defect" else ("batched_riccati",))
        parted = list(PAR_SAMPLES[1:])
        for i in PAR_SAMPLES[:1]:
            t_one = time.perf_counter()
            one = (singles or {}).get(engine) or itt.solve(dp, x0s[i], U0,
                                                           cfg)
            mine = instance_of(sol, i)
            same = ((mine.iterations, mine.status, mine.defect_latch)
                    == (one.iterations, one.status, one.defect_latch))
            d = (abs(float(mine.cost) - float(one.cost)) / abs(float(
                one.cost)), float((mine.X - one.X).abs().max()),
                float((mine.U - one.U).abs().max()))
            text = (f"iterations {mine.iterations} / {one.iterations}, "
                    f"status {mine.status} / {one.status}, latch "
                    f"{mine.defect_latch} / {one.defect_latch}; cost rel "
                    f"{d[0]:.2e}, X {d[1]:.2e}, U {d[2]:.2e} (limits "
                    f"{RTOL_PAR}, {ATOL_PAR_X}, {ATOL_PAR_U}); "
                    f"{time.perf_counter() - t_one:.2f} s alone")
            if same and d[0] <= RTOL_PAR and d[1] <= ATOL_PAR_X \
                    and d[2] <= ATOL_PAR_U:
                gate(f"{label} instance {i}", True, "f32 against solve: "
                     + text)
            else:
                print(f"  {label} instance {i}: f32 parts from solve "
                      f"({text}); held in f64 below")
                parted.insert(0, i)
        if parted:
            # f32 rounding decided these instances' stops or basins: hold
            # them in f64 on the plain engines (the associative backward
            # pass, the plain scan), one batch of them against single
            # solves.
            t64 = time.perf_counter()
            cfg64 = dataclasses.replace(cfg, backward="pscan",
                                        defect_engine="xla",
                                        maxiter=PAR64_MAXITER)
            dp64 = dp_system(itt, dict(dtype=torch.float64, device=dev))
            x64 = x0s[parted].double()
            b64 = itt.solve_batch(dp64, x64, U0.double(), cfg64)
            for j, i in enumerate(parted):
                bj = instance_of(b64, j)
                s64 = itt.solve(dp64, x64[j], U0.double(), cfg64)
                d64 = (abs(float(bj.cost) - float(s64.cost)) / abs(float(
                    s64.cost)), float((bj.X - s64.X).abs().max()),
                    float((bj.U - s64.U).abs().max()))
                gate(f"{label} instance {i} in f64",
                     (bj.iterations, bj.status, bj.defect_latch)
                     == (s64.iterations, s64.status, s64.defect_latch)
                     and d64[0] <= RTOL_PAR64 and d64[1] <= ATOL_PAR64_X
                     and d64[2] <= ATOL_PAR64_U,
                     f"iterations {bj.iterations} / {s64.iterations}, "
                     f"status {bj.status} / {s64.status}, latch "
                     f"{bj.defect_latch} / {s64.defect_latch}; cost rel "
                     f"{d64[0]:.2e}, X {d64[1]:.2e}, U {d64[2]:.2e} (limits "
                     f"{RTOL_PAR64}, {ATOL_PAR64_X}, {ATOL_PAR64_U})")
            print(f"  {label}: the f64 re-check of instances {parted} took "
                  f"{time.perf_counter() - t64:.2f} s")
    shapes["b1"] = (PAR_B, 500, 4, 1)
    shapes["b10"] = (PAR_B, 500, 4, len(itt.IlqrConfig().alpha_schedule()))
    lap(" (b)")

    # ---- (c) the batched pendulum MPC under rollout='defect' -------------
    def mpc_pendulum(integrator):
        return itt.make_pendulum(
            0.01, [np.pi, 0.0], Q=np.diag([10.0, 1.0]), R=np.eye(1),
            Q_f=np.diag([10.0, 10.0]), d=0.0, integrator=integrator, **f32)

    p_solver, p_plant = (mpc_pendulum("backward_euler"),
                         mpc_pendulum("midpoint"))
    x0p = torch.zeros((PEND_BATCH, 2), **f32)
    x0p[:, 0] = torch.linspace(0.0, 0.7, PEND_BATCH, **f32)
    Up = torch.zeros((PEND_H, 1), **f32)
    cfg_c = itt.IlqrConfig(maxiter=10, tol=1e-5, rollout="defect",
                           defect_engine="pallas")
    with recording_scans() as scans_c:
        res, secs_c, counts_c = timed_run(lambda: itt.run_mpc_batched(
            p_solver, p_plant, x0p, Up, PEND_STEPS, cfg_c))
    need("batched defect MPC", counts_c, ("batched_riccati",
                                          "affine_prefix_scan_batched"))
    gate("batched defect MPC", counts_c.get("affine_prefix_scan", 0) == 0
         and counts_c["affine_prefix_scan_batched"] == len(scans_c)
         and bool(torch.isfinite(res.X).all())
         and res.X.shape == (PEND_BATCH, PEND_STEPS + 1, 2),
         f"B={PEND_BATCH} H={PEND_H} n_sim={PEND_STEPS}: {secs_c:.3f} s, "
         f"{float(res.solve_iters.float().mean()):.2f} iterations a solve, "
         f"{len(scans_c)} sweeps ({scans_c.count(1)} of one candidate), "
         f"launches {counts_c}")
    for i in (0, PEND_BATCH - 1):
        t_one = time.perf_counter()
        one = itt.run_mpc(p_solver, p_plant, x0p[i], Up, PEND_STEPS, cfg_c)
        dx = float((res.X[i] - one.X).abs().max())
        gate(f"batched defect MPC instance {i}", dx <= ATOL_MPC,
             f"every closed-loop step against single-instance run_mpc "
             f"{dx:.2e} (limit {ATOL_MPC}); iterations "
             f"{res.solve_iters[i].tolist()} / {one.solve_iters.tolist()}; "
             f"{time.perf_counter() - t_one:.2f} s alone")
    shapes["c"] = (PEND_BATCH, PEND_H, 2, 1)
    lap(" (c)")

    # ---- examples_torch/long_horizon.py's main ---------------------------
    out, secs_l, counts_l = timed_run(
        lambda: long_horizon.main(N=LONG_HORIZON_N, device=dev))
    need("long_horizon driver", counts_l, ("fused_riccati",
                                           "affine_prefix_scan"))
    gate("long_horizon driver", all(
        bool(torch.isfinite(s.cost)) for s in (out.sol, out.sol_seq,
                                               out.sol_ms))
         and float(out.defect) <= 1e-5,
         f"N={LONG_HORIZON_N}: {secs_l:.2f} s; costs {float(out.sol.cost):.4f}"
         f" (defect line search, latch {out.sol.defect_latch}), "
         f"{float(out.sol_seq.cost):.4f} (sequential), "
         f"{float(out.sol_ms.cost):.4f} (multiple shooting, defect "
         f"{float(out.sol_ms.defect):.1e}); launches {counts_l}")
    lap(" long_horizon")

    # ---- B3 over the batch timed at the paths' shapes --------------------
    timed_in = {k: random_chains(B, N, n, A, 77 + n, f32)
                for k, (B, N, n, A) in shapes.items()}
    t_b3b = design_timing(smi, "B3 batched", {
        k: lambda c=c: itt.affine_prefix_scan_batched(*c, engine="pallas")
        for k, c in timed_in.items()}, turns=3)
    rows = []
    path_launches = {
        "b1": (b_runs["defect"][1].count(1), "batched DP defect solve, "
               "phase 1 (one candidate)"),
        "b10": (len(b_runs["defect"][1]) - b_runs["defect"][1].count(1),
                "batched DP defect solve, phase 2"),
        "c": (scans_c.count(1), f"batched pendulum MPC, {PEND_STEPS} "
              f"steps, phase 1 (one candidate)")}
    for k, (B, N, n, A) in shapes.items():
        c = timed_in[k]
        for i in range(B):   # each instance against its plain version
            check_b3(itt, f"batched path shape instance {i}",
                     *(t[i] for t in c), errors)
        single = cuda_ms(lambda c=c, B=B: [itt.affine_prefix_scan_multi(
            c[0][i], c[1][i], c[2][i], engine="pallas") for i in range(B)],
            3, 1)
        plain = cuda_ms(lambda c=c: itt.affine_prefix_scan_batched(
            *c, engine="xla"), 3, 1)
        b = b3b_bound(B, N, n, A)
        ms, cols = timing_columns(
            t_b3b[k], launches_per_call.get("affine_prefix_scan_batched"))
        print(f"B3 batched n={n} B={B} N={N} A={A} on {smi}: one launch "
              f"events {t_b3b[k]['event_ms']:.4f} ms, device "
              f"{ms_text(t_b3b[k]['device_us'])}; {B} single launches "
              f"{single:.4f} ms; plain {plain:.4f} ms; bound {b[0]:.2e} ms "
              f"({b[1]})")
        launches, path = path_launches[k]
        rows.append(dict(
            name=f"affine_prefix_scan_batched_n{n}_b{B}_n{N}_a{A}",
            route="cuda", source="ilqr_tpu_torch/csrc/affine_scan.cu",
            replaces="ilqr_tpu/ops/pallas_affine.py:137", launches=launches,
            max_abs_err=errors["affine_prefix_scan"], ms=ms, plain_ms=plain,
            bound_ms=b[0], bound_by=b[1], library_ms=None,
            single_launches_ms=single, path=path, **cols))
    lap(" timing")
    print(f"phase 38: {time.perf_counter() - t0:.1f} s")
    return rows


def sass_turn() -> int:
    """``python3 chip_smoke.py --sass``: build the kernels and print
    `sass_report`'s step loops (a diagnostic, run alone since phase 38
    came: ~20-27 s of cuobjdump)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    from ilqr_tpu_torch.ops import _build

    kernels = _build.load()
    t0 = time.perf_counter()
    for line in sass_report(kernels.path, kernels.ptxas_log):
        print(line)
    print(f"SASS report: {time.perf_counter() - t0:.1f} s")
    return 0


def batch_parallel_turn() -> int:
    """``python3 chip_smoke.py --batch-parallel``: build the kernels and
    run phase 38 alone (no launches-per-call column), printing its kernels
    line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    import ilqr_tpu_torch as itt
    from ilqr_tpu_torch.ops import _build

    smi = nvidia_smi()
    print(smi)
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s (nvcc "
          f"{lib.build_seconds:.1f} s)")
    for line in ptxas_summary(lib.ptxas_log):
        if "prefix_kernel" in line:
            print(line)
    rows = batch_parallel_phases(itt, torch.device("cuda", 0), smi, {})
    print(json.dumps({"kernels": rows}))
    return 0


# ---- Phase 39: learned dynamics (the neural residual) and collocation -----

# (a): B2's three entries on the neural form (csrc/forms.cuh, NeuralForm) at
# neural_sysid.py's fitted pendulum ((32, 32), rk4, dt 0.05) and the 3-D
# quadrotor with a (64, 64, 64) residual (rk4 at dt 0.005, phase 28's
# nominal draws), 10 alphas at N = 1, the ring's chunk edge +- 1, its ring
# edge +- 1, its H = 40 (also with 33 alphas) and 500; each against
# the plain rollouts in f64 on the card under phase 35's rule, every call
# twice, bit for bit.  A zero output layer gives the base form's bits.
LEARNED_H = 40
LEARNED_N = 500
LEARNED_WIDE = ("quadrotor3d", (64, 64, 64))
# (b): B5's three entries at MPPI's (512, 30) and a batched solve's
# (64, 40), one mppi_update and the batched solve on the fitted model.
LEARNED_B5 = ((512, 30), (64, LEARNED_H))
# (c): the example's gates (tests/test_neural.py:61-91): the 10-step loss
# below FIT_RATIO of its start after 1000 Adam steps; MPC with the learned
# model LEARNED_MARGIN below the nominal's cost and within LEARNED_ORACLE of
# the true model's; its first LEARNED_SCAN_STEPS steps again under 'scan'
# within RTOL_LEARNED_SCAN of the kernels' closed-loop cost.
FIT_RATIO = 0.01
LEARNED_MARGIN = 1.0
LEARNED_ORACLE = 0.5
LEARNED_SCAN_STEPS = 5
RTOL_LEARNED_SCAN = 1e-3
# (d): tests/test_cross_validation.py:117-131's pendulum (euler, N = 100)
# by solve_collocation on the card against the card's solve.
COLLOC_N = 100


def mlp_ops(widths) -> int:
    """One evaluation of a neural residual's MLP of layer widths w_0 ...
    w_L, a multiply-add counting two: each layer's products and sums
    (2 w_l w_{l+1}) and biases, a tanh (one) a hidden unit, and the sum
    with the base's f (w_L)."""
    ops = sum(2 * a * b + b for a, b in zip(widths, widths[1:]))
    return ops + sum(widths[1:-1]) + widths[-1]


def mlp_floats(widths) -> int:
    """Floats of an MLP's parameter block: the layer count and widths,
    then each layer's W and b."""
    return len(widths) + 1 + sum((a + 1) * b for a, b in zip(widths,
                                                            widths[1:]))


def neural_name(base: str, widths) -> str:
    """The `rollout_step_ops` model name of a neural residual."""
    return f"neural:{base}:{'-'.join(map(str, widths))}"


def learned_wide_system(itt, f32, seed=39):
    """The 3-D quadrotor (phase 28's, rk4 at dt 0.005) with a seeded
    (64, 64, 64) residual whose output layer is drawn too (scale 0.05)."""
    name, hidden = LEARNED_WIDE
    base = wide_model_systems(itt, f32, "rk4")[name]
    return drawn_output(itt.make_neural_residual(
        base, hidden=hidden, generator=torch.Generator().manual_seed(seed)),
        seed)


def drawn_output(net, seed, scale=0.05):
    """``net`` with its output layer drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(seed + 1)
    layers = [dict(layer) for layer in net.params["mlp"]]
    for k in ("W", "b"):
        t = layers[-1][k]
        layers[-1][k] = (scale * torch.randn(t.shape, generator=gen,
                                             dtype=t.dtype)).to(t.device)
    return net.replace(params={**net.params, "mlp": layers})


def learned_phases(itt, dev, smi, launches_per_call) -> list:
    """Phase 39: (c) examples_torch/neural_sysid.py's story at full size
    (the fit, MPC on the true plant with the nominal, learned and true
    models through B1 and B2, the learned model's first steps under
    'scan'), (b) B5 on the fitted model (one mppi_update, a batched solve),
    (a) B2 on the neural form against its plain versions, (d) the
    collocation oracle against the card's solve; each path's launch
    counts reset just before it and read just after.  Returns the kernels
    line's rows of the neural form."""
    from examples_torch import mppi_pendulum as mp
    from examples_torch import neural_sysid as ns
    from ilqr_tpu_torch import mppi
    from ilqr_tpu_torch.collocation import solve_collocation
    from ilqr_tpu_torch.models.neural import prediction_loss
    from ilqr_tpu_torch.mpc import run_mpc
    from ilqr_tpu_torch.ops import _build, fused_rollout

    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load().lib
    t0 = t_lap = time.perf_counter()
    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    A10 = alphas.numel()
    rows = []

    def lap(part):
        nonlocal t_lap
        now = time.perf_counter()
        print(f"phase 39{part}: {now - t_lap:.1f} s")
        t_lap = now

    def gate(label, ok, text):
        print(f"  {label}: {text}")
        if not ok:
            raise AssertionError(f"phase 39 {label}: {text}")

    # ---- (c) neural_sysid.py's story --------------------------------------
    p = ns.problem(dev)
    loss0 = float(prediction_loss(p.net, p.X, p.U, horizon=p.horizon))
    (net, losses), secs_fit, _ = timed_run(
        lambda: itt.fit_dynamics(p.net, p.X, p.U, **p.fit))
    loss1 = float(prediction_loss(net, p.X, p.U, horizon=p.horizon))
    B_fit, N_fit = p.U.shape[:2]
    gate("fit", loss1 < FIT_RATIO * loss0 and losses.shape ==
         (p.fit["steps"],) and bool(torch.isfinite(losses).all()),
         f"{p.fit['steps']} Adam steps on B = {B_fit}, N = {N_fit}, horizon "
         f"{p.horizon}: 10-step loss {loss0:.4e} -> {loss1:.4e} "
         f"({loss1 / loss0:.4f} of its start, limit {FIT_RATIO}); "
         f"{secs_fit:.2f} s, {secs_fit / p.fit['steps'] * 1e3:.1f} ms a step")
    mpc, mpc_counts = {}, {}
    for name, model in (("nominal", p.nominal), ("learned", net),
                        ("oracle", p.plant)):
        res, secs, counts = timed_run(lambda model=model: run_mpc(
            model, p.plant, p.x0, p.U0, p.n_sim, p.config))
        mpc[name], mpc_counts[name] = res, counts
        x = res.X[-1].cpu().numpy()
        print(f"  MPC with the {name} model (H = {p.U0.shape[0]}, "
              f"{p.n_sim} steps, maxiter {p.config.maxiter}, pallas): cost "
              f"{float(res.cost):.4f}, final state [{x[0]:+.4f} "
              f"{x[1]:+.4f}], {secs:.2f} s ({secs / p.n_sim * 1e3:.1f} ms a "
              f"step), launches {counts}")
        need(f"MPC with the {name} model", counts,
             ("fused_riccati", "linesearch_costs", "closed_loop_rollout",
              "open_loop_rollout"))
    c = {k: float(v.cost) for k, v in mpc.items()}
    gate("learned MPC", c["learned"] < c["nominal"] - LEARNED_MARGIN
         and abs(c["learned"] - c["oracle"]) < LEARNED_ORACLE,
         f"learned {c['learned']:.4f} < nominal {c['nominal']:.4f} - "
         f"{LEARNED_MARGIN}, |learned - oracle {c['oracle']:.4f}| < "
         f"{LEARNED_ORACLE}")
    cfg_scan = dataclasses.replace(p.config, backward="scan", rollout="scan")
    short = {cfg.rollout: run_mpc(net, p.plant, p.x0, p.U0,
                                  LEARNED_SCAN_STEPS, cfg)
             for cfg in (p.config, cfg_scan)}
    d = abs(float(short["pallas"].cost) - float(short["scan"].cost)) / abs(
        float(short["scan"].cost))
    gate("learned MPC under 'scan'", d <= RTOL_LEARNED_SCAN,
         f"first {LEARNED_SCAN_STEPS} steps: pallas "
         f"{float(short['pallas'].cost):.6f}, scan "
         f"{float(short['scan'].cost):.6f} ({d:.2e} relative, limit "
         f"{RTOL_LEARNED_SCAN})")
    lap(" (c)")

    # ---- (b) B5 on the fitted model ---------------------------------------
    widths = fused_rollout.mlp_widths(net.params["mlp"])
    model = neural_name("pendulum", widths)
    extra = mlp_floats(widths)
    sys64 = net.replace(params=params_f64(net.params))

    def held(label, got, plain, ref64, rtol):
        """Gate each output (X, U, cost, as many as there are) against the
        f64 plain version within rtol of its max, or F32_FLOOR times the
        f32 plain version's own error (phase 35's rule); returns the
        largest error."""
        worst = 0.0
        names = {1: ("cost",), 2: ("X", "cost"), 3: ("X", "U", "cost")}
        for out, g, r32, r in zip(names[len(got)], got, plain, ref64):
            err, rr = rel_err(g, r)
            floor = rel_err(r32, r)[0]
            ok = err <= max(rtol * float(r.abs().max()), F32_FLOOR * floor)
            gate(f"{label} {out}", bool(torch.isfinite(g).all()) and ok,
                 f"{err:.2e} ({rr:.1e} of max; f32 plain {floor:.2e}; limit "
                 f"max({rtol} of max, {F32_FLOOR} x f32 plain))")
            worst = max(worst, err)
        return worst

    def twice(fn):
        got, again = fn(), fn()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("phase 39: a repeated call gave other bits")
        return got

    def batch_inputs(system, B, N, seed):
        rng = np.random.default_rng(seed)
        x0s, U, u_ff = (torch.tensor(0.3 * rng.standard_normal(s), **f32)
                        for s in ((B, 2), (B, N, 1), (B, N, 1)))
        K = torch.tensor(-0.05 * rng.standard_normal((B, N, 1, 2)), **f32)
        X, _ = itt.rollout(system, x0s, U)
        return x0s, X.contiguous(), U, u_ff, K

    def b5_check(B, N):
        x0s, X, U, u_ff, K = batch_inputs(net, B, N, 1000 + B + N)
        args = (x0s, alphas, X, U, u_ff, K)
        ref = itt.linesearch_rollouts(sys64, *(t.double() for t in args))
        r32 = itt.linesearch_rollouts(net, *args)
        ref_o = itt.rollout(sys64, x0s.double(), U.double())
        r32_o = itt.rollout(net, x0s, U)
        a = torch.arange(B, device=dev) % A10
        b = torch.arange(B, device=dev)
        lab = f"B5 neural ({B}, {N})"
        err = {
            "linesearch_costs_batched": held(
                f"{lab} costs", twice(lambda: itt.linesearch_costs_batched(
                    net, *args)), (r32[2],), (ref[2],), RTOL_B5),
            "closed_loop_rollout_batched": held(
                f"{lab} trajectory", twice(
                    lambda: itt.closed_loop_rollout_batched(
                        net, x0s, alphas[a].contiguous(), X, U, u_ff, K)),
                tuple(t[b, a] for t in r32), tuple(t[b, a] for t in ref),
                RTOL_B5),
            "open_loop_rollout_batched": held(
                f"{lab} open loop", twice(
                    lambda: itt.open_loop_rollout_batched(net, x0s, U)),
                r32_o, ref_o, RTOL_B5)}
        plain = {
            "linesearch_costs_batched": lambda: itt.linesearch_rollouts(
                net, *args),
            "closed_loop_rollout_batched": lambda: itt.linesearch_rollouts(
                net, x0s, alphas[a][:, None], X, U, u_ff, K),
            "open_loop_rollout_batched": lambda: itt.rollout(net, x0s, U)}
        kern = {
            "linesearch_costs_batched": lambda: itt.linesearch_costs_batched(
                net, *args),
            "closed_loop_rollout_batched":
                lambda: itt.closed_loop_rollout_batched(
                    net, x0s, alphas[a].contiguous(), X, U, u_ff, K),
            "open_loop_rollout_batched": lambda: itt.open_loop_rollout_batched(
                net, x0s, U)}
        return err, kern, plain

    b5 = {shape: b5_check(*shape) for shape in LEARNED_B5}
    # One MPPI update on the fitted model: its samples through B5's open
    # loop (`mppi._takes`), and through the plain rollouts (patched in).
    mc = mp.problem(dev).mppi_config
    S, H8 = mc.samples, LEARNED_B5[0][1]
    U_fix = torch.zeros((H8, 1), **f32)
    gen = partial(torch.Generator(device=dev).manual_seed, P8_SEED)
    (U_k, ess_k), _, counts_m = timed_run(
        lambda: mppi.mppi_update(net, p.x0, U_fix, gen(), mc))
    gate("MPPI update launches", counts_m == {
        "open_loop_rollout_batched": 1}, f"{counts_m} (one of B5's open loop "
         f"for {S} samples)")
    sample_costs = mppi._sample_costs
    mppi._sample_costs = lambda system, x0, U: itt.rollout(
        system, x0.expand(U.shape[0], x0.shape[0]), U)[1]
    try:
        U_p, ess_p = mppi.mppi_update(net, p.x0, U_fix, gen(), mc)
    finally:
        mppi._sample_costs = sample_costs
    U_cand = mppi._candidates(U_fix, gen(), mc, 1.0)
    x0m = p.x0.expand(S, 2).contiguous()
    e_m, r_m = rel_err(itt.open_loop_rollout_batched(net, x0m, U_cand)[1],
                       itt.rollout(net, x0m, U_cand)[1])
    # As phase 36's P8: a cost error moves the update and the ESS by at
    # most these bounds, beside the f32 rounding of the weighted sum.
    spread = float((U_cand - U_p[None]).abs().max())
    lim_u = 4 * e_m / mc.temperature * spread + 1e-5 * mp.U_LIM
    lim_e = 8 * e_m / mc.temperature + 1e-5
    d_u = float((U_k - U_p).abs().max())
    d_e = abs(float(ess_k) - float(ess_p)) / float(ess_p)
    gate("MPPI update", r_m <= RTOL_B5 and d_u <= lim_u and d_e <= lim_e,
         f"B5 sample costs {e_m:.2e} ({r_m:.1e} of max, limit {RTOL_B5}); "
         f"U_new {d_u:.2e} (limit {lim_u:.2e}); ESS {float(ess_k):.5f} "
         f"against {float(ess_p):.5f} ({d_e:.1e}, limit {lim_e:.1e})")
    # A batched solve of the fitted model from 64 seeded states: B4 and B5
    # (the example's MPC config), instance 0 against a single solve.
    Bb, Hb = LEARNED_B5[1]
    rng = np.random.default_rng(64)
    x0b = torch.tensor(np.stack([rng.uniform(-0.5, 0.5, Bb),
                                 rng.uniform(-0.5, 0.5, Bb)], 1), **f32)
    Ub = torch.zeros((Bb, Hb, 1), **f32)
    solb, secs_b, counts_b = timed_run(lambda: itt.solve_batch(
        net, x0b, Ub, p.config))
    need("learned batched solve", counts_b, (
        "batched_riccati", "linesearch_costs_batched",
        "closed_loop_rollout_batched", "open_loop_rollout_batched"))
    one = itt.solve(net, x0b[0], Ub[0], p.config)
    d_b = abs(float(solb.cost[0]) - float(one.cost)) / abs(float(one.cost))
    gate("learned batched solve", bool(torch.isfinite(solb.cost).all())
         and d_b <= 1e-3,
         f"B = {Bb}, H = {Hb}: {secs_b:.2f} s, launches {counts_b}; "
         f"instance 0 cost {float(solb.cost[0]):.6f} against a single "
         f"solve's {float(one.cost):.6f} ({d_b:.1e}, limit 1e-3)")
    lap(" (b)")

    # ---- (a) B2 on the neural form ----------------------------------------
    chunk = lib.ilqr_chain_chunk_steps_at(2, 1)
    ring = chunk * lib.ilqr_chain_ring_stages()
    Ns = (1, chunk - 1, chunk + 1, LEARNED_H, ring - 1, ring + 1, LEARNED_N)
    wide = learned_wide_system(itt, f32)
    systems = {"pendulum": (net, "pendulum"),
               LEARNED_WIDE[0]: (wide, LEARNED_WIDE[0])}
    print(f"phase 39 (a): B2a, B2b and the open loop on the neural form, "
          f"N {Ns}, {A10} alphas (33 at N = {LEARNED_H}), against the f64 "
          f"plain rollouts")
    b2 = {}
    for label, (system, base) in systems.items():
        s64 = system.replace(params=params_f64(system.params))
        for N in Ns:
            for A in ((A10, 33) if N == LEARNED_H else (A10,)):
                al = torch.tensor([0.5 ** i for i in range(A)], **f32)
                x0, U, u_ff, K = nominal_draws(system, base, N, 39 + N, f32)
                X = itt.rollout(system, x0, U)[0].contiguous()
                args = (x0, al, X, U, u_ff, K)
                ref = itt.linesearch_rollouts(s64, *(t.double()
                                                     for t in args))
                r32 = itt.linesearch_rollouts(system, *args)
                ref_o = itt.rollout(s64, x0.double(), U.double())
                r32_o = itt.rollout(system, x0, U)
                lab = f"B2 neural {label} N={N} A={A}"
                a = A // 2
                e = max(
                    held(f"{lab} costs", twice(
                        lambda: itt.linesearch_costs_fused(system, *args)),
                        (r32[2],), (ref[2],), RTOL_B2),
                    held(f"{lab} trajectory", twice(
                        lambda: itt.closed_loop_rollout_fused(
                            system, x0, float(al[a]), X, U, u_ff, K)),
                        tuple(t[a] for t in r32), tuple(t[a] for t in ref),
                        RTOL_B2),
                    held(f"{lab} open loop", twice(
                        lambda: itt.open_loop_rollout_fused(system, x0, U)),
                        r32_o, ref_o, RTOL_B2))
                b2[label, N] = max(b2.get((label, N), 0.0), e)
    # A zero output layer: the base form's bits.
    for label, base in (("pendulum", p.nominal),
                        (LEARNED_WIDE[0], wide_model_systems(
                            itt, f32, "rk4")[LEARNED_WIDE[0]])):
        zero = itt.make_neural_residual(base, hidden=(32, 32))
        x0, U, u_ff, K = nominal_draws(base, label, LEARNED_N, 7, f32)
        X = itt.rollout(base, x0, U)[0].contiguous()
        outs = [(itt.linesearch_costs_fused(s, x0, alphas, X, U, u_ff, K),
                 *itt.closed_loop_rollout_fused(s, x0, 0.5, X, U, u_ff, K),
                 *itt.open_loop_rollout_fused(s, x0, U),
                 itt.linesearch_costs_batched(s, x0[None], alphas, X[None],
                                              U[None], u_ff[None], K[None]))
                for s in (base, zero)]
        gate(f"zero residual {label}", all(
            torch.equal(a, b) for a, b in zip(*outs)),
             f"B2's three entries and B5's costs at N = {LEARNED_N} equal "
             f"the base form's bit for bit")
    lap(" (a)")

    # ---- (d) the collocation oracle against the card's solve --------------
    pend = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.zeros((2, 2)), d=0.0, integrator="euler",
                             **f32)
    x0c, U0c = torch.tensor([1.0, 0.0], **f32), torch.zeros((COLLOC_N, 1),
                                                            **f32)
    sol_i, secs_i, counts_i = timed_run(lambda: itt.solve(
        pend, x0c, U0c, itt.IlqrConfig(maxiter=200, tol=1e-9,
                                       backward="pallas", rollout="pallas")))
    need("collocation's iLQR solve", counts_i,
         ("fused_riccati", "linesearch_costs"))
    sol_c, secs_c, _ = timed_run(lambda: solve_collocation(
        pend, x0c, U0c, defect="step", tol=1e-6))
    dc = abs(float(sol_c.cost) - float(sol_i.cost))
    dX = float((sol_c.X - sol_i.X.double()).abs().max())
    dU = float((sol_c.U - sol_i.U.double()).abs().max())
    gate("collocation", float(sol_c.kkt_residual) < 1e-4
         and dc < 1e-4 * max(1.0, abs(float(sol_i.cost)))
         and dX < 1e-3 and dU < 1e-3 and sol_c.X.device == dev,
         f"N = {COLLOC_N}: {int(sol_c.iterations)} Newton steps in "
         f"{secs_c:.2f} s on {sol_c.X.device} (f64), kkt "
         f"{float(sol_c.kkt_residual):.2e} (< 1e-4); cost "
         f"{float(sol_c.cost):.6f} against the card's iLQR "
         f"{float(sol_i.cost):.6f} ({int(sol_i.iterations)} iterations, "
         f"{secs_i:.2f} s): {dc:.2e}; X {dX:.2e}, U {dU:.2e} (< 1e-3)")
    lap(" (d)")

    # ---- the kernels line: the neural form at the paths' shapes ------------
    src2 = {"linesearch_costs": "pallas_rollout.py:92",
            "closed_loop_rollout": "pallas_rollout.py:132",
            "open_loop_rollout": "pallas_rollout.py:132"}

    def row(name, replaces, launches, err, t, plain_ms, b, lpc_key):
        ms, cols = timing_columns(t, launches_per_call.get(lpc_key))
        rows.append(dict(
            name=name, route="cuda", source="ilqr_tpu_torch/csrc/"
            "neural_models.cu", replaces=f"ilqr_tpu/ops/{replaces}",
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], library_ms=None, **cols))

    # The wide residual is timed only, at the example's horizon and in one
    # turn: its steps are the form's slowest (PERF.md, section 6), and a
    # turn of `design_timing` makes 174 calls an entry.
    learned = mpc_counts["learned"]
    for label, (system, base), N, launches, turns in (
            ("pendulum", systems["pendulum"], LEARNED_H, learned, 3),
            (LEARNED_WIDE[0], systems[LEARNED_WIDE[0]], LEARNED_H, {}, 1)):
        x0, U, u_ff, K = nominal_draws(system, base, N, 39 + N, f32)
        X = itt.rollout(system, x0, U)[0].contiguous()
        kern = {
            "linesearch_costs": lambda: itt.linesearch_costs_fused(
                system, x0, alphas, X, U, u_ff, K),
            "closed_loop_rollout": lambda: itt.closed_loop_rollout_fused(
                system, x0, 1.0, X, U, u_ff, K),
            "open_loop_rollout": lambda: itt.open_loop_rollout_fused(
                system, x0, U)}
        plain = {
            "linesearch_costs": lambda: itt.linesearch_rollouts(
                system, x0, alphas, X, U, u_ff, K),
            "closed_loop_rollout": lambda: itt.closed_loop_rollout(
                system, x0, 1.0, X, U, u_ff, K),
            "open_loop_rollout": lambda: itt.rollout(system, x0, U)}
        t2 = design_timing(smi, f"B2 neural {label} N={N}", kern,
                           turns=turns)
        ws = fused_rollout.mlp_widths(system.params["mlp"])
        bnd = chain_bounds(system.n_x, system.n_u, N, A10,
                           model=neural_name(base, ws), integrator="rk4",
                           extra_floats=mlp_floats(ws))
        tag = f"neural_{base}_rk4_{'x'.join(map(str, ws[1:-1]))}_n{N}"
        for k in kern:
            row(f"{k}_{tag}", src2[k], launches.get(k, 0), b2[label, N],
                t2[k], cuda_ms(plain[k], 1, 0), bnd[k], None)
    for (B, N), (err, kern, plain) in b5.items():
        t5 = design_timing(smi, f"B5 neural ({B}, {N})", kern, turns=3)
        bnd = batched_bounds(B, N, A10, 2, 1, model=model, integrator="rk4",
                             extra_floats=extra)
        counts = counts_m if (B, N) == LEARNED_B5[0] else counts_b
        for k in kern:
            row(f"{k}_neural_pendulum_rk4_32x32_b{B}_n{N}",
                "pallas_batched.py:377", counts.get(k, 0), err[k], t5[k],
                cuda_ms(plain[k], 1, 0), bnd[k], k)
    lap(" kernels")
    print(f"phase 39: {time.perf_counter() - t0:.1f} s")
    return rows


def learned_turn() -> int:
    """``python3 chip_smoke.py --learned``: build the kernels and run phase
    39 alone (no launches-per-call column), printing its kernels line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    import ilqr_tpu_torch as itt
    from ilqr_tpu_torch.ops import _build

    smi = nvidia_smi()
    print(smi)
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s (nvcc "
          f"{lib.build_seconds:.1f} s)")
    neural = [line for line in ptxas_summary(lib.ptxas_log)
              if "NeuralForm" in line]
    print(f"{len(neural)} neural-form kernels:")
    print("\n".join(neural))
    spilled = [line for line in neural if " 0 bytes spill stores" not in line]
    if spilled:
        raise AssertionError("kernels spill registers:\n" + "\n".join(spilled))
    rows = learned_phases(itt, torch.device("cuda", 0), smi, {})
    print(json.dumps({"kernels": rows}))
    return 0


# ---- Phase groups beside the main process --------------------------------

# Phases 13-37 and 39 depend on nothing that phases 2-12 and 38 compute but
# phase 1's launches per call, and they spend most of their time on the host
# (eager host loops, plain versions in child processes), with the card
# mostly idle.  So after phase 1's build the main process starts one child
# process a group (``python3 chip_smoke.py --group NAME``; the processes
# share the card by CUDA's time slicing), runs phases 2-12 and 38
# meanwhile, and then prints each group's output and takes its kernels
# rows.  Each group resets and reads its own launch counts around its
# paths, as the phases did in one process.  The groups are balanced by
# their phases' seconds on an H100 run in one process (PERF.md, section 5).
# Kernel times taken beside other groups may hold other processes' time
# slices; `--turns`, `--batch-options`, `--batch-parallel`, `--solvers` and
# `--learned` time kernels alone.
PHASE_GROUPS = {
    "batched": "13-22, 39",  # batched, suffix, facade and learned phases
    "wide": "23-30, 37",     # driver, constrained, wide, batch_option
    "wrappers": "31-36",     # wide_batched, wrapper, solver phases
}
# torch's CPU threads in each of the four processes (the host has 8 cores;
# the plain versions' pools have their own single-threaded workers).
GROUP_THREADS = max(1, len(os.sched_getaffinity(0)) // (len(PHASE_GROUPS)
                                                         + 1))
# A group still running this long after the main run started is killed and
# fails the run (the script must end within 1200 s, the kernels' build
# included).
GROUP_DEADLINE_S = 1100.0


def run_group(name: str, itt, dev, smi, launches_per_call) -> list:
    """The phases of group ``name`` in order; their kernels-line rows."""
    lpc, rows = launches_per_call, []
    if name == "batched":
        rows += batched_phases(itt, dev, smi, lpc)
        rows += suffix_phases(itt, dev, smi, lpc)
        facade_phase(itt, dev)
        rows += learned_phases(itt, dev, smi, lpc)
    elif name == "wide":
        driver_phase(itt, dev)
        rows += constrained_phases(itt, dev, smi)
        rows += wide_phases(itt, dev, smi, lpc)
        rows += batch_option_phases(itt, dev, smi, lpc)
    elif name == "wrappers":
        rows += wide_batched_phases(itt, dev, smi, lpc)
        rows += wrapper_phases(itt, dev, smi, lpc)
        rows += solver_phases(itt, dev, smi, lpc)
    else:
        raise ValueError(f"no phase group {name!r}: {list(PHASE_GROUPS)}")
    return rows


def start_groups(launches_per_call: dict) -> dict:
    """One child process a phase group, each the leader of a session of
    its own (so that its plain versions' pool workers die with it), its
    output in temporary files.  They are killed when this process exits
    (atexit) or dies (`group_turn` sets PR_SET_PDEATHSIG)."""
    groups = {}
    for name in PHASE_GROUPS:
        out, err = (tempfile.TemporaryFile("w+") for _ in range(2))
        proc = subprocess.Popen(
            [sys.executable, "-u", str(Path(__file__).resolve()), "--group",
             name, str(os.getpid()), json.dumps(launches_per_call)],
            stdout=out, stderr=err, text=True, start_new_session=True)
        groups[name] = (proc, out, err)
    atexit.register(kill_groups, groups)
    return groups


def kill_groups(groups: dict) -> None:
    for proc, _, _ in groups.values():
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish_groups(groups: dict, deadline: float) -> list:
    """Wait for every group (until ``deadline`` on the perf counter), print
    its output and errors, and return their kernels rows in group order;
    raises when a group failed, timed out or printed no kernels line."""
    rows = []
    for name, (proc, out, err) in groups.items():
        try:
            code = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            kill_groups({name: (proc, out, err)})
            code = "killed at the deadline"
        out.seek(0)
        err.seek(0)
        lines = out.read().splitlines()
        tagged = [line for line in lines if line.startswith('{"kernels": ')]
        print(f"---- phases {PHASE_GROUPS[name]} (group {name!r}, child "
              f"process, exit {code}):")
        for line in lines:
            if not line.startswith('{"kernels": '):
                print(line)
        sys.stderr.write(err.read())
        if code != 0 or len(tagged) != 1:
            raise AssertionError(f"phase group {name!r} (phases "
                                 f"{PHASE_GROUPS[name]}) failed: exit "
                                 f"{code}, {len(tagged)} kernels lines")
        rows += json.loads(tagged[0])["kernels"]
    return rows


def group_turn(name: str, parent: int, lpc_json: str) -> int:
    """``python3 chip_smoke.py --group NAME PARENT LPC``: the phases of one
    group, as the main run starts it (PARENT its pid, LPC phase 1's
    launches per call as JSON; the kernels must be built).  Prints the
    group's kernels line last."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    # Die with the main run, and take this session's pool workers along.
    signal.signal(signal.SIGTERM,
                  lambda *_: os.killpg(0, signal.SIGKILL))
    ctypes.CDLL(None).prctl(1, signal.SIGTERM)   # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        return 1
    torch.set_num_threads(GROUP_THREADS)
    import ilqr_tpu_torch as itt

    rows = run_group(name, itt, torch.device("cuda", 0), nvidia_smi(),
                     json.loads(lpc_json))
    print(json.dumps({"kernels": rows}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1

    import ilqr_tpu_torch as itt
    from ilqr_tpu_torch.ops import _build, fused_riccati
    from ilqr_tpu_torch.ops.parallel_rollout import (
        linesearch_defect_rollouts,
        open_loop_defect_rollout,
        trajectory_cost,
    )

    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    t_run = t_lap = time.perf_counter()

    def lap(done: str) -> None:
        nonlocal t_lap
        now = time.perf_counter()
        print(f"phase {done}: {now - t_lap:.1f} s")
        t_lap = now

    # ---- 1. device, versions, build ------------------------------------
    smi = nvidia_smi()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernels = _build.load()
    print(f"kernel library {kernels.path.name} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds:.2f} s)")
    for line in ptxas_summary(kernels.ptxas_log):
        print(line)
    spilled = [line for line in ptxas_summary(kernels.ptxas_log)
               if " 0 bytes spill stores" not in line]
    if spilled:
        raise AssertionError("kernels spill registers:\n"
                             + "\n".join(spilled))
    wide_kernels = ("wide_scan_kernel", "wide_riccati_kernel",
                    "wide_fused_kernel", "wide_prefix_kernel")
    wide = [line for line in ptxas_summary(kernels.ptxas_log)
            if any(k in line for k in wide_kernels)]
    if len(wide) != 9:
        raise AssertionError(f"expected B6w's, B1w's and B3w's kernels at "
                             f"P = 8 and 16 and B4w's at (P, U) = (8, 8), "
                             f"(16, 8), (16, 16) in the build, found {wide}")
    print("the entry-parallel kernels (csrc/group_linalg.cuh): B6w/B7w "
          "wide_scan_kernel<P>, B4w wide_riccati_kernel<P, U>, B1w "
          "wide_fused_kernel<P>, B3w wide_prefix_kernel<P>:")
    for line in wide:
        print(line)
    launches_per_call = one_launch_check(itt, f32)
    tile = fused_riccati.tile_steps(kernels.lib, 4, 2)   # the DP's shape
    if kernels.lib.ilqr_riccati_wide_max_n() != fused_riccati.WIDE_MAX_N:
        raise AssertionError(
            f"B1w takes N < {kernels.lib.ilqr_riccati_wide_max_n()}, "
            f"fused_riccati.WIDE_MAX_N says {fused_riccati.WIDE_MAX_N}")

    # The reference workloads' systems, from the port's drivers (phase 4
    # solves their problems, phases 22-25 run the drivers).
    from examples_torch import (
        double_pendulum_open_loop,
        pendulum_open_loop,
        ua_double_pendulum_open_loop,
    )
    pend = pendulum_open_loop.problem(dev).system
    dp_problem = double_pendulum_open_loop.problem(dev)
    dp = dp_problem.system
    ua = ua_double_pendulum_open_loop.problem(dev).system
    x0_dp = torch.zeros(4, **f32)
    x0_pend = torch.tensor([1.0, 0.0], **f32)

    def expansion(system, x0, N):
        U = torch.zeros((N, system.n_u), **f32)
        X, _ = itt.rollout(system, x0, U)
        return X, U, itt.linearize_trajectory(system, X, U)

    errors: dict[str, float] = {"fused_riccati": 0.0, "linesearch_costs": 0.0,
                                "closed_loop_rollout": 0.0,
                                "open_loop_rollout": 0.0,
                                "fused_riccati_defects": 0.0,
                                "affine_prefix_scan": 0.0}

    def check_b1(label, exp, reg=0.0, defects=None, key="fused_riccati"):
        torch.cuda.synchronize()
        u_k, K_k, dV_k, ok_k = itt.backward_pass_fused(exp, reg, defects)
        again = itt.backward_pass_fused(exp, reg, defects)
        if not all(torch.equal(a, b) for a, b in
                   zip((u_k, K_k, dV_k, ok_k), again)):
            raise AssertionError(f"B1 {label} N={exp.f_x.shape[0]}: a "
                                 f"repeated call gave other bits")
        u_p, K_p, dV_p, ok_p = itt.backward_pass_associative(exp, reg,
                                                             defects)
        exp64 = dataclasses.replace(exp, **{
            f.name: getattr(exp, f.name).double()
            for f in dataclasses.fields(exp)})
        ref64 = itt.backward_pass_associative(
            exp64, reg, None if defects is None else defects.double())
        torch.cuda.synchronize()
        notes = []
        for name, got, ref, r64 in (("u_ff", u_k, u_p, ref64[0]),
                                    ("K", K_k, K_p, ref64[1]),
                                    ("dV", dV_k, dV_p, ref64[2])):
            err, rel = rel_err(got, ref)
            floor = rel_err(ref, r64)[0]
            limit = max(RTOL_B1 * float(ref.abs().max()), F32_FLOOR * floor)
            errors[key] = max(errors[key], err)
            notes.append(f"{name} {err:.2e} (rel {rel:.1e}, limit {limit:.2e};"
                         f" kernel vs f64 {rel_err(got, r64)[0]:.2e},"
                         f" plain vs f64 {floor:.2e})")
            if not err <= limit:
                raise AssertionError(f"B1 {label}: {notes[-1]}")
        if not (bool(ok_k) and bool(ok_p)):
            raise AssertionError(f"B1 {label}: non-finite gains")
        print(f"B1 {label}: N={exp.f_x.shape[0]} max abs error "
              + "; ".join(notes) + "; repeated call bit-identical")

    lap("1")
    # Phases 13-37 and 39 run beside phases 2-12 and 38, one child process a
    # group.
    groups = start_groups(launches_per_call)
    torch.set_num_threads(GROUP_THREADS)
    print(f"phases {', '.join(PHASE_GROUPS.values())}: started in "
          f"{len(groups)} child processes beside this one, "
          f"{GROUP_THREADS} CPU threads each")
    # ---- 2. B1 against its plain version --------------------------------
    mid_n = 5 * tile + tile // 2 + 3   # crosses 5 tile edges, ends mid-tile
    # N + 1 = T - 1, T, T + 1 steps and elements; N = 1; T + 2 tiles, more
    # than one look-back poll round covers (all resident at once on the
    # card, so a tile usually finds an inclusive value in its first round:
    # this does not show that the later rounds ran).
    edge_ns = (1, tile - 2, tile - 1, tile, tile * (tile + 1))
    print(f"B1 tolerance: max|kernel - plain| <= {RTOL_B1} * max|plain| "
          f"(f32 scans in two association orders); tile {tile} steps; "
          f"tile-edge horizons {edge_ns}")
    X_dp0, U_dp0, exp_dp0 = expansion(dp, x0_dp, 500)
    for N in (500, mid_n, LONG_N) + edge_ns:
        check_b1("DP first trajectory", tile_expansion(exp_dp0, N))
    check_b1("DP first trajectory, reg 0.1", exp_dp0, reg=0.1)
    _, _, exp_pend = expansion(pend, x0_pend, 400)
    for N in (400, mid_n, tile - 1, tile):
        check_b1("pendulum", tile_expansion(exp_pend, N))
    _, _, exp_ua = expansion(ua, x0_dp, 800)
    for N in (800, mid_n):
        check_b1("UA-DP", tile_expansion(exp_ua, N))

    lap("2")
    # ---- 3. B2 against its plain version (first iteration) --------------
    cfg = itt.IlqrConfig(maxiter=200, tol=1e-6, backward="pallas",
                         rollout="pallas")
    alphas = torch.tensor(cfg.alpha_schedule(), **f32)
    print(f"B2 tolerance: max|kernel - plain| <= {RTOL_B2} * max|plain| "
          f"(same f32 recursion, other operation order)")

    def check_b2(label, X, U, u_ff, K, alpha):
        c_k = itt.linesearch_costs_fused(dp, x0_dp, alphas, X, U, u_ff, K)
        X_p, U_p, c_p = itt.linesearch_rollouts(dp, x0_dp, alphas, X, U,
                                                u_ff, K)
        Xk, Uk, ck = itt.closed_loop_rollout_fused(dp, x0_dp, alpha, X, U,
                                                   u_ff, K)
        Xr, Ur, cr = itt.closed_loop_rollout(dp, x0_dp, alpha, X, U, u_ff, K)
        torch.cuda.synchronize()
        checks = (("linesearch_costs", "costs", c_k, c_p),
                  ("closed_loop_rollout", "X", Xk, Xr),
                  ("closed_loop_rollout", "U", Uk, Ur),
                  ("closed_loop_rollout", "cost", ck, cr))
        worst = 0.0
        for kernel, name, got, ref in checks:
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"B2 {label}: non-finite {name}")
            err, rel = rel_err(got, ref)
            errors[kernel] = max(errors[kernel], err)
            worst = max(worst, rel)
            if not rel <= RTOL_B2:
                raise AssertionError(
                    f"B2 {label}: {name} max error {err:.3e} is {rel:.3e} "
                    f"of max |plain| (limit {RTOL_B2})")
        print(f"B2 {label}: N={U.shape[0]}, {alphas.numel()} alphas, "
              f"trajectory alpha {alpha}: max rel error {worst:.3e}")

    u0, K0, _, _ = itt.backward_pass_fused(exp_dp0, 0.0)
    check_b2("DP first iteration", X_dp0, U_dp0, u0, K0, alpha=0.5)
    t0 = time.perf_counter()
    chain_checks(itt, dev, errors, long_n=CHAIN_LONG_N)
    print(f"phase 3 chain checks: {time.perf_counter() - t0:.1f} s")

    lap("3")
    # ---- 4. the slice: the DP swing-up through both kernels -------------
    # examples_torch/double_pendulum_open_loop.py's problem (phase 22 runs
    # the driver itself); its config is phase 3's.
    if dp_problem.config != cfg or tuple(dp_problem.U0.shape) != (500, 2):
        raise AssertionError("the DP driver's problem is not the flagship")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sol = itt.solve(dp, x0_dp, torch.zeros((500, 2), **f32), cfg)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    print(f"DP solve (pallas/pallas): status {sol.status}, "
          f"{sol.iterations} iterations, cost {float(sol.cost):.6f}, "
          f"{solve_s:.3f} s, launches {launches}")
    dp_gates(itt, sol, "DP solve", launches,
             ("fused_riccati", "linesearch_costs", "closed_loop_rollout"))
    if launches.get("open_loop_rollout", 0) != 1:
        raise AssertionError(f"DP solve launched open_loop_rollout "
                             f"{launches.get('open_loop_rollout', 0)} times, "
                             f"expected once (the initial rollout)")

    # B1 and B2 again, along the solved trajectory.
    X_s, U_s = sol.X.contiguous(), sol.U.contiguous()
    exp_dps = itt.linearize_trajectory(dp, X_s, U_s)
    for N in (500, mid_n, LONG_N):
        check_b1("DP solved trajectory", tile_expansion(exp_dps, N))
    u_s, K_s, _, _ = itt.backward_pass_fused(exp_dps, 0.0)
    check_b2("DP solved trajectory", X_s, U_s, u_s, K_s, alpha=1.0)

    # The pendulum golden (backward Euler) through B1, B2a, B2b and the
    # open-loop entry.  Phase 22 solves it with host loops (the compat
    # facade's 'auto' engines), which gives the plain rollouts' time.
    b2_kernels = ("linesearch_costs", "closed_loop_rollout",
                  "open_loop_rollout")
    pend_runs = {}
    for rollout_engine in ("pallas",):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        sol_p = itt.solve(pend, x0_pend, torch.zeros((400, 1), **f32),
                          itt.IlqrConfig(maxiter=100, tol=1e-5,
                                         backward="pallas",
                                         rollout=rollout_engine))
        torch.cuda.synchronize()
        pend_s = time.perf_counter() - t0
        counts = _build.launch_counts()
        err = abs(float(sol_p.cost) - PENDULUM_GOLDEN_COST)
        print(f"pendulum golden (pallas/{rollout_engine}): status "
              f"{sol_p.status}, {sol_p.iterations} iterations, cost "
              f"{float(sol_p.cost):.6f}, |cost - {PENDULUM_GOLDEN_COST}| "
              f"{err:.2e}, {pend_s:.3f} s, launches {counts}")
        if not (sol_p.status == itt.CONVERGED and err <= 1e-3):
            raise AssertionError(f"pendulum golden ({rollout_engine}): not "
                                 f"CONVERGED within 1e-3 of the golden cost")
        needed = ("fused_riccati",) + (b2_kernels if rollout_engine == "pallas"
                                       else ())
        for kernel in needed:
            if counts.get(kernel, 0) < 1:
                raise AssertionError(f"the pendulum golden ({rollout_engine})"
                                     f" never launched {kernel}")
        if rollout_engine == "pallas" and counts["open_loop_rollout"] != 1:
            raise AssertionError("the pendulum golden launched "
                                 "open_loop_rollout more than once")
        pend_runs[rollout_engine] = (sol_p, pend_s, counts)

    # The under-actuated golden (tests/test_solver.py:42-55, 96-101) through
    # the kernels, f32, on examples_torch/ua_double_pendulum_open_loop.py's
    # problem, warm-started from the reference's controls (the golden's U)
    # under the golden's gates: cut from the 272-iteration cold start for
    # the time limit (PERF.md §4).  tests/test_torch_solve.py holds the
    # cold start's iterations to JAX's (cut in N and maxiter, f64), phases
    # 2-3 hold its kernels to their plain versions, and phase 23 runs the
    # driver's main.
    gold = np.load(UA_GOLDEN)
    ua_cost_ref = float(gold["cost"])
    ua_angles_ref = torch.tensor(gold["X"][:2, -1], **f32)  # (dim, time)
    p_ua = ua_double_pendulum_open_loop.problem(dev)
    U_ua = torch.tensor(gold["U"].T, **f32).contiguous()   # (time, dim)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sol_ua = itt.solve(p_ua.system, p_ua.x0, U_ua, p_ua.config)
    torch.cuda.synchronize()
    ua_s = time.perf_counter() - t0
    ua_counts = _build.launch_counts()
    ua_ang = float((sol_ua.X[-1, :2] - ua_angles_ref).abs().max())
    print(f"UA-DP golden (pallas/pallas, from the reference's controls): "
          f"status {sol_ua.status}, "
          f"{sol_ua.iterations} iterations, cost {float(sol_ua.cost):.6f} "
          f"(reference {ua_cost_ref:.6f}, limit 1.05x), final angles "
          f"{sol_ua.X[-1, :2].tolist()} ({ua_ang:.2e} from the reference's, "
          f"limit 0.2), {ua_s:.3f} s, launches {ua_counts}")
    if not (float(sol_ua.cost) <= 1.05 * ua_cost_ref and ua_ang <= 0.2
            and bool(torch.isfinite(sol_ua.X).all())):
        raise AssertionError("UA-DP golden: cost above 1.05x the reference's "
                             "or final angles not within 0.2 of its")
    for kernel in ("fused_riccati",) + b2_kernels:
        if ua_counts.get(kernel, 0) < 1:
            raise AssertionError(f"the UA-DP golden never launched {kernel}")

    # A U_init that is a row view 8 bytes into its storage solves through
    # the kernels, as a contiguous copy of it does (the kernels place each
    # run at its own 16-byte phase).
    U_prev = torch.zeros((501, 2), **f32)
    U_view = U_prev[1:]
    if U_view.data_ptr() % 16 == 0:
        raise AssertionError("the C1 view is aligned: the check shows nothing")
    cfg_c1 = itt.IlqrConfig(maxiter=5, tol=1e-6, backward="pallas",
                            rollout="pallas")
    _build.reset_launch_counts()
    sol_v = itt.solve(dp, x0_dp, U_view, cfg_c1)
    counts_v = _build.launch_counts()
    sol_c = itt.solve(dp, x0_dp, U_view.clone(), cfg_c1)
    torch.cuda.synchronize()
    same = (torch.equal(sol_v.X, sol_c.X) and torch.equal(sol_v.U, sol_c.U)
            and float(sol_v.cost) == float(sol_c.cost))
    print(f"C1: solve from U_prev[1:] (offset {U_view.data_ptr() % 16} bytes "
          f"mod 16): status {sol_v.status}, {sol_v.iterations} iterations, "
          f"cost {float(sol_v.cost):.6f}, launches {counts_v}; equal to the "
          f"solve from a copy: {same}")
    if not same or counts_v.get("open_loop_rollout", 0) != 1:
        raise AssertionError("C1: the view's solve differs from the copy's "
                             "or did not run through the kernels")

    # The pendulum MPC example (examples/pendulum_mpc.py: backward-Euler
    # solver, midpoint plant, H = 200, maxiter 10), cut to MPC_STEPS steps.
    # Its first step is no longer held to rollout='scan' on the card (12.5 s
    # of host loops, cut for the time limit, PERF.md §4): phase 3 holds the
    # backward-Euler B2 kernels to their plain versions, and
    # tests/test_torch_examples_smoke.py holds the example's loop to JAX's.
    def mpc_pendulum(integrator):
        return itt.make_pendulum(
            0.01, [np.pi, 0.0], Q=np.diag([10.0, 1.0]), R=np.eye(1),
            Q_f=np.diag([10.0, 10.0]), d=0.0, integrator=integrator, **f32)

    mpc_solver, mpc_plant = (mpc_pendulum("backward_euler"),
                             mpc_pendulum("midpoint"))
    mpc_runs = {}
    for rollout_engine, n_sim in (("pallas", MPC_STEPS),):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = itt.run_mpc(mpc_solver, mpc_plant, torch.zeros(2, **f32),
                          torch.zeros((200, 1), **f32), n_sim,
                          itt.IlqrConfig(maxiter=10, tol=1e-5,
                                         backward="pallas",
                                         rollout=rollout_engine))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        print(f"pendulum MPC H=200 (cut to {n_sim} of the example's 400 "
              f"steps; pallas/{rollout_engine}): {wall:.3f} s, "
              f"{wall * 1e3 / n_sim:.1f} ms per step, cost "
              f"{float(res.cost):.4f}, final x {res.X[-1].tolist()}, "
              f"launches {counts}")
        if not bool(torch.isfinite(res.X).all()):
            raise AssertionError("pendulum MPC: closed loop not finite")
        mpc_runs[rollout_engine] = (res, counts)
    for kernel in ("fused_riccati",) + b2_kernels:
        if mpc_runs["pallas"][1].get(kernel, 0) < 1:
            raise AssertionError(f"pendulum MPC never launched {kernel}")

    lap("4")
    # ---- 5. timing --------------------------------------------------------
    reg0 = 0.0
    exp_long = tile_expansion(exp_dps, LONG_N)
    exp_1411 = tile_expansion(exp_dps, 1411)
    exp_pb = tile_expansion(exp_pend, BENCH_N)
    d_pb = torch.tensor(
        0.01 * np.random.default_rng(5).standard_normal((BENCH_N, 2)), **f32)
    b1_t = design_timing(smi, "B1", {
        label: (lambda e=e, d=d: itt.backward_pass_fused(e, 0.0, d))
        for label, (e, d) in {
            "DP N=500": (exp_dps, None), "DP N=1411": (exp_1411, None),
            f"DP N={LONG_N}": (exp_long, None),
            f"pendulum N={BENCH_N}, defects": (exp_pb, d_pb)}.items()})
    t_b1p = cuda_ms(lambda: itt.backward_pass_associative(exp_dps, reg0), 10, 2)
    t_b1lp = cuda_ms(lambda: itt.backward_pass_associative(exp_long, reg0), 3, 1)
    # The host-loop plain versions timed by one call each (two after a
    # warm-up until phase 38 came).
    t_b1s = cuda_ms(lambda: itt.backward_pass(exp_dps, reg0), 1, 0)
    t_c = cuda_ms(lambda: itt.linesearch_costs_fused(
        dp, x0_dp, alphas, X_s, U_s, u_s, K_s), 50, 5)
    t_cp = cuda_ms(lambda: itt.linesearch_rollouts(
        dp, x0_dp, alphas, X_s, U_s, u_s, K_s), 1, 0)
    t_t = cuda_ms(lambda: itt.closed_loop_rollout_fused(
        dp, x0_dp, 1.0, X_s, U_s, u_s, K_s), 50, 5)
    t_tp = cuda_ms(lambda: itt.closed_loop_rollout(
        dp, x0_dp, 1.0, X_s, U_s, u_s, K_s), 1, 0)
    t_lin = cuda_ms(lambda: itt.linearize_trajectory(dp, X_s, U_s), 10, 2)
    t_init = cuda_ms(lambda: itt.rollout(dp, x0_dp, U_dp0), 1, 0)
    t_init_k = cuda_ms(lambda: itt.open_loop_rollout_fused(dp, x0_dp, U_dp0),
                       50, 5)
    print(f"timing on {smi} (CUDA events, ms per call):")
    print(f"  B1 fused_riccati N=500: kernel (device) "
          f"{ms_text(b1_t['DP N=500']['device_us'])}, plain "
          f"(associative) {t_b1p:.4f}, sequential scan {t_b1s:.2f}")
    print(f"  B1 fused_riccati N={LONG_N}: kernel (device) "
          f"{ms_text(b1_t[f'DP N={LONG_N}']['device_us'])}, plain "
          f"(associative) {t_b1lp:.4f}")
    print(f"  B2 linesearch_costs N=500, {alphas.numel()} alphas: kernel "
          f"{t_c:.4f}, plain {t_cp:.2f}")
    print(f"  B2 closed_loop_rollout N=500: kernel {t_t:.4f}, plain {t_tp:.2f}")
    print(f"  linearize_trajectory N=500: {t_lin:.3f}; initial rollout "
          f"N=500: kernel (open_loop_rollout) {t_init_k:.4f}, plain (host "
          f"loop) {t_init:.2f}")

    def timed_solve(backward, rollout, maxiter):
        c = itt.IlqrConfig(maxiter=maxiter, tol=1e-6, backward=backward,
                           rollout=rollout)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = itt.solve(dp, x0_dp, torch.zeros((500, 2), **f32), c)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
        init = t_init_k if rollout == "pallas" else t_init
        return total, s.iterations, (total - init) / max(s.iterations, 1)

    # The plain engines' solve in one turn (two until phase 38 came).
    runs = [("pallas", "pallas", 200), ("scan", "scan", 3),
            ("pallas", "pallas", 200)]
    b1_dev_us = b1_t["DP N=500"]["device_us"]
    for backward, rollout_engine, maxiter in runs:
        total, iters, per_iter = timed_solve(backward, rollout_engine,
                                             maxiter)
        share = ""
        if backward == "pallas" and b1_dev_us is not None:
            b1_ms = iters * b1_dev_us * 1e-3
            share = (f"; B1 {iters} launches x {b1_dev_us * 1e-3:.4f} ms "
                     f"device = {b1_ms:.3f} ms "
                     f"({100 * b1_ms / total:.2f} % of the solve)")
        print(f"  DP solve backward={backward} rollout={rollout_engine}: "
              f"{total:.1f} ms total, {iters} iterations, {per_iter:.2f} ms "
              f"per iteration after the initial rollout{share}")
    chain_timing(itt, dev, smi)
    imp_t = implicit_timing(itt, dev, smi, {
        "pendulum": (pend, x0_pend, pend_runs["pallas"][0]),
        "UA-DP": (ua, x0_dp, sol_ua)})
    sol_pk = pend_runs["pallas"][0]
    X_pk, U_pk = sol_pk.X.contiguous(), sol_pk.U.contiguous()
    u_pk, K_pk = sol_pk.u_ff.contiguous(), sol_pk.K.contiguous()
    imp_plain = {
        "linesearch_costs": cuda_ms(lambda: itt.linesearch_rollouts(
            pend, x0_pend, alphas, X_pk, U_pk, u_pk, K_pk), 1, 0),
        "closed_loop_rollout": cuda_ms(lambda: itt.closed_loop_rollout(
            pend, x0_pend, 1.0, X_pk, U_pk, u_pk, K_pk), 1, 0),
        "open_loop_rollout": cuda_ms(lambda: itt.rollout(pend, x0_pend, U_pk),
                                     1, 0),
    }
    print(f"  pendulum backward_euler N=400 plain (host loops): "
          + ", ".join(f"{k} {v:.1f}" for k, v in imp_plain.items()))

    def launched(label, kernels):
        counts = _build.launch_counts()
        for kernel in kernels:
            if counts.get(kernel, 0) < 1:
                raise AssertionError(f"{label} never launched {kernel}")
        return counts

    lap("5")
    # ---- 6. B3 against its plain version ----------------------------------
    b3_checks(itt, kernels.lib, f32, errors)
    A_cl_s = (exp_dps.f_x + exp_dps.f_u @ K_s).contiguous()
    _, q_s, d0_s = random_chain(500, 4, 10, 7, f32)
    check_b3(itt, "DP closed loop f_x + f_u K, solved trajectory", A_cl_s,
             q_s, d0_s, errors)

    lap("6")
    # ---- 7. B1d against its plain version ---------------------------------
    rng = np.random.default_rng(17)

    def gaps(N, n_x):
        return torch.tensor(0.01 * rng.standard_normal((N, n_x)), **f32)

    for N in (500, mid_n, LONG_N) + edge_ns:
        check_b1("DP first trajectory, defects", tile_expansion(exp_dp0, N),
                 defects=gaps(N, 4), key="fused_riccati_defects")
    for N in (400, mid_n, LONG_N):
        check_b1("pendulum, defects", tile_expansion(exp_pend, N),
                 defects=gaps(N, 2), key="fused_riccati_defects")

    lap("7")
    # ---- 8. the DP swing-up through the parallel-in-time path -------------
    par_launches, par_sols = {}, {}
    for rollout_engine in ("defect", "chunked"):
        cfg_par = itt.IlqrConfig(maxiter=200, tol=1e-6, backward="pallas",
                                 rollout=rollout_engine, init_rollout="defect",
                                 defect_engine="pallas")
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        sol_par = itt.solve(dp, x0_dp, torch.zeros((500, 2), **f32), cfg_par)
        torch.cuda.synchronize()
        par_s = time.perf_counter() - t0
        counts = _build.launch_counts()
        par_launches[rollout_engine] = counts
        par_sols[rollout_engine] = sol_par
        print(f"DP solve (pallas/{rollout_engine}, defect init): status "
              f"{sol_par.status}, {sol_par.iterations} iterations, cost "
              f"{float(sol_par.cost):.6f}, latch {sol_par.defect_latch}, "
              f"{par_s:.3f} s, launches {counts}, alphas "
              f"{sol_par.alpha_trace[:sol_par.iterations].tolist()}")
        # The chunked search scans its C chunk boundaries with the plain
        # version (as in JAX), so only the defect search must launch B3.
        dp_gates(itt, sol_par, f"DP solve ({rollout_engine})", counts,
                 ("fused_riccati", "affine_prefix_scan")
                 if rollout_engine == "defect" else ("fused_riccati",))

    lap("8")
    # ---- 9. multiple shooting: the pendulum golden ------------------------
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sol_g = itt.solve_ms(pend, x0_pend, torch.zeros((400, 1), **f32),
                         config=itt.IlqrConfig(maxiter=100, tol=1e-5,
                                               backward="pallas"),
                         ms=itt.MsConfig(update_engine="pallas"))
    torch.cuda.synchronize()
    ms_golden_s = time.perf_counter() - t0
    counts = launched("MS pendulum golden",
                      ("fused_riccati", "affine_prefix_scan"))
    print(f"MS pendulum golden (pallas/pallas): status {sol_g.status}, "
          f"{sol_g.iterations} iterations, cost {float(sol_g.cost):.6f}, "
          f"defect {float(sol_g.defect):.2e}, {ms_golden_s:.3f} s, "
          f"launches {counts}")
    if not (sol_g.status == itt.CONVERGED
            and abs(float(sol_g.cost) - PENDULUM_GOLDEN_COST) < 1e-3
            and float(sol_g.defect) < 1e-5):
        raise AssertionError("MS pendulum golden: not CONVERGED within 1e-3 "
                             "of the golden cost with defect < 1e-5")

    lap("9")
    # ---- 10. defect sweeps at the bench's size (DP, N = 100000) -----------
    # bench.py's cell: the nominal is the rest state under zero controls
    # (built by the defect rollout, which certifies it without a sweep),
    # the gains come from B1, and all 10 alphas are swept 8 times.
    U_b = torch.zeros((BENCH_N, 2), **f32)
    X_b, _, d_b = open_loop_defect_rollout(dp, x0_dp, U_b, iters=8,
                                           engine="pallas")
    exp_b = itt.linearize_trajectory(dp, X_b, U_b)
    u_b, K_b, _, _ = itt.backward_pass_fused(exp_b, 0.0)
    cert_b = 1e-3 * (1.0 + float(X_b.abs().max()))
    ls = {}
    for engine in ("pallas", "xla"):
        _build.reset_launch_counts()
        ls[engine] = linesearch_defect_rollouts(dp, x0_dp, alphas, X_b, U_b,
                                                u_b, K_b, exp_b, iters=8,
                                                engine=engine)
        torch.cuda.synchronize()
        if engine == "pallas":
            ls_counts = launched("bench-size line search",
                                 ("affine_prefix_scan",))
    n_alpha_b = alphas.numel()
    costs_k, defects_k = (t.cpu().numpy() for t in ls["pallas"][2:])
    costs_p, defects_p = (t.cpu().numpy() for t in ls["xla"][2:])
    cert_k, cert_p = defects_k < cert_b, defects_p < cert_b
    print(f"DP line search N={BENCH_N}, 10 alphas, 8 sweeps: costs kernel "
          f"{np.array2string(costs_k, precision=6)}, plain "
          f"{np.array2string(costs_p, precision=6)}; defects kernel "
          f"{np.array2string(defects_k, precision=2)}, plain "
          f"{np.array2string(defects_p, precision=2)} (certified below "
          f"{cert_b:.1e})")
    if not (cert_k == cert_p).all() or not cert_k.any():
        raise AssertionError("bench-size line search: the kernel and plain "
                             "scans certify different candidates, or none")
    ls_rel = float(np.max(np.abs(costs_k - costs_p)[cert_k]
                          / np.abs(costs_p)[cert_k]))
    if not ls_rel <= RTOL_LS:
        raise AssertionError(f"bench-size line search: certified costs differ "
                             f"by {ls_rel:.2e} (limit {RTOL_LS})")
    # The open-loop rollout of the smallest alpha's controls (the DP stays
    # near rest) from the constant guess at x0, over the first half of the
    # horizon and over all of it.  Over the first half it must certify, find
    # that candidate's trajectory and agree between kernel and plain scan.
    # Over all 100000 Euler steps the f32 sweeps diverge with either scan
    # (the same sweeps in f64 certify in 4): there both must report it.
    i_ol = n_alpha_b - 1
    X_cand = ls["pallas"][0][i_ol]
    ol = {}
    for n_ol in (BENCH_N // 2, BENCH_N):
        U_ol = ls["pallas"][1][i_ol, :n_ol].contiguous()
        for engine in ("pallas", "xla"):
            _build.reset_launch_counts()
            ol[engine] = open_loop_defect_rollout(dp, x0_dp, U_ol, iters=8,
                                                  engine=engine)
            torch.cuda.synchronize()
            if engine == "pallas":
                launched("bench-size open-loop rollout",
                         ("affine_prefix_scan",))
        c_k, c_p = float(ol["pallas"][1]), float(ol["xla"][1])
        d_k, d_p = float(ol["pallas"][2]), float(ol["xla"][2])
        ol_dx = float((ol["pallas"][0] - X_cand[:n_ol + 1]).abs().max())
        print(f"DP open-loop defect rollout N={n_ol}, alpha "
              f"{float(alphas[i_ol])} controls, constant guess: cost kernel "
              f"{c_k:.6f}, plain {c_p:.6f}; defect kernel {d_k:.2e}, plain "
              f"{d_p:.2e}; max |X - candidate X| {ol_dx:.2e}")
        if (d_k < cert_b) != (d_p < cert_b):
            raise AssertionError("bench-size open-loop rollout: the kernel and "
                                 "plain scans certify differently")
        if n_ol < BENCH_N and not (d_k < cert_b and abs(c_k - c_p)
                                   <= RTOL_LS * abs(c_p)):
            raise AssertionError("bench-size open-loop rollout: not certified, "
                                 "or the kernel and plain costs disagree")

    lap("10")
    # ---- 11. multiple shooting at the bench's size (pendulum, rk4) --------
    p_rk4 = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                              Q_f=np.zeros((2, 2)), d=0.0, integrator="rk4",
                              **f32)
    engines = {"kernels": (dict(backward="pallas", defect_engine="pallas"),
                           "pallas"),
               "plain": (dict(backward="pscan", defect_engine="xla"), "xla")}

    def ms_bench(name, X_init=None):
        kw, update_engine = engines[name]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t = time.perf_counter()
        out = itt.solve_ms(p_rk4, x0_pend, torch.zeros((BENCH_N, 1), **f32),
                           X_init=X_init,
                           config=itt.IlqrConfig(maxiter=60, tol=1e-5,
                                                 init_rollout="defect", **kw),
                           ms=itt.MsConfig(update_engine=update_engine))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        counts = _build.launch_counts()
        print(f"MS solve N={BENCH_N} ({name}, "
              f"{'defect init' if X_init is None else 'X_init = x0'}): status "
              f"{out.status}, {out.iterations} iterations, cost "
              f"{float(out.cost):.6f}, defect {float(out.defect):.2e}, "
              f"{ms:.1f} ms, {ms / max(out.iterations, 1):.2f} ms per "
              f"iteration, launches {counts}")
        return out, ms, counts

    def ms_agree(label, a, b, converged):
        if a.status != b.status:
            raise AssertionError(f"{label}: statuses differ ({a.status}, "
                                 f"{b.status})")
        ca, cb = float(a.cost), float(b.cost)
        if np.isfinite(cb) and not abs(ca - cb) <= RTOL_MS * abs(cb):
            raise AssertionError(f"{label}: costs {ca} and {cb} differ by "
                                 f"more than {RTOL_MS}")
        if converged and not (a.status == itt.CONVERGED
                              and max(float(a.defect), float(b.defect))
                              <= itt.MsConfig().dtol):
            raise AssertionError(f"{label}: not CONVERGED with defect <= dtol")

    ms_k, ms_k_ms, ms_launches = ms_bench("kernels")
    if ms_launches.get("fused_riccati", 0) < 1:
        raise AssertionError("the MS bench solve never launched fused_riccati")
    ms_p, ms_p_ms, _ = ms_bench("plain")
    ms_agree("MS bench solve", ms_k, ms_p, ms_k.status == itt.CONVERGED)
    if ms_k.status != itt.CONVERGED:
        # As in the JAX package (N = 10000, CPU): the open-loop sweeps from
        # the constant guess diverge to finite but useless nodes.  The
        # package's fallback for non-finite nodes is the constant x0
        # trajectory: solve from there and hold both engines to convergence.
        X_c = x0_pend.expand(BENCH_N + 1, 2)
        ms_k, ms_k_ms, ms_launches = ms_bench("kernels", X_c)
        ms_p, ms_p_ms, _ = ms_bench("plain", X_c)
        ms_agree("MS bench solve from x0", ms_k, ms_p, True)
    for kernel in ("fused_riccati", "affine_prefix_scan"):
        if ms_launches.get(kernel, 0) < 1:
            raise AssertionError(f"the MS bench solve never launched {kernel}")

    lap("11")
    # ---- 12. timing of B3 and B1d, and the parallel-in-time stages --------
    # B3 at the DP defect solve's shape (the closed-loop transition along
    # the solved trajectory, 10 candidates) and the bench's.
    Pb = (exp_b.f_x + exp_b.f_u @ K_b).contiguous()
    _, qb, db = random_chain(BENCH_N, 4, 10, 8, f32)
    scan = itt.affine_prefix_scan_multi
    b3_cases = {"DP N=500 A=10": (A_cl_s, q_s, d0_s),
                f"DP N={BENCH_N} A=10": (Pb, qb, db)}

    b3_t = design_timing(smi, "B3", {
        label: lambda a=args: scan(*a, engine="pallas")
        for label, args in b3_cases.items()})
    t_b3p = {label: cuda_ms(lambda a=args: scan(*a, engine="xla"), 10, 2)
             for label, args in b3_cases.items()}
    exp_pl = tile_expansion(exp_pend, BENCH_N)
    d_pl = gaps(BENCH_N, 2)
    t_b1d = cuda_ms(lambda: itt.backward_pass_fused(exp_pl, 0.0, d_pl), 20, 3)
    t_b1dp = cuda_ms(lambda: itt.backward_pass_associative(exp_pl, 0.0, d_pl),
                     5, 1)
    exp_d500 = tile_expansion(exp_dp0, 500)
    d_d500 = gaps(500, 4)
    t_b1d5 = cuda_ms(lambda: itt.backward_pass_fused(exp_d500, 0.0, d_d500),
                     50, 5)
    t_b1d5p = cuda_ms(lambda: itt.backward_pass_associative(
        exp_d500, 0.0, d_d500), 10, 2)
    t_lsk = cuda_ms(lambda: linesearch_defect_rollouts(
        dp, x0_dp, alphas, X_b, U_b, u_b, K_b, exp_b, iters=8,
        engine="pallas"), 2, 1)
    t_lsp = cuda_ms(lambda: linesearch_defect_rollouts(
        dp, x0_dp, alphas, X_b, U_b, u_b, K_b, exp_b, iters=8,
        engine="xla"), 2, 1)
    U_half = ls["pallas"][1][i_ol, :BENCH_N // 2].contiguous()
    t_olk = cuda_ms(lambda: open_loop_defect_rollout(
        dp, x0_dp, U_half, iters=8, engine="pallas"), 2, 1)
    t_olp = cuda_ms(lambda: open_loop_defect_rollout(
        dp, x0_dp, U_half, iters=8, engine="xla"), 2, 1)
    t_ol0 = cuda_ms(lambda: open_loop_defect_rollout(
        dp, x0_dp, U_b, iters=8, engine="pallas"), 2, 1)
    # Stages of one MS iteration at the bench's size, along the solution.
    from ilqr_tpu_torch import shooting as ms_mod
    X_m, U_m = ms_k.X.contiguous(), ms_k.U.contiguous()
    d_m = ms_mod._node_defects(p_rk4, X_m, U_m)
    exp_m = itt.linearize_trajectory(p_rk4, X_m, U_m)
    u_m, K_m, _, _ = itt.backward_pass_fused(exp_m, 0.0, d_m)
    ms_alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    stages = {
        "node defects + cost": lambda: (ms_mod._node_defects(p_rk4, X_m, U_m),
                                        trajectory_cost(p_rk4, X_m, U_m)),
        "linearize_trajectory": lambda: itt.linearize_trajectory(p_rk4, X_m,
                                                                 U_m),
        "B1d backward (kernel)": lambda: itt.backward_pass_fused(exp_m, 0.0,
                                                                 d_m),
        "backward (plain, pscan)": lambda: itt.backward_pass_associative(
            exp_m, 0.0, d_m),
        "update pass, 10 alphas (B3)": lambda: ms_mod._update_pass_multi(
            ms_alphas, exp_m, d_m, u_m, K_m, "pallas"),
        "update pass, 10 alphas (plain)": lambda: ms_mod._update_pass_multi(
            ms_alphas, exp_m, d_m, u_m, K_m, "xla"),
        "score 10 candidates": lambda: (
            trajectory_cost(p_rk4, X_m.expand(10, -1, -1),
                            U_m.expand(10, -1, -1)),
            ms_mod._node_defects(p_rk4, X_m.expand(10, -1, -1),
                                 U_m.expand(10, -1, -1))),
    }
    t_stage = {k: cuda_ms(f, 3, 1) for k, f in stages.items()}
    X_di, _, d_di = open_loop_defect_rollout(p_rk4, x0_pend,
                                             torch.zeros((BENCH_N, 1), **f32),
                                             iters=8, engine="pallas")
    # Stages of the DP line searches at the first iteration (the largest
    # step of the solve), with the solver's exit tolerance.
    from ilqr_tpu_torch.ops import chunked_rollout as chunked
    from ilqr_tpu_torch.ops.parallel_rollout import defect_rollout
    A_cl0 = exp_dp0.f_x + exp_dp0.f_u @ K0
    exit0 = 1e-6 * (1.0 + float(X_dp0.abs().max()))
    ls_args = (dp, x0_dp)
    t_ls = {
        "defect phase 1 (alpha 1)": lambda: defect_rollout(
            *ls_args, 1.0, X_dp0, U_dp0, u0, K0, A_cl0, iters=8,
            engine="pallas", exit_tol=exit0),
        "defect phase 2 (10 alphas)": lambda: linesearch_defect_rollouts(
            *ls_args, alphas, X_dp0, U_dp0, u0, K0, exp_dp0, iters=8,
            engine="pallas", exit_tol=exit0),
        "chunked phase 1 (alpha 1)": lambda: chunked.chunked_rollout(
            *ls_args, 1.0, X_dp0, U_dp0, u0, K0, A_cl0, sweeps=8,
            exit_tol=exit0),
        "chunked phase 2 (10 alphas)": lambda: (
            chunked.linesearch_chunked_rollouts(
                *ls_args, alphas, X_dp0, U_dp0, u0, K0, A_cl0, sweeps=8,
                chunk_len=chunked.coarse_chunk_len(500), exit_tol=exit0)),
        "exact fallback (host loop)": lambda: itt.linesearch_rollouts(
            *ls_args, alphas, X_dp0, U_dp0, u0, K0),
        "defect initial rollout (rest)": lambda: open_loop_defect_rollout(
            dp, x0_dp, U_dp0, iters=8, engine="pallas", exit_tol=1e-6),
    }
    # One call each (two after a warm-up until phase 38 came).
    t_ls = {k: cuda_ms(f, 1, 0) for k, f in t_ls.items()}
    print(f"timing on {smi} (CUDA events, ms per call):")
    for label, tp in t_b3p.items():
        print(f"  B3 affine_prefix_scan {label}: kernel "
              f"{b3_t[label]['event_ms']:.4f} (device "
              f"{ms_text(b3_t[label]['device_us'])}), plain {tp:.4f}")
    print(f"  B1d fused_riccati (defects) DP N=500: kernel {t_b1d5:.4f}, "
          f"plain (associative) {t_b1d5p:.4f}")
    print(f"  B1d fused_riccati (defects) pendulum N={BENCH_N}: kernel "
          f"{t_b1d:.4f}, plain (associative) {t_b1dp:.4f}")
    print(f"  DP line search N={BENCH_N}, 10 alphas, 8 sweeps: kernel scan "
          f"{t_lsk:.2f}, plain scan {t_lsp:.2f}")
    print(f"  DP open-loop defect rollout N={BENCH_N // 2}, smallest "
          f"alpha's controls, up to 8 sweeps: kernel scan "
          f"{t_olk:.2f}, plain scan {t_olp:.2f}; bench cell N={BENCH_N} "
          f"(zero controls, no sweep needed) {t_ol0:.2f}")
    print(f"  DP line-search stages N=500, first iteration:")
    for k, v in t_ls.items():
        print(f"    {k}: {v:.2f}")
    print(f"  MS defect initial rollout N={BENCH_N} (pendulum rk4, zero "
          f"controls, 8 sweeps from x0): defect {float(d_di):.2e}, finite "
          f"{bool(torch.isfinite(X_di).all())}")
    print(f"  MS iteration stages N={BENCH_N} (pendulum rk4):")
    for k, v in t_stage.items():
        print(f"    {k}: {v:.3f}")
    print(f"  MS solve N={BENCH_N}: kernels {ms_k_ms:.1f} ms "
          f"({ms_k.iterations} iterations), plain {ms_p_ms:.1f} ms "
          f"({ms_p.iterations} iterations)")

    # Bounds at the timed shapes (bytes: inputs read once, outputs written
    # once; operations: the sequential recursion's work).
    nx, nu, N5 = 4, 2, 500
    A10 = alphas.numel()
    ls_ops = rollout_step_ops("double_pendulum", "euler", nx, nu)
    traj_in = (N5 + 1) * nx + 2 * N5 * nu + N5 * nu * nx + params_floats(nx,
                                                                         nu)
    b_b1 = bound(4 * (expansion_floats(N5, nx, nu) + N5 * (nu + nu * nx) + 2),
                 N5 * riccati_step_ops(nx, nu))
    b_ls = bound(4 * (traj_in + nx + A10 + A10), A10 * N5 * ls_ops)
    b_tr = bound(4 * (traj_in + nx + 1 + (N5 + 1) * nx + N5 * nu + 1),
                 N5 * ls_ops)
    b_ol = chain_bounds(nx, nu, N5, A10)["open_loop_rollout"]
    b_b1d = bound(4 * (expansion_floats(BENCH_N, 2, 1) + BENCH_N * 2
                       + BENCH_N * (1 + 2) + 2),
                  BENCH_N * riccati_step_ops(2, 1))

    def entry(name, source, replaces, launches, err, ms, plain_ms, b, **more):
        return dict(name=name, route="cuda",
                    source=f"ilqr_tpu_torch/csrc/{source}",
                    replaces=f"ilqr_tpu/ops/{replaces}", launches=launches,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                    bound_by=b[1], library_ms=None, **more)

    lpc = launches_per_call
    b1_ms, b1_more = timing_columns(b1_t["DP N=500"], lpc["fused_riccati"])
    b3_ms, b3_more = timing_columns(b3_t["DP N=500 A=10"],
                                    lpc["affine_prefix_scan"])
    b3l_ms, b3l_more = timing_columns(b3_t[f"DP N={BENCH_N} A=10"],
                                      lpc["affine_prefix_scan"])
    b1d_ms, b1d_more = timing_columns(b1_t[f"pendulum N={BENCH_N}, defects"],
                                      lpc["fused_riccati_defects"])
    b_imp = chain_bounds(2, 1, 400, A10, model="pendulum",
                         integrator="backward_euler")
    imp_source = {"linesearch_costs": "pallas_rollout.py:92",
                  "closed_loop_rollout": "pallas_rollout.py:132",
                  "open_loop_rollout": "pallas_rollout.py:132"}
    kernels_json = [
        entry("fused_riccati", "fused_riccati.cu", "pallas_riccati.py:774",
              launches.get("fused_riccati", 0), errors["fused_riccati"],
              b1_ms, t_b1p, b_b1, **b1_more),
        entry("linesearch_costs", "chain_rollout.cu", "pallas_rollout.py:92",
              launches.get("linesearch_costs", 0),
              errors["linesearch_costs"], t_c, t_cp, b_ls),
        entry("closed_loop_rollout", "chain_rollout.cu",
              "pallas_rollout.py:132", launches.get("closed_loop_rollout", 0),
              errors["closed_loop_rollout"], t_t, t_tp, b_tr),
        entry("open_loop_rollout", "chain_rollout.cu",
              "pallas_rollout.py:132", launches.get("open_loop_rollout", 0),
              errors["open_loop_rollout"], t_init_k, t_init, b_ol),
        # B3 at the DP defect solve's shape, with that solve's launches,
        # and at the bench's (N = 100000), with its line search's.
        entry("affine_prefix_scan", "affine_scan.cu", "pallas_affine.py:137",
              par_launches["defect"].get("affine_prefix_scan", 0),
              errors["affine_prefix_scan"], b3_ms, t_b3p["DP N=500 A=10"],
              b3_bound(500, 4, 10), **b3_more),
        entry(f"affine_prefix_scan_n{BENCH_N}", "affine_scan.cu",
              "pallas_affine.py:137", ls_counts.get("affine_prefix_scan", 0),
              errors["affine_prefix_scan"], b3l_ms,
              t_b3p[f"DP N={BENCH_N} A=10"], b3_bound(BENCH_N, 4, 10),
              **b3l_more),
        entry("fused_riccati_defects", "fused_riccati.cu",
              "pallas_riccati.py:774", ms_launches.get("fused_riccati", 0),
              errors["fused_riccati_defects"], b1d_ms, t_b1dp, b_b1d,
              **b1d_more),
    ]
    # The implicit instantiations (backward Euler) at the pendulum golden's
    # shape, with the launches of its solve; per step there and on the
    # UA-DP golden.
    kernels_json += [
        entry(f"{name}_backward_euler", "chain_rollout.cu", imp_source[name],
              pend_runs["pallas"][2].get(name, 0),
              errors[f"{name}_backward_euler"],
              imp_t["pendulum", name]["ms"], imp_plain[name], b_imp[name],
              ns_per_step=imp_t["pendulum", name]["ns_per_step"],
              ua_dp_ns_per_step=imp_t["UA-DP", name]["ns_per_step"])
        for name in imp_source]
    lap("12")
    rows_38 = batch_parallel_phases(itt, dev, smi, lpc, par_sols)
    print(f"phases 1-12 and 38 (this process): "
          f"{time.perf_counter() - t_run:.1f} s")
    kernels_json += finish_groups(groups, t_run + GROUP_DEADLINE_S)
    kernels_json += rows_38
    print(f"phases 1-38: {time.perf_counter() - t_run:.1f} s")
    for k in kernels_json:
        print(f"  {k['name']}: {k['ms']:.4f} ms on {smi}, bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, {k['launches']} launches")
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# `--turns`: the batched kernels at the batched-solve and batched-MPC cells'
# shapes, and the B = 1 chain kernels on the DP line-search cell.
TURN_SHAPES = {"batched-solve B=1024 N=128": (1024, 128),
               "batched-MPC B=512 N=64": (512, 64)}
TURN_CHAIN_N = (500, BENCH_N)
# The wide forms at their paths' shapes: B6w (and B7w, the same kernel) at
# the flight's (n, M) and the dash's; B4w at P1, its rotor variant, P2's
# planar quadrotor and P5's rate cart-pole (n_x, n_u, B, N).
TURN_B6W = ((12, 151), (6, 301))
TURN_B4W = ((12, 4, 256, 80), (16, 4, 16, 80), (6, 2, 64, 100),
            (5, 1, 256, 100))
# B1w at the flight MPC's (n_x, n_u, N), P4's, the dash TVLQR's and the
# bench's widest cell (there beside its plain version,
# backward_pass_associative); B3w at P3's (n, N, A): the defect line
# search's 10 candidates and multiple shooting's 1.
TURN_B1W = ((12, 4, 50), (3, 1, 50), (6, 2, 300), (16, 4, WIDE_N))
TURN_B3W = ((12, 80, 10), (12, 80, 1))


def kernel_turns(tag: str, turns: int = 3) -> int:
    """``python3 chip_smoke.py --turns TAG``: time B4, B5, B2, B6w, B7w,
    B4w, B1w and B3w through their public wrappers by `design_timing`
    (``turns`` turns)
    and print one JSON line {"tag", "device", "times": {label: {kernel:
    {device_us, host_us, event_ms}}}}.  B4 and B5 run on the first
    iteration of a DP swing-up batch at each of TURN_SHAPES (bench.py's
    initial states, zero controls, their expansion and B4 gains; 10
    alphas, the trajectory at alpha 0.5, the open loop of the zero
    controls); B2 on the DP line-search cell at each of TURN_CHAIN_N (as
    `chain_timing`); B6w and B7w on the elements (`make_elements`) of a
    seeded expansion at each of TURN_B6W, B4w on a seeded batched
    expansion at each of TURN_B4W, B1w on a seeded expansion at each of
    TURN_B1W (and its plain version at N = WIDE_N), B3w on a seeded chain
    at each of TURN_B3W.  Only wrapper signatures that the port
    has had since its wide kernels came are used, so this file copied
    into the root of an older checkout times that checkout's kernels the
    same way: run two checkouts in turns (A, B, B, A) in one call to
    compare them on one card."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    import ilqr_tpu_torch as itt

    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    smi = nvidia_smi()
    dp = dp_system(itt, f32)
    alphas = torch.tensor(itt.IlqrConfig().alpha_schedule(), **f32)
    cases = {}
    for label, (B, N) in TURN_SHAPES.items():
        x0s = torch.zeros((B, 4), **f32)
        x0s[:, 0] += torch.linspace(0.0, 0.5, B, **f32)
        U = torch.zeros((B, N, 2), **f32)
        X = itt.rollout(dp, x0s, U)[0].contiguous()
        exp = itt.linearize_trajectory_batched(dp, X, U)
        u_ff, K, _, _ = itt.backward_pass_batched(exp, 0.0)
        alpha_b = torch.full((B,), 0.5, **f32)
        cases[label] = {
            "batched_riccati": partial(itt.backward_pass_batched, exp, 0.0),
            "linesearch_costs_batched": partial(
                itt.linesearch_costs_batched, dp, x0s, alphas, X, U, u_ff, K),
            "closed_loop_rollout_batched": partial(
                itt.closed_loop_rollout_batched, dp, x0s, alpha_b, X, U,
                u_ff, K),
            "open_loop_rollout_batched": partial(
                itt.open_loop_rollout_batched, dp, x0s, U)}
    x0 = torch.zeros(4, **f32)
    for N in TURN_CHAIN_N:
        U = torch.zeros((N, 2), **f32)
        X = torch.zeros((N + 1, 4), **f32)   # the DP rests exactly
        u_ff, K, _, _ = itt.backward_pass_fused(
            itt.linearize_trajectory(dp, X, U), 0.0)
        cases[f"DP line-search cell N={N}"] = {
            "linesearch_costs": partial(itt.linesearch_costs_fused, dp, x0,
                                        alphas, X, U, u_ff, K),
            "closed_loop_rollout": partial(itt.closed_loop_rollout_fused, dp,
                                           x0, 1.0, X, U, u_ff, K),
            "open_loop_rollout": partial(itt.open_loop_rollout_fused, dp, x0,
                                         U)}
    from ilqr_tpu_torch.ops.parallel_riccati import (RiccatiElement,
                                                     make_elements)
    for n, M in TURN_B6W:
        el = RiccatiElement(*(t.contiguous() for t in make_elements(
            random_expansion(itt, M - 1, n, n // 3, 60 + n, f32), 0.0)))
        cases[f"B6w n={n} M={M}"] = {
            "suffix_scan_wide": partial(itt.suffix_scan_fused, el),
            "suffix_scan_lane_wide": partial(itt.suffix_scan_fused, el,
                                             "lane")}
    for n_x, n_u, B, N in TURN_B4W:
        exp = batched_random_expansion(itt, B, N, n_x, n_u, 70 + n_x, f32)
        cases[f"B4w ({n_x}, {n_u}) B={B} N={N}"] = {
            "batched_riccati_wide": partial(itt.backward_pass_batched, exp,
                                            0.0)}
    for n_x, n_u, N in TURN_B1W:
        exp = random_expansion(itt, N, n_x, n_u, 80 + n_x, f32)
        calls = {"fused_riccati_wide": partial(itt.backward_pass_fused, exp,
                                               0.0)}
        if N == WIDE_N:
            calls["backward_pass_associative"] = partial(
                itt.backward_pass_associative, exp, 0.0)
        cases[f"B1w ({n_x}, {n_u}) N={N}"] = calls
    for n, N, A in TURN_B3W:
        P, q, d0 = random_chain(N, n, A, 90 + A, f32)
        cases[f"B3w n={n} N={N} A={A}"] = {
            "affine_prefix_scan_wide": partial(
                itt.affine_prefix_scan_multi, P, q, d0, engine="pallas")}
    out = {"tag": tag, "device": smi, "times": {}}
    for label, calls in cases.items():
        out["times"][label] = {
            kernel: design_timing(smi, kernel, {label: fn}, turns)[label]
            for kernel, fn in calls.items()}
    print(json.dumps(out))
    return 0


def flight_turn(tag: str) -> int:
    """``python3 chip_smoke.py --flight TAG``: solve the 3-D quadrotor
    flight's open loop once (examples_torch/quadrotor3d_flight.py's
    problem: N = 150, thrust limits, adaptive_reg; one B6w launch at
    n = 12 a sweep), the kernels built first, and print one JSON line
    {"tag", "device", "status", "iterations", "sweeps", "cost",
    "seconds"}.  Copied into the root of an older checkout it solves with
    that checkout's kernels, so two checkouts' counts show whether a kernel
    change moved the solve's path."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    import ilqr_tpu_torch as itt
    from examples_torch import quadrotor3d_flight
    from ilqr_tpu_torch.ops import _build

    _build.load()
    p = quadrotor3d_flight.problem(torch.device("cuda", 0))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sol = itt.solve(p.system, p.x0, p.U0, p.config)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(json.dumps({
        "tag": tag, "device": nvidia_smi(), "status": int(sol.status),
        "iterations": int(sol.iterations),
        "sweeps": _build.launch_counts().get("suffix_scan", 0),
        "cost": float(sol.cost), "seconds": secs}))
    return 0


def hvp_timing(itt, dev) -> dict:
    """One Hessian-vector product of P7's rollout cost (the pendulum under
    rk4, N = 60, at the first demonstration's solution) taken two ways on
    the card: ``torch.func.jvp`` of ``torch.func.grad`` through the plain
    rollout (the construction of JAX's diff.py) and `diff._Adjoint.hvp`,
    the second-order adjoint `solve_implicit`'s CG runs.  Returns and
    prints the host milliseconds of each (the adjoint's set-up, the
    expansion and the dynamics' Hessians, apart) and their difference."""
    from examples_torch import inverse_optimal_control as ioc
    from ilqr_tpu_torch import diff

    p = ioc.problem(dev)
    sys0 = ioc.make_system(p.log_w0, dev)
    sol = itt.solve(sys0, p.x0s[0], p.U0, p.config)
    X, U = sol.X, sol.U
    v = torch.randn(U.shape, generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)

    def cost(U):
        return itt.rollout(sys0, p.x0s[0], U)[1]

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    t_jvp, h_jvp = ms(lambda: torch.func.jvp(torch.func.grad(cost), (U,),
                                             (v,))[1])
    t_set, hvp = ms(lambda: diff._Adjoint(sys0, X, U).hvp(0.0))
    t_adj, h_adj = ms(lambda: hvp(v))
    _, rr = rel_err(h_adj, h_jvp)
    out = dict(jvp_of_grad_ms=t_jvp, adjoint_setup_ms=t_set,
               adjoint_ms=t_adj, rel_diff=rr)
    print(f"HVP at P7's first solution (N = {p.N}): jvp of grad "
          f"{t_jvp:.2f} ms a product; the adjoint {t_adj:.2f} ms a product "
          f"after {t_set:.2f} ms of set-up; {rr:.1e} of max apart")
    return out


def solver_turn() -> int:
    """``python3 chip_smoke.py --solvers``: build the kernels, run phase
    36 alone (`solver_phases`, no launches-per-call column) and
    `hvp_timing`, and print the phase's kernels line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    import ilqr_tpu_torch as itt
    from ilqr_tpu_torch.ops import _build

    smi = nvidia_smi()
    print(smi)
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s (nvcc "
          f"{lib.build_seconds:.1f} s)")
    dev = torch.device("cuda", 0)
    rows = solver_phases(itt, dev, smi, {})
    hvp_timing(itt, dev)
    print(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--group"]:
        sys.exit(group_turn(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--solvers"]:
        sys.exit(solver_turn())
    if sys.argv[1:2] == ["--batch-options"]:
        sys.exit(batch_option_turn())
    if sys.argv[1:2] == ["--batch-parallel"]:
        sys.exit(batch_parallel_turn())
    if sys.argv[1:2] == ["--learned"]:
        sys.exit(learned_turn())
    if sys.argv[1:2] == ["--sass"]:
        sys.exit(sass_turn())
    if sys.argv[1:2] == ["--turns"]:
        sys.exit(kernel_turns(sys.argv[2] if len(sys.argv) > 2 else "tree"))
    if sys.argv[1:2] == ["--flight"]:
        sys.exit(flight_turn(sys.argv[2] if len(sys.argv) > 2 else "tree"))
    sys.exit(main())
