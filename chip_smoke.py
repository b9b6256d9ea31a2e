#!/usr/bin/env python3
"""Drive the PyTorch port (ilqr_tpu_torch) on one CUDA GPU and check it.

Run from the root of the repository, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ilqr_tpu_torch/csrc`` with nvcc
(sm_90a), then:

1. prints the GPU's name and power limit, the torch and CUDA versions and
   the kernel build time (with each kernel's registers and spills);
2. checks the fused backward pass (B1) against its plain version on the
   double-pendulum, pendulum and under-actuated double-pendulum expansions,
   at N = 500, at a horizon that crosses several scan blocks and ends
   mid-block, and at N = 131072 (the N = 500 expansion tiled along time);
3. checks the rollout kernels (B2) against their plain versions on the
   double pendulum at N = 500 with the 10-α schedule;
4. solves the double-pendulum swing-up (N = 500, maxiter 200, tol 1e-6,
   euler) with backward='pallas' and rollout='pallas', with the launch
   counts reset just before and read just after, and gates the result;
   then the pendulum golden (backward_euler, N = 400) with
   backward='pallas', rollout='scan';
5. times each kernel and its plain version with CUDA events, and the
   double-pendulum solve per iteration with kernels against plain engines.

Any failed check raises, and the script exits non-zero.  Without a CUDA
device it exits non-zero before printing any result.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# The reference's own f32 golden cost of the double-pendulum swing-up
# (tests/golden/double_pendulum_ol.npz), gated at 1.02x as the JAX test does.
DP_GOLDEN_COST = 214.310
# The reference's pendulum swing-up cost (tests/golden/pendulum_ol.npz).
PENDULUM_GOLDEN_COST = 23.435774
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


def tile_expansion(exp, N: int):
    """``exp`` repeated along time and cut to N steps (terminal unchanged)."""
    reps = -(-N // exp.f_x.shape[0])

    def tile(t):
        return t.repeat((reps,) + (1,) * (t.ndim - 1))[:N].contiguous()

    return dataclasses.replace(
        exp, **{f: tile(getattr(exp, f)) for f in
                ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu")})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script runs only on a CUDA GPU", file=sys.stderr)
        return 1

    import ilqr_tpu_torch as itt
    from ilqr_tpu_torch.ops import _build, fused_riccati

    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)

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
    block = fused_riccati.block_steps(kernels.lib)

    def dp_system(underactuated=False, integrator="euler"):
        if underactuated:
            return itt.make_double_pendulum(
                0.01, [np.pi, 0, 0, 0], Q=np.diag([1.0, 1.0, 0.1, 0.1]),
                R=np.diag([1.0]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
                d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12,
                underactuated=True, integrator=integrator, **f32)
        return itt.make_double_pendulum(
            0.01, [np.pi, 0, 0, 0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
            R=np.diag([0.1, 0.1]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
            d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12,
            integrator=integrator, **f32)

    pend = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.zeros((2, 2)), d=0.0,
                             integrator="backward_euler", **f32)
    dp = dp_system()
    ua = dp_system(underactuated=True, integrator="backward_euler")
    x0_dp = torch.zeros(4, **f32)
    x0_pend = torch.tensor([1.0, 0.0], **f32)

    def expansion(system, x0, N):
        U = torch.zeros((N, system.n_u), **f32)
        X, _ = itt.rollout(system, x0, U)
        return X, U, itt.linearize_trajectory(system, X, U)

    errors: dict[str, float] = {"fused_riccati": 0.0, "linesearch_costs": 0.0,
                                "closed_loop_rollout": 0.0}

    def check_b1(label, exp, reg=0.0):
        torch.cuda.synchronize()
        u_k, K_k, dV_k, ok_k = itt.backward_pass_fused(exp, reg)
        u_p, K_p, dV_p, ok_p = itt.backward_pass_associative(exp, reg)
        exp64 = dataclasses.replace(exp, **{
            f.name: getattr(exp, f.name).double()
            for f in dataclasses.fields(exp)})
        ref64 = itt.backward_pass_associative(exp64, reg)
        torch.cuda.synchronize()
        notes = []
        for name, got, ref, r64 in (("u_ff", u_k, u_p, ref64[0]),
                                    ("K", K_k, K_p, ref64[1]),
                                    ("dV", dV_k, dV_p, ref64[2])):
            err, rel = rel_err(got, ref)
            floor = rel_err(ref, r64)[0]
            limit = max(RTOL_B1 * float(ref.abs().max()), F32_FLOOR * floor)
            errors["fused_riccati"] = max(errors["fused_riccati"], err)
            notes.append(f"{name} {err:.2e} (rel {rel:.1e}, limit {limit:.2e};"
                         f" kernel vs f64 {rel_err(got, r64)[0]:.2e},"
                         f" plain vs f64 {floor:.2e})")
            if not err <= limit:
                raise AssertionError(f"B1 {label}: {notes[-1]}")
        if not (bool(ok_k) and bool(ok_p)):
            raise AssertionError(f"B1 {label}: non-finite gains")
        print(f"B1 {label}: N={exp.f_x.shape[0]} max abs error " + "; ".join(notes))

    # ---- 2. B1 against its plain version --------------------------------
    mid_n = 5 * block + block // 2 + 3   # crosses 5 block edges, ends mid-block
    print(f"B1 tolerance: max|kernel - plain| <= {RTOL_B1} * max|plain| "
          f"(f32 scans in two association orders); scan block {block} steps")
    X_dp0, U_dp0, exp_dp0 = expansion(dp, x0_dp, 500)
    for N in (500, mid_n, LONG_N):
        check_b1("DP first trajectory", tile_expansion(exp_dp0, N))
    check_b1("DP first trajectory, reg 0.1", exp_dp0, reg=0.1)
    _, _, exp_pend = expansion(pend, x0_pend, 400)
    for N in (400, mid_n):
        check_b1("pendulum", tile_expansion(exp_pend, N))
    _, _, exp_ua = expansion(ua, x0_dp, 800)
    for N in (800, mid_n):
        check_b1("UA-DP", tile_expansion(exp_ua, N))

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

    # ---- 4. the slice: the DP swing-up through both kernels -------------
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sol = itt.solve(dp, x0_dp, torch.zeros((500, 2), **f32), cfg)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    trace = sol.cost_trace[:sol.iterations].cpu().numpy()
    cost = float(sol.cost)
    print(f"DP solve (pallas/pallas): status {sol.status}, "
          f"{sol.iterations} iterations, cost {cost:.6f}, {solve_s:.3f} s, "
          f"launches {launches}")
    # Status gate.  tol = 1e-6 is below the f32 resolution of a cost near
    # 37 (one ulp is 3.8e-6), so a solve at its f32 floor stops either by
    # an exactly repeated cost (CONVERGED) or by a line search in which no
    # candidate beats the current cost by rounding (LINESEARCH_FAILED).
    # The latter counts only when the last accepted step moved the cost by
    # at most 8 ulp.
    last_step = abs(float(trace[-1] - trace[-2])) if len(trace) > 1 else np.inf
    at_floor = last_step <= 8 * float(np.spacing(np.float32(cost)))
    if not (sol.status in (itt.CONVERGED, itt.MAXITER)
            or (sol.status == itt.LINESEARCH_FAILED and at_floor)):
        raise AssertionError(f"DP solve ended with status {sol.status}, "
                             f"last accepted step {last_step:.3e}")
    if not np.all(np.diff(trace) <= 0):
        raise AssertionError("DP cost trace increased")
    if not cost <= 1.02 * DP_GOLDEN_COST:
        raise AssertionError(f"DP cost {cost} above 1.02 x {DP_GOLDEN_COST}")
    ang_err = (sol.X[-1, :2] - torch.tensor([np.pi, 0.0], **f32)).abs().max()
    if not float(ang_err) <= 0.2:
        raise AssertionError(f"DP final angles {sol.X[-1, :2].tolist()} "
                             f"not within 0.2 of the target")
    if not (torch.isfinite(sol.X).all() and torch.isfinite(sol.U).all()
            and sol.X.shape == (501, 4) and sol.U.shape == (500, 2)):
        raise AssertionError("DP solution not finite or of the wrong shape")
    for kernel in ("fused_riccati", "linesearch_costs", "closed_loop_rollout"):
        if launches.get(kernel, 0) < 1:
            raise AssertionError(f"the DP solve never launched {kernel}")
    print(f"DP gates passed: cost {cost:.4f} <= {1.02 * DP_GOLDEN_COST:.4f}, "
          f"final angle error {float(ang_err):.2e}, trace non-increasing")

    # B1 and B2 again, along the solved trajectory.
    X_s, U_s = sol.X.contiguous(), sol.U.contiguous()
    exp_dps = itt.linearize_trajectory(dp, X_s, U_s)
    for N in (500, mid_n, LONG_N):
        check_b1("DP solved trajectory", tile_expansion(exp_dps, N))
    u_s, K_s, _, _ = itt.backward_pass_fused(exp_dps, 0.0)
    check_b2("DP solved trajectory", X_s, U_s, u_s, K_s, alpha=1.0)

    # The pendulum golden on the GPU: kernel backward pass, plain rollouts
    # (backward Euler has no device function yet).
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sol_p = itt.solve(pend, x0_pend, torch.zeros((400, 1), **f32),
                      itt.IlqrConfig(maxiter=100, tol=1e-5, backward="pallas",
                                     rollout="scan"))
    torch.cuda.synchronize()
    pend_s = time.perf_counter() - t0
    rel = abs(float(sol_p.cost) - PENDULUM_GOLDEN_COST) / PENDULUM_GOLDEN_COST
    print(f"pendulum solve (pallas/scan): status {sol_p.status}, "
          f"{sol_p.iterations} iterations, cost {float(sol_p.cost):.6f}, "
          f"rel. error {rel:.2e} vs {PENDULUM_GOLDEN_COST}, {pend_s:.3f} s, "
          f"launches {_build.launch_counts()}")
    if not rel <= 1e-3:
        raise AssertionError("pendulum golden cost not reproduced to 1e-3")
    if _build.launch_counts().get("fused_riccati", 0) < 1:
        raise AssertionError("the pendulum solve never launched fused_riccati")

    # ---- 5. timing --------------------------------------------------------
    reg0 = 0.0
    t_b1 = cuda_ms(lambda: itt.backward_pass_fused(exp_dps, reg0), 50, 5)
    t_b1p = cuda_ms(lambda: itt.backward_pass_associative(exp_dps, reg0), 10, 2)
    exp_long = tile_expansion(exp_dps, LONG_N)
    t_b1l = cuda_ms(lambda: itt.backward_pass_fused(exp_long, reg0), 10, 2)
    t_b1lp = cuda_ms(lambda: itt.backward_pass_associative(exp_long, reg0), 3, 1)
    t_b1s = cuda_ms(lambda: itt.backward_pass(exp_dps, reg0), 2, 1)
    t_c = cuda_ms(lambda: itt.linesearch_costs_fused(
        dp, x0_dp, alphas, X_s, U_s, u_s, K_s), 50, 5)
    t_cp = cuda_ms(lambda: itt.linesearch_rollouts(
        dp, x0_dp, alphas, X_s, U_s, u_s, K_s), 2, 1)
    t_t = cuda_ms(lambda: itt.closed_loop_rollout_fused(
        dp, x0_dp, 1.0, X_s, U_s, u_s, K_s), 50, 5)
    t_tp = cuda_ms(lambda: itt.closed_loop_rollout(
        dp, x0_dp, 1.0, X_s, U_s, u_s, K_s), 2, 1)
    t_lin = cuda_ms(lambda: itt.linearize_trajectory(dp, X_s, U_s), 10, 2)
    t_init = cuda_ms(lambda: itt.rollout(dp, x0_dp, U_dp0), 2, 1)
    print(f"timing on {smi} (CUDA events, ms per call):")
    print(f"  B1 fused_riccati N=500: kernel {t_b1:.4f}, plain (associative) "
          f"{t_b1p:.4f}, sequential scan {t_b1s:.2f}")
    print(f"  B1 fused_riccati N={LONG_N}: kernel {t_b1l:.4f}, plain "
          f"(associative) {t_b1lp:.4f}")
    print(f"  B2 linesearch_costs N=500, {alphas.numel()} alphas: kernel "
          f"{t_c:.4f}, plain {t_cp:.2f}")
    print(f"  B2 closed_loop_rollout N=500: kernel {t_t:.4f}, plain {t_tp:.2f}")
    print(f"  linearize_trajectory N=500: {t_lin:.3f}; initial rollout "
          f"(host loop) N=500: {t_init:.2f}")

    def solve_ms(backward, rollout, maxiter):
        c = itt.IlqrConfig(maxiter=maxiter, tol=1e-6, backward=backward,
                           rollout=rollout)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = itt.solve(dp, x0_dp, torch.zeros((500, 2), **f32), c)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
        return total, s.iterations, (total - t_init) / max(s.iterations, 1)

    runs = [("pallas", "pallas", 200), ("scan", "scan", 3),
            ("scan", "scan", 3), ("pallas", "pallas", 200)]
    for backward, rollout_engine, maxiter in runs:
        total, iters, per_iter = solve_ms(backward, rollout_engine, maxiter)
        print(f"  DP solve backward={backward} rollout={rollout_engine}: "
              f"{total:.1f} ms total, {iters} iterations, {per_iter:.2f} ms "
              f"per iteration after the initial rollout")

    kernels_json = [
        dict(name="fused_riccati", route="cuda",
             source="ilqr_tpu_torch/csrc/fused_riccati.cu",
             replaces="ilqr_tpu/ops/pallas_riccati.py:774",
             launches=launches.get("fused_riccati", 0),
             max_abs_err=errors["fused_riccati"], ms=t_b1, plain_ms=t_b1p),
        dict(name="linesearch_costs", route="cuda",
             source="ilqr_tpu_torch/csrc/fused_rollout.cu",
             replaces="ilqr_tpu/ops/pallas_rollout.py:92",
             launches=launches.get("linesearch_costs", 0),
             max_abs_err=errors["linesearch_costs"], ms=t_c, plain_ms=t_cp),
        dict(name="closed_loop_rollout", route="cuda",
             source="ilqr_tpu_torch/csrc/fused_rollout.cu",
             replaces="ilqr_tpu/ops/pallas_rollout.py:132",
             launches=launches.get("closed_loop_rollout", 0),
             max_abs_err=errors["closed_loop_rollout"], ms=t_t,
             plain_ms=t_tp),
    ]
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
