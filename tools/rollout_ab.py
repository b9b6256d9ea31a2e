"""Time B2's chain kernels across two checkouts of the port, in turns on
one card.

Each named root (a directory holding `ilqr_tpu_torch/` and `chip_smoke.py`)
is driven by a child process of its own, which builds that root's kernels
(`_build.load`, into the root's `ilqr_tpu_torch/_build/`) and times B2a
(10 α), B2b and the open loop of the rk4 register models whose device
forms share `csrc/models.cuh`'s integrator: the 3-D quadrotor at the
flight MPC's H = 50 and at N = 500, the car at its AL solve's N = 120, the
cart-pole at its MPC's H = 200 and the pendulum at `inverse_optimal_control.py`'s N = 60,
on `chip_smoke.nominal_draws` (seed 19).  Each time is
`chip_smoke.queued_us` (CUDA events around 20 calls queued behind a spin
kernel), µs a call (NaN where the host's queueing outlasted the spin).
The builds run first, together; then the children run in the order
A B B A, and each root's two turns are printed with their mean.  Run
from the repository root on a machine with an H100, e.g. the working tree
against a `git archive` of its parent unpacked under `_scratch/`
(git-ignored):

    python3 tools/rollout_ab.py parent=_scratch/parent tree=.
"""
import json
import subprocess
import sys
from pathlib import Path

CASES = (("quadrotor3d", 50), ("quadrotor3d", 500), ("car", 120),
         ("cartpole", 200), ("pendulum", 60))


def child(root: str, build_only: bool) -> None:
    """Build ``root``'s kernels and, unless ``build_only``, print one JSON
    object {case: {entry: µs a call}}."""
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    import ilqr_tpu_torch as itt
    from ilqr_tpu_torch.ops import _build

    _build.load()
    if build_only:
        return
    f32 = dict(dtype=torch.float32, device=torch.device("cuda", 0))
    systems = cs.wide_model_systems(itt, f32, "rk4")
    systems["pendulum"] = itt.make_pendulum(
        0.05, [np.pi, 0.0], Q=np.diag([5.0, 0.5]), R=0.1 * np.eye(1),
        Q_f=np.diag([50.0, 5.0]), integrator="rk4", **f32)
    alphas = torch.tensor([0.5 ** i for i in range(10)], **f32)

    def us(fn):
        t = cs.queued_us(fn)
        return float("nan") if t is None else t

    out = {}
    for name, N in CASES:
        s = systems[name]
        x0, U, u_ff, K = cs.nominal_draws(s, name, N, 19, f32)
        X = itt.rollout(s, x0, U)[0].contiguous()
        out[f"{name} N={N}"] = {
            "B2a": us(lambda: itt.linesearch_costs_fused(
                s, x0, alphas, X, U, u_ff, K)),
            "B2b": us(lambda: itt.closed_loop_rollout_fused(
                s, x0, 0.5, X, U, u_ff, K)),
            "open loop": us(lambda: itt.open_loop_rollout_fused(
                s, x0, U))}
    print(json.dumps(out))


def main(args) -> int:
    roots = dict(a.split("=", 1) for a in args)
    me = [sys.executable, __file__]
    builds = [subprocess.Popen(me + ["--child", r, "--build-only"])
              for r in roots.values()]
    if any(p.wait() != 0 for p in builds):
        return 1
    names = list(roots)
    order = names + names[::-1]
    turns = {n: [] for n in names}
    for n in order:
        run = subprocess.run(me + ["--child", roots[n]], capture_output=True,
                             text=True, check=True)
        turns[n].append(json.loads(run.stdout.strip().splitlines()[-1]))
    print(f"B2 µs a call, order {' '.join(order)} (mean: the turns):")
    for case in turns[names[0]][0]:
        for entry in turns[names[0]][0][case]:
            cols = []
            for n in names:
                v = [t[case][entry] for t in turns[n]]
                cols.append(f"{n} {sum(v) / len(v):.2f}: "
                            f"{'/'.join(f'{x:.2f}' for x in v)}")
            print(f"  {case} {entry}: " + "; ".join(cols))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], "--build-only" in sys.argv[3:])
    else:
        sys.exit(main(sys.argv[1:]))
