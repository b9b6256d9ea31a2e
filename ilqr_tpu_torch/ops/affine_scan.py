"""Multi-candidate affine prefix scan: δ_{k+1} = P_k δ_k + q_k^(a).

PyTorch counterpart of `ilqr_tpu/ops/pallas_affine.py`
(`affine_prefix_scan_multi`, kernel `_prefix_kernel_sub`).  The transition
chain P is shared by all A candidates; only the drives q^(a) differ.  The
elements (P_k, q_k^(1..A)) combine associatively,

    (P, q^a) ∘ (P', q'^a) = (P'P, P'q^a + q'^a)        (earlier ∘ later),

so the inclusive prefixes give every δ_{k+1} = (P_k⋯P_0) δ_0 + (q prefix)_k
in ⌈log₂ N⌉ sweeps.  The plain version, `prefix_scan`, doubles over the
whole horizon with torch ops; the CUDA kernel, `csrc/affine_scan.cu`, is
one launch: at n ∈ {2, 4} and up to 16 candidates (the register form)
256-step tiles scanned by warp shuffles, elsewhere at n ≤ 16 and any
number of candidates (the wide form) 32-step tiles run by warps (a tree
of warp products for the tile's transition, a warp a candidate's chain;
`csrc/group_linalg.cuh`), a state carried across tiles by decoupled
look-back either way.  Its
counters and scratch come from `_build.scratch` (once per device, stream
and shape); per call the wrapper allocates only δ.

Dispatch: ``engine='xla'`` runs the plain version on any device, and so
does every engine on CPU tensors and at n > 16, as in JAX.  On a CUDA
tensor ``'pallas'`` launches the kernel, which takes float32 at n ≤ 16
(`kernel_takes`), or raises; ``'auto'`` launches it where it takes the
inputs and runs the plain version elsewhere (float64), as JAX's 'auto'
runs XLA wherever its kernel does not apply (`pallas_affine.py:300-304`).
"""
from __future__ import annotations

import torch

from ilqr_tpu_torch.models.base import full_f32_matmuls
from ilqr_tpu_torch.ops import _build

KERNEL = "affine_prefix_scan"
MAX_STATE = 16   # the largest n of the kernel (and of JAX's)
ENGINES = ("auto", "pallas", "xla")


def combine(earlier, later):
    """(P, q) ∘ (P', q') = (P'P, P'q + q'), batched; q carries the
    candidate axis first: P (..., n, n), q (A, ..., n)."""
    P1, q1 = earlier
    P2, q2 = later
    return P2 @ P1, torch.einsum("...ij,a...j->a...i", P2, q1) + q2


def prefix_scan(P: torch.Tensor, q: torch.Tensor):
    """Inclusive prefixes of (P (N, n, n), q (A, N, n)) by recursive
    doubling: at distance d, E[k] ← E[k−d] ∘ E[k] wherever k ≥ d."""
    N = P.shape[0]
    d = 1
    while d < N:
        P_new, q_new = combine((P[:N - d], q[:, :N - d]), (P[d:], q[:, d:]))
        P = torch.cat([P[:d], P_new])
        q = torch.cat([q[:, :d], q_new], dim=1)
        d *= 2
    return P, q


def kernel_takes(P, q, delta0) -> bool:
    """Whether the kernel takes these inputs: float32, n <= `MAX_STATE`
    (any number of candidates)."""
    return (P.shape[-1] <= MAX_STATE
            and all(t.dtype == torch.float32 for t in (P, q, delta0)))


def _check(P, q, delta0) -> None:
    N, n = P.shape[0], P.shape[-1]
    A = q.shape[0]
    shapes = dict(P=(N, n, n), q=(A, N, n), delta0=(A, n))
    for name, t in zip(shapes, (P, q, delta0)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA affine scan takes float32, "
                            f"{name} is {t.dtype}")
        if t.device != P.device:
            raise ValueError(f"{name} is on {t.device}, P on {P.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N < 1:
        raise ValueError("the CUDA affine scan needs a horizon N >= 1")


def tile_steps(lib, n: int, A: int) -> int:
    """Steps per tile of the kernel at n and A candidates (its cross-tile
    carry period): the register form's at n in {2, 4} with A <= 16, else
    the wide form's."""
    return lib.ilqr_affine_tile_steps(n, A)


def launch(lib, P, q, delta0, stream) -> torch.Tensor:
    """Allocate δ and run the kernel on ``stream``: one launch.  Takes the
    library handle so that any build of the sources can be run; inputs must
    already have passed `_check`."""
    N, n = P.shape[0], P.shape[-1]
    A = q.shape[0]
    counters, scratch = _build.scratch(lib, KERNEL, P.device, stream, n, A, N)
    out = torch.empty((A, N + 1, n), dtype=torch.float32, device=P.device)
    code = lib.ilqr_affine_prefix_scan(
        n, A, N, P.data_ptr(), q.data_ptr(), delta0.data_ptr(),
        counters.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, code, "affine prefix scan kernel")
    return out


@full_f32_matmuls()
def affine_prefix_scan_multi(P: torch.Tensor, q: torch.Tensor,
                             delta0: torch.Tensor,
                             engine: str = "auto") -> torch.Tensor:
    """Solve δ_{k+1} = P_k δ_k + q_k^(a) for all candidates a at once.

    P: (N, n, n) shared transition chain; q: (A, N, n) per-candidate drives;
    delta0: (A, n).  Returns δ: (A, N+1, n) with δ[:, 0] = δ0.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'auto'|'pallas'|'xla', got {engine!r}")
    n = P.shape[-1]
    device = P.device
    if (engine == "xla" or n > MAX_STATE or device.type == "cpu"
            or (engine == "auto" and not kernel_takes(P, q, delta0))):
        Ps, qs = prefix_scan(P, q)
        deltas = torch.einsum("kij,aj->aki", Ps, delta0) + qs
        return torch.cat([delta0[:, None], deltas], dim=1)
    if not kernel_takes(P, q, delta0):
        raise TypeError(f"the CUDA affine scan takes float32, got "
                        f"{P.dtype}, {q.dtype}, {delta0.dtype}")
    if device.type != "cuda":
        raise ValueError(f"no affine scan kernel for device {device}")
    P, q, delta0 = P.contiguous(), q.contiguous(), delta0.contiguous()
    _check(P, q, delta0)
    with _build.on_device(device):
        lib = _build.load().lib
        out = launch(lib, P, q, delta0,
                     _build.current_stream(device))
    _build.count_launch(KERNEL)
    return out
