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

Over a batch of B independent chains (P (B, N, n, n), q (B, A, N, n),
delta0 (B, A, n): JAX's ``jax.vmap`` of `affine_prefix_scan_multi`, whose
``pallas_call`` gains a batch grid axis), `affine_prefix_scan_batched`
makes one launch of the kernel's batched entry for all B chains, each
instance's deltas those of a single-instance launch on it bit for bit;
its plain version is `prefix_scan_batched`.  The batched defect sweeps of
`solver.solve_batch` scan through it.

Dispatch (both entries): ``engine='xla'`` runs the plain version on any
device, and so does every engine on CPU tensors and at n > 16, as in JAX.  On a CUDA
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
KERNEL_BATCHED = "affine_prefix_scan_batched"
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


def prefix_scan_batched(P: torch.Tensor, q: torch.Tensor):
    """`prefix_scan` with a leading batch axis: P (B, N, n, n), q
    (B, A, N, n).  The doubling runs along time with the batch as a
    trailing axis of `combine`'s ``...``."""
    Ps, qs = prefix_scan(P.transpose(0, 1), q.permute(1, 2, 0, 3))
    return Ps.transpose(0, 1), qs.permute(2, 0, 1, 3)


def kernel_takes(P, q, delta0) -> bool:
    """Whether the kernel takes these inputs: float32, n <= `MAX_STATE`
    (any number of candidates)."""
    return (P.shape[-1] <= MAX_STATE
            and all(t.dtype == torch.float32 for t in (P, q, delta0)))


def _check(P, q, delta0) -> None:
    """Refuse what the kernel does not take: P (N, n, n), q (A, N, n),
    delta0 (A, n), or over a batch the same with a leading B, with
    B, N >= 1, float32, on one device, contiguous."""
    if P.ndim not in (3, 4):
        raise ValueError(f"P has shape {tuple(P.shape)}, expected "
                         f"(N, n, n) or (B, N, n, n)")
    lead = tuple(P.shape[:-3])
    N, n = P.shape[-3], P.shape[-1]
    A = q.shape[-3] if q.ndim == P.ndim else 0
    shapes = dict(P=lead + (N, n, n), q=lead + (A, N, n),
                  delta0=lead + (A, n))
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
    if N < 1 or min(lead, default=1) < 1:
        raise ValueError("the CUDA affine scan needs a horizon N >= 1 and "
                         "a batch B >= 1")


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


def launch_batched(lib, P, q, delta0, stream) -> torch.Tensor:
    """The batched entry on P (B, N, n, n), q (B, A, N, n), delta0
    (B, A, n): allocate δ (B, A, N+1, n) and make one launch for every
    instance.  Takes the library handle as `launch` does; inputs must
    already have passed `_check`."""
    B, N, n = P.shape[0], P.shape[1], P.shape[-1]
    A = q.shape[1]
    counters, scratch = _build.scratch(lib, KERNEL_BATCHED, P.device, stream,
                                       n, A, B, N)
    out = torch.empty((B, A, N + 1, n), dtype=torch.float32, device=P.device)
    code = lib.ilqr_affine_prefix_scan_batched(
        n, A, B, N, P.data_ptr(), q.data_ptr(), delta0.data_ptr(),
        counters.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, code, "batched affine prefix scan kernel")
    return out


def _on_kernel(P, q, delta0, engine: str) -> bool:
    """Whether ``engine`` launches the kernel on these inputs (False: the
    plain version); raises where 'pallas' cannot launch it."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'auto'|'pallas'|'xla', got {engine!r}")
    if (engine == "xla" or P.shape[-1] > MAX_STATE or P.device.type == "cpu"
            or (engine == "auto" and not kernel_takes(P, q, delta0))):
        return False
    if not kernel_takes(P, q, delta0):
        raise TypeError(f"the CUDA affine scan takes float32, got "
                        f"{P.dtype}, {q.dtype}, {delta0.dtype}")
    if P.device.type != "cuda":
        raise ValueError(f"no affine scan kernel for device {P.device}")
    return True


def _launch_counted(launcher, kernel: str, P, q, delta0) -> torch.Tensor:
    P, q, delta0 = P.contiguous(), q.contiguous(), delta0.contiguous()
    _check(P, q, delta0)
    with _build.on_device(P.device):
        out = launcher(_build.load().lib, P, q, delta0,
                       _build.current_stream(P.device))
    _build.count_launch(kernel)
    return out


@full_f32_matmuls()
def affine_prefix_scan_multi(P: torch.Tensor, q: torch.Tensor,
                             delta0: torch.Tensor,
                             engine: str = "auto") -> torch.Tensor:
    """Solve δ_{k+1} = P_k δ_k + q_k^(a) for all candidates a at once.

    P: (N, n, n) shared transition chain; q: (A, N, n) per-candidate drives;
    delta0: (A, n).  Returns δ: (A, N+1, n) with δ[:, 0] = δ0.
    """
    if _on_kernel(P, q, delta0, engine):
        return _launch_counted(launch, KERNEL, P, q, delta0)
    Ps, qs = prefix_scan(P, q)
    deltas = torch.einsum("kij,aj->aki", Ps, delta0) + qs
    return torch.cat([delta0[:, None], deltas], dim=1)


@full_f32_matmuls()
def affine_prefix_scan_batched(P: torch.Tensor, q: torch.Tensor,
                               delta0: torch.Tensor,
                               engine: str = "auto") -> torch.Tensor:
    """`affine_prefix_scan_multi` over B independent chains: P
    (B, N, n, n), q (B, A, N, n), delta0 (B, A, n) → δ (B, A, N+1, n), on
    CUDA one launch of the kernel's batched entry."""
    if _on_kernel(P, q, delta0, engine):
        return _launch_counted(launch_batched, KERNEL_BATCHED, P, q, delta0)
    Ps, qs = prefix_scan_batched(P, q)
    deltas = torch.einsum("bkij,baj->baki", Ps, delta0) + qs
    return torch.cat([delta0[:, :, None], deltas], dim=2)
