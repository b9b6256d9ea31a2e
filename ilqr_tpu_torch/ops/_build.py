"""Build, load and count the port's CUDA kernels.

The sources in ``ilqr_tpu_torch/csrc`` are compiled at first use, one
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c`` per source, all
started together, and linked into one shared library with a plain C
interface, loaded with `ctypes`.  Building takes seconds because no PyTorch
header is included.  The library lands in
``ilqr_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, so a fresh checkout builds it once and an edit rebuilds it.  The
build works in a temporary directory and renames the library into place, so
processes that build at once do not see a partial library.

Nothing here runs at import: the CPU tests import every module of the
package on machines without nvcc or a GPU.

Every C entry returns ``cudaGetLastError()`` after its launches; `check`
turns a non-zero code into an exception.  Each kernel wrapper adds one to
its entry in the launch counts where it launches its kernel, and nowhere
else, so a run can show which kernels its main path went through.  The
look-back kernels (B1, B3, B6/B7 and B3 and B6 over a batch:
``csrc/lookback.cuh``) take their counters and scratch from `scratch`, one
set per device, stream and shape (the batch size included).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libilqr_tpu_torch_kernels.so"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry: c_void_p for each pointer and the stream.
SIGNATURES = {
    "ilqr_fused_riccati": [_I, _I, _I, _F] + [_P] * 10 + [_P] * 6 + [_P],
    "ilqr_fused_riccati_counters": [_I, _I],
    "ilqr_fused_riccati_scratch": [_I, _I],
    "ilqr_riccati_tile_steps": [_I, _I],
    "ilqr_riccati_wide_max_n": [],
    "ilqr_linesearch_costs": [_I, _I, _I, _I, _I, _P, _I, _P, _P, _I,
                              _P, _P, _P, _P, _I, _P, _P],
    "ilqr_closed_loop_rollout": [_I, _I, _I, _I, _I, _P, _I, _P, _F,
                                 _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "ilqr_open_loop_rollout": [_I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P,
                               _P, _P],
    "ilqr_chain_chunk_steps": [],
    "ilqr_chain_chunk_steps_at": [_I, _I],
    "ilqr_chain_ring_stages": [],
    "ilqr_chain_instances_per_warp": [_I] * 5,
    "ilqr_chain_warps_per_block": [_I] * 5,
    "ilqr_affine_prefix_scan": [_I, _I, _I] + [_P] * 6 + [_P],
    "ilqr_affine_prefix_scan_counters": [_I, _I, _I],
    "ilqr_affine_prefix_scan_scratch": [_I, _I, _I],
    "ilqr_affine_prefix_scan_occupancy": [_I, _I],
    "ilqr_affine_tile_steps": [_I, _I],
    "ilqr_affine_prefix_scan_batched": [_I] * 4 + [_P] * 6 + [_P],
    "ilqr_affine_prefix_scan_batched_counters": [_I] * 4,
    "ilqr_affine_prefix_scan_batched_scratch": [_I] * 4,
    "ilqr_batched_riccati": [_I, _I, _I, _I, _F] + [_P] * 10 + [_P] * 4
                            + [_P],
    "ilqr_batched_riccati_chunk_steps": [],
    "ilqr_batched_riccati_wide_lanes": [_I, _I],
    "ilqr_batched_riccati_wide_pad": [_I, _I],
    "ilqr_batched_riccati_wide_chunk_steps": [],
    "ilqr_linesearch_costs_batched": [_I] * 5 + [_P, _I, _I, _P, _P, _I,
                                               _P, _P, _P, _P, _I, _P, _P],
    "ilqr_closed_loop_rollout_batched": [_I] * 5 + [_P, _I, _I, _P, _P, _P,
                                                  _P, _P, _P, _I, _P, _P, _P,
                                                  _P],
    "ilqr_open_loop_rollout_batched": [_I] * 5 + [_P, _I, _I, _P, _P, _I,
                                                _P, _P, _P],
    "ilqr_suffix_scan": [_I, _I, _I] + [_P] * 5 + [_P] * 2 + [_P] * 5 + [_P],
    "ilqr_suffix_scan_counters": [_I, _I, _I],
    "ilqr_suffix_scan_scratch": [_I, _I, _I],
    "ilqr_suffix_scan_occupancy": [_I, _I],
    "ilqr_suffix_tile_steps": [_I, _I],
    "ilqr_suffix_scan_batched": [_I, _I, _I] + [_P] * 5 + [_P] * 2
                                + [_P] * 5 + [_P],
    "ilqr_suffix_scan_batched_counters": [_I, _I, _I],
    "ilqr_suffix_scan_batched_scratch": [_I, _I, _I],
    "ilqr_cuda_error_string": [_I],
}

# Kernel name -> launches since the last reset (plain integers).
_LAUNCHES: Dict[str, int] = {}
# (kernel, device, stream, sizes) -> (counters, floats): the scratch of the
# look-back kernels (csrc/lookback.cuh).
_SCRATCH: Dict[tuple, tuple] = {}


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a launch.
    torch's own getter (`torch._C._cuda_getCurrentRawStream`, which Triton
    launches with too) skips building a `torch.cuda.Stream` object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device: torch.device):
    """A guard that makes ``device`` the current CUDA device for a launch,
    or a no-op when it already is (the common case costs no device switch
    and back)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def count_launch(kernel: str) -> None:
    _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def scratch(lib, kernel: str, device: torch.device, stream: int,
            *sizes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reusable scratch of a look-back kernel (B1, B3, B6/B7) for this
    device, stream and shape: its counters, int32, sized by the C entry
    ``ilqr_<kernel>_counters(*sizes)`` and zeroed here once (each launch
    leaves them zeroed, so launches on one stream can share them, and other
    streams get their own), and its floats, sized by
    ``ilqr_<kernel>_scratch(*sizes)``.  Per call a wrapper then allocates
    only its outputs."""
    key = (kernel, device, stream, sizes)
    out = _SCRATCH.get(key)
    if out is None:
        n_int = getattr(lib, f"ilqr_{kernel}_counters")(*sizes)
        n_float = getattr(lib, f"ilqr_{kernel}_scratch")(*sizes)
        out = (torch.zeros(n_int, dtype=torch.int32, device=device),
               torch.empty(n_float, dtype=torch.float32, device=device))
        _SCRATCH[key] = out
    return out


@dataclasses.dataclass(frozen=True)
class Kernels:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when the library was already built
    ptxas_log: str         # nvcc -Xptxas -v report of that build


def sources() -> list[Path]:
    """The translation units; headers enter the build through them."""
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes/restype of every entry of a kernel library."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ilqr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.ilqr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _compile(out: Path) -> tuple[float, str]:
    """One nvcc per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out.parent))
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        objs = [work / f"{src.stem}.o" for src in sources()]
        jobs = []
        for src, obj in zip(sources(), objs):
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=CSRC_DIR)))
        # Wait for every compile before raising, so none is left running.
        results = [(cmd, *proc.communicate(), proc.returncode)
                   for cmd, proc in jobs]
        link = [nvcc, *LINK_FLAGS, "-o", str(work / LIB_NAME), *map(str, objs)]
        for cmd, stdout, stderr, code in results:
            if code != 0:
                raise RuntimeError(
                    f"nvcc failed ({code}):\n{' '.join(cmd)}\n"
                    f"{stdout[-4000:]}{stderr[-4000:]}")
        proc = subprocess.run(link, capture_output=True, text=True,
                              cwd=CSRC_DIR)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        log = "".join(o + e for _, o, e, _ in results)
        (out.parent / "ptxas.log").write_text(log)
        os.replace(work / LIB_NAME, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return time.perf_counter() - t0, log


@functools.cache
def load() -> Kernels:
    """The kernel library, built from the checkout's sources at first use."""
    path = BUILD_DIR / source_hash() / LIB_NAME
    seconds, log = 0.0, ""
    if not path.exists():
        seconds, log = _compile(path)
    elif (path.parent / "ptxas.log").exists():
        log = (path.parent / "ptxas.log").read_text()
    return Kernels(bind(ctypes.CDLL(str(path))), path, seconds, log)
