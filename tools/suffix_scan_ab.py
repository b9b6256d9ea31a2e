"""Time B6's single-instance entry across trees of `csrc/`, in turns on one
card.

Each named directory's `suffix_scan.cu` (with the headers beside it) is
built alone into a small library, and the entry `ilqr_suffix_scan` of each
is timed at the solvers' shapes (pendulum n = 2, M = 301 and 32769; the
double pendulum's n = 4, M = 151; the flight's n = 12, M = 151) by
`chip_smoke.queued_us` (CUDA events around 20 calls queued behind a spin
kernel), in the order A B ... B A, three rounds, on seeded elements.  It
prints the median µs a call of each tree and whether each tree's outputs
equal the first's bit for bit.  Run from the repository root on a machine
with an H100, naming the trees to compare, e.g. the working tree against a
`git archive` of its parent unpacked under `_scratch/` (git-ignored):

    python3 tools/suffix_scan_ab.py \\
        parent=_scratch/parent/ilqr_tpu_torch/csrc tree=ilqr_tpu_torch/csrc
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import ilqr_tpu_torch as itt  # noqa: E402
from ilqr_tpu_torch.ops import _build, suffix_scan  # noqa: E402
from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement  # noqa: E402

CASES = {"n2 M301": (2, 301), "n4 M151": (4, 151), "n12 M151": (12, 151),
         "n2 M32769": (2, 32769)}
ENTRIES = ("ilqr_suffix_scan", "ilqr_suffix_scan_counters",
           "ilqr_suffix_scan_scratch", "ilqr_cuda_error_string")
ERR = ('#include <cuda_runtime.h>\nextern "C" const char* '
       'ilqr_cuda_error_string(int c) { return cudaGetErrorString('
       '(cudaError_t)c); }\n')


def build(trees: dict, work: Path) -> dict:
    """One library per tree, the nvcc processes started together."""
    (work / "err.cu").write_text(ERR)
    flags = [f for f in _build.COMPILE_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {}
    for name, csrc in trees.items():
        out = work / f"{name}.so"
        cmd = [_build.nvcc_path(), *flags, "-shared", "-o", str(out),
               str(Path(csrc) / "suffix_scan.cu"), str(work / "err.cu")]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(out))
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        lib.ilqr_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main(argv) -> int:
    trees = dict(a.split("=", 1) for a in argv)
    if len(trees) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    stream = _build.current_stream(dev)
    with tempfile.TemporaryDirectory() as work:
        libs = build(trees, Path(work))
        order = list(libs) + list(libs)[::-1]
        print(cs.nvidia_smi())
        for label, (n, M) in CASES.items():
            el = cs.b6b_elements(itt, 1, M, n, 3 + n, f32, terminal=True)
            el = RiccatiElement(*(t[0].contiguous() for t in el))
            outs, times = {}, {name: [] for name in libs}
            for name, lib in libs.items():
                _build._SCRATCH.clear()
                outs[name] = suffix_scan.launch(lib, el, "sub", stream)
            torch.cuda.synchronize()
            first = next(iter(outs.values()))
            same = {name: all(torch.equal(a, b) for a, b in zip(out, first))
                    for name, out in outs.items()}
            for _ in range(3):
                for name in order:
                    # Each library sizes its own scratch.
                    _build._SCRATCH.clear()

                    def call(lib=libs[name]):
                        return suffix_scan.launch(lib, el, "sub", stream)

                    call()
                    torch.cuda.synchronize()
                    us = cs.queued_us(call)
                    if us is not None:
                        times[name].append(us)
            print(f"B6 {label}: median µs a call "
                  + ", ".join(f"{name} {np.median(v):.3f}" if v else
                              f"{name} not measured"
                              for name, v in times.items())
                  + f"; bits equal to {next(iter(libs))}'s: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
