"""The look-back kernels (B1, B3, B6/B7) without a GPU.

`csrc/lookback.cuh` carries a value across the tiles of one launch for the
fused backward pass (B1), the affine prefix scan (B3) and the Riccati
suffix scan (B6/B7).  Their wrappers take the counters and scratch from
`_build.scratch`, a cache per device, stream and shape; the first test
drives that cache through each wrapper's `launch` with a stand-in library
on CPU tensors.

The host tests compile the three CUDA sources with g++ against
`MOCK_RUNTIME`, a mock of cuda_runtime.h that runs every CUDA thread as a
pthread, with tiles cut to 32-64 steps and 3 aggregates a look-back stage, so that a few thousand steps cross the tile edges, fold
over several stages and poll over more tiles than a block has threads.  On
CPU tensors each kernel is held to the plain version in f64 within 1e-5 of
each output's max, a repeated call must give the same bits, and the
counters must be back at zero.  They skip where no g++ is found; the card
runs the same sources in chip_smoke.py.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.ops import _build, affine_scan, fused_riccati, \
    parallel_riccati, suffix_scan
from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

torch.set_num_threads(1)

SOURCES = ("fused_riccati.cu", "affine_scan.cu", "suffix_scan.cu")
# Tiles and look-back stages cut so that small inputs span many of them.
SMALL_TILES = {
    "affine_scan.cu": [("kTileSteps = 256;", "kTileSteps = 64;"),
                       ("kStageTiles = 64;", "kStageTiles = 3;")],
    "suffix_scan.cu": [("kSubTile = 256;", "kSubTile = 64;"),
                       ("kLaneTile = 128;", "kLaneTile = 32;"),
                       ("kStageTiles = 64;", "kStageTiles = 3;")],
    "fused_riccati.cu": [("kTileSteps = 256;", "kTileSteps = 32;"),
                         ("kStageTiles = 64;", "kStageTiles = 3;")],
}
RTOL = 1e-5


# ---- the scratch cache, through each wrapper -----------------------------

def _sizes(*dims):
    """A stand-in sizing entry: any count that depends on the shape."""
    return 3 + sum(dims) % 5


class StandInLib:
    """The C entries a look-back wrapper calls: the sizing entries count
    their calls; a launch entry records its counters (read through the
    pointer), its scratch pointer and its stream, then marks the counters,
    which a real kernel leaves zeroed."""

    def __init__(self):
        self.sized = 0
        self.launches = []

    def _size(self, *dims):
        self.sized += 1
        return _sizes(*dims)

    ilqr_fused_riccati_counters = ilqr_fused_riccati_scratch = _size
    ilqr_affine_prefix_scan_counters = ilqr_affine_prefix_scan_scratch = _size
    ilqr_affine_prefix_scan_batched_counters = _size
    ilqr_affine_prefix_scan_batched_scratch = _size
    ilqr_suffix_scan_counters = ilqr_suffix_scan_scratch = _size

    def _launch(self, counters, scratch, dims, stream):
        n = _sizes(*dims)
        words = (ctypes.c_int * n).from_address(counters)
        self.launches.append((counters, scratch, list(words), stream))
        words[0] = 7
        return 0

    def ilqr_fused_riccati(self, n_x, n_u, N, reg, *ptrs):
        return self._launch(ptrs[10], ptrs[11], (n_x, N), ptrs[-1])

    def ilqr_affine_prefix_scan(self, n, A, N, *ptrs):
        return self._launch(ptrs[3], ptrs[4], (n, A, N), ptrs[-1])

    def ilqr_affine_prefix_scan_batched(self, n, A, B, N, *ptrs):
        return self._launch(ptrs[3], ptrs[4], (n, A, B, N), ptrs[-1])

    def ilqr_suffix_scan(self, lane, n_x, M, *ptrs):
        return self._launch(ptrs[5], ptrs[6], (lane, n_x, M), ptrs[-1])


def _call(kernel, lib, size, stream):
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
    if kernel == "fused_riccati":
        n_x, n_u = 4, 2
        exp = itt.TrajectoryExpansion(
            f_x=zeros(size, n_x, n_x), f_u=zeros(size, n_x, n_u),
            l_x=zeros(size, n_x), l_u=zeros(size, n_u),
            l_xx=zeros(size, n_x, n_x), l_ux=zeros(size, n_u, n_x),
            l_uu=zeros(size, n_u, n_u), v_x=zeros(n_x), v_xx=zeros(n_x, n_x))
        return fused_riccati.launch(lib, exp, 0.0, stream)
    if kernel == "affine_prefix_scan":
        return affine_scan.launch(lib, zeros(size, 2, 2), zeros(3, size, 2),
                                  zeros(3, 2), stream)
    if kernel == "affine_prefix_scan_batched":
        return affine_scan.launch_batched(lib, zeros(2, size, 2, 2),
                                          zeros(2, 3, size, 2),
                                          zeros(2, 3, 2), stream)
    elems = RiccatiElement(zeros(size, 2, 2), zeros(size, 2),
                           zeros(size, 2, 2), zeros(size, 2),
                           zeros(size, 2, 2))
    return suffix_scan.launch(lib, elems, "sub", stream)


@pytest.mark.parametrize("kernel", ["fused_riccati", "affine_prefix_scan",
                                    "affine_prefix_scan_batched",
                                    "suffix_scan"])
def test_lookback_scratch_is_zeroed_once_per_device_stream_and_shape(
        kernel, monkeypatch):
    """B1, B3 and B6 take their scratch from `_build.scratch`: counters
    sized by the C sizing entry and zeroed once, reused (not zeroed again)
    for the same device, stream and shape; another stream or shape gets
    scratch of its own, zeroed."""
    monkeypatch.setattr(_build, "_SCRATCH", {})
    lib = StandInLib()
    _call(kernel, lib, 9, stream=11)
    c0, s0, words, stream = lib.launches[-1]
    assert lib.sized == 2 and stream == 11
    assert len(words) == _sizes(*{
        "fused_riccati": (4, 9), "affine_prefix_scan": (2, 3, 9),
        "affine_prefix_scan_batched": (2, 3, 2, 9)}.get(kernel, (0, 2, 9)))
    assert words == [0] * len(words)
    _call(kernel, lib, 9, stream=11)
    c1, s1, words, _ = lib.launches[-1]
    assert (c1, s1) == (c0, s0) and words[0] == 7 and lib.sized == 2
    _call(kernel, lib, 9, stream=12)
    c2, s2, words, stream = lib.launches[-1]
    assert c2 != c0 and s2 != s0 and stream == 12
    assert words == [0] * len(words) and lib.sized == 4
    _call(kernel, lib, 10, stream=11)
    c3, _, words, _ = lib.launches[-1]
    assert c3 not in (c0, c2) and words == [0] * len(words)
    assert len(_build._SCRATCH) == 3


def test_wide_backward_pass_refuses_horizons_past_its_int_offsets():
    """B1w takes N < 2^23 (`kWideMaxN`, int offsets in its gains): the
    wrapper refuses N >= 2^23 at a wide shape with a message that names
    ROADMAP item B1x, where the kernel would answer with a bare launch
    error.  The register form takes that horizon.  (The library's own
    limit is held to WIDE_MAX_N by `test_torch_wide_host.py` on the host
    build and by chip_smoke.py on the card.)"""
    N = fused_riccati.WIDE_MAX_N
    assert N == 1 << 23

    def expansion(n_x, n_u, N):
        # Stride-0 views: the shapes of a long horizon, no memory.
        z = lambda *s: torch.zeros((1,) + s).expand((N,) + s)  # noqa: E731
        return itt.TrajectoryExpansion(
            f_x=z(n_x, n_x), f_u=z(n_x, n_u), l_x=z(n_x), l_u=z(n_u),
            l_xx=z(n_x, n_x), l_ux=z(n_u, n_x), l_uu=z(n_u, n_u),
            v_x=torch.zeros(n_x), v_xx=torch.zeros(n_x, n_x))

    for shape in ((6, 2), (3, 1), (16, 6)):
        with pytest.raises(NotImplementedError,
                           match="N < 2\\^23.*ROADMAP item B1x"):
            fused_riccati._check(expansion(*shape, N))
    # One step shorter passes the horizon check (then fails on the views'
    # layout, which the real inputs do not have), and the register form
    # takes that horizon.
    for shape, n in (((6, 2), N - 1), ((2, 1), N)):
        with pytest.raises(ValueError, match="contiguous"):
            fused_riccati._check(expansion(*shape, n))


# ---- the kernels on a host mock of the runtime ---------------------------

# cuda_runtime.h for a host build: each CUDA thread of a launch runs as a
# pthread, blocks (of a one- or two-dimensional grid) start in order with
# at most MOCK_RESIDENT of them running at once, __syncthreads and
# __syncwarp are std::barriers (a partial mask: one barrier per warp and
# mask, over the mask's lanes), shuffles, ballots and max reductions go
# through a per-warp buffer, and atomics and fences are GCC __atomic
# builtins.  `_rewrite` turns the sources' shared arrays and launches into
# the mock:: forms.
MOCK_RUNTIME = r"""#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <pthread.h>
#include <sched.h>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct __attribute__((aligned(16))) float4 {
  float x, y, z, w;
};
struct __attribute__((aligned(8))) float2 {
  float x, y;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline float2 make_float2(float x, float y) { return {x, y}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

namespace mock {

struct Block {
  explicit Block(int threads, size_t smem)
      : bar(threads), shfl(((threads + 31) / 32) * 32), dyn(smem + 16, 0xff),
        left(threads) {
    for (int w = 0; w * 32 < threads; ++w)
      warp_bars.emplace_back(
          std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<float> shfl;
  std::vector<unsigned char> dyn;   // NaN-filled dynamic shared memory
  std::mutex statics_mutex;
  std::map<int, std::unique_ptr<unsigned char[]>> statics;
  // Barriers of lane groups (__syncwarp with a partial mask), by warp and
  // mask, made at first use under statics_mutex.
  std::map<long, std::unique_ptr<std::barrier<>>> group_bars;
  int left;                          // threads still running
};

struct Thread {
  dim3 tid, bid, bdim, gdim;
  Block* block;
};
inline thread_local Thread ctx;

template <class T>
T* dyn_smem() {
  return reinterpret_cast<T*>(ctx.block->dyn.data());
}

template <class T>
T& block_static(int id) {
  Block* b = ctx.block;
  std::lock_guard<std::mutex> lock(b->statics_mutex);
  auto& slot = b->statics[id];
  if (!slot) {
    slot.reset(new unsigned char[sizeof(T) + 16]);
    std::memset(slot.get(), 0xff, sizeof(T) + 16);
  }
  return *reinterpret_cast<T*>(slot.get());
}

inline int resident() {
  const char* e = std::getenv("MOCK_RESIDENT");
  return e ? std::atoi(e) : (1 << 30);
}

struct Launch {
  std::mutex m;
  std::condition_variable cv;
  int running = 0;
};

template <class F>
struct Arg {
  F* body;
  Block* block;
  Launch* launch;
  dim3 tid, bid, bdim, gdim;
};

template <class F>
void* thread_main(void* p) {
  auto* a = static_cast<Arg<F>*>(p);
  ctx = Thread{a->tid, a->bid, a->bdim, a->gdim, a->block};
  (*a->body)();
  Block* b = a->block;
  b->bar.arrive_and_drop();
  b->warp_bars[a->tid.x / 32]->arrive_and_drop();
  std::lock_guard<std::mutex> lock(a->launch->m);
  if (--b->left == 0) {
    --a->launch->running;
    a->launch->cv.notify_all();
  }
  return nullptr;
}

template <class F>
void launch(dim3 grid, dim3 block, size_t smem, F&& body) {
  using Body = std::remove_reference_t<F>;
  const int nb = grid.x * grid.y, nt = block.x, cap = resident();
  Launch l;
  std::vector<std::unique_ptr<Block>> blocks;
  std::vector<std::unique_ptr<Arg<Body>>> args;
  std::vector<pthread_t> threads;
  pthread_attr_t attr;
  pthread_attr_init(&attr);
  pthread_attr_setstacksize(&attr, 1 << 20);
  for (int b = 0; b < nb; ++b) {
    {
      std::unique_lock<std::mutex> lock(l.m);
      l.cv.wait(lock, [&] { return l.running < cap; });
      ++l.running;
    }
    blocks.emplace_back(std::make_unique<Block>(nt, smem));
    for (int t = 0; t < nt; ++t) {
      args.emplace_back(new Arg<Body>{&body, blocks.back().get(), &l,
                                      dim3(t), dim3(b % grid.x, b / grid.x),
                                      block, grid});
      pthread_t th;
      if (pthread_create(&th, &attr, &thread_main<Body>, args.back().get()))
        std::abort();
      threads.push_back(th);
    }
  }
  for (pthread_t th : threads) pthread_join(th, nullptr);
  pthread_attr_destroy(&attr);
}

}  // namespace mock

#define threadIdx (mock::ctx.tid)
#define blockIdx (mock::ctx.bid)
#define blockDim (mock::ctx.bdim)
#define gridDim (mock::ctx.gdim)

inline void __syncthreads() { mock::ctx.block->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  mock::Block* b = mock::ctx.block;
  const int w = mock::ctx.tid.x / 32;
  if (mask == 0xffffffffu) {
    b->warp_bars[w]->arrive_and_wait();
    return;
  }
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(b->statics_mutex);
    auto& slot = b->group_bars[(long(w) << 32) | mask];
    if (!slot)
      slot = std::make_unique<std::barrier<>>(__builtin_popcount(mask));
    bar = slot.get();
  }
  bar->arrive_and_wait();
}
inline float __shfl_up_sync(unsigned, float v, int d) {
  const int t = mock::ctx.tid.x, lane = t % 32, base = t - lane;
  mock::Block* b = mock::ctx.block;
  b->shfl[t] = v;
  b->warp_bars[t / 32]->arrive_and_wait();
  const float r = lane >= d ? b->shfl[base + lane - d] : v;
  b->warp_bars[t / 32]->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const int t = mock::ctx.tid.x, lane = t % 32, base = t - lane;
  mock::Block* b = mock::ctx.block;
  b->shfl[t] = v;
  b->warp_bars[t / 32]->arrive_and_wait();
  const float r = b->shfl[base + lane / width * width + src % width];
  b->warp_bars[t / 32]->arrive_and_wait();
  return r;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  const int t = mock::ctx.tid.x, lane = t % 32, base = t - lane;
  mock::Block* b = mock::ctx.block;
  std::memcpy(&b->shfl[t], &v, 4);
  b->warp_bars[t / 32]->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) {
    unsigned u;
    std::memcpy(&u, &b->shfl[base + i], 4);
    r = u > r ? u : r;
  }
  b->warp_bars[t / 32]->arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int t = mock::ctx.tid.x, lane = t % 32, base = t - lane;
  mock::Block* b = mock::ctx.block;
  b->shfl[t] = pred ? 1.0f : 0.0f;
  b->warp_bars[t / 32]->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if (b->shfl[base + i] != 0.0f) r |= 1u << i;
  b->warp_bars[t / 32]->arrive_and_wait();
  return r;
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned __float_as_uint(float v) {
  unsigned r;
  std::memcpy(&r, &v, 4);
  return r;
}
inline void __threadfence() {
  __atomic_thread_fence(__ATOMIC_SEQ_CST);
  sched_yield();
}
inline float __ldcg(const float* p) {
  float v;
  __atomic_load(p, &v, __ATOMIC_SEQ_CST);
  return v;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicExch(int* p, int v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > old && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}

template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "mock error"; }
"""


def _rewrite(src: str) -> str:
    """Shared arrays and launches in the mock's forms."""
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
                 r"\1* \2 = mock::dyn_smem<\1>();", src)
    src = re.sub(r"__shared__ ([\w:]+) (\w+);",
                 lambda m: f"{m[1]}& {m[2]} = "
                           f"mock::block_static<{m[1]}>(__LINE__);", src)
    out, i = [], 0
    launch = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(", re.S)
    while (m := launch.search(src, i)) is not None:
        out.append(src[i:m.start()])
        depth, j = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            j += 1
        grid, block, smem, _ = (x.strip() for x in m[2].split(","))
        out.append(f"mock::launch({grid}, {block}, {smem}, [&]() "
                   f"{{ {m[1]}({src[m.end():j - 1]}); }})")
        i = j
    out.append(src[i:])
    return "".join(out)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host mock of the CUDA runtime")
    d = tmp_path_factory.mktemp("lookback_host")
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / "cuda_runtime.h").write_text(MOCK_RUNTIME)
    for name in SOURCES:
        src = (_build.CSRC_DIR / name).read_text()
        for a, b in SMALL_TILES[name]:
            assert a in src, (name, a)
            src = src.replace(a, b)
        (d / f"{name}.cpp").write_text(_rewrite(src))
    (d / "err.cpp").write_text('extern "C" const char* '
                               'ilqr_cuda_error_string(int) { return ""; }\n')
    so = d / "liblookback_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(d), *(str(d / f"{n}.cpp") for n in SOURCES),
                    str(d / "err.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.ilqr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _close(got, ref):
    """Each output within RTOL of its max against the f64 plain version."""
    for g, r in zip(got, ref):
        r = r.double()
        assert g.shape == r.shape
        err = float((g.double() - r).abs().max())
        assert err <= RTOL * max(float(r.abs().max()), 1e-30), err


def _twice(launch):
    """Two calls: equal bits, and every counter back at zero."""
    got, again = launch(), launch()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(int(c.abs().sum()) == 0 for c, _ in _build._SCRATCH.values())
    return got


def _expansion(N, n_x, n_u, seed):
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
    return itt.TrajectoryExpansion(**{
        k: torch.tensor(v, dtype=torch.float32) for k, v in e.items()})


# (N, n, A, blocks resident at once): 64-step tiles; 64 * 65 + 1 steps are
# 66 tiles, two poll rounds of 64 for the last when all run at once.
@pytest.mark.parametrize("N,n,A,resident", [
    (1, 4, 10, 0), (63, 2, 16, 0), (64, 4, 1, 0), (65, 4, 10, 0),
    (5 * 64 + 35, 2, 10, 0), (64 * 65 + 1, 2, 1, 0), (700, 4, 16, 2)])
def test_affine_scan_kernel_on_the_host(host_lib, monkeypatch, N, n, A,
                                        resident):
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    rng = np.random.default_rng(N + n + A)
    P = torch.tensor(0.9 * np.eye(n) + 0.05 * rng.standard_normal((N, n, n)),
                     dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((A, N, n)), dtype=torch.float32)
    d0 = torch.tensor(rng.standard_normal((A, n)), dtype=torch.float32)
    got = _twice(lambda: (affine_scan.launch(host_lib, P, q, d0, 0),))
    ref = itt.affine_prefix_scan_multi(P.double(), q.double(), d0.double())
    _close(got, (ref,))


# (layout, M, n_x, resident): 64-element tiles for 'sub', 32 for 'lane'.
@pytest.mark.parametrize("layout,M,n_x,resident", [
    ("sub", 1, 4, 0), ("sub", 64, 2, 0), ("sub", 5 * 64 + 35, 4, 0),
    ("lane", 31, 2, 0), ("lane", 33, 4, 0), ("lane", 32 * 33 + 1, 2, 0),
    ("sub", 1500, 2, 3)])
def test_suffix_scan_kernel_on_the_host(host_lib, monkeypatch, layout, M,
                                        n_x, resident):
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    elems = parallel_riccati.make_elements(_expansion(M, n_x, 1, M), 0.0)
    elems = RiccatiElement(*(t[:M].contiguous() for t in elems))
    got = _twice(lambda: suffix_scan.launch(host_lib, elems, layout, 0))
    ref = parallel_riccati.suffix_scan(
        RiccatiElement(*(t.double() for t in elems)))
    _close(got, ref)


# (N, n_x, n_u, defects, resident): 32-step tiles over N + 1 elements.
@pytest.mark.parametrize("N,n_x,n_u,defects,resident", [
    (1, 4, 2, False, 0), (30, 2, 1, True, 0), (31, 4, 1, False, 0),
    (5 * 32 + 19, 4, 2, True, 0), (32 * 33, 2, 1, False, 0),
    (1200, 4, 2, True, 3)])
def test_fused_riccati_kernel_on_the_host(host_lib, monkeypatch, N, n_x, n_u,
                                          defects, resident):
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    exp = _expansion(N, n_x, n_u, N)
    d = (torch.tensor(0.01 * np.random.default_rng(N).standard_normal(
        (N, n_x)), dtype=torch.float32) if defects else None)
    got = _twice(lambda: fused_riccati.launch(host_lib, exp, 0.1, 0, d))
    exp64 = itt.TrajectoryExpansion(**{
        k: getattr(exp, k).double() for k in exp.__dataclass_fields__})
    ref = itt.backward_pass_associative(exp64, 0.1,
                                        None if d is None else d.double())
    assert bool(got[3]) and bool(ref[3])
    _close(got[:3], ref[:3])


def _batched_elements(B, M, n_x, seed):
    """B sequences of M elements (seeded, one expansion each), stacked."""
    seqs = []
    for i in range(B):
        el = parallel_riccati.make_elements(
            _expansion(M, n_x, 1, seed + 17 * i), 0.1 * i)
        seqs.append(RiccatiElement(*(t[:M] for t in el)))
    return RiccatiElement(*(torch.stack(f).contiguous() for f in zip(*seqs)))


# (B, M, n_x, resident): 64-element 'sub' tiles, B x n_tiles blocks by
# instance-major tickets; with 2-3 resident a block that polls waits on
# earlier tickets only.
@pytest.mark.parametrize("B,M,n_x,resident", [
    (1, 65, 2, 0), (3, 1, 4, 0), (3, 64, 2, 0), (2, 5 * 64 + 35, 4, 0),
    (5, 130, 2, 3), (4, 64 * 3 + 1, 4, 2), (2, 64 * 65 + 1, 2, 0)])
def test_batched_suffix_scan_kernel_on_the_host(host_lib, monkeypatch, B, M,
                                                n_x, resident):
    """B6's batched entry: one launch for B sequences, each instance's
    outputs equal bit for bit to a single-instance launch on it (the same
    tiles and fold order), held to the plain scan in f64, a repeated
    call bit for bit and the counters back at zero."""
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    elems = _batched_elements(B, M, n_x, M + B)
    got = _twice(lambda: suffix_scan.launch_batched(host_lib, elems, 0))
    ref = parallel_riccati.suffix_scan(
        RiccatiElement(*(t.double() for t in elems)), axis=1)
    _close(got, ref)
    for i in range(B):
        one = suffix_scan.launch(host_lib, RiccatiElement(
            *(t[i].contiguous() for t in elems)), "sub", 0)
        assert all(torch.equal(a[i], b) for a, b in zip(got, one)), i


# (B, N, n, A, resident): 64-step tiles, B x n_tiles blocks by
# instance-major tickets; with 2-3 resident a block that polls waits on
# earlier tickets only.
@pytest.mark.parametrize("B,N,n,A,resident", [
    (1, 65, 4, 10, 0), (3, 1, 2, 1, 0), (3, 64, 4, 16, 0),
    (2, 5 * 64 + 35, 2, 10, 0), (5, 130, 4, 1, 3), (4, 64 * 3 + 1, 2, 16, 2),
    (2, 64 * 65 + 1, 4, 1, 0)])
def test_batched_affine_scan_kernel_on_the_host(host_lib, monkeypatch, B, N,
                                                n, A, resident):
    """B3's batched entry (register form): one launch for B chains, each
    instance's deltas equal bit for bit to a single-instance launch on it,
    held to the plain scan in f64, a repeated call bit for bit and the
    counters back at zero."""
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    rng = np.random.default_rng(B + N + n + A)
    P = torch.tensor(0.9 * np.eye(n)
                     + 0.05 * rng.standard_normal((B, N, n, n)),
                     dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((B, A, N, n)), dtype=torch.float32)
    d0 = torch.tensor(rng.standard_normal((B, A, n)), dtype=torch.float32)
    got = _twice(lambda: (affine_scan.launch_batched(host_lib, P, q, d0, 0),))
    ref = affine_scan.affine_prefix_scan_batched(P.double(), q.double(),
                                                 d0.double())
    _close(got, (ref,))
    for i in range(B):
        one = affine_scan.launch(host_lib, P[i].contiguous(),
                                 q[i].contiguous(), d0[i].contiguous(), 0)
        assert torch.equal(got[0][i], one), i
