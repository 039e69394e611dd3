#!/usr/bin/env python3
"""Run the forward kernels K2 and K4 (``csrc/forward_batched.cu``,
``csrc/forward_sweep.cu`` over ``csrc/rollout.cuh``) on the CPU, for a
rehearsal of an edit to their walk before a chip call.

The sources compile with g++ against a header that emulates what the walk
uses: a CTA's threads are OS threads, ``__syncthreads`` and ``__syncwarp``
are barriers, a shuffle goes through a per-warp buffer, and a ``cp.async``
copy lands at once (default) or only at the thread's next
``__pipeline_wait_prior`` (``EMU_LAZY=1``), so that a buffer refilled too
early, or read before its wait, shows as a wrong result in one mode or the
other; a copy outside the CTA's dynamic shared memory aborts.
``EMU_OPTIN=<bytes>`` lowers the shared memory a block may use (one buffer,
fewer warps a CTA).  Only the gains path of K4 runs right (its plain
rollout's three kernels are not emulated).  Slow: keep shapes small.

    python3 scripts/rollout_emulator.py                # the checks below
    EMU_LAZY=1 EMU_OPTIN=43200 python3 scripts/rollout_emulator.py

Checks: K2 (10 unicycles, K=8, and 16 Quad6D, K=16) against its twin, with tiles forced
(``max_rows``) bit-equal to the whole block; K4 with gains on 100 Unicycle4D
(tiles) against its twin, float64 and float32; K2's tail under its
predicate against the unpredicated launch; the accept kernel
(``csrc/accept_batched.cu``, also compiled here) against
``accept_batched_torch``, bit for bit.
"""

import ctypes
import hashlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import dpilqr_tpu_torch as dtt  # noqa: E402
from dpilqr_tpu_torch.ops import batched as bt  # noqa: E402
from dpilqr_tpu_torch.ops import cuda_build as cb  # noqa: E402
from dpilqr_tpu_torch.ops import ilqr, sweeps  # noqa: E402

HEADER = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cfloat>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max; using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __align__(x)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
typedef int cudaError_t;
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) {
  const char* e = getenv("EMU_OPTIN"); *v = e ? atoi(e) : 232448; return 0; }
template <typename K> int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
struct Block {
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<double> xbuf;
  size_t bytes = 0;
  std::atomic<int> vote{0};
};
inline Block* g_block = nullptr;
inline const bool g_lazy = getenv("EMU_LAZY") != nullptr;
inline void __syncthreads() { g_block->all->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_block->warp[threadIdx.x >> 5]->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  if (p) g_block->vote.store(1);
  g_block->all->arrive_and_wait();
  const int r = g_block->vote.load();
  g_block->all->arrive_and_wait();
  if (threadIdx.x == 0) g_block->vote.store(0);
  g_block->all->arrive_and_wait();
  return r;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dsub_rn(double a, double b) { return a - b; }
template <typename T> T __shfl_xor_sync(unsigned, T v, int o) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  std::memcpy(&g_block->xbuf[w * 32 + lane], &v, sizeof(T));
  g_block->warp[w]->arrive_and_wait();
  T r;
  std::memcpy(&r, &g_block->xbuf[w * 32 + (lane ^ o)], sizeof(T));
  g_block->warp[w]->arrive_and_wait();
  return r;
}
struct Copy { void* d; const void* s; size_t n; };
inline thread_local std::vector<Copy> pending;
namespace { alignas(16) unsigned char smem_raw[1 << 20]; }
static inline void __pipeline_memcpy_async(void* d, const void* s, size_t n) {
  if ((unsigned char*)d < smem_raw || (unsigned char*)d + n > smem_raw + g_block->bytes) {
    fprintf(stderr, "cp.async outside the CTA's shared memory\n"); abort(); }
  if (g_lazy) pending.push_back({d, s, n}); else std::memcpy(d, s, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {
  for (auto& c : pending) std::memcpy(c.d, c.s, c.n);
  pending.clear();
}
template <typename F>
static void emu_run(dim3 blocks, int threads, size_t bytes, F body) {
  blockDim = dim3(threads); gridDim = blocks;
  for (unsigned by = 0; by < blocks.y; ++by)
    for (unsigned bx = 0; bx < blocks.x; ++bx) {
      Block b;
      b.all = std::make_unique<std::barrier<>>(threads);
      for (int w = 0; w < (threads + 31) / 32; ++w)
        b.warp.push_back(std::make_unique<std::barrier<>>(32));
      b.xbuf.assign(threads + 32, 0.0);
      b.bytes = bytes;
      std::memset(smem_raw, 0xff, sizeof(smem_raw));  // NaN where nothing landed
      g_block = &b;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] { threadIdx = dim3(t); blockIdx = dim3(bx, by); body(); pending.clear(); });
      for (auto& t : ts) t.join();
    }
}
"""

SOURCES = ("forward_batched.cu", "forward_sweep.cu", "accept_batched.cu")


def build() -> Path:
    """Compile the sources against the emulation into
    ``_build/host/emu/<hash>/``; returns the library."""
    texts = {p.name: p.read_text() for p in cb.sources()}
    digest = hashlib.sha256((HEADER + "".join(texts.values())).encode()).hexdigest()[:16]
    out = cb.BUILD_DIR / "host" / "emu" / digest
    lib = out / "libemu.so"
    if lib.exists():
        return lib
    src = out / "src"
    src.mkdir(parents=True, exist_ok=True)
    launch = "kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(args...);"
    for name, text in texts.items():
        text = text.replace(launch, "emu_run(blocks, threads, bytes, [&] { kernel(args...); });")
        text = re.sub(r"<<<[^>]*>>>", "", text)  # K4's plain rollout: not emulated
        text = text.replace("#include <cuda_pipeline.h>", '#include "emu.h"')
        text = text.replace("#include <cuda_runtime.h>", "")
        (src / name).write_text(text)
    (src / "emu.h").write_text(HEADER)
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-I", str(src),
                    "-include", str(src / "emu.h"), "-x", "c++",
                    *(str(src / s) for s in SOURCES), "-o", str(lib)], check=True)
    return lib


def install(lib_path: Path) -> ctypes.CDLL:
    """Send the wrappers' K2, K4 and accept launches to the emulated
    library, on CPU tensors."""
    lib = ctypes.CDLL(str(lib_path))
    for base in ("forward_batched", "forward_sweep", "accept_batched"):
        for sfx in cb._DTYPES[base]:
            fn = getattr(lib, f"dpilqr_{base}_{sfx}")
            fn.argtypes, fn.restype = cb._SIGNATURES[base], ctypes.c_int

    def run(b, device):
        err = b.fn(*b.args, None)
        if err:
            raise RuntimeError(f"{b.kernel} kernel failed: error {err}")
        cb.count(b)

    def launch(kernel, dtype, device, *args, library=None):
        run(cb.bind(kernel, dtype, *args, library=library), device)

    cb.load_library = lambda header=None: lib
    for module in (bt, sweeps):
        module.require_cuda = lambda name, t: None
    bt.run = run
    sweeps.launch = launch
    return lib


def close(got, want, dtype):
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    for a, b in zip(got, want):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= tol, (err, tol)


def batch(model, n, K, dtype, S, N=6):
    """A gathered batch of ``S`` subproblems of ``n`` agents of ``model`` on
    a grid at spacing 0.7, its nominal trajectory and the twins' gains."""
    fleet = dtt.homogeneous_fleet(model, n, 0.1)
    side = int(np.ceil(np.sqrt(n)))
    x0 = np.zeros((n, fleet.nx_p))
    x0[:, :2] = np.stack([np.arange(n) % side, np.arange(n) // side], -1) * 0.7
    eye = np.eye(fleet.nx_p)
    cost = dtt.make_game_cost(x0 + 1.0, np.tile(eye, (n, 1, 1)),
                              np.tile(np.eye(fleet.nu_p), (n, 1, 1)),
                              np.tile(10 * eye, (n, 1, 1)), radius=0.5, dtype=dtype,
                              device="cpu")
    U = np.random.default_rng(0).uniform(size=(N, n, fleet.nu_p)) * 0.01
    if model.name == "Quad6D":
        U[..., 0] += 9.80665
    from dpilqr_tpu_torch.parallel.graph import interaction_graph
    from dpilqr_tpu_torch.parallel.subproblems import (gather_controls, gather_cost,
                                                       gather_states, gather_subproblems)
    X = torch.as_tensor(x0, dtype=dtype)[None]
    b = gather_subproblems(interaction_graph(X, 0.5, n_pos=cost.n_pos), K)
    sub = type(cost)(*(a[:S].contiguous() for a in gather_cost(cost, b, dtype)))
    mids = torch.as_tensor(fleet.branch_index_array, dtype=torch.int32)[b.member_idx][:S]
    x0_s = gather_states(X[0], b)[:S].contiguous()
    U_s = gather_controls(torch.as_tensor(U, dtype=dtype), b)[:S].contiguous()
    carry = bt.init_batch_carry(fleet, dtt.SolverConfig(), sub, x0_s, U_s, mids.contiguous(),
                                torch.ones(S, dtype=torch.bool), "torch")
    Kg, d = bt.backward_pass_batched(fleet, sub, mids.contiguous(), carry.X, carry.U,
                                     torch.ones(S, dtype=dtype), "torch")
    return fleet, sub, mids.contiguous(), carry, Kg, d


def main():
    install(build())
    for model, n, K, S in ((dtt.UNICYCLE_4D, 10, 8, 3), (dtt.QUAD_6D, 16, 16, 2)):
        for dtype in (torch.float64, torch.float32):
            fleet, sub, mids, carry, Kg, d = batch(model, n, K, dtype, S)
            for n_alpha in (2, 10):
                fa = (fleet, sub, mids, carry.X, carry.U, Kg, d,
                      ilqr.line_search_alphas(n_alpha, dtype))
                whole = bt.forward_pass_batched_cuda(*fa)
                close(whole, bt.forward_pass_batched_torch(*fa), dtype)
                for rows in (4, 8):
                    tiles = bt.forward_pass_batched_cuda(*fa, max_rows=rows)
                    assert all(torch.equal(a, b) for a, b in zip(tiles, whole))
            print(f"K2 {model.name} K={K} {str(dtype)[6:]}: the twin's values, "
                  "tiles with the whole block's bits", flush=True)
    for dtype in (torch.float64, torch.float32):
        n, N = 100, 4
        fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
        x0 = np.zeros((n, 4))
        x0[:, :2] = np.stack([np.arange(n) % 10, np.arange(n) // 10], -1) * 1.25
        cost = dtt.make_game_cost(x0 + 1.0, np.tile(np.eye(4), (n, 1, 1)),
                                  np.tile(np.eye(2), (n, 1, 1)), np.tile(10 * np.eye(4), (n, 1, 1)),
                                  radius=0.5, dtype=dtype, device="cpu")
        U = torch.as_tensor(np.random.default_rng(1).uniform(size=(N, n, 2)) * 0.1, dtype=dtype)
        X = ilqr._rollout_fn(fleet.step, cost, torch.as_tensor(x0, dtype=dtype), U)[0]
        Kb, db = ilqr._backward_pass(fleet.linearize, cost, X, U, torch.tensor(1.0, dtype=dtype))
        fw = (cost, X, U, Kb, db, ilqr.line_search_alphas(10, dtype))
        close(sweeps.forward_pass_cuda(fleet, *fw), ilqr._forward_pass(fleet.step, *fw), dtype)
        plan = tuple(cb.forward_plan(n, 4, 2, 10, X.element_size(),
                                     limit=int(os.environ.get("EMU_OPTIN", cb.SMEM_LIMIT))))
        print(f"K4 100 Unicycle4D {str(dtype)[6:]} (chunks, warps, buffers, rows, bytes) "
              f"{plan}: the twin's values", flush=True)
    tail_checks()
    accept_checks()
    print("ok")


def tail_checks():
    """K2's tail under its predicate: the unpredicated launch's bits where
    some active subproblem improved at no probe alpha, J = +inf and nothing
    else where none needs the tail."""
    for dtype in (torch.float64, torch.float32):
        fleet, sub, mids, carry, Kg, d = batch(dtt.UNICYCLE_4D, 10, 8, dtype, 3)
        alphas = ilqr.line_search_alphas(10, dtype)
        fa = (fleet, sub, mids, carry.X, carry.U, Kg, d)
        J_probe = bt.forward_pass_batched_cuda(*fa, alphas[:2])[2]
        plain = bt.forward_pass_batched_cuda(*fa, alphas[2:])
        active = torch.tensor([True, False, True])
        need = J_probe.min(0).values.clone()  # subproblem 2 improves at no probe alpha
        need[0] = float("inf")
        got = bt.forward_pass_batched_cuda(*fa, alphas[2:], tail=(J_probe, need, active))
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
        skip = torch.full((3,), float("inf"), dtype=dtype)
        got = bt.forward_pass_batched_cuda(*fa, alphas[2:], tail=(J_probe, skip, active))
        assert bool(torch.isinf(got[2]).all())
        print(f"K2 tail {str(dtype)[6:]}: the unpredicated bits, J = inf when skipped",
              flush=True)


def accept_checks():
    """The accept kernel against ``accept_batched_torch``, bit for bit, on a
    random carry (a tail needed or not, both ``on_failed_ls`` modes,
    ``mu_floor``, inactive lanes)."""
    rng = np.random.default_rng(4)
    S, N, K, nx, nu, n_alpha = 7, 5, 3, 4, 2, 6
    for dtype in (torch.float64, torch.float32):
        for mode in ("bail", "increase"):
            for mu_floor in (False, True):
                cfg = dtt.SolverConfig(on_failed_ls=mode, mu_floor=mu_floor, tol=0.05,
                                       n_lqr_iter=4, mu_max=2.0)

                def t(a, dt=dtype):
                    return torch.as_tensor(a).to(dt)

                X5 = t(rng.standard_normal((n_alpha, S, N, K, nx)))
                U5 = t(rng.standard_normal((n_alpha, S, N, K, nu)))
                J_c = t(rng.uniform(0.5, 1.5, (n_alpha, S)))
                J_c[:, 1] = float("inf")  # no improving alpha
                x0 = t(rng.standard_normal((S, K, nx)))
                carry = bt.BatchCarry(
                    X=t(rng.standard_normal((S, N + 1, K, nx))),
                    U=t(rng.standard_normal((S, N, K, nu))),
                    J=t(rng.uniform(0.9, 1.1, S)), mu=t(rng.choice([1e-7, 0.5, 1.5], S)),
                    delta=t(rng.choice([0.25, 1.0, 4.0], S)),
                    i=t(rng.integers(0, 4, S), torch.int32),
                    converged=torch.zeros(S, dtype=torch.bool),
                    failed=torch.zeros(S, dtype=torch.bool),
                    active=t(rng.uniform(size=S) < 0.8, torch.bool))
                inv = bt._inverse(bt.COLUMN_ORDER)
                outs = []
                for fn in (bt.accept_batched_cuda, bt.accept_batched_torch):
                    c = bt.BatchCarry(*(a.clone() for a in carry))
                    counter = torch.zeros(2, dtype=torch.int32)
                    fn(cfg, X5.permute(inv), U5.permute(inv), J_c, x0, c, counter)
                    outs.append((c, counter))
                (got, n_got), (want, n_want) = outs
                for name, a, b in zip(bt.BatchCarry._fields, got, want):
                    assert torch.equal(a, b), (name, mode, mu_floor, dtype)
                assert torch.equal(n_got, n_want), (n_got, n_want)
        print(f"accept {str(dtype)[6:]}: the torch version's bits", flush=True)


if __name__ == "__main__":
    main()
