// One closed-loop rollout column, walked by one warp: the routine shared by
// the batched line-search kernel (forward_batched.cu: a CTA per subproblem)
// and the centralized one (forward_sweep.cu: one problem, K = n agents).
//
// A column is one (problem, alpha) pair: N steps of u = U + Kg (x - X) +
// alpha d (reference dpilqr/control.py:95-114), RK4 under each slot's own
// substep table, and the game cost accumulated step by step.  With no gains
// (Kg = d = nullptr) it is the plain rollout of U.
//
// What the routine does about the chain's latency:
//
// - the column's x, dx = x - X and u live in shared memory, sized at launch
//   from K, nx, nu and the warps of the CTA (column_values): no per-thread
//   array has a flat width, so the only width limit is the shared memory a
//   block may use;
// - a step's gain block, d row and nominal X and U rows are staged once per
//   CTA with 16-byte asynchronous copies (cp.async) and shared by all its
//   warps; step t+1 is in flight while step t computes (two stages; one
//   where two do not fit).  One __syncthreads() a step;
// - lanes split a step's work: the gain rows' dot products run over lanes
//   (dx element i on lane i mod 32, a butterfly of shuffles per row, four
//   rows in flight), slots run over lanes for RK4 and the quadratic forms,
//   pairs over lanes for the proximity term, and the step's cost is one
//   warp sum.  So J and the gain products add in another order than a
//   serial loop (float64 agrees with the plain version to ~1e-13);
// - a slot integrates in registers (dynamics.cuh: arrays of the
//   compile-time width NXC); mixed fleets diverge on the model switch only
//   inside a warp;
// - every output row is written from shared memory by neighbouring lanes to
//   neighbouring addresses.
//
// Every warp of the CTA calls rollout_column, live or not: the copies and
// the barriers are the CTA's.

#pragma once

#include "dynamics.cuh"
#include "launch.cuh"

namespace {

constexpr int WARPS_PER_CTA = 8;
constexpr unsigned FULL = 0xffffffffu;

// Sum over the warp, the same bits on every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The values of one stage (gain block, d row, nominal U row, nominal X row)
// and of one column's x, dx, u.  Mirrored by forward_smem_bytes in
// dpilqr_tpu_torch/ops/batched.py.
__host__ __device__ inline size_t stage_values(int nxf, int nuf) {
  return pad4((size_t)nuf * nxf) + 2 * pad4(nuf) + pad4(nxf);
}
__host__ __device__ inline size_t column_values(int nxf, int nuf) {
  return 2 * pad4(nxf) + pad4(nuf);
}

// How n_alpha columns of one problem are laid over CTAs: `chunks` CTAs of
// `warps` warps each, `n_stage` stages of `bytes` dynamic shared memory in
// all; n_stage 0 where not even one stage fits `optin` bytes.
struct ColumnLaunch {
  int chunks, warps, n_stage;
  size_t bytes;
};

inline ColumnLaunch column_launch(int nxf, int nuf, int n_alpha, bool gains,
                                  size_t itemsize, long long optin) {
  const int chunks = (n_alpha + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
  const int warps = chunks ? (n_alpha + chunks - 1) / chunks : 0;
  const size_t stage = gains ? stage_values(nxf, nuf) : 0;
  const size_t cols = warps * column_values(nxf, nuf);
  for (int n_stage = 2; n_stage >= 1; --n_stage) {
    const size_t bytes = (n_stage * stage + cols) * itemsize;
    if (optin >= 0 && bytes <= (size_t)optin) return {chunks, warps, n_stage, bytes};
  }
  return {chunks, warps, 0, 0};
}

// This lane's share of the cost at state x (and control u, or nullptr at
// the terminal step): slots lane, lane + 32, ... and pairs likewise.
template <int NXC, typename T>
__device__ __forceinline__ T cost_share(
    const T* x, const T* u, const T* xf, const T* W, const T* R, const T* mask,
    const int* npos, T rw, T rad, T pw, int K, int nx, int nu, int lane) {
  T part = T(0);
  for (int k = lane; k < K; k += 32) {
    T e[NXC];
#pragma unroll
    for (int i = 0; i < NXC; ++i)
      e[i] = i < nx ? x[k * nx + i] - xf[k * nx + i] : T(0);
    T q = quadform<NXC>(W + (size_t)k * nx * nx, e, nx);
    T row;
    if (u != nullptr) {
      const T* uk = u + k * nu;
      q = q + quadform<MAX_NU>(R + (size_t)k * nu * nu, uk, nu);
      T uu = uk[0] * uk[0];
#pragma unroll
      for (int j = 1; j < MAX_NU; ++j)
        if (j < nu) uu += uk[j] * uk[j];
      row = rw * mask[k] * q + (T(1) - mask[k]) * uu;
    } else {
      row = rw * mask[k] * q;
    }
    part += row;
  }
  T pp = T(0);
  for (int idx = lane; idx < K * K; idx += 32) {
    const int i = idx / K, j = idx % K;
    if (j <= i) continue;
    const int nd = npos[i] < npos[j] ? npos[i] : npos[j];
    pp += pair_penalty(x + i * nx, x + j * nx, mask[i], mask[j], nd, rad, nx);
  }
  return part + pw * pp;
}

// One problem as a column sees it (contiguous, time-major):
//   X (N+1, K, nx), U (N, K, nu), Kg (N, nuf, nxf), d (N, nuf) or both
//   nullptr, model / nsub (K) int32, dh (K), xf (K, nx), Q / Qf (K, nx, nx),
//   R (K, nu, nu), mask (K), npos (K) int32, the three cost scalars.
template <typename T>
struct ColumnProblem {
  const T *X, *U, *Kg, *d;
  const int *model, *nsub;
  const T *dh, *xf, *Q, *R, *Qf, *mask;
  const int* npos;
  T rw, rad, pw;
  int N, K, nx, nu;
};

// Walk one column: `sm` is the CTA's dynamic shared memory (n_stage stages,
// then a column_values block per warp), `live` whether this warp has a
// column, Xo (N, K, nx) its states 1..N, Uo (N, K, nu) its controls, Jo its
// cost.
template <int NXC, typename T>
__device__ __forceinline__ void rollout_column(
    T* sm, int n_stage, const ColumnProblem<T>& pb, bool live, T alpha,
    T* __restrict__ Xo, T* __restrict__ Uo, T* __restrict__ Jo) {
  const int N = pb.N, K = pb.K, nx = pb.nx, nu = pb.nu;
  const int nxf = K * nx, nuf = K * nu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool gains = pb.Kg != nullptr;

  const size_t stage_sz = gains ? stage_values(nxf, nuf) : 0;
  const size_t g_off = pad4((size_t)nuf * nxf), v_off = pad4(nuf);
  T* x = sm + n_stage * stage_sz + warp * column_values(nxf, nuf);
  T* dx = x + pad4(nxf);
  T* u = dx + pad4(nxf);

  // Stage t: [gain block | d row | nominal U row | nominal X row].
  auto fetch = [&](int t, T* st) {
    copy_async(st, pb.Kg + (size_t)t * nuf * nxf, nuf * nxf);
    copy_async(st + g_off, pb.d + (size_t)t * nuf, nuf);
    copy_async(st + g_off + v_off, pb.U + (size_t)t * nuf, nuf);
    copy_async(st + g_off + 2 * v_off, pb.X + (size_t)t * nxf, nxf);
    __pipeline_commit();
  };

  for (int i = lane; i < nxf; i += 32) x[i] = pb.X[i];
  if (gains && n_stage == 2 && N > 0) fetch(0, sm);
  __syncwarp();

  T Jacc = T(0);
  for (int t = 0; t < N; ++t) {
    if (gains) {
      T* st;
      if (n_stage == 2) {
        // Stage t has landed for every thread, and every warp is done with
        // the buffer step t - 1 read: refill it with step t + 1.
        __pipeline_wait_prior(0);
        __syncthreads();
        st = sm + (t & 1) * stage_sz;
        if (t + 1 < N) fetch(t + 1, sm + ((t + 1) & 1) * stage_sz);
      } else {
        __syncthreads();
        st = sm;
        fetch(t, st);
        __pipeline_wait_prior(0);
        __syncthreads();
      }
      if (live) {
        const T* G = st;
        const T* dt = st + g_off;
        const T* Un = st + g_off + v_off;
        const T* Xn = st + g_off + 2 * v_off;
        for (int i = lane; i < nxf; i += 32) dx[i] = x[i] - Xn[i];
        __syncwarp();
        // Closed-loop controls, four gain rows in flight.
        for (int r0 = 0; r0 < nuf; r0 += 4) {
          T p[4] = {T(0), T(0), T(0), T(0)};
          for (int i = lane; i < nxf; i += 32) {
            const T dxi = dx[i];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (r0 + q < nuf) p[q] += G[(size_t)(r0 + q) * nxf + i] * dxi;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const T du = warp_sum(p[q]);
            const int r = r0 + q;
            if (r < nuf && lane == q) u[r] = Un[r] + du + alpha * dt[r];
          }
        }
      }
    } else if (live) {
      for (int r = lane; r < nuf; r += 32) u[r] = pb.U[(size_t)t * nuf + r];
    }
    if (live) {
      __syncwarp();
      for (int r = lane; r < nuf; r += 32) Uo[(size_t)t * nuf + r] = u[r];

      // Stage cost at (x_t, u_t).
      Jacc = Jacc + warp_sum(cost_share<NXC>(x, u, pb.xf, pb.Q, pb.R, pb.mask,
                                             pb.npos, pb.rw, pb.rad, pb.pw, K,
                                             nx, nu, lane));
      __syncwarp();

      // RK4 with the slot's own substep schedule, a slot a lane.
      for (int k = lane; k < K; k += 32)
        rk4_slot<NXC>(pb.model[k], pb.nsub[k], pb.dh[k], x + k * nx, u + k * nu, nx);
      __syncwarp();
      for (int i = lane; i < nxf; i += 32) Xo[(size_t)t * nxf + i] = x[i];
    }
  }

  if (live) {
    const T term = warp_sum(cost_share<NXC>(x, (const T*)nullptr, pb.xf, pb.Qf,
                                            pb.R, pb.mask, pb.npos, pb.rw,
                                            pb.rad, pb.pw, K, nx, nu, lane));
    if (lane == 0) *Jo = Jacc + term;
  }
}

}  // namespace
