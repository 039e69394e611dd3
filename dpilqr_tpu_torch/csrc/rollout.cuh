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
//   array has a flat width.  Where the columns of all the CTA's warps do
//   not fit beside a 4-row tile of gains (below), a CTA takes fewer warps;
//   the only width limit is one warp's column beside one such tile in the
//   shared memory a block may use;
// - a step's gain block, d row and nominal X and U rows are fetched into
//   shared memory with 16-byte asynchronous copies (cp.async) and shared by
//   all the CTA's warps.  The block comes in tiles of `rows` consecutive
//   rows, each one contiguous range of the (.., nuf, nxf) layout: a tile of
//   all nuf rows (a "stage", the whole block) where one fits, else tiles of
//   a multiple of 4 rows.  Tile g + 1 is in flight while tile g computes
//   (two buffers, one __syncthreads() a tile; one buffer and two barriers
//   where two do not fit).  A step's d, U and X rows come with its first
//   tile.  Reading the block straight from L2 instead would have each of a
//   CTA's alpha warps fetch all of it;
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
#include "plan.h"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Sum over the warp, the same bits on every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
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

// Walk one column: `sm` is the CTA's dynamic shared memory (with gains
// n_buf tile buffers of `rows` gain rows, then n_buf buffers of a step's
// rows; then a column_values block per warp), `live` whether this warp has
// a column, Xo (N, K, nx) its states 1..N, Uo (N, K, nu) its controls, Jo
// its cost.  A tile adds in the order of the whole block: rows start at
// multiples of 4, so the same four rows are in flight together and every
// row's sum runs over the same lanes; the placement changes no bit.
// TILES false is the whole block a buffer (rows = nuf), compiled without
// the tile loop.
template <bool TILES, int NXC, typename T>
__device__ __forceinline__ void rollout_column(
    T* sm, int n_buf, int rows, const ColumnProblem<T>& pb, bool live,
    T alpha, T* __restrict__ Xo, T* __restrict__ Uo, T* __restrict__ Jo) {
  const int N = pb.N, K = pb.K, nx = pb.nx, nu = pb.nu;
  const int nxf = K * nx, nuf = K * nu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool gains = pb.Kg != nullptr;

  const size_t tile_sz = gains ? tile_values(rows, nxf) : 0;
  const size_t rows_sz = gains ? row_values(nxf, nuf) : 0;
  const size_t v_off = pad4(nuf);
  const int n_tiles = TILES ? (nuf + rows - 1) / rows : 1;
  const int mask = n_buf - 1;  // buffer of tile g: g & mask (n_buf 1 or 2)
  T* rowbuf = sm + n_buf * tile_sz;
  T* x = rowbuf + n_buf * rows_sz + warp * column_values(nxf, nuf);
  T* dx = x + pad4(nxf);
  T* u = dx + pad4(nxf);

  // Tile j of step t (tile g = t n_tiles + j of the walk): rows j rows ..
  // of step t's gain block, into buffer g & mask; a step's first tile
  // brings its [d | U | X] rows into row buffer t & mask.
  auto fetch = [&](int t, int j) {
    const int r0 = TILES ? j * rows : 0, nr = TILES ? min(rows, nuf - r0) : nuf;
    copy_async(sm + ((TILES ? t * n_tiles + j : t) & mask) * tile_sz,
               pb.Kg + ((size_t)t * nuf + r0) * nxf, nr * nxf);
    if (j == 0) {
      T* rb = rowbuf + (t & mask) * rows_sz;
      copy_async(rb, pb.d + (size_t)t * nuf, nuf);
      copy_async(rb + v_off, pb.U + (size_t)t * nuf, nuf);
      copy_async(rb + 2 * v_off, pb.X + (size_t)t * nxf, nxf);
    }
    __pipeline_commit();
  };

  for (int i = lane; i < nxf; i += 32) x[i] = pb.X[i];
  if (gains && n_buf == 2 && N > 0) fetch(0, 0);
  __syncwarp();

  T Jacc = T(0);
  for (int t = 0; t < N; ++t) {
    if (gains) {
      const T* dt = rowbuf + (t & mask) * rows_sz;
      const T* Un = dt + v_off;
      const T* Xn = dt + 2 * v_off;
      for (int j = 0; j < n_tiles; ++j) {
        if (n_buf == 2) {
          // Tile g has landed for every thread, and every warp is done
          // with the buffers tile g - 1 and step t - 1 read: refill them.
          __pipeline_wait_prior(0);
          __syncthreads();
          if (TILES && j + 1 < n_tiles)
            fetch(t, j + 1);
          else if (t + 1 < N)
            fetch(t + 1, 0);
        } else {
          __syncthreads();
          fetch(t, j);
          __pipeline_wait_prior(0);
          __syncthreads();
        }
        if (!live) continue;
        const T* G = sm + ((TILES ? t * n_tiles + j : t) & mask) * tile_sz;
        const int r0 = TILES ? j * rows : 0;  // G holds rows r0 .. r1 - 1
        const int r1 = TILES ? min(r0 + rows, nuf) : nuf;
        if (j == 0) {
          for (int i = lane; i < nxf; i += 32) dx[i] = x[i] - Xn[i];
          __syncwarp();
        }
        // Closed-loop controls, four gain rows in flight.
        for (int rr = r0; rr < r1; rr += 4) {
          T p[4] = {T(0), T(0), T(0), T(0)};
          for (int i = lane; i < nxf; i += 32) {
            const T dxi = dx[i];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (rr + q < r1) p[q] += G[(size_t)(rr - r0 + q) * nxf + i] * dxi;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const T du = warp_sum(p[q]);
            const int r = rr + q;
            if (r < r1 && lane == q) u[r] = Un[r] + du + alpha * dt[r];
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
