// Centralized closed-loop line search, and the plain rollout of a fleet.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_sweeps.py ::
// forward_pass_pallas (the Pallas program at :276-372), which
// rollout_pallas (:541) reuses with no gains: for every alpha it rolls the
// whole fleet out under u = U + K (x - X) + alpha d (reference
// dpilqr/control.py:95-114) with RK4, each agent under its own model and
// substep count (so fleets that mix Bike5D's one substep with the others'
// five need no routing exception), and accumulates the game cost: the
// stage and terminal reference cost, the masked-agent (1-m) |u|^2 term and
// the pair penalty sum min(0, d - r)^2 over the n_pos_eval components (the
// component and pair masks of pallas_sweeps._pair_constants).  With no
// gains (K = d = nullptr, one alpha) it is the plain rollout of U from x0.
//
// What bounds it on the H100: latency, not bytes or FLOPs.  The two shapes
// it serves have different chains, so each has its own kernels under the one
// entry point:
//
// - WITH gains (the centralized line search: about 10 agents, 10 alphas) a
//   step couples every agent through the gain matvec, so a column is one
//   serial chain of N steps.  It is rollout_column of rollout.cuh, the routine
//   the batched kernel walks, at one problem with K = n slots: a warp per
//   alpha, the step's gain block, d row and nominal rows fetched by cp.async
//   for all the CTA's alphas, lanes over gain rows, agents and pairs, RK4 in
//   registers, one CTA barrier a tile.  Past about 80 Unicycle4D agents in
//   float32 (56 in float64) a step's gain block no longer fits a block's
//   shared memory and comes in tiles of rows (column_launch); past one
//   warp's column beside a 4-row tile (about 1,700 unicycles in float32,
//   850 in float64) the launch returns cudaErrorInvalidValue.
// - WITHOUT gains (the stitched plan's joint cost, the executed trajectory's
//   cost, the public rollout: 10 to 500 agents and more) nothing couples the
//   agents but the cost.  Agent i's trajectory depends on U[:, i] alone, and
//   once X is known every (step, agent) and (step, pair) term is independent.
//   So: (1) rollout_states_kernel, a thread per agent, walks the N RK4 steps
//   in registers (the next step's control is loaded while this one
//   integrates) and writes X; (2) rollout_cost_kernel, a grid of (step, part)
//   CTAs, sums the step's agent terms and its pair terms over 16 x 16 tiles
//   of the upper triangle (no index division, no skipped half but on the
//   diagonal tiles) into one partial each; (3) rollout_sum_kernel adds the
//   parts of a step, then the steps, in index order.  No atomics: J has the
//   same bits in every run.  The three launches share the stream; the
//   wrapper counts them as one launch of this kernel.
//
// Model RHS, RK4 and the quadratic forms: dynamics.cuh, shared with the
// batched forward kernel.
//
// Layouts (contiguous):
//   X (N+1, n, nx) with gains, x0 (n, nx) without; U (N, n, nu),
//   K (N, nuf, nxf), d (N, nuf), alphas (n_alpha), agent_model / agent_nsub
//   (n) int32, agent_dh (n), xf (n, nx), Q / Qf (n, nx, nx), R (n, nu, nu),
//   mask (n), refw / radius / proxw (1), npos_eval (n) int32,
//   work ((N+1) * COST_PARTS_MAX values; used without gains only)
//   -> Xc (n_alpha, N+1, n, nx), Uc (n_alpha, N, n, nu) (with gains only),
//      Jc (n_alpha).

#include "rollout.cuh"

namespace {

constexpr int STATE_THREADS = 32;
constexpr int COST_THREADS = 256, COST_TILE = 16, COST_PARTS_MAX = 32;

template <typename T, int NXC, bool TILES>
__global__ void __launch_bounds__(WARPS_PER_CTA * 32) forward_sweep_kernel(
    const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ Kg, const T* __restrict__ dg,
    const T* __restrict__ alphas, const int* __restrict__ agent_model,
    const int* __restrict__ agent_nsub, const T* __restrict__ agent_dh,
    const T* __restrict__ xf, const T* __restrict__ Q,
    const T* __restrict__ R, const T* __restrict__ Qf,
    const T* __restrict__ mask, const T* __restrict__ refw,
    const T* __restrict__ radius, const T* __restrict__ proxw,
    const int* __restrict__ npos_eval, T* __restrict__ Xc,
    T* __restrict__ Uc, T* __restrict__ Jc, int n, int N, int nx, int nu,
    int n_alpha, int n_buf, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nxf = n * nx, nuf = n * nu;
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // A warp past the last alpha still copies and meets the barriers.
  const bool live = a < n_alpha;
  const ColumnProblem<T> pb = {X,    U,  Kg, dg,   agent_model, agent_nsub,
                               agent_dh, xf, Q,  R,    Qf,          mask,
                               npos_eval, refw[0], radius[0], proxw[0],
                               N,    n,  nx, nu};
  T* Xa = Xc + (size_t)(live ? a : 0) * (N + 1) * nxf;
  if (live)
    for (int i = lane; i < nxf; i += 32) Xa[i] = X[i];
  rollout_column<TILES, NXC>(sm, n_buf, rows, pb, live,
                             live ? alphas[a] : T(0), Xa + nxf,
                             Uc + (size_t)(live ? a : 0) * N * nuf,
                             Jc + (live ? a : 0));
}

// The trajectories of a plain rollout, a thread per agent.
template <typename T, int NXC>
__global__ void __launch_bounds__(STATE_THREADS) rollout_states_kernel(
    const T* __restrict__ x0, const T* __restrict__ U,
    const int* __restrict__ agent_model, const int* __restrict__ agent_nsub,
    const T* __restrict__ agent_dh, T* __restrict__ Xc, int n, int N, int nx,
    int nu) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int model = agent_model[k], nsub = agent_nsub[k];
  const T dh = agent_dh[k];
  T x[NXC], u[MAX_NU], un[MAX_NU];
#pragma unroll
  for (int i = 0; i < NXC; ++i) {
    x[i] = i < nx ? x0[k * nx + i] : T(0);
    if (i < nx) Xc[k * nx + i] = x[i];
  }
#pragma unroll
  for (int j = 0; j < MAX_NU; ++j) un[j] = j < nu && N > 0 ? U[k * nu + j] : T(0);
  for (int t = 0; t < N; ++t) {
#pragma unroll
    for (int j = 0; j < MAX_NU; ++j) {
      u[j] = un[j];
      un[j] = j < nu && t + 1 < N ? U[((size_t)(t + 1) * n + k) * nu + j] : T(0);
    }
    rk4_slot<NXC>(model, nsub, dh, x, u, nx);
    T* row = Xc + ((size_t)(t + 1) * n + k) * nx;
#pragma unroll
    for (int i = 0; i < NXC; ++i)
      if (i < nx) row[i] = x[i];
  }
}

// Sum over the block (blockDim a multiple of 32), warps in index order; the
// result is valid on thread 0.  `red` holds one value per warp.
template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T tot = T(0);
  if (threadIdx.x == 0) {
    tot = red[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) tot += red[i];
  }
  return tot;
}

// Part blockIdx.y of step blockIdx.x's cost: the agents k = part * 256 +
// thread (striding by all parts' threads) and every gridDim.y-th 16 x 16
// tile of the pairs' upper triangle.  Step N is the terminal step.
template <typename T, int NXC>
__global__ void __launch_bounds__(COST_THREADS) rollout_cost_kernel(
    const T* __restrict__ Xc, const T* __restrict__ U,
    const T* __restrict__ xf, const T* __restrict__ Q,
    const T* __restrict__ R, const T* __restrict__ Qf,
    const T* __restrict__ mask, const T* __restrict__ refw,
    const T* __restrict__ radius, const T* __restrict__ proxw,
    const int* __restrict__ npos_eval, T* __restrict__ partial, int n, int N,
    int nx, int nu) {
  __shared__ T red[COST_THREADS / 32];
  const int t = blockIdx.x, part = blockIdx.y, parts = gridDim.y;
  const int tid = threadIdx.x;
  const bool stage = t < N;
  const T* x = Xc + (size_t)t * n * nx;
  const T* W = stage ? Q : Qf;
  const T rw = refw[0], rad = radius[0], pw = proxw[0];

  T rows = T(0);
  for (int k = part * COST_THREADS + tid; k < n; k += parts * COST_THREADS) {
    T e[NXC];
#pragma unroll
    for (int i = 0; i < NXC; ++i)
      e[i] = i < nx ? x[k * nx + i] - xf[k * nx + i] : T(0);
    T q = quadform<NXC>(W + (size_t)k * nx * nx, e, nx);
    T row;
    if (stage) {
      T uk[MAX_NU];
#pragma unroll
      for (int j = 0; j < MAX_NU; ++j)
        uk[j] = j < nu ? U[((size_t)t * n + k) * nu + j] : T(0);
      q = q + quadform<MAX_NU>(R + (size_t)k * nu * nu, uk, nu);
      T uu = uk[0] * uk[0];
#pragma unroll
      for (int j = 1; j < MAX_NU; ++j)
        if (j < nu) uu += uk[j] * uk[j];
      row = rw * mask[k] * q + (T(1) - mask[k]) * uu;
    } else {
      row = rw * mask[k] * q;
    }
    rows += row;
  }

  T pairs = T(0);
  const int tiles = (n + COST_TILE - 1) / COST_TILE;
  const int ty = tid / COST_TILE, tx = tid % COST_TILE;
  int turn = 0;  // tile (bi, bj) belongs to part `turn`
  for (int bi = 0; bi < tiles; ++bi)
    for (int bj = bi; bj < tiles; ++bj) {
      if (turn == part) {
        const int i = bi * COST_TILE + ty, j = bj * COST_TILE + tx;
        if (i < j && j < n) {
          const int nd = npos_eval[i] < npos_eval[j] ? npos_eval[i] : npos_eval[j];
          pairs += pair_penalty(x + (size_t)i * nx, x + (size_t)j * nx, mask[i],
                                mask[j], nd, rad, nx);
        }
      }
      if (++turn == parts) turn = 0;
    }

  const T total = block_sum(rows + pw * pairs, red);
  if (tid == 0) partial[(size_t)t * parts + part] = total;
}

// J = sum over the steps, in order, of each step's parts, in order.
template <typename T>
__global__ void __launch_bounds__(COST_THREADS) rollout_sum_kernel(
    T* __restrict__ partial, T* __restrict__ J, int steps, int parts) {
  for (int t = threadIdx.x; t < steps; t += blockDim.x) {
    T s = partial[(size_t)t * parts];
    for (int p = 1; p < parts; ++p) s += partial[(size_t)t * parts + p];
    partial[(size_t)t * parts] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T tot = partial[0];
    for (int t = 1; t < steps; ++t) tot += partial[(size_t)t * parts];
    J[0] = tot;
  }
}

// The parts a step's cost is split into: about 16 pair tiles a CTA.
inline int cost_parts(int n) {
  const int tiles = (n + COST_TILE - 1) / COST_TILE;
  const int parts = (tiles * (tiles + 1) / 2 + 15) / 16;
  return parts < 1 ? 1 : parts > COST_PARTS_MAX ? COST_PARTS_MAX : parts;
}

template <typename T, int NXC>
int launch_nxc(const T* X, const T* U, const T* Kg, const T* d,
               const T* alphas, const int* agent_model, const int* agent_nsub,
               const T* agent_dh, const T* xf, const T* Q, const T* R,
               const T* Qf, const T* mask, const T* refw, const T* radius,
               const T* proxw, const int* npos_eval, T* Xc, T* Uc, T* Jc,
               T* work, int n, int N, int nx, int nu, int n_alpha,
               int work_size, int max_rows, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (Kg != nullptr) {
    const long long optin = max_shared_optin();
    if (optin < 0) return (int)cudaErrorInvalidDevice;
    const ColumnLaunch cl =
        column_launch(n * nx, n * nu, n_alpha, true, sizeof(T), optin, max_rows);
    if (cl.n_buf == 0 || Uc == nullptr) return (int)cudaErrorInvalidValue;
    auto kernel = cl.rows < n * nu ? forward_sweep_kernel<T, NXC, true>
                                   : forward_sweep_kernel<T, NXC, false>;
    return launch_with_smem(kernel, dim3(cl.chunks), cl.warps * 32, cl.bytes,
                            stream, X, U, Kg, d, alphas, agent_model, agent_nsub,
                            agent_dh, xf, Q, R, Qf, mask, refw, radius, proxw,
                            npos_eval, Xc, Uc, Jc, n, N, nx, nu, n_alpha,
                            cl.n_buf, cl.rows);
  }
  const int parts = cost_parts(n);
  if (n_alpha != 1 || work == nullptr || work_size < (N + 1) * parts)
    return (int)cudaErrorInvalidValue;
  rollout_states_kernel<T, NXC>
      <<<(n + STATE_THREADS - 1) / STATE_THREADS, STATE_THREADS, 0, st>>>(
          X, U, agent_model, agent_nsub, agent_dh, Xc, n, N, nx, nu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rollout_cost_kernel<T, NXC><<<dim3(N + 1, parts), COST_THREADS, 0, st>>>(
      Xc, U, xf, Q, R, Qf, mask, refw, radius, proxw, npos_eval, work, n, N, nx,
      nu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rollout_sum_kernel<T><<<1, COST_THREADS, 0, st>>>(work, Jc, N + 1, parts);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* X, const T* U, const T* Kg, const T* d, const T* alphas,
           const int* agent_model, const int* agent_nsub, const T* agent_dh,
           const T* xf, const T* Q, const T* R, const T* Qf, const T* mask,
           const T* refw, const T* radius, const T* proxw,
           const int* npos_eval, T* Xc, T* Uc, T* Jc, T* work, int n, int N,
           int nx, int nu, int n_alpha, int work_size, int max_rows,
           void* stream) {
  if (nx > MAX_NX || nu > MAX_NU || nx < 1 || nu < 1 || n < 1 || N < 0 ||
      (Kg == nullptr) != (d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_alpha == 0) return 0;
#define DPILQR_SWEEP_NXC(NXC)                                                  \
  return launch_nxc<T, NXC>(X, U, Kg, d, alphas, agent_model, agent_nsub,      \
                            agent_dh, xf, Q, R, Qf, mask, refw, radius, proxw, \
                            npos_eval, Xc, Uc, Jc, work, n, N, nx, nu,         \
                            n_alpha, work_size, max_rows, stream)
  if (nx <= 4) DPILQR_SWEEP_NXC(4);
  if (nx <= 6) DPILQR_SWEEP_NXC(6);
  DPILQR_SWEEP_NXC(MAX_NX);
#undef DPILQR_SWEEP_NXC
}

}  // namespace

#define DPILQR_FORWARD_SWEEP(NAME, T)                                          \
  extern "C" int NAME(                                                         \
      const T* X, const T* U, const T* K, const T* d, const T* alphas,         \
      const int* agent_model, const int* agent_nsub, const T* agent_dh,        \
      const T* xf, const T* Q, const T* R, const T* Qf, const T* mask,         \
      const T* refw, const T* radius, const T* proxw, const int* npos_eval,    \
      T* Xc, T* Uc, T* Jc, T* work, int n, int N, int nx, int nu, int n_alpha, \
      int work_size, int max_rows, void* stream) {                             \
    return launch<T>(X, U, K, d, alphas, agent_model, agent_nsub, agent_dh,    \
                     xf, Q, R, Qf, mask, refw, radius, proxw, npos_eval, Xc,   \
                     Uc, Jc, work, n, N, nx, nu, n_alpha, work_size, max_rows, \
                     stream);                                                  \
  }

DPILQR_FORWARD_SWEEP(dpilqr_forward_sweep_f32, float)
DPILQR_FORWARD_SWEEP(dpilqr_forward_sweep_f64, double)
