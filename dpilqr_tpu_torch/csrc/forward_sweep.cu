// Centralized closed-loop line search: one iLQR problem, all alphas.
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
// gains (K = d = nullptr, one alpha) it is the plain rollout of U.
//
// What bounds it on the H100: a serial chain of N steps, each a gain
// matvec (nuf x nxf), n RK4 integrations and n(n-1)/2 pair distances;
// tiny data (the gains stream once, nuf nxf values a step).  Latency-bound.
// Design: one CTA per alpha (the alphas are independent), with the fleet
// state, dx and u in shared memory; the gain product K_t dx is a CTA matvec
// (one thread per control row), RK4 runs one thread per agent, and the cost
// is a per-thread partial over agents and pairs folded by a warp-shuffle
// block reduction.  Three barriers a step.
//
// Layouts (contiguous):
//   X (N+1, n, nx), U (N, n, nu), K (N, nuf, nxf), d (N, nuf), alphas
//   (n_alpha), agent_model / agent_nsub (n) int32, agent_dh (n),
//   xf (n, nx), Q / Qf (n, nx, nx), R (n, nu, nu), mask (n),
//   refw / radius / proxw (1), npos_eval (n) int32
//   -> Xc (n_alpha, N+1, n, nx), Uc (n_alpha, N, n, nu), Jc (n_alpha).

#include "dynamics.cuh"

namespace {

// Sum over the block (blockDim a multiple of 32); the result is valid on
// thread 0.  `red` holds one value per warp.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T tot = T(0);
  if (threadIdx.x == 0) {
    tot = red[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) tot += red[i];
  }
  __syncthreads();
  return tot;
}

// This thread's share of the cost at state x (and control u, or nullptr at
// the terminal step): agents k = tid, tid + nth, ... and pairs likewise.
template <typename T>
__device__ T cost_share(const T* x, const T* u, const T* xf, const T* W,
                        const T* R, const T* mask, const int* npos, T rw,
                        T rad, T pw, int n, int nx, int nu) {
  const int tid = threadIdx.x, nth = blockDim.x;
  T part = T(0);
  for (int k = tid; k < n; k += nth) {
    T e[MAX_NX];
    for (int i = 0; i < nx; ++i) e[i] = x[k * nx + i] - xf[k * nx + i];
    T q = quadform(W + (size_t)k * nx * nx, e, nx);
    T row;
    if (u != nullptr) {
      const T* uk = u + k * nu;
      q = q + quadform(R + (size_t)k * nu * nu, uk, nu);
      T uu = uk[0] * uk[0];
      for (int j = 1; j < nu; ++j) uu += uk[j] * uk[j];
      row = rw * mask[k] * q + (T(1) - mask[k]) * uu;
    } else {
      row = rw * mask[k] * q;
    }
    part += row;
  }
  T pp = T(0);
  for (int idx = tid; idx < n * n; idx += nth) {
    const int i = idx / n, j = idx % n;
    if (j <= i) continue;
    const int nd = npos[i] < npos[j] ? npos[i] : npos[j];
    pp += pair_penalty(x + i * nx, x + j * nx, mask[i], mask[j], nd, rad, nx);
  }
  return part + pw * pp;
}

constexpr int MAX_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) forward_sweep_kernel(
    const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ Kg, const T* __restrict__ dg,
    const T* __restrict__ alphas, const int* __restrict__ agent_model,
    const int* __restrict__ agent_nsub, const T* __restrict__ agent_dh,
    const T* __restrict__ xf, const T* __restrict__ Q,
    const T* __restrict__ R, const T* __restrict__ Qf,
    const T* __restrict__ mask, const T* __restrict__ refw,
    const T* __restrict__ radius, const T* __restrict__ proxw,
    const int* __restrict__ npos_eval, T* __restrict__ Xc,
    T* __restrict__ Uc, T* __restrict__ Jc, int n, int N, int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nxf = n * nx, nuf = n * nu;
  T* x = reinterpret_cast<T*>(smem_raw);
  T* dx = x + nxf;
  T* u = dx + nxf;
  T* red = u + nuf;
  const int a = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const T alpha = alphas[a];
  const T rw = refw[0], rad = radius[0], pw = proxw[0];
  T* Xa = Xc + (size_t)a * (N + 1) * nxf;
  T* Ua = Uc + (size_t)a * N * nuf;

  for (int i = tid; i < nxf; i += nth) {
    x[i] = X[i];
    Xa[i] = X[i];
  }
  __syncthreads();
  T Jacc = T(0);
  for (int t = 0; t < N; ++t) {
    // Closed-loop controls u = U + (K dx + alpha d).
    if (Kg != nullptr) {
      for (int i = tid; i < nxf; i += nth) dx[i] = x[i] - X[(size_t)t * nxf + i];
      __syncthreads();
      for (int r = tid; r < nuf; r += nth) {
        const T* kr = Kg + ((size_t)t * nuf + r) * nxf;
        T du = kr[0] * dx[0];
        for (int i = 1; i < nxf; ++i) du += kr[i] * dx[i];
        u[r] = U[(size_t)t * nuf + r] + (du + alpha * dg[(size_t)t * nuf + r]);
      }
    } else {
      for (int r = tid; r < nuf; r += nth) u[r] = U[(size_t)t * nuf + r];
    }
    __syncthreads();

    const T stage = block_sum(
        cost_share(x, u, xf, Q, R, mask, npos_eval, rw, rad, pw, n, nx, nu), red);
    if (tid == 0) Jacc = Jacc + stage;
    for (int i = tid; i < nuf; i += nth) Ua[(size_t)t * nuf + i] = u[i];

    // RK4, one thread per agent (block_sum's last barrier ordered the cost's
    // reads of x before these writes).
    for (int k = tid; k < n; k += nth)
      rk4_slot(agent_model[k], agent_nsub[k], agent_dh[k], x + k * nx,
               u + k * nu, nx);
    __syncthreads();
    for (int i = tid; i < nxf; i += nth) Xa[(size_t)(t + 1) * nxf + i] = x[i];
  }
  const T term = block_sum(
      cost_share(x, (const T*)nullptr, xf, Qf, R, mask, npos_eval, rw, rad, pw,
                 n, nx, nu),
      red);
  if (tid == 0) Jc[a] = Jacc + term;
}

template <typename T>
int launch(const T* X, const T* U, const T* Kg, const T* d, const T* alphas,
           const int* agent_model, const int* agent_nsub, const T* agent_dh,
           const T* xf, const T* Q, const T* R, const T* Qf, const T* mask,
           const T* refw, const T* radius, const T* proxw,
           const int* npos_eval, T* Xc, T* Uc, T* Jc, int n, int N, int nx,
           int nu, int n_alpha, void* stream) {
  if (nx > MAX_NX || n < 1) return (int)cudaErrorInvalidValue;
  if (n_alpha == 0) return 0;
  // Enough threads for one per control row (and per agent), in whole warps.
  int threads = n * nu > n ? n * nu : n;
  threads = ((threads + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t bytes = (size_t)(2 * n * nx + n * nu + 32) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      forward_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  forward_sweep_kernel<T><<<n_alpha, threads, bytes, (cudaStream_t)stream>>>(
      X, U, Kg, d, alphas, agent_model, agent_nsub, agent_dh, xf, Q, R, Qf,
      mask, refw, radius, proxw, npos_eval, Xc, Uc, Jc, n, N, nx, nu);
  return (int)cudaGetLastError();
}

}  // namespace

#define DPILQR_FORWARD_SWEEP(NAME, T)                                          \
  extern "C" int NAME(                                                         \
      const T* X, const T* U, const T* K, const T* d, const T* alphas,         \
      const int* agent_model, const int* agent_nsub, const T* agent_dh,        \
      const T* xf, const T* Q, const T* R, const T* Qf, const T* mask,         \
      const T* refw, const T* radius, const T* proxw, const int* npos_eval,    \
      T* Xc, T* Uc, T* Jc, int n, int N, int nx, int nu, int n_alpha,          \
      void* stream) {                                                          \
    return launch<T>(X, U, K, d, alphas, agent_model, agent_nsub, agent_dh,    \
                     xf, Q, R, Qf, mask, refw, radius, proxw, npos_eval, Xc,   \
                     Uc, Jc, n, N, nx, nu, n_alpha, stream);                   \
  }

DPILQR_FORWARD_SWEEP(dpilqr_forward_sweep_f32, float)
DPILQR_FORWARD_SWEEP(dpilqr_forward_sweep_f64, double)
