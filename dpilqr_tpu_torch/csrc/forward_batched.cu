// Batched closed-loop line-search rollout for the decomposed DP-iLQR solve.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_batched.py ::
// forward_pass_batched (the Pallas program at :647-778): for every
// (alpha, subproblem) column it rolls out u = U + Kg (x - X) + alpha d
// (reference dpilqr/control.py:95-114) with RK4 under a per-slot step
// table (a slot whose model takes s_m substeps runs s_m steps of dt/s_m,
// so mixed Bike5D fleets stay exact), blending all nine models' dynamics,
// and accumulates the game cost: the stage and terminal reference cost,
// the padded-slot (1-m) |u|^2 term and the pair penalty
// sum min(0, d - r)^2 over the n_pos_eval position components.  With no
// gains (Kg = d = nullptr) it is the plain rollout of U.
//
// What bounds it on the H100: per column the work is a serial chain of
// N x (nuf nxf gain FMAs + K x substeps x 4 RHS evaluations + K(K-1)/2
// pair distances), and there are only n_alpha x S columns (200-1000 on the
// main path), far fewer than the card's threads.  So it is latency-bound,
// not bound by bytes (the gains stream once per column, ~nuf nxf values a
// step, shared by a subproblem's alphas through L1/L2).  The design is the
// simple one: one thread per column, the slot states in registers/local
// memory, the whole time loop in one launch so nothing round-trips through
// device memory but the per-step outputs.  Splitting a column's slots over
// threads is later work.  Wide subproblems (nxf up to 96) run through the
// same code; their per-thread arrays spill to local memory.
//
// Model RHS, RK4 and the cost's quadratic forms: dynamics.cuh, shared with
// the centralized forward kernel (forward_sweep.cu).
//
// Layouts (contiguous):
//   X (S, N+1, K, nx), U (S, N, K, nu), Kg (N, nuf, nxf, S), d (N, nuf, S),
//   alphas (n_alpha), slot_model / slot_nsub (S, K) int32, slot_dh (S, K),
//   xf (S, K, nx), Q / Qf (S, K, nx, nx), R (S, K, nu, nu), mask (S, K),
//   refw / radius / proxw (S), npos_eval (S, K) int32
//   -> X5 (N, nx, K, n_alpha, S) states 1..N, U5 (N, nu, K, n_alpha, S),
//      J (n_alpha, S); column c = alpha * S + s.

#include "dynamics.cuh"

namespace {

// Widest flat state / control of a subproblem (K * nx, K * nu) the kernel
// takes: the wide subproblems (nxf 96: Quad12D at K=8, Quad6D at K=16;
// nuf up to 64 for Car3D at K=32).  A column's x, dx and u live in
// per-thread arrays of these sizes; past a few dozen values they spill to
// local memory (cached in L1/L2).
constexpr int MAX_NXF = 96;
constexpr int MAX_NUF = 64;

// Unweighted pair penalty sum_{k1<k2} m1 m2 [d < r] min(0, d - r)^2.
template <typename T>
__device__ T prox(const T* x, const T* mask, const int* npos, T rad, int K,
                  int nx) {
  T acc = T(0);
  for (int k1 = 0; k1 < K; ++k1)
    for (int k2 = k1 + 1; k2 < K; ++k2) {
      const int nd = npos[k1] < npos[k2] ? npos[k1] : npos[k2];
      acc += pair_penalty(x + k1 * nx, x + k2 * nx, mask[k1], mask[k2], nd,
                          rad, nx);
    }
  return acc;
}

template <typename T>
__global__ void forward_batched_kernel(
    const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ Kg, const T* __restrict__ dg,
    const T* __restrict__ alphas, const int* __restrict__ slot_model,
    const int* __restrict__ slot_nsub, const T* __restrict__ slot_dh,
    const T* __restrict__ xf, const T* __restrict__ Q,
    const T* __restrict__ R, const T* __restrict__ Qf,
    const T* __restrict__ mask, const T* __restrict__ refw,
    const T* __restrict__ radius, const T* __restrict__ proxw,
    const int* __restrict__ npos_eval, T* __restrict__ X5,
    T* __restrict__ U5, T* __restrict__ J, int S, int N, int K, int nx,
    int nu, int n_alpha) {
  const int CS = n_alpha * S;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= CS) return;
  const int a = c / S, s = c % S;
  const int nxf = K * nx, nuf = K * nu;
  const bool gains = Kg != nullptr;

  T x[MAX_NXF], u[MAX_NUF], dx[MAX_NXF];
  const T* Xs = X + (size_t)s * (N + 1) * nxf;
  const T* Us = U + (size_t)s * N * nuf;
  for (int i = 0; i < nxf; ++i) x[i] = Xs[i];
  const T alpha = alphas[a];
  const T rw = refw[s], rad = radius[s], pw = proxw[s];
  const T* ms = mask + (size_t)s * K;
  const int* nps = npos_eval + (size_t)s * K;
  const T* xfs = xf + (size_t)s * nxf;
  T Jacc = T(0);

  for (int t = 0; t < N; ++t) {
    // Closed-loop controls.
    if (gains) {
      for (int i = 0; i < nxf; ++i) dx[i] = x[i] - Xs[(size_t)t * nxf + i];
      for (int r = 0; r < nuf; ++r) {
        const T* gr = Kg + ((size_t)t * nuf + r) * nxf * S + s;
        T du = T(0);
        for (int i = 0; i < nxf; ++i) du += gr[(size_t)i * S] * dx[i];
        u[r] = Us[(size_t)t * nuf + r] + du + alpha * dg[((size_t)t * nuf + r) * S + s];
      }
    } else {
      for (int r = 0; r < nuf; ++r) u[r] = Us[(size_t)t * nuf + r];
    }

    // Stage cost at (x_t, u_t).
    T rows = T(0);
    for (int k = 0; k < K; ++k) {
      T e[MAX_NX];
      for (int i = 0; i < nx; ++i) e[i] = x[k * nx + i] - xfs[k * nx + i];
      const size_t sk = (size_t)s * K + k;
      const T q = quadform(Q + sk * nx * nx, e, nx) +
                  quadform(R + sk * nu * nu, u + k * nu, nu);
      T uu = u[k * nu] * u[k * nu];
      for (int j = 1; j < nu; ++j) uu += u[k * nu + j] * u[k * nu + j];
      const T row = rw * ms[k] * q + (T(1) - ms[k]) * uu;
      rows = k == 0 ? row : rows + row;
    }
    if (K > 1) rows = rows + pw * prox(x, ms, nps, rad, K, nx);
    Jacc = Jacc + rows;
    for (int k = 0; k < K; ++k)
      for (int j = 0; j < nu; ++j)
        U5[(((size_t)t * nu + j) * K + k) * CS + c] = u[k * nu + j];

    // RK4 with the slot's own substep schedule.
    for (int k = 0; k < K; ++k) {
      const size_t sk = (size_t)s * K + k;
      rk4_slot(slot_model[sk], slot_nsub[sk], slot_dh[sk], x + k * nx,
               u + k * nu, nx);
    }
    for (int k = 0; k < K; ++k)
      for (int i = 0; i < nx; ++i)
        X5[(((size_t)t * nx + i) * K + k) * CS + c] = x[k * nx + i];
  }

  // Terminal cost.
  T rows = T(0);
  for (int k = 0; k < K; ++k) {
    T e[MAX_NX];
    for (int i = 0; i < nx; ++i) e[i] = x[k * nx + i] - xfs[k * nx + i];
    const T row = rw * ms[k] * quadform(Qf + ((size_t)s * K + k) * nx * nx, e, nx);
    rows = k == 0 ? row : rows + row;
  }
  if (K > 1) rows = rows + pw * prox(x, ms, nps, rad, K, nx);
  J[c] = Jacc + rows;
}

template <typename T>
int launch(const T* X, const T* U, const T* Kg, const T* d, const T* alphas,
           const int* slot_model, const int* slot_nsub, const T* slot_dh,
           const T* xf, const T* Q, const T* R, const T* Qf, const T* mask,
           const T* refw, const T* radius, const T* proxw,
           const int* npos_eval, T* X5, T* U5, T* J, int S, int N, int K,
           int nx, int nu, int n_alpha, void* stream) {
  if (K * nx > MAX_NXF || K * nu > MAX_NUF || nx > MAX_NX)
    return (int)cudaErrorInvalidValue;
  const int CS = n_alpha * S;
  if (CS == 0) return 0;
  const int threads = 128;
  forward_batched_kernel<T><<<(CS + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
      X, U, Kg, d, alphas, slot_model, slot_nsub, slot_dh, xf, Q, R, Qf, mask,
      refw, radius, proxw, npos_eval, X5, U5, J, S, N, K, nx, nu, n_alpha);
  return (int)cudaGetLastError();
}

}  // namespace

#define DPILQR_FORWARD(NAME, T)                                               \
  extern "C" int NAME(                                                        \
      const T* X, const T* U, const T* Kg, const T* d, const T* alphas,       \
      const int* slot_model, const int* slot_nsub, const T* slot_dh,          \
      const T* xf, const T* Q, const T* R, const T* Qf, const T* mask,        \
      const T* refw, const T* radius, const T* proxw, const int* npos_eval,   \
      T* X5, T* U5, T* J, int S, int N, int K, int nx, int nu, int n_alpha,   \
      void* stream) {                                                         \
    return launch<T>(X, U, Kg, d, alphas, slot_model, slot_nsub, slot_dh, xf, \
                     Q, R, Qf, mask, refw, radius, proxw, npos_eval, X5, U5,  \
                     J, S, N, K, nx, nu, n_alpha, stream);                    \
  }

DPILQR_FORWARD(dpilqr_forward_batched_f32, float)
DPILQR_FORWARD(dpilqr_forward_batched_f64, double)
