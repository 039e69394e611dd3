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
// threads is later work.
//
// Model RHS: one __device__ function per model, transcribed from
// dpilqr_tpu_torch/models/vectorized.py (same formulas and association
// order as dpilqr_tpu/models/vectorized.py:42-117).
//
// Layouts (contiguous):
//   X (S, N+1, K, nx), U (S, N, K, nu), Kg (N, nuf, nxf, S), d (N, nuf, S),
//   alphas (n_alpha), slot_model / slot_nsub (S, K) int32, slot_dh (S, K),
//   xf (S, K, nx), Q / Qf (S, K, nx, nx), R (S, K, nu, nu), mask (S, K),
//   refw / radius / proxw (S), npos_eval (S, K) int32
//   -> X5 (N, nx, K, n_alpha, S) states 1..N, U5 (N, nu, K, n_alpha, S),
//      J (n_alpha, S); column c = alpha * S + s.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_NXF = 32;
constexpr int MAX_NUF = 32;
constexpr int MAX_NX = 12;

constexpr double GRAVITY = 9.80665;
constexpr double Q12_KF = 2000.0 / 63.0;
constexpr double Q12_KTX = 625000000000000000.0 / 10982593196059.0;
constexpr double Q12_KTY = 5000000000000000000.0 / 92848985528431.0;
constexpr double Q12_KTZ = 10000000000000000000.0 / 271597947137541.0;
constexpr double Q12_CX = 85899976080679.0 / 175721491136944.0;
constexpr double Q12_CY = 95876456000597.0 / 185697971056862.0;
constexpr double Q12_CZ = 9976479919918.0 / 271597947137541.0;

__device__ __forceinline__ float d_sin(float v) { return sinf(v); }
__device__ __forceinline__ double d_sin(double v) { return sin(v); }
__device__ __forceinline__ float d_cos(float v) { return cosf(v); }
__device__ __forceinline__ double d_cos(double v) { return cos(v); }
__device__ __forceinline__ float d_tan(float v) { return tanf(v); }
__device__ __forceinline__ double d_tan(double v) { return tan(v); }
__device__ __forceinline__ float d_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double d_sqrt(double v) { return sqrt(v); }

// Continuous dynamics of one slot; components a model does not set are 0.
template <typename T>
__device__ void rhs(int model, const T* x, const T* u, T* xd, int nx) {
  for (int i = 0; i < nx; ++i) xd[i] = T(0);
  const T g = T(GRAVITY);
  switch (model) {
    case 0:  // DoubleInt4D
      xd[0] = x[2]; xd[1] = x[3]; xd[2] = u[0]; xd[3] = u[1];
      break;
    case 1:  // DoubleInt6D
      xd[0] = x[3]; xd[1] = x[4]; xd[2] = x[5];
      xd[3] = u[0]; xd[4] = u[1]; xd[5] = u[2];
      break;
    case 2:  // Car3D
      xd[0] = u[0] * d_cos(x[2]); xd[1] = u[0] * d_sin(x[2]); xd[2] = u[1];
      break;
    case 3:  // Unicycle4D
      xd[0] = x[2] * d_cos(x[3]); xd[1] = x[2] * d_sin(x[3]);
      xd[2] = u[0]; xd[3] = u[1];
      break;
    case 4:  // Human6D
      xd[0] = x[3] * d_cos(u[0]); xd[1] = x[3] * d_sin(u[0]); xd[3] = u[1];
      break;
    case 5:  // HumanLin6D
      xd[0] = x[3]; xd[1] = x[4]; xd[3] = u[0]; xd[4] = u[1];
      break;
    case 6:  // Quad6D
      xd[0] = x[3]; xd[1] = x[4]; xd[2] = x[5];
      xd[3] = g * d_tan(u[2]);
      xd[4] = T(-GRAVITY) * d_tan(u[1]);
      xd[5] = u[0] - g;
      break;
    case 7: {  // Quad12D
      const T psi = x[3], th = x[4], ph = x[5];
      const T vx = x[6], vy = x[7], vz = x[8];
      const T wx = x[9], wy = x[10], wz = x[11];
      const T sps = d_sin(psi), cps = d_cos(psi);
      const T sth = d_sin(th), cth = d_cos(th);
      const T sph = d_sin(ph), cph = d_cos(ph);
      const T tth = d_tan(th);
      xd[0] = vx * cps * cth + vy * (sph * sth * cps - sps * cph) +
              vz * (sph * sps + sth * cph * cps);
      xd[1] = vx * sps * cth + vy * (sph * sps * sth + cph * cps) +
              vz * (-sph * cps + sps * sth * cph);
      xd[2] = -vx * sth + vy * sph * cth + vz * cph * cth;
      xd[3] = wy * sph / cth + wz * cph / cth;
      xd[4] = wy * cph - wz * sph;
      xd[5] = wx + wy * sph * tth + wz * cph * tth;
      xd[6] = vy * wz - vz * wy + g * sth;
      xd[7] = -vx * wz + vz * wx - g * sph * cth;
      xd[8] = T(Q12_KF) * u[3] + vx * wy - vy * wx - g * cph * cth;
      xd[9] = T(Q12_KTX) * u[0] - T(Q12_CX) * wy * wz;
      xd[10] = T(Q12_KTY) * u[1] + T(Q12_CY) * wx * wz;
      xd[11] = T(Q12_KTZ) * u[2] - T(Q12_CZ) * wx * wy;
      break;
    }
    case 8:  // Bike5D
      xd[0] = x[2] * d_cos(x[3]); xd[1] = x[2] * d_sin(x[3]);
      xd[2] = u[0]; xd[3] = x[2] * d_tan(x[4]); xd[4] = u[1];
      break;
    default:
      break;
  }
}

// v^T M v accumulated as sum_b v_b (sum_a M_ba v_a).
template <typename T>
__device__ T quadform(const T* M, const T* v, int n) {
  T acc = T(0);
  for (int b = 0; b < n; ++b) {
    T mv = M[b * n] * v[0];
    for (int a = 1; a < n; ++a) mv += M[b * n + a] * v[a];
    acc += v[b] * mv;
  }
  return acc;
}

// Unweighted pair penalty sum_{k1<k2} m1 m2 [d < r] min(0, d - r)^2.
template <typename T>
__device__ T prox(const T* x, const T* mask, const int* npos, T rad, int K,
                  int nx) {
  const int kpos = nx < 3 ? nx : 3;
  T acc = T(0);
  for (int k1 = 0; k1 < K; ++k1) {
    for (int k2 = k1 + 1; k2 < K; ++k2) {
      const int nd = npos[k1] < npos[k2] ? npos[k1] : npos[k2];
      T dd2 = T(0);
      for (int c = 0; c < kpos; ++c) {
        const T dc = (x[k1 * nx + c] - x[k2 * nx + c]) * T(c < nd ? 1 : 0);
        dd2 += dc * dc;
      }
      const T dist = d_sqrt(dd2);
      const T active = dist < rad ? T(1) : T(0);
      const T m = dist - rad < T(0) ? dist - rad : T(0);
      acc += mask[k1] * mask[k2] * active * (m * m);
    }
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
  T k0[MAX_NX], k1[MAX_NX], k2[MAX_NX], k3[MAX_NX], xt[MAX_NX];
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
      const int model = slot_model[sk], nsub = slot_nsub[sk];
      const T dh = slot_dh[sk], hh = T(0.5) * dh;
      T* xs = x + k * nx;
      const T* us = u + k * nu;
      for (int i_sub = 0; i_sub < nsub; ++i_sub) {
        rhs(model, xs, us, k0, nx);
        for (int i = 0; i < nx; ++i) xt[i] = xs[i] + hh * k0[i];
        rhs(model, xt, us, k1, nx);
        for (int i = 0; i < nx; ++i) xt[i] = xs[i] + hh * k1[i];
        rhs(model, xt, us, k2, nx);
        for (int i = 0; i < nx; ++i) xt[i] = xs[i] + dh * k2[i];
        rhs(model, xt, us, k3, nx);
        for (int i = 0; i < nx; ++i)
          xs[i] = xs[i] + dh * (k0[i] + T(2) * k1[i] + T(2) * k2[i] + k3[i]) / T(6);
      }
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
