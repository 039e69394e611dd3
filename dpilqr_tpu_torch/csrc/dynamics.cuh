// Device-side dynamics shared by the forward kernels (forward_batched.cu,
// forward_sweep.cu): the nine models' continuous right-hand sides, one
// slot's RK4 substep schedule and the per-agent quadratic form of the cost.
// The right-hand sides (and the d_* functions they call) are also host
// functions, so that derivatives.cuh, which differentiates them, compiles
// with a plain C++ compiler for the CPU tests (csrc/derivatives_host.cpp).
//
// A slot's state lives in registers while it integrates: the per-slot
// arrays have a compile-time width NXC (the caller's bound on nx, at most
// MAX_NX) and every loop over them is fully unrolled under an ``i < nx``
// predicate, so no index is computed at run time and nothing goes to local
// memory.  A model wider than NXC compiles to nothing under that bound.
//
// Model RHS: transcribed from dpilqr_tpu_torch/models/vectorized.py (same
// formulas and association order as dpilqr_tpu/models/vectorized.py:42-117);
// the switch index is ModelSpec.model_id.  A translation unit built with
// -DDPILQR_CUSTOM_MODELS also holds the custom models' right-hand sides that
// ops/codegen.py generates from their sympy forms (the header
// dpilqr_custom_models.cuh on the include path, ids from 1000), reached
// from the switch's default case.

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DPILQR_HD __host__ __device__
#else  // a host compiler: the device-only helpers below compile as inline
#include <cmath>
#define DPILQR_HD
#define __device__
#define __forceinline__ inline
#endif

namespace {

// Widest per-agent state and control among the nine models (Quad12D).
constexpr int MAX_NX = 12;
constexpr int MAX_NU = 4;

constexpr double GRAVITY = 9.80665;
constexpr double Q12_KF = 2000.0 / 63.0;
constexpr double Q12_KTX = 625000000000000000.0 / 10982593196059.0;
constexpr double Q12_KTY = 5000000000000000000.0 / 92848985528431.0;
constexpr double Q12_KTZ = 10000000000000000000.0 / 271597947137541.0;
constexpr double Q12_CX = 85899976080679.0 / 175721491136944.0;
constexpr double Q12_CY = 95876456000597.0 / 185697971056862.0;
constexpr double Q12_CZ = 9976479919918.0 / 271597947137541.0;

DPILQR_HD __forceinline__ float d_sin(float v) { return sinf(v); }
DPILQR_HD __forceinline__ double d_sin(double v) { return sin(v); }
DPILQR_HD __forceinline__ float d_tan(float v) { return tanf(v); }
DPILQR_HD __forceinline__ double d_tan(double v) { return tan(v); }
DPILQR_HD __forceinline__ float d_sqrt(float v) { return sqrtf(v); }
DPILQR_HD __forceinline__ double d_sqrt(double v) { return sqrt(v); }
// The other functions a generated right-hand side may call (ops/codegen.py;
// their dual-number overloads are in derivatives.cuh).
DPILQR_HD __forceinline__ float d_cos(float v) { return cosf(v); }
DPILQR_HD __forceinline__ double d_cos(double v) { return cos(v); }
DPILQR_HD __forceinline__ float d_exp(float v) { return expf(v); }
DPILQR_HD __forceinline__ double d_exp(double v) { return exp(v); }
DPILQR_HD __forceinline__ float d_log(float v) { return logf(v); }
DPILQR_HD __forceinline__ double d_log(double v) { return log(v); }
DPILQR_HD __forceinline__ float d_tanh(float v) { return tanhf(v); }
DPILQR_HD __forceinline__ double d_tanh(double v) { return tanh(v); }
DPILQR_HD __forceinline__ float d_abs(float v) { return fabsf(v); }
DPILQR_HD __forceinline__ double d_abs(double v) { return fabs(v); }
DPILQR_HD __forceinline__ float d_atan2(float y, float x) { return atan2f(y, x); }
DPILQR_HD __forceinline__ double d_atan2(double y, double x) { return atan2(y, x); }
DPILQR_HD __forceinline__ float d_pow(float a, float b) { return powf(a, b); }
DPILQR_HD __forceinline__ double d_pow(double a, double b) { return pow(a, b); }

DPILQR_HD __forceinline__ void d_sincos(float v, float* s, float* c) {
  sincosf(v, s, c);
}
DPILQR_HD __forceinline__ void d_sincos(double v, double* s, double* c) {
  sincos(v, s, c);
}

#ifdef DPILQR_CUSTOM_MODELS
// custom_rhs: the generated right-hand sides, by library-local id.
#include "dpilqr_custom_models.cuh"
#endif

// Continuous dynamics of one slot; components a model does not set are 0.
// Sine and cosine of one angle come from one sincos call.
template <int NXC, typename T>
DPILQR_HD __forceinline__ void rhs(int model, const T (&x)[NXC], const T* u,
                                   T (&xd)[NXC]) {
#pragma unroll
  for (int i = 0; i < NXC; ++i) xd[i] = T(0);
  const T g = T(GRAVITY);
  switch (model) {
    case 0:  // DoubleInt4D
      if constexpr (NXC >= 4) {
        xd[0] = x[2]; xd[1] = x[3]; xd[2] = u[0]; xd[3] = u[1];
      }
      break;
    case 1:  // DoubleInt6D
      if constexpr (NXC >= 6) {
        xd[0] = x[3]; xd[1] = x[4]; xd[2] = x[5];
        xd[3] = u[0]; xd[4] = u[1]; xd[5] = u[2];
      }
      break;
    case 2:  // Car3D
      if constexpr (NXC >= 3) {
        T sn, cs;
        d_sincos(x[2], &sn, &cs);
        xd[0] = u[0] * cs; xd[1] = u[0] * sn; xd[2] = u[1];
      }
      break;
    case 3:  // Unicycle4D
      if constexpr (NXC >= 4) {
        T sn, cs;
        d_sincos(x[3], &sn, &cs);
        xd[0] = x[2] * cs; xd[1] = x[2] * sn;
        xd[2] = u[0]; xd[3] = u[1];
      }
      break;
    case 4:  // Human6D
      if constexpr (NXC >= 6) {
        T sn, cs;
        d_sincos(u[0], &sn, &cs);
        xd[0] = x[3] * cs; xd[1] = x[3] * sn; xd[3] = u[1];
      }
      break;
    case 5:  // HumanLin6D
      if constexpr (NXC >= 6) {
        xd[0] = x[3]; xd[1] = x[4]; xd[3] = u[0]; xd[4] = u[1];
      }
      break;
    case 6:  // Quad6D
      if constexpr (NXC >= 6) {
        xd[0] = x[3]; xd[1] = x[4]; xd[2] = x[5];
        xd[3] = g * d_tan(u[2]);
        xd[4] = T(-GRAVITY) * d_tan(u[1]);
        xd[5] = u[0] - g;
      }
      break;
    case 7:  // Quad12D
      if constexpr (NXC >= 12) {
        const T psi = x[3], th = x[4], ph = x[5];
        const T vx = x[6], vy = x[7], vz = x[8];
        const T wx = x[9], wy = x[10], wz = x[11];
        T sps, cps, sth, cth, sph, cph;
        d_sincos(psi, &sps, &cps);
        d_sincos(th, &sth, &cth);
        d_sincos(ph, &sph, &cph);
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
      }
      break;
    case 8:  // Bike5D
      if constexpr (NXC >= 5) {
        T sn, cs;
        d_sincos(x[3], &sn, &cs);
        xd[0] = x[2] * cs; xd[1] = x[2] * sn;
        xd[2] = u[0]; xd[3] = x[2] * d_tan(x[4]); xd[4] = u[1];
      }
      break;
    default:
#ifdef DPILQR_CUSTOM_MODELS
      custom_rhs(model, x, u, xd);
#endif
      break;
  }
}

// One control period of one slot, in place: ``nsub`` classic RK4 steps of
// size ``dh`` under zero-order hold (models/integrate.py rk4_step).  The
// slot's state is read from ``xs`` once and written back once; the weighted
// sum k0 + 2 k1 + 2 k2 + k3 accumulates left to right as it is written.
template <int NXC = MAX_NX, typename T>
__device__ __forceinline__ void rk4_slot(int model, int nsub, T dh, T* xs,
                                         const T* us, int nx) {
  T x[NXC], xt[NXC], k[NXC], acc[NXC];
#pragma unroll
  for (int i = 0; i < NXC; ++i) x[i] = i < nx ? xs[i] : T(0);
  const T hh = T(0.5) * dh;
  for (int i_sub = 0; i_sub < nsub; ++i_sub) {
    rhs(model, x, us, k);
#pragma unroll
    for (int i = 0; i < NXC; ++i) {
      acc[i] = k[i];
      xt[i] = x[i] + hh * k[i];
    }
    rhs(model, xt, us, k);
#pragma unroll
    for (int i = 0; i < NXC; ++i) {
      acc[i] = acc[i] + T(2) * k[i];
      xt[i] = x[i] + hh * k[i];
    }
    rhs(model, xt, us, k);
#pragma unroll
    for (int i = 0; i < NXC; ++i) {
      acc[i] = acc[i] + T(2) * k[i];
      xt[i] = x[i] + dh * k[i];
    }
    rhs(model, xt, us, k);
#pragma unroll
    for (int i = 0; i < NXC; ++i) x[i] = x[i] + dh * (acc[i] + k[i]) / T(6);
  }
#pragma unroll
  for (int i = 0; i < NXC; ++i)
    if (i < nx) xs[i] = x[i];
}

// v^T M v accumulated as sum_b v_b (sum_a M_ba v_a), n <= NC; unrolled, so
// a ``v`` held in registers stays there.
template <int NC = MAX_NX, typename T>
__device__ __forceinline__ T quadform(const T* M, const T* v, int n) {
  T acc = T(0);
#pragma unroll
  for (int b = 0; b < NC; ++b) {
    if (b < n) {
      T mv = M[b * n] * v[0];
#pragma unroll
      for (int a = 1; a < NC; ++a)
        if (a < n) mv += M[b * n + a] * v[a];
      acc += v[b] * mv;
    }
  }
  return acc;
}

// One pair's unweighted penalty m1 m2 [d < r] min(0, d - r)^2, the distance
// over the first min(nx, 3, nd) position components.
template <typename T>
__device__ T pair_penalty(const T* x1, const T* x2, T m1, T m2, int nd, T rad,
                          int nx) {
  const int kpos = nx < 3 ? nx : 3;
  T dd2 = T(0);
  for (int c = 0; c < kpos; ++c) {
    const T dc = (x1[c] - x2[c]) * T(c < nd ? 1 : 0);
    dd2 += dc * dc;
  }
  const T dist = d_sqrt(dd2);
  const T active = dist < rad ? T(1) : T(0);
  const T m = dist - rad < T(0) ? dist - rad : T(0);
  return m1 * m2 * active * (m * m);
}

}  // namespace
