// The Riccati backward recursion of one iLQR problem, run by one CTA: the
// algebra shared by the three backward kernels (backward_batched.cu,
// backward_batched_wide.cu, backward_sweep.cu).
//
// For every step t = N-1 .. 0 it builds Q_x, Q_u, Q_xx, Q_ux, Q_uu from the
// block-diagonal dynamics (K slots of nx states and nu controls; Tassa
// regularization P + mu I on the B sandwiches only), solves
// Q_uu [K | d] = [Q_ux | Q_u] by Gauss-Jordan WITHOUT pivoting, and applies
// the full-form value update with symmetrization (reference
// dpilqr/control.py:116-148).  Threads span matrix entries, with
// __syncthreads() between phases and between pivots.  The arithmetic order
// follows the Pallas kernel dpilqr_tpu/ops/pallas_batched.py ::
// backward_pass_batched (pivot order, pivot-row restore, reciprocal-multiply
// pivots, full-form update, Q_ux^T K taken as the transpose of K^T Q_ux).
//
// Working memory comes in three groups, each carved from its own base
// pointer, so a kernel can place each group in shared or in device memory
// (the pointers are generic):
//   value: P, A^T P (later K^T Q_ux), Q_xx (later the unsymmetrized P),
//          3 nxf^2 values;
//   gain:  B^T (P + mu I), Q_ux, K, Q_uu K, Q_uu, the Gauss-Jordan tableau
//          [Q_uu | Q_ux | Q_u], A_t, B_t;
//   vec:   p, Q_x, Q_u, d, w, the pivot row and column.
//
// Per-problem layouts (contiguous, time-major):
//   A (N, K, nx, nx), B (N, K, nx, nu), Luu (N, nuf, nuf), Lxx (N, nxf, nxf),
//   Lx (N, nxf), Lu (N, nuf), p0 (nxf), P0 (nxf, nxf);
// gains are written to Kg[((t nuf + r) nxf + c) S + s], d[(t nuf + r) S + s]
// (the batched layout (N, nuf, nxf, S); S = 1 for a single problem).

#pragma once

#include <cuda_runtime.h>

namespace {

struct RiccatiSizes {
  size_t value, gain, vec;  // values per group
};

__host__ __device__ inline RiccatiSizes riccati_sizes(int K, int nx, int nu) {
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu, ncol = nuf + nxf + 1;
  return {3 * nxf * nxf,
          4 * nuf * nxf + nuf * nuf + nuf * ncol + (size_t)K * nx * (nx + nu),
          2 * nxf + 4 * nuf + ncol};
}

template <typename T>
struct RiccatiWork {
  T *P, *AtP, *Qxx;
  T *W1, *Qux, *Kt, *QuuK, *Quu, *M, *At, *Bt;
  T *p, *Qx, *Qu, *dt, *w, *prow, *colv;
};

template <typename T>
__device__ RiccatiWork<T> riccati_carve(T* value, T* gain, T* vec, int K,
                                        int nx, int nu) {
  const int nxf = K * nx, nuf = K * nu, ncol = nuf + nxf + 1;
  RiccatiWork<T> ws;
  ws.P = value;    value += nxf * nxf;
  ws.AtP = value;  value += nxf * nxf;
  ws.Qxx = value;
  ws.W1 = gain;    gain += nuf * nxf;
  ws.Qux = gain;   gain += nuf * nxf;
  ws.Kt = gain;    gain += nuf * nxf;
  ws.QuuK = gain;  gain += nuf * nxf;
  ws.Quu = gain;   gain += nuf * nuf;
  ws.M = gain;     gain += nuf * ncol;
  ws.At = gain;    gain += K * nx * nx;
  ws.Bt = gain;
  ws.p = vec;      vec += nxf;
  ws.Qx = vec;     vec += nxf;
  ws.Qu = vec;     vec += nuf;
  ws.dt = vec;     vec += nuf;
  ws.w = vec;      vec += nuf;
  ws.prow = vec;   vec += ncol;
  ws.colv = vec;
  return ws;
}

template <typename T>
__device__ __forceinline__ void riccati_sweep(
    const T* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ Luu, const T* __restrict__ Lxx,
    const T* __restrict__ Lx, const T* __restrict__ Lu, const T mu,
    const T* __restrict__ p0, const T* __restrict__ P0, T* __restrict__ Kg,
    T* __restrict__ dg, int S, int s, int N, int K, int nx, int nu,
    const RiccatiWork<T>& ws) {
  const int nxf = K * nx, nuf = K * nu;
  const int ncol = nuf + nxf + 1;  // Gauss-Jordan tableau [Quu | Qux | Qu]
  T* const P = ws.P;
  T* const AtP = ws.AtP;
  T* const Qxx = ws.Qxx;
  T* const W1 = ws.W1;
  T* const Qux = ws.Qux;
  T* const Kt = ws.Kt;
  T* const QuuK = ws.QuuK;
  T* const Quu = ws.Quu;
  T* const M = ws.M;
  T* const At = ws.At;
  T* const Bt = ws.Bt;
  T* const p = ws.p;
  T* const Qx = ws.Qx;
  T* const Qu = ws.Qu;
  T* const dt = ws.dt;
  T* const w = ws.w;
  T* const prow = ws.prow;
  T* const colv = ws.colv;
  const int tid = threadIdx.x, nth = blockDim.x;

  for (int i = tid; i < nxf * nxf; i += nth) P[i] = P0[i];
  for (int i = tid; i < nxf; i += nth) p[i] = p0[i];

  for (int t = N - 1; t >= 0; --t) {
    for (int i = tid; i < K * nx * nx; i += nth) At[i] = A[(size_t)t * K * nx * nx + i];
    for (int i = tid; i < K * nx * nu; i += nth) Bt[i] = B[(size_t)t * K * nx * nu + i];
    __syncthreads();

    // Phase 1: Q_x, Q_u, A^T P, B^T (P + mu I).
    for (int i = tid; i < nxf; i += nth) {
      const int k = i / nx, j = i % nx;
      T acc = At[(k * nx) * nx + j] * p[k * nx];
      for (int b = 1; b < nx; ++b) acc += At[(k * nx + b) * nx + j] * p[k * nx + b];
      Qx[i] = Lx[(size_t)t * nxf + i] + acc;
    }
    for (int i = tid; i < nuf; i += nth) {
      const int k = i / nu, j = i % nu;
      T acc = Bt[(k * nx) * nu + j] * p[k * nx];
      for (int b = 1; b < nx; ++b) acc += Bt[(k * nx + b) * nu + j] * p[k * nx + b];
      Qu[i] = Lu[(size_t)t * nuf + i] + acc;
    }
    for (int i = tid; i < nxf * nxf; i += nth) {
      const int r = i / nxf, c = i % nxf, k = r / nx, j = r % nx;
      T acc = At[(k * nx) * nx + j] * P[(k * nx) * nxf + c];
      for (int b = 1; b < nx; ++b)
        acc += At[(k * nx + b) * nx + j] * P[(k * nx + b) * nxf + c];
      AtP[i] = acc;
    }
    for (int i = tid; i < nuf * nxf; i += nth) {
      const int r = i / nxf, c = i % nxf, k = r / nu, j = r % nu;
      T acc = 0;
      for (int b = 0; b < nx; ++b) {
        const int row = k * nx + b;
        const T preg = P[row * nxf + c] + (row == c ? mu : T(0));
        const T term = Bt[row * nu + j] * preg;
        acc = b == 0 ? term : acc + term;
      }
      W1[i] = acc;
    }
    __syncthreads();

    // Phase 2: Q_xx = Lxx + A^T P A, Q_ux = B^T Preg A, Q_uu = B^T Preg B + Luu.
    for (int i = tid; i < nxf * nxf; i += nth) {
      const int r = i / nxf, c = i % nxf, k = c / nx, j = c % nx;
      T acc = AtP[r * nxf + k * nx] * At[(k * nx) * nx + j];
      for (int b = 1; b < nx; ++b)
        acc += AtP[r * nxf + k * nx + b] * At[(k * nx + b) * nx + j];
      Qxx[i] = Lxx[(size_t)t * nxf * nxf + i] + acc;
    }
    for (int i = tid; i < nuf * nxf; i += nth) {
      const int r = i / nxf, c = i % nxf, k = c / nx, j = c % nx;
      T acc = W1[r * nxf + k * nx] * At[(k * nx) * nx + j];
      for (int b = 1; b < nx; ++b)
        acc += W1[r * nxf + k * nx + b] * At[(k * nx + b) * nx + j];
      Qux[i] = acc;
      M[r * ncol + nuf + c] = acc;
    }
    for (int i = tid; i < nuf * nuf; i += nth) {
      const int r = i / nuf, c = i % nuf, k = c / nu, j = c % nu;
      T acc = W1[r * nxf + k * nx] * Bt[(k * nx) * nu + j];
      for (int b = 1; b < nx; ++b)
        acc += W1[r * nxf + k * nx + b] * Bt[(k * nx + b) * nu + j];
      const T q = acc + Luu[(size_t)t * nuf * nuf + i];
      Quu[i] = q;
      M[r * ncol + c] = q;
    }
    for (int i = tid; i < nuf; i += nth) M[i * ncol + nuf + nxf] = Qu[i];
    __syncthreads();

    // Phase 3: Gauss-Jordan without pivoting on [Quu | Qux | Qu].
    for (int kp = 0; kp < nuf; ++kp) {
      const T inv = T(1) / M[kp * ncol + kp];
      for (int j = tid; j < ncol; j += nth) prow[j] = M[kp * ncol + j] * inv;
      for (int r = tid; r < nuf; r += nth) colv[r] = M[r * ncol + kp];
      __syncthreads();
      for (int i = tid; i < nuf * ncol; i += nth) {
        const int r = i / ncol, j = i % ncol;
        M[i] = r == kp ? prow[j] : M[i] - colv[r] * prow[j];
      }
      __syncthreads();
    }

    // Phase 4: gains K = -X, d = -x, written in (N, nuf, nxf, S) layout.
    for (int i = tid; i < nuf * nxf; i += nth) {
      const int r = i / nxf, c = i % nxf;
      const T kval = -M[r * ncol + nuf + c];
      Kt[i] = kval;
      Kg[(((size_t)t * nuf + r) * nxf + c) * S + s] = kval;
    }
    for (int r = tid; r < nuf; r += nth) {
      const T dval = -M[r * ncol + nuf + nxf];
      dt[r] = dval;
      dg[((size_t)t * nuf + r) * S + s] = dval;
    }
    __syncthreads();

    // Phase 5: w = Quu d + Qu, Quu K, K^T Qux (into AtP).
    for (int r = tid; r < nuf; r += nth) {
      T acc = Quu[r] * dt[0];
      for (int v = 1; v < nuf; ++v) acc += Quu[v * nuf + r] * dt[v];
      w[r] = acc + Qu[r];
    }
    for (int i = tid; i < nuf * nxf; i += nth) {
      const int r = i / nxf, c = i % nxf;
      T acc = Quu[r] * Kt[c];
      for (int v = 1; v < nuf; ++v) acc += Quu[v * nuf + r] * Kt[v * nxf + c];
      QuuK[i] = acc;
    }
    for (int i = tid; i < nxf * nxf; i += nth) {
      const int r = i / nxf, c = i % nxf;
      T acc = Kt[r] * Qux[c];
      for (int v = 1; v < nuf; ++v) acc += Kt[v * nxf + r] * Qux[v * nxf + c];
      AtP[i] = acc;
    }
    __syncthreads();

    // Phase 6: full-form value update p, P_new = Qxx + K^T Quu K + K^T Qux
    // + (K^T Qux)^T (into Qxx, each entry read and written by one thread).
    for (int c = tid; c < nxf; c += nth) {
      T a1 = Kt[c] * w[0];
      for (int v = 1; v < nuf; ++v) a1 += Kt[v * nxf + c] * w[v];
      T a2 = Qux[c] * dt[0];
      for (int v = 1; v < nuf; ++v) a2 += Qux[v * nxf + c] * dt[v];
      p[c] = Qx[c] + a1 + a2;
    }
    for (int i = tid; i < nxf * nxf; i += nth) {
      const int r = i / nxf, c = i % nxf;
      T acc = Kt[r] * QuuK[c];
      for (int v = 1; v < nuf; ++v) acc += Kt[v * nxf + r] * QuuK[v * nxf + c];
      Qxx[i] = Qxx[i] + acc + AtP[i] + AtP[c * nxf + r];
    }
    __syncthreads();

    // Phase 7: symmetrize.
    for (int i = tid; i < nxf * nxf; i += nth) {
      const int r = i / nxf, c = i % nxf;
      P[i] = T(0.5) * (Qxx[i] + Qxx[c * nxf + r]);
    }
    __syncthreads();
  }
}

// The shared memory a block may opt into on the current device, or -1.
inline long long max_shared_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin;
}

// Opt the kernel into `bytes` of dynamic shared memory and launch it.
template <typename Kernel, typename... Args>
int launch_with_smem(Kernel kernel, int blocks, int threads, size_t bytes,
                     void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
