// Batched Riccati backward recursion for the decomposed DP-iLQR solve.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_batched.py ::
// backward_pass_batched (the Pallas program at :421-479): for every
// subproblem s and every step t = N-1 .. 0 it builds Q_x, Q_u, Q_xx, Q_ux,
// Q_uu from the block-diagonal dynamics (Tassa regularization P + mu I on
// the B sandwiches only), solves Q_uu [K | d] = [Q_ux | Q_u] by Gauss-Jordan
// WITHOUT pivoting, and applies the full-form value update with
// symmetrization (reference dpilqr/control.py:116-148).
//
// What bounds it on the H100: not bytes (per step a subproblem streams
// ~nxf^2 + K nx^2 values, a few KB) nor FLOPs (~10 nxf^3 per step), but the
// latency of a long chain of dependent small matrix phases: N steps x
// (8 phases + 2 barriers per pivot).  The design keeps that chain on chip:
// one CTA per subproblem runs the whole time loop, with P, p, the Q blocks
// and the Gauss-Jordan tableau in shared memory, threads spanning matrix
// entries and __syncthreads() between phases and between pivots.  Nothing
// round-trips through device memory between steps; S subproblems fill the
// SMs in parallel.  The arithmetic order follows the Pallas kernel (pivot
// order, pivot-row restore, reciprocal-multiply pivots, full-form update,
// Q_ux^T K taken as the transpose of K^T Q_ux).
//
// Layouts (all contiguous, subproblem-major inputs, JAX-layout outputs):
//   A   (S, N, K, nx, nx)   A_k[b][a] = d f_b / d x_a of slot k
//   B   (S, N, K, nx, nu)   zero for padded slots
//   Luu (S, N, nuf, nuf)    block-diagonal control Hessian
//   Lxx (S, N, nxf, nxf)    state Hessian incl. proximity coupling
//   Lx  (S, N, nxf), Lu (S, N, nuf), mu (S), p0 (S, nxf), P0 (S, nxf, nxf)
//   Kg  (N, nuf, nxf, S), d (N, nuf, S)   outputs
// with nxf = K nx, nuf = K nu.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void backward_batched_kernel(
    const T* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ Luu, const T* __restrict__ Lxx,
    const T* __restrict__ Lx, const T* __restrict__ Lu,
    const T* __restrict__ mu_s, const T* __restrict__ p0,
    const T* __restrict__ P0, T* __restrict__ Kg, T* __restrict__ dg,
    int S, int N, int K, int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nxf = K * nx, nuf = K * nu;
  const int ncol = nuf + nxf + 1;  // Gauss-Jordan tableau [Quu | Qux | Qu]
  T* P = sm;                 sm += nxf * nxf;
  T* AtP = sm;               sm += nxf * nxf;  // later K^T Q_ux
  T* Qxx = sm;               sm += nxf * nxf;  // later the unsymmetrized P
  T* W1 = sm;                sm += nuf * nxf;  // B^T (P + mu I)
  T* Qux = sm;               sm += nuf * nxf;
  T* Kt = sm;                sm += nuf * nxf;
  T* QuuK = sm;              sm += nuf * nxf;
  T* Quu = sm;               sm += nuf * nuf;
  T* M = sm;                 sm += nuf * ncol;
  T* At = sm;                sm += K * nx * nx;
  T* Bt = sm;                sm += K * nx * nu;
  T* p = sm;                 sm += nxf;
  T* Qx = sm;                sm += nxf;
  T* Qu = sm;                sm += nuf;
  T* dt = sm;                sm += nuf;
  T* w = sm;                 sm += nuf;
  T* prow = sm;              sm += ncol;
  T* colv = sm;              sm += nuf;

  const int s = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const T mu = mu_s[s];

  for (int i = tid; i < nxf * nxf; i += nth) P[i] = P0[(size_t)s * nxf * nxf + i];
  for (int i = tid; i < nxf; i += nth) p[i] = p0[(size_t)s * nxf + i];

  for (int t = N - 1; t >= 0; --t) {
    const size_t st = (size_t)s * N + t;
    for (int i = tid; i < K * nx * nx; i += nth) At[i] = A[st * K * nx * nx + i];
    for (int i = tid; i < K * nx * nu; i += nth) Bt[i] = B[st * K * nx * nu + i];
    __syncthreads();

    // Phase 1: Q_x, Q_u, A^T P, B^T (P + mu I).
    for (int i = tid; i < nxf; i += nth) {
      const int k = i / nx, j = i % nx;
      T acc = At[(k * nx) * nx + j] * p[k * nx];
      for (int b = 1; b < nx; ++b) acc += At[(k * nx + b) * nx + j] * p[k * nx + b];
      Qx[i] = Lx[st * nxf + i] + acc;
    }
    for (int i = tid; i < nuf; i += nth) {
      const int k = i / nu, j = i % nu;
      T acc = Bt[(k * nx) * nu + j] * p[k * nx];
      for (int b = 1; b < nx; ++b) acc += Bt[(k * nx + b) * nu + j] * p[k * nx + b];
      Qu[i] = Lu[st * nuf + i] + acc;
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
      Qxx[i] = Lxx[st * nxf * nxf + i] + acc;
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
      const T q = acc + Luu[st * nuf * nuf + i];
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

template <typename T>
size_t smem_bytes(int K, int nx, int nu) {
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu, ncol = nuf + nxf + 1;
  const size_t n = 3 * nxf * nxf + 4 * nuf * nxf + nuf * nuf + nuf * ncol +
                   (size_t)K * nx * (nx + nu) + 2 * nxf + 3 * nuf + ncol + nuf;
  return n * sizeof(T);
}

template <typename T>
int launch(const T* A, const T* B, const T* Luu, const T* Lxx, const T* Lx,
           const T* Lu, const T* mu, const T* p0, const T* P0, T* Kg, T* d,
           int S, int N, int K, int nx, int nu, void* stream) {
  if (S == 0 || N == 0) return 0;
  const size_t bytes = smem_bytes<T>(K, nx, nu);
  cudaError_t err = cudaFuncSetAttribute(
      backward_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  backward_batched_kernel<T><<<S, 256, bytes, (cudaStream_t)stream>>>(
      A, B, Luu, Lxx, Lx, Lu, mu, p0, P0, Kg, d, S, N, K, nx, nu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dpilqr_backward_batched_f32(
    const float* A, const float* B, const float* Luu, const float* Lxx,
    const float* Lx, const float* Lu, const float* mu, const float* p0,
    const float* P0, float* Kg, float* d, int S, int N, int K, int nx, int nu,
    void* stream) {
  return launch<float>(A, B, Luu, Lxx, Lx, Lu, mu, p0, P0, Kg, d, S, N, K, nx,
                       nu, stream);
}

extern "C" int dpilqr_backward_batched_f64(
    const double* A, const double* B, const double* Luu, const double* Lxx,
    const double* Lx, const double* Lu, const double* mu, const double* p0,
    const double* P0, double* Kg, double* d, int S, int N, int K, int nx,
    int nu, void* stream) {
  return launch<double>(A, B, Luu, Lxx, Lx, Lu, mu, p0, P0, Kg, d, S, N, K, nx,
                        nu, stream);
}
