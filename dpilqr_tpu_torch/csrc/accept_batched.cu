// The accept step of one batched iLQR iteration: each subproblem's choice of
// line-search candidate, its regularization update and its convergence flags.
//
// Replaces the accept step of dpilqr_tpu/ops/pallas_batched.py ::
// batched_iteration (:1055-1097), which is no Pallas kernel: XLA fuses it
// into the iteration's program.  The port had it as some 40 separate torch
// operations; here it is one launch, so that an iteration of the batched
// solve is K1 (or K3), K2 twice and this kernel, and replays as one CUDA
// graph (ops/batched.py).  Per subproblem s, in the order of the torch
// version (ops/batched.py accept_batched_torch, reference
// dpilqr/control.py:150-237):
//   improved = Jc[:, s] < J[s]; accept = any(improved); a_idx = the first
//   improving alpha (0 where none); Jn = Jc[a_idx, s];
//   upd = active & accept: X[s] = [x0[s]; X5[a_idx, s]], U[s] = U5[a_idx, s],
//   J[s] = Jn;
//   rel = |(J - Jn) / max(|J|, tiny)|, converged_now = upd & rel < tol,
//   failed_now = active & ~accept;
//   mu and delta: decrease on acceptance (floored at mu_min with mu_floor,
//   else snapped to 0), with on_failed_ls="increase" the increase schedule
//   on a failed search and failure only past mu_max;
//   i += active; converged |= converged_now; failed |= failed_now;
//   active &= ~converged_now & ~failed_now & (i < n_lqr_iter).
// Then the number of active subproblems is written to counter[0], the one
// value the host reads an iteration.
//
// It updates the carry (X, U, J, mu, delta, i, converged, failed, active) in
// place: a graph's replays need fixed addresses, and every subproblem reads
// and writes only its own entries (its CTA's).
//
// Bits: the same as the torch version on the card, in float32 and float64.
// The arithmetic is compares, selects, one subtraction, one division and
// multiplications, written with the _rn intrinsics so that nvcc contracts
// none of them into a fused multiply-add (torch does not fuse them either).
// torch on the card divides a tensor by a Python scalar as a multiplication
// by the scalar's reciprocal (ATen's div_true_kernel_cuda), so delta_dec is
// min(delta, 1) * (1 / delta_0) here too; a clamp passes NaN through as
// torch's does.
//
// What bounds it on the H100: bytes, and they are few: the J_c column of
// every subproblem, its scalars, and for each updated subproblem one
// candidate row of X5 and U5 read and its X and U written (contiguous, in
// the column-major candidate layout).  At the main path's width (S = 100,
// N = 50, K = 8) that is 1 MB, 0.3 us at 3.35 TB/s, so the launch itself
// costs more.  Design: one CTA per subproblem; its thread 0 decides, the
// CTA copies the chosen rows with neighbouring threads on neighbouring
// addresses; the last CTA to finish (a counter of finished CTAs, reset to
// 0 by that CTA) counts the active flags.  No second kernel, no host sync.
//
// Layouts (contiguous): X5 (n_alpha, S, N, K, nx), U5 (n_alpha, S, N, K, nu),
// Jc (n_alpha, S), x0 (S, K, nx) -> in place X (S, N+1, K, nx),
// U (S, N, K, nu), J / mu / delta (S), i (S) int32, converged / failed /
// active (S) bool (one byte); counter (2) int32: [active count, finished
// CTAs, 0 between launches].

#include <cfloat>
#include <cmath>

#include "launch.cuh"

namespace {

constexpr int ACCEPT_THREADS = 128;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }
__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }

// torch.clamp(v, min=lo) and torch.clamp(v, max=hi): NaN passes through.
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v != v ? v : (v < lo ? lo : v);
}
template <typename T>
__device__ __forceinline__ T clamp_max(T v, T hi) {
  return v != v ? v : (v > hi ? hi : v);
}

template <typename T>
__global__ void __launch_bounds__(ACCEPT_THREADS) accept_batched_kernel(
    const T* __restrict__ X5, const T* __restrict__ U5,
    const T* __restrict__ Jc, const T* __restrict__ x0, T* __restrict__ X,
    T* __restrict__ U, T* __restrict__ J, T* __restrict__ mu,
    T* __restrict__ delta, int* __restrict__ iters,
    unsigned char* __restrict__ converged, unsigned char* __restrict__ failed,
    unsigned char* active, int* counter, int S, int N, int nxf, int nuf,
    int n_alpha, T tol, T mu_min, T mu_max, T delta_0, T mu_lo, int increase,
    int n_lqr_iter) {
  // [upd, a_idx, last CTA, active count]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* flags = reinterpret_cast<int*>(smem_raw);
  const int s = blockIdx.x;
  if (threadIdx.x == 0) {
    const T Jold = J[s];
    int a_idx = 0;
    bool accept = false;
    for (int a = 0; a < n_alpha; ++a)
      if (Jc[(size_t)a * S + s] < Jold) {
        a_idx = a;
        accept = true;
        break;
      }
    const T Jn = Jc[(size_t)a_idx * S + s];
    const bool act = active[s] != 0;
    const bool upd = act && accept;
    const T rel =
        abs_of(div_rn(sub_rn(Jold, Jn), clamp_min(abs_of(Jold), tiny_of(Jold))));
    const bool conv_now = upd && rel < tol;
    bool fail_now = act && !accept;
    const T mu0 = mu[s], delta0 = delta[s];
    const T delta_dec = mul_rn(clamp_max(delta0, T(1)), div_rn(T(1), delta_0));
    T mu_dec = mul_rn(mu0, delta_dec);
    if (mu_dec <= mu_min) mu_dec = mu_lo;
    T mu_new = upd ? mu_dec : mu0, delta_new = upd ? delta_dec : delta0;
    if (increase) {
      const T delta_inc = mul_rn(clamp_min(delta0, T(1)), delta_0);
      const T mu_inc = clamp_min(mul_rn(mu0, delta_inc), mu_min);
      if (!upd && act) {
        mu_new = mu_inc;
        delta_new = delta_inc;
      }
      fail_now = fail_now && mu_inc >= mu_max;
    }
    const int it = iters[s] + (act ? 1 : 0);
    J[s] = upd ? Jn : Jold;
    mu[s] = mu_new;
    delta[s] = delta_new;
    iters[s] = it;
    converged[s] = converged[s] || conv_now;
    failed[s] = failed[s] || fail_now;
    active[s] = act && !conv_now && !fail_now && it < n_lqr_iter;
    flags[0] = upd;
    flags[1] = a_idx;
    flags[3] = 0;
  }
  __syncthreads();
  if (flags[0]) {
    const size_t col = (size_t)flags[1] * S + s;
    T* Xs = X + (size_t)s * (N + 1) * nxf;
    for (int k = threadIdx.x; k < nxf; k += blockDim.x)
      Xs[k] = x0[(size_t)s * nxf + k];
    const T* xr = X5 + col * N * nxf;
    for (int k = threadIdx.x; k < N * nxf; k += blockDim.x) Xs[nxf + k] = xr[k];
    const T* ur = U5 + col * N * nuf;
    T* Us = U + (size_t)s * N * nuf;
    for (int k = threadIdx.x; k < N * nuf; k += blockDim.x) Us[k] = ur[k];
  }
  // The last CTA to finish counts the active flags of all.
  if (threadIdx.x == 0) {
    __threadfence();
    flags[2] = atomicAdd(&counter[1], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!flags[2]) return;
  const volatile unsigned char* act = active;
  int n = 0;
  for (int k = threadIdx.x; k < S; k += blockDim.x) n += act[k] != 0;
  atomicAdd(&flags[3], n);
  __syncthreads();
  if (threadIdx.x == 0) {
    counter[0] = flags[3];
    counter[1] = 0;
  }
}

template <typename T>
int launch(const T* X5, const T* U5, const T* Jc, const T* x0, T* X, T* U, T* J,
           T* mu, T* delta, int* iters, unsigned char* converged,
           unsigned char* failed, unsigned char* active, int* counter, int S,
           int N, int K, int nx, int nu, int n_alpha, double tol, double mu_min,
           double mu_max, double delta_0, int mu_floor, int increase,
           int n_lqr_iter, void* stream) {
  if (S < 0 || N < 0 || K < 1 || nx < 1 || nu < 1 || n_alpha < 1)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  // The config's Python floats as torch casts a scalar to the tensor's type.
  const T lo = mu_floor ? (T)mu_min : T(0);
  return launch_with_smem(accept_batched_kernel<T>, dim3(S), ACCEPT_THREADS,
                          4 * sizeof(int), stream, X5, U5, Jc, x0, X, U, J, mu,
                          delta, iters, converged, failed, active, counter, S, N,
                          K * nx, K * nu, n_alpha, (T)tol, (T)mu_min, (T)mu_max,
                          (T)delta_0, lo, increase, n_lqr_iter);
}

}  // namespace

#define DPILQR_ACCEPT(NAME, T)                                                   \
  extern "C" int NAME(const T* X5, const T* U5, const T* Jc, const T* x0, T* X,  \
                      T* U, T* J, T* mu, T* delta, int* iters,                   \
                      unsigned char* converged, unsigned char* failed,           \
                      unsigned char* active, int* counter, int S, int N, int K,  \
                      int nx, int nu, int n_alpha, double tol, double mu_min,    \
                      double mu_max, double delta_0, int mu_floor, int increase, \
                      int n_lqr_iter, void* stream) {                            \
    return launch<T>(X5, U5, Jc, x0, X, U, J, mu, delta, iters, converged,       \
                     failed, active, counter, S, N, K, nx, nu, n_alpha, tol,     \
                     mu_min, mu_max, delta_0, mu_floor, increase, n_lqr_iter,    \
                     stream);                                                    \
  }

DPILQR_ACCEPT(dpilqr_accept_batched_f32, float)
DPILQR_ACCEPT(dpilqr_accept_batched_f64, double)
