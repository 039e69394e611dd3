// Batched Riccati backward recursion for WIDE decomposed subproblems.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_batched_wide.py ::
// backward_pass_batched_wide (the Pallas program at :156-293): the same
// contract and per-element arithmetic as backward_batched.cu (the Riccati
// recursion of riccati.cuh, reference dpilqr/control.py:116-148) for
// subproblems with 32 < nxf = K nx <= 96 (then nuf = K nu <= 64): Quad6D
// at K=8 and K=16 (nxf 48, 96), Quad12D at K=4 and K=8 (48, 96), mixed
// DoubleInt4D + Car3D + Bike5D fleets at K=8 (40).  The TPU needed a
// blocked layout to keep its program small; here the limit is shared
// memory.
//
// What bounds it on the H100: the same latency chain as the narrow kernel
// (N steps x (8 phases + 2 barriers per pivot)), with up to 9x more work per
// phase (nxf^2 = 9216 entries at nxf = 96).  K1's all-shared layout needs
// 47,073 values at nxf = 96, nuf = 32: 377 KB in float64, over the 227 KB a
// block may use.  So the three nxf^2 matrices (P, A^T P, Q_xx) live in a
// per-subproblem workspace in device memory (~14 MB in float64 at S = 64,
// resident in the 50 MB L2 and read through L1), while the gain blocks,
// the Gauss-Jordan tableau (33 KB in float64 at nuf = 32) and the vectors
// stay in shared memory.  Where the gain blocks do not fit either (nuf = 48
// or 64 in float64) they move to the workspace too.  One CTA of 512
// threads per subproblem: the wide batches are small (S ~ 64 on 132 SMs),
// so each CTA gets more threads than K1's 256.
//
// Layouts: as backward_batched.cu, plus
//   work (S, dpilqr_riccati_work_size values)        scratch from the wrapper.

#include "riccati.cuh"

namespace {

constexpr int THREADS = 512;

template <typename T>
__global__ void __launch_bounds__(THREADS) backward_batched_wide_kernel(
    const T* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ Luu, const T* __restrict__ Lxx,
    const T* __restrict__ Lx, const T* __restrict__ Lu,
    const T* __restrict__ mu_s, const T* __restrict__ p0,
    const T* __restrict__ P0, T* __restrict__ Kg, T* __restrict__ dg,
    T* __restrict__ work, int gain_shared, int S, int N, int K, int nx,
    int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const RiccatiSizes z = riccati_sizes(K, nx, nu);
  const int s = blockIdx.x;
  T* own = work + s * (z.value + z.gain);
  const RiccatiWork<T> ws =
      gain_shared ? riccati_carve(own, sm, sm + z.gain, K, nx, nu)
                  : riccati_carve(own, own + z.value, sm, K, nx, nu);
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu, sN = (size_t)s * N;
  riccati_sweep(A + sN * K * nx * nx, B + sN * K * nx * nu, Luu + sN * nuf * nuf,
                Lxx + sN * nxf * nxf, Lx + sN * nxf, Lu + sN * nuf, mu_s[s],
                p0 + s * nxf, P0 + s * nxf * nxf, Kg, dg, S, s, N, K, nx, nu, ws);
}

template <typename T>
int launch(const T* A, const T* B, const T* Luu, const T* Lxx, const T* Lx,
           const T* Lu, const T* mu, const T* p0, const T* P0, T* Kg, T* d,
           T* work, long long work_size, int S, int N, int K, int nx, int nu,
           void* stream) {
  const RiccatiSizes z = riccati_sizes(K, nx, nu);
  if (K * nx > 96 || K * nu > 64 || (size_t)work_size < S * (z.value + z.gain))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || N == 0) return 0;
  const long long optin = max_shared_optin();
  if (optin < 0) return (int)cudaErrorInvalidDevice;
  const size_t gain_vec = (z.gain + z.vec) * sizeof(T);
  const int gain_shared = gain_vec <= (size_t)optin;
  return launch_with_smem(backward_batched_wide_kernel<T>, S, THREADS,
                          gain_shared ? gain_vec : z.vec * sizeof(T), stream, A,
                          B, Luu, Lxx, Lx, Lu, mu, p0, P0, Kg, d, work,
                          gain_shared, S, N, K, nx, nu);
}

}  // namespace

#define DPILQR_BACKWARD_WIDE(NAME, T)                                          \
  extern "C" int NAME(const T* A, const T* B, const T* Luu, const T* Lxx,      \
                      const T* Lx, const T* Lu, const T* mu, const T* p0,      \
                      const T* P0, T* Kg, T* d, T* work,                       \
                      long long work_size, int S, int N, int K, int nx,        \
                      int nu, void* stream) {                                  \
    return launch<T>(A, B, Luu, Lxx, Lx, Lu, mu, p0, P0, Kg, d, work,          \
                     work_size, S, N, K, nx, nu, stream);                      \
  }

DPILQR_BACKWARD_WIDE(dpilqr_backward_batched_wide_f32, float)
DPILQR_BACKWARD_WIDE(dpilqr_backward_batched_wide_f64, double)

// The values of the value and gain groups of one problem (riccati_sizes):
// the per-problem workspace this kernel and backward_sweep.cu take.  The
// Python wrappers size their workspace through it, so the layout is
// defined once.
extern "C" long long dpilqr_riccati_work_size(int K, int nx, int nu) {
  const RiccatiSizes z = riccati_sizes(K, nx, nu);
  return (long long)(z.value + z.gain);
}
