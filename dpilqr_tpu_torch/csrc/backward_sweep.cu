// Centralized Riccati backward sweep: one iLQR problem over the whole fleet.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_sweeps.py ::
// backward_pass_pallas (the Pallas program at :458-513): the value
// recursion of reference dpilqr/control.py:116-148 for one problem of n
// agents, nxf = n nx, nuf = n nu, returning the flat gains K (N, nuf, nxf)
// and d (N, nuf).  The Pallas kernel took dense flat-space A_f, B_f (a
// Mosaic constraint); this one takes the block-diagonal per-agent A and B
// and runs the algebra of riccati.cuh, the decomposed kernels' recursion at
// one problem with n slots (its products and sums group differently from
// the Pallas kernel's dense matmuls, so results agree to rounding).  The
// Q_uu solve is the unpivoted Gauss-Jordan of dpilqr_tpu/ops/ilqr.py
// gauss_jordan_solve, with the pivot row restored after elimination.
//
// What bounds it on the H100: a single problem is one dependent chain of N
// steps x (8 phases + a barrier per pivot), so it is latency-bound and
// runs on one SM; the 10-agent problem (nxf 40, nuf 20) streams a few KB a
// step.  Design: one CTA of 512 threads runs the whole sweep with the
// register tiles and the one-barrier Gauss-Jordan of riccati.cuh.  When the
// working set (~96 n^2 values for unicycles) fits the 227 KB of shared
// memory (up to 17 unicycles in float64, 24 in float32) all of it lives
// there; past that riccati_plan moves the matrices to a workspace in device
// memory (L2-resident for any fleet a single problem is solved for).
//
// Layouts (contiguous): A (N, n, nx, nx), B (N, n, nx, nu) (zero for
// masked agents), Luu (N, nuf, nuf), Lxx (N, nxf, nxf), Lx (N, nxf),
// Lu (N, nuf), mu (1), p0 (nxf), P0 (nxf, nxf) -> K (N, nuf, nxf),
// d (N, nuf); work holds the values dpilqr_riccati_plan asks for.

#include "riccati.cuh"

namespace {

constexpr int THREADS = 512;

template <typename T, int TIER, int TILE>
__global__ void __launch_bounds__(THREADS) backward_sweep_kernel(
    const T* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ Luu, const T* __restrict__ Lxx,
    const T* __restrict__ Lx, const T* __restrict__ Lu,
    const T* __restrict__ mu, const T* __restrict__ p0,
    const T* __restrict__ P0, T* __restrict__ Kg, T* __restrict__ dg,
    T* __restrict__ work, int N, int n, int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const RiccatiWork<T> ws = riccati_place<TIER>(sm, work, n, nx, nu);
  riccati_sweep<TILE, TIER>(A, B, Luu, Lxx, Lx, Lu, mu[0], p0, P0, Kg, dg, N, n, nx,
                      nu, ws);
}

template <typename T>
int launch(const T* A, const T* B, const T* Luu, const T* Lxx, const T* Lx,
           const T* Lu, const T* mu, const T* p0, const T* P0, T* Kg, T* d,
           T* work, long long work_size, int N, int n, int nx, int nu,
           void* stream) {
  if (n < 1 || nx < 1 || nu < 1) return (int)cudaErrorInvalidValue;
  const RiccatiPlan plan = riccati_plan(n, nx, nu, sizeof(T), max_shared_optin());
  if (plan.tier < 0 || (size_t)work_size < plan.work)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const auto kernel = plan.tier == 2   ? backward_sweep_kernel<T, 2, 4>
                      : plan.tier == 1 ? backward_sweep_kernel<T, 1, 4>
                      : riccati_tile(n * nx, 0) == 4
                          ? backward_sweep_kernel<T, 0, 4>
                          : backward_sweep_kernel<T, 0, 2>;
  return launch_with_smem(kernel, 1, THREADS, plan.smem * sizeof(T), stream, A,
                          B, Luu, Lxx, Lx, Lu, mu, p0, P0, Kg, d, work, N, n,
                          nx, nu);
}

}  // namespace

#define DPILQR_BACKWARD_SWEEP(NAME, T)                                         \
  extern "C" int NAME(const T* A, const T* B, const T* Luu, const T* Lxx,      \
                      const T* Lx, const T* Lu, const T* mu, const T* p0,      \
                      const T* P0, T* K, T* d, T* work, long long work_size,   \
                      int N, int n, int nx, int nu, void* stream) {            \
    return launch<T>(A, B, Luu, Lxx, Lx, Lu, mu, p0, P0, K, d, work,           \
                     work_size, N, n, nx, nu, stream);                         \
  }

DPILQR_BACKWARD_SWEEP(dpilqr_backward_sweep_f32, float)
DPILQR_BACKWARD_SWEEP(dpilqr_backward_sweep_f64, double)
