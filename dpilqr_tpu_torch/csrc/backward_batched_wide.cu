// Batched Riccati backward recursion for WIDE decomposed subproblems.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_batched_wide.py ::
// backward_pass_batched_wide (the Pallas program at :156-293): the same
// contract and per-element arithmetic as backward_batched.cu (the Riccati
// recursion of riccati.cuh, reference dpilqr/control.py:116-148) for
// subproblems wider than the narrow kernel takes: Quad6D at K=8 and K=16
// (nxf 48, 96), Quad12D at K=4 and K=8 (48, 96), mixed DoubleInt4D + Car3D
// + Bike5D fleets at K=8 (40).  The TPU needed a blocked layout to keep its
// program small; here the limit is shared memory, and the kernel itself has
// no width limit but what riccati_plan can place.
//
// What bounds it on the H100: one CTA walks N dependent steps, and a step
// at nxf 96, nuf 48 is 1.6 M multiply-adds behind 48 serial pivots.  The
// FMAs of one SM need about 7 us a step; the kernel takes 46 us (2.3 ms a
// sweep at S = 64, N = 50; scripts/riccati_phase_clocks.py splits it by
// phase): a third of it is the Gauss-Jordan's chain of pivots (a barrier
// and a reciprocal each), a third the three nuf-deep products, which at
// 4 x 4 register tiles read 2 bytes of shared memory per FMA and so run at
// the shared-memory rate, not the FMA rate.  The design (riccati.cuh):
// register tiles fed by vector loads in those products, a Gauss-Jordan that
// keeps the tableau in registers with one barrier per pivot and no update
// left of the pivot, shared-memory pointers the compiler can prove shared,
// the step's inputs copied in asynchronously, conflict-free transposed
// reads, coalesced gains.  One thread per tile of the nxf^2 outputs (576 at
// nxf 96), at most 640.
//
// Where the working set lives is chosen at launch from the type and the
// widths (riccati_plan), and is a template argument of the kernel: all of
// it in shared memory where it fits (float32 up to nxf 96, nuf 48: 228,544
// bytes of the 232,448 a block may use); else the three nxf^2 matrices in a
// per-subproblem workspace in device memory (L2-resident: 14 MB in float64
// at S = 64) with the gain blocks, the tableau and the vectors in shared
// memory (float64 at nxf 96, nuf 32); else the gain blocks in the workspace
// too (float64 at nuf 48).  The wrapper sizes the workspace with
// dpilqr_riccati_plan.
//
// Layouts: as backward_batched.cu, plus
//   work (S, plan.work values)        scratch from the wrapper.

#include "riccati.cuh"

namespace {

constexpr int MIN_THREADS = 128, MAX_THREADS = 640;

template <typename T, int TIER, int TILE>
__global__ void __launch_bounds__(MAX_THREADS) backward_batched_wide_kernel(
    const T* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ Luu, const T* __restrict__ Lxx,
    const T* __restrict__ Lx, const T* __restrict__ Lu,
    const T* __restrict__ mu_s, const T* __restrict__ p0,
    const T* __restrict__ P0, T* __restrict__ Kg, T* __restrict__ dg,
    T* __restrict__ work, long long work_each, int N, int K, int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int s = blockIdx.x;
  const RiccatiWork<T> ws =
      riccati_place<TIER>(sm, work + (size_t)s * work_each, K, nx, nu);
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu, sN = (size_t)s * N;
  riccati_sweep<TILE, TIER>(A + sN * K * nx * nx, B + sN * K * nx * nu,
                      Luu + sN * nuf * nuf, Lxx + sN * nxf * nxf, Lx + sN * nxf,
                      Lu + sN * nuf, mu_s[s], p0 + s * nxf, P0 + s * nxf * nxf,
                      Kg + sN * nuf * nxf, dg + sN * nuf, N, K, nx, nu, ws);
}

template <typename T>
int launch(const T* A, const T* B, const T* Luu, const T* Lxx, const T* Lx,
           const T* Lu, const T* mu, const T* p0, const T* P0, T* Kg, T* d,
           T* work, long long work_size, int S, int N, int K, int nx, int nu,
           void* stream) {
  if (K < 1 || nx < 1 || nu < 1) return (int)cudaErrorInvalidValue;
  const RiccatiPlan plan = riccati_plan(K, nx, nu, sizeof(T), max_shared_optin());
  if (plan.tier < 0 || (size_t)work_size < S * plan.work)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || N == 0) return 0;
  const int tile = riccati_tile(K * nx, plan.tier);
  const int threads = riccati_threads(K * nx, tile, MIN_THREADS, MAX_THREADS);
  const auto kernel = plan.tier == 2   ? backward_batched_wide_kernel<T, 2, 4>
                      : plan.tier == 1 ? backward_batched_wide_kernel<T, 1, 4>
                      : tile == 4      ? backward_batched_wide_kernel<T, 0, 4>
                                       : backward_batched_wide_kernel<T, 0, 2>;
  return launch_with_smem(kernel, S, threads, plan.smem * sizeof(T), stream, A,
                          B, Luu, Lxx, Lx, Lu, mu, p0, P0, Kg, d, work,
                          (long long)plan.work, N, K, nx, nu);
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

// Where one problem's working set goes on the current device (riccati_plan):
// returns the tier (0 all in shared memory, 1 the value group in the
// workspace, 2 the gain group too, -1 no fit) and writes the shared-memory
// bytes of a CTA and the workspace values of one problem.  The Python
// wrappers of this kernel and of backward_sweep.cu size their workspace
// through it, so the layout is defined once, in riccati.cuh.
extern "C" int dpilqr_riccati_plan(int K, int nx, int nu, int itemsize,
                                   long long* smem_bytes,
                                   long long* work_values) {
  const RiccatiPlan plan = riccati_plan(K, nx, nu, itemsize, max_shared_optin());
  *smem_bytes = (long long)(plan.smem * itemsize);
  *work_values = (long long)plan.work;
  return plan.tier;
}

#ifdef DPILQR_PHASE_CLOCKS
// This kernel's cycles by phase (riccati.cuh, RICCATI_CLOCK), read and reset.
extern "C" int dpilqr_riccati_phase_clocks(unsigned long long* out) {
  return riccati_read_phase_clocks(out);
}
#endif
