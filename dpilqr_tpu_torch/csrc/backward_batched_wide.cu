// Batched Riccati backward pass for WIDE decomposed subproblems, its inputs
// computed inside the kernel.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_batched_wide.py ::
// backward_pass_batched_wide, the whole function: its XLA phase (:137-138,
// _quadraticize_batch and _linearize_batch) and its Pallas program
// (:156-293): the same contract and per-element arithmetic as
// backward_batched.cu (the inputs of computed_inputs.cuh, the Riccati
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
// conflict-free transposed reads, coalesced gains.  One thread per tile of
// the nxf^2 outputs (576 at nxf 96), at most 640.  The next step's inputs
// (computed_inputs.cuh, on this subproblem's view of the batch) are computed
// by the warps the register elimination leaves idle (up to 160 tableau
// columns); past that the elimination is in place on every warp and the
// prep runs after it, on the chain.
//
// Where the working set lives is chosen at launch from the type and the
// widths (wide_plan: riccati_plan with the input source's buffers in the
// gain group, computed_plan, then the cluster tier), and is a template
// argument of the kernel: all of it in shared memory where it fits; else
// the three nxf^2 matrices in a per-subproblem workspace in device memory
// (L2-resident: 14 MB in float64 at S = 64) with the gain blocks, the
// source's buffers, the tableau and the vectors in shared memory; else, where
// a thread-block cluster of at most 8 CTAs holds the whole working set in
// its distributed shared memory, on such a cluster (TIER 3,
// riccati_cluster.cuh: Quad6D at K = 32 in float32, nxf 192, where the
// device-memory workspace made a launch 36 ms at S = 16); else the gain
// blocks and the source's buffers in the workspace too.  The wrapper sizes
// the workspace with the same plan's host build (plan.cpp
// dpilqr_riccati_plan).
//
// Layouts: as backward_batched.cu, plus
//   work (S, plan.work values)        scratch from the wrapper.

#include "computed_inputs.cuh"
#include "riccati.cuh"
#include "riccati_cluster.cuh"

namespace {

constexpr int MIN_THREADS = 128, MAX_THREADS = 640;

// TIER 0-2: one CTA a subproblem (riccati_place); 3: a cluster of CTAs a
// subproblem (riccati_cluster.cuh), blockIdx.x / cluster size its index.
template <typename T, int TIER, int TILE>
__global__ void __launch_bounds__(TIER == 3 ? CLUSTER_THREADS : MAX_THREADS)
    backward_batched_wide_kernel(
        const T* __restrict__ X, const T* __restrict__ U, const T* __restrict__ xf,
        const T* __restrict__ Q, const T* __restrict__ R, const T* __restrict__ Qf,
        const T* __restrict__ mask, const T* __restrict__ refw,
        const T* __restrict__ radius, const T* __restrict__ pw,
        const int* __restrict__ npos, const int* __restrict__ mids,
        const int* __restrict__ ids, const T* __restrict__ dt,
        const T* __restrict__ mu_s, T* __restrict__ Kg, T* __restrict__ dg,
        T* __restrict__ work, long long work_each, int N, int K, int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu;
  if constexpr (TIER == 3) {
    const int s = blockIdx.x / (int)cg::this_cluster().num_blocks();
    const SlotProblem<T> pb = slot_problem(X, U, xf, Q, R, Qf, mask, refw, radius, pw,
                                           npos, mids, ids, dt[0], s, N, K, nx, nu);
    const size_t sN = (size_t)s * N;
    riccati_cluster_sweep<6>(pb, mu_s[s], Kg + sN * nuf * nxf, dg + sN * nuf, N, K, nx,
                             nu, sm);
  } else {
    const int s = blockIdx.x;
    T* extra = nullptr;
    const RiccatiWork<T> ws =
        riccati_place<TIER>(sm, work + (size_t)s * work_each, K, nx, nu,
                            sweep_extra_values(K, nx, nu), &extra);
    ComputedInputs<false, MAX_NX, T, SlotProblem<T>, 6> src;
    src.pb = slot_problem(X, U, xf, Q, R, Qf, mask, refw, radius, pw, npos, mids, ids,
                          dt[0], s, N, K, nx, nu);
    src.carve(extra, K, nx, nu);
    const size_t sN = (size_t)s * N;
    riccati_sweep_from<TILE>(src, mu_s[s], Kg + sN * nuf * nxf, dg + sN * nuf, N, K, nx,
                             nu, ws);
  }
}

template <typename T>
int launch(const T* X, const T* U, const T* xf, const T* Q, const T* R,
           const T* Qf, const T* mask, const T* refw, const T* radius,
           const T* pw, const int* npos, const int* mids, const int* ids,
           const T* dt, const T* mu, T* Kg, T* d, T* work, long long work_size,
           int S, int N, int K, int nx, int nu, void* stream) {
  if (K < 1 || nx < 1 || nu < 1 || nx > MAX_NX || nu > MAX_NU)
    return (int)cudaErrorInvalidValue;
  const RiccatiPlan plan =
      wide_plan(K, nx, nu, sizeof(T), max_shared_optin(), CLUSTER_MAX);
  if (plan.tier < 0 || (size_t)work_size < S * plan.work)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || N == 0) return 0;
  if (plan.tier == 3)
    return launch_cluster(backward_batched_wide_kernel<T, 3, 4>, S * plan.cluster,
                          CLUSTER_THREADS, plan.cluster, plan.smem * sizeof(T), stream, X,
                          U, xf, Q, R, Qf, mask, refw, radius, pw, npos, mids, ids, dt, mu,
                          Kg, d, work, (long long)plan.work, N, K, nx, nu);
  const int tile = riccati_tile(K * nx, plan.tier);
  const int threads = riccati_threads(K * nx, tile, MIN_THREADS, MAX_THREADS);
  const auto kernel = plan.tier == 2   ? backward_batched_wide_kernel<T, 2, 4>
                      : plan.tier == 1 ? backward_batched_wide_kernel<T, 1, 4>
                      : tile == 4      ? backward_batched_wide_kernel<T, 0, 4>
                                       : backward_batched_wide_kernel<T, 0, 2>;
  return launch_with_smem(kernel, S, threads, plan.smem * sizeof(T), stream, X, U,
                          xf, Q, R, Qf, mask, refw, radius, pw, npos, mids, ids,
                          dt, mu, Kg, d, work, (long long)plan.work, N, K, nx, nu);
}

}  // namespace

#define DPILQR_BACKWARD_WIDE(NAME, T)                                          \
  extern "C" int NAME(const T* X, const T* U, const T* xf, const T* Q,        \
                      const T* R, const T* Qf, const T* mask, const T* refw,  \
                      const T* radius, const T* pw, const int* npos,          \
                      const int* mids, const int* ids, const T* dt,           \
                      const T* mu, T* Kg, T* d, T* work, long long work_size, \
                      int S, int N, int K, int nx, int nu, void* stream) {    \
    return launch<T>(X, U, xf, Q, R, Qf, mask, refw, radius, pw, npos, mids,  \
                     ids, dt, mu, Kg, d, work, work_size, S, N, K, nx, nu,    \
                     stream);                                                 \
  }

DPILQR_BACKWARD_WIDE(dpilqr_backward_batched_wide_f32, float)
DPILQR_BACKWARD_WIDE(dpilqr_backward_batched_wide_f64, double)

#ifdef DPILQR_PHASE_CLOCKS
// This kernel's cycles by phase (riccati.cuh, RICCATI_CLOCK), read and reset.
extern "C" int dpilqr_riccati_phase_clocks(unsigned long long* out) {
  return riccati_read_phase_clocks(out);
}
#endif
