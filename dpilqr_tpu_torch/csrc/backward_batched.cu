// Batched Riccati backward recursion for the decomposed DP-iLQR solve.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_batched.py ::
// backward_pass_batched (the Pallas program at :421-479): for every
// subproblem s the Riccati recursion of riccati.cuh (reference
// dpilqr/control.py:116-148), for subproblems whose flat state is at most
// 32 wide (nxf = K nx <= 32, nuf = K nu <= 32).
//
// What bounds it on the H100: not bytes (per step a subproblem streams
// ~nxf^2 + K nx^2 values, a few KB) nor FLOPs (~10 nxf^3 per step, which
// 256 threads issue in a few hundred cycles), but the latency of a long
// chain of dependent small matrix phases: N steps x (phases + pivots).  A
// launch takes the same time at S = 16 and S = 128: the chain, not the
// grid, is the time.  With so little arithmetic, what a step walks is
// mostly index and loop code (divisions by nx and nu, thread grids, loops
// of run-time trip counts) and the pivots' chain; its barriers are cheap
// (scripts/riccati_phase_clocks.py --kernel narrow: a step took 16,400
// cycles at nxf 4 and 24,300 at nxf 32 before this design, 9,200 and 12,000
// with it).  The design keeps the chain on chip and shortens it: one CTA
// per subproblem runs the whole time loop, with P, p, the Q blocks and the
// Gauss-Jordan tableau in shared memory (54 KB in float64 at nxf = 32) and
// 2 x 2 register tiles in the products; the elimination runs in ONE warp's
// registers with no barrier (gauss_jordan_warp: a lane owns columns lane,
// lane + 32, ... of all rows, a pivot is a reciprocal, a shuffle a row and
// the multiply-adds) and stores the gains itself, while the other warps
// fetch the next step's inputs, which have landed before the barrier that
// ends the step; slots of 4 states and 2 controls, the 100-agent main
// path's, compile their widths in, and at K = 8 the slot count too, so that
// the index arithmetic folds away.  The kernel is instantiated for nuf <= 8,
// 16 and 32 (the rows of the register tableau).  Nothing round-trips through
// device memory between steps; S subproblems fill the SMs in parallel.
// Wider subproblems take backward_batched_wide.cu.
//
// Layouts (all contiguous, subproblem-major):
//   A   (S, N, K, nx, nx)   A_k[b][a] = d f_b / d x_a of slot k
//   B   (S, N, K, nx, nu)   zero for padded slots
//   Luu (S, N, nuf, nuf)    block-diagonal control Hessian
//   Lxx (S, N, nxf, nxf)    state Hessian incl. proximity coupling
//   Lx  (S, N, nxf), Lu (S, N, nuf), mu (S), p0 (S, nxf), P0 (S, nxf, nxf)
//   Kg  (S, N, nuf, nxf), d (S, N, nuf)   outputs
// with nxf = K nx, nuf = K nu.  The Python wrapper hands the outputs out as
// permuted views in the JAX package's shapes (N, nuf, nxf, S), (N, nuf, S).

#include "riccati.cuh"

namespace {

// Threads a CTA; scripts/riccati_phase_clocks.py --threads rebuilds with
// another count to measure it (128 threads: 9% slower at nxf 32, 6% faster
// at nxf 4, measured before the slot widths were compiled in).
#ifndef DPILQR_NARROW_THREADS
#define DPILQR_NARROW_THREADS 256
#endif
constexpr int THREADS = DPILQR_NARROW_THREADS;

// NR, NCB: rows and 32-column blocks of the elimination's register tableau;
// NXS, NUS, KS: the slot widths and the slot count at compile time, or 0.
template <typename T, int NR, int NCB, int NXS, int NUS, int KS>
__global__ void __launch_bounds__(THREADS) backward_batched_kernel(
    const T* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ Luu, const T* __restrict__ Lxx,
    const T* __restrict__ Lx, const T* __restrict__ Lu,
    const T* __restrict__ mu_s, const T* __restrict__ p0,
    const T* __restrict__ P0, T* __restrict__ Kg, T* __restrict__ dg,
    int N, int K, int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const RiccatiWork<T> ws = riccati_place<0>(sm, (T*)nullptr, K, nx, nu);
  const int s = blockIdx.x;
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu, sN = (size_t)s * N;
  riccati_sweep<2, 0, NR, NCB, NXS, NUS, KS>(
      A + sN * K * nx * nx, B + sN * K * nx * nu, Luu + sN * nuf * nuf,
      Lxx + sN * nxf * nxf, Lx + sN * nxf, Lu + sN * nuf, mu_s[s], p0 + s * nxf,
      P0 + s * nxf * nxf, Kg + sN * nuf * nxf, dg + sN * nuf, N, K, nx, nu, ws);
}

template <typename T>
int launch(const T* A, const T* B, const T* Luu, const T* Lxx, const T* Lx,
           const T* Lu, const T* mu, const T* p0, const T* P0, T* Kg, T* d,
           int S, int N, int K, int nx, int nu, void* stream) {
  if (K * nx > 32 || K * nu > 32) return (int)cudaErrorInvalidValue;
  if (S == 0 || N == 0) return 0;
  const RiccatiPlan plan = riccati_plan(K, nx, nu, sizeof(T), max_shared_optin());
  if (plan.tier != 0) return (int)cudaErrorInvalidValue;
  // Slots of 4 states and 2 controls (Unicycle4D, DoubleInt4D: the 100-agent
  // main path) have their widths compiled in, and K = 8, the width that path
  // runs at, its slot count too; K <= 8 there, so nuf <= 16.
  const bool s42 = nx == 4 && nu == 2;
  const auto kernel =
      K * nu <= 8    ? (s42 ? backward_batched_kernel<T, 8, 2, 4, 2, 0>
                            : backward_batched_kernel<T, 8, 2, 0, 0, 0>)
      : K * nu <= 16 ? (s42 ? (K == 8 ? backward_batched_kernel<T, 16, 2, 4, 2, 8>
                                      : backward_batched_kernel<T, 16, 2, 4, 2, 0>)
                            : backward_batched_kernel<T, 16, 2, 0, 0, 0>)
                     : backward_batched_kernel<T, 32, 3, 0, 0, 0>;
  return launch_with_smem(kernel, S, THREADS, plan.smem * sizeof(T), stream, A,
                          B, Luu, Lxx, Lx, Lu, mu, p0, P0, Kg, d, N, K, nx, nu);
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

#ifdef DPILQR_PHASE_CLOCKS
// This kernel's cycles by phase (riccati.cuh, RICCATI_CLOCK), read and reset.
extern "C" int dpilqr_riccati_phase_clocks_narrow(unsigned long long* out) {
  return riccati_read_phase_clocks(out);
}
#endif
