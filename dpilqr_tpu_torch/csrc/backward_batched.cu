// Batched Riccati backward pass for the decomposed DP-iLQR solve, its inputs
// computed inside the kernel.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_batched.py ::
// backward_pass_batched, the whole function: its XLA phase (:417-418, the
// time-batched quadraticization _quadraticize_batch and the Jacobians
// _linearize_batch, with the dense L_xx, L_uu embedding) and its Pallas
// program (:421-479): for every subproblem s the Riccati recursion of
// riccati.cuh (reference dpilqr/control.py:116-148), for subproblems whose
// flat state is at most 32 wide (nxf = K nx <= 32, nuf = K nu <= 32).  It
// reads a subproblem's trajectory, its per-slot cost and models, and writes
// its gains: no Jacobian, gradient or Hessian goes through device memory.
//
// What bounds it on the H100: not bytes (a subproblem reads its trajectory,
// ~(K nx + K nu) values a step, and writes its gains, nuf nxf a step) nor
// FLOPs (~10 nxf^3 a step for the recursion, a few thousand for a step's
// inputs), but the latency of a long chain of dependent small matrix
// phases: N steps x (phases + pivots).  A launch takes about the same time
// at S = 16 and S = 128: the chain, not the grid, is the time.  With so
// little arithmetic, what a step walks is mostly index and loop code and the
// pivots' chain (scripts/riccati_phase_clocks.py --kernel narrow: a step
// took 16,400 cycles at nxf 4 and 24,300 at nxf 32 before this design,
// 9,200 and 12,000 with it, with its inputs copied in).  The design keeps
// the chain on chip and shortens it: one CTA per subproblem runs the whole
// time loop, with P, p, the Q blocks and the Gauss-Jordan tableau in shared
// memory and 2 x 2 register tiles in the products; the elimination runs in
// ONE warp's registers with no barrier (gauss_jordan_warp: a lane owns
// columns lane, lane + 32, ... of all rows, a pivot is a reciprocal, a
// shuffle a row and the multiply-adds) and stores the gains itself, while
// the other seven warps compute the next step's inputs (computed_inputs.cuh,
// K5's input source on this subproblem's view of the batch: a Jacobian
// column by one dual evaluation of its slot's model, an ordered pair's
// Hessian block and gradient term, then each slot's L_x, L_u and diagonal
// block), which are in shared memory before the barrier that ends the step;
// L_xx and L_uu are read entry by entry from those blocks where phase 2 adds
// them.  Slots of 4 states and 2 controls, the 100-agent main path's,
// compile their widths (and the models' width) in, and at K = 8 the slot
// count too, with the prep inlined, so that the index arithmetic folds away.
// The kernel is instantiated for nuf <= 8, 16 and 32 (the rows of the
// register tableau).  Nothing round-trips through device memory between
// steps; S subproblems fill the SMs in parallel.  Wider subproblems take
// backward_batched_wide.cu.
//
// Layouts (all contiguous, subproblem-major):
//   X (S, N+1, K, nx), U (S, N, K, nu), xf (S, K, nx), Q, Qf (S, K, nx, nx),
//   R (S, K, nu, nu), mask (S, K), refw, radius, pw, mu (S), npos, mids
//   (S, K) int32 (mids: branch indices into ids, the fleet's unique model
//   ids, int32), dt (1)
//   -> Kg (S, N, nuf, nxf), d (S, N, nuf)
// with nxf = K nx, nuf = K nu.  The Python wrapper hands the outputs out as
// permuted views in the JAX package's shapes (N, nuf, nxf, S), (N, nuf, S).

#include "computed_inputs.cuh"
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
// NXC: the state width the models are compiled for (at MAX_NX slots of up
// to 6 states take a prep compiled for 6); NXS, NUS, KS: the slot widths and
// the slot count at compile time, or 0 (KS: the prep inlined).
template <typename T, int NR, int NCB, int NXC, int NXS, int NUS, int KS>
__global__ void __launch_bounds__(THREADS) backward_batched_kernel(
    const T* __restrict__ X, const T* __restrict__ U, const T* __restrict__ xf,
    const T* __restrict__ Q, const T* __restrict__ R, const T* __restrict__ Qf,
    const T* __restrict__ mask, const T* __restrict__ refw,
    const T* __restrict__ radius, const T* __restrict__ pw,
    const int* __restrict__ npos, const int* __restrict__ mids,
    const int* __restrict__ ids, const T* __restrict__ dt,
    const T* __restrict__ mu_s, T* __restrict__ Kg, T* __restrict__ dg, int N,
    int K, int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* extra = nullptr;
  const RiccatiWork<T> ws = riccati_place<0>(
      sm, (T*)nullptr, K, nx, nu, sweep_extra_values(K, nx, nu), &extra);
  const int s = blockIdx.x;
  ComputedInputs<KS != 0, NXC, T, SlotProblem<T>, NXC == MAX_NX ? 6 : 0> src;
  src.pb = slot_problem(X, U, xf, Q, R, Qf, mask, refw, radius, pw, npos, mids, ids,
                        dt[0], s, N, K, nx, nu);
  src.carve(extra, K, nx, nu);
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu, sN = (size_t)s * N;
  riccati_sweep_from<2, NR, NCB, NXS, NUS, KS>(src, mu_s[s], Kg + sN * nuf * nxf,
                                               dg + sN * nuf, N, K, nx, nu, ws);
}

template <typename T>
int launch(const T* X, const T* U, const T* xf, const T* Q, const T* R,
           const T* Qf, const T* mask, const T* refw, const T* radius,
           const T* pw, const int* npos, const int* mids, const int* ids,
           const T* dt, const T* mu, T* Kg, T* d, int S, int N, int K, int nx,
           int nu, void* stream) {
  if (K < 1 || nx < 1 || nu < 1 || nx > MAX_NX || nu > MAX_NU || K * nx > 32 ||
      K * nu > 32)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || N == 0) return 0;
  const RiccatiPlan plan = computed_plan(K, nx, nu, sizeof(T), max_shared_optin());
  if (plan.tier != 0) return (int)cudaErrorInvalidValue;
  // Slots of 4 states and 2 controls (Unicycle4D, DoubleInt4D: the 100-agent
  // main path) have their widths compiled in, the models' width too (every
  // model of such a fleet is at most 4 wide), and K = 8, the width that path
  // runs at, its slot count and the inlined prep; K <= 8 there, so nuf <= 16.
  const bool s42 = nx == 4 && nu == 2;
  const auto kernel =
      K * nu <= 8
          ? (s42 ? backward_batched_kernel<T, 8, 2, 4, 4, 2, 0>
                 : backward_batched_kernel<T, 8, 2, MAX_NX, 0, 0, 0>)
      : K * nu <= 16
          ? (s42 ? (K == 8 ? backward_batched_kernel<T, 16, 2, 4, 4, 2, 8>
                           : backward_batched_kernel<T, 16, 2, 4, 4, 2, 0>)
                 : backward_batched_kernel<T, 16, 2, MAX_NX, 0, 0, 0>)
          : backward_batched_kernel<T, 32, 3, MAX_NX, 0, 0, 0>;
  return launch_with_smem(kernel, S, THREADS, plan.smem * sizeof(T), stream, X, U,
                          xf, Q, R, Qf, mask, refw, radius, pw, npos, mids, ids,
                          dt, mu, Kg, d, N, K, nx, nu);
}

}  // namespace

#define DPILQR_BACKWARD_BATCHED(NAME, T)                                         \
  extern "C" int NAME(const T* X, const T* U, const T* xf, const T* Q,          \
                      const T* R, const T* Qf, const T* mask, const T* refw,    \
                      const T* radius, const T* pw, const int* npos,            \
                      const int* mids, const int* ids, const T* dt,             \
                      const T* mu, T* Kg, T* d, int S, int N, int K, int nx,    \
                      int nu, void* stream) {                                   \
    return launch<T>(X, U, xf, Q, R, Qf, mask, refw, radius, pw, npos, mids,    \
                     ids, dt, mu, Kg, d, S, N, K, nx, nu, stream);              \
  }

DPILQR_BACKWARD_BATCHED(dpilqr_backward_batched_f32, float)
DPILQR_BACKWARD_BATCHED(dpilqr_backward_batched_f64, double)

#ifdef DPILQR_PHASE_CLOCKS
// This kernel's cycles by phase (riccati.cuh, RICCATI_CLOCK), read and reset.
extern "C" int dpilqr_riccati_phase_clocks_narrow(unsigned long long* out) {
  return riccati_read_phase_clocks(out);
}
#endif
