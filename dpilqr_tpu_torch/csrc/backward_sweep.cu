// Centralized Riccati backward sweep with its inputs: one iLQR problem over
// the whole fleet, from the trajectory and the cost to the gains.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_sweeps.py ::
// backward_pass_pallas, the whole function: its XLA phase (:430-454: the
// time-batched quadraticization, the Euler-discretized Jacobians and the
// dense flat-space embedding of A, B, L_uu and L_xx) and its Pallas program
// (:458-513: the value recursion of reference dpilqr/control.py:116-148).
// It reads X (N+1, n, nx), U (N, n, nu), the cost's compact fields, the
// per-agent model ids, dt and mu, and writes K (N, nuf, nxf) and d (N, nuf)
// with nxf = n nx, nuf = n nu.  The Pallas kernel took dense A_f and B_f and
// a dense L_xx assembled outside it (a Mosaic constraint on the
// (n,k,n,k) -> (nxf,nxf) reshape); this kernel computes every input itself
// (computed_inputs.cuh over derivatives.cuh: the Jacobians by dual numbers
// through dynamics.cuh's right-hand sides, the cost's gradient and Hessian
// blocks in closed form)
// and runs the algebra of riccati.cuh on block-diagonal A and B.  Its sums
// group differently from the torch version's (ops/ilqr.py _backward_pass),
// so results agree to rounding.  The Q_uu solve is the unpivoted
// Gauss-Jordan of dpilqr_tpu/ops/ilqr.py gauss_jordan_solve.
//
// What bounds it on the H100: a single problem is one dependent chain of N
// steps x (8 phases + the elimination's pivots), so it is latency-bound and
// runs on one SM; the inputs it reads are a few KB, its gains a few KB a
// step.  The prep is not on that chain: step t depends on step t+1 through
// P and p alone, and its inputs on (X, U) alone.  Design: one CTA of 512
// threads runs the sweep (register tiles, the elimination of riccati.cuh);
// while a few warps eliminate, the warps the elimination leaves idle compute
// the NEXT step's A, B, L_x, L_u and proximity blocks into the shared-memory
// buffers the recursion reads (work items in two stages: a Jacobian column
// by one dual evaluation of the model and an ordered pair's Hessian block and
// gradient term, one geometry each; then an agent's L_x, L_u and diagonal
// block from its row of those), so nothing but the gains ever goes to device
// memory; phase 2 reads each entry of L_xx and L_uu from those blocks where
// it adds it to Q_xx and Q_uu (no dense L_xx is ever stored: writing one at
// a step's top cost 2,200 cycles a step of 22,000 at 10 Unicycle4D, 16,000
// of 145,000 for the nine-model fleet; scripts/riccati_phase_clocks.py
// --kernel sweep).  The 10-agent
// Unicycle4D problem users run (nxf 40, nuf 20) has its slot widths, slot
// count and a one-warp register elimination compiled in (riccati_sweep_from's
// NXS, NUS, KS, GJ_NR); other shapes run the run-time path.  When the working
// set (~108 n^2 values for unicycles) fits the 227 KB of shared memory (up
// to 15 unicycles in float64, 22 in float32) all of it lives there; past that
// riccati_plan moves the matrices (then K5's blocks too) to a workspace in
// device memory.  Tensor cores are not used: a 40-wide float32 problem would
// need TF32 and change the results.
//
// Layouts (contiguous): X (N+1, n, nx), U (N, n, nu), xf (n, nx), Q, Qf
// (n, nx, nx), R (n, nu, nu), mask (n), refw, radius, pw (1), npos, model
// (n) int32, dt (1), mu (1) -> K (N, nuf, nxf), d (N, nuf); work holds the
// values the plan asks for (plan.cpp dpilqr_riccati_plan).

#include "computed_inputs.cuh"
#include "riccati.cuh"

namespace {

// Threads a CTA; scripts/riccati_phase_clocks.py --kernel sweep --threads N
// rebuilds with another count to measure it.
#ifndef DPILQR_SWEEP_THREADS
#define DPILQR_SWEEP_THREADS 512
#endif
constexpr int THREADS = DPILQR_SWEEP_THREADS;

// NXC: the state width the models are compiled for (the right-hand sides
// of wider models compile to nothing); GJ_NR, GJ_NCB, NXS, NUS, KS as
// riccati_sweep_from's.
template <typename T, int TIER, int TILE, int NXC, int GJ_NR = 0, int GJ_NCB = 0,
          int NXS = 0, int NUS = 0, int KS = 0>
__global__ void __launch_bounds__(THREADS) backward_sweep_kernel(
    const T* __restrict__ X, const T* __restrict__ U, const T* __restrict__ xf,
    const T* __restrict__ Q, const T* __restrict__ R, const T* __restrict__ Qf,
    const T* __restrict__ mask, const T* __restrict__ refw,
    const T* __restrict__ radius, const T* __restrict__ pw,
    const int* __restrict__ npos, const int* __restrict__ model,
    const T* __restrict__ dt, const T* __restrict__ mu, T* __restrict__ Kg,
    T* __restrict__ dg, T* __restrict__ work, int N, int n, int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* extra = nullptr;
  const RiccatiWork<T> ws = riccati_place<TIER>(
      sm, work, n, nx, nu, sweep_extra_values(n, nx, nu), &extra);
  ComputedInputs<NXS != 0, NXC, T> src;
  src.pb = {X, U, xf, Q, R, Qf, mask, npos, model, refw[0], radius[0], pw[0], dt[0], N};
  src.carve(extra, n, nx, nu);
  riccati_sweep_from<TILE, GJ_NR, GJ_NCB, NXS, NUS, KS>(src, mu[0], Kg, dg, N, n, nx,
                                                        nu, ws);
}

template <typename T>
int launch(const T* X, const T* U, const T* xf, const T* Q, const T* R,
           const T* Qf, const T* mask, const T* refw, const T* radius,
           const T* pw, const int* npos, const int* model, const T* dt,
           const T* mu, T* Kg, T* d, T* work, long long work_size, int N, int n,
           int nx, int nu, void* stream) {
  if (n < 1 || nx < 1 || nu < 1 || nx > MAX_NX || nu > MAX_NU)
    return (int)cudaErrorInvalidValue;
  const RiccatiPlan plan = computed_plan(n, nx, nu, sizeof(T), max_shared_optin());
  if (plan.tier < 0 || (size_t)work_size < plan.work)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  // The 10-agent Unicycle4D problem (nxf 40, nuf 20, a 61-column tableau):
  // widths, slot count and the one-warp elimination compiled in.
  const bool main_shape = plan.tier == 0 && n == 10 && nx == 4 && nu == 2;
  const auto kernel =
      main_shape           ? backward_sweep_kernel<T, 0, 2, 4, 20, 2, 4, 2, 10>
      : plan.tier == 2     ? backward_sweep_kernel<T, 2, 4, MAX_NX>
      : plan.tier == 1     ? backward_sweep_kernel<T, 1, 4, MAX_NX>
      : riccati_tile(n * nx, 0) == 4 ? backward_sweep_kernel<T, 0, 4, MAX_NX>
                                     : backward_sweep_kernel<T, 0, 2, MAX_NX>;
  return launch_with_smem(kernel, 1, THREADS, plan.smem * sizeof(T), stream, X, U,
                          xf, Q, R, Qf, mask, refw, radius, pw, npos, model, dt,
                          mu, Kg, d, work, N, n, nx, nu);
}

}  // namespace

#define DPILQR_BACKWARD_SWEEP(NAME, T)                                          \
  extern "C" int NAME(const T* X, const T* U, const T* xf, const T* Q,          \
                      const T* R, const T* Qf, const T* mask, const T* refw,    \
                      const T* radius, const T* pw, const int* npos,            \
                      const int* model, const T* dt, const T* mu, T* K, T* d,   \
                      T* work, long long work_size, int N, int n, int nx,       \
                      int nu, void* stream) {                                   \
    return launch<T>(X, U, xf, Q, R, Qf, mask, refw, radius, pw, npos, model,   \
                     dt, mu, K, d, work, work_size, N, n, nx, nu, stream);      \
  }

DPILQR_BACKWARD_SWEEP(dpilqr_backward_sweep_f32, float)
DPILQR_BACKWARD_SWEEP(dpilqr_backward_sweep_f64, double)

#ifdef DPILQR_PHASE_CLOCKS
// This kernel's cycles by phase (riccati.cuh, RICCATI_CLOCK), read and reset.
extern "C" int dpilqr_riccati_phase_clocks_sweep(unsigned long long* out) {
  return riccati_read_phase_clocks(out);
}
#endif
