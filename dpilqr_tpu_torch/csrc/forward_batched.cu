// Batched closed-loop line-search rollout for the decomposed DP-iLQR solve.
//
// Replaces the TPU kernel dpilqr_tpu/ops/pallas_batched.py ::
// forward_pass_batched (the Pallas program at :647-778): for every
// (alpha, subproblem) column it rolls out u = U + Kg (x - X) + alpha d
// (reference dpilqr/control.py:95-114) with RK4 under a per-slot step
// table (a slot whose model takes s_m substeps runs s_m steps of dt/s_m,
// so mixed Bike5D fleets stay exact), blending all nine models' dynamics,
// and accumulates the game cost: the stage and terminal reference cost,
// the padded-slot (1-m) |u|^2 term and the pair penalty
// sum min(0, d - r)^2 over the n_pos_eval position components.  With no
// gains (Kg = d = nullptr) it is the plain rollout of U.
//
// What bounds it on the H100: neither bytes (the gains stream once per
// subproblem, nuf nxf values a step) nor FLOPs, but the latency of one
// column's serial chain: N steps, each a gain matvec, then per slot
// substeps x 4 dependent RHS evaluations (a sincos or two tangents each),
// and there are only n_alpha x S columns (32 to 1000 on the solve paths).
// A step of that chain takes 6 to 9 us at K = 8 unicycles and 18 us at 16
// Quad6D slots (0.3-0.5 and 0.9 ms a launch), whatever the batch width.
// The design shortens the chain a column walks and gives every column its
// own warp: one CTA per subproblem, one warp per alpha (at most
// WARPS_PER_CTA warps; further alphas take further CTAs along grid.y), so
// 2 alphas x 100 subproblems are 200 warps on 100 SMs; the column itself is
// rollout_column of rollout.cuh, shared with the centralized forward kernel
// (forward_sweep.cu): state in shared memory, the step's gain block fetched
// once per subproblem by cp.async (whole, or in tiles of rows where a
// whole block does not fit beside the columns: Quad12D at K=32 in float64,
// Unicycle4D at K=64), lanes over gain rows, slots and pairs, RK4 in
// registers.  The kernel is instantiated for nx <= 4, 6 and 12; the
// outputs are column-major in memory, (n_alpha, S, N, K nx) and
// (n_alpha, S, N, K nu), so a column's row is contiguous.
//
// The tail's predicate (the counterpart of the lax.cond at
// pallas_batched.py:1045): the two-stage line search launches the first
// alphas (the probe), then always the rest (the tail) with the probe's
// costs J_probe (n_probe, S), the carry's J (S) and active (S).  Each CTA
// of the tail first evaluates need_tail = any(active & ~any(J_probe < J))
// over all S subproblems; where it is false, no active subproblem needs
// the tail, and each CTA writes J = +inf for its alphas and returns (the
// JAX skip branch, :1035-1043: never selected, since the accept takes the
// first improving alpha; its X5 and U5 rows are left unwritten and never
// read).  Where it is true the walk runs as without a predicate, to the
// same bits.  So the host needs no sync to decide, and the iteration
// replays as one graph.
//
// Layouts (contiguous):
//   X (S, N+1, K, nx), U (S, N, K, nu), Kg (S, N, nuf, nxf), d (S, N, nuf),
//   alphas (n_alpha), slot_model / slot_nsub (S, K) int32, slot_dh (S, K),
//   xf (S, K, nx), Q / Qf (S, K, nx, nx), R (S, K, nu, nu), mask (S, K),
//   refw / radius / proxw (S), npos_eval (S, K) int32; with a predicate
//   J_probe (n_probe, S), J_carry (S), active (S) bool (one byte), else all
//   three nullptr
//   -> X5 (n_alpha, S, N, K, nx) states 1..N, U5 (n_alpha, S, N, K, nu),
//      J (n_alpha, S).
// The Python wrapper hands Kg, d, X5 and U5 out as permuted views in the
// JAX package's shapes (N, nuf, nxf, S), (N, nuf, S), (N, nx, K, n_alpha, S).

#include <cmath>

#include "rollout.cuh"

namespace {

template <typename T, int NXC, bool TILES>
__global__ void __launch_bounds__(WARPS_PER_CTA * 32) forward_batched_kernel(
    const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ Kg, const T* __restrict__ dg,
    const T* __restrict__ alphas, const int* __restrict__ slot_model,
    const int* __restrict__ slot_nsub, const T* __restrict__ slot_dh,
    const T* __restrict__ xf, const T* __restrict__ Q,
    const T* __restrict__ R, const T* __restrict__ Qf,
    const T* __restrict__ mask, const T* __restrict__ refw,
    const T* __restrict__ radius, const T* __restrict__ proxw,
    const int* __restrict__ npos_eval, T* __restrict__ X5,
    T* __restrict__ U5, T* __restrict__ J, const T* __restrict__ J_probe,
    const T* __restrict__ J_carry, const unsigned char* __restrict__ active,
    int S, int N, int K, int nx, int nu, int n_alpha, int n_probe, int n_buf,
    int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nxf = K * nx, nuf = K * nu;
  const int s = blockIdx.x;
  const int a = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // A warp past the last alpha still copies and meets the barriers.
  const bool live = a < n_alpha;
  if (J_probe != nullptr) {
    // The tail's predicate, the same on every CTA (block-uniform return).
    int need = 0;
    for (int k = threadIdx.x; k < S; k += blockDim.x) {
      if (!active[k]) continue;
      bool improved = false;
      for (int p = 0; p < n_probe; ++p)
        improved |= J_probe[(size_t)p * S + k] < J_carry[k];
      need |= !improved;
    }
    if (!__syncthreads_or(need)) {
      if (live && (threadIdx.x & 31) == 0) J[(size_t)a * S + s] = T(INFINITY);
      return;
    }
  }
  const bool gains = Kg != nullptr;
  const size_t sK = (size_t)s * K;
  const ColumnProblem<T> pb = {
      X + (size_t)s * (N + 1) * nxf,
      U + (size_t)s * N * nuf,
      gains ? Kg + (size_t)s * N * nuf * nxf : nullptr,
      gains ? dg + (size_t)s * N * nuf : nullptr,
      slot_model + sK,
      slot_nsub + sK,
      slot_dh + sK,
      xf + sK * nx,
      Q + sK * nx * nx,
      R + sK * nu * nu,
      Qf + sK * nx * nx,
      mask + sK,
      npos_eval + sK,
      refw[s],
      radius[s],
      proxw[s],
      N, K, nx, nu};
  const size_t col = (size_t)(live ? a : 0) * S + s;
  rollout_column<TILES, NXC>(sm, n_buf, rows, pb, live,
                             live ? alphas[a] : T(0), X5 + col * N * nxf,
                             U5 + col * N * nuf, J + col);
}

template <typename T, int NXC>
int launch_nxc(const T* X, const T* U, const T* Kg, const T* d,
               const T* alphas, const int* slot_model, const int* slot_nsub,
               const T* slot_dh, const T* xf, const T* Q, const T* R,
               const T* Qf, const T* mask, const T* refw, const T* radius,
               const T* proxw, const int* npos_eval, T* X5, T* U5, T* J,
               const T* J_probe, const T* J_carry, const unsigned char* active,
               int S, int N, int K, int nx, int nu, int n_alpha, int max_rows,
               int n_probe, void* stream) {
  const long long optin = max_shared_optin();
  if (optin < 0) return (int)cudaErrorInvalidDevice;
  const ColumnLaunch cl = column_launch(K * nx, K * nu, n_alpha, Kg != nullptr,
                                        sizeof(T), optin, max_rows);
  if (cl.n_buf == 0) return (int)cudaErrorInvalidValue;
  // Tiles where a buffer holds fewer rows than the block; no gains run the
  // whole-block walk (its fetches never run).
  auto kernel = cl.rows && cl.rows < K * nu ? forward_batched_kernel<T, NXC, true>
                                           : forward_batched_kernel<T, NXC, false>;
  return launch_with_smem(kernel, dim3(S, cl.chunks), cl.warps * 32, cl.bytes,
                          stream, X, U, Kg, d, alphas, slot_model, slot_nsub,
                          slot_dh, xf, Q, R, Qf, mask, refw, radius, proxw,
                          npos_eval, X5, U5, J, J_probe, J_carry, active, S, N,
                          K, nx, nu, n_alpha, n_probe, cl.n_buf, cl.rows);
}

template <typename T>
int launch(const T* X, const T* U, const T* Kg, const T* d, const T* alphas,
           const int* slot_model, const int* slot_nsub, const T* slot_dh,
           const T* xf, const T* Q, const T* R, const T* Qf, const T* mask,
           const T* refw, const T* radius, const T* proxw,
           const int* npos_eval, T* X5, T* U5, T* J, const T* J_probe,
           const T* J_carry, const unsigned char* active, int S, int N, int K,
           int nx, int nu, int n_alpha, int max_rows, int n_probe,
           void* stream) {
  if (nx > MAX_NX || nu > MAX_NU || nx < 1 || nu < 1 || K < 1 ||
      (Kg == nullptr) != (d == nullptr) ||
      (J_probe != nullptr &&
       (J_carry == nullptr || active == nullptr || n_probe < 1)))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || n_alpha == 0) return 0;
#define DPILQR_FORWARD_NXC(NXC)                                               \
  return launch_nxc<T, NXC>(X, U, Kg, d, alphas, slot_model, slot_nsub,       \
                            slot_dh, xf, Q, R, Qf, mask, refw, radius, proxw, \
                            npos_eval, X5, U5, J, J_probe, J_carry, active,   \
                            S, N, K, nx, nu, n_alpha, max_rows, n_probe, stream)
  if (nx <= 4) DPILQR_FORWARD_NXC(4);
  if (nx <= 6) DPILQR_FORWARD_NXC(6);
  DPILQR_FORWARD_NXC(MAX_NX);
#undef DPILQR_FORWARD_NXC
}

}  // namespace

#define DPILQR_FORWARD(NAME, T)                                               \
  extern "C" int NAME(                                                        \
      const T* X, const T* U, const T* Kg, const T* d, const T* alphas,       \
      const int* slot_model, const int* slot_nsub, const T* slot_dh,          \
      const T* xf, const T* Q, const T* R, const T* Qf, const T* mask,        \
      const T* refw, const T* radius, const T* proxw, const int* npos_eval,   \
      T* X5, T* U5, T* J, const T* J_probe, const T* J_carry,                 \
      const unsigned char* active, int S, int N, int K, int nx, int nu,       \
      int n_alpha, int max_rows, int n_probe, void* stream) {                 \
    return launch<T>(X, U, Kg, d, alphas, slot_model, slot_nsub, slot_dh, xf, \
                     Q, R, Qf, mask, refw, radius, proxw, npos_eval, X5, U5,  \
                     J, J_probe, J_carry, active, S, N, K, nx, nu, n_alpha,   \
                     max_rows, n_probe, stream);                              \
  }

DPILQR_FORWARD(dpilqr_forward_batched_f32, float)
DPILQR_FORWARD(dpilqr_forward_batched_f64, double)
