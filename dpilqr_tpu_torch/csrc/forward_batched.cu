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
// own warp:
//
// - one CTA per subproblem, one warp per alpha (at most WARPS_PER_CTA warps;
//   further alphas take further CTAs along grid.y), so 2 alphas x 100
//   subproblems are 200 warps on 100 SMs;
// - a column's x, dx = x - X and u live in shared memory, sized at launch
//   from K, nx, nu and the warps of the CTA: no per-thread array has a flat
//   width, and the only width limit is the shared memory a block may use
//   (the launch returns cudaErrorInvalidValue past it);
// - the step's gain block, d row and nominal X and U rows are staged once
//   per subproblem with 16-byte asynchronous copies (cp.async) and shared by
//   all its alphas; step t+1 is in flight while step t computes (two stages;
//   one where two do not fit).  The block is contiguous because the gains
//   are laid out (S, N, nuf, nxf) in memory.  One __syncthreads() a step;
// - lanes split a step's work: the gain rows' dot products run over lanes
//   (dx element i on lane i mod 32, a butterfly of shuffles per row, four
//   rows in flight), slots run over lanes for RK4 and the quadratic forms,
//   pairs over lanes for the proximity term, and the step's cost is one
//   warp sum.  So J and the gain products add in another order than a
//   serial loop (float64 agrees with the plain version to ~1e-13);
// - a slot integrates in registers (dynamics.cuh: arrays of the
//   compile-time width NXC, the kernel being instantiated for nx <= 4, 6
//   and 12); mixed fleets diverge on the model switch only inside a warp;
// - every output row is written from shared memory by neighbouring lanes to
//   neighbouring addresses: the outputs are column-major in memory,
//   (n_alpha, S, N, K nx) and (n_alpha, S, N, K nu).
//
// Model RHS, RK4 and the cost's quadratic forms: dynamics.cuh, shared with
// the centralized forward kernel (forward_sweep.cu).
//
// Layouts (contiguous):
//   X (S, N+1, K, nx), U (S, N, K, nu), Kg (S, N, nuf, nxf), d (S, N, nuf),
//   alphas (n_alpha), slot_model / slot_nsub (S, K) int32, slot_dh (S, K),
//   xf (S, K, nx), Q / Qf (S, K, nx, nx), R (S, K, nu, nu), mask (S, K),
//   refw / radius / proxw (S), npos_eval (S, K) int32
//   -> X5 (n_alpha, S, N, K, nx) states 1..N, U5 (n_alpha, S, N, K, nu),
//      J (n_alpha, S).
// The Python wrapper hands Kg, d, X5 and U5 out as permuted views in the
// JAX package's shapes (N, nuf, nxf, S), (N, nuf, S), (N, nx, K, n_alpha, S).

#include "dynamics.cuh"
#include "launch.cuh"

namespace {

constexpr int WARPS_PER_CTA = 8;
constexpr unsigned FULL = 0xffffffffu;

// Sum over the warp, the same bits on every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The values of one stage (gain block, d row, nominal U row, nominal X row)
// and of one column's x, dx, u.  Mirrored by forward_smem_bytes in
// dpilqr_tpu_torch/ops/batched.py.
__host__ __device__ inline size_t stage_values(int nxf, int nuf) {
  return pad4((size_t)nuf * nxf) + 2 * pad4(nuf) + pad4(nxf);
}
__host__ __device__ inline size_t column_values(int nxf, int nuf) {
  return 2 * pad4(nxf) + pad4(nuf);
}

// This lane's share of the cost at state x (and control u, or nullptr at
// the terminal step): slots lane, lane + 32, ... and pairs likewise.
template <int NXC, typename T>
__device__ __forceinline__ T cost_share(
    const T* x, const T* u, const T* xf, const T* W, const T* R, const T* mask,
    const int* npos, T rw, T rad, T pw, int K, int nx, int nu, int lane) {
  T part = T(0);
  for (int k = lane; k < K; k += 32) {
    T e[NXC];
#pragma unroll
    for (int i = 0; i < NXC; ++i)
      e[i] = i < nx ? x[k * nx + i] - xf[k * nx + i] : T(0);
    T q = quadform<NXC>(W + (size_t)k * nx * nx, e, nx);
    T row;
    if (u != nullptr) {
      const T* uk = u + k * nu;
      q = q + quadform<MAX_NU>(R + (size_t)k * nu * nu, uk, nu);
      T uu = uk[0] * uk[0];
#pragma unroll
      for (int j = 1; j < MAX_NU; ++j)
        if (j < nu) uu += uk[j] * uk[j];
      row = rw * mask[k] * q + (T(1) - mask[k]) * uu;
    } else {
      row = rw * mask[k] * q;
    }
    part += row;
  }
  T pp = T(0);
  for (int idx = lane; idx < K * K; idx += 32) {
    const int i = idx / K, j = idx % K;
    if (j <= i) continue;
    const int nd = npos[i] < npos[j] ? npos[i] : npos[j];
    pp += pair_penalty(x + i * nx, x + j * nx, mask[i], mask[j], nd, rad, nx);
  }
  return part + pw * pp;
}

template <typename T, int NXC>
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
    T* __restrict__ U5, T* __restrict__ J, int S, int N, int K, int nx,
    int nu, int n_alpha, int n_stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nxf = K * nx, nuf = K * nu;
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a = blockIdx.y * (blockDim.x >> 5) + warp;
  // A warp past the last alpha still copies and meets the barriers.
  const bool live = a < n_alpha;
  const bool gains = Kg != nullptr;

  const size_t stage_sz = gains ? stage_values(nxf, nuf) : 0;
  const size_t g_off = pad4((size_t)nuf * nxf), v_off = pad4(nuf);
  T* x = sm + n_stage * stage_sz + warp * column_values(nxf, nuf);
  T* dx = x + pad4(nxf);
  T* u = dx + pad4(nxf);

  const T* Xs = X + (size_t)s * (N + 1) * nxf;
  const T* Us = U + (size_t)s * N * nuf;
  const T* Kgs = gains ? Kg + (size_t)s * N * nuf * nxf : nullptr;
  const T* dgs = gains ? dg + (size_t)s * N * nuf : nullptr;
  const size_t sK = (size_t)s * K;
  const int* model = slot_model + sK;
  const int* nsub = slot_nsub + sK;
  const T* dh = slot_dh + sK;
  const T* ms = mask + sK;
  const int* nps = npos_eval + sK;
  const T* xfs = xf + sK * nx;
  const T* Qs = Q + sK * nx * nx;
  const T* Rs = R + sK * nu * nu;
  const T* Qfs = Qf + sK * nx * nx;
  const T alpha = live ? alphas[a] : T(0);
  const T rw = refw[s], rad = radius[s], pw = proxw[s];
  const size_t col = (size_t)(live ? a : 0) * S + s;
  T* Xo = X5 + col * N * nxf;
  T* Uo = U5 + col * N * nuf;

  // Stage t: [gain block | d row | nominal U row | nominal X row].
  auto fetch = [&](int t, T* st) {
    copy_async(st, Kgs + (size_t)t * nuf * nxf, nuf * nxf);
    copy_async(st + g_off, dgs + (size_t)t * nuf, nuf);
    copy_async(st + g_off + v_off, Us + (size_t)t * nuf, nuf);
    copy_async(st + g_off + 2 * v_off, Xs + (size_t)t * nxf, nxf);
    __pipeline_commit();
  };

  for (int i = lane; i < nxf; i += 32) x[i] = Xs[i];
  if (gains && n_stage == 2 && N > 0) fetch(0, sm);
  __syncwarp();

  T Jacc = T(0);
  for (int t = 0; t < N; ++t) {
    if (gains) {
      T* st;
      if (n_stage == 2) {
        // Stage t has landed for every thread, and every warp is done with
        // the buffer step t - 1 read: refill it with step t + 1.
        __pipeline_wait_prior(0);
        __syncthreads();
        st = sm + (t & 1) * stage_sz;
        if (t + 1 < N) fetch(t + 1, sm + ((t + 1) & 1) * stage_sz);
      } else {
        __syncthreads();
        st = sm;
        fetch(t, st);
        __pipeline_wait_prior(0);
        __syncthreads();
      }
      if (live) {
        const T* G = st;
        const T* dt = st + g_off;
        const T* Un = st + g_off + v_off;
        const T* Xn = st + g_off + 2 * v_off;
        for (int i = lane; i < nxf; i += 32) dx[i] = x[i] - Xn[i];
        __syncwarp();
        // Closed-loop controls, four gain rows in flight.
        for (int r0 = 0; r0 < nuf; r0 += 4) {
          T p[4] = {T(0), T(0), T(0), T(0)};
          for (int i = lane; i < nxf; i += 32) {
            const T dxi = dx[i];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (r0 + q < nuf) p[q] += G[(size_t)(r0 + q) * nxf + i] * dxi;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const T du = warp_sum(p[q]);
            const int r = r0 + q;
            if (r < nuf && lane == q) u[r] = Un[r] + du + alpha * dt[r];
          }
        }
      }
    } else if (live) {
      for (int r = lane; r < nuf; r += 32) u[r] = Us[(size_t)t * nuf + r];
    }
    if (live) {
      __syncwarp();
      for (int r = lane; r < nuf; r += 32) Uo[(size_t)t * nuf + r] = u[r];

      // Stage cost at (x_t, u_t).
      Jacc = Jacc + warp_sum(cost_share<NXC>(x, u, xfs, Qs, Rs, ms, nps, rw, rad,
                                             pw, K, nx, nu, lane));
      __syncwarp();

      // RK4 with the slot's own substep schedule, a slot a lane.
      for (int k = lane; k < K; k += 32)
        rk4_slot<NXC>(model[k], nsub[k], dh[k], x + k * nx, u + k * nu, nx);
      __syncwarp();
      for (int i = lane; i < nxf; i += 32) Xo[(size_t)t * nxf + i] = x[i];
    }
  }

  if (live) {
    const T term = warp_sum(cost_share<NXC>(x, (const T*)nullptr, xfs, Qfs, Rs, ms,
                                            nps, rw, rad, pw, K, nx, nu, lane));
    if (lane == 0) J[col] = Jacc + term;
  }
}

template <typename T, int NXC>
int launch_nxc(const T* X, const T* U, const T* Kg, const T* d,
               const T* alphas, const int* slot_model, const int* slot_nsub,
               const T* slot_dh, const T* xf, const T* Q, const T* R,
               const T* Qf, const T* mask, const T* refw, const T* radius,
               const T* proxw, const int* npos_eval, T* X5, T* U5, T* J, int S,
               int N, int K, int nx, int nu, int n_alpha, void* stream) {
  const int nxf = K * nx, nuf = K * nu;
  const int chunks = (n_alpha + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
  const int warps = (n_alpha + chunks - 1) / chunks;
  const long long optin = max_shared_optin();
  if (optin < 0) return (int)cudaErrorInvalidDevice;
  const size_t stage = Kg != nullptr ? stage_values(nxf, nuf) : 0;
  const size_t cols = warps * column_values(nxf, nuf);
  int n_stage = 2;
  if ((2 * stage + cols) * sizeof(T) > (size_t)optin) n_stage = 1;
  const size_t bytes = (n_stage * stage + cols) * sizeof(T);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  return launch_with_smem(forward_batched_kernel<T, NXC>, dim3(S, chunks),
                          warps * 32, bytes, stream, X, U, Kg, d, alphas,
                          slot_model, slot_nsub, slot_dh, xf, Q, R, Qf, mask,
                          refw, radius, proxw, npos_eval, X5, U5, J, S, N, K, nx,
                          nu, n_alpha, n_stage);
}

template <typename T>
int launch(const T* X, const T* U, const T* Kg, const T* d, const T* alphas,
           const int* slot_model, const int* slot_nsub, const T* slot_dh,
           const T* xf, const T* Q, const T* R, const T* Qf, const T* mask,
           const T* refw, const T* radius, const T* proxw,
           const int* npos_eval, T* X5, T* U5, T* J, int S, int N, int K,
           int nx, int nu, int n_alpha, void* stream) {
  if (nx > MAX_NX || nu > MAX_NU || nx < 1 || nu < 1 || K < 1 ||
      (Kg == nullptr) != (d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || n_alpha == 0) return 0;
#define DPILQR_FORWARD_NXC(NXC)                                               \
  return launch_nxc<T, NXC>(X, U, Kg, d, alphas, slot_model, slot_nsub,       \
                            slot_dh, xf, Q, R, Qf, mask, refw, radius, proxw, \
                            npos_eval, X5, U5, J, S, N, K, nx, nu, n_alpha,   \
                            stream)
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
      T* X5, T* U5, T* J, int S, int N, int K, int nx, int nu, int n_alpha,   \
      void* stream) {                                                         \
    return launch<T>(X, U, Kg, d, alphas, slot_model, slot_nsub, slot_dh, xf, \
                     Q, R, Qf, mask, refw, radius, proxw, npos_eval, X5, U5,  \
                     J, S, N, K, nx, nu, n_alpha, stream);                    \
  }

DPILQR_FORWARD(dpilqr_forward_batched_f32, float)
DPILQR_FORWARD(dpilqr_forward_batched_f64, double)

// The dynamic shared memory one CTA of the forward kernel takes with two
// stages (bytes), for the Python mirror's test on the card.
extern "C" long long dpilqr_forward_smem_bytes(int K, int nx, int nu,
                                               int n_alpha, int gains,
                                               int itemsize) {
  const int chunks = (n_alpha + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
  const int warps = chunks ? (n_alpha + chunks - 1) / chunks : 0;
  const size_t stage = gains ? stage_values(K * nx, K * nu) : 0;
  return (long long)((2 * stage + warps * column_values(K * nx, K * nu)) * itemsize);
}
