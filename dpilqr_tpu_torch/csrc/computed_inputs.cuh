// The input source that computes a Riccati step's inputs inside the kernel
// (riccati.cuh riccati_sweep_from): the Euler-discretized Jacobians, the
// cost's gradients and its Hessian blocks (derivatives.cuh) of one problem,
// from its trajectory, its cost and its models.  All three backward kernels
// run on it: K5 (backward_sweep.cu) on the centralized problem of n agents,
// K1 and K3 (backward_batched.cu, backward_batched_wide.cu) on one
// decomposed subproblem of K slots a CTA, through that subproblem's view of
// the batch (slot_problem).
//
// The prep (sweep_prep_items_inline and what it calls) is also a host
// function: csrc/derivatives_host.cpp compiles it with a host C++ compiler
// for the CPU tests (tests/test_torch_batched_prep.py), where the device-only
// parts below (the named barrier, the non-inlined copy, ComputedInputs) are
// left out.
//
// Work items of a step t, by threads ft of fn, in two stages apart by a
// named barrier among those threads: first every Jacobian column (one dual
// evaluation of the model) and every ordered pair's Hessian block and
// gradient term (one geometry each), then every agent's L_x, L_u and
// diagonal block from its row of pair results.  At the terminal step (t = N)
// no controls and no Jacobians: lx is p.

#pragma once

#include "derivatives.cuh"
#include "plan.h"
#ifdef __CUDACC__
#include "riccati.cuh"
#endif

namespace {

// What a step's inputs are computed from: one problem's trajectory X (N+1,
// n, nx) and U (N, n, nu), its cost's per-agent fields, its scalars and its
// agents' model ids (those of the library the kernel is built in).
template <typename T>
struct SweepProblem {
  const T *X, *U, *xf, *Q, *R, *Qf, *mask;
  const int *npos, *model;
  T refw, radius, pw, dt;
  int N;
};

// A decomposed subproblem: as SweepProblem, but `model` holds its slots'
// branch indices into the fleet's unique models and `ids` maps them to
// model ids, so a batch's slot table needs no gather before the launch.
template <typename T>
struct SlotProblem : SweepProblem<T> {
  const int* ids;
};

template <typename T>
DPILQR_HD __forceinline__ int model_of(const SweepProblem<T>& pb, int i) {
  return pb.model[i];
}
template <typename T>
DPILQR_HD __forceinline__ int model_of(const SlotProblem<T>& pb, int i) {
  return pb.ids[pb.model[i]];
}

// Subproblem s of a batch of S subproblems of K slots: X (S, N+1, K, nx),
// U (S, N, K, nu), xf (S, K, nx), Q and Qf (S, K, nx, nx), R (S, K, nu, nu),
// mask, npos and mids (S, K), refw, radius and pw (S), ids (the unique
// models' ids), dt (1).
template <typename T>
DPILQR_HD SlotProblem<T> slot_problem(const T* X, const T* U, const T* xf, const T* Q,
                                      const T* R, const T* Qf, const T* mask,
                                      const T* refw, const T* radius, const T* pw,
                                      const int* npos, const int* mids, const int* ids,
                                      T dt, int s, int N, int K, int nx, int nu) {
  const size_t sK = (size_t)s * K;
  SlotProblem<T> pb;
  pb.X = X + (size_t)s * (N + 1) * K * nx;
  pb.U = U + (size_t)s * N * K * nu;
  pb.xf = xf + sK * nx;
  pb.Q = Q + sK * nx * nx;
  pb.R = R + sK * nu * nu;
  pb.Qf = Qf + sK * nx * nx;
  pb.mask = mask + sK;
  pb.npos = npos + sK;
  pb.model = mids + sK;
  pb.refw = refw[s];
  pb.radius = radius[s];
  pb.pw = pw[s];
  pb.dt = dt;
  pb.N = N;
  pb.ids = ids;
  return pb;
}

// Step t's inputs, by threads ft of fn (see the top of the file): At (n,
// nx, nx), Bt (n, nx, nu), lx (n nx), lu (n nu) and the step's Lblk and G.
template <int NXC, typename T, typename P>
DPILQR_HD __forceinline__ void sweep_prep_items_inline(const P& pb, const CostTerms<T>& c,
                                                       int t, T* lx, T* lu, T* At,
                                                       T* Bt, T* Lblk, T* G, int ft,
                                                       int fn) {
  const int n = c.n, nx = c.nx, nu = c.nu, k = c.k, kk = k * k;
  const bool terminal = t == pb.N;
  const T* x = pb.X + (size_t)t * n * nx;
  const T* u = terminal ? nullptr : pb.U + (size_t)t * n * nu;
  const int n_jac = terminal ? 0 : n * (nx + nu);
  for (int it = ft; it < n_jac + n * (n - 1); it += fn) {
    if (it < n_jac) {
      const int i = it / (nx + nu), q = it % (nx + nu);
      jacobian_column<NXC>(model_of(pb, i), x + i * nx, u + i * nu, nx, nu, q, pb.dt,
                           c.mask[i], At + i * nx * nx, nx, Bt + i * nx * nu, nu);
    } else {
      const int p = it - n_jac, i = p / (n - 1), jj = p % (n - 1);
      const int j = jj + (jj >= i);
      pair_terms_block(c, i, j, x, Lblk + (i * n + j) * kk, G + (i * n + j) * 3);
    }
  }
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 2, %0;" ::"r"(fn) : "memory");
#endif
  for (int i = ft; i < n; i += fn)
    agent_terms(c, i, x, u, Lblk, G, lx + i * nx, terminal ? nullptr : lu + i * nu,
                Lblk + (i * n + i) * kk);
}

// The same for agents [i0, i1) alone (the cluster tier of K3, whose CTAs
// each compute their own slots' inputs): their Jacobian columns, their
// ordered pairs (i, j) for every partner j, then their L_x, L_u and
// diagonal blocks.  Lblk and G hold those agents' rows alone (rows i0 ..
// i1 - 1 of (n, n, k, k) and (n, n, 3)), lx and lu their entries; At and
// Bt are whole (n blocks).  Every item's arithmetic is
// sweep_prep_items_inline's.
template <int NXC, typename T, typename P>
DPILQR_HD __forceinline__ void sweep_prep_rows_inline(const P& pb, const CostTerms<T>& c,
                                                      int t, int i0, int i1, T* lx, T* lu,
                                                      T* At, T* Bt, T* Lblk, T* G, int ft,
                                                      int fn) {
  const int n = c.n, nx = c.nx, nu = c.nu, k = c.k, kk = k * k, m = i1 - i0;
  const bool terminal = t == pb.N;
  const T* x = pb.X + (size_t)t * n * nx;
  const T* u = terminal ? nullptr : pb.U + (size_t)t * n * nu;
  const int n_jac = terminal ? 0 : m * (nx + nu);
  for (int it = ft; it < n_jac + m * (n - 1); it += fn) {
    if (it < n_jac) {
      const int i = i0 + it / (nx + nu), q = it % (nx + nu);
      jacobian_column<NXC>(model_of(pb, i), x + i * nx, u + i * nu, nx, nu, q, pb.dt,
                           c.mask[i], At + i * nx * nx, nx, Bt + i * nx * nu, nu);
    } else {
      const int p = it - n_jac, il = p / (n - 1), jj = p % (n - 1);
      const int j = jj + (jj >= i0 + il);
      pair_terms_block(c, i0 + il, j, x, Lblk + (il * n + j) * kk, G + (il * n + j) * 3);
    }
  }
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 2, %0;" ::"r"(fn) : "memory");
#endif
  // agent_terms reads row i of Lblk and G by the agent's index: their bases
  // shifted back by i0 rows.
  const T* Lrows = Lblk - (long long)i0 * n * kk;
  const T* Grows = G - (long long)i0 * n * 3;
  for (int i = i0 + ft; i < i1; i += fn)
    agent_terms(c, i, x, u, Lrows, Grows, lx + (i - i0) * nx,
                terminal ? nullptr : lu + (i - i0) * nu, Lblk + ((i - i0) * n + i) * kk);
}

#ifdef __CUDACC__

template <int NXC, typename T, typename P>
__device__ __noinline__ void sweep_prep_rows(const P pb, const CostTerms<T> c, int t,
                                             int i0, int i1, T* lx, T* lu, T* At, T* Bt,
                                             T* Lblk, T* G, int ft, int fn) {
  sweep_prep_rows_inline<NXC>(pb, c, t, i0, i1, lx, lu, At, Bt, Lblk, G, ft, fn);
}

// The same, not inlined: the nine models' derivatives compile once per type,
// width and problem kind for the run-time path, not once per instantiation of
// the sweep (a compiled-in main shape inlines them: its shared-memory
// pointers stay shared-memory accesses).
template <int NXC, typename T, typename P>
__device__ __noinline__ void sweep_prep_items(const P pb, const CostTerms<T> c, int t,
                                              T* lx, T* lu, T* At, T* Bt, T* Lblk,
                                              T* G, int ft, int fn) {
  sweep_prep_items_inline<NXC>(pb, c, t, lx, lu, At, Bt, Lblk, G, ft, fn);
}

// NXC_LO: where not 0, a problem whose slots are at most NXC_LO states wide
// takes the prep compiled for that width: its dual arrays are half as wide
// and the widest models' right-hand sides compile out of it (K1 and K3 take
// 6, every model but Quad12D; K5's run-time path keeps the one width).
template <bool INLINE, int NXC, typename T, typename P, int NXC_LO>
__device__ __forceinline__ void prep_items(const P& pb, const CostTerms<T>& c, int t,
                                           T* lx, T* lu, T* At, T* Bt, T* Lblk, T* G,
                                           int ft, int fn) {
  if constexpr (INLINE) {
    sweep_prep_items_inline<NXC>(pb, c, t, lx, lu, At, Bt, Lblk, G, ft, fn);
  } else if constexpr (NXC_LO > 0) {
    if (c.nx <= NXC_LO)
      sweep_prep_items<NXC_LO, T, P>(pb, c, t, lx, lu, At, Bt, Lblk, G, ft, fn);
    else
      sweep_prep_items<NXC, T, P>(pb, c, t, lx, lu, At, Bt, Lblk, G, ft, fn);
  } else {
    sweep_prep_items<NXC, T, P>(pb, c, t, lx, lu, At, Bt, Lblk, G, ft, fn);
  }
}

// The input source of riccati_sweep_from that computes a step's inputs in
// place; INLINE: the prep inlined; P: the problem's kind (SweepProblem for
// K5, SlotProblem for K1 and K3); NXC_LO as prep_items'.
template <bool INLINE, int NXC, typename T, typename P = SweepProblem<T>,
          int NXC_LO = 0>
struct ComputedInputs {
  P pb;
  T *QQ, *RR, *Ld, *Lu, *Lblk, *G;

  // The buffers from `extra`, the sweep_extra_values(n, nx, nu) values
  // riccati_place set aside.
  __device__ __forceinline__ void carve(T* extra, int n, int nx, int nu) {
    const size_t k = nx < 3 ? nx : 3;
    QQ = extra;
    RR = QQ + pad4((size_t)n * nx * nx);
    Ld = RR + pad4((size_t)n * nu * nu);
    Lu = Ld + pad4((size_t)n * nx * nx);
    Lblk = Lu + pad4((size_t)n * nu * nu);
    G = Lblk + pad4((size_t)n * n * k * k);
  }

  __device__ __forceinline__ CostTerms<T> terms(int n, int nx, int nu) const {
    return {pb.xf, QQ, RR, pb.mask, pb.npos, pb.refw, pb.radius, pb.pw,
            n, nx, nu, nx < 3 ? nx : 3};
  }

  // Sums W + W^T of n blocks of w x w into S.
  static __device__ __forceinline__ void symmetrize(const T* W, T* S, int n, int w) {
    for (int e = threadIdx.x; e < n * w * w; e += blockDim.x) {
      const int i = e / (w * w), a = e % (w * w) / w, b = e % w;
      S[e] = W[e] + W[(i * w + b) * w + a];
    }
  }

  // The terminal step's P and p (Qf, proximity included), then the stage
  // blocks (the sweep's first fetch follows and synchronizes); three
  // barriers, once a sweep.
  __device__ __forceinline__ void init(const RiccatiWork<T>& ws, int n, int nx,
                                       int nu) const {
    const int nxf = n * nx, k = nx < 3 ? nx : 3;
    const int tid = threadIdx.x, nth = blockDim.x;
    symmetrize(pb.Qf, QQ, n, nx);
    symmetrize(pb.R, RR, n, nu);
    __syncthreads();
    const CostTerms<T> c = terms(n, nx, nu);
    constant_blocks(c, Ld, Lu, tid, nth);
    prep_items<INLINE, NXC, T, P, NXC_LO>(pb, c, pb.N, ws.p, nullptr, nullptr, nullptr,
                                          Lblk, G, tid, nth);
    __syncthreads();
    for (int e = tid; e < nxf * nxf; e += nth)
      ws.P[e] = lxx_entry(e / nxf, e % nxf, n, nx, k, Ld, Lblk);
    symmetrize(pb.Q, QQ, n, nx);
    __syncthreads();
    constant_blocks(c, Ld, Lu, tid, nth);
  }

  __device__ __forceinline__ void fetch(int t, const RiccatiWork<T>& ws, int n,
                                        int nx, int nu, int ft, int fn) const {
    prep_items<INLINE, NXC, T, P, NXC_LO>(pb, terms(n, nx, nu), t, ws.lx, ws.lu, ws.At,
                                          ws.Bt, Lblk, G, ft, fn);
  }

  // L_xx and L_uu are not staged: phase 2 reads each entry from the blocks
  // where it adds it.
  __device__ __forceinline__ T lxx(const RiccatiWork<T>&, int, int r, int c, int n,
                                   int nx) const {
    return lxx_entry(r, c, n, nx, nx < 3 ? nx : 3, Ld, Lblk);
  }
  __device__ __forceinline__ T luu(const RiccatiWork<T>&, int, int r, int c,
                                   int nu) const {
    return luu_entry(r, c, nu, Lu);
  }
};

#endif  // __CUDACC__

}  // namespace
