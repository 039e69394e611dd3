// The cluster tier of the wide backward kernel (K3, backward_batched_wide.cu):
// one subproblem solved by a thread-block cluster of C CTAs (C <= 8, the
// portable limit), its whole Riccati working set in the cluster's
// distributed shared memory, so that no value of it goes through device
// memory.  It takes the problems whose working set one CTA's shared memory
// cannot hold and that riccati_plan would put in the device-memory
// workspace (tier 2): Quad6D at K = 32 in float32 (nxf 192, nuf 96, about
// 0.96 MB), where tier 2 ran the 96-pivot elimination in place in device
// memory with a barrier a pivot and read the nuf-deep products' operands
// from there.
//
// Rows are split by agent slot: rank q owns slots [q K / C, (q + 1) K / C),
// and with them the rows of P, A^T P, Q_xx (its slots' nx each) and of W1,
// Q_ux, Q_uu, K and the tableau (its slots' nu each).  A and B are block
// diagonal, so phases 1 and 2 need a CTA's own rows and every slot's A and
// B blocks (each rank computes its own slots' inputs, computed_inputs.cuh
// sweep_prep_rows, and pulls the others' blocks through distributed shared
// memory).  The arithmetic is riccati_sweep_from's, entry by entry: the same
// products in the same order (mul_rn on the first pair, then fused
// multiply-adds in index order), the same reciprocals, so that the cluster
// tier gives tier 2's bits on the same problem.
//
// The elimination runs in blocks of pivots, one block a rank (its own
// rows): the owner of a block runs the block before's pivots and then its
// own on the two blocks' columns in one warp's registers (the multipliers
// and reciprocals), then every column right of its block, a thread a
// column, takes both blocks' pivots one after another and saves each scaled
// pivot row; after one cluster barrier every other rank applies those
// pivot rows to its own rows, in pivot order (its multipliers first, a
// thread a row, then a thread a column), and each rank computes its slots'
// inputs of the next step in the iteration where it has nothing to apply.
// That is one cluster barrier a block, C a step, instead of a barrier a
// pivot.  Every entry still takes M[r][j] - M[r][kp] (M[kp][j] (1 /
// M[kp][kp])) for kp ascending.
//
// The value update reads the others' rows of K, Q_ux and K^T Q_uu's factor
// Q_uu K through distributed shared memory: K whole (pulled once a step),
// Q_ux and Q_uu K a rank's rows at a time into a staging buffer, while each
// thread keeps its tile's sums in registers from one rank's rows to the
// next; the symmetrization reads the transposed entries of Q_xx from their
// owners.  Twelve cluster barriers a step at C = 8.
//
// What bounds it on an H100 (scripts/riccati_phase_clocks.py, rank 0 of the
// first cluster, Quad6D K = 32 float32): about 330 k cycles a step, over half of
// it the elimination's chain of eight blocks (a block's owner: about 8 k
// cycles in its warp, 4.5 k for its column pass, 2 k for the barrier),
// then the value update's products.  A cluster of 8 CTAs of 219 KB takes
// 8 SMs of one GPC: 15 clusters fit the H100 at once, so a launch of S
// subproblems runs in ceil(S / 15) waves.

#pragma once

#include <cooperative_groups.h>

#include "computed_inputs.cuh"

namespace {

namespace cg = cooperative_groups;

// The portable cluster size; the control rows one CTA of a cluster holds at
// most (the register rows of the elimination's block steps); the threads of
// a CTA.
constexpr int CLUSTER_MAX = 8, CLUSTER_MU = 16, CLUSTER_THREADS = 384;

// First slot of rank q of a cluster of C over K slots, and the rank that
// owns a slot.
__host__ __device__ inline int cluster_slot0(int q, int K, int C) { return q * K / C; }
__host__ __device__ inline int cluster_owner(int slot, int K, int C) {
  return ((slot + 1) * C - 1) / K;
}

// Offsets (values) of one CTA's buffers under the cluster tier; every CTA of
// the cluster has the same layout, sized for the largest share of slots
// (ms), so that a buffer lies at the same offset in every rank.
struct ClusterLayout {
  size_t P, AtP, Qxx, stage, Qux, QuuK, Quu, Qs, M, Kt, AB, QQ, RR, Ld, Lu, Lblk, G;
  size_t p, Qx, Qu, lx, lu, d, w, inv, mult, total;
  int ms, ldq, lds;
};

__host__ __device__ inline ClusterLayout cluster_layout(int K, int nx, int nu, int C) {
  ClusterLayout L;
  const int ms = (K + C - 1) / C, k = nx < 3 ? nx : 3;
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu, ncol = nuf + nxf + 1;
  const size_t mx = (size_t)ms * nx, mu = (size_t)ms * nu;
  L.ms = ms;
  L.ldq = (int)pad4(mu);
  L.lds = (int)pad4(ncol);
  size_t o = 0;
  L.P = o;     o += pad4(mx * nxf);
  // A^T P in phases 1 and 2; in the elimination, the owner's scaled pivot
  // rows (mu x lds), which the other ranks read.
  L.AtP = o;   o += pad4(mx * nxf > mu * L.lds ? mx * nxf : mu * L.lds);
  L.Qxx = o;   o += pad4(mx * nxf);
  // W1 in phases 1 and 2; another block's pivot rows in the elimination;
  // a rank's rows of Q_ux and Q_uu K in the update.
  L.stage = o; o += 2 * pad4(mu * nxf) > pad4(mu * L.lds) ? 2 * pad4(mu * nxf) : pad4(mu * L.lds);
  L.Qux = o;   o += pad4(mu * nxf);
  L.QuuK = o;  o += pad4(mu * nxf);
  L.Quu = o;   o += pad4(mu * nuf);
  L.Qs = o;    o += pad4(nuf * L.ldq);  // Q_uu's columns of the own rows
  L.M = o;     o += pad4(mu * ncol);
  L.Kt = o;    o += pad4(nuf * nxf);    // K whole
  L.AB = o;    o += 2 * (pad4((size_t)K * nx * nx) + pad4((size_t)K * nx * nu));
  L.QQ = o;    o += pad4((size_t)K * nx * nx);
  L.RR = o;    o += pad4((size_t)K * nu * nu);
  L.Ld = o;    o += pad4((size_t)K * nx * nx);
  L.Lu = o;    o += pad4((size_t)K * nu * nu);
  L.Lblk = o;  o += pad4((size_t)ms * K * k * k);
  L.G = o;     o += pad4((size_t)ms * K * 3);
  L.p = o;     o += pad4(mx);
  L.Qx = o;    o += pad4(mx);
  L.Qu = o;    o += pad4(mu);
  L.lx = o;    o += pad4(mx);
  L.lu = o;    o += pad4(mu);
  L.d = o;     o += pad4(nuf);  // d whole
  L.w = o;     o += pad4(nuf);  // w whole
  L.inv = o;   o += pad4(CLUSTER_MU);
  L.mult = o;  o += 2 * CLUSTER_MU * CLUSTER_MU;  // the own block's, the block before's
  L.total = o;
  return L;
}

// The smallest cluster (2 .. max_cluster CTAs) whose layout fits `optin`
// bytes a CTA, or 0.
inline int cluster_ctas(int K, int nx, int nu, size_t itemsize, long long optin,
                        int max_cluster) {
  if (optin < 0) return 0;
  for (int C = 2; C <= max_cluster && C <= K; ++C) {
    const ClusterLayout L = cluster_layout(K, nx, nu, C);
    if (L.ms * nu <= CLUSTER_MU && L.total * itemsize <= (size_t)optin) return C;
  }
  return 0;
}

// K3's plan: computed_plan, with the cluster tier in place of the
// device-memory workspace (tier 2) wherever that tier eliminates in place in
// device memory (a tableau past the register path's 32 GJ_COLS columns,
// riccati.cuh gauss_jordan) and a cluster of at most max_cluster CTAs holds
// the whole working set.  Below that width tier 2 keeps the tableau in
// registers and was faster (Quad6D K = 16 in float64 on an H100: 5.7 ms a
// launch at S = 64 against 19.6 on clusters of 4, scripts/compare_builds.py).
inline RiccatiPlan wide_plan(int K, int nx, int nu, size_t itemsize, int max_cluster) {
  const RiccatiPlan plan = computed_plan(K, nx, nu, itemsize);
  if (plan.tier != 2 || max_cluster < 2 || K * (nx + nu) + 1 <= 32 * GJ_COLS) return plan;
  const int C = cluster_ctas(K, nx, nu, itemsize, max_shared_optin(), max_cluster);
  if (C == 0) return plan;
  RiccatiPlan out{3, cluster_layout(K, nx, nu, C).total, 0};
  out.cluster = C;
  return out;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The same buffer in rank q's shared memory.
template <typename T>
__device__ __forceinline__ T* at_rank(T* p, int q) {
  return cg::this_cluster().map_shared_rank(p, q);
}

// n values of each of two other-rank buffers into this CTA's, by threads
// tid of nth: 16 bytes a request where the ends and n allow, four requests
// in flight a thread.
template <typename T>
__device__ __forceinline__ void pull2(T* dst0, const T* src0, T* dst1, const T* src1, int n,
                                      int tid, int nth) {
  constexpr int PER = 16 / sizeof(T);
  const bool wide = ((reinterpret_cast<uintptr_t>(dst0) | reinterpret_cast<uintptr_t>(src0) |
                      reinterpret_cast<uintptr_t>(dst1) | reinterpret_cast<uintptr_t>(src1)) &
                     15) == 0 &&
                    n % PER == 0;
  if (wide) {
    const int nv = n / PER;
    for (int i = tid; i < nv; i += 2 * nth) {
      float4 v[4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        if (i + a * nth < nv) {
          v[2 * a] = reinterpret_cast<const float4*>(src0)[i + a * nth];
          v[2 * a + 1] = reinterpret_cast<const float4*>(src1)[i + a * nth];
        }
#pragma unroll
      for (int a = 0; a < 2; ++a)
        if (i + a * nth < nv) {
          reinterpret_cast<float4*>(dst0)[i + a * nth] = v[2 * a];
          reinterpret_cast<float4*>(dst1)[i + a * nth] = v[2 * a + 1];
        }
    }
  } else {
    for (int i = tid; i < n; i += nth) {
      const T a = src0[i], b = src1[i];
      dst0[i] = a;
      dst1[i] = b;
    }
  }
}

// n values of another rank's buffer into this CTA's, by threads tid of
// nth: 16 bytes a request where the ends and n allow, four in flight a
// thread.
template <typename T>
__device__ __forceinline__ void pull(T* dst, const T* src, int n, int tid, int nth) {
  constexpr int PER = 16 / sizeof(T);
  const bool wide =
      ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0 &&
      n % PER == 0;
  const int nv = wide ? n / PER : n;
  for (int i = tid; i < nv; i += 4 * nth) {
    float4 v4[4];
    T v1[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (i + a * nth < nv) {
        if (wide) v4[a] = reinterpret_cast<const float4*>(src)[i + a * nth];
        else v1[a] = src[i + a * nth];
      }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (i + a * nth < nv) {
        if (wide) reinterpret_cast<float4*>(dst)[i + a * nth] = v4[a];
        else dst[i + a * nth] = v1[a];
      }
  }
}

// Every slot's `per` values of buf (K slots, contiguous) that another rank
// owns, from that rank's copy at the same offset: 16-byte requests where
// per allows, four in flight a thread.
template <typename T>
__device__ __forceinline__ void gather_slots(T* buf, int per, int K, int C, int q,
                                             int tid, int nth) {
  constexpr int PER = 16 / sizeof(T);
  if (per % PER == 0) {
    const int pv = per / PER, n = K * pv;
    float4* d = reinterpret_cast<float4*>(buf);
    for (int i = tid; i < n; i += 4 * nth) {
      float4 v[4];
      int o[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int e = i + a * nth;
        o[a] = e < n ? cluster_owner(e / pv, K, C) : q;
        if (o[a] != q) v[a] = reinterpret_cast<const float4*>(at_rank(buf, o[a]))[e];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (o[a] != q) d[i + a * nth] = v[a];
    }
  } else {
    const int n = K * per;
    for (int i = tid; i < n; i += 4 * nth) {
      T v[4];
      int o[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int e = i + a * nth;
        o[a] = e < n ? cluster_owner(e / per, K, C) : q;
        if (o[a] != q) v[a] = at_rank(buf, o[a])[e];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (o[a] != q) buf[i + a * nth] = v[a];
    }
  }
}

// Every loop over pivots below is unrolled to CLUSTER_MU with an exit past
// the block's count, so that a row's register is picked by a constant
// index, and every update runs on all CLUSTER_MU register rows without a
// guard (rows past the block's hold values that are never stored): a
// guarded update compiled to a branch and its reconvergence per row.

// The owner's part of the elimination that runs in one warp (lane l holds
// column pu0 + l of the mb own rows, the columns of the block before,
// pmb of them, then those of the own block): first the block before's
// pivots on those columns, its scaled pivot rows read from their owner
// (rsave) and its multipliers multp[kp][r] = M[r][pu0 + kp] at pivot kp;
// then the own block's pivots: the reciprocals, the scaled pivot rows'
// entries right of each pivot in the block (saved to `save`) and the
// multipliers mult[kp][r] = M[r][bu0 + kp] at pivot kp.  What the columns
// right of the block need.
template <typename T>
__device__ __forceinline__ void gj_owner_pivots(const T* M, int ncol, int mb, int bu0,
                                                int pmb, const T* rsave, T* save, int lds,
                                                T* inv_s, T* mult, T* multp) {
  const int lane = threadIdx.x & 31, pu0 = bu0 - pmb, nc = pmb + mb;
  T dv[CLUSTER_MU], pr[CLUSTER_MU];
#pragma unroll
  for (int kp = 0; kp < CLUSTER_MU; ++kp)
    pr[kp] = kp < pmb && lane < nc ? rsave[kp * lds + pu0 + lane] : T(0);
#pragma unroll
  for (int r = 0; r < CLUSTER_MU; ++r)
    dv[r] = r < mb && lane < nc ? M[r * ncol + pu0 + lane] : T(0);
#pragma unroll
  for (int kp = 0; kp < CLUSTER_MU; ++kp) {
    if (kp >= pmb) break;
    T cr[CLUSTER_MU];
#pragma unroll
    for (int r = 0; r < CLUSTER_MU; ++r) cr[r] = __shfl_sync(0xffffffffu, dv[r], kp);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < CLUSTER_MU; ++r) multp[kp * CLUSTER_MU + r] = cr[r];
#pragma unroll
    for (int r = 0; r < CLUSTER_MU; ++r) dv[r] = dv[r] - cr[r] * pr[kp];
  }
#pragma unroll
  for (int kp = 0; kp < CLUSTER_MU; ++kp) {
    if (kp >= mb) break;
    const int lk = pmb + kp;  // the pivot's lane
    const T inv = T(1) / __shfl_sync(0xffffffffu, dv[kp], lk);
    T cr[CLUSTER_MU];
#pragma unroll
    for (int r = 0; r < CLUSTER_MU; ++r) cr[r] = __shfl_sync(0xffffffffu, dv[r], lk);
    const T pj = dv[kp] * inv;
    if (lane > lk && lane < nc) save[kp * lds + pu0 + lane] = pj;
    if (lane == 0) {
      inv_s[kp] = inv;
#pragma unroll
      for (int r = 0; r < CLUSTER_MU; ++r) mult[kp * CLUSTER_MU + r] = cr[r];
    }
#pragma unroll
    for (int r = 0; r < CLUSTER_MU; ++r) dv[r] = r == kp ? pj : dv[r] - cr[r] * pj;
  }
}

// The CLUSTER_MU multipliers of pivot kp (mult[kp][.]) as vector loads.
template <typename T>
__device__ __forceinline__ void load_multipliers(const T* mult, int kp, T (&m)[CLUSTER_MU]) {
#pragma unroll
  for (int r = 0; r < CLUSTER_MU; r += 4) {
    T v[4];
    load_vec<4>(mult + kp * CLUSTER_MU + r, v);
#pragma unroll
    for (int a = 0; a < 4; ++a) m[r + a] = v[a];
  }
}

// Column j of the own rows under the pmb pivots of another block (a thread
// a column): col[r] -= mult[kp][r] pv[kp], kp ascending, the pivot rows'
// entries pv from PR (row stride lds).
template <typename T>
__device__ __forceinline__ void gj_apply_block(T (&col)[CLUSTER_MU], int pmb, int j,
                                               const T* PR, int lds, const T* mult) {
#pragma unroll
  for (int kp = 0; kp < CLUSTER_MU; ++kp) {
    if (kp >= pmb) break;
    const T pv = PR[kp * lds + j];
    T m[CLUSTER_MU];
    load_multipliers(mult, kp, m);
#pragma unroll
    for (int r = 0; r < CLUSTER_MU; ++r) col[r] = col[r] - m[r] * pv;
  }
}

// The owner's block on column j right of it: first the pmb pivots of the
// block before (pivot rows PR, multipliers multp), then its own mb pivots
// in order, each scaled pivot row's entry saved for the other ranks.
template <typename T>
__device__ __forceinline__ void gj_block_column(T* M, int ncol, int mb, int j, T* save,
                                                int lds, const T* inv_s, const T* mult,
                                                int pmb, const T* PR, const T* multp) {
  T col[CLUSTER_MU];
#pragma unroll
  for (int r = 0; r < CLUSTER_MU; ++r) col[r] = r < mb ? M[r * ncol + j] : T(0);
  gj_apply_block(col, pmb, j, PR, lds, multp);
#pragma unroll
  for (int kp = 0; kp < CLUSTER_MU; ++kp) {
    if (kp >= mb) break;
    const T pj = col[kp] * inv_s[kp];
    save[kp * lds + j] = pj;
    T m[CLUSTER_MU];
    load_multipliers(mult, kp, m);
#pragma unroll
    for (int r = 0; r < CLUSTER_MU; ++r) col[r] = r == kp ? pj : col[r] - m[r] * pj;
  }
#pragma unroll
  for (int r = 0; r < CLUSTER_MU; ++r)
    if (r < mb) M[r * ncol + j] = col[r];
}

// Another block applied to own row `row` (a thread a row): its multipliers
// mult[kp][row] = M[row][pu0 + kp] at pivot kp (mult_row = mult + row,
// stride CLUSTER_MU), from the block's scaled pivot rows on the block's
// columns (PR, row stride lds, from column pu0).
template <typename T>
__device__ __forceinline__ void gj_row_multipliers(const T* Mrow, int pmb, const T* PR,
                                                   int lds, T* mult_row) {
  T x[CLUSTER_MU];
#pragma unroll
  for (int l = 0; l < CLUSTER_MU; ++l) x[l] = l < pmb ? Mrow[l] : T(0);
#pragma unroll
  for (int kp = 0; kp < CLUSTER_MU; ++kp) {
    if (kp >= pmb) break;
    const T c = x[kp];
    mult_row[kp * CLUSTER_MU] = c;
#pragma unroll
    for (int l = kp + 1; l < CLUSTER_MU; ++l) x[l] = x[l] - c * PR[kp * lds + l];
  }
}

// Column j of the mr own rows under another block: load, apply, store.
template <typename T>
__device__ __forceinline__ void gj_apply_column(T* M, int ncol, int mr, int pmb, int j,
                                                const T* PR, int lds, const T* mult) {
  T col[CLUSTER_MU];
#pragma unroll
  for (int r = 0; r < CLUSTER_MU; ++r) col[r] = r < mr ? M[r * ncol + j] : T(0);
  gj_apply_block(col, pmb, j, PR, lds, mult);
#pragma unroll
  for (int r = 0; r < CLUSTER_MU; ++r)
    if (r < mr) M[r * ncol + j] = col[r];
}

template <typename T>
__device__ __forceinline__ void symmetrize_blocks(const T* W, T* S, int n, int w) {
  for (int e = threadIdx.x; e < n * w * w; e += blockDim.x) {
    const int i = e / (w * w), a = e % (w * w) / w, b = e % w;
    S[e] = W[e] + W[(i * w + b) * w + a];
  }
}

// The prep of agents [i0, i1) at step t, compiled for the slot width NXC_LO
// where the problem's slots fit it (K3's input source's choice).
template <int NXC_LO, typename T, typename P>
__device__ __forceinline__ void prep_rows(const P& pb, const CostTerms<T>& c, int t, int i0,
                                          int i1, T* lx, T* lu, T* At, T* Bt, T* Lblk,
                                          T* G) {
  if (c.nx <= NXC_LO)
    sweep_prep_rows<NXC_LO, T, P>(pb, c, t, i0, i1, lx, lu, At, Bt, Lblk, G, threadIdx.x,
                                  blockDim.x);
  else
    sweep_prep_rows<MAX_NX, T, P>(pb, c, t, i0, i1, lx, lu, At, Bt, Lblk, G, threadIdx.x,
                                  blockDim.x);
}

// What the phases of the cluster sweep need: the widths, this rank's rows
// and the offsets (values) of its buffers.  Each phase of a step runs as a
// function of its own (not inlined), its pointers derived from the CTA's
// shared memory and these offsets: each gets the registers it needs
// instead of sharing them with everything the sweep keeps alive across a
// step (which spilled to local memory, hence to L2 beside 219 KB of shared
// memory, in every phase).
struct ClusterCtx {
  int K, nx, nu, C, q, k0, nxf, nuf, ncol, mx, mu, x0, u0, ms, ldq, lds, kq, ab;
  int P, AtP, Qxx, stage, Qux, QuuK, Quu, Qs, M, Kt, AB, Ld, Lu, Lblk, p, Qx, Qu, lx, lu,
      d, w, inv, mult;
};

// The CTA's dynamic shared memory (the kernel's extern array).
template <typename T>
__device__ __forceinline__ T* cluster_smem() {
  extern __shared__ __align__(16) unsigned char cluster_smem_raw[];
  return reinterpret_cast<T*>(cluster_smem_raw);
}

// Phase 3: the elimination, a block of pivots a rank.  Iteration b first
// applies block b - 1 (saved by its owner before the barrier that ended
// the iteration before) to the own rows; then the owner of block b takes
// its pivots, the columns right of its block in one pass with block
// b - 1's, and saves them for the barrier that ends the iteration.  The
// owner's part is the chain; a rank computes the own slots' inputs of the
// next step (`prep`, every thread) in the iteration after its own block,
// where it has nothing to apply (the last rank: in the first), between
// arriving at that iteration's barrier and waiting on it.
template <typename T, typename Prep>
__device__ __noinline__ void cluster_eliminate(const ClusterCtx& x, const Prep& prep) {
  T* const sm = cluster_smem<T>();
  const int K = x.K, nu = x.nu, C = x.C, q = x.q, nuf = x.nuf, ncol = x.ncol,
            mu_ = x.mu, lds = x.lds;
  const int tid = threadIdx.x, nth = blockDim.x;
  T* const M = sm + x.M;
  T* const save = sm + x.AtP;  // the scaled pivot rows of the own block
  T* const inv_s = sm + x.inv;
  T* const mult = sm + x.mult;
  T* const multp = mult + CLUSTER_MU * CLUSTER_MU;
  T* const PR = sm + x.stage;  // another block's pivot rows
  for (int b = 0; b <= C; ++b) {
    const int bu0 = b < C ? cluster_slot0(b, K, C) * nu : nuf;
    const int mb = b < C ? cluster_slot0(b + 1, K, C) * nu - bu0 : 0, bu1 = bu0 + mb;
    const int pu0 = b > 0 ? cluster_slot0(b - 1, K, C) * nu : 0, pmb = bu0 - pu0;
    const T* rsave = at_rank(save, b > 0 ? b - 1 : q);
    if (b == q) {
      // One warp: block b - 1 on the own block's columns, then the own
      // pivots; the others fetch block b - 1's pivot rows meanwhile.
      if (tid < 32)
        gj_owner_pivots(M, ncol, mb, bu0, pmb, rsave, save, lds, inv_s, mult, multp);
      else if (b > 0)
        pull(PR, rsave, pmb * lds, tid - 32, nth - 32);
      __syncthreads();
      for (int j = bu1 + tid; j < ncol; j += nth)
        gj_block_column(M, ncol, mb, j, save, lds, inv_s, mult, pmb, PR, multp);
    } else if (b > 0 && b - 1 != q) {
      // Block b - 1's pivot rows, whole, into the staging buffer; the own
      // rows' multipliers of it; then every column right of it.
      pull(PR, rsave, pmb * lds, tid, nth);
      __syncthreads();
      if (tid < mu_)
        gj_row_multipliers(M + tid * ncol + pu0, pmb, PR + pu0, lds,
                           multp + tid);
      __syncthreads();
      for (int j = bu0 + tid; j < ncol; j += nth)
        gj_apply_column(M, ncol, mu_, pmb, j, PR, lds, multp);
      __syncthreads();
    }
    if (b == (q + 1) % C) {
      // This rank has nothing to do in this iteration: it arrives at once
      // and computes its inputs while the owner of block b works.
      cluster_arrive();
      prep();
      cluster_wait();
    } else if (b < C) {
      cluster_sync();  // block b's pivot rows are saved
    }
  }
}

// One rank's rows v0 .. v0 + mv - 1 of Qux (qx) and Quu K (qk) into a
// tile's sums of K^T Qux (X), its transpose (Xt) and K^T Quu K (Z): rows
// r0g .., columns c0 .. (v = 0 starts every sum).  FULL: every row segment
// is a whole aligned vector (no guard in the loop).
template <bool FULL, typename T>
__device__ __forceinline__ void update_chunk(const T* Kt, const T* qx, const T* qk, int nxf,
                                             int v0, int mv, int r0g, int nr, int c0,
                                             bool vr, bool vc, T (&X)[4][4], T (&Xt)[4][4],
                                             T (&Z)[4][4]) {
  T ar[4], ac[4], bc[4], br[4], zc[4];
  auto operands = [&](int vl) {
    const int v = v0 + vl;
    if constexpr (FULL) {
      load_vec<4>(Kt + v * nxf + r0g, ar);
      load_vec<4>(Kt + v * nxf + c0, ac);
      load_vec<4>(qx + vl * nxf + c0, bc);
      load_vec<4>(qx + vl * nxf + r0g, br);
      load_vec<4>(qk + vl * nxf + c0, zc);
    } else {
      load_row<4>(Kt + v * nxf + r0g, nr, vr, ar);
      load_row<4>(Kt + v * nxf + c0, nxf - c0, vc, ac);
      load_row<4>(qx + vl * nxf + c0, nxf - c0, vc, bc);
      load_row<4>(qx + vl * nxf + r0g, nr, vr, br);
      load_row<4>(qk + vl * nxf + c0, nxf - c0, vc, zc);
    }
  };
  int vl = 0;
  if (v0 == 0) {
    operands(0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        X[i][j] = mul_rn(ar[i], bc[j]);
        Xt[i][j] = mul_rn(ac[j], br[i]);
        Z[i][j] = mul_rn(ar[i], zc[j]);
      }
    vl = 1;
  }
  for (; vl < mv; ++vl) {
    operands(vl);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        X[i][j] = X[i][j] + ar[i] * bc[j];
        Xt[i][j] = Xt[i][j] + ac[j] * br[i];
        Z[i][j] = Z[i][j] + ar[i] * zc[j];
      }
  }
}

// Phase 6: p and P_new = Qxx + K^T Quu K + K^T Qux + (K^T Qux)^T on the own
// rows, a rank's rows of Qux and Quu K at a time (each thread's tile's sums
// stay in registers from one rank to the next); ends with the cluster
// barrier after which Q_xx is read by its transposes' owners.
template <typename T>
__device__ __noinline__ void cluster_value_update(const ClusterCtx& x) {
  T* const sm = cluster_smem<T>();
  const int K = x.K, nu = x.nu, C = x.C, q = x.q, nxf = x.nxf, nuf = x.nuf, mx = x.mx,
            x0 = x.x0;
  const int tid = threadIdx.x, nth = blockDim.x;
  T* const Qxx = sm + x.Qxx;
  T* const Qux = sm + x.Qux;
  T* const QuuK = sm + x.QuuK;
  T* const Kt = sm + x.Kt;
  T* const p = sm + x.p;
  T* const Qx = sm + x.Qx;
  T* const d = sm + x.d;
  T* const w = sm + x.w;
  T* const stage = sm + x.stage;
  T* const stage2 = stage + pad4((size_t)x.ms * nu * nxf);
  const int ntx = (nxf + 3) / 4, ntiles = (mx + 3) / 4 * ntx;
  const bool vect = nxf % 4 == 0;
  gather_slots(w, nu, K, C, q, tid, nth);
  T a2 = T(0);  // the own entry tid of p: sum_v Qux[v][c] d[v]
  for (int base = 0; base < ntiles; base += nth) {
    const int it = base + tid;
    const bool has = it < ntiles;
    const int r0 = has ? (it / ntx) * 4 : 0, c0 = has ? (it % ntx) * 4 : 0;
    const int r0g = x0 + r0, nr = mx - r0 < 4 ? mx - r0 : 4;
    const bool vr = vect && r0g % 4 == 0 && nr == 4, vc = vect && c0 + 4 <= nxf;
    T X[4][4], Xt[4][4], Z[4][4];
    for (int r = 0; r < C; ++r) {
      const int v0 = cluster_slot0(r, K, C) * nu, mv = cluster_slot0(r + 1, K, C) * nu - v0;
      const T *qx = Qux, *qk = QuuK;
      if (r != q) {
        __syncthreads();  // the staging buffer is free
        qx = stage;
        qk = stage2;
        pull2(stage, at_rank(Qux, r), stage2, at_rank(QuuK, r), mv * nxf, tid, nth);
        __syncthreads();
      }
      if (has) {
        if (vr && vc)
          update_chunk<true>(Kt, qx, qk, nxf, v0, mv, r0g, nr, c0, vr, vc, X, Xt, Z);
        else
          update_chunk<false>(Kt, qx, qk, nxf, v0, mv, r0g, nr, c0, vr, vc, X, Xt, Z);
      }
      if (base == 0 && tid < mx)
        for (int vl = 0; vl < mv; ++vl) {
          const int v = v0 + vl;
          const T qv = qx[vl * nxf + x0 + tid];
          a2 = v == 0 ? mul_rn(qv, d[0]) : a2 + qv * d[v];
        }
    }
    if (has) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < mx) {
          T qv[4];
          T* const row = Qxx + (r0 + i) * nxf + c0;
          load_row<4>(row, nxf - c0, vc, qv);
#pragma unroll
          for (int j = 0; j < 4; ++j) qv[j] = qv[j] + Z[i][j] + X[i][j] + Xt[i][j];
          store_row<4>(row, nxf - c0, vc, qv);
        }
    }
  }
  for (int i = tid; i < mx; i += nth) {
    const int col = x0 + i;
    T a1 = mul_rn(Kt[col], w[0]);
    for (int v = 1; v < nuf; ++v) a1 += Kt[v * nxf + col] * w[v];
    p[i] = Qx[i] + a1 + a2;
  }
  cluster_sync();  // Q_xx of every rank
}

// bd_right on four whole rows (r0 + 4 <= nrows): the same sums with no
// guard in the loop (a guarded update compiled to a branch a row).
template <typename T>
__device__ __forceinline__ void bd_right_full(const T* In, int ldin, const T* Blk, int w,
                                              int nx, int r0, int kc, int jc, T (&acc)[4]) {
  const T* in = In + r0 * ldin + kc * nx;
  const T* blk = Blk + kc * nx * w + jc;
  const T a0 = blk[0];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = mul_rn(in[i * ldin], a0);
  for (int b = 1; b < nx; ++b) {
    const T a = blk[b * w];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = acc[i] + in[i * ldin + b] * a;
  }
}

// bd_left where nxf is a multiple of four (every row segment a whole
// aligned vector): the same sums with no branch in the loop.
template <bool REG, typename T>
__device__ __forceinline__ void bd_left_full(const T* Blk, int w, int nrows, const T* P,
                                             T mu, T* out, int nx, int nxf, int row0) {
  const int nx4 = nxf / 4;
  const Grid2 g = grid2(nx4);
  if (!g.on) return;
  const int dk = g.nyt / w, dj = g.nyt % w;
  for (int cs = g.tx; cs < nx4; cs += g.nxt) {
    const int c0 = cs * 4;
    int k = g.ty / w, j = g.ty % w;
    for (int r = g.ty; r < nrows; r += g.nyt) {
      const T* prow = P + k * nx * nxf + c0;
      const T* blk = Blk + k * nx * w + j;
      T acc[4], pv[4];
      for (int b = 0; b < nx; ++b) {
        load_vec<4>(prow + b * nxf, pv);
        const T a = blk[b * w];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T preg = REG ? pv[i] + (row0 + k * nx + b == c0 + i ? mu : T(0)) : pv[i];
          const T term = a * preg;
          acc[i] = b == 0 ? term : acc[i] + term;
        }
      }
      store_row<4>(out + r * nxf + c0, 4, true, acc);
      k += dk;
      j += dj;
      if (j >= w) {
        j -= w;
        ++k;
      }
    }
  }
}

// Phase 1 of step t on the own rows: the other ranks' blocks of A_t and
// B_t, then Q_x, Q_u, A^T P, B^T (P + mu I).
template <typename T>
__device__ __noinline__ void cluster_phase1(const ClusterCtx& x, int t, T mu) {
  T* const sm = cluster_smem<T>();
  const int K = x.K, nx = x.nx, nu = x.nu, nxf = x.nxf, mx = x.mx, mu_ = x.mu, x0 = x.x0,
            u0 = x.u0, k0 = x.k0;
  const int tid = threadIdx.x, nth = blockDim.x;
  T* const At = sm + x.AB + (t & 1) * x.ab;
  T* const Bt = At + pad4((size_t)K * nx * nx);
  const T* const p = sm + x.p;
  const T* const lx = sm + x.lx;
  const T* const lu = sm + x.lu;
  T* const Qx = sm + x.Qx;
  T* const Qu = sm + x.Qu;
  // (phase 2 reads the other ranks' blocks, after the barrier below)
  gather_slots(At, nx * nx, K, x.C, x.q, tid, nth);
  gather_slots(Bt, nx * nu, K, x.C, x.q, tid, nth);
  for (int i = tid; i < mx; i += nth) {
    const int k = (x0 + i) / nx, j = (x0 + i) % nx, pk = k * nx - x0;
    T acc = mul_rn(At[(k * nx) * nx + j], p[pk]);
    for (int b = 1; b < nx; ++b) acc += At[(k * nx + b) * nx + j] * p[pk + b];
    Qx[i] = lx[i] + acc;
  }
  for (int i = tid; i < mu_; i += nth) {
    const int k = (u0 + i) / nu, j = (u0 + i) % nu, pk = k * nx - x0;
    T acc = mul_rn(Bt[(k * nx) * nu + j], p[pk]);
    for (int b = 1; b < nx; ++b) acc += Bt[(k * nx + b) * nu + j] * p[pk + b];
    Qu[i] = lu[i] + acc;
  }
  if (nxf % 4 == 0) {
    bd_left_full<false>(At + k0 * nx * nx, nx, mx, sm + x.P, mu, sm + x.AtP, nx, nxf, x0);
    bd_left_full<true>(Bt + k0 * nx * nu, nu, mu_, sm + x.P, mu, sm + x.stage, nx, nxf, x0);
  } else {
    bd_left<false>(At + k0 * nx * nx, nx, mx, sm + x.P, mu, sm + x.AtP, nx, nxf, x0);
    bd_left<true>(Bt + k0 * nx * nu, nu, mu_, sm + x.P, mu, sm + x.stage, nx, nxf, x0);
  }
  __syncthreads();
}

// Phase 2 of step t on the own rows: Q_xx, Q_ux, Q_uu and the tableau.
template <typename T>
__device__ __noinline__ void cluster_phase2(const ClusterCtx& x, int t) {
  T* const sm = cluster_smem<T>();
  const int K = x.K, nx = x.nx, nu = x.nu, nxf = x.nxf, nuf = x.nuf, ncol = x.ncol,
            mx = x.mx, mu_ = x.mu, x0 = x.x0, u0 = x.u0, kq = x.kq;
  const T* const At = sm + x.AB + (t & 1) * x.ab;
  const T* const Bt = At + pad4((size_t)K * nx * nx);
  const T* const AtP = sm + x.AtP;
  const T* const W1 = sm + x.stage;
  const T* const Ld = sm + x.Ld;
  const T* const Lu = sm + x.Lu;
  // L_xx's own rows: lxx_entry on the own rows of Lblk (its base shifted
  // back by k0 rows, as sweep_prep_rows_inline's).
  const T* const Lrows = sm + x.Lblk - (long long)x.k0 * K * kq * kq;
  T* const Qxx = sm + x.Qxx;
  T* const Qux = sm + x.Qux;
  T* const Quu = sm + x.Quu;
  T* const M = sm + x.M;
  // Every strip of four rows whole: the loops below run without a guard.
  const bool whole = mx % 4 == 0 && mu_ % 4 == 0;
  if (whole) {
    const Grid2 g = grid2(nxf);
    if (g.on)
      for (int col = g.tx; col < nxf; col += g.nxt) {
        const int kc = col / nx, jc = col % nx;
        T acc[4];
        for (int r0 = 4 * g.ty; r0 < mx; r0 += 4 * g.nyt) {
          bd_right_full(AtP, nxf, At, nx, nx, r0, kc, jc, acc);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            Qxx[(r0 + i) * nxf + col] = lxx_entry(x0 + r0 + i, col, K, nx, kq, Ld, Lrows) + acc[i];
        }
        for (int r0 = 4 * g.ty; r0 < mu_; r0 += 4 * g.nyt) {
          bd_right_full(W1, nxf, At, nx, nx, r0, kc, jc, acc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            Qux[(r0 + i) * nxf + col] = acc[i];
            M[(r0 + i) * ncol + nuf + col] = acc[i];
          }
        }
      }
    const Grid2 h = grid2(nuf);
    if (h.on)
      for (int col = h.tx; col < nuf; col += h.nxt) {
        const int kc = col / nu, jc = col % nu;
        T acc[4];
        for (int r0 = 4 * h.ty; r0 < mu_; r0 += 4 * h.nyt) {
          bd_right_full(W1, nxf, Bt, nu, nx, r0, kc, jc, acc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const T qv = acc[i] + luu_entry(u0 + r0 + i, col, nu, Lu);
            Quu[(r0 + i) * nuf + col] = qv;
            M[(r0 + i) * ncol + col] = qv;
          }
        }
      }
  } else {
  {
    const Grid2 g = grid2(nxf);
    if (g.on)
      for (int col = g.tx; col < nxf; col += g.nxt) {
        const int kc = col / nx, jc = col % nx;
        T acc[4];
        for (int r0 = 4 * g.ty; r0 < mx; r0 += 4 * g.nyt) {
          bd_right(AtP, nxf, mx, At, nx, nx, r0, kc, jc, acc);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (r0 + i < mx)
              Qxx[(r0 + i) * nxf + col] =
                  lxx_entry(x0 + r0 + i, col, K, nx, kq, Ld, Lrows) + acc[i];
        }
        for (int r0 = 4 * g.ty; r0 < mu_; r0 += 4 * g.nyt) {
          bd_right(W1, nxf, mu_, At, nx, nx, r0, kc, jc, acc);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (r0 + i < mu_) {
              Qux[(r0 + i) * nxf + col] = acc[i];
              M[(r0 + i) * ncol + nuf + col] = acc[i];
            }
        }
      }
  }
  {
    const Grid2 g = grid2(nuf);
    if (g.on)
      for (int col = g.tx; col < nuf; col += g.nxt) {
        const int kc = col / nu, jc = col % nu;
        T acc[4];
        for (int r0 = 4 * g.ty; r0 < mu_; r0 += 4 * g.nyt) {
          bd_right(W1, nxf, mu_, Bt, nu, nx, r0, kc, jc, acc);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (r0 + i < mu_) {
              const T qv = acc[i] + luu_entry(u0 + r0 + i, col, nu, Lu);
              Quu[(r0 + i) * nuf + col] = qv;
              M[(r0 + i) * ncol + col] = qv;
            }
        }
      }
  }
  }
  const T* const Qu = sm + x.Qu;
  for (int i = threadIdx.x; i < mu_; i += blockDim.x) M[i * ncol + nuf + nxf] = Qu[i];
  __syncthreads();
}

// Phase 4 of step t: the own rows' gains K = -X, d = -x (a step's block is
// contiguous) into Kg, dg and into K and d whole; then the cluster barrier
// after which the other ranks read them.
template <typename T>
__device__ __noinline__ void cluster_gains(const ClusterCtx& x, int t, T* Kg, T* dg) {
  T* const sm = cluster_smem<T>();
  const int nxf = x.nxf, nuf = x.nuf, ncol = x.ncol, mu_ = x.mu, u0 = x.u0;
  const int tid = threadIdx.x, nth = blockDim.x;
  const T* const M = sm + x.M;
  T* const Kt = sm + x.Kt + (size_t)u0 * nxf;
  T* const d = sm + x.d;
  T* const Kg_t = Kg + (size_t)t * nuf * nxf + (size_t)u0 * nxf;
  for (int e = tid; e < mu_ * nxf; e += nth) {
    const int r = e / nxf, col = e - r * nxf;
    const T kval = -M[r * ncol + nuf + col];
    Kt[e] = kval;
    Kg_t[e] = kval;
  }
  for (int r = tid; r < mu_; r += nth) {
    const T dval = -M[r * ncol + nuf + nxf];
    d[u0 + r] = dval;
    dg[(size_t)t * nuf + u0 + r] = dval;
  }
  cluster_sync();  // K and d of every rank
}

// Phase 5: K and d whole, Q_uu's columns of the own rows; then w = Quu d +
// Qu and Quu K on the own rows; then the cluster barrier after which the
// other ranks read them.
template <typename T>
__device__ __noinline__ void cluster_phase5(const ClusterCtx& x) {
  T* const sm = cluster_smem<T>();
  const int K = x.K, nu = x.nu, C = x.C, q = x.q, nxf = x.nxf, nuf = x.nuf, mu_ = x.mu,
            u0 = x.u0, ldq = x.ldq;
  const int tid = threadIdx.x, nth = blockDim.x;
  T* const Kt = sm + x.Kt;
  T* const d = sm + x.d;
  T* const Quu = sm + x.Quu;
  T* const Qs = sm + x.Qs;
  T* const QuuK = sm + x.QuuK;
  const T* const Qu = sm + x.Qu;
  T* const w = sm + x.w;
  const int ntx = (nxf + 3) / 4;
  const bool vect = nxf % 4 == 0;
  gather_slots(Kt, nu * nxf, K, C, q, tid, nth);
  gather_slots(d, nu, K, C, q, tid, nth);
  for (int i = tid; i < nuf * mu_; i += 4 * nth) {
    T v[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int e = i + a * nth, vr = e / mu_, rl = e - vr * mu_;
      const int o = cluster_owner(vr / nu, K, C);
      if (e < nuf * mu_)
        v[a] = (o == q ? Quu : at_rank(Quu, o))[(vr - cluster_slot0(o, K, C) * nu) * nuf +
                                                u0 + rl];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int e = i + a * nth, vr = e / mu_, rl = e - vr * mu_;
      if (e < nuf * mu_) Qs[vr * ldq + rl] = v[a];
    }
  }
  __syncthreads();
  for (int r = tid; r < mu_; r += nth) {
    T acc = mul_rn(Qs[r], d[0]);
    for (int v = 1; v < nuf; ++v) acc += Qs[v * ldq + r] * d[v];
    w[u0 + r] = acc + Qu[r];
  }
  for (int it = tid; it < (mu_ + 3) / 4 * ntx; it += nth) {
    const int r0 = (it / ntx) * 4, c0 = (it % ntx) * 4;
    T acc[4][4];
    atb_tile<4>(Qs, ldq, mu_, Kt, nxf, nxf, nuf, r0, c0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < mu_)
        store_row<4>(QuuK + (r0 + i) * nxf + c0, nxf - c0, vect && c0 + 4 <= nxf, acc[i]);
  }
  cluster_sync();  // Quu K and w of every rank
}

// Phase 7: P = (Q_xx + Q_xx^T) / 2 on the own rows, the transposed entries
// from their owners; then the cluster barrier that ends the step (every
// rank's Q_xx read, the next step's inputs in place).
template <typename T>
__device__ __noinline__ void cluster_symmetrize(const ClusterCtx& x) {
  T* const sm = cluster_smem<T>();
  const int K = x.K, nx = x.nx, C = x.C, nxf = x.nxf, mx = x.mx, x0 = x.x0;
  T* const Qxx = sm + x.Qxx;
  T* const P = sm + x.P;
  const int ntx = (nxf + 3) / 4, ntiles = (mx + 3) / 4 * ntx;
  const bool vect = nxf % 4 == 0;
  for (int it = threadIdx.x; it < ntiles; it += blockDim.x) {
    const int r0 = (it / ntx) * 4, c0 = (it % ntx) * 4;
    const int r0g = x0 + r0, nr = mx - r0 < 4 ? mx - r0 : 4;
    const bool full = vect && c0 + 4 <= nxf, fullT = vect && r0g % 4 == 0 && nr == 4;
    T tr[4][4];
    if (full && fullT) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // tr[j][i] = Qxx[c0 + j][r0g + i]
        const int row = c0 + j, o = cluster_owner(row / nx, K, C);
        load_vec<4>(at_rank(Qxx, o) + (row - cluster_slot0(o, K, C) * nx) * nxf + r0g, tr[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = c0 + j;
        if (row < nxf) {
          const int o = cluster_owner(row / nx, K, C);
          const T* src = at_rank(Qxx, o) + (row - cluster_slot0(o, K, C) * nx) * nxf + r0g;
          load_row<4>(src, nr, fullT, tr[j]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) tr[j][i] = T(0);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < mx) {
        T qv[4];
        load_row<4>(Qxx + (r0 + i) * nxf + c0, nxf - c0, full, qv);
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = T(0.5) * (qv[j] + tr[j][i]);
        store_row<4>(P + (r0 + i) * nxf + c0, nxf - c0, full, qv);
      }
  }
  cluster_sync();  // every rank's Q_xx read, the next step's inputs in place
}

// The Riccati sweep of one subproblem by the calling cluster (every thread
// of every CTA calls it): riccati_sweep_from's recursion with the working
// set split by slots over the ranks, a phase a function.  `sm`: the CTA's
// dynamic shared memory (cluster_layout's total).
template <int NXC_LO, typename T, typename Prob>
__device__ __forceinline__ void riccati_cluster_sweep(const Prob& pb, const T mu,
                                                      T* __restrict__ Kg,
                                                      T* __restrict__ dg, int N, int K,
                                                      int nx, int nu, T* sm) {
  const int C = (int)cg::this_cluster().num_blocks();
  const int q = (int)cg::this_cluster().block_rank();
  const ClusterLayout L = cluster_layout(K, nx, nu, C);
  const int k0 = cluster_slot0(q, K, C), k1 = cluster_slot0(q + 1, K, C);
  const int nxf = K * nx, nuf = K * nu, kq = nx < 3 ? nx : 3;
  const int mx = (k1 - k0) * nx, x0 = k0 * nx;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int ab = (int)(pad4((size_t)K * nx * nx) + pad4((size_t)K * nx * nu));
  const ClusterCtx ctx = {K, nx, nu, C, q, k0, nxf, nuf, nuf + nxf + 1, mx,
                          (k1 - k0) * nu, x0, k0 * nu, L.ms, L.ldq, L.lds, kq, ab,
                          (int)L.P, (int)L.AtP, (int)L.Qxx, (int)L.stage, (int)L.Qux,
                          (int)L.QuuK, (int)L.Quu, (int)L.Qs, (int)L.M, (int)L.Kt,
                          (int)L.AB, (int)L.Ld, (int)L.Lu, (int)L.Lblk, (int)L.p,
                          (int)L.Qx, (int)L.Qu, (int)L.lx, (int)L.lu, (int)L.d, (int)L.w,
                          (int)L.inv, (int)L.mult};
  T* const QQ = sm + L.QQ;
  T* const RR = sm + L.RR;
  T* const Ld = sm + L.Ld;
  T* const Lu = sm + L.Lu;
  T* const Lblk = sm + L.Lblk;
  T* const G = sm + L.G;
  const CostTerms<T> c = {pb.xf, QQ, RR, pb.mask, pb.npos, pb.refw, pb.radius, pb.pw,
                          K, nx, nu, kq};
  // The own slots' inputs of step s (A_s, B_s into that step's half of AB).
  auto prep_step = [&](int s) {
    T* const As = sm + L.AB + (s & 1) * ab;
    prep_rows<NXC_LO>(pb, c, s, k0, k1, sm + L.lx, sm + L.lu, As,
                      As + pad4((size_t)K * nx * nx), Lblk, G);
  };

  // The terminal step's P and p (ComputedInputs::init, own rows), then the
  // stage blocks, then step N-1's inputs of the own slots.
  symmetrize_blocks(pb.Qf, QQ, K, nx);
  symmetrize_blocks(pb.R, RR, K, nu);
  __syncthreads();
  constant_blocks(c, Ld, Lu, tid, nth);
  prep_rows<NXC_LO>(pb, c, N, k0, k1, sm + L.p, (T*)nullptr, (T*)nullptr, (T*)nullptr,
                    Lblk, G);
  __syncthreads();
  {
    const T* const Lrows = Lblk - (long long)k0 * K * kq * kq;
    T* const P = sm + L.P;
    for (int e = tid; e < mx * nxf; e += nth)
      P[e] = lxx_entry(x0 + e / nxf, e % nxf, K, nx, kq, Ld, Lrows);
  }
  symmetrize_blocks(pb.Q, QQ, K, nx);
  __syncthreads();
  constant_blocks(c, Ld, Lu, tid, nth);
  if (N > 0) prep_step(N - 1);
  cluster_sync();
#ifdef DPILQR_PHASE_CLOCKS
  long long phase_start_ = clock64();
#endif

  for (int t = N - 1; t >= 0; --t) {
    RICCATI_CLOCK(0)
    cluster_phase1<T>(ctx, t, mu);
    RICCATI_CLOCK(1)
    cluster_phase2<T>(ctx, t);
    RICCATI_CLOCK(2)
    // The elimination; inside it, while this rank waits for a block's
    // owner, the own slots' inputs of the next step.
    auto prep = [&]() {
      if (t > 0) prep_step(t - 1);
    };
    cluster_eliminate<T>(ctx, prep);
    RICCATI_CLOCK(3)
    cluster_gains<T>(ctx, t, Kg, dg);
    RICCATI_CLOCK(4)
    cluster_phase5<T>(ctx);
    RICCATI_CLOCK(5)
    cluster_value_update<T>(ctx);
    RICCATI_CLOCK(6)
    cluster_symmetrize<T>(ctx);
    RICCATI_CLOCK(7)
  }
}

// Launch `kernel` on clusters of `cluster` CTAs (blocks a multiple of it)
// with `bytes` of dynamic shared memory: first the occupancy check that a
// cluster can be placed at all (cached per shape; a launch that cannot be
// placed returns cudaErrorLaunchOutOfResources and launches nothing).
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int blocks, int threads, int cluster,
                   size_t bytes, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // The checked shapes: (kernel, cluster, bytes, threads, device).
  struct Checked {
    const void* fn;
    int cluster, threads, dev;
    size_t bytes;
  };
  static Checked checked[32];
  static int n_checked = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  bool known = false;
  for (int i = 0; i < n_checked && !known; ++i)
    known = checked[i].fn == (const void*)kernel && checked[i].cluster == cluster &&
            checked[i].threads == threads && checked[i].dev == dev &&
            checked[i].bytes == bytes;
  if (!known) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (active < 1) return (int)cudaErrorLaunchOutOfResources;
    if (n_checked < 32) checked[n_checked++] = {(const void*)kernel, cluster, threads, dev, bytes};
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
