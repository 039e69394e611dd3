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
// Q_ux, Q_uu, K and the right-hand sides [Q_ux | Q_u] (its slots' nu each).  A and B are block
// diagonal, so phases 1 and 2 need a CTA's own rows and every slot's A and
// B blocks (each rank computes its own slots' inputs, computed_inputs.cuh
// sweep_prep_rows, and pulls the others' blocks through distributed shared
// memory).  The arithmetic is riccati_sweep_from's, entry by entry: the same
// products in the same order (mul_rn on the first pair, then fused
// multiply-adds in index order), the same reciprocals, so that the cluster
// tier gives tier 2's bits on the same problem.
//
// The elimination is split by columns, since no right-hand column ever
// feeds a pivot: column j's value at pivot kp depends only on the
// multipliers M[r][kp] (Q_uu's own columns), the reciprocals and column j's
// own entries.  Phase 3a, the pivot chain: every rank writes its rows of
// Q_uu into one rank (CHAIN_RANK), whose warps eliminate that nuf x nuf
// square alone, in panels of pivots: one warp takes a panel's pivots in
// its registers (a shuffle, not a barrier, a pivot) and records each
// pivot's reciprocal and multipliers; six warps apply each taken panel to
// the next one, which is then ready for the chain, and to the columns past
// it; two push its multipliers into the other ranks; three compute the
// rank's inputs of the next step, as the other ranks do meanwhile.  Phase
// 3b, the right-hand pass: each rank takes its share of the nxf + 1
// right-hand columns in chunks of four (sent to it with the rows of Q_uu),
// a warp a chunk with every row in its lanes' registers, through every
// pivot with no barrier, and writes them back to the rows' owners.
// Three cluster barriers a step for the elimination, whatever C.  Every
// entry still takes M[r][j] - M[r][kp] (M[kp][j] (1 / M[kp][kp])) for kp
// ascending.
//
// The value update reads the others' rows of K, Q_ux and K^T Q_uu's factor
// Q_uu K through distributed shared memory: K whole (pulled once a step),
// Q_ux and Q_uu K a rank's rows at a time into a staging buffer, while each
// thread keeps its tile's sums in registers from one rank's rows to the
// next; the symmetrization reads the transposed entries of Q_xx from their
// owners.  Seven cluster barriers a step, whatever C.
//
// What bounds it on an H100 (scripts/riccati_phase_clocks.py, rank 0 of the
// first cluster, Quad6D K = 32 float32): about 220 k cycles a step; the
// pivot chain about 69 k (its warp about 30 k factoring, the rest waiting
// on the update warps; the chain rank's own prep about 32 k beside it),
// the right-hand pass about 22 k, the value update's products about 64 k.
// A cluster of 8 CTAs of 212 KiB takes 8 SMs of one GPC: 15 clusters fit
// the H100 at once, so a launch of S subproblems runs in ceil(S / 15)
// waves.

#pragma once

#include <cooperative_groups.h>

#include "computed_inputs.cuh"
#include "plan.h"

namespace {

namespace cg = cooperative_groups;

// The threads of a CTA (the cluster's sizes and layout, CLUSTER_MAX,
// CLUSTER_MU, cluster_layout and wide_plan, are plan.h's).
constexpr int CLUSTER_THREADS = 384;
// The rank that runs the pivot chain.
constexpr int CHAIN_RANK = 0;

// First slot of rank q of a cluster of C over K slots, and the rank that
// owns a slot.
__host__ __device__ inline int cluster_slot0(int q, int K, int C) { return q * K / C; }
__host__ __device__ inline int cluster_owner(int slot, int K, int C) {
  return ((slot + 1) * C - 1) / K;
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

// The elimination's workers keep their entries in registers, lane l of a
// warp rows R l .. R l + R - 1 (R = ceil(nuf / 32); rows past nuf hold
// values that are never stored), under loops over a panel's W pivots
// unrolled so that the pivot's register row (kp mod R, W a multiple of R)
// is a constant, and update every register row without a guard: a guarded
// update compiled to a branch and its reconvergence per row.

// R values of a multiplier row from this lane's first row on.
template <int R, typename T>
__device__ __forceinline__ void load_rows(const T* p, T (&m)[R]) {
  if constexpr (R == 2 || R == 4) {
    load_vec<R>(p, m);
  } else {
#pragma unroll
    for (int a = 0; a < R; ++a) m[a] = p[a];
  }
}

// NC columns in one warp (col[b][a]: column b, this lane's row a).  Panels
// p0 .. p1 - 1 of W pivots (kp < nuf) on them, in order: the pivot row's
// entries by shuffle from the lane that holds row kp, scaled by the
// reciprocal, then col[r] -= M[r][kp] pj with this lane's multipliers of
// pivot kp (Mult row kp, stride ldm), the pivot row itself set to pj.  The
// next pivot's multipliers and reciprocal are loaded while a pivot is
// applied.
template <int R, int W, int NC, typename T>
__device__ __forceinline__ void gj_warp_columns(T (&col)[NC][R], int p0, int p1, int nuf,
                                                const T* Mult, int ldm, const T* inv_s) {
  static_assert(W % R == 0, "a panel starts on register row 0");
  const int lane = threadIdx.x & 31, r0 = R * lane;
  const int k1 = W * p1 < nuf ? W * p1 : nuf;
  T m[R], inv = T(0);
#pragma unroll
  for (int a = 0; a < R; ++a) m[a] = T(0);
  if (W * p0 < k1) {
    inv = inv_s[W * p0];
    load_rows<R>(Mult + W * p0 * ldm + r0, m);
  }
  for (int p = p0; p < p1; ++p) {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int kp = W * p + c, lk = kp / R;
      if (kp >= k1) break;
      const T inv_k = inv;
      T m_k[R];
#pragma unroll
      for (int a = 0; a < R; ++a) m_k[a] = m[a];
      if (kp + 1 < k1) {
        inv = inv_s[kp + 1];
        load_rows<R>(Mult + (kp + 1) * ldm + r0, m);
      }
      T pj[NC];
#pragma unroll
      for (int b = 0; b < NC; ++b)
        pj[b] = __shfl_sync(0xffffffffu, col[b][c % R], lk) * inv_k;
#pragma unroll
      for (int b = 0; b < NC; ++b)
#pragma unroll
        for (int a = 0; a < R; ++a)
          col[b][a] = a == c % R && lane == lk ? pj[b] : col[b][a] - m_k[a] * pj[b];
    }
  }
}

// NC columns of the square S (row stride lds) from column j on, through
// panels p0 .. p1 - 1, in one warp: loaded, eliminated, stored back.
template <int R, int W, int NC, typename T>
__device__ __forceinline__ void gj_square_columns(T* S, int lds, int nuf, int j, int p0,
                                                  int p1, const T* Mult, int ldm,
                                                  const T* inv_s) {
  const int r0 = R * (threadIdx.x & 31);
  T col[NC][R];
#pragma unroll
  for (int b = 0; b < NC; ++b)
#pragma unroll
    for (int a = 0; a < R; ++a)
      col[b][a] = r0 + a < nuf && j + b < nuf ? S[(r0 + a) * lds + j + b] : T(0);
  gj_warp_columns<R, W, NC>(col, p0, p1, nuf, Mult, ldm, inv_s);
#pragma unroll
  for (int b = 0; b < NC; ++b)
#pragma unroll
    for (int a = 0; a < R; ++a)
      if (r0 + a < nuf && j + b < nuf) S[(r0 + a) * lds + j + b] = col[b][a];
}

// The named barriers of the pivot chain (0 is the CTA's, 2 the prep's): a
// panel taken (the chain's, update and push warps), the next panel ready
// for the chain (the chain's and update warps).
constexpr int BAR_TAKEN = 1, BAR_READY = 3;

template <int ID>
__device__ __forceinline__ void named_sync(int threads) {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "r"(threads) : "memory");
}

// The pivot chain's warp: the nuf x nuf square S (row stride lds) in panels
// of W pivots.  Once panel p is ready (every pivot before it applied, by
// the update warps), its W columns in registers: for each pivot the pivot
// row's entries by shuffle, the reciprocal, the multipliers (this lane's
// rows of the pivot's column) and the reciprocal recorded in Mult and
// inv_s, the columns right of the pivot updated; then the panel is handed
// over.
template <int R, int W, typename T>
__device__ __forceinline__ void gj_chain_warp(const T* S, int lds, int nuf, T* Mult, int ldm,
                                              T* inv_s, int taken, int ready) {
  const int lane = threadIdx.x & 31, r0 = R * lane, np = (nuf + W - 1) / W;
  for (int p = 0; p < np; ++p) {
    const int c0 = W * p;
    if (p > 0) named_sync<BAR_READY>(ready);
    T reg[W][R];
#pragma unroll
    for (int c = 0; c < W; ++c)
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int row = r0 + a, col = c0 + c;
        reg[c][a] = row < nuf && col < nuf ? S[row * lds + col] : T(0);
      }
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int kp = c0 + c, lk = kp / R;
      if (kp >= nuf) break;
      T pv[W];
#pragma unroll
      for (int c2 = c; c2 < W; ++c2) pv[c2] = __shfl_sync(0xffffffffu, reg[c2][c % R], lk);
      const T inv = T(1) / pv[c];
#pragma unroll
      for (int a = 0; a < R; ++a)
        if (r0 + a < nuf) Mult[kp * ldm + r0 + a] = reg[c][a];
      if (lane == 0) inv_s[kp] = inv;
#pragma unroll
      for (int c2 = c + 1; c2 < W; ++c2) {
        const T pj = pv[c2] * inv;
#pragma unroll
        for (int a = 0; a < R; ++a)
          reg[c2][a] = a == c % R && lane == lk ? pj : reg[c2][a] - reg[c][a] * pj;
      }
    }
    named_sync<BAR_TAKEN>(taken);
  }
}

// The chain rank's update warps (uw of nuw): once the chain's warp has
// taken panel p, its pivots first on panel p + 1 (two columns a warp), which
// then is ready for the chain, then on the square's columns from panel p + 2
// on (four a warp).
template <int R, int W, typename T>
__device__ __forceinline__ void gj_update_warps(T* S, int lds, int nuf, const T* Mult,
                                                int ldm, const T* inv_s, int uw, int nuw,
                                                int taken, int ready) {
  const int np = (nuf + W - 1) / W;
  for (int p = 0; p < np; ++p) {
    named_sync<BAR_TAKEN>(taken);
    if (p + 1 < np) {
      for (int j = W * (p + 1) + 2 * uw; j < W * (p + 2); j += 2 * nuw)
        gj_square_columns<R, W, 2>(S, lds, nuf, j, p, p + 1, Mult, ldm, inv_s);
      named_sync<BAR_READY>(ready);
    }
    for (int j = W * (p + 2) + 4 * uw; j < nuf; j += 4 * nuw)
      gj_square_columns<R, W, 4>(S, lds, nuf, j, p, p + 1, Mult, ldm, inv_s);
  }
}

// The chain rank's push warps (threads ut of un): once the chain's warp
// has taken panel p, its multipliers and reciprocals into the other ranks.
template <int W, typename T>
__device__ __forceinline__ void gj_push_warps(T* Mult, int ldm, T* inv_s, int nuf, int C,
                                              int ut, int un, int taken) {
  const int np = (nuf + W - 1) / W;
  for (int p = 0; p < np; ++p) {
    named_sync<BAR_TAKEN>(taken);
    const int k0 = W * p, nk = nuf - k0 < W ? nuf - k0 : W;
    const int nv = nk * ldm / (16 / (int)sizeof(T));  // ldm is a multiple of 32
    const float4* const src = reinterpret_cast<const float4*>(Mult + k0 * ldm);
    for (int rank = 0; rank < C; ++rank) {
      if (rank == CHAIN_RANK) continue;
      float4* const dst = reinterpret_cast<float4*>(at_rank(Mult, rank) + k0 * ldm);
      for (int e = ut; e < nv; e += un) dst[e] = src[e];
      if (ut < nk) at_rank(inv_s, rank)[k0 + ut] = inv_s[k0 + ut];
    }
  }
}

template <typename T>
__device__ __forceinline__ void symmetrize_blocks(const T* W, T* S, int n, int w) {
  for (int e = threadIdx.x; e < n * w * w; e += blockDim.x) {
    const int i = e / (w * w), a = e % (w * w) / w, b = e % w;
    S[e] = W[e] + W[(i * w + b) * w + a];
  }
}

// The prep of agents [i0, i1) at step t by threads ft of fn (whole warps),
// compiled for the slot width NXC_LO where the problem's slots fit it (K3's
// input source's choice).
template <int NXC_LO, typename T, typename P>
__device__ __forceinline__ void prep_rows(const P& pb, const CostTerms<T>& c, int t, int i0,
                                          int i1, T* lx, T* lu, T* At, T* Bt, T* Lblk,
                                          T* G, int ft, int fn) {
  if (c.nx <= NXC_LO)
    sweep_prep_rows<NXC_LO, T, P>(pb, c, t, i0, i1, lx, lu, At, Bt, Lblk, G, ft, fn);
  else
    sweep_prep_rows<MAX_NX, T, P>(pb, c, t, i0, i1, lx, lu, At, Bt, Lblk, G, ft, fn);
}

// What the phases of the cluster sweep need: the widths, this rank's rows
// and the offsets (values) of its buffers.  Each phase of a step runs as a
// function of its own (not inlined), its pointers derived from the CTA's
// shared memory and these offsets: each gets the registers it needs
// instead of sharing them with everything the sweep keeps alive across a
// step (which spilled to local memory, hence to L2 beside 219 KB of shared
// memory, in every phase).
struct ClusterCtx {
  int K, nx, nu, C, q, k0, nxf, nuf, mx, mu, x0, u0, ms, ldq, kq, ab;
  int P, AtP, Qxx, stage, Qux, QuuK, Quu, Qs, M, Kt, AB, Ld, Lu, Lblk, p, Qx, Qu, lx, lu,
      d, w;
};

// The CTA's dynamic shared memory (the kernel's extern array).
template <typename T>
__device__ __forceinline__ T* cluster_smem() {
  extern __shared__ __align__(16) unsigned char cluster_smem_raw[];
  return reinterpret_cast<T*>(cluster_smem_raw);
}

// Phase 3a: the pivot chain.  Every rank writes its rows of Q_uu into the
// chain rank's square and its rows of [Q_ux | Q_u] into the ranks that
// take their chunks (both in K, free until phase 4), and arrives at the
// cluster barrier; the other ranks compute their slots' inputs of the
// next step (`prep`, every thread) before they wait on it.  On the chain
// rank, once every row has landed, the chain's, update, push and prep
// warps below.  Ends with the cluster barrier after which every rank holds
// every multiplier and reciprocal (Mult in its P and A^T P, the
// reciprocals in its Q_s).
template <typename T, int R, int W, typename Prep>
__device__ __noinline__ void cluster_pivot_chain(const ClusterCtx& x, const Prep& prep) {
  static_assert(CLUSTER_THREADS == 384, "the chain rank's roles take twelve warps");
  // Warp 0 the chain, alone on its scheduler (a warp w issues on scheduler
  // w mod 4); warps 1-3 and 5-7 the updates; warps 4 and 8, which share
  // warp 0's scheduler, the pushes; warps 9-11 the prep.
  constexpr int UPDATE_WARPS = 6, PREP0 = 9 * 32;
  constexpr int TAKEN = 9 * 32, READY = 32 * (1 + UPDATE_WARPS);
  T* const sm = cluster_smem<T>();
  const int C = x.C, nxf = x.nxf, nuf = x.nuf, mu_ = x.mu, u0 = x.u0;
  const int lds = nuf + 1, ldm = chain_ldm(nuf), ldb = rhs_ld(nxf), ldc = rhs_cols(nxf, C),
            nch = rhs_chunks(nxf);
  const int tid = threadIdx.x, nth = blockDim.x;
  T* const S = sm + x.Kt;
  T* const CB = S + pad4((size_t)nuf * lds);
  T* const Mult = sm + x.P;
  T* const inv_s = sm + x.Qs;
  {
    const T* const Quu = sm + x.Quu;
    T* const dst = at_rank(S, CHAIN_RANK) + (size_t)u0 * lds;
    for (int e = tid; e < mu_ * nuf; e += nth) {
      const int r = e / nuf;
      dst[r * lds + e - r * nuf] = Quu[e];
    }
    const T* const M = sm + x.M;
    for (int e = tid; e < mu_ * nch; e += nth) {
      const int r = e / nch, ch = e - r * nch, o = cluster_owner(ch, nch, C);
      T v[4];
      load_vec<4>(M + r * ldb + 4 * ch, v);
      store_row<4>(at_rank(CB, o) + (u0 + r) * ldc + 4 * (ch - cluster_slot0(o, nch, C)), 4,
                   true, v);
    }
  }
  cluster_arrive();
  if (x.q != CHAIN_RANK) {
    prep(tid, nth);
    cluster_wait();
    cluster_sync();  // the multipliers and reciprocals have landed
    return;
  }
  cluster_wait();  // the square has landed
  const int wrp = tid >> 5;
  if (wrp == 0)
    gj_chain_warp<R, W>(S, lds, nuf, Mult, ldm, inv_s, TAKEN, READY);
  else if (wrp < 8 && wrp != 4)
    gj_update_warps<R, W>(S, lds, nuf, Mult, ldm, inv_s, wrp - 1 - (wrp > 4), UPDATE_WARPS,
                          TAKEN, READY);
  else if (wrp == 4 || wrp == 8)
    gj_push_warps<W>(Mult, ldm, inv_s, nuf, C, tid & 31 | (wrp == 8) << 5, 64, TAKEN);
  else if (tid >= PREP0)
    prep(tid - PREP0, nth - PREP0);
  __syncthreads();
  cluster_sync();  // the multipliers and reciprocals have landed
}

// Phase 3b: the right-hand pass.  Rank q takes chunks [q n / C, (q + 1) n
// / C) of the n chunks of [Q_ux | Q_u], a chunk of four columns a warp,
// every row in registers (from this rank's copy in K), through every pivot
// (the multipliers and reciprocals in its P and Q_s), and back to the rows'
// owners; then the cluster barrier after which each rank's rows of M hold
// its rows of X and x, the solution.
template <typename T, int R, int W>
__device__ __noinline__ void cluster_right_pass(const ClusterCtx& x) {
  T* const sm = cluster_smem<T>();
  const int K = x.K, nu = x.nu, C = x.C, q = x.q, nxf = x.nxf, nuf = x.nuf;
  const int ldm = chain_ldm(nuf), ldb = rhs_ld(nxf), ldc = rhs_cols(nxf, C),
            nch = rhs_chunks(nxf), np = (nuf + W - 1) / W;
  const int lane = threadIdx.x & 31, wrp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int r0 = R * lane, ch0 = cluster_slot0(q, nch, C), ch1 = cluster_slot0(q + 1, nch, C);
  const T* const CB = sm + x.Kt + pad4((size_t)nuf * (nuf + 1));
  const T* const Mult = sm + x.P;
  const T* const inv_s = sm + x.Qs;
  T* const M = sm + x.M;
  T* dst[R];  // this lane's rows in their owners' M
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = r0 + a < nuf ? r0 + a : nuf - 1, o = cluster_owner(row / nu, K, C);
    dst[a] = at_rank(M, o) + (row - cluster_slot0(o, K, C) * nu) * ldb;
  }
  for (int ch = ch0 + wrp; ch < ch1; ch += nw) {
    T col[4][R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      T v[4] = {T(0), T(0), T(0), T(0)};
      if (r0 + a < nuf) load_vec<4>(CB + (r0 + a) * ldc + 4 * (ch - ch0), v);
#pragma unroll
      for (int b = 0; b < 4; ++b) col[b][a] = v[b];
    }
    gj_warp_columns<R, W, 4>(col, 0, np, nuf, Mult, ldm, inv_s);
#pragma unroll
    for (int a = 0; a < R; ++a)
      if (r0 + a < nuf) {
        const T v[4] = {col[0][a], col[1][a], col[2][a], col[3][a]};
        store_row<4>(dst[a] + 4 * ch, 4, true, v);
      }
  }
  cluster_sync();  // every rank's rows of the solution
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

// Phase 2 of step t on the own rows: Q_xx, Q_ux, Q_uu and the right-hand
// sides [Q_ux | Q_u] (M).
template <typename T>
__device__ __noinline__ void cluster_phase2(const ClusterCtx& x, int t) {
  T* const sm = cluster_smem<T>();
  const int K = x.K, nx = x.nx, nu = x.nu, nxf = x.nxf, nuf = x.nuf, ldb = rhs_ld(nxf),
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
            M[(r0 + i) * ldb + col] = acc[i];
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
            Quu[(r0 + i) * nuf + col] = acc[i] + luu_entry(u0 + r0 + i, col, nu, Lu);
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
              M[(r0 + i) * ldb + col] = acc[i];
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
              Quu[(r0 + i) * nuf + col] = acc[i] + luu_entry(u0 + r0 + i, col, nu, Lu);
            }
        }
      }
  }
  }
  const T* const Qu = sm + x.Qu;
  for (int i = threadIdx.x; i < mu_; i += blockDim.x) M[i * ldb + nxf] = Qu[i];
  __syncthreads();
}

// Phase 4 of step t: the own rows' gains K = -X, d = -x (a step's block is
// contiguous) into Kg, dg and into K and d whole; then the cluster barrier
// after which the other ranks read them.
template <typename T>
__device__ __noinline__ void cluster_gains(const ClusterCtx& x, int t, T* Kg, T* dg) {
  T* const sm = cluster_smem<T>();
  const int nxf = x.nxf, nuf = x.nuf, ldb = rhs_ld(nxf), mu_ = x.mu, u0 = x.u0;
  const int tid = threadIdx.x, nth = blockDim.x;
  const T* const M = sm + x.M;
  T* const Kt = sm + x.Kt + (size_t)u0 * nxf;
  T* const d = sm + x.d;
  T* const Kg_t = Kg + (size_t)t * nuf * nxf + (size_t)u0 * nxf;
  for (int e = tid; e < mu_ * nxf; e += nth) {
    const int r = e / nxf, col = e - r * nxf;
    const T kval = -M[r * ldb + col];
    Kt[e] = kval;
    Kg_t[e] = kval;
  }
  for (int r = tid; r < mu_; r += nth) {
    const T dval = -M[r * ldb + nxf];
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
  const ClusterCtx ctx = {K, nx, nu, C, q, k0, nxf, nuf, mx, (k1 - k0) * nu, x0, k0 * nu,
                          L.ms, L.ldq, kq, ab, (int)L.P, (int)L.AtP, (int)L.Qxx,
                          (int)L.stage, (int)L.Qux, (int)L.QuuK, (int)L.Quu, (int)L.Qs,
                          (int)L.M, (int)L.Kt, (int)L.AB, (int)L.Ld, (int)L.Lu,
                          (int)L.Lblk, (int)L.p, (int)L.Qx, (int)L.Qu, (int)L.lx, (int)L.lu,
                          (int)L.d, (int)L.w};
  T* const QQ = sm + L.QQ;
  T* const RR = sm + L.RR;
  T* const Ld = sm + L.Ld;
  T* const Lu = sm + L.Lu;
  T* const Lblk = sm + L.Lblk;
  T* const G = sm + L.G;
  const CostTerms<T> c = {pb.xf, QQ, RR, pb.mask, pb.npos, pb.refw, pb.radius, pb.pw,
                          K, nx, nu, kq};
  // The own slots' inputs of step s (A_s, B_s into that step's half of AB)
  // by threads ft of fn.
  auto prep_step = [&](int s, int ft, int fn) {
    T* const As = sm + L.AB + (s & 1) * ab;
    prep_rows<NXC_LO>(pb, c, s, k0, k1, sm + L.lx, sm + L.lu, As,
                      As + pad4((size_t)K * nx * nx), Lblk, G, ft, fn);
  };

  // The terminal step's P and p (ComputedInputs::init, own rows), then the
  // stage blocks, then step N-1's inputs of the own slots.
  symmetrize_blocks(pb.Qf, QQ, K, nx);
  symmetrize_blocks(pb.R, RR, K, nu);
  __syncthreads();
  constant_blocks(c, Ld, Lu, tid, nth);
  prep_rows<NXC_LO>(pb, c, N, k0, k1, sm + L.p, (T*)nullptr, (T*)nullptr, (T*)nullptr,
                    Lblk, G, tid, nth);
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
  if (N > 0) prep_step(N - 1, tid, nth);
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
    // The elimination: the pivot chain, beside it the own slots' inputs of
    // the next step; then the right-hand columns.
    auto prep = [&](int ft, int fn) {
      if (t > 0) prep_step(t - 1, ft, fn);
    };
    // Panels of 12 pivots (16 where a lane holds 4 rows), a multiple of
    // the rows R a lane holds.
    if (nuf > 96) {
      cluster_pivot_chain<T, 4, 16>(ctx, prep);
      RICCATI_CLOCK(3)
      cluster_right_pass<T, 4, 16>(ctx);
    } else if (nuf > 64) {
      cluster_pivot_chain<T, 3, 12>(ctx, prep);
      RICCATI_CLOCK(3)
      cluster_right_pass<T, 3, 12>(ctx);
    } else if (nuf > 32) {
      cluster_pivot_chain<T, 2, 12>(ctx, prep);
      RICCATI_CLOCK(3)
      cluster_right_pass<T, 2, 12>(ctx);
    } else {
      cluster_pivot_chain<T, 1, 12>(ctx, prep);
      RICCATI_CLOCK(3)
      cluster_right_pass<T, 1, 12>(ctx);
    }
    RICCATI_CLOCK(8)
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
