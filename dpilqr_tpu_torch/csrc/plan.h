// Where the kernels place their working sets: the shared-memory plan of the
// backward kernels (K1, K3, K5: riccati_plan, computed_plan, and K3's
// cluster tier, wide_plan) and of the forward kernels (K2, K4:
// column_launch).  Plain integer arithmetic with no CUDA include, defined
// once for two builds: nvcc compiles it into the kernels, which plan each
// launch with the device's opt-in limit (launch.cuh max_shared_optin), and
// a host C++ compiler compiles it into the small library that the Python
// side reads every plan from (plan.cpp, ops/cuda_build.py riccati_plan and
// forward_plan).

#pragma once

#include <cstddef>

#ifndef DPILQR_HD
#ifdef __CUDACC__
#define DPILQR_HD __host__ __device__
#else
#define DPILQR_HD
#endif
#endif

namespace {

// n rounded up to a multiple of 4 values: every buffer carved from a
// 16-byte aligned base then starts 16-byte aligned in float32 (32 in
// float64), which the vector loads and the 16-byte async copies need.
DPILQR_HD inline size_t pad4(size_t n) { return (n + 3) / 4 * 4; }

// ---------------------------------------------------------------------------
// The Riccati working set of one problem (riccati.cuh): a value, a gain and
// a vector group, each carved from its own base pointer.
// ---------------------------------------------------------------------------

struct RiccatiSizes {
  size_t value, gain, vec;  // values per group
};

// The two pivot rows and two pivot columns of the Gauss-Jordan solve are
// padded to whole warps, so that the register path reads its row unguarded.
DPILQR_HD inline size_t pad32(size_t n) { return (n + 31) / 32 * 32; }

DPILQR_HD inline RiccatiSizes riccati_sizes(int K, int nx, int nu) {
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu, ncol = nuf + nxf + 1;
  return {3 * pad4(nxf * nxf),
          4 * pad4(nuf * nxf) + pad4(nuf * nuf) + pad4(nuf * ncol) +
              pad4((size_t)K * nx * nx) + pad4((size_t)K * nx * nu),
          3 * pad4(nxf) + 4 * pad4(nuf) + 2 * pad32(ncol) + 2 * pad32(nuf)};
}

// Where the groups of one problem live.  tier 0: all in shared memory;
// 1: the value group in the workspace; 2: the value and gain groups in the
// workspace; 3 (K3 alone, riccati_cluster.cuh): all of it in the shared
// memory of a cluster of `cluster` CTAs; -1: not even the vectors fit.
// `smem` (of a CTA) and `work` are values.
struct RiccatiPlan {
  int tier;
  size_t smem, work;
  int cluster = 1;
};

// `extra`: values a kernel adds to the gain group for itself (the input
// source's buffers, computed_plan).
inline RiccatiPlan riccati_plan(int K, int nx, int nu, size_t itemsize,
                                long long optin, size_t extra = 0) {
  RiccatiSizes z = riccati_sizes(K, nx, nu);
  z.gain += extra;
  const size_t room = optin < 0 ? 0 : (size_t)optin / itemsize;
  if (z.value + z.gain + z.vec <= room) return {0, z.value + z.gain + z.vec, 0};
  if (z.gain + z.vec <= room) return {1, z.gain + z.vec, z.value};
  if (z.vec <= room) return {2, z.vec, z.value + z.gain};
  return {-1, 0, 0};
}

// The buffers the input source (computed_inputs.cuh) adds to the Riccati
// working set (riccati_plan's `extra`, after the gain group): per agent
// QQ = Q + Q^T (Qf + Qf^T until the terminal step is done), RR = R + R^T,
// Ld = w QQ and Lu = w RR + 2 (1 - m) I (derivatives.cuh constant_blocks),
// and one step's proximity blocks Lblk (n, n, k, k) and pair gradient terms
// G (n, n, 3).
DPILQR_HD inline size_t sweep_extra_values(int n, int nx, int nu) {
  const size_t k = nx < 3 ? nx : 3;
  return 2 * pad4((size_t)n * nx * nx) + 2 * pad4((size_t)n * nu * nu) +
         pad4((size_t)n * n * k * k) + pad4((size_t)n * n * 3);
}

// Where a backward kernel's working set goes under `optin` bytes of shared
// memory a block: riccati_plan with the source's buffers in the gain group.
inline RiccatiPlan computed_plan(int n, int nx, int nu, size_t itemsize,
                                 long long optin) {
  return riccati_plan(n, nx, nu, itemsize, optin, sweep_extra_values(n, nx, nu));
}

// Tableau columns a lane holds in the register path of the Gauss-Jordan
// solve (riccati.cuh gauss_jordan): it eliminates tableaus of up to
// 32 GJ_COLS columns in registers.
constexpr int GJ_COLS = 5;

// ---------------------------------------------------------------------------
// K3's cluster tier (riccati_cluster.cuh).
// ---------------------------------------------------------------------------

// The portable cluster size; the control rows one CTA of a cluster holds at
// most (so nuf <= 128: a warp of the elimination holds every row of Q_uu,
// four a lane).
constexpr int CLUSTER_MAX = 8, CLUSTER_MU = 16;

// The row stride of the elimination's multipliers: 32 R values, R =
// ceil(nuf / 32) the rows a lane holds.
DPILQR_HD inline int chain_ldm(int nuf) { return (nuf + 31) / 32 * 32; }
// The right-hand sides [Q_ux | Q_u] in chunks of four columns: a row's
// stride, the chunks, and the columns a rank takes at most (its chunks are
// cluster_slot0 of the chunk count).
DPILQR_HD inline int rhs_ld(int nxf) { return (nxf + 4) / 4 * 4; }
DPILQR_HD inline int rhs_chunks(int nxf) { return (nxf + 4) / 4; }
DPILQR_HD inline int rhs_cols(int nxf, int C) {
  return 4 * ((rhs_chunks(nxf) + C - 1) / C);
}

// Offsets (values) of one CTA's buffers under the cluster tier; every CTA of
// the cluster has the same layout, sized for the largest share of slots
// (ms), so that a buffer lies at the same offset in every rank.
struct ClusterLayout {
  size_t P, AtP, Qxx, stage, Qux, QuuK, Quu, Qs, M, Kt, AB, QQ, RR, Ld, Lu, Lblk, G;
  size_t p, Qx, Qu, lx, lu, d, w, total;
  int ms, ldq;
};

DPILQR_HD inline ClusterLayout cluster_layout(int K, int nx, int nu, int C) {
  ClusterLayout L;
  const int ms = (K + C - 1) / C, k = nx < 3 ? nx : 3;
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu;
  const size_t mx = (size_t)ms * nx, mu = (size_t)ms * nu;
  // In the elimination: the multipliers (nuf x chain_ldm) in P and A^T P;
  // in K, the chain rank's copy of Q_uu (nuf x (nuf + 1)) and, after it,
  // every rank's right-hand columns (nuf x rhs_cols).
  const size_t mult = nuf * (size_t)chain_ldm((int)nuf);
  const size_t elim = pad4(nuf * (nuf + 1)) + nuf * (size_t)rhs_cols((int)nxf, C);
  L.ms = ms;
  L.ldq = (int)pad4(mu);
  size_t o = 0;
  L.P = o;     o += pad4(mx * nxf);
  // A^T P in phases 1 and 2; with P before it, the multipliers in the
  // elimination.
  const size_t after_p = mult > pad4(mx * nxf) ? mult - pad4(mx * nxf) : 0;
  L.AtP = o;   o += pad4(mx * nxf > after_p ? mx * nxf : after_p);
  L.Qxx = o;   o += pad4(mx * nxf);
  // W1 in phases 1 and 2; a rank's rows of Q_ux and Q_uu K in the update.
  L.stage = o; o += 2 * pad4(mu * nxf);
  L.Qux = o;   o += pad4(mu * nxf);
  L.QuuK = o;  o += pad4(mu * nxf);
  L.Quu = o;   o += pad4(mu * nuf);
  // Q_uu's columns of the own rows; the pivots' reciprocals in the
  // elimination.
  L.Qs = o;    o += pad4(nuf * L.ldq);
  L.M = o;     o += pad4(mu * rhs_ld((int)nxf));  // the own rows of [Q_ux | Q_u]
  L.Kt = o;    o += pad4(nuf * nxf > elim ? nuf * nxf : elim);  // K whole
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
inline RiccatiPlan wide_plan(int K, int nx, int nu, size_t itemsize, long long optin,
                             int max_cluster) {
  const RiccatiPlan plan = computed_plan(K, nx, nu, itemsize, optin);
  if (plan.tier != 2 || max_cluster < 2 || K * (nx + nu) + 1 <= 32 * GJ_COLS) return plan;
  const int C = cluster_ctas(K, nx, nu, itemsize, optin, max_cluster);
  if (C == 0) return plan;
  RiccatiPlan out{3, cluster_layout(K, nx, nu, C).total, 0};
  out.cluster = C;
  return out;
}

// ---------------------------------------------------------------------------
// The forward kernels' columns (rollout.cuh).
// ---------------------------------------------------------------------------

// The most warps (alphas) a CTA of the forward kernels takes.
constexpr int WARPS_PER_CTA = 8;

// The values of a step's rows beside its gains (d row, nominal U row,
// nominal X row), of a tile of `rows` gain rows, and of one column's x, dx,
// u.
DPILQR_HD inline size_t row_values(int nxf, int nuf) {
  return 2 * pad4(nuf) + pad4(nxf);
}
DPILQR_HD inline size_t tile_values(int rows, int nxf) {
  return pad4((size_t)rows * nxf);
}
DPILQR_HD inline size_t column_values(int nxf, int nuf) {
  return 2 * pad4(nxf) + pad4(nuf);
}

// How n_alpha columns of one problem are laid over CTAs: `chunks` CTAs of
// `warps` warps each; with gains `n_buf` buffers (2 or 1) of a tile of
// `rows` gain rows and a step's rows; `bytes` of dynamic shared memory in
// all.  n_buf 0 where nothing fits `optin` bytes.
struct ColumnLaunch {
  int chunks, warps, n_buf, rows;
  size_t bytes;
};

// The placement, in order of preference: a whole block a buffer (two, then
// one); tiles of as many rows as fit, a multiple of 4 (two buffers, then
// one), evened out over the block; then the same with fewer warps a CTA.
// `max_rows` > 0 forces tiles of at most that many rows (rounded down to a
// multiple of 4, at least 4) where it is below nuf: the tests and the smoke
// hold the tiled walk to the staged one's bits with it.
inline ColumnLaunch column_launch(int nxf, int nuf, int n_alpha, bool gains,
                                  size_t itemsize, long long optin,
                                  int max_rows = 0) {
  if (optin < 0 || n_alpha < 1) return {0, 0, 0, 0, 0};
  const size_t room = (size_t)optin / itemsize;
  const size_t col = column_values(nxf, nuf), rowv = row_values(nxf, nuf);
  const bool whole = max_rows <= 0 || max_rows >= nuf;
  const int cap_rows = whole ? nuf : (max_rows < 4 ? 4 : max_rows / 4 * 4);
  for (int cap = WARPS_PER_CTA; cap >= 1; --cap) {
    const int chunks = (n_alpha + cap - 1) / cap;
    const int warps = (n_alpha + chunks - 1) / chunks;
    const size_t cols = warps * col;
    if (cols > room) continue;
    if (!gains) return {chunks, warps, 1, 0, cols * itemsize};
    for (int nb = 2; whole && nb >= 1; --nb) {
      const size_t v = cols + nb * (tile_values(nuf, nxf) + rowv);
      if (v <= room) return {chunks, warps, nb, nuf, v * itemsize};
    }
    for (int nb = 2; nb >= 1; --nb) {
      if (cols + nb * (tile_values(4, nxf) + rowv) > room) continue;
      const size_t per = ((room - cols) / nb - rowv) / 4 * 4;
      size_t fit = per / nxf;
      if (fit > (size_t)cap_rows) fit = cap_rows;
      const int rmax = (int)(fit / 4 * 4);
      const int n_tiles = (nuf + rmax - 1) / rmax;
      const int rows = (int)pad4((nuf + n_tiles - 1) / n_tiles);
      return {chunks, warps, nb, rows,
              (cols + nb * (tile_values(rows, nxf) + rowv)) * itemsize};
    }
  }
  return {0, 0, 0, 0, 0};
}

}  // namespace
