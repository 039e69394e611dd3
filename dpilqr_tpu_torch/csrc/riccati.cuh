// The Riccati backward recursion of one iLQR problem, run by one CTA: the
// algebra shared by the three backward kernels (backward_batched.cu,
// backward_batched_wide.cu, backward_sweep.cu).
//
// For every step t = N-1 .. 0 it builds Q_x, Q_u, Q_xx, Q_ux, Q_uu from the
// block-diagonal dynamics (K slots of nx states and nu controls; Tassa
// regularization P + mu I on the B sandwiches only), solves
// Q_uu [K | d] = [Q_ux | Q_u] by Gauss-Jordan WITHOUT pivoting, and applies
// the full-form value update with symmetrization (reference
// dpilqr/control.py:116-148).  The arithmetic order follows the Pallas kernel
// dpilqr_tpu/ops/pallas_batched.py :: backward_pass_batched: every dot
// product accumulates over the same index in the same order, pivots multiply
// by a reciprocal, the update is the full form, Q_ux^T K is the transpose of
// K^T Q_ux.  Float32 convergence depends on that order, so the design below
// changes which thread computes an entry and never how it is computed: every
// dot product is round(a0 b0) followed by fused multiply-adds in index order
// (mul_rn pins the first product), so all three kernels, in every
// instantiation, give the same bits on the same problem.
//
// What the design does about the latency chain (N steps x phases x pivots):
//
// - register tiles: in the three nuf-deep products (Q_uu K, K^T Q_ux,
//   K^T Q_uu K) a thread owns a TILE x TILE block of the output, so each
//   operand row segment, read with one vector load, feeds TILE FMAs; the
//   block-diagonal products of phases 1 and 2 run in strips of four.  TILE
//   is 4 for wide problems and 2 for narrow ones, where 4 x 4 tiles would
//   leave most of the CTA without a tile;
// - the Gauss-Jordan takes one barrier per pivot: every tableau entry has
//   one owning thread for the whole elimination, the owners publish the
//   pivot row (already scaled by the pivot's reciprocal) into one of two
//   small buffers, and after the barrier each thread updates the entries it
//   owns.  Where the tableau fits (up to 160 columns) it lives in registers
//   for the whole elimination, four rows by five columns a thread, on as
//   many warps as that takes, with the pivot loops unrolled so that every
//   register index is a constant; larger tableaus are eliminated in place
//   in shared memory.  Columns left of the pivot (and the pivot's own) never
//   feed the solution columns again, so what they hold does not matter, and
//   the solution is the same to the bit (gauss_jordan below).  A narrow
//   problem (nuf <= 32) is eliminated by one warp with no barrier at all,
//   each lane holding whole columns, and that warp writes the gains out
//   itself while the others fetch the next step's inputs
//   (gauss_jordan_warp);
// - seven CTA barriers a step (six where one warp eliminates): a step's
//   inputs have landed before the barrier that ends the step before, so a
//   step starts without one of its own;
// - where a kernel compiles the slot widths nx, nu (and the slot count K)
//   in, the index divisions and the loops over a block cost nothing on the
//   chain: at nxf 32 they were more than half of phases 1 and 2
//   (riccati_sweep_from's NXS, NUS, KS);
// - the transposed reads of the value update (K^T Q_ux's transpose, the
//   symmetrization) go tile by tile, a row segment per load, instead of one
//   column-strided value per thread (a 32-way bank conflict at nxf 32, 96);
// - the gains leave coalesced: a step's block is contiguous in memory;
// - no phase waits for device memory: the sweep's input source
//   (computed_inputs.cuh, for all three kernels) computes a step's inputs
//   into the working set, the next step's on the warps the elimination
//   leaves idle, and phase 2 reads each entry of L_xx and L_uu from their
//   blocks where it adds it.
//
// Working memory comes in three groups, each carved from its own base
// pointer, so a kernel can place each group in shared or in device memory
// (riccati_place, by a template argument); every buffer starts at a multiple
// of four values, so that row segments can be read as vectors:
//   value: P, A^T P (later K^T Q_ux), Q_xx (later the unsymmetrized P),
//          3 nxf^2 values;
//   gain:  B^T (P + mu I), Q_ux, K, Q_uu K, Q_uu, the Gauss-Jordan tableau
//          [Q_uu | Q_ux | Q_u], A_t, B_t;
//   vec:   p, Q_x, Q_u, d, w, the staged L_x and L_u rows, two pivot rows
//          and two pivot columns.
// riccati_plan (plan.h) places them: all in shared memory where that fits,
// else the value group in a device-memory workspace, else the gain group too.
//
// A step's inputs, as the source leaves them in the working set: A_t (K, nx,
// nx), B_t (K, nx, nu), the L_x and L_u rows; L_xx and L_uu entries on
// request (lxx, luu) -> Kg (N, nuf, nxf), d (N, nuf) of this problem.

#pragma once

#include <cuda_runtime.h>

#include "launch.cuh"
#include "plan.h"

namespace {

// The register tile of the nuf-deep products: 4 x 4 where that still gives
// every thread of a 256-thread CTA a tile of the nxf^2 outputs (and for
// every problem that needs the workspace), else 2 x 2.
inline int riccati_tile(int nxf, int tier) {
  const int n4 = (nxf + 3) / 4;
  return tier > 0 || n4 * n4 >= 256 ? 4 : 2;
}

// Threads for one problem: a thread per tile of the nxf^2 outputs, in whole
// warps, within [lo, hi].
inline int riccati_threads(int nxf, int tile, int lo, int hi) {
  const int n = (nxf + tile - 1) / tile;
  const int threads = (n * n + 31) / 32 * 32;
  return threads < lo ? lo : threads > hi ? hi : threads;
}

template <typename T>
struct RiccatiWork {
  T *P, *AtP, *Qxx;
  T *W1, *Qux, *Kt, *QuuK, *Quu, *M, *At, *Bt;
  T *p, *Qx, *Qu, *dt, *w, *lx, *lu, *prow, *colv;
};

template <typename T>
__device__ __forceinline__ RiccatiWork<T> riccati_carve(T* value, T* gain, T* vec, int K,
                                        int nx, int nu) {
  const size_t nxf = (size_t)K * nx, nuf = (size_t)K * nu, ncol = nuf + nxf + 1;
  RiccatiWork<T> ws;
  ws.P = value;    value += pad4(nxf * nxf);
  ws.AtP = value;  value += pad4(nxf * nxf);
  ws.Qxx = value;
  ws.W1 = gain;    gain += pad4(nuf * nxf);
  ws.Qux = gain;   gain += pad4(nuf * nxf);
  ws.Kt = gain;    gain += pad4(nuf * nxf);
  ws.QuuK = gain;  gain += pad4(nuf * nxf);
  ws.Quu = gain;   gain += pad4(nuf * nuf);
  ws.M = gain;     gain += pad4(nuf * ncol);
  ws.At = gain;    gain += pad4((size_t)K * nx * nx);
  ws.Bt = gain;
  ws.p = vec;      vec += pad4(nxf);
  ws.Qx = vec;     vec += pad4(nxf);
  ws.Qu = vec;     vec += pad4(nuf);
  ws.dt = vec;     vec += pad4(nuf);
  ws.w = vec;      vec += pad4(nuf);
  ws.lx = vec;     vec += pad4(nxf);  // the step's L_x and L_u rows, staged
  ws.lu = vec;     vec += pad4(nuf);
  ws.prow = vec;   vec += 2 * pad32(ncol);  // two pivot rows
  ws.colv = vec;                           // two pivot columns
  return ws;
}

// The groups of one problem under a plan's tier: `sm` is the CTA's dynamic
// shared memory, `own` the problem's part of the workspace.  The tier is a
// template argument so that every pointer into shared memory is derived
// from `sm` alone: the compiler then emits shared-memory loads and stores
// (LDS, STS) for it.  A pointer chosen at run time between `sm` and `own`
// is generic, and a generic load costs several times an LDS's latency on
// every link of the recursion's dependent chain.
// `extra` values (riccati_plan) follow the gain group's own; *extra_at
// (where given) points at them.
template <int TIER, typename T>
__device__ __forceinline__ RiccatiWork<T> riccati_place(T* sm, T* own, int K,
                                                        int nx, int nu,
                                                        size_t extra = 0,
                                                        T** extra_at = nullptr) {
  const RiccatiSizes z = riccati_sizes(K, nx, nu);
  T* gain = TIER == 0 ? sm + z.value : TIER == 1 ? sm : own + z.value;
  if (extra_at != nullptr) *extra_at = gain + z.gain;
  if constexpr (TIER == 0)
    return riccati_carve(sm, sm + z.value, sm + z.value + z.gain + extra, K, nx, nu);
  else if constexpr (TIER == 1)
    return riccati_carve(own, sm, sm + z.gain + extra, K, nx, nu);
  else
    return riccati_carve(own, own + z.value, sm, K, nx, nu);
}

// a b rounded once, never fused into a following addition.  Every dot
// product below starts with it, so that the sum is round(a0 b0) followed by
// fused multiply-adds in index order in every instantiation: left to the
// compiler, an unrolled chain (compile-time widths) may fuse the first
// product into the second instead, and the bits would differ between the
// kernels that share this header.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// W consecutive values at p as one vector load (two in float64 at W = 4);
// p is aligned for it.
template <int W, typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[W]) {
  static_assert(W == 2 || W == 4, "row segments are 2 or 4 values");
  if constexpr (sizeof(T) == 4 && W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (sizeof(T) == 4 && W == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else if constexpr (W == 2) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    const double2 q0 = *reinterpret_cast<const double2*>(p);
    const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
    v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
  }
}

// W consecutive values from p: one vector load where `vec` says that p is
// aligned for it and all W are in range, else the first `nvalid` one by one
// and zeros after them.
template <int W, typename T>
__device__ __forceinline__ void load_row(const T* p, int nvalid, bool vec,
                                         T (&v)[W]) {
  if (vec) {
    load_vec<W>(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = i < nvalid ? p[i] : T(0);
  }
}

template <int W, typename T>
__device__ __forceinline__ void store_row(T* p, int nvalid, bool vec,
                                          const T (&v)[W]) {
  if (vec) {
    if constexpr (sizeof(T) == 4 && W == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (sizeof(T) == 4 && W == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else if constexpr (W == 2) {
      *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    } else {
      *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
      *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i < nvalid) p[i] = v[i];
  }
}

// acc[i][j] = sum_v L[v][r0 + i] R[v][c0 + j], v ascending from 0 (the first
// product starts the sum), for L (nv, m) and R (nv, n) with row strides ldl
// and ldr.  Entries past m or n come out as sums of zeros.  Full, aligned
// tiles take a loop of vector loads with no branch in it.
template <int TILE, typename T>
__device__ __forceinline__ void atb_tile(const T* L, int ldl, int m, const T* R,
                                         int ldr, int n, int nv, int r0, int c0,
                                         T (&acc)[TILE][TILE]) {
  const bool vl = ldl % TILE == 0 && r0 + TILE <= m;
  const bool vr = ldr % TILE == 0 && c0 + TILE <= n;
  const T* lp = L + r0;
  const T* rp = R + c0;
  T a[TILE], b[TILE];
  load_row<TILE>(lp, m - r0, vl, a);
  load_row<TILE>(rp, n - c0, vr, b);
#pragma unroll
  for (int i = 0; i < TILE; ++i)
#pragma unroll
    for (int j = 0; j < TILE; ++j) acc[i][j] = mul_rn(a[i], b[j]);
  if (vl && vr) {
#pragma unroll 4
    for (int v = 1; v < nv; ++v) {
      lp += ldl;
      rp += ldr;
      load_vec<TILE>(lp, a);
      load_vec<TILE>(rp, b);
#pragma unroll
      for (int i = 0; i < TILE; ++i)
#pragma unroll
        for (int j = 0; j < TILE; ++j) acc[i][j] = acc[i][j] + a[i] * b[j];
    }
  } else {
    for (int v = 1; v < nv; ++v) {
      lp += ldl;
      rp += ldr;
      load_row<TILE>(lp, m - r0, vl, a);
      load_row<TILE>(rp, n - c0, vr, b);
#pragma unroll
      for (int i = 0; i < TILE; ++i)
#pragma unroll
        for (int j = 0; j < TILE; ++j) acc[i][j] = acc[i][j] + a[i] * b[j];
    }
  }
}

// The CTA's threads as nxt columns by nyt rows for a phase whose outputs
// have `ncols` columns: thread (tx, ty) walks columns tx, tx + nxt, ... and
// rows ty, ty + nyt, ..., so no entry costs an integer division.  Threads
// past nxt * nyt sit the phase out.
struct Grid2 {
  int tx, ty, nxt, nyt;
  bool on;
};

__device__ __forceinline__ Grid2 grid2(int ncols) {
  const int nth = blockDim.x, nxt = ncols < nth ? ncols : nth, nyt = nth / nxt;
  const int ty = threadIdx.x / nxt;
  return {(int)threadIdx.x - ty * nxt, ty, nxt, nyt, ty < nyt};
}

// Strips of one row by four columns of a product with a block-diagonal LEFT
// factor: out[r][c] = sum_b Blk[k][b][j] (P[k nx + b][c] (+ mu on the
// diagonal when REG)) for row r = k w + j, b ascending from 0; Blk holds K
// blocks of nx x w, out has K w rows.  P's rows are rows row0 .. of the
// whole P (a CTA of the cluster tier holds its own slots' rows alone).
template <bool REG, typename T>
__device__ __forceinline__ void bd_left(const T* Blk, int w, int nrows,
                                        const T* P, T mu, T* out, int nx,
                                        int nxf, int row0 = 0) {
  const int nx4 = (nxf + 3) / 4;
  const bool vec4 = nxf % 4 == 0;
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
        load_row<4>(prow + b * nxf, nxf - c0, vec4, pv);
        const T a = blk[b * w];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T preg = REG ? pv[i] + (row0 + k * nx + b == c0 + i ? mu : T(0)) : pv[i];
          const T term = a * preg;
          acc[i] = b == 0 ? term : acc[i] + term;
        }
      }
      store_row<4>(out + r * nxf + c0, nxf - c0, vec4, acc);
      k += dk;
      j += dj;
      if (j >= w) {
        j -= w;
        ++k;
      }
    }
  }
}

// acc[i] = sum_b In[r0 + i][kc nx + b] Blk[kc][b][jc], b ascending from 0,
// for column c = kc w + jc of a product with a block-diagonal RIGHT factor
// (K blocks of nx x w): four rows of one column.
template <typename T>
__device__ __forceinline__ void bd_right(const T* In, int ldin, int nrows,
                                         const T* Blk, int w, int nx, int r0,
                                         int kc, int jc, T (&acc)[4]) {
  const T* in = In + r0 * ldin + kc * nx;
  const T* blk = Blk + kc * nx * w + jc;
  const T a0 = blk[0];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i] = r0 + i < nrows ? mul_rn(in[i * ldin], a0) : T(0);
  for (int b = 1; b < nx; ++b) {
    const T a = blk[b * w];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < nrows) acc[i] = acc[i] + in[i * ldin + b] * a;
  }
}

// Rows and columns of the Gauss-Jordan tableau a thread keeps in registers:
// the elimination runs on ceil(nuf / GJ_ROWS) warps, entry (r, j) on warp
// r / GJ_ROWS, lane j mod 32, for tableaus of up to 32 GJ_COLS columns;
// larger ones are eliminated in place by the whole CTA (entry (r, j) on
// warp r mod warps).
constexpr int GJ_ROWS = 4;  // GJ_COLS: plan.h

// Gauss-Jordan without pivoting on the nuf x ncol tableau M = [Quu | Qux |
// Qu], one barrier per pivot.  Every entry has one owning thread for the
// whole elimination.  Per pivot the owners publish the pivot row, scaled by
// the reciprocal of the pivot, and the pivot column into one of two
// buffers (the register path takes its pivot column by warp shuffle
// instead); after the barrier each thread updates what it owns:
// M[r][j] -= M[r][kp] (M[kp][j] (1 / M[kp][kp])).  Columns at or left of the
// pivot never feed the solution columns again, so what they hold afterwards
// does not matter.
//
// A pivot is a short dependent chain (measured: 678 cycles, of which the
// barrier is ~375 and the reciprocal ~90), so what counts is the number of
// instructions on it, not of FMAs.  The register path therefore runs on
// ceil(nuf / GJ_ROWS) warps (a named barrier among them; the rest of the
// CTA waits at the caller's barrier), takes its pivot column by shuffle
// from the lane that holds it, and updates whole column blocks from the
// pivot's block on, whether an entry exists or lies left of the pivot
// (those are never read again, and rows and columns past the tableau are
// never stored), so no entry costs a comparison.  On return the columns
// from nuf on hold the solution; the caller synchronizes.
template <typename T>
__device__ __forceinline__ void gauss_jordan(T* M, T* prow2, T* colv2, int nuf,
                                             int ncol) {
  const int lane = threadIdx.x & 31, wrp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int pcol = (int)pad32(ncol), pnuf = (int)pad32(nuf);
  const int gw = (nuf + GJ_ROWS - 1) / GJ_ROWS;  // warps of the register path
  if (gw <= nw && ncol <= 32 * GJ_COLS) {
    if (wrp >= gw) return;
    // The tableau in registers: reg[a][b] = M[GJ_ROWS wrp + a][lane + 32 b].
    const int ncb = (ncol + 31) / 32, r0 = GJ_ROWS * wrp;
    T reg[GJ_ROWS][GJ_COLS];
#pragma unroll
    for (int a = 0; a < GJ_ROWS; ++a)
#pragma unroll
      for (int b = 0; b < GJ_COLS; ++b) {
        const int r = r0 + a, j = lane + 32 * b;
        reg[a][b] = r < nuf && j < ncol ? M[r * ncol + j] : T(0);
      }
    // Pivot kp = 32 bk + kq + ak: the loops over bk and ak are unrolled, so
    // the pivot's register row ak and column block bk are compile-time
    // constants and no entry is picked by a select; the column blocks left
    // of bk are dead and are not updated.  The two pivot-row buffers
    // alternate with ak.
    T* const prow_even = prow2 + lane;
    T* const prow_odd = prow2 + pcol + lane;
#pragma unroll
    for (int bk = 0; bk < GJ_COLS; ++bk) {
      for (int kq = 0; kq < 32 && 32 * bk + kq < nuf; kq += GJ_ROWS) {
        const bool owner = wrp == (32 * bk + kq) / GJ_ROWS;  // the pivot rows' warp
#pragma unroll
        for (int ak = 0; ak < GJ_ROWS; ++ak) {
          const int lk = kq + ak;  // the pivot's lane
          if (32 * bk + lk < nuf) {
            T* const prow = ak & 1 ? prow_odd : prow_even;
            if (owner) {
              // The pivot row, scaled once by the reciprocal of the pivot
              // (which lane lk holds), for every warp.
              const T inv = T(1) / __shfl_sync(0xffffffffu, reg[ak][bk], lk);
#pragma unroll
              for (int b = bk; b < GJ_COLS; ++b)
                if (b < ncb) prow[32 * b] = reg[ak][b] * inv;
            }
            // The pivot column of this warp's rows sits on its lane lk.
            T cr[GJ_ROWS], pj[GJ_COLS];
#pragma unroll
            for (int a = 0; a < GJ_ROWS; ++a)
              cr[a] = __shfl_sync(0xffffffffu, reg[a][bk], lk);
            asm volatile("bar.sync 1, %0;" ::"r"(gw * 32) : "memory");
#pragma unroll
            for (int b = bk; b < GJ_COLS; ++b) pj[b] = b < ncb ? prow[32 * b] : T(0);
#pragma unroll
            for (int a = 0; a < GJ_ROWS; ++a)
#pragma unroll
              for (int b = bk; b < GJ_COLS; ++b) {
                const T upd = reg[a][b] - cr[a] * pj[b];
                reg[a][b] = a == ak && owner ? pj[b] : upd;
              }
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < GJ_ROWS; ++a)
#pragma unroll
      for (int b = 0; b < GJ_COLS; ++b) {
        const int r = r0 + a, j = lane + 32 * b;
        if (r < nuf && j >= nuf && j < ncol) M[r * ncol + j] = reg[a][b];
      }
    return;
  }
  // In place, four rows of a column at a time.
  for (int kp = 0; kp < nuf; ++kp) {
    T* const prow = prow2 + (kp & 1) * pcol;
    T* const colv = colv2 + (kp & 1) * pnuf;
    int j0 = lane;  // this lane's first column at or right of the pivot
    if (j0 < kp) j0 += (kp - lane + 31) / 32 * 32;
    if (j0 == kp) j0 += 32;  // the pivot's own column is read, not updated
    if (wrp == kp % nw) {
      __syncwarp();  // the pivot is another lane's entry of this warp's row
      const T inv = T(1) / M[kp * ncol + kp];
      for (int j = j0; j < ncol; j += 32) prow[j] = M[kp * ncol + j] * inv;
    }
    if (lane == (kp & 31))
      for (int r = wrp; r < nuf; r += nw) colv[r] = M[r * ncol + kp];
    __syncthreads();
    for (int rb = wrp; rb < nuf; rb += 4 * nw) {
      T cr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        cr[a] = rb + a * nw < nuf ? colv[rb + a * nw] : T(0);
      for (int j = j0; j < ncol; j += 32) {
        const T pj = prow[j];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = rb + a * nw;
          if (r < nuf) {
            T* const m = M + r * ncol + j;
            *m = r == kp ? pj : *m - cr[a] * pj;
          }
        }
      }
    }
  }
}

// The same elimination for a narrow problem (nuf <= NR <= 32 rows, ncol <=
// 32 NCB columns), run by ONE warp with no barrier at all: lane l keeps
// columns l, l + 32, ... of every row in registers, so a pivot is a
// reciprocal, one shuffle per row for the pivot column and the row's
// multiply-adds; nothing is published through shared memory.  Every entry's
// arithmetic is gauss_jordan's: M[r][j] -= M[r][kp] (M[kp][j] (1 / M[kp][kp])).
// The solution leaves negated, straight from the registers: the gains K = -X
// into Kt (shared memory, row stride nxf) and Kg_t (device memory, the step's
// contiguous block), d = -x into dt and dg_t.  The other warps of the CTA
// wait at the caller's barrier.
template <int NR, int NCB, typename T>
__device__ __forceinline__ void gauss_jordan_warp(const T* M, int nuf, int nxf,
                                                  T* Kt, T* Kg_t, T* dt,
                                                  T* dg_t) {
  const int lane = threadIdx.x & 31, ncol = nuf + nxf + 1;
  T reg[NR][NCB];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int b = 0; b < NCB; ++b) {
      const int j = lane + 32 * b;
      reg[r][b] = r < nuf && j < ncol ? M[r * ncol + j] : T(0);
    }
  // The loop over pivots is unrolled, so the pivot's register row kp and
  // column block bk are constants; column blocks left of bk are dead.  Rows
  // past nuf hold zeros and stay zero.
#pragma unroll
  for (int kp = 0; kp < NR; ++kp) {
    if (kp < nuf) {
      const int bk = kp / 32, lk = kp % 32;
      // All of the pivot column's shuffles first, so that they are in
      // flight together and under the reciprocal.
      T cr[NR], pj[NCB];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        cr[r] = __shfl_sync(0xffffffffu, reg[r][bk], lk);
      const T inv = T(1) / cr[kp];
#pragma unroll
      for (int b = bk; b < NCB; ++b) pj[b] = reg[kp][b] * inv;
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int b = bk; b < NCB; ++b)
          reg[r][b] = r == kp ? pj[b] : reg[r][b] - cr[r] * pj[b];
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int b = 0; b < NCB; ++b) {
      const int j = lane + 32 * b - nuf;  // column of [K | d]
      if (r < nuf && j >= 0 && j <= nxf) {
        const T v = -reg[r][b];
        if (j < nxf) {
          Kt[r * nxf + j] = v;
          Kg_t[r * nxf + j] = v;
        } else {
          dt[r] = v;
          dg_t[r] = v;
        }
      }
    }
}

// Cycles of each phase of one sweep, summed over the steps by the first
// thread of the first CTA, when compiled with -DDPILQR_PHASE_CLOCKS
// (scripts/riccati_phase_clocks.py); nothing otherwise.  Slots 0-7 are the
// phases of a step; slot 8 only the cluster tier's (riccati_cluster.cuh),
// whose elimination splits into 3 (the pivot chain) and 8 (the right-hand
// pass).
#ifdef DPILQR_PHASE_CLOCKS
constexpr int RICCATI_PHASES = 9;
__device__ unsigned long long riccati_phase_clocks[RICCATI_PHASES];
#define RICCATI_CLOCK(i)                                   \
  if (threadIdx.x == 0 && blockIdx.x == 0) {               \
    const long long now_ = clock64();                      \
    riccati_phase_clocks[i] += now_ - phase_start_;        \
    phase_start_ = now_;                                   \
  }
// The cycles the phases of this translation unit's kernel took since the
// last reset: copies the RICCATI_PHASES sums to `out` after a device
// synchronize, then clears them.
inline int riccati_read_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, riccati_phase_clocks,
                               sizeof(unsigned long long) * RICCATI_PHASES);
  const unsigned long long zero[RICCATI_PHASES] = {0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(riccati_phase_clocks, zero, sizeof(zero));
  return (int)err;
}
#else
#define RICCATI_CLOCK(i)
#endif

// Where a step's inputs come from: the sweep calls its input source at
// fixed points, with the slot widths it runs at.
//   init(ws, ...): P and p of the terminal step, by every thread; it may
//     synchronize the CTA;
//   fetch(t, ws, ..., ft, fn): step t's A, B, L_x and L_u into At, Bt, lx
//     and lu, by threads ft of fn, while the CTA's other work goes on (the
//     next step's, on the warps the elimination leaves idle); done by the
//     barrier that ends the step;
//   lxx(ws, e, r, c, ...), luu(...): entry (r, c) of the step's L_xx and
//     L_uu where phase 2 adds it (e: its index in Qxx, Quu).
// The one source is computed_inputs.cuh's ComputedInputs (K1, K3 and K5).

// The first warp the register elimination (gauss_jordan) leaves idle, or
// 0 where it takes the whole CTA (every warp, or the in-place path).
__device__ __forceinline__ int gauss_jordan_idle_warp(int nuf, int ncol) {
  const int gw = (nuf + GJ_ROWS - 1) / GJ_ROWS, nw = blockDim.x >> 5;
  return gw < nw && ncol <= 32 * GJ_COLS ? gw : 0;
}

// TILE: the register tile of the nuf-deep products; GJ_NR, GJ_NCB: where GJ_NR > 0 the elimination runs in one warp's
// registers (gauss_jordan_warp: nuf <= GJ_NR, ncol <= 32 GJ_NCB) and writes
// the gains itself, so phases 3 and 4 are one; NXS, NUS, KS: where not 0, the
// slot widths nx and nu and the slot count K as compile-time constants (the
// index divisions become shifts or multiplications and the loops over a
// block unroll: at nxf 32 more than half of phases 1 and 2 was index
// arithmetic on the dependent chain).
// src: the input source (computed_inputs.cuh).
template <int TILE, int GJ_NR = 0, int GJ_NCB = 0, int NXS = 0, int NUS = 0,
          int KS = 0, typename Src, typename T>
__device__ __forceinline__ void riccati_sweep_from(
    const Src& src, const T mu, T* __restrict__ Kg, T* __restrict__ dg, int N,
    int K_arg, int nx_arg, int nu_arg, const RiccatiWork<T>& ws) {
  const int nx = NXS ? NXS : nx_arg, nu = NUS ? NUS : nu_arg;
  const int K = KS ? KS : K_arg;
  const int nxf = K * nx, nuf = K * nu;
  const int ncol = nuf + nxf + 1;  // Gauss-Jordan tableau [Quu | Qux | Qu]
  T* const P = ws.P;
  T* const AtP = ws.AtP;
  T* const Qxx = ws.Qxx;
  T* const W1 = ws.W1;
  T* const Qux = ws.Qux;
  T* const Kt = ws.Kt;
  T* const QuuK = ws.QuuK;
  T* const Quu = ws.Quu;
  T* const M = ws.M;
  T* const At = ws.At;
  T* const Bt = ws.Bt;
  T* const p = ws.p;
  T* const Qx = ws.Qx;
  T* const Qu = ws.Qu;
  T* const dt = ws.dt;
  T* const w = ws.w;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int ntx = (nxf + TILE - 1) / TILE, ntu = (nuf + TILE - 1) / TILE;
  const bool vect = nxf % TILE == 0;  // TILE-wide segments of nxf-wide rows

  src.init(ws, K, nx, nu);
#ifdef DPILQR_PHASE_CLOCKS
  long long phase_start_ = clock64();
#endif

  // Step t's A, B, L_x and L_u rows, by threads ft of fn.  Where the
  // elimination leaves warps idle, they fetch meanwhile.
  auto fetch_step = [&](int t, int ft, int fn) { src.fetch(t, ws, K, nx, nu, ft, fn); };
  if (N > 0) fetch_step(N - 1, tid, nth);
  __syncthreads();  // P, p and the last step's A, B, L_x, L_u are in place

  for (int t = N - 1; t >= 0; --t) {
    // The step's A, B, L_x and L_u are in place since the barrier that
    // ended the step before (or the one above), so phase 1 starts at once.
    RICCATI_CLOCK(0)

    // Phase 1: Q_x, Q_u, A^T P, B^T (P + mu I).
    for (int i = tid; i < nxf; i += nth) {
      const int k = i / nx, j = i % nx;
      T acc = mul_rn(At[(k * nx) * nx + j], p[k * nx]);
      for (int b = 1; b < nx; ++b) acc += At[(k * nx + b) * nx + j] * p[k * nx + b];
      Qx[i] = ws.lx[i] + acc;
    }
    for (int i = tid; i < nuf; i += nth) {
      const int k = i / nu, j = i % nu;
      T acc = mul_rn(Bt[(k * nx) * nu + j], p[k * nx]);
      for (int b = 1; b < nx; ++b) acc += Bt[(k * nx + b) * nu + j] * p[k * nx + b];
      Qu[i] = ws.lu[i] + acc;
    }
    bd_left<false>(At, nx, nxf, P, mu, AtP, nx, nxf);
    bd_left<true>(Bt, nu, nuf, P, mu, W1, nx, nxf);
    __syncthreads();
    RICCATI_CLOCK(1)

    // Phase 2: Q_xx = Lxx + A^T P A, Q_ux = B^T Preg A, Q_uu = B^T Preg B + Luu,
    // in strips of four rows by one column.
    {
      const Grid2 g = grid2(nxf);
      if (g.on)
        for (int c = g.tx; c < nxf; c += g.nxt) {
          const int kc = c / nx, jc = c % nx;
          T acc[4];
          for (int r0 = 4 * g.ty; r0 < nxf; r0 += 4 * g.nyt) {
            bd_right(AtP, nxf, nxf, At, nx, nx, r0, kc, jc, acc);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (r0 + i < nxf) {
                const int e = (r0 + i) * nxf + c;
                Qxx[e] = src.lxx(ws, e, r0 + i, c, K, nx) + acc[i];
              }
          }
          for (int r0 = 4 * g.ty; r0 < nuf; r0 += 4 * g.nyt) {
            bd_right(W1, nxf, nuf, At, nx, nx, r0, kc, jc, acc);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (r0 + i < nuf) {
                Qux[(r0 + i) * nxf + c] = acc[i];
                M[(r0 + i) * ncol + nuf + c] = acc[i];
              }
          }
        }
    }
    {
      const Grid2 g = grid2(nuf);
      if (g.on)
        for (int c = g.tx; c < nuf; c += g.nxt) {
          const int kc = c / nu, jc = c % nu;
          T acc[4];
          for (int r0 = 4 * g.ty; r0 < nuf; r0 += 4 * g.nyt) {
            bd_right(W1, nxf, nuf, Bt, nu, nx, r0, kc, jc, acc);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (r0 + i < nuf) {
                const int e = (r0 + i) * nuf + c;
                const T q = acc[i] + src.luu(ws, e, r0 + i, c, nu);
                Quu[e] = q;
                M[(r0 + i) * ncol + c] = q;
              }
          }
        }
    }
    for (int i = tid; i < nuf; i += nth) M[i * ncol + nuf + nxf] = Qu[i];
    __syncthreads();
    RICCATI_CLOCK(2)
    // A_t, B_t and the staged rows are done with.

    // Phases 3 and 4: the solve [K | d] = -Quu^-1 [Qux | Qu] and the gains
    // K = -X, d = -x; a step's block is contiguous.
    if constexpr (GJ_NR > 0) {
      if (tid < 32)
        gauss_jordan_warp<GJ_NR, GJ_NCB>(M, nuf, nxf, Kt,
                                         Kg + (size_t)t * nuf * nxf, dt,
                                         dg + (size_t)t * nuf);
      else if (t > 0)
        fetch_step(t - 1, tid - 32, nth - 32);
      RICCATI_CLOCK(3)
    } else {
      gauss_jordan(M, ws.prow, ws.colv, nuf, ncol);
      if (t > 0) {
        // The warps the elimination leaves idle compute the next step's
        // inputs while it runs; where it takes them all, all of them do
        // after it.
        const int w0 = 32 * gauss_jordan_idle_warp(nuf, ncol);
        if (tid >= w0) fetch_step(t - 1, tid - w0, nth - w0);
      }
      __syncthreads();
      RICCATI_CLOCK(3)

      const Grid2 g = grid2(nxf);
      T* const Kg_t = Kg + (size_t)t * nuf * nxf;
      if (g.on)
        for (int c = g.tx; c < nxf; c += g.nxt)
          for (int r = g.ty; r < nuf; r += g.nyt) {
            const T kval = -M[r * ncol + nuf + c];
            Kt[r * nxf + c] = kval;
            Kg_t[r * nxf + c] = kval;
          }
      for (int r = tid; r < nuf; r += nth) {
        const T dval = -M[r * ncol + nuf + nxf];
        dt[r] = dval;
        dg[(size_t)t * nuf + r] = dval;
      }
    }
    __syncthreads();
    RICCATI_CLOCK(4)

    // Phase 5: w = Quu d + Qu, Quu K, K^T Qux (into AtP), in register tiles.
    for (int r = tid; r < nuf; r += nth) {
      T acc = mul_rn(Quu[r], dt[0]);
      for (int v = 1; v < nuf; ++v) acc += Quu[v * nuf + r] * dt[v];
      w[r] = acc + Qu[r];
    }
    for (int it = tid; it < ntu * ntx; it += nth) {
      const int r0 = (it / ntx) * TILE, c0 = (it % ntx) * TILE;
      T acc[TILE][TILE];
      atb_tile<TILE>(Quu, nuf, nuf, Kt, nxf, nxf, nuf, r0, c0, acc);
#pragma unroll
      for (int i = 0; i < TILE; ++i)
        if (r0 + i < nuf)
          store_row<TILE>(QuuK + (r0 + i) * nxf + c0, nxf - c0,
                          vect && c0 + TILE <= nxf, acc[i]);
    }
    for (int it = tid; it < ntx * ntx; it += nth) {
      const int r0 = (it / ntx) * TILE, c0 = (it % ntx) * TILE;
      T acc[TILE][TILE];
      atb_tile<TILE>(Kt, nxf, nxf, Qux, nxf, nxf, nuf, r0, c0, acc);
#pragma unroll
      for (int i = 0; i < TILE; ++i)
        if (r0 + i < nxf)
          store_row<TILE>(AtP + (r0 + i) * nxf + c0, nxf - c0,
                          vect && c0 + TILE <= nxf, acc[i]);
    }
    __syncthreads();
    RICCATI_CLOCK(5)

    // Phase 6: full-form value update p, P_new = Qxx + K^T Quu K + K^T Qux
    // + (K^T Qux)^T (into Qxx; a tile is read and written by one thread,
    // the transposed tile of K^T Qux read a row segment at a time).
    for (int c = tid; c < nxf; c += nth) {
      T a1 = mul_rn(Kt[c], w[0]);
      for (int v = 1; v < nuf; ++v) a1 += Kt[v * nxf + c] * w[v];
      T a2 = mul_rn(Qux[c], dt[0]);
      for (int v = 1; v < nuf; ++v) a2 += Qux[v * nxf + c] * dt[v];
      p[c] = Qx[c] + a1 + a2;
    }
    for (int it = tid; it < ntx * ntx; it += nth) {
      const int r0 = (it / ntx) * TILE, c0 = (it % ntx) * TILE;
      const bool full = vect && c0 + TILE <= nxf, fullT = vect && r0 + TILE <= nxf;
      T acc[TILE][TILE], tr[TILE][TILE];
      atb_tile<TILE>(Kt, nxf, nxf, QuuK, nxf, nxf, nuf, r0, c0, acc);
#pragma unroll
      for (int j = 0; j < TILE; ++j)  // tr[j][i] = (K^T Qux)[c0 + j][r0 + i]
        load_row<TILE>(AtP + (c0 + j) * nxf + r0, c0 + j < nxf ? nxf - r0 : 0,
                       fullT && c0 + j < nxf, tr[j]);
#pragma unroll
      for (int i = 0; i < TILE; ++i)
        if (r0 + i < nxf) {
          T q[TILE], s[TILE];
          T* const row = Qxx + (r0 + i) * nxf + c0;
          load_row<TILE>(row, nxf - c0, full, q);
          load_row<TILE>(AtP + (r0 + i) * nxf + c0, nxf - c0, full, s);
#pragma unroll
          for (int j = 0; j < TILE; ++j) q[j] = q[j] + acc[i][j] + s[j] + tr[j][i];
          store_row<TILE>(row, nxf - c0, full, q);
        }
    }
    __syncthreads();
    RICCATI_CLOCK(6)

    // Phase 7: symmetrize, tile by tile.
    for (int it = tid; it < ntx * ntx; it += nth) {
      const int r0 = (it / ntx) * TILE, c0 = (it % ntx) * TILE;
      const bool full = vect && c0 + TILE <= nxf, fullT = vect && r0 + TILE <= nxf;
      T tr[TILE][TILE];
#pragma unroll
      for (int j = 0; j < TILE; ++j)  // tr[j][i] = Qxx[c0 + j][r0 + i]
        load_row<TILE>(Qxx + (c0 + j) * nxf + r0, c0 + j < nxf ? nxf - r0 : 0,
                       fullT && c0 + j < nxf, tr[j]);
#pragma unroll
      for (int i = 0; i < TILE; ++i)
        if (r0 + i < nxf) {
          T q[TILE];
          load_row<TILE>(Qxx + (r0 + i) * nxf + c0, nxf - c0, full, q);
#pragma unroll
          for (int j = 0; j < TILE; ++j) q[j] = T(0.5) * (q[j] + tr[j][i]);
          store_row<TILE>(P + (r0 + i) * nxf + c0, nxf - c0, full, q);
        }
    }
    __syncthreads();  // the next step's A, B, L_x, L_u are in place
    RICCATI_CLOCK(7)
  }
}


}  // namespace
