// First and second derivatives of one iLQR step, on the device and the
// host: the Euler-discretized model Jacobians and the game cost's gradient
// and Hessian blocks.  backward_sweep.cu (K5) computes its inputs with them
// inside the kernel; csrc/derivatives_host.cpp compiles the same functions
// with a host C++ compiler for the CPU tests (tests/test_torch_derivatives.py).
//
// Jacobians: A = I + dt df/dx and B = dt df/du, the forward-Euler
// discretization of the CONTINUOUS Jacobians (models/integrate.py
// euler_discretize), not Jacobians of the RK4 step; B is scaled by the
// agent's mask.  They come from the right-hand sides of dynamics.cuh (one
// source for the nine models) evaluated on dual numbers: one evaluation
// with the tangent e_q gives column q.
//
// Cost (ops/costs.py quadraticize_stage_compact, with the proximity closed
// form of proximity_quadraticize_compact): with e = x - xf and
// w = ref_weight * mask,
//   L_x = w (Q + Q^T)^T e + pw sum_j c_ij (pos_i - pos_j),
//   L_u = w (R + R^T)^T u + 2 (1 - m) u,
//   L_xx: diagonal blocks w (Q + Q^T) + pw sum_j H_ij, off-diagonal -pw H_ij,
//   L_uu = w (R + R^T) + 2 (1 - m) I,
// over pairs active where d < radius, weighted by both masks, in the first
// k = min(3, nx) components, each masked to min(n_pos_i, n_pos_j); d is
// clamped at 1e-12 where it divides, c_ij = 2 (d - r) / d and
// H_ij = (2 - 2 r / d) I + (2 r / d^3) delta delta^T.  The terminal step has
// Qf for Q and no control terms.  Every expression keeps the association
// order of the torch version.

#pragma once

#include "dynamics.cuh"

namespace {

constexpr double PAIR_EPS = 1e-12;  // ops/costs.py _EPS

// A value and one tangent.
template <typename T>
struct Dual {
  T v, d;
  DPILQR_HD Dual() : v(0), d(0) {}
  DPILQR_HD Dual(double c) : v(T(c)), d(0) {}
  DPILQR_HD Dual(T v_, T d_) : v(v_), d(d_) {}
};

template <typename T>
DPILQR_HD __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> operator-(Dual<T> a) {
  return {-a.v, -a.d};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}

template <typename T>
DPILQR_HD __forceinline__ void d_sincos(Dual<T> v, Dual<T>* s, Dual<T>* c) {
  T sn, cs;
  d_sincos(v.v, &sn, &cs);
  *s = Dual<T>(sn, cs * v.d);
  *c = Dual<T>(cs, -sn * v.d);
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_tan(Dual<T> v) {
  const T t = d_tan(v.v);
  return {t, (T(1) + t * t) * v.d};
}

// The other functions a generated right-hand side may call (ops/codegen.py),
// on dual numbers; found by argument-dependent lookup from the generated
// templates, which are defined before these.
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_sin(Dual<T> v) {
  return {d_sin(v.v), d_cos(v.v) * v.d};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_cos(Dual<T> v) {
  return {d_cos(v.v), -d_sin(v.v) * v.d};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_sqrt(Dual<T> v) {
  const T s = d_sqrt(v.v);
  return {s, v.d / (T(2) * s)};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_exp(Dual<T> v) {
  const T e = d_exp(v.v);
  return {e, e * v.d};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_log(Dual<T> v) {
  return {d_log(v.v), v.d / v.v};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_tanh(Dual<T> v) {
  const T t = d_tanh(v.v);
  return {t, (T(1) - t * t) * v.d};
}
// The derivative of |v| is sign(v), 0 at 0 (torch's).
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_abs(Dual<T> v) {
  const T sg = v.v > T(0) ? T(1) : (v.v < T(0) ? T(-1) : T(0));
  return {d_abs(v.v), sg * v.d};
}
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_atan2(Dual<T> y, Dual<T> x) {
  return {d_atan2(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}
// a^b: the exponent's term only where its tangent is not 0, so a constant
// exponent over a negative base keeps a finite derivative.
template <typename T>
DPILQR_HD __forceinline__ Dual<T> d_pow(Dual<T> a, Dual<T> b) {
  const T p = d_pow(a.v, b.v);
  T dp = b.v * d_pow(a.v, b.v - T(1)) * a.d;
  if (b.d != T(0)) dp = dp + p * d_log(a.v) * b.d;
  return {p, dp};
}

// Column q of one agent's discretized Jacobians at (x, u): for q < nx column
// q of A (nx, nx), A[b][q] = [b == q] + dt df_b/dx_q; else column q - nx of
// B (nx, nu), B[b][q - nx] = dt df_b/du_(q-nx) mask.  Rows and columns are
// the padded widths nx <= NXC, nu <= MAX_NU; lda, ldb: the row strides.
template <int NXC, typename T>
DPILQR_HD void jacobian_column(int model, const T* x, const T* u, int nx, int nu,
                               int q, T dt, T mask, T* A, int lda, T* B,
                               int ldb) {
  Dual<T> xs[NXC], xd[NXC], us[MAX_NU];
#pragma unroll
  for (int a = 0; a < NXC; ++a)
    xs[a] = Dual<T>(a < nx ? x[a] : T(0), a == q ? T(1) : T(0));
#pragma unroll
  for (int b = 0; b < MAX_NU; ++b)
    us[b] = Dual<T>(b < nu ? u[b] : T(0), nx + b == q ? T(1) : T(0));
  rhs(model, xs, us, xd);
#pragma unroll
  for (int b = 0; b < NXC; ++b) {
    if (b < nx) {
      if (q < nx)
        A[b * lda + q] = (b == q ? T(1) : T(0)) + dt * xd[b].d;
      else
        B[b * ldb + q - nx] = dt * xd[b].d * mask;
    }
  }
}

// One pair's proximity terms at positions xi, xj (the first k <= 3 state
// components of two agents), masks' product mm and position size nd:
// returns c = w 2 (d - r) / d (the gradient is c delta) and writes
// delta = (pos_i - pos_j) masked to nd components and the weighted Hessian
// H (3 x 3; entries past k are 0); w = mm [d < r].  Fixed-size and
// unrolled, so that delta and H stay in registers.
template <typename T>
DPILQR_HD __forceinline__ T pair_terms(const T* xi, const T* xj, int k, int nd, T mm,
                                       T radius, T (&delta)[3], T (&H)[9]) {
  T dd = T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T raw = a < k ? xi[a] - xj[a] : T(0);
    delta[a] = raw * (a < nd ? T(1) : T(0));
    dd = a == 0 ? delta[0] * delta[0] : dd + delta[a] * delta[a];
  }
  const T d = d_sqrt(dd);
  const T wp = mm * (d < radius ? T(1) : T(0));
  const T ds = d > T(PAIR_EPS) ? d : T(PAIR_EPS);
  const T s1 = T(2) - T(2) * radius / ds;
  const T s2 = T(2) * radius / (ds * ds * ds);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const T cm = (a < nd && a < k ? T(1) : T(0)) * (b < nd && b < k ? T(1) : T(0));
      H[a * 3 + b] = (s1 * (a == b ? T(1) : T(0)) + s2 * (delta[a] * delta[b])) * cm * wp;
    }
  return wp * T(2) * (d - radius) / ds;
}

// The game cost's fields as the derivative routines read them: per agent
// xf (n, nx), QQ = Q + Q^T (or Qf + Qf^T at the terminal step) (n, nx, nx),
// RR = R + R^T (n, nu, nu), mask (n), n_pos (n); scalars ref_weight,
// radius, prox_weight.
template <typename T>
struct CostTerms {
  const T *xf, *QQ, *RR, *mask;
  const int* npos;
  T refw, radius, pw;
  int n, nx, nu, k;
};

// A step's cost terms come in two stages: every ordered pair i != j first
// (pair_terms_block: its off-diagonal Hessian block and its gradient term,
// one geometry each), then every agent from its row of those (agent_terms).
//
// Stage 1, the ordered pair i != j: blk (k x k) = -pw H_ij, the off-diagonal
// Hessian block, and g (3) = c_ij delta_ij, the pair's part of agent i's
// proximity gradient.
template <typename T>
DPILQR_HD void pair_terms_block(const CostTerms<T>& c, int i, int j, const T* x,
                                T* blk, T* g) {
  const int nd = c.npos[i] < c.npos[j] ? c.npos[i] : c.npos[j];
  T delta[3], h[9];
  const T cij = pair_terms(x + i * c.nx, x + j * c.nx, c.k, nd, c.mask[i] * c.mask[j],
                           c.radius, delta, h);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g[a] = cij * delta[a];
#pragma unroll
    for (int b = 0; b < 3; ++b)
      if (a < c.k && b < c.k) blk[a * c.k + b] = -(c.pw * h[a * 3 + b]);
  }
}

// Stage 2, agent i at one step, x (n, nx) and u (n, nu) the step's rows (u
// null at the terminal step), Lblk (n, n, k, k) and G (n, n, 3) holding
// stage 1's results for row i: lx (nx) = w (Q + Q^T)^T e + pw sum_j g_ij,
// lu (nu, unless u is null) and the diagonal block's proximity part
// hd (k x k) = pw sum_j H_ij = sum_j -blk_ij, partners in index order.
template <typename T>
DPILQR_HD void agent_terms(const CostTerms<T>& c, int i, const T* x, const T* u,
                           const T* Lblk, const T* G, T* lx, T* lu, T* hd) {
  const int nx = c.nx, nu = c.nu, k = c.k, n = c.n, kk = k * k;
  const T m = c.mask[i], w = c.refw * m;
  const T* xi = x + i * nx;
  const T* qq = c.QQ + i * nx * nx;
  for (int b = 0; b < nx; ++b) {
    T acc = (xi[0] - c.xf[i * nx]) * qq[b];
    for (int a = 1; a < nx; ++a) acc = acc + (xi[a] - c.xf[i * nx + a]) * qq[a * nx + b];
    lx[b] = w * acc;
  }
  if (u != nullptr) {
    const T* ui = u + i * nu;
    const T* rr = c.RR + i * nu * nu;
    for (int b = 0; b < nu; ++b) {
      T acc = ui[0] * rr[b];
      for (int a = 1; a < nu; ++a) acc = acc + ui[a] * rr[a * nu + b];
      lu[b] = w * acc + T(2) * (T(1) - m) * ui[b];
    }
  }
  T g[3] = {T(0), T(0), T(0)}, hs[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) hs[e] = T(0);
  for (int j = 0; j < n; ++j) {
    if (j == i) continue;
    const T* blk = Lblk + (i * n + j) * kk;
    const T* gj = G + (i * n + j) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      g[a] = g[a] + gj[a];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        if (a < k && b < k) hs[a * 3 + b] = hs[a * 3 + b] + -blk[a * k + b];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if (a < k) {
      lx[a] = lx[a] + c.pw * g[a];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        if (b < k) hd[a * k + b] = hs[a * 3 + b];
    }
}

// The blocks of the Hessians that do not change along the horizon:
// Ld_i = w_i (Q_i + Q_i^T) (n, nx, nx) and Lu_i = w_i (R_i + R_i^T) +
// 2 (1 - m_i) I (n, nu, nu), for entries e of a thread's share (tid of nth).
template <typename T>
DPILQR_HD void constant_blocks(const CostTerms<T>& c, T* Ld, T* Lu, int tid, int nth) {
  const int nx = c.nx, nu = c.nu;
  for (int e = tid; e < c.n * nx * nx; e += nth) {
    const int i = e / (nx * nx);
    Ld[e] = c.refw * c.mask[i] * c.QQ[e];
  }
  for (int e = tid; e < c.n * nu * nu; e += nth) {
    const int i = e / (nu * nu), a = e % (nu * nu) / nu, b = e % nu;
    const T m = c.mask[i];
    Lu[e] = c.refw * m * c.RR[e] + T(2) * (T(1) - m) * (a == b ? T(1) : T(0));
  }
}

// Entry (r, c) of the dense L_xx (n nx, n nx) from the diagonal blocks Ld
// (n, nx, nx) and the proximity blocks Lblk (n, n, k, k): the diagonal block
// plus, in the first k components, the proximity block.
template <typename T>
DPILQR_HD __forceinline__ T lxx_entry(int r, int c, int n, int nx, int k, const T* Ld,
                                      const T* Lblk) {
  const int i = r / nx, a = r - i * nx, j = c / nx, b = c - j * nx;
  const T diag = i == j ? Ld[(i * nx + a) * nx + b] : T(0);
  return a < k && b < k ? diag + Lblk[((i * n + j) * k + a) * k + b] : diag;
}

// Entry (r, c) of the dense block-diagonal L_uu (n nu, n nu).
template <typename T>
DPILQR_HD __forceinline__ T luu_entry(int r, int c, int nu, const T* Lu) {
  const int i = r / nu, a = r - i * nu, j = c / nu, b = c - j * nu;
  return i == j ? Lu[(i * nu + a) * nu + b] : T(0);
}

}  // namespace
