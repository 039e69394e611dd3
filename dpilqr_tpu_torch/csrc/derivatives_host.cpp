// Host build of derivatives.cuh and computed_inputs.cuh, for the CPU tests:
// the functions K1, K3 and K5 compute their inputs with, compiled by a host
// C++ compiler (ops/cuda_build.py host_build) into a small shared library
// with a plain C interface and called through ctypes
// (tests/test_torch_derivatives.py, tests/test_torch_batched_prep.py).
// float64 only.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I csrc -o lib.so csrc/derivatives_host.cpp
//
// With -DDPILQR_CUSTOM_MODELS and the directory of a header generated by
// ops/codegen.py on the include path (-I), the same functions also take the
// generated models' library-local ids (tests/test_torch_codegen.py).

#include <vector>

#include "computed_inputs.cuh"

extern "C" {

// One agent's continuous right-hand side at (x (nx), u (nu)): xd (nx).
// Returns 1 for widths past the models'.
int dpilqr_host_rhs(int model, const double* x, const double* u, int nx, int nu,
                    double* xd) {
  if (nx > MAX_NX || nu > MAX_NU) return 1;
  double xs[MAX_NX], us[MAX_NU], out[MAX_NX];
  for (int a = 0; a < MAX_NX; ++a) xs[a] = a < nx ? x[a] : 0.0;
  for (int b = 0; b < MAX_NU; ++b) us[b] = b < nu ? u[b] : 0.0;
  rhs(model, xs, us, out);
  for (int a = 0; a < nx; ++a) xd[a] = out[a];
  return 0;
}

// One agent's discretized Jacobians at (x (nx), u (nu)): A (nx, nx), B
// (nx, nu).  Returns 1 for widths past the models'.
int dpilqr_host_jacobians(int model, const double* x, const double* u, int nx,
                          int nu, double dt, double mask, double* A, double* B) {
  if (nx > MAX_NX || nu > MAX_NU) return 1;
  for (int q = 0; q < nx + nu; ++q)
    jacobian_column<MAX_NX>(model, x, u, nx, nu, q, dt, mask, A, nx, B, nu);
  return 0;
}

// The cost's derivatives at one step of n agents, x (n, nx), u (n, nu) (null
// at the terminal step, where Q is the terminal weight): lx (n, nx), lu (n,
// nu), and the dense Lxx (n nx, n nx) and Luu (n nu, n nu) assembled from
// their blocks as K5 assembles them.
int dpilqr_host_cost_terms(int n, int nx, int nu, const double* x, const double* u,
                           const double* xf, const double* Q, const double* R,
                           const double* mask, const int* npos, double refw,
                           double radius, double pw, double* lx, double* lu,
                           double* Lxx, double* Luu) {
  const int k = nx < 3 ? nx : 3;
  std::vector<double> QQ(n * nx * nx), RR(n * nu * nu), Ld(n * nx * nx),
      Lu(n * nu * nu), Lblk(n * n * k * k), G(n * n * 3);
  for (int i = 0; i < n; ++i) {
    for (int a = 0; a < nx; ++a)
      for (int b = 0; b < nx; ++b)
        QQ[(i * nx + a) * nx + b] = Q[(i * nx + a) * nx + b] + Q[(i * nx + b) * nx + a];
    for (int a = 0; a < nu; ++a)
      for (int b = 0; b < nu; ++b)
        RR[(i * nu + a) * nu + b] = R[(i * nu + a) * nu + b] + R[(i * nu + b) * nu + a];
  }
  const CostTerms<double> c{xf, QQ.data(), RR.data(), mask, npos, refw, radius, pw,
                            n, nx, nu, k};
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      if (j != i)
        pair_terms_block(c, i, j, x, &Lblk[(i * n + j) * k * k], &G[(i * n + j) * 3]);
  for (int i = 0; i < n; ++i)
    agent_terms(c, i, x, u, Lblk.data(), G.data(), lx + i * nx,
                u ? lu + i * nu : nullptr, &Lblk[(i * n + i) * k * k]);
  constant_blocks(c, Ld.data(), Lu.data(), 0, 1);
  const int nxf = n * nx, nuf = n * nu;
  for (int r = 0; r < nxf; ++r)
    for (int col = 0; col < nxf; ++col)
      Lxx[r * nxf + col] = lxx_entry(r, col, n, nx, k, Ld.data(), Lblk.data());
  for (int r = 0; r < nuf; ++r)
    for (int col = 0; col < nuf; ++col)
      Luu[r * nuf + col] = luu_entry(r, col, nu, Lu.data());
  return 0;
}

// The inputs K1 and K3 compute for a batch of S subproblems of K slots, by
// the same per-subproblem view (slot_problem) and work items
// (sweep_prep_items_inline, run by one thread) and the same assembly of the
// dense Hessians from their blocks (ComputedInputs::init and lxx_entry,
// luu_entry), laid out as ops/batched.py's _quadraticize_batch and
// _linearize_batch return them: A (S, N, K, nx, nx), B (S, N, K, nx, nu),
// Lx (S, N, K nx), Lu (S, N, K nu), Lxx (S, N, K nx, K nx), Luu (S, N,
// K nu, K nu), p0 (S, K nx), P0 (S, K nx, K nx).  Inputs as the kernels take
// them (computed_inputs.cuh slot_problem).  Returns 1 for widths past the
// models'.
int dpilqr_host_batched_prep(int S, int N, int K, int nx, int nu, const double* X,
                             const double* U, const double* xf, const double* Q,
                             const double* R, const double* Qf, const double* mask,
                             const double* refw, const double* radius,
                             const double* pw, const int* npos, const int* mids,
                             const int* ids, double dt, double* A, double* B,
                             double* Lx, double* Lu, double* Lxx, double* Luu,
                             double* p0, double* P0) {
  if (nx > MAX_NX || nu > MAX_NU) return 1;
  const int k = nx < 3 ? nx : 3, nxf = K * nx, nuf = K * nu;
  std::vector<double> QQ(K * nx * nx), RR(K * nu * nu), Ld(K * nx * nx),
      Lud(K * nu * nu), Lblk(K * K * k * k), G(K * K * 3);
  const auto symmetrize = [](const double* W, double* out, int n, int w) {
    for (int e = 0; e < n * w * w; ++e) {
      const int i = e / (w * w), a = e % (w * w) / w, b = e % w;
      out[e] = W[e] + W[(i * w + b) * w + a];
    }
  };
  const auto hessians = [&](double* lxx, double* luu) {
    for (int r = 0; r < nxf; ++r)
      for (int c = 0; c < nxf; ++c)
        lxx[r * nxf + c] = lxx_entry(r, c, K, nx, k, Ld.data(), Lblk.data());
    if (luu != nullptr)
      for (int r = 0; r < nuf; ++r)
        for (int c = 0; c < nuf; ++c) luu[r * nuf + c] = luu_entry(r, c, nu, Lud.data());
  };
  for (int s = 0; s < S; ++s) {
    const SlotProblem<double> pb = slot_problem(X, U, xf, Q, R, Qf, mask, refw, radius,
                                                pw, npos, mids, ids, dt, s, N, K, nx, nu);
    const CostTerms<double> c{pb.xf, QQ.data(), RR.data(), pb.mask, pb.npos, pb.refw,
                              pb.radius, pb.pw, K, nx, nu, k};
    // The terminal step, with Qf.
    symmetrize(pb.Qf, QQ.data(), K, nx);
    symmetrize(pb.R, RR.data(), K, nu);
    constant_blocks(c, Ld.data(), Lud.data(), 0, 1);
    sweep_prep_items_inline<MAX_NX, double>(pb, c, N, p0 + (size_t)s * nxf, nullptr, nullptr,
                                    nullptr, Lblk.data(), G.data(), 0, 1);
    hessians(P0 + (size_t)s * nxf * nxf, nullptr);
    // The stage steps, with Q.
    symmetrize(pb.Q, QQ.data(), K, nx);
    constant_blocks(c, Ld.data(), Lud.data(), 0, 1);
    for (int t = 0; t < N; ++t) {
      const size_t st = (size_t)s * N + t;
      sweep_prep_items_inline<MAX_NX>(pb, c, t, Lx + st * nxf, Lu + st * nuf,
                                      A + st * K * nx * nx, B + st * K * nx * nu,
                                      Lblk.data(), G.data(), 0, 1);
      hessians(Lxx + st * nxf * nxf, Luu + st * nuf * nuf);
    }
  }
  return 0;
}

// The same inputs as the cluster tier of K3 computes them (riccati_cluster.cuh):
// rank q of C computes the agents [q K / C, (q + 1) K / C) with
// sweep_prep_rows_inline, into its own rows of the proximity blocks and
// gradient terms, and assembles its own rows of L_xx from them; the ranks'
// rows together must be dpilqr_host_batched_prep's to the bit.
int dpilqr_host_batched_prep_rows(int S, int N, int K, int nx, int nu, const double* X,
                                  const double* U, const double* xf, const double* Q,
                                  const double* R, const double* Qf, const double* mask,
                                  const double* refw, const double* radius,
                                  const double* pw, const int* npos, const int* mids,
                                  const int* ids, double dt, double* A, double* B,
                                  double* Lx, double* Lu, double* Lxx, double* Luu,
                                  double* p0, double* P0, int C) {
  if (nx > MAX_NX || nu > MAX_NU || C < 1 || C > K) return 1;
  const int k = nx < 3 ? nx : 3, nxf = K * nx, nuf = K * nu;
  std::vector<double> QQ(K * nx * nx), RR(K * nu * nu), Ld(K * nx * nx),
      Lud(K * nu * nu), Lrows(K * K * k * k), Grows(K * K * 3);
  const auto symmetrize = [](const double* W, double* out, int n, int w) {
    for (int e = 0; e < n * w * w; ++e) {
      const int i = e / (w * w), a = e % (w * w) / w, b = e % w;
      out[e] = W[e] + W[(i * w + b) * w + a];
    }
  };
  // Rank q's share of a step: its agents' items, then its rows of L_xx.
  const auto rank_step = [&](const SlotProblem<double>& pb, const CostTerms<double>& c,
                             int t, int q, double* lx, double* lu, double* At, double* Bt,
                             double* lxx) {
    const int i0 = q * K / C, i1 = (q + 1) * K / C;
    sweep_prep_rows_inline<MAX_NX>(pb, c, t, i0, i1, lx + i0 * nx,
                                   lu ? lu + i0 * nu : nullptr, At, Bt, Lrows.data(),
                                   Grows.data(), 0, 1);
    const double* shifted = Lrows.data() - (long long)i0 * K * k * k;
    for (int r = i0 * nx; r < i1 * nx; ++r)
      for (int col = 0; col < nxf; ++col)
        lxx[r * nxf + col] = lxx_entry(r, col, K, nx, k, Ld.data(), shifted);
  };
  for (int s = 0; s < S; ++s) {
    const SlotProblem<double> pb = slot_problem(X, U, xf, Q, R, Qf, mask, refw, radius,
                                                pw, npos, mids, ids, dt, s, N, K, nx, nu);
    const CostTerms<double> c{pb.xf, QQ.data(), RR.data(), pb.mask, pb.npos, pb.refw,
                              pb.radius, pb.pw, K, nx, nu, k};
    symmetrize(pb.Qf, QQ.data(), K, nx);
    symmetrize(pb.R, RR.data(), K, nu);
    constant_blocks(c, Ld.data(), Lud.data(), 0, 1);
    for (int q = 0; q < C; ++q)
      rank_step(pb, c, N, q, p0 + (size_t)s * nxf, nullptr, nullptr, nullptr,
                P0 + (size_t)s * nxf * nxf);
    symmetrize(pb.Q, QQ.data(), K, nx);
    constant_blocks(c, Ld.data(), Lud.data(), 0, 1);
    for (int t = 0; t < N; ++t) {
      const size_t st = (size_t)s * N + t;
      for (int q = 0; q < C; ++q)
        rank_step(pb, c, t, q, Lx + st * nxf, Lu + st * nuf, A + st * K * nx * nx,
                  B + st * K * nx * nu, Lxx + st * nxf * nxf);
      for (int r = 0; r < nuf; ++r)
        for (int col = 0; col < nuf; ++col)
          Luu[st * nuf * nuf + r * nuf + col] = luu_entry(r, col, nu, Lud.data());
    }
  }
  return 0;
}

}  // extern "C"
