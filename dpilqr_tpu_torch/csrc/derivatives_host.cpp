// Host build of derivatives.cuh, for the CPU tests: the functions K5
// (backward_sweep.cu) computes its inputs with, compiled by a host C++
// compiler into a small shared library with a plain C interface and called
// through ctypes (tests/test_torch_derivatives.py).  float64 only.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I csrc -o lib.so csrc/derivatives_host.cpp

#include <vector>

#include "derivatives.cuh"

extern "C" {

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

}  // extern "C"
