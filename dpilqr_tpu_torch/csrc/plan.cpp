// The shared-memory plan of plan.h with a plain C interface, for the Python
// side (ops/cuda_build.py riccati_plan and forward_plan, through ctypes).  A
// host C++ compiler builds this file alone into a small library:
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libdpilqr_plan.so csrc/plan.cpp
//
// The kernels compile the same header and plan every launch with it, so the
// layout is defined once, in plan.h: what Python sizes a workspace or
// refuses a width with is what the card runs.  `limit` is the shared memory
// a block may use (sm_90a's opt-in, 227 KB, on the card).

#include "plan.h"

extern "C" {

// K3's largest cluster, for the wrapper that asks for K3's plan.
extern const int dpilqr_cluster_max = CLUSTER_MAX;

// Where one problem's working set of a backward kernel goes (computed_plan:
// riccati_plan with the input source's buffers, the plan of all three
// backward kernels; with max_cluster > 1, K3's wide_plan, which may put it
// on a cluster of up to max_cluster CTAs): returns the tier (0 all in
// shared memory, 1 the value group in the workspace, 2 the gain group too,
// 3 a cluster's shared memory) and writes the shared-memory bytes of a CTA,
// the workspace values of one problem and the CTAs a problem.  Returns -1
// where not even the vectors fit, and writes their bytes as smem_bytes.
int dpilqr_riccati_plan(int K, int nx, int nu, int itemsize, int max_cluster,
                        long long limit, long long* smem_bytes,
                        long long* work_values, int* cluster) {
  const RiccatiPlan plan = wide_plan(K, nx, nu, itemsize, limit, max_cluster);
  *smem_bytes = (long long)((plan.tier < 0 ? riccati_sizes(K, nx, nu).vec : plan.smem) *
                            itemsize);
  *work_values = (long long)plan.work;
  *cluster = plan.cluster;
  return plan.tier;
}

// The forward kernels' plan (column_launch) of one problem of K slots:
// fills plan = {chunks, warps, n_buf, rows} and returns the dynamic shared
// memory of a CTA in bytes (0 for no alphas).  Where nothing fits it
// returns minus the bytes that one warp's column (beside a 4-row tile of
// gains and a step's rows, with gains) takes.
long long dpilqr_forward_plan(int K, int nx, int nu, int n_alpha, int gains,
                              int itemsize, int max_rows, long long limit,
                              int* plan) {
  const int nxf = K * nx, nuf = K * nu;
  const ColumnLaunch cl =
      column_launch(nxf, nuf, n_alpha, gains != 0, itemsize, limit, max_rows);
  plan[0] = cl.chunks;
  plan[1] = cl.warps;
  plan[2] = cl.n_buf;
  plan[3] = cl.rows;
  if (cl.n_buf != 0 || n_alpha < 1) return (long long)cl.bytes;
  const size_t need = column_values(nxf, nuf) +
                      (gains ? tile_values(4, nxf) + row_values(nxf, nuf) : 0);
  return -(long long)(need * itemsize);
}

}  // extern "C"
