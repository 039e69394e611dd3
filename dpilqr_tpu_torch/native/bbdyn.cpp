// bbdyn.cpp -- batched host-side dynamics kernel.
//
// TPU-native framework companion to the JAX dynamics path: the real-time
// control loop (scripts/experiment.py) integrates measured states and
// linearizes on the host between device solves, where a TPU round-trip per
// tiny 4-12 dim step would dominate latency.  Capability-equivalent to the
// reference's Cython/C++ kernel (reference: dpilqr/bbdynamics.cpp) but with
// a batched, padded-block C ABI matching this framework's (n_agents, nx_p)
// array layout, selected per agent by model id.
//
// Exposed C ABI (see host.py):
//   bbdyn_f          : continuous RHS, batched
//   bbdyn_step       : RK4 integration over dt with per-model substeps
//   bbdyn_linearize  : Euler-discretized Jacobians A = I + dt*Ac, B = dt*Bc
//
// All buffers are row-major double, padded to (nx_p, nu_p) per agent.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr double kGravity = 9.80665;

// Quad12D physical ratios (1/mass, 1/inertia, gyroscopic couplings) --
// same plant constants as the reference model (bbdynamics.cpp:507-510).
constexpr double kQ12InvMass = 2000.0 / 63.0;
constexpr double kQ12InvIxx = 625000000000000000.0 / 10982593196059.0;
constexpr double kQ12InvIyy = 5000000000000000000.0 / 92848985528431.0;
constexpr double kQ12InvIzz = 10000000000000000000.0 / 271597947137541.0;
constexpr double kQ12CoupX = 85899976080679.0 / 175721491136944.0;
constexpr double kQ12CoupY = 95876456000597.0 / 185697971056862.0;
constexpr double kQ12CoupZ = 9976479919918.0 / 271597947137541.0;

struct ModelInfo {
  int nx;
  int nu;
  int substeps;
};

// Model ids match dpilqr_tpu.models.specs.MODEL_REGISTRY order.
enum ModelId {
  kDoubleInt4D = 0,
  kDoubleInt6D = 1,
  kCar3D = 2,
  kUnicycle4D = 3,
  kHuman6D = 4,
  kHumanLin6D = 5,
  kQuad6D = 6,
  kQuad12D = 7,
  kBike5D = 8,
  kNumModels = 9,
};

const ModelInfo kModels[kNumModels] = {
    {4, 2, 5}, {6, 3, 5}, {3, 2, 5}, {4, 2, 5}, {6, 3, 5},
    {6, 3, 5}, {6, 3, 5}, {12, 4, 5}, {5, 2, 1},
};

// Continuous-time right-hand sides.  xd is pre-zeroed by the caller loop,
// so only nonzero components are written.
void rhs(int model, const double* x, const double* u, double* xd) {
  switch (model) {
    case kDoubleInt4D:
      xd[0] = x[2];
      xd[1] = x[3];
      xd[2] = u[0];
      xd[3] = u[1];
      break;
    case kDoubleInt6D:
      xd[0] = x[3];
      xd[1] = x[4];
      xd[2] = x[5];
      xd[3] = u[0];
      xd[4] = u[1];
      xd[5] = u[2];
      break;
    case kCar3D:
      xd[0] = u[0] * std::cos(x[2]);
      xd[1] = u[0] * std::sin(x[2]);
      xd[2] = u[1];
      break;
    case kUnicycle4D:
      xd[0] = x[2] * std::cos(x[3]);
      xd[1] = x[2] * std::sin(x[3]);
      xd[2] = u[0];
      xd[3] = u[1];
      break;
    case kHuman6D:
      xd[0] = x[3] * std::cos(u[0]);
      xd[1] = x[3] * std::sin(u[0]);
      xd[3] = u[1];
      break;
    case kHumanLin6D:
      xd[0] = x[3];
      xd[1] = x[4];
      xd[3] = u[0];
      xd[4] = u[1];
      break;
    case kQuad6D:
      xd[0] = x[3];
      xd[1] = x[4];
      xd[2] = x[5];
      xd[3] = kGravity * std::tan(u[2]);
      xd[4] = -kGravity * std::tan(u[1]);
      xd[5] = u[0] - kGravity;
      break;
    case kQuad12D: {
      const double psi = x[3], th = x[4], ph = x[5];
      const double vx = x[6], vy = x[7], vz = x[8];
      const double wx = x[9], wy = x[10], wz = x[11];
      const double sps = std::sin(psi), cps = std::cos(psi);
      const double sth = std::sin(th), cth = std::cos(th);
      const double sph = std::sin(ph), cph = std::cos(ph);
      const double tth = std::tan(th);
      xd[0] = vx * cps * cth + vy * (sph * sth * cps - sps * cph) +
              vz * (sph * sps + sth * cph * cps);
      xd[1] = vx * sps * cth + vy * (sph * sps * sth + cph * cps) +
              vz * (-sph * cps + sps * sth * cph);
      xd[2] = -vx * sth + vy * sph * cth + vz * cph * cth;
      xd[3] = wy * sph / cth + wz * cph / cth;
      xd[4] = wy * cph - wz * sph;
      xd[5] = wx + wy * sph * tth + wz * cph * tth;
      xd[6] = vy * wz - vz * wy + kGravity * sth;
      xd[7] = -vx * wz + vz * wx - kGravity * sph * cth;
      xd[8] = kQ12InvMass * u[3] + vx * wy - vy * wx - kGravity * cph * cth;
      xd[9] = kQ12InvIxx * u[0] - kQ12CoupX * wy * wz;
      xd[10] = kQ12InvIyy * u[1] + kQ12CoupY * wx * wz;
      xd[11] = kQ12InvIzz * u[2] - kQ12CoupZ * wx * wy;
      break;
    }
    case kBike5D:
      xd[0] = x[2] * std::cos(x[3]);
      xd[1] = x[2] * std::sin(x[3]);
      xd[2] = u[0];
      xd[3] = x[2] * std::tan(x[4]);
      xd[4] = u[1];
      break;
    default:
      break;
  }
}

// Continuous Jacobians dxd/dx (Ac: nx*nx) and dxd/du (Bc: nx*nu), row-major.
// Buffers are pre-zeroed; only nonzeros are written.
void jac(int model, const double* x, const double* u, double* Ac, double* Bc) {
  const int nx = kModels[model].nx;
  const int nu = kModels[model].nu;
  auto A = [&](int r, int c) -> double& { return Ac[r * nx + c]; };
  auto B = [&](int r, int c) -> double& { return Bc[r * nu + c]; };
  switch (model) {
    case kDoubleInt4D:
      A(0, 2) = 1;
      A(1, 3) = 1;
      B(2, 0) = 1;
      B(3, 1) = 1;
      break;
    case kDoubleInt6D:
      for (int i = 0; i < 3; ++i) {
        A(i, i + 3) = 1;
        B(i + 3, i) = 1;
      }
      break;
    case kCar3D:
      A(0, 2) = -u[0] * std::sin(x[2]);
      A(1, 2) = u[0] * std::cos(x[2]);
      B(0, 0) = std::cos(x[2]);
      B(1, 0) = std::sin(x[2]);
      B(2, 1) = 1;
      break;
    case kUnicycle4D:
      A(0, 2) = std::cos(x[3]);
      A(0, 3) = -x[2] * std::sin(x[3]);
      A(1, 2) = std::sin(x[3]);
      A(1, 3) = x[2] * std::cos(x[3]);
      B(2, 0) = 1;
      B(3, 1) = 1;
      break;
    case kHuman6D:
      A(0, 3) = std::cos(u[0]);
      A(1, 3) = std::sin(u[0]);
      B(0, 0) = -x[3] * std::sin(u[0]);
      B(1, 0) = x[3] * std::cos(u[0]);
      B(3, 1) = 1;
      break;
    case kHumanLin6D:
      A(0, 3) = 1;
      A(1, 4) = 1;
      B(3, 0) = 1;
      B(4, 1) = 1;
      break;
    case kQuad6D: {
      const double t1 = std::tan(u[1]), t2 = std::tan(u[2]);
      A(0, 3) = 1;
      A(1, 4) = 1;
      A(2, 5) = 1;
      B(3, 2) = kGravity * (t2 * t2 + 1.0);
      B(4, 1) = -kGravity * (t1 * t1 + 1.0);
      B(5, 0) = 1;
      break;
    }
    case kQuad12D: {
      const double psi = x[3], th = x[4], ph = x[5];
      const double vx = x[6], vy = x[7], vz = x[8];
      const double wx = x[9], wy = x[10], wz = x[11];
      const double sps = std::sin(psi), cps = std::cos(psi);
      const double sth = std::sin(th), cth = std::cos(th);
      const double sph = std::sin(ph), cph = std::cos(ph);
      const double tth = std::tan(th);
      // Rotation-matrix columns and their angle derivatives.
      const double r00 = cps * cth;
      const double r01 = sph * sth * cps - sps * cph;
      const double r02 = sph * sps + sth * cph * cps;
      const double r10 = sps * cth;
      const double r11 = sph * sps * sth + cph * cps;
      const double r12 = -sph * cps + sps * sth * cph;
      // Row 0: d(world vx)
      A(0, 3) = -vx * r10 - vy * r11 - vz * r12;
      A(0, 4) = -vx * sth * cps + vy * sph * cps * cth + vz * cph * cps * cth;
      A(0, 5) = vy * r02 - vz * r01;
      A(0, 6) = r00;
      A(0, 7) = r01;
      A(0, 8) = r02;
      // Row 1: d(world vy)
      A(1, 3) = vx * r00 + vy * r01 + vz * r02;
      A(1, 4) = -vx * sps * sth + vy * sph * sps * cth + vz * sps * cph * cth;
      A(1, 5) = vy * (-sph * cps + sps * sth * cph) -
                vz * (sph * sps * sth + cph * cps);
      A(1, 6) = r10;
      A(1, 7) = r11;
      A(1, 8) = r12;
      // Row 2: d(world vz)
      A(2, 4) = -vx * cth - vy * sph * sth - vz * sth * cph;
      A(2, 5) = vy * cph * cth - vz * sph * cth;
      A(2, 6) = -sth;
      A(2, 7) = sph * cth;
      A(2, 8) = cph * cth;
      // Row 3: d(psi_dot)
      A(3, 4) = (wy * sph * sth + wz * sth * cph) / (cth * cth);
      A(3, 5) = (wy * cph - wz * sph) / cth;
      A(3, 10) = sph / cth;
      A(3, 11) = cph / cth;
      // Row 4: d(theta_dot)
      A(4, 5) = -wy * sph - wz * cph;
      A(4, 10) = cph;
      A(4, 11) = -sph;
      // Row 5: d(phi_dot)
      A(5, 4) = (tth * tth + 1.0) * (wy * sph + wz * cph);
      A(5, 5) = (wy * cph - wz * sph) * tth;
      A(5, 9) = 1;
      A(5, 10) = sph * tth;
      A(5, 11) = cph * tth;
      // Rows 6-8: body-frame accelerations
      A(6, 4) = kGravity * cth;
      A(6, 7) = wz;
      A(6, 8) = -wy;
      A(6, 10) = -vz;
      A(6, 11) = vy;
      A(7, 4) = kGravity * sph * sth;
      A(7, 5) = -kGravity * cph * cth;
      A(7, 6) = -wz;
      A(7, 8) = wx;
      A(7, 9) = vz;
      A(7, 11) = -vx;
      A(8, 4) = kGravity * sth * cph;
      A(8, 5) = kGravity * sph * cth;
      A(8, 6) = wy;
      A(8, 7) = -wx;
      A(8, 9) = -vy;
      A(8, 10) = vx;
      // Rows 9-11: angular accelerations (gyroscopic couplings)
      A(9, 10) = -kQ12CoupX * wz;
      A(9, 11) = -kQ12CoupX * wy;
      A(10, 9) = kQ12CoupY * wz;
      A(10, 11) = kQ12CoupY * wx;
      A(11, 9) = -kQ12CoupZ * wy;
      A(11, 10) = -kQ12CoupZ * wx;
      B(8, 3) = kQ12InvMass;
      B(9, 0) = kQ12InvIxx;
      B(10, 1) = kQ12InvIyy;
      B(11, 2) = kQ12InvIzz;
      break;
    }
    case kBike5D: {
      const double tphi = std::tan(x[4]);
      A(0, 2) = std::cos(x[3]);
      A(0, 3) = -x[2] * std::sin(x[3]);
      A(1, 2) = std::sin(x[3]);
      A(1, 3) = x[2] * std::cos(x[3]);
      A(3, 2) = tphi;
      A(3, 4) = x[2] * (tphi * tphi + 1.0);
      B(2, 0) = 1;
      B(4, 1) = 1;
      break;
    }
    default:
      break;
  }
}

constexpr int kMaxNx = 12;

// One classic RK4 step of size dh on the first nx components.
void rk4_substep(int model, double* x, const double* u, double dh, int nx) {
  double k0[kMaxNx] = {0}, k1[kMaxNx] = {0}, k2[kMaxNx] = {0},
         k3[kMaxNx] = {0}, tmp[kMaxNx];
  rhs(model, x, u, k0);
  for (int i = 0; i < nx; ++i) tmp[i] = x[i] + 0.5 * dh * k0[i];
  rhs(model, tmp, u, k1);
  for (int i = 0; i < nx; ++i) tmp[i] = x[i] + 0.5 * dh * k1[i];
  rhs(model, tmp, u, k2);
  for (int i = 0; i < nx; ++i) tmp[i] = x[i] + dh * k2[i];
  rhs(model, tmp, u, k3);
  for (int i = 0; i < nx; ++i)
    x[i] += dh * (k0[i] + 2.0 * k1[i] + 2.0 * k2[i] + k3[i]) / 6.0;
}

}  // namespace

extern "C" {

int bbdyn_num_models() { return kNumModels; }

int bbdyn_model_dims(int model, int* nx, int* nu, int* substeps) {
  if (model < 0 || model >= kNumModels) return -1;
  *nx = kModels[model].nx;
  *nu = kModels[model].nu;
  *substeps = kModels[model].substeps;
  return 0;
}

// Batched continuous dynamics: x (n, nx_p), u (n, nu_p) -> xd (n, nx_p).
int bbdyn_f(const int32_t* models, int n, int nx_p, int nu_p,
            const double* x, const double* u, double* xd) {
  std::memset(xd, 0, sizeof(double) * n * nx_p);
  for (int a = 0; a < n; ++a) {
    const int m = models[a];
    if (m < 0 || m >= kNumModels) return -1;
    rhs(m, x + a * nx_p, u + a * nu_p, xd + a * nx_p);
  }
  return 0;
}

// Batched RK4 step over dt (per-model substeps); padding passes through.
int bbdyn_step(const int32_t* models, int n, int nx_p, int nu_p,
               const double* x, const double* u, double dt, double* x_out) {
  for (int a = 0; a < n; ++a) {
    const int m = models[a];
    if (m < 0 || m >= kNumModels) return -1;
    const ModelInfo& info = kModels[m];
    double* xa = x_out + a * nx_p;
    std::memcpy(xa, x + a * nx_p, sizeof(double) * nx_p);
    const double dh = dt / info.substeps;
    for (int s = 0; s < info.substeps; ++s)
      rk4_substep(m, xa, u + a * nu_p, dh, info.nx);
  }
  return 0;
}

// Batched Euler-discretized Jacobians in padded layout:
// A (n, nx_p, nx_p) = I + dt * Ac (identity in padding), B (n, nx_p, nu_p).
int bbdyn_linearize(const int32_t* models, int n, int nx_p, int nu_p,
                    const double* x, const double* u, double dt,
                    double* A_out, double* B_out) {
  double Ac[kMaxNx * kMaxNx], Bc[kMaxNx * kMaxNx];
  std::memset(A_out, 0, sizeof(double) * n * nx_p * nx_p);
  std::memset(B_out, 0, sizeof(double) * n * nx_p * nu_p);
  for (int a = 0; a < n; ++a) {
    const int m = models[a];
    if (m < 0 || m >= kNumModels) return -1;
    const int nx = kModels[m].nx;
    const int nu = kModels[m].nu;
    std::memset(Ac, 0, sizeof(double) * nx * nx);
    std::memset(Bc, 0, sizeof(double) * nx * nu);
    jac(m, x + a * nx_p, u + a * nu_p, Ac, Bc);
    double* A = A_out + a * nx_p * nx_p;
    double* B = B_out + a * nx_p * nu_p;
    for (int r = 0; r < nx_p; ++r) A[r * nx_p + r] = 1.0;
    for (int r = 0; r < nx; ++r)
      for (int c = 0; c < nx; ++c) A[r * nx_p + c] += dt * Ac[r * nx + c];
    for (int r = 0; r < nx; ++r)
      for (int c = 0; c < nu; ++c) B[r * nu_p + c] = dt * Bc[r * nu + c];
  }
  return 0;
}

}  // extern "C"
