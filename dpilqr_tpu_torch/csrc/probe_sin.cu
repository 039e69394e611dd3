// Ceiling probe: float32 sine evaluation rate, as the forward kernels pay it.
//
// Replaces the TPU kernel dpilqr_tpu/utils/sol.py ::
// measure_vpu_transcendental_ops (the Pallas program at :310-326): from each
// input element a it derives b = a * 0.99, c = a * 1.01 and d = a * 0.98,
// runs `iters` iterations of four independent chains v = sin(v) unrolled
// four times (16 sines an iteration), and stores (a + b) + (c + d).  The
// evaluations counted are 16 * elements * iters.
//
// What bounds it on the H100: operations.  The data stays in registers (4
// bytes in and out per element against 16 * iters sines).  The sine is
// d_sin of dynamics.cuh, the function the forward kernels (forward_batched.cu,
// forward_sweep.cu) call for their models' headings: sinf, the accurate
// software routine (argument reduction and a polynomial on the FMA pipes),
// not the special-function unit's __sinf.  So the rate measured here is the
// one those kernels pay per transcendental.  Design: as probe_fma.cu, one
// thread per element with four independent chains in registers; `iters` is
// a kernel argument and the final store keeps the loop alive.
//
// Layouts (contiguous): x (n) float32 -> out (n) float32.

#include "dynamics.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) probe_sin_kernel(
    const float* __restrict__ x, float* __restrict__ out, long long n,
    int iters) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  float b = a * 0.99f;
  float c = a * 1.01f;
  float d = a * 0.98f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a = d_sin(a);
      b = d_sin(b);
      c = d_sin(c);
      d = d_sin(d);
    }
  }
  out[i] = (a + b) + (c + d);
}

}  // namespace

extern "C" int dpilqr_probe_sin_f32(const float* x, float* out, long long n,
                                    int iters, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  probe_sin_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, out, n, iters);
  return (int)cudaGetLastError();
}
