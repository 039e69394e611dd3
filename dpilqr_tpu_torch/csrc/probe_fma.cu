// Ceiling probe: float32 FMA issue rate of the CUDA cores.
//
// Replaces the TPU kernel dpilqr_tpu/utils/sol.py :: measure_vpu_peak_gflops
// (the Pallas program at :197-215): from each input element a it derives
// b = a * 1.0000001 + 0.0000003, c = a * 0.9999999 + 0.0000001 and
// d = b * 1.0000002 + 0.0000002, runs `iters` iterations of four
// independent chains v = v * m_v + c_v unrolled four times (16 fused
// multiply-adds an iteration), and stores (a + b) + (c + d).  The FLOPs
// counted are 4 * 8 * elements * iters (dpilqr_tpu/utils/sol.py:240).
//
// What bounds it on the H100: operations.  The data stays in registers, so
// the only traffic is 4 bytes in and 4 bytes out per element against
// 32 * iters FLOPs; the limit is the FMA pipes' issue rate (one warp
// instruction per cycle and SM sub-partition, four cycles of dependent
// latency).  Design: one thread per element with its four chain values in
// registers, so each warp always has four independent FMAs to issue, and at
// the default (256, 512) operand every SM holds about 31 warps, eight times
// what hiding the latency needs.  The eight chain constants and `iters`
// are kernel arguments, so the compiler cannot fold the loop, and the final
// store keeps it alive.
//
// Layouts (contiguous): x (n) float32 -> out (n) float32.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) probe_fma_kernel(
    const float* __restrict__ x, float* __restrict__ out, long long n,
    int iters, float ma, float ca, float mb, float cb, float mc, float cc,
    float md, float cd) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  float b = fmaf(a, 1.0000001f, 0.0000003f);
  float c = fmaf(a, 0.9999999f, 0.0000001f);
  float d = fmaf(b, 1.0000002f, 0.0000002f);
  // Unrolled further so that the loop's own counter and branch are a few
  // instructions in 128 FMAs.
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a = fmaf(a, ma, ca);
      b = fmaf(b, mb, cb);
      c = fmaf(c, mc, cc);
      d = fmaf(d, md, cd);
    }
  }
  out[i] = (a + b) + (c + d);
}

}  // namespace

extern "C" int dpilqr_probe_fma_f32(const float* x, float* out, long long n,
                                    int iters, float ma, float ca, float mb,
                                    float cb, float mc, float cc, float md,
                                    float cd, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  probe_fma_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, out, n, iters, ma, ca, mb, cb, mc, cc, md, cd);
  return (int)cudaGetLastError();
}
