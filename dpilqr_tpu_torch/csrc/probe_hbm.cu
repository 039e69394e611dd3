// Ceiling probe: streaming read bandwidth of device memory.
//
// Replaces the TPU kernel dpilqr_tpu/utils/sol.py :: measure_hbm_stream_gbps
// (the Pallas program at :257-268): it reads a (T, m) float32 array once (the
// probe's default is T = 256 slabs of m = 512 * 512 values, 256 MB) and
// reduces it over its leading axis into out (m), so out equals x.sum(0).
// Only the bytes read are counted, T * m * 4 (dpilqr_tpu/utils/sol.py:297).
//
// What bounds it on the H100: bytes.  One add per 4 bytes read is far below
// the FMA rate, and 256 MB is five times the 50 MB L2, so every read comes
// from HBM.  Design: each thread owns four neighbouring output values and
// walks the T slabs with one 128-bit load per slab, so a warp reads 512
// contiguous bytes per slab and no two threads share an output: no atomics,
// no second pass.  The slab loop is unrolled sixteen times with the loads ahead
// of the adds, which keeps 256 bytes a thread in flight; a grid-stride loop
// over the output covers any m that is a multiple of four.  The TPU
// kernel's sequential grid with an accumulator carried in fast memory has
// no counterpart here: blocks run in any order, so the T loop sits inside
// the thread.
//
// Layouts (contiguous, 16-byte aligned): x (T, m) float32 -> out (m) float32,
// m a multiple of 4.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS) probe_hbm_kernel(
    const float4* __restrict__ x, float4* __restrict__ out, int T,
    long long m4) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < m4;
       j += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int t = 0;
    for (; t + UNROLL <= T; t += UNROLL) {
      float4 v[UNROLL];
#pragma unroll
      for (int r = 0; r < UNROLL; ++r) v[r] = __ldg(x + (long long)(t + r) * m4 + j);
#pragma unroll
      for (int r = 0; r < UNROLL; ++r) {
        acc.x += v[r].x; acc.y += v[r].y; acc.z += v[r].z; acc.w += v[r].w;
      }
    }
    for (; t < T; ++t) {
      const float4 v = __ldg(x + (long long)t * m4 + j);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    out[j] = acc;
  }
}

}  // namespace

extern "C" int dpilqr_probe_hbm_f32(const float* x, float* out, int T,
                                    long long m, void* stream) {
  if (m % 4 != 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const long long m4 = m / 4;
  long long blocks = (m4 + THREADS - 1) / THREADS;
  if (blocks > 65536) blocks = 65536;  // the grid-stride loop covers the rest
  probe_hbm_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), T,
      m4);
  return (int)cudaGetLastError();
}
