// masked_agg: out[p] = f32(int32(sum_i masked[i,p] - sum_i masks[i,p] mod 2^32)) * inv_scale
//
// Replaces the Pallas TPU kernel masked_aggregate / _agg_kernel in
// src/repro/kernels/masked_agg.py: the secure-aggregation unmask and
// fixed-point decode of the (k, P) uint32 ciphertext and pad rows
// (PrivacyPipeline.aggregate on the secure-agg and DP paths).
//
// Bound: bytes.  It reads 2*k*P*4 bytes and writes P*4, with two integer
// adds per input pair.  Design: the layout of staleness_agg.cu.  Each thread
// owns 4 consecutive columns, reads 16 bytes of each of the 2k rows once, and
// keeps four uint32_t ring sums in registers: unsigned arithmetic wraps mod
// 2^32 by definition, so the sum is exact in any order.  The decode mirrors
// the Pallas kernel's arithmetic (a multiply by f32(1/scale), with the
// reciprocal rounded on the host), so the result is bitwise the reference's.
#include "common.cuh"

namespace {

__device__ __forceinline__ float decode(uint32_t total, float inv_scale) {
  return __fmul_rn(__int2float_rn(static_cast<int>(total)), inv_scale);
}

__global__ void __launch_bounds__(rt::kThreads)
masked_agg_kernel(const uint32_t* __restrict__ masked, const uint32_t* __restrict__ masks,
                  float* __restrict__ out, int k, long long P, float inv_scale, int vec) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * rt::kThreads + threadIdx.x) * 4;
  if (col >= P) return;
  if (vec) {
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 0; i < k; ++i) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(masked + i * P + col));
      const uint4 m = __ldg(reinterpret_cast<const uint4*>(masks + i * P + col));
      acc.x += a.x - m.x;
      acc.y += a.y - m.y;
      acc.z += a.z - m.z;
      acc.w += a.w - m.w;
    }
    *reinterpret_cast<float4*>(out + col) =
        make_float4(decode(acc.x, inv_scale), decode(acc.y, inv_scale),
                    decode(acc.z, inv_scale), decode(acc.w, inv_scale));
  } else {
    const long long n = P - col < 4 ? P - col : 4;
    for (long long j = 0; j < n; ++j) {
      uint32_t acc = 0u;
      for (int i = 0; i < k; ++i)
        acc += __ldg(masked + i * P + col + j) - __ldg(masks + i * P + col + j);
      out[col + j] = decode(acc, inv_scale);
    }
  }
}

}  // namespace

RT_EXPORT int rt_masked_agg(const uint32_t* masked, const uint32_t* masks, float* out,
                            int k, long long P, float inv_scale, int vec, void* stream) {
  if (k <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  masked_agg_kernel<<<static_cast<unsigned>(rt::col4_blocks(P)), rt::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(masked, masks, out, k, P,
                                                           inv_scale, vec);
  return static_cast<int>(cudaGetLastError());
}
