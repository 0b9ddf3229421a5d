// staleness_agg: out[p] = sum_i w[i] * deltas[i, p]
//
// Replaces the Pallas TPU kernel staleness_aggregate / _staleness_kernel in
// src/repro/kernels/staleness_agg.py: the Eq. 6 weighted mean of the (k, P)
// float32 delta rows (RuntimeContext.weighted_sum), also the async buffer
// flush of later slices.
//
// Bound: bytes.  It reads k*P*4 bytes and writes P*4, with k multiply-adds
// per output: about 0.5 FLOP per byte, far below the card's balance point.
// Design: the grid runs over P; each thread owns 4 consecutive columns,
// loads them with one 16-byte load per row and loops over the k rows, so
// every row is read exactly once and neighbouring threads read neighbouring
// addresses.  The (k,) weights are broadcast loads through the read-only
// cache.  A ragged P, or one that is not a multiple of 4 (row starts then
// lose 16-byte alignment), takes the scalar branch.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(rt::kThreads)
staleness_agg_kernel(const float* __restrict__ d, const float* __restrict__ w,
                     float* __restrict__ out, int k, long long P, int vec) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * rt::kThreads + threadIdx.x) * 4;
  if (col >= P) return;
  if (vec) {  // P % 4 == 0 and 16-byte aligned rows: col..col+3 all valid
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < k; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(d + i * P + col));
      const float wi = __ldg(w + i);
      acc.x += wi * v.x;
      acc.y += wi * v.y;
      acc.z += wi * v.z;
      acc.w += wi * v.w;
    }
    *reinterpret_cast<float4*>(out + col) = acc;
  } else {
    const long long n = P - col < 4 ? P - col : 4;
    for (long long j = 0; j < n; ++j) {
      float acc = 0.f;
      for (int i = 0; i < k; ++i) acc += __ldg(w + i) * __ldg(d + i * P + col + j);
      out[col + j] = acc;
    }
  }
}

}  // namespace

RT_EXPORT int rt_staleness_agg(const float* d, const float* w, float* out, int k,
                               long long P, int vec, void* stream) {
  if (k <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  staleness_agg_kernel<<<static_cast<unsigned>(rt::col4_blocks(P)), rt::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(d, w, out, k, P, vec);
  return static_cast<int>(cudaGetLastError());
}
