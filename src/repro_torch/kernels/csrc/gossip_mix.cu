// gossip_mix: out = W @ X, one gossip mixing pass over the cohort's rows
//
//   out[i, p] = sum_{j=0..k-1} W[i, j] * X[j, p]     W: (k, k), X: (k, P) float32
//
// Replaces the Pallas TPU kernel gossip_mix / _gossip_kernel in
// src/repro/kernels/gossip_mix.py (called once per mixing step from
// repro.topo.gossip.mix_rows).
//
// Bound: bytes.  It reads k*P*4 bytes of X and writes k*P*4 of out, with
// 2*k*k*P operations: k/4 operations per byte, about 2.5 at the cohort of
// 10, far below the card's balance point.  So it is written as a streaming
// weighted sum and not as a matrix product: the grid runs over P, W sits in
// shared memory once per block, and each thread owns C consecutive columns.
// A thread loads the k inputs of its columns into registers (one C-wide
// load per row), then computes and writes the k outputs, so X is read once
// and out written once, and neighbouring threads touch neighbouring
// addresses.  KMAX, the register budget per column, is a template
// parameter: rt_gossip_mix takes the smallest of 8, 16, 32 and 64 that holds
// k, and C = 4, 4, 2, 1 keeps KMAX*C <= 64 registers of inputs.  A ragged
// P, or rows that are not 16-byte aligned, take the scalar loads.
//
// Each output is summed in the fixed order j = 0..k-1, each product and
// each sum rounded on its own (__fmul_rn / __fadd_rn, never an FMA), which
// is what the plain version (ref.gossip_mix_ref) does: the two agree
// bitwise on the card.
#include "common.cuh"

namespace {

constexpr int kMaxK = 64;  // ops.GOSSIP_MAX_K: the wrapper raises above it

template <int C>
__device__ __forceinline__ void load_cols(const float* __restrict__ src, float* v) {
  if constexpr (C == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(src);
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* __restrict__ dst, const float* v) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

template <int KMAX, int C>
__global__ void __launch_bounds__(rt::kThreads)
gossip_mix_kernel(const float* __restrict__ w, const float* __restrict__ x,
                  float* __restrict__ out, int k, long long P, int vec) {
  __shared__ float w_s[KMAX * KMAX];
  for (int t = threadIdx.x; t < k * k; t += rt::kThreads) w_s[t] = w[t];
  __syncthreads();

  const long long col = (static_cast<long long>(blockIdx.x) * rt::kThreads + threadIdx.x) * C;
  if (col >= P) return;
  const int n = P - col < C ? static_cast<int>(P - col) : C;  // valid columns here
  const bool wide = vec && n == C;

  float xs[KMAX][C];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j >= k) break;
    const float* src = x + j * P + col;
    if (wide) {
      load_cols<C>(src, xs[j]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) xs[j][c] = c < n ? __ldg(src + c) : 0.f;
    }
  }

#pragma unroll 1
  for (int i = 0; i < k; ++i) {
    const float* wi = w_s + i * k;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j >= k) break;
      const float wij = wi[j];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(wij, xs[j][c]));
    }
    float* dst = out + i * P + col;
    if (wide) {
      store_cols<C>(dst, acc);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c < n) dst[c] = acc[c];
    }
  }
}

template <int KMAX, int C>
cudaError_t launch(const float* w, const float* x, float* out, int k, long long P, int vec,
                   cudaStream_t s) {
  const long long groups = (P + C - 1) / C;
  const long long blocks = (groups + rt::kThreads - 1) / rt::kThreads;
  gossip_mix_kernel<KMAX, C><<<static_cast<unsigned>(blocks), rt::kThreads, 0, s>>>(
      w, x, out, k, P, vec);
  return cudaGetLastError();
}

}  // namespace

// vec: P % 4 == 0 and every row start 16-byte aligned (so 8-byte too).
RT_EXPORT int rt_gossip_mix(const float* w, const float* x, float* out, int k, long long P,
                            int vec, void* stream) {
  if (k <= 0 || k > kMaxK || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k <= 8) {
    e = launch<8, 4>(w, x, out, k, P, vec, s);
  } else if (k <= 16) {
    e = launch<16, 4>(w, x, out, k, P, vec, s);
  } else if (k <= 32) {
    e = launch<32, 2>(w, x, out, k, P, vec, s);
  } else {
    e = launch<64, 1>(w, x, out, k, P, vec, s);
  }
  return static_cast<int>(e);
}
