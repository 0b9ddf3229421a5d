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
// Above 64 rows the inputs of a column no longer fit in registers, so the
// outputs are taken in chunks instead (gossip_mix_wide_kernel): a block owns
// 64 output rows (blockIdx.y) of 256 columns, one column a thread, and keeps
// the 64 running sums of its column in registers.  The k inputs stream
// through in order, 64 at a time, with the matching 64 x 64 block of W in
// shared memory, so each input is read once per chunk of outputs: k*P*4
// bytes times ceil(k/64), plus the k*P*4 written.  At k/4 operations per
// byte such cohorts are bound by operations, and the unfused multiply and
// add (below) issue twice the instructions an FMA would.
//
// Each output is summed in the fixed order j = 0..k-1, each product and
// each sum rounded on its own (__fmul_rn / __fadd_rn, never an FMA), which
// is what the plain version (ref.gossip_mix_ref) does: the two agree
// bitwise on the card.
#include "common.cuh"

namespace {

constexpr int kMaxK = 64;  // rows of the register kernel; the wide kernel above it
constexpr int kLoads = 8;  // inputs the wide kernel has in flight per thread

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

// k > kMaxK: out rows i0 .. i0+63 (i0 = 64*blockIdx.y) of one column a thread
__global__ void __launch_bounds__(rt::kThreads)
gossip_mix_wide_kernel(const float* __restrict__ w, const float* __restrict__ x,
                       float* __restrict__ out, int k, long long P) {
  // w_s[j][i] = W[i0 + i, j0 + j], zeros past k: input j's 64 weights are one
  // row, read as 16-byte broadcasts (rows padded by 4 floats)
  __shared__ __align__(16) float w_s[kMaxK][kMaxK + 4];
  const int i0 = blockIdx.y * kMaxK;
  const int ni = k - i0 < kMaxK ? k - i0 : kMaxK;
  const long long col = static_cast<long long>(blockIdx.x) * rt::kThreads + threadIdx.x;
  const bool live = col < P;  // no early return: every thread meets the barriers

  float acc[kMaxK];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < k; j0 += kMaxK) {
    const int nj = k - j0 < kMaxK ? k - j0 : kMaxK;
    __syncthreads();  // the previous chunk of W is no longer read
    for (int t = threadIdx.x; t < kMaxK * kMaxK; t += rt::kThreads) {
      const int i = t / kMaxK, j = t % kMaxK;
      w_s[j][i] = i < ni && j < nj ? w[static_cast<long long>(i0 + i) * k + j0 + j] : 0.f;
    }
    __syncthreads();
    // kLoads inputs loaded ahead, then used in order j = 0, 1, ...
#pragma unroll 1
    for (int jb = 0; jb < nj; jb += kLoads) {
      float xs[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        xs[u] = live && jb + u < nj ? __ldg(x + static_cast<long long>(j0 + jb + u) * P + col)
                                    : 0.f;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (jb + u >= nj) break;
        const float4* wj = reinterpret_cast<const float4*>(w_s[jb + u]);
#pragma unroll
        for (int i = 0; i < kMaxK / 4; ++i) {
          const float4 w4 = wj[i];
          acc[4 * i] = __fadd_rn(acc[4 * i], __fmul_rn(w4.x, xs[u]));
          acc[4 * i + 1] = __fadd_rn(acc[4 * i + 1], __fmul_rn(w4.y, xs[u]));
          acc[4 * i + 2] = __fadd_rn(acc[4 * i + 2], __fmul_rn(w4.z, xs[u]));
          acc[4 * i + 3] = __fadd_rn(acc[4 * i + 3], __fmul_rn(w4.w, xs[u]));
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    if (i < ni) out[static_cast<long long>(i0 + i) * P + col] = acc[i];
}

}  // namespace

// vec: P % 4 == 0 and every row start 16-byte aligned (so 8-byte too).
RT_EXPORT int rt_gossip_mix(const float* w, const float* x, float* out, int k, long long P,
                            int vec, void* stream) {
  if (k <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k <= 8) {
    e = launch<8, 4>(w, x, out, k, P, vec, s);
  } else if (k <= 16) {
    e = launch<16, 4>(w, x, out, k, P, vec, s);
  } else if (k <= 32) {
    e = launch<32, 2>(w, x, out, k, P, vec, s);
  } else if (k <= kMaxK) {
    e = launch<64, 1>(w, x, out, k, P, vec, s);
  } else {
    const long long blocks = (P + rt::kThreads - 1) / rt::kThreads;
    const int chunks = (k + kMaxK - 1) / kMaxK;
    if (blocks > 0x7fffffffll || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
    gossip_mix_wide_kernel<<<dim3(static_cast<unsigned>(blocks), chunks), rt::kThreads, 0, s>>>(
        w, x, out, k, P);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}
