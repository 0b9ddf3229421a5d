// flash_attention: online-softmax attention with GQA, causal mask, sliding
// window and tanh logit cap
//
//   out[b, t, h] = sum_s softmax_s(score(t, s)) * v[b, s, h / G]
//   score(t, s) = cap * tanh((q[b, t, h] . k[b, s, h / G]) * hd^-0.5 / cap)
//   over the keys with s < S, s <= t (causal) and s > t - window
//
// q: (B, T, H, hd), k and v: (B, S, K, hd), G = H / K, float32 or bfloat16,
// read through their strides (the last one 1, the others and the base
// pointers 16-byte aligned); out: (B, T, H, hd)
// contiguous, in q's dtype.  hd is one of 32, 48, 64, 80, 128, 256.
//
// Replaces the Pallas TPU kernel flash_attention_bh / _attn_kernel in
// src/repro/kernels/flash_attention.py (wrapper repro.kernels.ops
// .flash_attention), reached from attention_forward(..., use_flash=True).
// It computes what _attn_kernel computes, not block for block: per query
// row a running (m, l, acc) over key tiles, masked scores set to -1e30,
// p zeroed on a tile that leaves the row no key, corr = exp(m_prev - m_new)
// only where the row has a key, and out = acc / max(l, 1e-30).  So a row
// with no valid key gives zeros, as the Pallas kernel's does.  Unlike the
// TPU wrapper it does not pad hd to 128 or pre-scale q: the scale is applied
// in float32 after the dot, as in the plain version (ref.flash_attention_ref).
//
// Bound: operations.  Causal attention at qwen2-0.5b's layer shape does
// about 0.44*T FLOPs per byte of q, k, v and out (1,792 at T = 4096), far
// above the card's balance point of about 295.
//
// Two designs, chosen by (dtype, hd) before the launch (the wrapper's
// ops.flash_design is the rule; a launch never falls back to the other):
//  - wgmma (flash_wgmma.cuh): bf16 at hd 64, 80, 128 and 256.  Tensor-core
//    products, TMA loads into an mbarrier ring, a producer warpgroup and two
//    consumer warpgroups; its header says how it keeps the plain version's
//    float32 precision.
//  - CUDA core (this file): float32 inputs, and bf16 at hd 32 and 48.
//    Every product runs in float32 on the CUDA cores.  A block of 256
//    threads owns 64 query rows of one (b, h); Q, a 64-key tile of K and of
//    V, and the tile's probabilities sit in shared memory, and each block
//    walks the key tiles in order, skipping the tiles the causal mask or the
//    window removes entirely.  Thread (ty, tx) of a 16 x 16 grid owns rows
//    4*ty..4*ty+3: key columns tx + 16*j of the score tile (4 x 4 registers)
//    and output columns tx + 16*n (4 x hd/16 registers).  The 16 threads of
//    a row group are 16 lanes of one warp, so row max and row sum are warp
//    shuffles.  Rows of the shared tiles are padded by 4 floats so the
//    float4 reads of neighbouring rows fall in distinct banks.  The q tiles
//    run in reverse order, so that under a causal mask the longest blocks
//    start first.
#include <cuda_bf16.h>

#include "common.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kFAThreads = 256;  // 16 x 16
constexpr int kPad = 4;          // floats of padding per shared row
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile moves tiles of kBK rows, for Q too");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, T, S, H, K;
  long long qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2;
  int causal, window;  // window <= 0: none
  float scale, cap;         // cap <= 0: none
};

__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

// 16 bytes of a row: 4 float32 or 8 bfloat16 values, as floats
__device__ __forceinline__ void load16(const float* src, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}

// Rows row0..row0+63 of one head of a (B, L, heads, hd) tensor into a
// float32 shared tile with row stride HD + kPad; rows at or past L are zeros.
// src points at [b, 0, head, 0]; row r lies at src + r * s_row.  src and
// s_row are 16-byte aligned (the wrapper checks), so rows load 16 bytes at a time.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long s_row, int row0, int L) {
  constexpr int LD = HD + kPad;
  constexpr int E = 16 / sizeof(T);
  constexpr int PER_ROW = HD / E;
  for (int i = threadIdx.x; i < kBK * PER_ROW; i += kFAThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * E;
    float x[E];
    if (row0 + r < L) {
      load16(src + (row0 + r) * s_row + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * LD + c);
#pragma unroll
    for (int e = 0; e < E; e += 4) d[e / 4] = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFAThreads)
flash_attention_kernel(const Params p) {
  constexpr int LD = HD + kPad, LDP = kBK + kPad, NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* qh = static_cast<const T*>(p.q) + b * p.qs0 + h * p.qs2;
  const T* kh = static_cast<const T*>(p.k) + b * p.ks0 + kvh * p.ks2;
  const T* vh = static_cast<const T*>(p.v) + b * p.vs0 + kvh * p.vs2;
  load_tile<T, HD>(Qs, qh, p.qs1, q0, p.T);

  // keys the mask can leave to rows q0..q0+63: s <= t under causal, s > t - window
  int kv_end = p.S;
  if (p.causal) kv_end = min(kv_end, q0 + kBQ);
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  kv_begin -= kv_begin % kBK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done with Ks, Vs and Ps
    load_tile<T, HD>(Ks, kh, p.ks1, k0, p.S);
    load_tile<T, HD>(Vs, vh, p.vs1, k0, p.S);
    __syncthreads();

    // scores of rows 4*ty+i against keys k0 + tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // mask, cap and the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
      float mx = kNegInf;
      int any = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = key < p.S && (!p.causal || key <= t) &&
                        (p.window <= 0 || key > t - p.window);
        float x = s[i][j] * p.scale;
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        s[i][j] = ok ? x : kNegInf;
        any |= ok;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {  // the 16 lanes of this row group
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        any |= __shfl_xor_sync(0xffffffffu, any, off);
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = any ? expf(s[i][j] - m_new) : 0.f;
        Ps[(4 * ty + i) * LDP + tx + 16 * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = any ? expf(m[i] - m_new) : 1.f;
      l[i] = corr * l[i] + sum;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    // acc += P V for rows 4*ty+i and output columns tx + 16*n
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * LDP + c);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float* vc = Vs + c * LD + tx + 16 * n;
        const float v0 = vc[0], v1 = vc[LD], v2 = vc[2 * LD], v3 = vc[3 * LD];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][n];
          a = fmaf(pv[i].x, v0, a);
          a = fmaf(pv[i].y, v1, a);
          a = fmaf(pv[i].z, v2, a);
          acc[i][n] = fmaf(pv[i].w, v3, a);
        }
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= p.T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = out + ((static_cast<long long>(b) * p.T + t) * p.H + h) * HD;
#pragma unroll
    for (int n = 0; n < NC; ++n) from_f32(row + tx + 16 * n, acc[i][n] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int LD = HD + kPad;
  constexpr size_t smem = sizeof(float) * (kBQ * LD + 2 * kBK * LD + kBQ * (kBK + kPad));
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + kBQ - 1) / kBQ, p.H, p.B);
  flash_attention_kernel<T, HD><<<grid, kFAThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// float32 at every head dim; bf16 only where the wgmma design does not run
cudaError_t dispatch_f32(const Params& p, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<float, 32>(p, s);
    case 48: return launch<float, 48>(p, s);
    case 64: return launch<float, 64>(p, s);
    case 80: return launch<float, 80>(p, s);
    case 128: return launch<float, 128>(p, s);
    case 256: return launch<float, 256>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const Params& p, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<__nv_bfloat16, 32>(p, s);
    case 48: return launch<__nv_bfloat16, 48>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements.  Every base pointer must be 16-byte aligned and
// every stride a multiple of 16 bytes: rows load 16 bytes at a time, and TMA
// requires it.  wgmma != 0 launches the tensor-core design, which takes bf16
// at hd 64, 80, 128 and 256 only; the CUDA-core design takes float32 at
// every head dim and bf16 at hd 32 and 48.  Returns 0, a cudaError_t, or minus the
// CUresult of a failed tensor-map encode.
RT_EXPORT int rt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                 int B, int T, int S, int H, int K, int hd,
                                 long long qs0, long long qs1, long long qs2,
                                 long long ks0, long long ks1, long long ks2,
                                 long long vs0, long long vs1, long long vs2,
                                 int causal, int window, float scale, float cap, int bf16,
                                 int wgmma, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || S < 0 || H <= 0 || H > 65535 || K <= 0 || H % K)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
    const long long qs[3] = {qs0, qs1, qs2}, ks[3] = {ks0, ks1, ks2}, vs[3] = {vs0, vs1, vs2};
    switch (hd) {
      case 64: return flash_wgmma::launch<64>(q, k, v, out, B, T, S, H, K, qs, ks, vs, causal,
                                              window, scale, cap, s);
      case 80: return flash_wgmma::launch<80>(q, k, v, out, B, T, S, H, K, qs, ks, vs, causal,
                                              window, scale, cap, s);
      case 128: return flash_wgmma::launch<128>(q, k, v, out, B, T, S, H, K, qs, ks, vs, causal,
                                                window, scale, cap, s);
      case 256: return flash_wgmma::launch<256>(q, k, v, out, B, T, S, H, K, qs, ks, vs, causal,
                                                window, scale, cap, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Params p{q, k, v, out, B, T, S, H, K, qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2,
                 causal, window, scale, cap};
  const cudaError_t e = bf16 ? dispatch_bf16(p, hd, s) : dispatch_f32(p, hd, s);
  return static_cast<int>(e);
}

// Dynamic shared memory of the tensor-core design's block at head dim hd
// (0 where it has no instantiation).
RT_EXPORT int rt_flash_wgmma_smem(int hd) {
  switch (hd) {
    case 64: return flash_wgmma::Tile<64>::SMEM;
    case 80: return flash_wgmma::Tile<80>::SMEM;
    case 128: return flash_wgmma::Tile<128>::SMEM;
    case 256: return flash_wgmma::Tile<256>::SMEM;
    default: return 0;
  }
}

// Q K^T of the tensor-core design alone (flash_wgmma_scores_kernel): q (1, T,
// 1, hd) and k (1, S, 1, hd) bf16 -> s_out (T, S) float32, the slices of hd
// summed as flash_attention sums them.  Returns as rt_flash_attention.
RT_EXPORT int rt_flash_wgmma_scores(const void* q, const void* k, float* s_out, int T, int S,
                                    int hd, long long qs0, long long qs1, long long qs2,
                                    long long ks0, long long ks1, long long ks2, void* stream) {
  const long long qs[3] = {qs0, qs1, qs2}, ks[3] = {ks0, ks1, ks2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using flash_wgmma::launch_scores;
  switch (hd) {
    case 64: return launch_scores<64>(q, k, s_out, T, S, qs, ks, s);
    case 80: return launch_scores<80>(q, k, s_out, T, S, qs, ks, s);
    case 128: return launch_scores<128>(q, k, s_out, T, S, qs, ks, s);
    case 256: return launch_scores<256>(q, k, s_out, T, S, qs, ks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
