// clip_quant_mask: per-row L2 clip, fixed-point encode and one-time pad.
//
//   scale_r = min(1, clip / max(||rows[r, :dim]||, 1e-12))
//   out[r,p] = uint32(int32(rint(clamp(rows[r,p] * scale_r, +-clip) * qscale))) + pad[r,p]
//
// Replaces the Pallas TPU kernel clip_quant_mask / _compress_kernel in
// src/repro/kernels/compress.py (FusedCompressStage on the DP path).
//
// Bound: bytes.  One read of the rows and the pads and one write of the
// ciphertext (3*k*P*4 bytes), a few operations per element.  The Pallas
// design keeps whole rows in VMEM, which caps it near 150k parameters; a
// ResNet-Tiny row is 18.8 MB and a block has 227 KB of shared memory.  So
// the norm is split out, in three deterministic launches and no atomics,
// over a (k, n_tiles + 1) double scratch:
//   1. norm_partials_kernel, grid (tile, row): the sum of squares of one
//      kNormTile-column tile of rows[r, :dim], accumulated in double and
//      reduced by a fixed-shape tree, into scratch[r, tile].
//   2. row_scale_kernel, one block per row: the row's partials, reduced in a
//      fixed order, give the norm and the scale, into scratch[r, n_tiles].
//   3. encode_kernel, grid (column block, row): each thread reads its row's
//      scale once and encodes 4 columns with 16-byte loads and stores.
// This reads the rows twice (4*k*P*4 bytes in all).  Double accumulation
// makes the norm the correctly rounded float32 of the exact one, which the
// plain version (ref.clip_quant_mask_ref) computes the same way.  The
// multiply, clamp, multiply sequence is built without FMA contraction
// (__fmul_rn here, and --fmad=false for this file) so each step rounds as
// the reference's float32 expression does; __float2int_rn rounds half to
// even like jnp.round / torch.round.
#include "common.cuh"

namespace {

constexpr int kNormTile = rt::kThreads * 4 * 8;  // columns of one row per norm block
constexpr int kWarps = rt::kThreads / 32;

// Sum of v over the block by a fixed tree (deterministic); valid in thread 0.
__device__ double block_sum(double v, double* smem) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kWarps ? smem[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(rt::kThreads)
norm_partials_kernel(const float* __restrict__ rows, double* __restrict__ scratch,
                     long long P, long long dim, long long n_tiles, int vec) {
  __shared__ double smem[kWarps];
  const int r = blockIdx.y;
  const float* row = rows + r * P;
  const long long start = static_cast<long long>(blockIdx.x) * kNormTile;
  const long long end = start + kNormTile < dim ? start + kNormTile : dim;
  double acc = 0.0;
  for (long long c = start + threadIdx.x * 4; c < end; c += rt::kThreads * 4) {
    if (vec && c + 3 < end) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + c));
      acc += static_cast<double>(v.x) * v.x;
      acc += static_cast<double>(v.y) * v.y;
      acc += static_cast<double>(v.z) * v.z;
      acc += static_cast<double>(v.w) * v.w;
    } else {
      const long long stop = c + 4 < end ? c + 4 : end;
      for (long long j = c; j < stop; ++j) {
        const double x = __ldg(row + j);
        acc += x * x;
      }
    }
  }
  const double s = block_sum(acc, smem);
  if (threadIdx.x == 0) scratch[r * (n_tiles + 1) + blockIdx.x] = s;
}

__global__ void __launch_bounds__(rt::kThreads)
row_scale_kernel(double* __restrict__ scratch, long long n_tiles, float clip) {
  __shared__ double smem[kWarps];
  double* row = scratch + blockIdx.x * (n_tiles + 1);
  double acc = 0.0;
  for (long long t = threadIdx.x; t < n_tiles; t += rt::kThreads) acc += row[t];
  const double total = block_sum(acc, smem);
  if (threadIdx.x == 0) {
    const float norm = static_cast<float>(sqrt(total));
    row[n_tiles] = fminf(1.0f, __fdiv_rn(clip, fmaxf(norm, 1e-12f)));  // exact in double
  }
}

__device__ __forceinline__ uint32_t encode1(float x, uint32_t pad, float scale, float clip,
                                            float qscale) {
  float v = __fmul_rn(x, scale);
  v = fminf(fmaxf(v, -clip), clip);
  v = __fmul_rn(v, qscale);
  return static_cast<uint32_t>(__float2int_rn(v)) + pad;  // uint32 add wraps mod 2^32
}

__global__ void __launch_bounds__(rt::kThreads)
encode_kernel(const float* __restrict__ rows, const uint32_t* __restrict__ masks,
              uint32_t* __restrict__ out, const double* __restrict__ scratch, long long P,
              long long n_tiles, float clip, float qscale, int vec) {
  const int r = blockIdx.y;
  const long long col =
      (static_cast<long long>(blockIdx.x) * rt::kThreads + threadIdx.x) * 4;
  if (col >= P) return;
  const float scale = static_cast<float>(__ldg(scratch + r * (n_tiles + 1) + n_tiles));
  const long long base = r * P + col;
  if (vec) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(rows + base));
    const uint4 m = __ldg(reinterpret_cast<const uint4*>(masks + base));
    *reinterpret_cast<uint4*>(out + base) =
        make_uint4(encode1(x.x, m.x, scale, clip, qscale), encode1(x.y, m.y, scale, clip, qscale),
                   encode1(x.z, m.z, scale, clip, qscale), encode1(x.w, m.w, scale, clip, qscale));
  } else {
    const long long n = P - col < 4 ? P - col : 4;
    for (long long j = 0; j < n; ++j)
      out[base + j] = encode1(__ldg(rows + base + j), __ldg(masks + base + j), scale, clip, qscale);
  }
}

}  // namespace

// Number of norm tiles per row: the wrapper sizes the (k, n_tiles + 1) scratch.
RT_EXPORT long long rt_clip_quant_mask_tiles(long long dim) {
  return (dim + kNormTile - 1) / kNormTile;
}

RT_EXPORT int rt_clip_quant_mask(const float* rows, const uint32_t* masks, uint32_t* out,
                                 double* scratch, int k, long long P, long long dim,
                                 float clip, float qscale, int vec, void* stream) {
  if (k <= 0 || k > 65535 || P <= 0 || dim <= 0 || dim > P)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = rt_clip_quant_mask_tiles(dim);
  norm_partials_kernel<<<dim3(static_cast<unsigned>(n_tiles), static_cast<unsigned>(k)),
                         rt::kThreads, 0, s>>>(rows, scratch, P, dim, n_tiles, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  row_scale_kernel<<<static_cast<unsigned>(k), rt::kThreads, 0, s>>>(scratch, n_tiles, clip);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_kernel<<<dim3(static_cast<unsigned>(rt::col4_blocks(P)), static_cast<unsigned>(k)),
                  rt::kThreads, 0, s>>>(rows, masks, out, scratch, P, n_tiles, clip, qscale,
                                        vec);
  return static_cast<int>(cudaGetLastError());
}
