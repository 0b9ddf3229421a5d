// The tensor-core design of flash_attention for Hopper: bf16 inputs, head
// dims 64, 80, 128 and 256.  Same function as the CUDA-core kernel in
// flash_attention.cu (see its header for the contract); this file holds the
// kernel and its host launch.
//
// A block owns 128 query rows of one (b, h) and has three warpgroups:
//  - warpgroup 0, the producer, gives up registers (setmaxnreg.dec) and one
//    of its threads issues TMA loads: the Q tile once, then each K and V
//    tile of the block's key range into a ring of 4 stages, guarded by
//    full (TMA landed) and empty (both consumers done) mbarriers;
//  - warpgroups 1 and 2, the consumers, take the registers
//    (setmaxnreg.inc) and own 64 query rows each.  Per key tile:
//    S = Q K^T by wgmma (Q and K K-major in swizzled shared memory), the
//    scale hd^-0.5, the cap and the mask applied in float32 on the
//    accumulator layout, the online softmax in registers (row max and row
//    sum over the 4 lanes that share a row), then the tile's P V by wgmma,
//    64 columns of hd at a time, with P from registers and V from shared
//    memory read MN-major (the transpose bit: no transposing copy).
//    The two consumers take turns on the tensor cores (named barriers), so
//    one's softmax runs under the other's products.
//
// Precision.  The plain version computes P V in float32.  P rounded once
// to bf16 errs by up to 2^-9 per weight, and P = P_hi + P_lo in two bf16
// pieces by up to about 2^-17; where the sum of p * v cancels to a small
// output, either is more than one bf16 ulp of that output.  So P is split
// into three bf16 pieces, P_hi + P_mid + P_lo, each the top 16 bits of what
// the earlier pieces leave: the differences are exact in float32 and the
// pieces sum to P exactly.  A tile's P V is three RS wgmmas into one float32
// accumulator, whose products are exact.  That triples the P V half of the
// tensor work: the kernel issues twice the counted FLOPs.  The tensor
// cores' float32 sums truncate, so the running output is not kept there:
// each tile's P V starts a fresh accumulator, and the CUDA cores merge it,
// o = fma(o, corr, o_tile), rounded to nearest.  (Kept in the tensor cores
// across a 2048-key row, the truncation moved small outputs of qwen2-0.5b's
// layers by up to 2.4 bf16 ulps.)  Q K^T likewise: chained over hd in one
// accumulator, the truncation repeats once per 16 columns of hd, so each
// half of hd (at hd 80 its first 2 and last 3 slices) is a chain of its own
// and the CUDA cores add the two (issue_qk, finish_qk): where scores are
// large (q and k three times the unit normal) the design's outputs then sit
// over 1 bf16 ulp of a float64 evaluation less often, and less far, than
// the float32 plain version's (chip_smoke.py's gate; PERF.md §6).  The
// exponentials are 2^(s * hd^-0.5 * log2(e) - m') on the special-function
// unit, with the row max m' rounded once per tile and reused in the
// rescaling, so its rounding cancels.  tests/test_torch_flash.py emulates this arithmetic on
// the CPU.
//
// Masking follows the CUDA-core kernel: masked scores are -1e30, a tile
// that leaves a row no key gives p = 0 and corr = 1, and the result is
// acc / max(l, 1e-30), so a row with no key gives zeros.  Tiles the causal
// mask or the window remove entirely are never loaded; a tile that needs no
// mask skips the per-element test.  TMA zero-fills rows past T or S; the
// mask still decides by position.
//
// Rows of Q, K and V sit in shared memory as column blocks: 64 columns of
// hd (128 bytes a row) with the 128-byte swizzle, and at hd 80 one more
// block of the last 16 columns (32 bytes a row) with the 32-byte swizzle,
// each block loaded by TMA through a tensor map of its own box and swizzle.
// At hd 80 Q K^T is then 5 k16 slices, 4 in the wide block and 1 in the
// narrow one, and a tile's P V is one N = 64 and one N = 16 wgmma group in
// one commit: nothing is padded, so the tensor work per key is 80/128 of
// hd 128's.
//
// Grid: one block per (q tile, b, h), longest causal q tiles first, and the
// G query heads of one KV group in adjacent blocks, so the K and V tiles
// they share are L2 hits.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"

namespace flash_wgmma {

using namespace hopper;

constexpr int kBM = 128;         // query rows per block: 64 per consumer warpgroup
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 24*128 + 240*256 <= 65,536
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static_assert(HD % 64 == 0 || HD % 64 == 16,
                "a row is whole 128-byte swizzle rows and at most one 32-byte one");
  // keys per tile: the scores, P's pieces, O and one tile's P V share a
  // consumer's 240 registers (BN/2 + 3*BN/8 + HD/2 + 32 of them, and BN/2
  // for Q K^T's second chain while the scores are summed), so a wider head
  // takes fewer keys.  hd 80 needs 204 at 96 keys (an N = 96 wgmma); 64
  // keys spill nothing but took no less time on the card, and there the
  // two Q K^T chains gain least over one on the large-score gate (PERF.md §6)
  static constexpr int BN = HD == 64 ? 128 : HD == 80 ? 96 : HD == 128 ? 64 : 32;
  static constexpr int STAGES = 4;                 // K/V ring depth
  static constexpr int NCB = HD / 64;              // 128-byte column blocks of a row
  static constexpr int NARROW = HD % 64 / 16;      // 32-byte column blocks of a row: 0 or 1
  static constexpr int NS = HD / 16;               // k16 slices of Q K^T
  static constexpr int QK_SPLIT = NS / 2;          // slices in Q K^T's first chain
  static constexpr int OT = 32 + 8 * NARROW;       // registers of one tile's P V
  static constexpr int Q_CB = kBM * 128;           // bytes of one Q column block
  static constexpr int Q_NB = kBM * 32;            // bytes of Q's narrow block
  static constexpr int KV_CB = BN * 128;           // bytes of one K or V column block
  static constexpr int KV_NB = BN * 32;            // bytes of K's or V's narrow block
  static constexpr int Q_BYTES = NCB * Q_CB + NARROW * Q_NB;
  static constexpr int KV_BYTES = NCB * KV_CB + NARROW * KV_NB;  // one K (or V) tile
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0,
                "every 128-byte-swizzled block starts 1024-byte aligned");
  static constexpr int BARRIERS = 8 * (1 + 3 * STAGES);
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes in the kernel
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + BARRIERS + 1024;
  static_assert(SMEM <= 232448, "more than a block's 227 KB of shared memory");
};

struct Params {
  void* out;
  int B, T, S, H, K;
  int causal, window;  // window <= 0: none
  float scale, cap;    // cap <= 0: none
  int n_qtiles;
};

// P's three bf16 pieces for two neighbouring values x0, x1 >= 0, packed as
// the wgmma A operand packs them (the lower column in the low half).  Each
// piece is the top 16 bits of what the earlier pieces leave; every
// difference is exact in float32, and the three pieces hold a float32
// exactly (8 + 8 + 8 significant bits).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  constexpr uint32_t kTop = 0xffff0000u;
  uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);  // the high halves of u0 and u1
  u0 = __float_as_uint(x0 - __uint_as_float(u0 & kTop));
  u1 = __float_as_uint(x1 - __uint_as_float(u1 & kTop));
  mid = __byte_perm(u0, u1, 0x7632);
  u0 = __float_as_uint(__uint_as_float(u0) - __uint_as_float(u0 & kTop));
  u1 = __float_as_uint(__uint_as_float(u1) - __uint_as_float(u1 & kTop));
  lo = __byte_perm(u0, u1, 0x7632);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ int quad_or(int x) {
  x |= __shfl_xor_sync(0xffffffffu, x, 1);
  return x | __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T for one warpgroup's 64 rows, Q and K K-major: HD/16 slices of
// 16 columns of hd, each one m64nBNk16 wgmma (q_wg and q_nb: this
// warpgroup's rows in Q's first wide block and in its narrow block).
// Inside one wgmma the tensor cores cut each product and the accumulator
// toward zero to a multiple of 2^(E - 25), E the largest exponent among
// them, and cut the sum toward zero to float32 (scripts/flash_qk_probe.py
// measures it; tests/test_torch_flash.py models it bit for bit).  Chaining
// every slice into one accumulator repeats that cut, all of one sign, HD/16
// times at |S|.  So the two halves of hd are two chains, into sc and st
// (BN/2 more registers, live only while the scores are summed), issued
// together: slices 0..QK_SPLIT-1 and the rest (at hd 80: 0-1 and 2-4);
// after the wait the CUDA cores add them, S = sc + st rounded to nearest.
template <int HD, int BN>
__device__ __forceinline__ void qk_slice(float (&d)[BN / 2], uint32_t q_wg, uint32_t q_nb,
                                         uint32_t k_tile, int kk, int scale_d) {
  using C = Tile<HD>;
  if (kk < 4 * C::NCB) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<BN>(d, desc_sw128(q_wg + (kk / 4) * C::Q_CB + off, 16, 1024),
                 desc_sw128(k_tile + (kk / 4) * C::KV_CB + off, 16, 1024), scale_d);
  } else {  // the narrow block: its 32-byte rows are one slice
    wgmma_ss<BN>(d, desc_sw32(q_nb, 16, 256), desc_sw32(k_tile + C::NCB * C::KV_CB, 16, 256),
                 scale_d);
  }
}

template <int BN>
__device__ __forceinline__ void fence_scores(float (&sc)[BN / 2], float (&st)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    fence_reg(sc[i]);
    fence_reg(st[i]);
  }
}

// issues both chains (not waited for)
template <int HD, int BN>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], float (&st)[BN / 2],
                                         uint32_t q_wg, uint32_t q_nb, uint32_t k_tile) {
  constexpr int NS = Tile<HD>::NS, SPLIT = Tile<HD>::QK_SPLIT;
  fence_scores<BN>(sc, st);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SPLIT; ++kk) qk_slice<HD, BN>(sc, q_wg, q_nb, k_tile, kk, kk > 0);
#pragma unroll
  for (int kk = SPLIT; kk < NS; ++kk)
    qk_slice<HD, BN>(st, q_wg, q_nb, k_tile, kk, kk > SPLIT);
  wgmma_commit();
}

// after the wait: S = sc + st, rounded to nearest
template <int BN>
__device__ __forceinline__ void finish_qk(float (&sc)[BN / 2], float (&st)[BN / 2]) {
  fence_scores<BN>(sc, st);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = __fadd_rn(sc[i], st[i]);
}

// O = corr * O + P V for one tile, 64 columns of hd at a time: each
// column block's P V goes into ot in the tensor cores (P's three pieces
// from registers, V read MN-major: 16 keys of 128-byte rows per slice),
// then into o on the CUDA cores.  The narrow block's 16 columns (16 keys of
// 32-byte rows per slice) go into ot[32..40) in the last block's commit.
// The last block's merge is left to the caller, after this consumer's turn.
template <int HD>
__device__ __forceinline__ void merge_block(float (&o)[HD / 2], const float (&ot)[Tile<HD>::OT],
                                            const float (&corr)[2], int cb) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[32 * cb + i] = fmaf(o[32 * cb + i], corr[(i >> 1) & 1], ot[i]);
}

template <int HD>
__device__ __forceinline__ void merge_last(float (&o)[HD / 2], const float (&ot)[Tile<HD>::OT],
                                           const float (&corr)[2]) {
  using C = Tile<HD>;
  merge_block<HD>(o, ot, corr, C::NCB - 1);
#pragma unroll
  for (int i = 32; i < C::OT; ++i)
    o[32 * (C::NCB - 1) + i] = fmaf(o[32 * (C::NCB - 1) + i], corr[(i >> 1) & 1], ot[i]);
}

template <int HD, int BN>
__device__ __forceinline__ void pv(float (&o)[HD / 2], float (&ot)[Tile<HD>::OT],
                                   uint32_t (&pa)[3][BN / 16][4], const float (&corr)[2],
                                   uint32_t v_tile) {
  using C = Tile<HD>;
#pragma unroll
  for (int cb = 0; cb < C::NCB; ++cb) {
#pragma unroll
    for (int i = 0; i < C::OT; ++i) fence_reg(ot[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      // N = 64 is one swizzle column: lbo unused
      const uint64_t dv = desc_sw128(v_tile + cb * C::KV_CB + j * 2048, 0, 1024);
#pragma unroll
      for (int piece = 0; piece < 3; ++piece)
        wgmma_rs_m64n64k16(ot, pa[piece][j], dv, j + piece > 0);
    }
    if constexpr (C::NARROW > 0) {
      if (cb + 1 == C::NCB) {
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          // N = 16 is one swizzle column: lbo unused
          const uint64_t dv = desc_sw32(v_tile + C::NCB * C::KV_CB + j * 512, 0, 256);
#pragma unroll
          for (int piece = 0; piece < 3; ++piece)
            wgmma_rs_m64n16k16(ot + 32, pa[piece][j], dv, j + piece > 0);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < C::OT; ++i) fence_reg(ot[i]);
    if (cb + 1 < C::NCB) merge_block<HD>(o, ot, corr, cb);
  }
#pragma unroll
  for (int piece = 0; piece < 3; ++piece)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_reg(pa[piece][j][r]);
}

// One thread's two rows of a score tile: sc[i] is row (i & 2 ? t1 : t0),
// key k0 + 8*(i/4) + c2 + (i & 1).  Applies cap and mask, updates the
// running max m (in the units of sc) and sum l, and leaves P's pieces in pa
// and each row's rescaling of the running output in corr.
// p = 2^(y*c - fl(m*c)) with c = hd^-0.5 log2(e) on raw scores (log2(e)
// after the cap); corr uses the same rounded fl(m*c), so its rounding
// cancels between tiles.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], uint32_t (&pa)[3][BN / 16][4],
                                             float (&m)[2], float (&l)[2], float (&corr)[2],
                                             const Params& p, float c, int k0, int t_lo, int t0,
                                             int t1, int c2) {
  if (p.cap > 0.f) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = p.cap * tanhf(sc[i] * p.scale / p.cap);
  }
  const bool full = k0 + BN <= p.S && (!p.causal || k0 + BN - 1 <= t_lo) &&
                    (p.window <= 0 || k0 > t_lo + 63 - p.window);
  int any[2] = {1, 1};
  if (!full) {
    any[0] = any[1] = 0;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + c2 + (i & 1);
      const int t = (i & 2) ? t1 : t0;
      const bool ok = key < p.S && (!p.causal || key <= t) &&
                      (p.window <= 0 || key > t - p.window);
      sc[i] = ok ? sc[i] : kNegInf;
      any[(i >> 1) & 1] |= ok;
    }
    any[0] = quad_or(any[0]);
    any[1] = quad_or(any[1]);
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    // a tile that leaves the row no key: p = 0 (2^-inf), corr = 1
    mu[r] = any[r] ? __fmul_rn(m_new, c) : INFINITY;
    corr[r] = any[r] ? ex2(__fmul_rn(m[r], c) - mu[r]) : 1.f;
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    sc[i] = ex2(fmaf(sc[i], c, -mu[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + quad_sum(sum[r]);
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1], pa[0][j][r], pa[1][j][r], pa[2][j][r]);
}

// tq, tk, tv: the 128-byte-swizzled column blocks; tqn, tkn, tvn: the
// narrow blocks (hd 80; unused at the other head dims)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tqn,
                   const __grid_constant__ CUtensorMap tkn,
                   const __grid_constant__ CUtensorMap tvn, const Params p) {
  using C = Tile<HD>;
  constexpr int BN = C::BN, ST = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + C::Q_BYTES;
  const uint32_t sv = sk + ST * C::KV_BYTES;
  const uint32_t bars = sv + ST * C::KV_BYTES;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8, v_full = k_full + 8 * ST, kv_empty = v_full + 8 * ST;

  // block -> (q tile, b, h): longest causal q tiles first; the G query heads
  // of a KV group adjacent
  const int G = p.H / p.K;
  int bid = blockIdx.x;
  const int g = bid % G;
  bid /= G;
  const int bk = bid % (p.B * p.K);
  bid /= p.B * p.K;
  const int q0 = (p.n_qtiles - 1 - bid) * kBM;
  const int b = bk / p.K, kvh = bk % p.K, h = kvh * G + g;

  // keys the mask can leave to rows q0..q0+127: s <= t under causal, s > t - window
  int kv_end = p.S;
  if (p.causal) kv_end = min(kv_end, q0 + kBM);
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  kv_begin -= kv_begin % BN;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 256);  // every consumer thread arrives
    }
    fence_barrier_init();
  }
  __syncthreads();

  // One if/else for the whole kernel: the two roles never reconverge, as
  // setmaxnreg needs.
  if (threadIdx.x < 128) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::NCB; ++c)
        tma_load_4d(sq + c * C::Q_CB, &tq, 64 * c, h, q0, b, q_full);
      if (C::NARROW) tma_load_4d(sq + C::NCB * C::Q_CB, &tqn, 64 * C::NCB, h, q0, b, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        // the first pass over the ring finds every stage empty
        mbar_wait(kv_empty + 8 * s, ((it / ST) & 1) ^ 1);
        const int k0 = kv_begin + it * BN;
        const uint32_t kt = sk + s * C::KV_BYTES, vt = sv + s * C::KV_BYTES;
        mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
        for (int c = 0; c < C::NCB; ++c)
          tma_load_4d(kt + c * C::KV_CB, &tk, 64 * c, kvh, k0, b, k_full + 8 * s);
        if (C::NARROW)
          tma_load_4d(kt + C::NCB * C::KV_CB, &tkn, 64 * C::NCB, kvh, k0, b, k_full + 8 * s);
        mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
        for (int c = 0; c < C::NCB; ++c)
          tma_load_4d(vt + c * C::KV_CB, &tv, 64 * c, kvh, k0, b, v_full + 8 * s);
        if (C::NARROW)
          tma_load_4d(vt + C::NCB * C::KV_CB, &tvn, 64 * C::NCB, kvh, k0, b, v_full + 8 * s);
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // rows q0 + 64*cw .. + 63
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int c2 = 2 * (lane % 4);
    const int t_lo = q0 + 64 * cw;
    const int t0 = t_lo + warp * 16 + lane / 4, t1 = t0 + 8;  // this thread's two rows
    const uint32_t q_wg = sq + cw * 64 * 128, q_nb = sq + C::NCB * C::Q_CB + cw * 64 * 32;
    const float c = p.cap > 0.f ? kLog2e : p.scale * kLog2e;
    // Ping-pong: a consumer issues its products only between a sync on its
    // own named barrier and an arrive on the other's, so the two take turns
    // on the tensor cores and one's softmax runs under the other's products.
    // Consumer 0 goes first; consumer 1 skips its last arrive, so every
    // arrive meets a sync.
    const int bar_mine = 1 + cw, bar_other = 2 - cw;

    // o: the running output, in float32 on the CUDA cores; ot: one tile's
    // P V for 64 columns (and the narrow block's 16), in the tensor cores.
    // Their float32 sums truncate, so adding tile after tile there drifts
    // with the row's length; o is rounded to nearest, once per tile.
    float o[HD / 2], ot[C::OT], sc[BN / 2], st[BN / 2];
    uint32_t pa[3][BN / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::OT; ++i) ot[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = st[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];

    // one tile: softmax of S (already issued), its P V merged into o, then,
    // unless it is the last tile, S of the next tile; the issue is never
    // conditional, so ptxas keeps the products asynchronous
    auto step = [&](const int it, auto not_last) {
      const int s = it % ST;
      wgmma_wait<0>();  // S of tile it, in two chains
      finish_qk<BN>(sc, st);
      softmax_tile<BN>(sc, pa, m, l, corr, p, c, kv_begin + it * BN, t_lo, t0, t1, c2);
      // the softmax's results are complete before this consumer's turn:
      // otherwise the compiler sinks the split of P into it
#pragma unroll
      for (int piece = 0; piece < 3; ++piece)
#pragma unroll
        for (int j = 0; j < BN / 16; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) fence_reg(pa[piece][j][r]);
      mbar_wait(v_full + 8 * s, (it / ST) & 1);
      named_bar_sync(bar_mine, 256);
      pv<HD, BN>(o, ot, pa, corr, sv + s * C::KV_BYTES);
      mbar_arrive(kv_empty + 8 * s);
      if constexpr (decltype(not_last)::value) {
        const int s1 = (it + 1) % ST;
        mbar_wait(k_full + 8 * s1, ((it + 1) / ST) & 1);
        issue_qk<HD, BN>(sc, st, q_wg, q_nb, sk + s1 * C::KV_BYTES);
        named_bar_arrive(bar_other, 256);
      } else if (cw == 0) {
        named_bar_arrive(bar_other, 256);
      }
      merge_last<HD>(o, ot, corr);
    };

    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      if (cw == 1) named_bar_arrive(bar_other, 256);
      named_bar_sync(bar_mine, 256);
      mbar_wait(k_full, 0);
      issue_qk<HD, BN>(sc, st, q_wg, q_nb, sk);
      named_bar_arrive(bar_other, 256);
      for (int it = 0; it + 1 < n_tiles; ++it) step(it, std::true_type{});
      step(n_tiles - 1, std::false_type{});
    }

    // out = acc / max(l, 1e-30), rows past T not written
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r ? t1 : t0;
      if (t >= p.T) continue;
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* row = out + ((static_cast<long long>(b) * p.T + t) * p.H + h) * HD;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * jn + c2) =
            __floats2bfloat162_rn(o[4 * jn + 2 * r] / den, o[4 * jn + 2 * r + 1] / den);
    }
  }
}

// Q K^T alone, for scripts/flash_qk_probe.py's look at the scores'
// precision: one 64-row query tile (blockIdx.x) against one key tile
// (blockIdx.y) of batch 0 and head 0, loaded and summed as the consumers do;
// written to s_out, a (T, S) float32 matrix.
template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_wgmma_scores_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tqn,
                          const __grid_constant__ CUtensorMap tkn, float* s_out, int T, int S) {
  using C = Tile<HD>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + C::Q_BYTES;
  const uint32_t bar = sk + C::KV_BYTES;
  const int q0 = blockIdx.x * 64, k0 = blockIdx.y * BN;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, C::Q_BYTES + C::KV_BYTES);
    for (int c = 0; c < C::NCB; ++c) {
      tma_load_4d(sq + c * C::Q_CB, &tq, 64 * c, 0, q0, 0, bar);
      tma_load_4d(sk + c * C::KV_CB, &tk, 64 * c, 0, k0, 0, bar);
    }
    if (C::NARROW) {
      tma_load_4d(sq + C::NCB * C::Q_CB, &tqn, 64 * C::NCB, 0, q0, 0, bar);
      tma_load_4d(sk + C::NCB * C::KV_CB, &tkn, 64 * C::NCB, 0, k0, 0, bar);
    }
  }
  mbar_wait(bar, 0);
  float sc[BN / 2], st[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = st[i] = 0.f;
  issue_qk<HD, BN>(sc, st, sq, sq + C::NCB * C::Q_CB, sk);
  wgmma_wait<0>();
  finish_qk<BN>(sc, st);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int t = q0 + warp * 16 + lane / 4 + ((i & 2) ? 8 : 0);
    const int key = k0 + 8 * (i / 4) + c2 + (i & 1);
    if (t < T && key < S) s_out[static_cast<long long>(t) * S + key] = sc[i];
  }
}

// cuTensorMapEncodeTiled, fetched from the driver at first use (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Rank-4 view (hd, heads, L, B) of a (B, L, heads, hd) bf16 tensor through its
// element strides s0 (B), s1 (L), s2 (heads); boxes of 64 x 1 x rows x 1,
// 128-byte swizzled, or with `narrow` 16 x 1 x rows x 1, 32-byte swizzled.
// Returns the CUresult of cuTensorMapEncodeTiled.
inline CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base, int hd, int heads,
                       int L, int B, long long s0, long long s1, long long s2, int rows,
                       bool narrow = false) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s2) * 2, static_cast<cuuint64_t>(s1) * 2,
                                 static_cast<cuuint64_t>(s0) * 2};
  const cuuint32_t box[4] = {narrow ? 16u : 64u, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            narrow ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The wide and, where the head dim has one, the narrow tensor map of one
// operand (else the narrow map is a copy of the wide one, never read).
template <int HD>
inline CUresult encode_pair(EncodeTiled fn, CUtensorMap* wide, CUtensorMap* narrow,
                            const void* base, int heads, int L, int B, const long long* s,
                            int rows) {
  CUresult r = encode(fn, wide, base, HD, heads, L, B, s[0], s[1], s[2], rows);
  if (r != CUDA_SUCCESS || !Tile<HD>::NARROW) {
    *narrow = *wide;
    return r;
  }
  return encode(fn, narrow, base, HD, heads, L, B, s[0], s[1], s[2], rows, true);
}

// Returns 0, a cudaError_t, or minus the CUresult of a failed tensor-map encode.
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int T, int S, int H,
           int K, const long long* qs, const long long* ks, const long long* vs, int causal,
           int window, float scale, float cap, cudaStream_t stream) {
  using C = Tile<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, tqn, tkn, tvn;
  CUresult r = encode_pair<HD>(fn, &tq, &tqn, q, H, T, B, qs, kBM);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  if (S > 0) {
    r = encode_pair<HD>(fn, &tk, &tkn, k, K, S, B, ks, C::BN);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
    r = encode_pair<HD>(fn, &tv, &tvn, v, K, S, B, vs, C::BN);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  } else {  // no key: the kernel loads no K or V tile
    tk = tv = tq;
    tkn = tvn = tqn;
  }
  cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qtiles = (T + kBM - 1) / kBM;
  const Params p{out, B, T, S, H, K, causal, window, scale, cap, n_qtiles};
  const long long blocks = static_cast<long long>(n_qtiles) * B * H;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  flash_wgmma_kernel<HD>
      <<<static_cast<unsigned>(blocks), kThreads, C::SMEM, stream>>>(tq, tk, tv, tqn, tkn, tvn,
                                                                      p);
  return static_cast<int>(cudaGetLastError());
}

// flash_wgmma_scores_kernel over q (1, T, 1, HD) and k (1, S, 1, HD) into s_out
// (T, S); T a multiple of 64.  Returns as launch().
template <int HD>
int launch_scores(const void* q, const void* k, float* s_out, int T, int S, const long long* qs,
                  const long long* ks, cudaStream_t stream) {
  using C = Tile<HD>;
  if (T <= 0 || S <= 0 || T % 64) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tqn, tkn;
  CUresult r = encode_pair<HD>(fn, &tq, &tqn, q, 1, T, 1, qs, kBM);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  r = encode_pair<HD>(fn, &tk, &tkn, k, 1, S, 1, ks, C::BN);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const int smem = C::Q_BYTES + C::KV_BYTES + 8 + 1024;
  cudaError_t e = cudaFuncSetAttribute(flash_wgmma_scores_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_wgmma_scores_kernel<HD>
      <<<dim3(T / 64, (S + C::BN - 1) / C::BN), 128, smem, stream>>>(tq, tk, tqn, tkn, s_out, T,
                                                                       S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_wgmma
