// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of the backward `_flash_bwd` in
// generativemodels_tpu/ops/flash_attention.py: the split backward's
// `_dq_kernel` (with _dq_tile) becomes flash_bwd_dq_kernel and `_dkv_kernel`
// (with _dkv_tile) becomes flash_bwd_dkv_kernel; the fused backward's
// `_dfused_kernel` (with _dfused_tile, run under GMTPU_FLASH_FUSED_BWD=1)
// becomes flash_bwd_fused_kernel. The last two share one body, dkv_block.
// Default contract, as flash_fwd.cu: q arrives prescaled by scale*log2(e)
// (rounded to q's type), dO arrives multiplied by ln2 (rounded to dO's
// type), lse2 is the forward's log2-domain lse and delta = rowsum(dO ln2 * O)
// in f32; those three come from plain torch ops, as JAX computes them in XLA
// outside its kernels. Every kernel recomputes
//   p  = exp2(min(q.k, 80) - lse2)    (0 exactly for masked keys and rows)
//   ds = p * (do.v - delta)           (the clamp's gradient is the identity)
// and then dq = ds K; dk = ds^T Q; dv = round(p)^T dO * log2(e). For bf16
// inputs ds and p are rounded to bf16 before their products and every
// product takes bf16 operands (exact in f32) with f32 accumulation.
//
// What bounds them on this card: at the 3D training shape (BH=2, S=32768,
// D=64, bf16) kernel 3 does 4 products of BH*S*S*D multiply-adds (s, dp,
// dv, dk), 1.1e12 operations on 17 MB: 1.11 ms at the bf16 tensor-core rate
// (989 TFLOP/s), bound by operations; kernel 4 adds the fifth, dq, and
// adds its key blocks' dq parts into one f32 buffer. With mma.sync (as
// kernel 1) the tensor pipe's issue rate and the operand fragments read
// from shared memory set the floor: a warp owns one 16-row fragment of each
// product, so every B fragment read feeds one mma.
//
// Kernel 2 (dq) still runs its products as f32 FMAs on the CUDA cores: one
// block per (bh, 32 query rows), 4 warps of 8 rows, looping over key tiles
// of 32 (one key per lane), with the (32 x D) f32 accumulator in registers
// and f32 copies of the tiles in shared memory (rows padded by 4 floats).
//
// Kernels 3 and 4 (dkv_block) run on the tensor cores: FlashAttention-2's
// key-major backward. A block of 8 warps owns one (bh, Bc-key block); K and
// V stay in shared memory in the input type, rows padded to D + 16 bytes so
// the eight rows an ldmatrix (or a quad of scalar loads) reads fall in
// distinct banks. The block loops over q tiles of Br rows; Q, dO and their
// lse2 and delta rows come in by cp.async two deep (one deep for f32 at
// D = 256, where two would not fit), so the next tile's copy runs under
// this tile's products; rows past Sq and keys past Sk are zero-filled
// (cp.async with src-size 0), so a masked p of 0 never meets a stale NaN
// inside an mma. Per q tile:
// - a warp takes a 16-key group and Br / kSplit of the tile's queries and
//   computes S^T = K Q^T and dP^T = V dO^T (A fragments of K, V by
//   ldmatrix, B fragments of Q, dO rows by ldmatrix), then
//   P^T = exp2(min(S^T, 80) - lse2) and dS^T = P^T (dP^T - delta), and
//   writes both, rounded to the input type, to shared memory (Bc x Br);
// - after a barrier, a warp takes the same 16 keys and D / kSplit columns:
//   dV += P^T dO and dK += dS^T Q (A fragments from the P^T and dS^T tiles,
//   B fragments by ldmatrix.trans), accumulated in f32 registers;
// - kernel 4 only: the tile's dq part dS K (Br x D; A fragments of dS by
//   ldmatrix.trans of the dS^T tile, B of K by ldmatrix.trans), a 16-row x
//   D / kColGroups slab a warp, in passes of at most 64 columns (32 f32).
// kSplit is 1 at D <= 64 (128-key blocks) and 2 above (64-key blocks): the
// dK and dV accumulators of 16 keys x D / kSplit columns take D / kSplit f32
// registers a thread, 128 at D = 256, so two warps share a key group there,
// each owning half of D, and P^T / dS^T reach both through shared memory.
// Shared memory at bf16 D = 256: 2 x 64 x 264 (K, V) + 2 x 2 x 64 x 264 (Q,
// dO, two deep) + 2 x 64 x 72 (P^T, dS^T) bf16, the rows' lse2, delta and
// |dO|, and the warps' queues: 223744 of the 232448 bytes a block may take.
// - bf16: mma.sync m16n8k16, Br = 64.
// - f32: mma.sync m16n8k8 as 3xTF32, as flash_fwd.cu: each operand a is
//   split into hi = tf32(a) and lo = tf32(a - hi) as it is read (scalar
//   loads, since ldmatrix.trans moves 16-bit elements), and each product is
//   lo*hi + hi*lo + hi*hi with f32 accumulation (lo*lo, ~2^-22 of it, is
//   dropped); the three products of a k8 step start from zero and an f32
//   add keeps the running sum (the tensor cores truncate their sums), so
//   results stay within f32 summation error; Br = 32.
// - Causal: q tiles wholly above the block's first key are never visited
//   (the loop starts at q tile k0, Bc being a multiple of Br); a key group
//   wholly past a tile's last row, or past Sk, skips its products and
//   writes p = ds = 0.
// At bf16 and kSplit = 1 a warp's own P^T and dS^T C fragments (its 16 keys
// x all Br queries) are already the A fragments of its dV and dK products,
// packed to bf16 pairs in registers, as kernel 1 reuses S: no P^T tile, no
// barrier between the two phases, and dS^T goes to shared memory only for
// kernel 4's dq part.
//
// Kernel 4's bf16 ds, rounded as kernel 2 rounds it. Kernel 2 and the plain
// backward sum s and dp as f32 FMAs in d order; the tensor cores sum them
// otherwise, so an f32 ds that lies near a bf16 rounding midpoint may round
// to the other neighbour here, which moves dq by an ulp of ds times |k|,
// many ulps of a dq that is small. So kernel 4 flags each element whose ds
// lies within |ds| kTieRel + p kTieDp |dO| |v| of a midpoint (a few per
// warp and tile), and the flagged elements' s and dp are computed again
// exactly as kernel 2 computes them (two lanes an element, f32 FMAs in d
// order, beside the dV, dK products) and their bf16 ds replaces the tile's
// in dS^T before the dq part. dK has already taken the tensor cores' ds, so
// kernel 4's dk and dv stay kernel 3's to the bit. The |dO| row norms come
// from the caller, the |v| ones from the block's V tile.
//
// Kernel 4 adds each q tile's dq part into one zeroed f32 (BH, Sq, D)
// buffer in a fixed order, so dq is the same to the bit from run to run
// (the TPU kernel writes one f32 partial-dq slab per kv tile and sums them
// in XLA; at the 3D shape that would be 8.6 GB of slabs): one int counter
// per (bh, Br-row q tile), zeroed by the caller, counts the key blocks whose
// part of that tile is in. Key block kb of a head waits (thread 0 spins on
// an ld.acquire.gpu with __nanosleep) until the counter equals kb, the
// number of key blocks before it that touch the tile (under the causal mask
// a block starts at its own first key, so every block before it has
// touched the tile too), adds its part with float2 atomic adds (each
// element by one thread, so their order is the counter's; an atomic add
// needs no round trip to L2), and after a block barrier thread 0 fences
// and sets the counter to kb + 1 with a st.release.gpu. So dq = ((part_0 +
// part_1) + ...) in key-block order. This relies on the blocks of one head being
// dispatched in blockIdx order (blockIdx.x = bh * num_kb + kb): a block
// waits only for blocks with a smaller index, which are resident or done,
// so the wait ends. The adds number BH * Sq * D/2 * ceil(Sk / Bc) float2
// atomic adds (fewer under the causal mask), so the wide key block
// pays twice, in products and in adds. Kernels 3 and 4 run the same code
// for dK and dV (the same Bc, Br, q-tile order and mma k-order), so their dk
// and dv are equal to the bit. The caller casts dq once.
// Kernels 2 and 3 are deterministic too: dq rows belong to one block, dK/dV
// rows to one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kBlock = 32;  // query rows and keys of kernel 2's tiles
constexpr int kDqThreads = 128;  // 4 warps x 8 query rows
constexpr int kDqRowsPerWarp = 8;
constexpr float kLog2e = 1.4426950408889634f;

// Tiles of kernels 3 and 4 (chip_smoke.py reads them from here): q rows of
// a q tile by input type, keys of a block by head width.
constexpr int kBrBf16 = 64;
constexpr int kBrF32 = 32;
constexpr int kNarrowD = 64;  // the widest head of the narrow tiles
constexpr int kBcNarrow = 128;  // keys of a block at D <= kNarrowD
constexpr int kBcWide = 64;  // keys of a block above
constexpr int kDkvWarps = 8;
constexpr int kDkvThreads = 32 * kDkvWarps;
// Kernel 4, bf16: how far kernel 2's ds = p (dp - delta) may lie from the
// tensor cores' (see the flags in dkv_block): kTieRel of |ds| (the rounding
// of x = min(s, 80) - lse2 at |x| <= 64, where p >= 2^-64, two exp2f of 2
// ulps, the rounding of dp - delta and of the product, and the error of s,
// each a few 2^-23 or less) and p kTieDp |dO| |v| (the error of dp, at most
// a few 2^-24 of the product of the rows' Euclidean norms).
constexpr float kTieRel = 0x1p-17f;
constexpr float kTieDp = 0x1p-23f;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round an f32 value to the precision of T (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy kBlock rows of width D (row-major, contiguous) into shared memory as
// f32 with row stride `ld`; rows at or past `valid` are zero-filled.
template <typename T, int D, int NThreads>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int valid) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecsPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBlock * kVecsPerRow; i += NThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i % kVecsPerRow) * kVec;
    float vals[kVec];
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = to_float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = 0.f;
    }
    float* out = dst + r * ld + c;
#pragma unroll
    for (int j = 0; j < kVec; j += 4) {
      *reinterpret_cast<float4*>(out + j) = make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
    }
  }
}

// lse2 and delta of the tile's rows into shared memory (0 past `valid`).
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta, const float* lse2,
                                          const float* delta, int valid) {
  if (threadIdx.x < kBlock) {
    const bool ok = static_cast<int>(threadIdx.x) < valid;
    s_lse[threadIdx.x] = ok ? lse2[threadIdx.x] : 0.f;
    s_delta[threadIdx.x] = ok ? delta[threadIdx.x] : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Shared memory of kernel 2: two tiles of 32 rows at stride D (Q, dO), two
// at stride D + 4 (K, V), two 32 x 32 tiles (dS; the second is unused), lse2
// and delta rows.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kBlock * D + 2 * kBlock * (D + 4) + 2 * kBlock * kBlock + 2 * kBlock);
}

// Kernel 2. Grid: one block per (bh, 32-row query block), flattened into blockIdx.x.
template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse2,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    int num_qb, int causal) {
  static_assert(D % 32 == 0, "head width must be a multiple of 32");
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 32;  // accumulator columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // kBlock x D
  float* sDO = sQ + kBlock * D;      // kBlock x D
  float* sK = sDO + kBlock * D;      // kBlock x kLd
  float* sV = sK + kBlock * kLd;     // kBlock x kLd
  float* sDS = sV + kBlock * kLd;    // kBlock x kBlock (the second such tile is unused)
  float* sLse = sDS + kBlock * kBlock;
  float* sDelta = sLse + kBlock;

  const int bh = blockIdx.x / num_qb;
  const int q0 = (blockIdx.x % num_qb) * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * kDqRowsPerWarp;  // first tile row of this warp
  const int qvalid = min(kBlock, sq - q0);
  const size_t row0 = static_cast<size_t>(bh) * sq + q0;

  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;
  load_tile<T, D, kDqThreads>(sQ, D, q + row0 * D, qvalid);
  load_tile<T, D, kDqThreads>(sDO, D, dout + row0 * D, qvalid);
  load_rows(sLse, sDelta, lse2 + row0, delta + row0, qvalid);

  float acc[kDqRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kDqRowsPerWarp; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, q0 + kBlock) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBlock) {
    __syncthreads();  // the previous tile is fully consumed
    const int kvalid = min(kBlock, sk - k0);
    load_tile<T, D, kDqThreads>(sK, kLd, kb + static_cast<size_t>(k0) * D, kvalid);
    load_tile<T, D, kDqThreads>(sV, kLd, vb + static_cast<size_t>(k0) * D, kvalid);
    __syncthreads();

    // s[i] = q[r0 + i] . k[lane], dp[i] = do[r0 + i] . v[lane]
    float s[kDqRowsPerWarp], dp[kDqRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kDqRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
    const float* krow = sK + lane * kLd;
    const float* vrow = sV + lane * kLd;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
      const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
      for (int i = 0; i < kDqRowsPerWarp; ++i) {
        s[i] = dot4(*reinterpret_cast<const float4*>(sQ + (r0 + i) * D + d), kk, s[i]);
        dp[i] = dot4(*reinterpret_cast<const float4*>(sDO + (r0 + i) * D + d), vv, dp[i]);
      }
    }

    const int col = k0 + lane;
#pragma unroll
    for (int i = 0; i < kDqRowsPerWarp; ++i) {
      const int r = r0 + i;
      const int row = q0 + r;
      const bool live = col < sk && row < sq && (!causal || col <= row);
      const float p = live ? exp2f(fminf(s[i], 80.f) - sLse[r]) : 0.f;
      sDS[r * kBlock + lane] = round_to<T>(p * (dp[i] - sDelta[r]));
    }
    __syncwarp();

    // acc[i][j] += sum_c ds[r0 + i][c] * k[c][lane + 32 j]
#pragma unroll 2
    for (int c = 0; c < kBlock; c += 4) {
      float4 dd[kDqRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kDqRowsPerWarp; ++i) {
        dd[i] = *reinterpret_cast<const float4*>(sDS + (r0 + i) * kBlock + c);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float k0v = sK[(c + 0) * kLd + lane + 32 * j];
        const float k1v = sK[(c + 1) * kLd + lane + 32 * j];
        const float k2v = sK[(c + 2) * kLd + lane + 32 * j];
        const float k3v = sK[(c + 3) * kLd + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kDqRowsPerWarp; ++i) {
          acc[i][j] = fmaf(dd[i].x, k0v, acc[i][j]);
          acc[i][j] = fmaf(dd[i].y, k1v, acc[i][j]);
          acc[i][j] = fmaf(dd[i].z, k2v, acc[i][j]);
          acc[i][j] = fmaf(dd[i].w, k3v, acc[i][j]);
        }
      }
    }
    __syncwarp();  // dS is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kDqRowsPerWarp; ++i) {
    const int row = q0 + r0 + i;
    if (row >= sq) continue;
    T* out = dq + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[lane + 32 * j] = from_float<T>(acc[i][j]);
  }
}

// ---- kernels 3 and 4 on the tensor cores ----

// Two adjacent values (columns c, c + 1 of a row) rounded to T and stored
// at p, which holds column c (shared or global memory).
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Tile shapes of one instantiation of kernels 3 and 4.
template <typename T, int D>
struct DkvCfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kBr = kBf16 ? kBrBf16 : kBrF32;  // q rows of a q tile
  static constexpr int kBc = D <= kNarrowD ? kBcNarrow : kBcWide;  // keys of a block
  // warps sharing a 16-key group: each owns kBr / kSplit queries of S^T and
  // D / kSplit columns of dK and dV
  static constexpr int kSplit = kDkvWarps * 16 / kBc;
  static constexpr int kStages = !kBf16 && D == 256 ? 1 : 2;  // Q, dO tiles in flight
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));  // rows of K, V, Q, dO
  static constexpr int kLdP = kBr + 16 / static_cast<int>(sizeof(T));  // rows of P^T, dS^T
  static constexpr int kK = kBf16 ? 16 : 8;  // k of one mma
  static constexpr size_t kSmem =
      sizeof(T) * (2 * kBc * kLd + 2 * kStages * kBr * kLd + 2 * kBc * kLdP) +
      sizeof(float) * 2 * kStages * kBr +
      // bf16 (used by kernel 4): the dO rows' norms and each warp's queue
      // of 32 elements whose ds is recomputed
      (kBf16 ? sizeof(float) * kStages * kBr + sizeof(uint32_t) * 32 * kDkvWarps : 0);
};

// mma fragments: bf16 operands as packed pairs; f32 operands as their TF32
// hi and lo parts (3xTF32).
template <typename T>
struct Frag;
template <>
struct Frag<bf16> {
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
};
template <>
struct Frag<float> {
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
};

__device__ __forceinline__ void mma(float (&c)[4], const Frag<bf16>::A& a,
                                    const Frag<bf16>::B& b) {
  mma_bf16(c, a.r, b.r[0], b.r[1]);
}
// An mma does not round its sum to nearest: with the running sum kept inside
// the mma, f32 dq drifted from kernel 2's by 1e-5 of max|dq| at D = 256, as
// truncation toward zero of each step would. So the three products of one
// k8 step go into a zero accumulator and the running sum is kept by an f32
// add, which rounds to nearest.
__device__ __forceinline__ void mma(float (&c)[4], const Frag<float>::A& a,
                                    const Frag<float>::B& b) {
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(step, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(step, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(step, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += step[e];
}

// Fragment loads from shared memory. `p` points at element (0, 0) of the
// fragment; `ld` is the row stride. A is 16 x kK (m x k), stored [m][k]
// (load_a_mk) or [k][m] (load_a_km); b[0] and b[1] are the B fragments
// (kK x 8, k x n) of n 0-7 and 8-15, stored [n][k] (load_b_nk) or [k][n]
// (load_b_kn). The mma layouts: A (g, 2t..2t+1), (g+8, ..), (g, 2t+8..),
// (g+8, 2t+8..) and B (k 2t..2t+1, n g), (k 2t+8.., n g) for bf16; A (g, t),
// (g+8, t), (g, t+4), (g+8, t+4) and B (k t, n g), (k t+4, n g) for TF32.
__device__ __forceinline__ void load_a_mk(Frag<bf16>::A& a, const bf16* p, int ld, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(a.r, p + ((mi & 1) * 8 + (lane & 7)) * ld + (mi >> 1) * 8);
}
__device__ __forceinline__ void load_a_km(Frag<bf16>::A& a, const bf16* p, int ld, int lane) {
  const int mi = lane >> 3;
  ldsm_x4_trans(a.r, p + ((mi >> 1) * 8 + (lane & 7)) * ld + (mi & 1) * 8);
}
__device__ __forceinline__ void load_b_nk(Frag<bf16>::B (&b)[2], const bf16* p, int ld,
                                          int lane) {
  const int mi = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, p + ((mi >> 1) * 8 + (lane & 7)) * ld + (mi & 1) * 8);
  b[0].r[0] = r[0];
  b[0].r[1] = r[1];
  b[1].r[0] = r[2];
  b[1].r[1] = r[3];
}
__device__ __forceinline__ void load_b_kn(Frag<bf16>::B (&b)[2], const bf16* p, int ld,
                                          int lane) {
  const int mi = lane >> 3;
  uint32_t r[4];
  ldsm_x4_trans(r, p + ((mi & 1) * 8 + (lane & 7)) * ld + (mi >> 1) * 8);
  b[0].r[0] = r[0];
  b[0].r[1] = r[1];
  b[1].r[0] = r[2];
  b[1].r[1] = r[3];
}
__device__ __forceinline__ void load_a_mk(Frag<float>::A& a, const float* p, int ld, int lane) {
  const float* e = p + (lane >> 2) * ld + (lane & 3);
  split_tf32(e[0], a.hi[0], a.lo[0]);
  split_tf32(e[8 * ld], a.hi[1], a.lo[1]);
  split_tf32(e[4], a.hi[2], a.lo[2]);
  split_tf32(e[8 * ld + 4], a.hi[3], a.lo[3]);
}
__device__ __forceinline__ void load_a_km(Frag<float>::A& a, const float* p, int ld, int lane) {
  const float* e = p + (lane & 3) * ld + (lane >> 2);
  split_tf32(e[0], a.hi[0], a.lo[0]);
  split_tf32(e[8], a.hi[1], a.lo[1]);
  split_tf32(e[4 * ld], a.hi[2], a.lo[2]);
  split_tf32(e[4 * ld + 8], a.hi[3], a.lo[3]);
}
__device__ __forceinline__ void load_b_nk(Frag<float>::B (&b)[2], const float* p, int ld,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* e = p + (8 * j + (lane >> 2)) * ld + (lane & 3);
    split_tf32(e[0], b[j].hi[0], b[j].lo[0]);
    split_tf32(e[4], b[j].hi[1], b[j].lo[1]);
  }
}
__device__ __forceinline__ void load_b_kn(Frag<float>::B (&b)[2], const float* p, int ld,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* e = p + (lane & 3) * ld + 8 * j + (lane >> 2);
    split_tf32(e[0], b[j].hi[0], b[j].lo[0]);
    split_tf32(e[4 * ld], b[j].hi[1], b[j].lo[1]);
  }
}

// Stage `Rows` rows of width D (contiguous in global memory, from `src`)
// into `dst` with row stride `ld`; rows at or past `valid` are zero-filled.
template <typename T, int D, int Rows>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* __restrict__ src, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < Rows * kChunks; i += kDkvThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c, src + static_cast<size_t>(ok ? r : 0) * D + c, ok);
  }
}

// lse2 and delta of `Rows` rows into shared memory (0 past `valid`).
template <int Rows>
__device__ __forceinline__ void stage_row_stats(float* s_lse, float* s_delta,
                                                const float* __restrict__ lse2,
                                                const float* __restrict__ delta, int valid,
                                                float* s_norm = nullptr,
                                                const float* __restrict__ norm = nullptr) {
  static_assert(3 * Rows <= kDkvThreads, "one row value a thread");
  const int i = threadIdx.x % Rows;
  const bool ok = i < valid;
  if (threadIdx.x < Rows) {
    cp_async4(s_lse + i, lse2 + (ok ? i : 0), ok);
  } else if (threadIdx.x < 2 * Rows) {
    cp_async4(s_delta + i, delta + (ok ? i : 0), ok);
  } else if (s_norm != nullptr && threadIdx.x < 3 * Rows) {
    cp_async4(s_norm + i, norm + (ok ? i : 0), ok);
  }
}

// acc + u.v over the two bf16 of each word, low half first, as f32 FMAs
__device__ __forceinline__ float dot_bf16x2(uint32_t u, uint32_t v, float acc) {
  acc = fmaf(__uint_as_float(u << 16), __uint_as_float(v << 16), acc);
  return fmaf(__uint_as_float(u & 0xffff0000u), __uint_as_float(v & 0xffff0000u), acc);
}

// acc + a.b over N columns of two bf16 rows, in column order, as f32 FMAs:
// kernel 2's order for s and dp
template <int N>
__device__ __forceinline__ float dot_run(const bf16* a, const bf16* b, float acc) {
#pragma unroll 4
  for (int c = 0; c < N; c += 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(a + c);
    const uint2 v = *reinterpret_cast<const uint2*>(b + c);
    acc = dot_bf16x2(u.y, v.y, dot_bf16x2(u.x, v.x, acc));
  }
  return acc;
}

// Euclidean norm of a bf16 row of D, summed by the 4 lanes of a quad (each
// a quarter of the columns)
template <int D>
__device__ __forceinline__ float quad_norm(const bf16* row, int t) {
  float acc = 0.f;
#pragma unroll
  for (int c = t * (D / 4); c < (t + 1) * (D / 4); c += 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + c);
    acc = dot_bf16x2(u.y, u.y, dot_bf16x2(u.x, u.x, acc));
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return sqrtf(acc + __shfl_xor_sync(0xffffffffu, acc, 2));
}

// The block of kernels 3 (Fused = false) and 4 (Fused = true). Grid: one
// block per (bh, kBc-key block), flattened into blockIdx.x. Kernel 4 also
// adds each q tile's dq part into `dq_acc`, f32 (bh, sq, D), zeroed by the
// caller, in key-block order kept by `dq_lock`, int (bh, ceil(sq / kBr)),
// zeroed by the caller; kernel 3 gets nullptr for both.
template <typename T, int D, bool Fused>
__device__ __forceinline__ void dkv_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    const float* __restrict__ dout_norm, int sq, int sk, int num_kb, int causal) {
  using C = DkvCfg<T, D>;
  using FA = typename Frag<T>::A;
  using FB = typename Frag<T>::B;
  constexpr int BR = C::kBr;
  constexpr int BC = C::kBc;
  constexpr int LD = C::kLd;
  constexpr int LDP = C::kLdP;
  constexpr int KK = C::kK;
  constexpr int kNq = BR / C::kSplit;  // queries of a warp's S^T slab
  constexpr int kSTiles = kNq / 8;  // its n8 tiles
  constexpr int kDw = D / C::kSplit;  // dK, dV columns of a warp
  constexpr int kDTiles = kDw / 8;
  static_assert(kSTiles % 2 == 0 && kDTiles % 2 == 0, "B fragments come two n8 tiles at a time");
  static_assert(BC % BR == 0, "a causal q loop starts on a q tile");
  // kernel 4, bf16: ds near a rounding midpoint recomputed as kernel 2 does
  constexpr bool kTies = Fused && C::kBf16;
  // bf16 at kSplit = 1: a warp's P^T and dS^T C fragments cover all the
  // tile's queries of its keys, so they are the A fragments of its dV and
  // dK products as they stand (packed to bf16 pairs), with no trip through
  // shared memory; dS^T still goes there for kernel 4's dq part
  constexpr bool kRegA = C::kBf16 && C::kSplit == 1;
  // k loops are unrolled by 4 for bf16 and rolled for f32, whose split
  // fragments would otherwise be loaded ahead into the registers that its
  // dK and dV accumulators need (no stack frame at D = 256)
  constexpr int kUnroll = C::kBf16 ? 4 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // BC x LD
  T* sV = sK + BC * LD;  // BC x LD
  T* sQ = sV + BC * LD;  // kStages x BR x LD
  T* sO = sQ + C::kStages * BR * LD;  // dO, kStages x BR x LD
  T* sP = sO + C::kStages * BR * LD;  // P^T, BC keys x LDP
  T* sS = sP + BC * LDP;  // dS^T, BC keys x LDP
  float* sLse = reinterpret_cast<float*>(sS + BC * LDP);  // kStages x BR
  float* sDelta = sLse + C::kStages * BR;  // kStages x BR
  // kernel 4, bf16 only: the dO rows' norms, and each warp's queue of
  // flagged elements (key << 8 | query of the tile)
  float* sNo = sDelta + C::kStages * BR;  // kStages x BR
  uint32_t* sQueue = reinterpret_cast<uint32_t*>(sNo + C::kStages * BR);  // 32 a warp

  const int bh = blockIdx.x / num_kb;
  const int kbi = blockIdx.x % num_kb;
  const int k0 = kbi * BC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wk = (warp / C::kSplit) * 16;  // first key of the warp's group, in the block
  const int wq = (warp % C::kSplit) * kNq;  // first query of its S^T slab, in the tile
  const int wd = (warp % C::kSplit) * kDw;  // first column of its dK, dV
  const size_t key0 = static_cast<size_t>(bh) * sk + k0;
  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* ob = dout + static_cast<size_t>(bh) * sq * D;
  const float* lb = lse2 + static_cast<size_t>(bh) * sq;
  const float* db = delta + static_cast<size_t>(bh) * sq;

  // under the causal mask, query rows before the block's first key are dead
  const int q_begin = causal ? k0 : 0;
  const int num_q = q_begin < sq ? (sq - q_begin + BR - 1) / BR : 0;
  auto stage_q = [&](int j, int st) {
    const int q0 = q_begin + j * BR;
    const int valid = min(BR, sq - q0);
    stage_rows<T, D, BR>(sQ + st * BR * LD, LD, qb + static_cast<size_t>(q0) * D, valid);
    stage_rows<T, D, BR>(sO + st * BR * LD, LD, ob + static_cast<size_t>(q0) * D, valid);
    if constexpr (kTies) {
      stage_row_stats<BR>(sLse + st * BR, sDelta + st * BR, lb + q0, db + q0, valid,
                          sNo + st * BR, dout_norm + static_cast<size_t>(bh) * sq + q0);
    } else {
      stage_row_stats<BR>(sLse + st * BR, sDelta + st * BR, lb + q0, db + q0, valid);
    }
  };
  stage_rows<T, D, BC>(sK, LD, k + key0 * D, min(BC, sk - k0));
  stage_rows<T, D, BC>(sV, LD, v + key0 * D, min(BC, sk - k0));
  if (num_q > 0) stage_q(0, 0);
  cp_async_commit();

  float acc_k[kDTiles][4], acc_v[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  }

  // kernel 4, bf16: kTieDp |v| of the lane's keys g and g + 8 (from the
  // first tile on, which brings V)
  float nv[2] = {0.f, 0.f};

  for (int j = 0; j < num_q; ++j) {
    const int st = C::kStages == 2 ? (j & 1) : 0;
    const int q0 = q_begin + j * BR;
    if constexpr (C::kStages == 2) {
      if (j + 1 < num_q) {  // the next tile's copy runs under this tile's products
        stage_q(j + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (j > 0) {  // the previous tile ended on a barrier
        stage_q(j, 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tQ = sQ + st * BR * LD;
    const T* tO = sO + st * BR * LD;
    const float* tLse = sLse + st * BR;
    const float* tDelta = sDelta + st * BR;
    if constexpr (kTies) {
      if (j == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) nv[h] = kTieDp * quad_norm<D>(sV + (wk + g + 8 * h) * LD, t);
      }
    }
    // a key group past sk, or under the causal mask past the tile's last
    // row, has p == 0 for the whole tile
    const bool dead = k0 + wk >= sk || (causal && k0 + wk > q0 + BR - 1);

    // S^T = K Q^T and dP^T = V dO^T: the group's 16 keys x kNq queries
    float s[kSTiles][4], dp[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    if (!dead) {
#pragma unroll(kUnroll)
      for (int kk = 0; kk < D; kk += KK) {
        FA ak, av;
        load_a_mk(ak, sK + wk * LD + kk, LD, lane);
        load_a_mk(av, sV + wk * LD + kk, LD, lane);
#pragma unroll
        for (int n = 0; n < kSTiles; n += 2) {
          FB bq[2], bo[2];
          load_b_nk(bq, tQ + (wq + 8 * n) * LD + kk, LD, lane);
          load_b_nk(bo, tO + (wq + 8 * n) * LD + kk, LD, lane);
          mma(s[n], ak, bq[0]);
          mma(s[n + 1], ak, bq[1]);
          mma(dp[n], av, bo[0]);
          mma(dp[n + 1], av, bo[1]);
        }
      }
    }
    // P^T and dS^T, rounded to T, into shared memory: the C fragment holds
    // keys g, g + 8 and queries 2t, 2t + 1 of each n8 tile. Kernel 4, bf16:
    // an element whose f32 ds lies within |ds| kTieRel + p kTieDp |dO| |v|
    // of a bf16 rounding midpoint is flagged in `ties` (bit 4n + 2h + e),
    // since kernel 2, whose s and dp are f32 FMAs in d order, may round it
    // to the other neighbour
    static_assert(kSTiles * 4 <= 32, "one bit an element of the fragment");
    uint32_t ties = 0;
    uint32_t pa[kRegA ? kSTiles : 1][2], sa[kRegA ? kSTiles : 1][2];  // kRegA: (n, h) bf16 pairs
    // kernel 4, bf16: kTieDp |v| max |dO| over the tile's rows, for the lane's keys
    float tie_dp[2] = {0.f, 0.f};
    if constexpr (kTies) {
      float no = 0.f;
#pragma unroll
      for (int r = lane; r < BR; r += 32) no = fmaxf(no, sNo[st * BR + r]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) no = fmaxf(no, __shfl_xor_sync(0xffffffffu, no, o));
      tie_dp[0] = nv[0] * no;
      tie_dp[1] = nv[1] * no;
    }
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      const int ql = wq + 8 * n + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kl = wk + g + 8 * h;
        const int key = k0 + kl;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = q0 + ql + e;
          const bool live = !dead && row < sq && key < sk && (!causal || key <= row);
          p[e] = live ? exp2f(fminf(s[n][2 * h + e], 80.f) - tLse[ql + e]) : 0.f;
          const float dd = dp[n][2 * h + e] - tDelta[ql + e];
          ds[e] = p[e] * dd;
          if constexpr (kTies) {  // p = 0 (masked) gives eps = 0: never flagged
            const float eps = p[e] * fmaf(fabsf(dd), kTieRel, tie_dp[h]);
            const float mid = __uint_as_float((__float_as_uint(ds[e]) & 0xffff0000u) | 0x8000u);
            ties |= static_cast<uint32_t>(fabsf(ds[e] - mid) <= eps) << (4 * n + 2 * h + e);
          }
        }
        if constexpr (kRegA) {
          pa[n][h] = pack_bf16(p[0], p[1]);
          sa[n][h] = pack_bf16(ds[0], ds[1]);
          if constexpr (Fused) *reinterpret_cast<uint32_t*>(sS + kl * LDP + ql) = sa[n][h];
        } else {
          store2(sP + kl * LDP + ql, p[0], p[1]);
          store2(sS + kl * LDP + ql, ds[0], ds[1]);
        }
      }
    }
    // kernel 4, bf16: the warp's first 16 flagged elements go into its
    // queue; entry i is recomputed, as kernel 2 computes it, by lanes 2i (s)
    // and 2i + 1 (dp) beside their dV, dK products. A lane keeps in `ties`
    // what did not fit, and recomputes it itself afterwards.
    int rk = 0, rq = 0;  // the lane's queued element: key and query in the tile
    bool redo = false;
    float racc = 0.f;  // its s (even lane) or dp (odd lane)
    if constexpr (kTies) {
      uint32_t* queue = sQueue + 32 * warp;
      const int count = __popc(ties);
      int end = count;  // inclusive prefix sum of the counts over the lanes
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, end, o);
        if (lane >= o) end += y;
      }
      const int total = __shfl_sync(0xffffffffu, end, 31);
      for (int pos = end - count; ties != 0 && pos < 16; ++pos) {
        const int b = __ffs(ties) - 1;
        ties &= ties - 1;
        queue[pos] = static_cast<uint32_t>((wk + g + 8 * ((b >> 1) & 1)) << 8 |
                                           (wq + 8 * (b >> 2) + 2 * t + (b & 1)));
      }
      __syncwarp();
      if (lane / 2 < total) {
        const uint32_t item = queue[lane / 2];
        rk = static_cast<int>(item >> 8);
        rq = static_cast<int>(item & 0xffu);
        redo = true;
      }
    }
    if constexpr (!kRegA) __syncthreads();  // P^T and dS^T of every warp are in

    // dV += P^T dO and dK += dS^T Q over the tile's queries, on the warp's
    // 16 keys x kDw columns
    if (!dead) {
#pragma unroll(kUnroll)
      for (int kk = 0; kk < BR; kk += KK) {
        FA ap, as;
        if constexpr (kRegA) {
          const int n = kk / 8;  // the n8 tiles n, n + 1 of the fragments
          ap = {{pa[n][0], pa[n][1], pa[n + 1][0], pa[n + 1][1]}};
          as = {{sa[n][0], sa[n][1], sa[n + 1][0], sa[n + 1][1]}};
        } else {
          load_a_mk(ap, sP + wk * LDP + kk, LDP, lane);
          load_a_mk(as, sS + wk * LDP + kk, LDP, lane);
        }
#pragma unroll
        for (int n = 0; n < kDTiles; n += 2) {
          FB bo[2], bq[2];
          load_b_kn(bo, tO + kk * LD + wd + 8 * n, LD, lane);
          load_b_kn(bq, tQ + kk * LD + wd + 8 * n, LD, lane);
          mma(acc_v[n], ap, bo[0]);
          mma(acc_v[n + 1], ap, bo[1]);
          mma(acc_k[n], as, bq[0]);
          mma(acc_k[n + 1], as, bq[1]);
        }
        if constexpr (kTies) {  // a quarter of the recomputed s or dp
          constexpr int kRun = D / (BR / KK);
          const int c0 = kk / KK * kRun;
          racc = dot_run<kRun>((lane & 1 ? tO : tQ) + rq * LD + c0,
                               (lane & 1 ? sV : sK) + rk * LD + c0, racc);
        }
      }
    }

    if constexpr (kTies) {
      // dS^T takes kernel 2's bf16 ds of the flagged elements, after the
      // dK products that read the warp's keys (its own, and at kSplit = 2
      // its partner's) are done: kernel 4's dk stays kernel 3's
      const float rdp = __shfl_xor_sync(0xffffffffu, racc, 1);
      const bf16 fixed = __float2bfloat16(exp2f(fminf(racc, 80.f) - tLse[rq]) * (rdp - tDelta[rq]));
      if constexpr (kRegA) {
        // the warp's dK product took dS^T from its registers
      } else {
        static_assert(C::kSplit == 2, "a key group's warps are adjacent pairs");
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + warp / 2) : "memory");
      }
      if (redo && (lane & 1) == 0) sS[rk * LDP + rq] = fixed;
      while (ties != 0) {  // what did not fit in the queue (rare)
        const int b = __ffs(ties) - 1;
        ties &= ties - 1;
        const int kl = wk + g + 8 * ((b >> 1) & 1);
        const int ql = wq + 8 * (b >> 2) + 2 * t + (b & 1);
        const float s2 = dot_run<D>(tQ + ql * LD, sK + kl * LD, 0.f);
        const float dp2 = dot_run<D>(tO + ql * LD, sV + kl * LD, 0.f);
        sS[kl * LDP + ql] = __float2bfloat16(exp2f(fminf(s2, 80.f) - tLse[ql]) * (dp2 - tDelta[ql]));
      }
    }
    if constexpr (Fused && (kTies || kRegA)) __syncthreads();  // dS^T is whole for the dq part

    if constexpr (Fused) {
      // the tile's dq part dS K (BR x D): warp w takes rows 16 (w % kRowGroups)
      // and kDqCols columns from kDqCols (w / kRowGroups), in passes of
      // kPassCols (32 f32 registers a thread beside the dK, dV accumulators,
      // 16 for f32, whose fragments take twice the registers); at f32 D = 32
      // only the first kRowGroups * kColGroups warps
      constexpr int kRowGroups = BR / 16;
      constexpr int kColGroups =
          kDkvWarps / kRowGroups < D / 16 ? kDkvWarps / kRowGroups : D / 16;
      constexpr int kDqCols = D / kColGroups;
      constexpr int kPassMax = C::kBf16 ? 64 : 32;
      constexpr int kPassCols = kDqCols < kPassMax ? kDqCols : kPassMax;
      constexpr int kPassTiles = kPassCols / 8;
      static_assert(kPassTiles % 2 == 0 && kDqCols % kPassCols == 0, "whole n8 tile pairs");
      const bool dq_warp = warp < kRowGroups * kColGroups;
      const int dr = (warp % kRowGroups) * 16;
      const int dc = (warp / kRowGroups) * kDqCols;
      int* lock = dq_lock + static_cast<size_t>(bh) * ((sq + BR - 1) / BR) + q0 / BR;
#pragma unroll 1
      for (int c0 = dc; c0 < dc + kDqCols; c0 += kPassCols) {
        float part[kPassTiles][4];
#pragma unroll
        for (int n = 0; n < kPassTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
        }
        if (dq_warp) {
#pragma unroll(kUnroll)
          for (int kk = 0; kk < BC; kk += KK) {
            FA a;  // dS (queries x keys) from the dS^T tile
            load_a_km(a, sS + kk * LDP + dr, LDP, lane);
#pragma unroll
            for (int n = 0; n < kPassTiles; n += 2) {
              FB b[2];
              load_b_kn(b, sK + kk * LD + c0 + 8 * n, LD, lane);
              mma(part[n], a, b[0]);
              mma(part[n + 1], a, b[1]);
            }
          }
        }
        if (c0 == dc) {
          // ordered add: the key blocks before this one have added their parts
          if (threadIdx.x == 0) {
            while (ld_acquire(lock) != kbi) __nanosleep(64);
          }
          __syncthreads();
        }
        if (dq_warp) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = q0 + dr + g + 8 * h;
            if (row >= sq) continue;
            float2* dst = reinterpret_cast<float2*>(
                dq_acc + (static_cast<size_t>(bh) * sq + row) * D + c0 + 2 * t);
#pragma unroll
            for (int n = 0; n < kPassTiles; ++n) {
              // one thread adds each element, after the blocks before it
              atomicAdd(dst + 4 * n, make_float2(part[n][2 * h], part[n][2 * h + 1]));
            }
          }
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {  // the block's adds are visible before the counter moves
        __threadfence();
        st_release(lock, kbi + 1);
      }
    }
    __syncthreads();  // stage st, P^T and dS^T are rewritten by the next tile
  }
  cp_async_wait<0>();  // a block with no q tile has its K, V copies in flight

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + wk + g + 8 * h;
    if (key >= sk) continue;
    const size_t off = (static_cast<size_t>(bh) * sk + key) * D + wd + 2 * t;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      store2(dk + off + 8 * n, acc_k[n][2 * h], acc_k[n][2 * h + 1]);
      // dO arrived multiplied by ln2 for ds; dv must not carry it
      store2(dv + off + 8 * n, acc_v[n][2 * h] * kLog2e, acc_v[n][2 * h + 1] * kLog2e);
    }
  }
}

// Kernel 3 and kernel 4: one signature, so that one launcher serves both.
template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    const float* __restrict__ dout_norm, int sq, int sk, int num_kb, int causal) {
  dkv_block<T, D, false>(q, k, v, dout, lse2, delta, dk, dv, dq_acc, dq_lock, dout_norm, sq, sk,
                         num_kb, causal);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads) flash_bwd_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    const float* __restrict__ dout_norm, int sq, int sk, int num_kb, int causal) {
  dkv_block<T, D, true>(q, k, v, dout, lse2, delta, dk, dv, dq_acc, dq_lock, dout_norm, sq, sk,
                        num_kb, causal);
}

enum class Entry { kDq, kDkv, kFused };

struct Args {
  const void *q, *k, *v, *dout, *lse2, *delta;
  void *out0, *out1, *out2;  // dq; or dk and dv; or the f32 dq buffer, dk and dv
  void* dq_lock;  // kernel 4's dq counters, else nullptr
  const void* dout_norm;  // kernel 4: the dO rows' norms (bf16 only), else nullptr
  int bh, sq, sk, causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_qb = (a.sq + kBlock - 1) / kBlock;
  kernel<<<num_qb * a.bh, kDqThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.sq, a.sk, num_qb, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool Fused>
int launch_dkv(const Args& a) {
  using C = DkvCfg<T, D>;
  static_assert(C::kSmem <= 232448, "shared memory of one block");
  auto kernel = Fused ? flash_bwd_fused_kernel<T, D> : flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_kb = (a.sk + C::kBc - 1) / C::kBc;
  void* dk = Fused ? a.out1 : a.out0;
  void* dv = Fused ? a.out2 : a.out1;
  kernel<<<num_kb * a.bh, kDkvThreads, C::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<T*>(dk), static_cast<T*>(dv),
      Fused ? static_cast<float*>(a.out0) : nullptr,
      Fused ? static_cast<int*>(a.dq_lock) : nullptr, static_cast<const float*>(a.dout_norm),
      a.sq, a.sk, num_kb, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <Entry E, typename T, int D>
int launch_entry(const Args& a) {
  if constexpr (E == Entry::kDq) {
    return launch_dq<T, D>(a);
  } else {
    return launch_dkv<T, D, E == Entry::kFused>(a);
  }
}

template <Entry E, typename T>
int launch_d(const Args& a, int d) {
  switch (d) {
    case 32: return launch_entry<E, T, 32>(a);
    case 64: return launch_entry<E, T, 64>(a);
    case 128: return launch_entry<E, T, 128>(a);
    case 256: return launch_entry<E, T, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <Entry E>
int launch(const Args& a, int d, int dtype, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) return launch_d<E, float>(a, d);
  if (dtype == 1) return launch_d<E, __nv_bfloat16>(a, d);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (bh, sq, d) prescaled, k and v (bh, sk, d), dout (bh, sq, d) times ln2,
// all in one type (dtype 0 = f32, 1 = bf16); lse2 and delta (bh, sq) f32;
// dq (bh, sq, d) in the input type. All contiguous. Launches on `stream` of
// `device` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int gm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse2, const void* delta, void* dq, int bh, int sq,
                               int sk, int d, int dtype, int causal, int device, void* stream) {
  const Args a{q,  k,  v,  dout,   lse2, delta, dq, nullptr, nullptr, nullptr, nullptr,
               bh, sq, sk, causal, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kDq>(a, d, dtype, device);
}

// The same inputs; dk and dv (bh, sk, d) in the input type.
extern "C" int gm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse2, const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int d, int dtype, int causal, int device,
                                void* stream) {
  const Args a{q,  k,  v,  dout,   lse2, delta, dk, dv, nullptr, nullptr, nullptr,
               bh, sq, sk, causal, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kDkv>(a, d, dtype, device);
}

// The same inputs and `dout_norm`, f32 (bh, sq), the Euclidean norms of
// dout's rows (read for bf16 only); one launch adds dq into `dq_acc`, f32
// (bh, sq, d) and zeroed by the caller, in the order kept by `dq_lock`, int32,
// at least bh * ceil(sq / Br) of them (Br = kBrBf16 or kBrF32 by input type)
// and zeroed by the caller, and writes dk and dv (bh, sk, d) in the input type.
extern "C" int gm_flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse2, const void* delta, const void* dout_norm,
                                  void* dq_acc, void* dq_lock, void* dk, void* dv, int bh, int sq,
                                  int sk, int d, int dtype, int causal, int device, void* stream) {
  const Args a{q,  k,  v,  dout,   lse2, delta, dq_acc, dk, dv, dq_lock, dout_norm,
               bh, sq, sk, causal, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kFused>(a, d, dtype, device);
}
