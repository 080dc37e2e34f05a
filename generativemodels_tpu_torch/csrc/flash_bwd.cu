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
// product takes bf16 operands (exact in f32) with f32 accumulation; for f32
// inputs everything is f32 on the CUDA cores, with no TF32.
//
// What bounds it on this card: at the 2D training shape (BH=128, S=1024,
// D=256) the split kernels do 3 + 4 = 7 BH*S*S*D multiply-adds (the forward
// does 2) on 4 operand tensors of 64 MB (bf16) that a block reads tile by
// tile from L2, so they are bound by arithmetic; the fused kernel shares the
// s and dp recomputations and does 5. This first version runs all products
// as f32 FMAs on the CUDA cores with operands in shared memory, so
// shared-memory bandwidth and the FMA rate bound it, far below the
// tensor-core rate; wgmma with TMA is later work.
// What the design does about it:
// - dq (kernel 2): one block per (bh, 32 query rows), 4 warps of 8 rows,
//   looping over key tiles of 32 (one key per lane), as flash_fwd.cu loops:
//   the TPU's sequential innermost grid axis becomes the loop. The (32 x D)
//   f32 accumulator lives in registers, 8 rows x D/32 columns a thread. Q
//   and dO stay in shared memory for the whole loop; K and V tiles are
//   padded by 4 floats a row so the 16-byte reads of a warp, one row a lane,
//   hit distinct banks. The dS tile of a warp's rows is private to that
//   warp, so only __syncwarp separates its write from the dS K product.
// - dkv (kernel 3): one block per (bh, 32 keys), 8 warps of 4 keys, looping
//   over query tiles of 32 (one query row a lane). It holds two (32 x D)
//   accumulators, dK and dV; at D=256 that is 128 f32 a thread over 128
//   threads, so the block has 256 threads and each keeps 4 keys x D/32
//   columns of each (64 registers). K and V of the block stay in shared
//   memory; Q and dO tiles are padded as K and V are in dq. The P and dS
//   rows of a warp's keys are private to that warp.
// - fused (kernel 4): kernel 3's loop with a third product per q tile, the
//   tile's dq part ds^T K over the block's keys, which every thread reads
//   from shared memory after a block barrier (ds of all warps' keys). The
//   TPU kernel writes one f32 partial-dq slab per kv tile and sums them in
//   XLA in a fixed order; at the 3D shape (BH=2, S=32768, D=64) that would
//   be 512 slabs of 16 MiB (8.6 GB). Here the blocks add their parts into
//   one zeroed f32 (BH, Sq, D) buffer in a fixed order, so dq is the same
//   to the bit from run to run: one int counter per (bh, 32-row q tile),
//   zeroed by the caller, counts the kv blocks whose part of that tile is
//   in. Key block kb of a head waits (thread 0 spins on an ld.acquire.gpu
//   with __nanosleep) until the counter equals kb, the number of key blocks
//   before it that touch the tile (under the causal mask a block starts at
//   its own first key, so every block before it has touched the tile too),
//   adds its part with a plain load-add-store that bypasses L1, and after
//   a __threadfence and a block barrier sets the counter to kb + 1 with a
//   st.release.gpu. So dq = ((part_0 + part_1) + ...) in key-block order.
//   This relies on the blocks of one head being dispatched in blockIdx
//   order (blockIdx.x = bh * num_kb + kb): a block waits only for blocks
//   with a smaller index, which are resident or done, so the wait ends. A
//   thread owns 4 columns of D/32 rows, so a warp adds 16-byte pieces of
//   whole rows. Adds number BH * Sq * D/4 * ceil(Sk / BK), so the block
//   takes BK = 64 keys (8 warps of 8 keys) at D <= 64; at D >= 128 the dK
//   and dV accumulators leave room for 32 keys only. dK and dV follow
//   kernel 3's per-element order (the same q tiles in the same order, the
//   same FMA chain; the extra causal q tiles of a 64-key block add exact
//   zeros), so they equal kernel 3's to the bit. The caller casts dq once.
// Kernels 2 and 3 are deterministic too: dq rows belong to one block, dK/dV
// rows to one block. Under the causal mask, tiles
// wholly above the diagonal are skipped (the conditions of _dq_kernel and
// _dkv_kernel); rows past Sq and keys past Sk get p == 0 and are not
// written. Shared memory is dynamic (about 140 KB at D=256), above the
// 48 KB static limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 32;  // query rows of a q tile, keys of kernel 2's kv tile
constexpr int kDqThreads = 128;  // 4 warps x 8 query rows
constexpr int kDqRowsPerWarp = 8;
constexpr int kDkvWarps = 8;
constexpr int kDkvThreads = 32 * kDkvWarps;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Keys a warp owns in the dkv-shaped kernels: kernel 3 always 4 (32-key
// blocks); kernel 4 8 at D <= 64 (64-key blocks), else 4.
template <bool Fused, int D>
constexpr int kKeysPerWarpOf = Fused && D <= 64 ? 8 : 4;

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

// Copy `Rows` rows of width D (row-major, contiguous) into shared memory as
// f32 with row stride `ld`; rows at or past `valid` are zero-filled.
template <typename T, int D, int NThreads, int Rows = kBlock>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int valid) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecsPerRow = D / kVec;
  for (int i = threadIdx.x; i < Rows * kVecsPerRow; i += NThreads) {
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

// Shared memory of kernel 2 (Keys = 32) and of the dkv-shaped kernels (Keys
// = their block's keys): two tiles of Keys rows at stride D, two of 32 rows
// at stride D + 4, two Keys x 32 tiles (dkv: P and dS; dq uses one), lse2
// and delta rows.
template <int D, int Keys = kBlock>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * Keys * D + 2 * kBlock * (D + 4) + 2 * Keys * kBlock + 2 * kBlock);
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

// The block of kernels 3 (Fused = false) and 4 (Fused = true). Grid: one
// block per (bh, kKeys-key block), flattened into blockIdx.x. Kernel 4 also
// adds each q tile's dq part into `dq_acc`, f32 (bh, sq, D), zeroed by the
// caller, in key-block order kept by `dq_lock`, int (bh, ceil(sq / 32)),
// zeroed by the caller; kernel 3 gets nullptr for both.
template <typename T, int D, bool Fused>
__device__ __forceinline__ void dkv_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    int sq, int sk, int num_kb, int causal) {
  static_assert(D % 32 == 0, "head width must be a multiple of 32");
  constexpr int kKeysPerWarp = kKeysPerWarpOf<Fused, D>;
  constexpr int kKeys = kDkvWarps * kKeysPerWarp;  // keys of the block
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 32;  // accumulator columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                  // kKeys x D
  float* sV = sK + kKeys * D;        // kKeys x D
  float* sQ = sV + kKeys * D;        // kBlock x kLd
  float* sDO = sQ + kBlock * kLd;    // kBlock x kLd
  float* sP = sDO + kBlock * kLd;    // kKeys keys x kBlock rows
  float* sDS = sP + kKeys * kBlock;  // kKeys keys x kBlock rows
  float* sLse = sDS + kKeys * kBlock;
  float* sDelta = sLse + kBlock;

  const int bh = blockIdx.x / num_kb;
  const int kbi = blockIdx.x % num_kb;
  const int k0 = kbi * kKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = warp * kKeysPerWarp;  // first tile key of this warp
  const int kvalid = min(kKeys, sk - k0);
  const size_t key0 = static_cast<size_t>(bh) * sk + k0;

  load_tile<T, D, kDkvThreads, kKeys>(sK, D, k + key0 * D, kvalid);
  load_tile<T, D, kDkvThreads, kKeys>(sV, D, v + key0 * D, kvalid);

  float acc_k[kKeysPerWarp][kCols], acc_v[kKeysPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kKeysPerWarp; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  }

  // kernel 4's dq part: a thread owns the 4 columns at `dq_col` of the
  // kDqRows tile rows from `dq_row`
  constexpr int kColVecs = D / 4;
  constexpr int kDqRows = kBlock * kColVecs / kDkvThreads;  // D / 32
  const int dq_col = (threadIdx.x % kColVecs) * 4;
  const int dq_row = (threadIdx.x / kColVecs) * kDqRows;

  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* ob = dout + static_cast<size_t>(bh) * sq * D;
  // under the causal mask, query rows before the block's first key are dead
  for (int q0 = causal ? k0 : 0; q0 < sq; q0 += kBlock) {
    __syncthreads();  // the previous tile is fully consumed
    const int qvalid = min(kBlock, sq - q0);
    load_tile<T, D, kDkvThreads>(sQ, kLd, qb + static_cast<size_t>(q0) * D, qvalid);
    load_tile<T, D, kDkvThreads>(sDO, kLd, ob + static_cast<size_t>(q0) * D, qvalid);
    const size_t row0 = static_cast<size_t>(bh) * sq + q0;
    load_rows(sLse, sDelta, lse2 + row0, delta + row0, qvalid);
    __syncthreads();

    // s[i] = q[lane] . k[c0 + i], dp[i] = do[lane] . v[c0 + i]
    float s[kKeysPerWarp], dp[kKeysPerWarp];
#pragma unroll
    for (int i = 0; i < kKeysPerWarp; ++i) s[i] = dp[i] = 0.f;
    const float* qrow = sQ + lane * kLd;
    const float* orow = sDO + lane * kLd;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qq = *reinterpret_cast<const float4*>(qrow + d);
      const float4 oo = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
      for (int i = 0; i < kKeysPerWarp; ++i) {
        s[i] = dot4(qq, *reinterpret_cast<const float4*>(sK + (c0 + i) * D + d), s[i]);
        dp[i] = dot4(oo, *reinterpret_cast<const float4*>(sV + (c0 + i) * D + d), dp[i]);
      }
    }

    const int row = q0 + lane;
    const float lse_r = sLse[lane];
    const float delta_r = sDelta[lane];
#pragma unroll
    for (int i = 0; i < kKeysPerWarp; ++i) {
      const int col = k0 + c0 + i;
      const bool live = row < sq && col < sk && (!causal || col <= row);
      const float p = live ? exp2f(fminf(s[i], 80.f) - lse_r) : 0.f;
      sP[(c0 + i) * kBlock + lane] = round_to<T>(p);
      sDS[(c0 + i) * kBlock + lane] = round_to<T>(p * (dp[i] - delta_r));
    }
    if constexpr (Fused) {
      __syncthreads();  // the dq part reads the dS rows of every warp's keys
    } else {
      __syncwarp();
    }

    // acc_v[i][j] += sum_r p[c0 + i][r] * do[r][lane + 32 j]
    // acc_k[i][j] += sum_r ds[c0 + i][r] * q[r][lane + 32 j]
#pragma unroll 1
    for (int r = 0; r < kBlock; r += 4) {
      float4 pp[kKeysPerWarp], dd[kKeysPerWarp];
#pragma unroll
      for (int i = 0; i < kKeysPerWarp; ++i) {
        pp[i] = *reinterpret_cast<const float4*>(sP + (c0 + i) * kBlock + r);
        dd[i] = *reinterpret_cast<const float4*>(sDS + (c0 + i) * kBlock + r);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int cj = lane + 32 * j;
        const float4 oo = make_float4(sDO[(r + 0) * kLd + cj], sDO[(r + 1) * kLd + cj],
                                      sDO[(r + 2) * kLd + cj], sDO[(r + 3) * kLd + cj]);
        const float4 qq = make_float4(sQ[(r + 0) * kLd + cj], sQ[(r + 1) * kLd + cj],
                                      sQ[(r + 2) * kLd + cj], sQ[(r + 3) * kLd + cj]);
#pragma unroll
        for (int i = 0; i < kKeysPerWarp; ++i) {
          acc_v[i][j] = dot4(pp[i], oo, acc_v[i][j]);
          acc_k[i][j] = dot4(dd[i], qq, acc_k[i][j]);
        }
      }
    }

    if constexpr (Fused) {
      // part[m] = sum_c ds[c][dq_row + m] * k[c][dq_col .. dq_col + 3]
      float4 part[kDqRows];
#pragma unroll
      for (int m = 0; m < kDqRows; ++m) part[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int c = 0; c < kKeys; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(sK + c * D + dq_col);
#pragma unroll
        for (int m = 0; m < kDqRows; ++m) {
          const float ds = sDS[c * kBlock + dq_row + m];
          part[m].x = fmaf(ds, kk.x, part[m].x);
          part[m].y = fmaf(ds, kk.y, part[m].y);
          part[m].z = fmaf(ds, kk.z, part[m].z);
          part[m].w = fmaf(ds, kk.w, part[m].w);
        }
      }
      // ordered add: the key blocks before this one have added their parts
      int* lock = dq_lock + static_cast<size_t>(bh) * ((sq + kBlock - 1) / kBlock) + q0 / kBlock;
      if (threadIdx.x == 0) {
        while (ld_acquire(lock) != kbi) __nanosleep(64);
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kDqRows; ++m) {
        if (dq_row + m < qvalid) {
          float4* dst = reinterpret_cast<float4*>(dq_acc + (row0 + dq_row + m) * D + dq_col);
          float4 cur = __ldcg(dst);
          cur.x += part[m].x;
          cur.y += part[m].y;
          cur.z += part[m].z;
          cur.w += part[m].w;
          __stcg(dst, cur);
        }
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) st_release(lock, kbi + 1);
    }
  }

#pragma unroll
  for (int i = 0; i < kKeysPerWarp; ++i) {
    const int key = k0 + c0 + i;
    if (key >= sk) continue;
    const size_t off = (static_cast<size_t>(bh) * sk + key) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[off + lane + 32 * j] = from_float<T>(acc_k[i][j]);
      // dO arrived multiplied by ln2 for ds; dv must not carry it
      dv[off + lane + 32 * j] = from_float<T>(acc_v[i][j] * kLog2e);
    }
  }
}

// Kernel 3 and kernel 4: one signature, so that one launcher serves both.
template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    int sq, int sk, int num_kb, int causal) {
  dkv_block<T, D, false>(q, k, v, dout, lse2, delta, dk, dv, dq_acc, dq_lock, sq, sk, num_kb,
                         causal);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads) flash_bwd_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    int sq, int sk, int num_kb, int causal) {
  dkv_block<T, D, true>(q, k, v, dout, lse2, delta, dk, dv, dq_acc, dq_lock, sq, sk, num_kb,
                        causal);
}

enum class Entry { kDq, kDkv, kFused };

struct Args {
  const void *q, *k, *v, *dout, *lse2, *delta;
  void *out0, *out1, *out2;  // dq; or dk and dv; or the f32 dq buffer, dk and dv
  void* dq_lock;  // kernel 4's dq counters, else nullptr
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
  constexpr int keys = kDkvWarps * kKeysPerWarpOf<Fused, D>;
  constexpr size_t smem = smem_bytes<D, keys>();
  auto kernel = Fused ? flash_bwd_fused_kernel<T, D> : flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_kb = (a.sk + keys - 1) / keys;
  void* dk = Fused ? a.out1 : a.out0;
  void* dv = Fused ? a.out2 : a.out1;
  kernel<<<num_kb * a.bh, kDkvThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<T*>(dk), static_cast<T*>(dv),
      Fused ? static_cast<float*>(a.out0) : nullptr,
      Fused ? static_cast<int*>(a.dq_lock) : nullptr, a.sq, a.sk, num_kb, a.causal);
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
  const Args a{q, k, v, dout, lse2, delta, dq, nullptr, nullptr, nullptr, bh, sq, sk, causal,
               static_cast<cudaStream_t>(stream)};
  return launch<Entry::kDq>(a, d, dtype, device);
}

// The same inputs; dk and dv (bh, sk, d) in the input type.
extern "C" int gm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse2, const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int d, int dtype, int causal, int device,
                                void* stream) {
  const Args a{q, k, v, dout, lse2, delta, dk, dv, nullptr, nullptr, bh, sq, sk, causal,
               static_cast<cudaStream_t>(stream)};
  return launch<Entry::kDkv>(a, d, dtype, device);
}

// The same inputs; one launch adds dq into `dq_acc`, f32 (bh, sq, d) and
// zeroed by the caller, in the order kept by `dq_lock`, int32 (bh,
// ceil(sq / 32)) and zeroed by the caller, and writes dk and dv (bh, sk, d)
// in the input type.
extern "C" int gm_flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse2, const void* delta, void* dq_acc,
                                  void* dq_lock, void* dk, void* dv, int bh, int sq, int sk, int d,
                                  int dtype, int causal, int device, void* stream) {
  const Args a{q, k, v, dout, lse2, delta, dq_acc, dk, dv, dq_lock, bh, sq, sk, causal,
               static_cast<cudaStream_t>(stream)};
  return launch<Entry::kFused>(a, d, dtype, device);
}
