// Flash-attention forward for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel generativemodels_tpu/ops/flash_attention.py
// ::_flash_fwd_impl (its `_fwd_kernel`, with _fwd_tile, _build_mask and
// _pv_update) in its default contract: q arrives unscaled and is multiplied
// here by qscale = scale*log2(e) (already rounded to q's type) and rounded
// back to q's type, as the JAX wrapper prescales q; scores live in the log2
// domain and are clamped above at 80, there is no running max, p = exp2(s)
// in f32, O = (p V) / max(l, 1e-30) and lse = lse_mul * log2(max(l, 1e-30)):
// lse_mul = ln2 gives the natural-log row logsumexp, 1 the log2-domain lse
// the backward reads. Masked keys (ragged kv edge, causal upper triangle)
// get p == 0 exactly; rows past Sq are computed on zeros and never written.
// For bf16 inputs p is rounded to bf16 before the PV product. The row sum l
// follows the JAX kernel by head width: at D % 128 != 0 JAX pads a ones
// column onto V (`fold_l`), so l is the f32 sum of the bf16-rounded p; at
// D % 128 == 0 it is the f32 sum of the unrounded p (for f32 the two agree).
//
// What bounds it on this card:
// - 3D shape (BH=2, S=32768, D=64, bf16): 4 BH S^2 D = 5.5e11 operations on
//   16 MB of operands, 0.556 ms at the bf16 tensor-core rate (989 TFLOP/s)
//   against 0.005 ms for the bytes: bound by operations. With mma.sync the
//   tensor pipe's issue rate and the K/V fragment reads from shared memory
//   set the floor (the probes of csrc/flash_probes.cu measured it: 1.86 ms
//   for the products alone, 1.85-1.90 ms with two 16-row fragments a warp).
// - Serving shape (BH=4, S=1024, D=256, f32): 4.3e9 useful operations on 16
//   MB, 0.064 ms at the CUDA-core f32 rate. The f32 path runs on the tensor
//   cores as 3xTF32 (three TF32 products per f32 product), 1.3e10
//   operations, 0.026 ms at the TF32 rate (495 TFLOP/s). Only 4096 query
//   rows exist, 256 warps of 16 rows: one warp a row fragment would leave
//   each SM sub-partition one warp walking all 1024 keys, whose dependent
//   chain of loads, splits and products bounds it (0.30 ms measured, slower
//   than the plain version's 0.18).
//
// What the design does about it (the FlashAttention-2 register reuse, as
// the probes): a warp owns 16-row fragments of q, and the warps of a block
// loop over key tiles staged in shared memory by cp.async two deep, so the
// next tile's copy runs under this tile's products; the TPU's sequential
// innermost grid axis becomes that loop.
// - bf16: both products with mma.sync m16n8k16 (bf16 operands, f32
//   accumulation). Two fragments a warp at D <= 64 (128-row blocks), so each
//   K/V fragment read from shared memory feeds two products; one above. Q
//   fragments stay in registers for the whole loop at D <= 128 and are
//   re-read from shared memory (ldmatrix) at D = 256, where the 16 x 256 f32
//   O accumulator alone takes 128 registers a thread and the key tile is cut
//   to 32. K fragments by ldmatrix, V fragments by ldmatrix.trans, rows
//   padded to D + 8 bf16 so the eight rows an ldmatrix reads fall in
//   distinct banks. The S accumulator, rounded to bf16 pairs, is the A
//   operand of the PV product without a trip through shared memory. At
//   D % 128 != 0 l comes from one more n8 product against a tile of ones
//   (exactly JAX's ones column); at D % 128 == 0 each thread sums its
//   unrounded p and a quad shuffle finishes the rows.
// - f32: mma.sync m16n8k8 TF32 as 3xTF32. A block of 8 warps holds 32
//   query rows; warp w takes row group w / 4 and a quarter (slice w % 4) of
//   every key tile, so the serving shape puts 8 warps on each of 128 SMs;
//   without a running max the slices' partial O and l simply add, in slice
//   order through shared memory at the end. Each f32 operand a is split into
//   hi = tf32(a) and lo = tf32(a - hi) (Q once, into two shared tiles; K, V
//   as they are read), and each product is
//   lo*hi + hi*lo + hi*hi with f32 accumulation (lo*lo, ~2^-22 of it, is
//   dropped), so the result stays within f32 summation error of the plain
//   version. The unrounded f32 p is split the same way. The S accumulator
//   holds keys 2t and 2t + 1 of each n8 tile where the TF32 A operand wants
//   columns t and t + 4, so the PV product numbers its keys in that order
//   and reads V rows 2t and 2t + 1 (rows padded to D + 4 floats, so a
//   warp's reads hit 32 banks). l is each thread's f32 sum with a quad
//   shuffle.
// - Causal: key tiles wholly above a block's last row are never loaded
//   (kv_end); a warp skips the tiles wholly above its own rows; only tiles
//   that cross the diagonal or the ragged kv edge are masked.
// - Ragged Sk: K and V rows past Sk are zero-filled in shared memory
//   (cp.async with src-size 0), so a masked p of 0 never meets a stale NaN
//   inside an mma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 (1, 1)

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// p of a score: exp2 of the score clamped at 80 (a masked score is -inf, so 0)
__device__ __forceinline__ float prob(float s) { return exp2f(fminf(s, 80.f)); }

// Tile shapes of one instantiation.
template <typename T, int D>
struct Cfg;

// bf16: 4 warps, each owning kM 16-row fragments and every key of a tile.
template <int D>
struct Cfg<bf16, D> {
  static constexpr int kM = D <= 64 ? 2 : 1;  // 16-row q fragments a warp
  static constexpr int kThreads = 128;
  static constexpr int kBlockQ = 4 * 16 * kM;
  static constexpr int kBlockK = D == 256 ? 32 : 64;  // keys a tile
  static constexpr int kLd = D + 8;  // shared-memory row stride in elements
  // the scaled Q tile and two stages of K and V tiles
  static constexpr size_t kSmem = sizeof(bf16) * (kBlockQ + 4 * kBlockK) * kLd;
};

// f32: 8 warps, 2 groups of 16 query rows x 4 slices of each key tile, so
// that the few query rows of the serving shape still give each SM
// sub-partition two warps; no running max, so the slices' partial sums add.
template <int D>
struct Cfg<float, D> {
  static constexpr int kRowGroups = 2;
  static constexpr int kKeySlices = 4;
  static constexpr int kThreads = 32 * kRowGroups * kKeySlices;
  static constexpr int kBlockQ = 16 * kRowGroups;
  static constexpr int kBlockK = D >= 128 ? 32 : 64;
  static constexpr int kLd = D + 4;
  // the scaled Q tile split into TF32 hi and lo, and two stages of K and V
  static constexpr size_t kSmem = sizeof(float) * (2 * kBlockQ + 4 * kBlockK) * kLd;
};

// Stage `Rows` rows of width D (contiguous in global memory) from row `r0`
// of `src` into `dst` with row stride Cfg::kLd; rows at or past `valid`
// are zero-filled.
template <typename T, int D, int Rows>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int r0, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;  // 16-byte pieces a row
  constexpr int kLd = Cfg<T, D>::kLd;
#pragma unroll
  for (int i = threadIdx.x; i < Rows * kChunks; i += Cfg<T, D>::kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const bool ok = r0 + r < valid;
    cp_async16(dst + r * kLd + c, src + static_cast<size_t>(ok ? r0 + r : 0) * D + c, ok);
  }
}

// The block's bf16 q rows times qscale, rounded to bf16, into shared
// memory; rows past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_q_bf16(bf16* dst, const bf16* __restrict__ src, int valid,
                                            float qscale) {
  using C = Cfg<bf16, D>;
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < C::kBlockQ * kChunks; i += C::kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
    }
    *reinterpret_cast<uint4*>(dst + r * C::kLd + c) = raw;
  }
}

// The block's f32 q rows times qscale into shared memory, split once into
// their TF32 hi and lo parts; rows past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_q_f32(uint32_t* hi, uint32_t* lo,
                                           const float* __restrict__ src, int valid,
                                           float qscale) {
  using C = Cfg<float, D>;
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < C::kBlockQ * kChunks; i += C::kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * D + c);
    const float e[4] = {x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale};
    uint4 h, l;
    split_tf32(e[0], h.x, l.x);
    split_tf32(e[1], h.y, l.y);
    split_tf32(e[2], h.z, l.z);
    split_tf32(e[3], h.w, l.w);
    *reinterpret_cast<uint4*>(hi + r * C::kLd + c) = h;
    *reinterpret_cast<uint4*>(lo + r * C::kLd + c) = l;
  }
}

// Set the scores of masked (row, key) pairs to -inf: keys at or past sk,
// and under the causal mask keys past the row. s holds the C fragments of
// `KeyTiles` n8 tiles for rows `row` (+8) from key k0.
template <int KeyTiles>
__device__ __forceinline__ void mask_scores(float (&s)[KeyTiles][4], int row, int k0, int sk,
                                            bool causal, int t) {
#pragma unroll
  for (int nt = 0; nt < KeyTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + 2 * t + (e & 1);
      const int r = row + 8 * (e >> 1);
      if (col >= sk || (causal && col > r)) s[nt][e] = -INFINITY;
    }
  }
}

// Grid: one block per (bh, Cfg::kBlockQ query rows), flattened into blockIdx.x.
template <int D>
__global__ void __launch_bounds__(Cfg<bf16, D>::kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      int sq, int sk, int num_qb, int causal, float qscale, float lse_mul) {
  using C = Cfg<bf16, D>;
  constexpr int M = C::kM;
  constexpr int BK = C::kBlockK;
  constexpr int LD = C::kLd;
  constexpr int kDSteps = D / 16;      // k-steps of the QK product
  constexpr int kKeyTiles = BK / 8;    // n8 tiles of S
  constexpr int kKeySteps = BK / 16;   // k-steps of the PV product
  constexpr int kDTiles = D / 8;       // n8 tiles of O
  // Q fragments kept in registers for the whole key loop
  constexpr bool kQInRegs = D <= 128;
  // l from a product against ones: the sum of the bf16-rounded p
  constexpr bool kFoldL = D % 128 != 0;
  static_assert(kDSteps % 2 == 0, "K fragments are read two k-steps at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBlockQ x LD
  bf16* sK = sQ + C::kBlockQ * LD;                // 2 stages x BK x LD
  bf16* sV = sK + 2 * BK * LD;                    // 2 stages x BK x LD

  const int bh = blockIdx.x / num_qb;
  const int q0 = (blockIdx.x % num_qb) * C::kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int mi = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int wr = warp * 16 * M;  // first tile row of this warp
  const int wrow0 = q0 + wr;
  const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk * D;

  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, q0 + C::kBlockQ) : sk;
  const int num_k = (kv_end + BK - 1) / BK;
  if (num_k > 0) {
    stage_tile<bf16, D, BK>(sK, kb, 0, sk);
    stage_tile<bf16, D, BK>(sV, vb, 0, sk);
  }
  cp_async_commit();
  load_q_bf16<D>(sQ, q + (static_cast<size_t>(bh) * sq + q0) * D, min(C::kBlockQ, sq - q0),
                 qscale);
  __syncthreads();

  // A fragment of fragment m, k-step kk: ldmatrix.x4 of rows (mi & 1) * 8 +
  // (lane & 7), columns 16 kk + (mi >> 1) * 8
  const bf16* qa = sQ + (wr + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
  uint32_t qf[kQInRegs ? M : 1][kQInRegs ? kDSteps : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) ldsm_x4(qf[m][kk], qa + m * 16 * LD + kk * 16);
    }
  }

  float acc[M][kDTiles][4];
  float lmma[M][4];  // kFoldL: every column holds the row sums of rows g, g + 8
  float lpart[M][2];  // else: this thread's part of rows g, g + 8
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) lmma[m][e] = 0.f;
    lpart[m][0] = lpart[m][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
    }
  }

  for (int j = 0; j < num_k; ++j) {
    const int st = j & 1;
    const int k0 = j * BK;
    if (j + 1 < num_k) {  // the next tile's copy runs under this tile's products
      stage_tile<bf16, D, BK>(sK + (st ^ 1) * BK * LD, kb, k0 + BK, sk);
      stage_tile<bf16, D, BK>(sV + (st ^ 1) * BK * LD, vb, k0 + BK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // a tile wholly above this warp's rows under the causal mask adds nothing
    if (!causal || k0 <= wrow0 + 16 * M - 1) {
      const bf16* tK = sK + st * BK * LD;
      const bf16* tV = sV + st * BK * LD;
      float s[M][kKeyTiles][4];
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[m][nt][e] = 0.f;
        }
      }
      // s = q k^T; B fragments of key tile nt, k-steps kk and kk + 1 by one
      // ldmatrix.x4 of keys nt * 8 + (lane & 7), columns 16 kk + 8 mi
      const bf16* kbase = tK + (lane & 7) * LD + mi * 8;
#pragma unroll
      for (int kk = 0; kk < kDSteps; kk += 2) {
        uint32_t qr[kQInRegs ? 1 : 2][4];
        if constexpr (!kQInRegs) {
          ldsm_x4(qr[0], qa + kk * 16);
          ldsm_x4(qr[1], qa + (kk + 1) * 16);
        }
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
          uint32_t b[4];
          ldsm_x4(b, kbase + nt * 8 * LD + kk * 16);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            if constexpr (kQInRegs) {
              mma_bf16(s[m][nt], qf[m][kk], b[0], b[1]);
              mma_bf16(s[m][nt], qf[m][kk + 1], b[2], b[3]);
            } else {
              mma_bf16(s[m][nt], qr[0], b[0], b[1]);
              mma_bf16(s[m][nt], qr[1], b[2], b[3]);
            }
          }
        }
      }
      if (k0 + BK > sk || (causal && k0 + BK - 1 > wrow0)) {
#pragma unroll
        for (int m = 0; m < M; ++m) mask_scores(s[m], wrow0 + 16 * m + g, k0, sk, causal, t);
      }

      // acc += bf16(p) V, k-step js over keys 16 js .. 16 js + 15; V
      // fragments by ldmatrix.trans of keys 16 js + (mi & 1) * 8 + (lane &
      // 7), columns 16 dp + (mi >> 1) * 8
      const bf16* vbase = tV + ((mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int js = 0; js < kKeySteps; ++js) {
        uint32_t pa[M][4];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          float p[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 4; ++e) p[h][e] = prob(s[m][2 * js + h][e]);
          }
          // the C layout of the two S tiles is the A layout of the PV product
          pa[m][0] = pack_bf16(p[0][0], p[0][1]);
          pa[m][1] = pack_bf16(p[0][2], p[0][3]);
          pa[m][2] = pack_bf16(p[1][0], p[1][1]);
          pa[m][3] = pack_bf16(p[1][2], p[1][3]);
          if constexpr (!kFoldL) {
            lpart[m][0] += (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
            lpart[m][1] += (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
          }
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, vbase + js * 16 * LD + dp * 16);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            mma_bf16(acc[m][2 * dp], pa[m], b[0], b[1]);
            mma_bf16(acc[m][2 * dp + 1], pa[m], b[2], b[3]);
          }
        }
        if constexpr (kFoldL) {
#pragma unroll
          for (int m = 0; m < M; ++m) mma_bf16(lmma[m], pa[m], kOnes, kOnes);
        }
      }
    }
    __syncthreads();  // stage st is refilled by the copy issued at step j + 1
  }

#pragma unroll
  for (int m = 0; m < M; ++m) {
    float l[2];
    if constexpr (kFoldL) {
      l[0] = lmma[m][0];
      l[1] = lmma[m][2];
    } else {
      l[0] = quad_sum(lpart[m][0]);
      l[1] = quad_sum(lpart[m][1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow0 + 16 * m + g + 8 * h;
      if (row >= sq) continue;
      const float ls = fmaxf(l[h], 1e-30f);
      const size_t off = static_cast<size_t>(bh) * sq + row;
      bf16* orow = o + off * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt) {
        *reinterpret_cast<uint32_t*>(orow + nt * 8) =
            pack_bf16(acc[m][nt][2 * h] / ls, acc[m][nt][2 * h + 1] / ls);
      }
      if (t == 0) lse[off] = log2f(ls) * lse_mul;
    }
  }
}

// Grid as the bf16 kernel's. Warp w owns the 16 query rows of row group
// w / kKeySlices and, of each key tile, the kBlockK / kKeySlices keys of
// slice w % kKeySlices; at the end the slices' partial O and l are summed
// in slice order through shared memory.
template <int D>
__global__ void __launch_bounds__(Cfg<float, D>::kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int sq, int sk, int num_qb, int causal, float qscale, float lse_mul) {
  using C = Cfg<float, D>;
  constexpr int BK = C::kBlockK;
  constexpr int LD = C::kLd;
  constexpr int kSlices = C::kKeySlices;
  constexpr int KS = BK / kSlices;   // keys of a warp's slice of a tile
  constexpr int kDSteps = D / 8;     // k8 steps of the QK product
  constexpr int kKeyTiles = KS / 8;  // n8 tiles of S, each one k8 step of PV
  constexpr int kDTiles = D / 8;     // n8 tiles of O
  // a warp's partial O and l for the final sum: 4 kDTiles + 2 floats a lane
  constexpr int kPart = 32 * (4 * kDTiles + 2);
  static_assert(KS % 8 == 0, "a key slice is whole n8 tiles");
  static_assert((kSlices - 1) * C::kRowGroups * kPart <= 4 * BK * LD,
                "the partial sums fit where the K and V tiles were");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sQh = reinterpret_cast<uint32_t*>(smem_raw);  // kBlockQ x LD, TF32 hi
  uint32_t* sQl = sQh + C::kBlockQ * LD;                   // kBlockQ x LD, TF32 lo
  float* sK = reinterpret_cast<float*>(sQl + C::kBlockQ * LD);  // 2 stages x BK x LD
  float* sV = sK + 2 * BK * LD;                                 // 2 stages x BK x LD

  const int bh = blockIdx.x / num_qb;
  const int q0 = (blockIdx.x % num_qb) * C::kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = warp / kSlices;  // row group
  const int ks = warp % kSlices;  // key slice
  const int wrow0 = q0 + rg * 16;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;

  const int kv_end = causal ? min(sk, q0 + C::kBlockQ) : sk;
  const int num_k = (kv_end + BK - 1) / BK;
  if (num_k > 0) {
    stage_tile<float, D, BK>(sK, kb, 0, sk);
    stage_tile<float, D, BK>(sV, vb, 0, sk);
  }
  cp_async_commit();
  load_q_f32<D>(sQh, sQl, q + (static_cast<size_t>(bh) * sq + q0) * D, min(C::kBlockQ, sq - q0),
                qscale);
  __syncthreads();

  // A fragment of k-step kk: rows g, g + 8 of the group, columns 8 kk + t, + 4
  const int qoff = (rg * 16 + g) * LD + t;
  float acc[kDTiles][4];
  float lpart[2] = {0.f, 0.f};  // this thread's part of rows g, g + 8
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }

  for (int j = 0; j < num_k; ++j) {
    const int st = j & 1;
    const int k0 = j * BK;
    if (j + 1 < num_k) {
      stage_tile<float, D, BK>(sK + (st ^ 1) * BK * LD, kb, k0 + BK, sk);
      stage_tile<float, D, BK>(sV + (st ^ 1) * BK * LD, vb, k0 + BK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int s0 = k0 + ks * KS;  // first key of this warp's slice
    if (!causal || s0 <= wrow0 + 15) {
      const float* tK = sK + st * BK * LD + ks * KS * LD;
      const float* tV = sV + st * BK * LD + ks * KS * LD;
      float s[kKeyTiles][4];
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
      // s = q k^T in 3xTF32; B fragment of key tile nt, k-step kk: key
      // nt * 8 + g, columns 8 kk + t, + 4
#pragma unroll 4
      for (int kk = 0; kk < kDSteps; ++kk) {
        const int c = qoff + kk * 8;
        const uint32_t ahi[4] = {sQh[c], sQh[c + 8 * LD], sQh[c + 4], sQh[c + 8 * LD + 4]};
        const uint32_t alo[4] = {sQl[c], sQl[c + 8 * LD], sQl[c + 4], sQl[c + 8 * LD + 4]};
        const float* kp = tK + g * LD + kk * 8 + t;
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
          uint32_t bhi0, blo0, bhi1, blo1;
          split_tf32(kp[nt * 8 * LD], bhi0, blo0);
          split_tf32(kp[nt * 8 * LD + 4], bhi1, blo1);
          mma_tf32(s[nt], alo, bhi0, bhi1);
          mma_tf32(s[nt], ahi, blo0, blo1);
          mma_tf32(s[nt], ahi, bhi0, bhi1);
        }
      }
      if (s0 + KS > sk || (causal && s0 + KS - 1 > wrow0)) {
        mask_scores(s, wrow0 + g, s0, sk, causal, t);
      }

      // acc += p V in 3xTF32, one k8 step per S tile nt: its A operand
      // takes keys 2t, 2t + 1 as columns t, t + 4, so the B operand reads V
      // rows nt * 8 + 2t and + 1 at column 8 dn + g
      const float* vp = tV + 2 * t * LD + g;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = prob(s[nt][e]);
        lpart[0] += p[0] + p[1];
        lpart[1] += p[2] + p[3];
        uint32_t phi[4], plo[4];
        split_tf32(p[0], phi[0], plo[0]);  // row g, key 2t
        split_tf32(p[2], phi[1], plo[1]);  // row g + 8, key 2t
        split_tf32(p[1], phi[2], plo[2]);  // row g, key 2t + 1
        split_tf32(p[3], phi[3], plo[3]);  // row g + 8, key 2t + 1
        const float* vrow = vp + nt * 8 * LD;
        // unrolled whole, so that acc stays in registers
#pragma unroll
        for (int dn = 0; dn < kDTiles; ++dn) {
          uint32_t bhi0, blo0, bhi1, blo1;
          split_tf32(vrow[dn * 8], bhi0, blo0);
          split_tf32(vrow[LD + dn * 8], bhi1, blo1);
          mma_tf32(acc[dn], plo, bhi0, bhi1);
          mma_tf32(acc[dn], phi, blo0, blo1);
          mma_tf32(acc[dn], phi, bhi0, bhi1);
        }
      }
    }
    __syncthreads();  // stage st is refilled by the copy issued at step j + 1
  }

  // the slices' partial sums, in slice order, into slice 0's registers; the
  // K and V stages are free (the loop ended on a barrier)
  float* part = sK + ((ks - 1) * C::kRowGroups + rg) * kPart + lane;
  if (ks > 0) {
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(4 * nt + e) * 32] = acc[nt][e];
    }
    part[4 * kDTiles * 32] = lpart[0];
    part[(4 * kDTiles + 1) * 32] = lpart[1];
  }
  __syncthreads();
  if (ks > 0) return;
#pragma unroll 1
  for (int sl = 1; sl < kSlices; ++sl) {
    const float* src = sK + ((sl - 1) * C::kRowGroups + rg) * kPart + lane;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += src[(4 * nt + e) * 32];
    }
    lpart[0] += src[4 * kDTiles * 32];
    lpart[1] += src[(4 * kDTiles + 1) * 32];
  }

  const float l[2] = {quad_sum(lpart[0]), quad_sum(lpart[1])};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + g + 8 * h;
    if (row >= sq) continue;
    const float ls = fmaxf(l[h], 1e-30f);
    const size_t off = static_cast<size_t>(bh) * sq + row;
    float* orow = o + off * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      *reinterpret_cast<float2*>(orow + nt * 8) =
          make_float2(acc[nt][2 * h] / ls, acc[nt][2 * h + 1] / ls);
    }
    if (t == 0) lse[off] = log2f(ls) * lse_mul;
  }
}

// The kernel of an input type, chosen at compile time.
template <typename T, int D>
struct KernelOf;
template <int D>
struct KernelOf<bf16, D> {
  static constexpr auto fn = flash_fwd_bf16_kernel<D>;
};
template <int D>
struct KernelOf<float, D> {
  static constexpr auto fn = flash_fwd_f32_kernel<D>;
};

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
           int sk, int causal, float qscale, float lse_mul, cudaStream_t stream) {
  using C = Cfg<T, D>;
  auto kernel = KernelOf<T, D>::fn;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_qb = (sq + C::kBlockQ - 1) / C::kBlockQ;
  kernel<<<num_qb * bh, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, num_qb, causal, qscale, lse_mul);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
             int sk, int d, int causal, float qscale, float lse_mul, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, sq, sk, causal, qscale, lse_mul, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, sq, sk, causal, qscale, lse_mul, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, sq, sk, causal, qscale, lse_mul, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, bh, sq, sk, causal, qscale, lse_mul, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d) in one type (dtype 0 =
// f32, 1 = bf16), lse (bh, sq) f32; all contiguous and 16-byte aligned.
// qscale is scale*log2(e) already rounded to the input type; lse_mul is ln2
// for a natural-log lse, 1 for a log2 one. Launches on `stream` of `device`
// and returns cudaGetLastError() of the launch (0 on success).
extern "C" int gm_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int sq, int sk, int d, int dtype, int causal, float qscale,
                            float lse_mul, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, o, lse, bh, sq, sk, d, causal, qscale, lse_mul, s);
  if (dtype == 1) {
    return launch_d<bf16>(q, k, v, o, lse, bh, sq, sk, d, causal, qscale, lse_mul, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
