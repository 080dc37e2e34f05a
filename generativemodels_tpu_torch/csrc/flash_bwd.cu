// Flash-attention backward for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels of the backward `_flash_bwd` in
// generativemodels_tpu/ops/flash_attention.py: the split backward's
// `_dq_kernel` (with _dq_tile) becomes flash_bwd_dq_kernel (kernel 2) and
// `_dkv_kernel` (with _dkv_tile) flash_bwd_dkv_kernel (kernel 3); the fused
// backward's `_dfused_kernel` (with _dfused_tile, run under
// GMTPU_FLASH_FUSED_BWD=1) becomes flash_bwd_fused_kernel (kernel 4). The
// last two share one body, dkv_block.
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
// D=64, bf16) kernel 2 does 3 products of BH*S*S*D multiply-adds (s, dp,
// dq), 8.2e11 operations, kernel 3 four (s, dp, dv, dk), 1.1e12 operations,
// on 17 MB: 0.83 and 1.11 ms at the bf16 tensor-core rate (989 TFLOP/s),
// bound by operations; kernel 4 adds the fifth, dq, and adds its key
// blocks' dq parts into one f32 buffer. With mma.sync (as kernel 1) the
// tensor pipe's issue rate and the operand fragments read from shared
// memory set the floor.
// - bf16: mma.sync m16n8k16, bf16 operands, f32 accumulation.
// - f32: mma.sync m16n8k8 as 3xTF32, as flash_fwd.cu: each operand a is
//   split into hi = tf32(a) and lo = tf32(a - hi) as it is read (scalar
//   loads, since ldmatrix moves 16-bit elements), and each product is
//   lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 of it, is dropped); the three
//   products of a k8 step start from zero and an f32 add keeps the running
//   sum (the tensor cores do not round their sums to nearest), so results
//   stay within f32 summation error.
//
// One s, dp computation. The three kernels compute s and dp with one
// function, sdp_products, and p and ds with one, prob_ds: the same 16-wide
// (bf16) or 8-wide (f32) d chunks in d order from zero, the same three TF32
// products of an f32 chunk in the same order (key lo x query hi, key hi x
// query lo, key hi x query hi, whichever operand is A), the same exp2f,
// fminf and operation order. Kernel 2 is query-major (A = Q, dO; B = K, V),
// kernels 3 and 4 key-major (A = K, V; B = Q, dO). An mma gives element
// (i, j) of Q K^T the same bits as element (j, i) of K Q^T (the mma sums the
// same products in the same k order; flash_bwd_roles_kernel computes both
// and tests/test_torch_kernels_gpu.py holds them equal to the bit), so each
// ds is the same f32 number in the three kernels and each bf16 ds rounds
// alike: kernel 4's dq differs from kernel 2's only in the order of its f32
// sums over the keys.
//
// Kernel 2 (dq): FlashAttention-2's dq kernel. A block of 8 warps owns one
// (bh, Br query rows); Q, dO and their lse2, delta rows come in once by
// cp.async, and K, V tiles of Bc keys by cp.async two deep, so the next
// tile's copy runs under this tile's products. Warp w owns the 16 rows of
// row group w / kSlices and, of each key tile, the Bc / kSlices keys of
// slice w % kSlices. Per key tile, a warp computes S = Q K^T and
// dP = dO V^T (B fragments of K, V rows by ldmatrix), then p and ds, and
// dq += dS K with the ds C fragments as the A operand straight from
// registers (bf16: packed to bf16 pairs, as kernel 1 feeds P into P V;
// f32: split into TF32 hi and lo, keys numbered as kernel 1's f32 P V) and
// K's B fragments by ldmatrix.trans (f32: scalar loads). Each 16 x 16 block
// of a bf16 dq product is summed over the slice's keys from zero and then
// added in f32, as an f32 k8 step is, so dq stays within f32 summation
// error of kernel 4's over 32768 keys. At the end the slices' partial dq
// add in slice order through shared memory; dq is cast once.
// - bf16, D <= 64: 8 row groups (128 rows), 64-key tiles, the Q and dO A
//   fragments resident in registers for the whole key loop; D = 128: the
//   same tiles, Q and dO fragments re-read by ldmatrix; D = 256: the 16 x
//   256 f32 dq accumulator takes 128 registers a thread, so 4 row groups x
//   2 key slices of 32-key tiles.
// - f32: 2 row groups x 4 key slices (32 rows), 64-key tiles at D <= 64 and
//   32 above (Q, dO and two stages of K, V: 199936 bytes at D = 256).
// - Causal: key tiles wholly past the block's last row are never loaded; a
//   warp skips a slice wholly past its own rows or past Sk.
// - Ragged: Q, dO rows past Sq and K, V rows past Sk are zero-filled in
//   shared memory (cp.async with src-size 0), so a masked p of 0 never
//   meets a stale NaN inside an mma.
//
// Kernels 3 and 4 (dkv_block): FlashAttention-2's key-major backward. A
// block of 8 warps owns one (bh, Bc-key block); K and V stay in shared
// memory in the input type, rows padded to D + 16 bytes so the eight rows
// an ldmatrix (or a quad of scalar loads) reads fall in distinct banks. The
// block loops over q tiles of Br rows; Q, dO and their lse2 and delta rows
// come in by cp.async two deep (one deep for f32 at D = 256, where two
// would not fit), so the next tile's copy runs under this tile's products;
// rows past Sq and keys past Sk are zero-filled. Per q tile:
// - a warp takes a 16-key group and Br / kSplit of the tile's queries and
//   computes S^T = K Q^T and dP^T = V dO^T (A fragments of K, V by
//   ldmatrix, B fragments of Q, dO rows by ldmatrix), then P^T and dS^T,
//   and writes both, rounded to the input type, to shared memory (Bc x Br);
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
// dO, two deep) + 2 x 64 x 72 (P^T, dS^T) bf16 and the rows' lse2 and
// delta: 203776 of the 232448 bytes a block may take. bf16 q tiles are 64
// rows, f32 ones 32.
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
// Kernels 2 and 3 are deterministic too: dq rows belong to one block (its
// slices add in a fixed order), dK/dV rows to one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;  // warps of a block, in kernels 2, 3 and 4
constexpr int kThreads = 32 * kWarps;

// Tiles of kernels 3 and 4 (chip_smoke.py reads them from here): q rows of
// a q tile by input type, keys of a block by head width.
constexpr int kBrBf16 = 64;
constexpr int kBrF32 = 32;
constexpr int kNarrowD = 64;  // the widest head of the narrow tiles
constexpr int kBcNarrow = 128;  // keys of a block at D <= kNarrowD
constexpr int kBcWide = 64;  // keys of a block above

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Two adjacent values (columns c, c + 1 of a row) rounded to T and stored
// at p, which holds column c (shared or global memory).
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// mma fragments: bf16 operands as packed pairs; f32 operands as their TF32
// hi and lo parts (3xTF32). kK is the k of one mma; kNB the n8 tiles of one
// B load (an ldmatrix.x4 gives two bf16 tiles; f32 loads are scalar).
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
  static constexpr int kK = 16;
  static constexpr int kNB = 2;
};
template <>
struct Frag<float> {
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  static constexpr int kK = 8;
  static constexpr int kNB = 1;
};

// Tile shapes of one instantiation of kernels 3 and 4.
template <typename T, int D>
struct DkvCfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kBr = kBf16 ? kBrBf16 : kBrF32;  // q rows of a q tile
  static constexpr int kBc = D <= kNarrowD ? kBcNarrow : kBcWide;  // keys of a block
  // warps sharing a 16-key group: each owns kBr / kSplit queries of S^T and
  // D / kSplit columns of dK and dV
  static constexpr int kSplit = kWarps * 16 / kBc;
  static constexpr int kStages = !kBf16 && D == 256 ? 1 : 2;  // Q, dO tiles in flight
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));  // rows of K, V, Q, dO
  static constexpr int kLdP = kBr + 16 / static_cast<int>(sizeof(T));  // rows of P^T, dS^T
  static constexpr size_t kSmem =
      sizeof(T) * (2 * kBc * kLd + 2 * kStages * kBr * kLd + 2 * kBc * kLdP) +
      sizeof(float) * 2 * kStages * kBr;
};

// Tile shapes of one instantiation of kernel 2: kRowGroups 16-row query
// fragments x kSlices slices of each key tile, one warp each.
template <typename T, int D>
struct DqCfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kRowGroups = !kBf16 ? 2 : D == 256 ? 4 : 8;
  static constexpr int kSlices = kWarps / kRowGroups;
  static constexpr int kBr = 16 * kRowGroups;  // query rows of a block
  static constexpr int kBc = (kBf16 ? D == 256 : D >= 128) ? 32 : 64;  // keys of a tile
  static constexpr int kKs = kBc / kSlices;  // keys of a warp's slice
  // the warp's Q and dO A fragments stay in registers for the key loop
  static constexpr bool kQInRegs = kBf16 && D <= 64;
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));  // rows of Q, dO, K, V
  static constexpr size_t kSmem =
      sizeof(T) * (2 * kBr + 4 * kBc) * kLd + sizeof(float) * 2 * kBr;
};

__device__ __forceinline__ void mma(float (&c)[4], const Frag<bf16>::A& a,
                                    const Frag<bf16>::B& b) {
  mma_bf16(c, a.r, b.r[0], b.r[1]);
}
// An mma does not round its sum to nearest: with the running sum kept inside
// the mma, f32 dq drifted from the plain version's by 1e-5 of max|dq| at
// D = 256, as truncation toward zero of each step would. So the three
// products of one k8 step go into a zero accumulator and the running sum is
// kept by an f32 add, which rounds to nearest.
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
// (load_a_mk) or [k][m] (load_a_km); b[j] is the B fragment (kK x 8, k x n)
// of n 8j..8j+7, stored [n][k] (load_b_nk) or [k][n] (load_b_kn). The mma
// layouts: A (g, 2t..2t+1), (g+8, ..), (g, 2t+8..), (g+8, 2t+8..) and B (k
// 2t..2t+1, n g), (k 2t+8.., n g) for bf16; A (g, t), (g+8, t), (g, t+4),
// (g+8, t+4) and B (k t, n g), (k t+4, n g) for TF32.
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
__device__ __forceinline__ void load_b_nk(Frag<float>::B (&b)[1], const float* p, int ld,
                                          int lane) {
  const float* e = p + (lane >> 2) * ld + (lane & 3);
  split_tf32(e[0], b[0].hi[0], b[0].lo[0]);
  split_tf32(e[4], b[0].hi[1], b[0].lo[1]);
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

// ---- the one s, dp computation of kernels 2, 3 and 4 ----

// One d chunk of s or dp. bf16: m16n8k16, the running sum in the mma. f32:
// 3xTF32 m16n8k8 from zero, then an f32 add; the three products come in
// one order of the key and the query operand, whichever of them is A
// (KeyMajor: A holds keys, as kernels 3 and 4; else queries, as kernel 2).
template <bool KeyMajor>
__device__ __forceinline__ void mma_sd(float (&c)[4], const Frag<bf16>::A& a,
                                       const Frag<bf16>::B& b) {
  mma_bf16(c, a.r, b.r[0], b.r[1]);
}
template <bool KeyMajor>
__device__ __forceinline__ void mma_sd(float (&c)[4], const Frag<float>::A& a,
                                       const Frag<float>::B& b) {
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (KeyMajor) {  // key lo x query hi, then key hi x query lo
    mma_tf32(step, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(step, a.hi, b.lo[0], b.lo[1]);
  } else {
    mma_tf32(step, a.hi, b.lo[0], b.lo[1]);
    mma_tf32(step, a.lo, b.hi[0], b.hi[1]);
  }
  mma_tf32(step, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += step[e];
}

// s = A_s B_s and dp = A_dp B_dp over D, from zero, in d chunks of
// Frag<T>::kK in d order: 16 rows (A) x NTiles n8 tiles (B). load_a(kk,
// a_s, a_dp) gives the A fragments of d chunk kk; load_b(kk, n, b_s, b_dp)
// the B fragments of n8 tiles n .. n + kNB - 1 there.
template <typename T, bool KeyMajor, int NTiles, int D, int Unroll, typename LoadA,
          typename LoadB>
__device__ __forceinline__ void sdp_products(float (&s)[NTiles][4], float (&dp)[NTiles][4],
                                             const LoadA& load_a, const LoadB& load_b) {
  using FA = typename Frag<T>::A;
  using FB = typename Frag<T>::B;
  constexpr int KK = Frag<T>::kK;
  constexpr int NB = Frag<T>::kNB;
  constexpr int kUnroll = Unroll;
  static_assert(NTiles % NB == 0, "whole B loads");
#pragma unroll
  for (int n = 0; n < NTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  }
#pragma unroll(kUnroll)
  for (int kk = 0; kk < D; kk += KK) {
    FA as, ad;
    load_a(kk, as, ad);
#pragma unroll
    for (int n = 0; n < NTiles; n += NB) {
      FB bs[NB], bd[NB];
      load_b(kk, n, bs, bd);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mma_sd<KeyMajor>(s[n + j], as, bs[j]);
        mma_sd<KeyMajor>(dp[n + j], ad, bd[j]);
      }
    }
  }
}

// p = exp2(min(s, 80) - lse2), 0 for a masked (query, key) pair, and
// ds = p (dp - delta)
__device__ __forceinline__ void prob_ds(float s, float dp, float lse2, float delta, bool live,
                                        float& p, float& ds) {
  p = live ? exp2f(fminf(s, 80.f) - lse2) : 0.f;
  ds = p * (dp - delta);
}

// Stage `Rows` rows of width D (contiguous in global memory, from `src`)
// into `dst` with row stride `ld`; rows at or past `valid` are zero-filled.
template <typename T, int D, int Rows>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* __restrict__ src, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < Rows * kChunks; i += kThreads) {
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
                                                const float* __restrict__ delta, int valid) {
  static_assert(2 * Rows <= kThreads, "one row value a thread");
  const int i = threadIdx.x % Rows;
  const bool ok = i < valid;
  if (threadIdx.x < Rows) {
    cp_async4(s_lse + i, lse2 + (ok ? i : 0), ok);
  } else if (threadIdx.x < 2 * Rows) {
    cp_async4(s_delta + i, delta + (ok ? i : 0), ok);
  }
}

// ---- kernel 2 ----

// dq += ds K over a warp's KS keys (bf16). ds holds the C fragments of S
// (rows g, g + 8; keys 2t, 2t + 1 of each n8 tile), which rounded to bf16
// pairs are the A fragments of k-step js (keys 16 js ..); K's B fragments
// by ldmatrix.trans. Each 16-column pair of n8 tiles is summed over the KS
// keys from zero, then added into acc in f32.
template <int D, int KS>
__device__ __forceinline__ void dq_product(float (&acc)[D / 8][4], const float (&ds)[KS / 8][4],
                                           const bf16* tK, int ld, int lane) {
  uint32_t a[KS / 16][4];
#pragma unroll
  for (int js = 0; js < KS / 16; ++js) {
    a[js][0] = pack_bf16(ds[2 * js][0], ds[2 * js][1]);
    a[js][1] = pack_bf16(ds[2 * js][2], ds[2 * js][3]);
    a[js][2] = pack_bf16(ds[2 * js + 1][0], ds[2 * js + 1][1]);
    a[js][3] = pack_bf16(ds[2 * js + 1][2], ds[2 * js + 1][3]);
  }
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int js = 0; js < KS / 16; ++js) {
      Frag<bf16>::B b[2];
      load_b_kn(b, tK + 16 * js * ld + 16 * c, ld, lane);
      mma_bf16(part[0], a[js], b[0].r[0], b[0].r[1]);
      mma_bf16(part[1], a[js], b[1].r[0], b[1].r[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * c][e] += part[0][e];
      acc[2 * c + 1][e] += part[1][e];
    }
  }
}

// The same for f32, one k8 step a S tile nt: its TF32 A operand takes keys
// 2t, 2t + 1 as columns t, t + 4 (as kernel 1's f32 P V), so the B operand
// reads K rows 8 nt + 2t and + 1 at column 8 dn + g.
template <int D, int KS>
__device__ __forceinline__ void dq_product(float (&acc)[D / 8][4], const float (&ds)[KS / 8][4],
                                           const float* tK, int ld, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < KS / 8; ++nt) {
    Frag<float>::A a;
    split_tf32(ds[nt][0], a.hi[0], a.lo[0]);  // row g, key 2t
    split_tf32(ds[nt][2], a.hi[1], a.lo[1]);  // row g + 8, key 2t
    split_tf32(ds[nt][1], a.hi[2], a.lo[2]);  // row g, key 2t + 1
    split_tf32(ds[nt][3], a.hi[3], a.lo[3]);  // row g + 8, key 2t + 1
    const float* krow = tK + (8 * nt + 2 * t) * ld + g;
    // unrolled whole, so that acc stays in registers
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      Frag<float>::B b;
      split_tf32(krow[8 * dn], b.hi[0], b.lo[0]);
      split_tf32(krow[ld + 8 * dn], b.hi[1], b.lo[1]);
      mma(acc[dn], a, b);
    }
  }
}

// Kernel 2. Grid: one block per (bh, kBr query rows), flattened into blockIdx.x.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse2,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    int num_qb, int causal) {
  using C = DqCfg<T, D>;
  using FA = typename Frag<T>::A;
  constexpr int BR = C::kBr;
  constexpr int BC = C::kBc;
  constexpr int KS = C::kKs;
  constexpr int LD = C::kLd;
  constexpr int KK = Frag<T>::kK;
  constexpr int kSTiles = KS / 8;  // n8 tiles of a warp's S and dP
  constexpr int kDTiles = D / 8;  // n8 tiles of its dq
  // d chunks unrolled whole where the Q, dO fragments are indexed by them
  constexpr int kUnroll = C::kQInRegs ? D / KK : C::kBf16 ? 4 : 1;
  constexpr int kPart = 32 * 4 * kDTiles;  // floats of a warp's partial dq
  static_assert(KS % 16 == 0 || !C::kBf16, "bf16 slices are whole k16 steps");
  static_assert((C::kSlices - 1) * C::kRowGroups * kPart * sizeof(float) <=
                    4 * BC * LD * sizeof(T),
                "the slices' partial sums fit where the K and V tiles were");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // BR x LD
  T* sO = sQ + BR * LD;  // dO, BR x LD
  T* sK = sO + BR * LD;  // 2 stages x BC x LD
  T* sV = sK + 2 * BC * LD;  // 2 stages x BC x LD
  float* sLse = reinterpret_cast<float*>(sV + 2 * BC * LD);  // BR
  float* sDelta = sLse + BR;  // BR

  const int bh = blockIdx.x / num_qb;
  const int q0 = (blockIdx.x % num_qb) * BR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = warp / C::kSlices;  // row group
  const int sl = warp % C::kSlices;  // key slice
  const int wr = rg * 16;  // first row of the warp's fragment, in the block
  const int ws = sl * KS;  // first key of its slice, in a key tile
  const size_t row0 = static_cast<size_t>(bh) * sq + q0;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;

  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, q0 + BR) : sk;
  const int num_k = (kv_end + BC - 1) / BC;
  const int qvalid = min(BR, sq - q0);
  stage_rows<T, D, BR>(sQ, LD, q + row0 * D, qvalid);
  stage_rows<T, D, BR>(sO, LD, dout + row0 * D, qvalid);
  stage_row_stats<BR>(sLse, sDelta, lse2 + row0, delta + row0, qvalid);
  if (num_k > 0) {
    stage_rows<T, D, BC>(sK, LD, kb, min(BC, sk));
    stage_rows<T, D, BC>(sV, LD, vb, min(BC, sk));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the lse2 and delta of the thread's rows g, g + 8
  const float r_lse[2] = {sLse[wr + g], sLse[wr + g + 8]};
  const float r_delta[2] = {sDelta[wr + g], sDelta[wr + g + 8]};
  FA qf[C::kQInRegs ? D / KK : 1], of[C::kQInRegs ? D / KK : 1];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int i = 0; i < D / KK; ++i) {
      load_a_mk(qf[i], sQ + wr * LD + i * KK, LD, lane);
      load_a_mk(of[i], sO + wr * LD + i * KK, LD, lane);
    }
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int j = 0; j < num_k; ++j) {
    const int st = j & 1;
    const int k0 = j * BC;
    if (j + 1 < num_k) {  // the next tile's copy runs under this tile's products
      const int k1 = k0 + BC;
      stage_rows<T, D, BC>(sK + (st ^ 1) * BC * LD, LD, kb + static_cast<size_t>(k1) * D,
                           min(BC, sk - k1));
      stage_rows<T, D, BC>(sV + (st ^ 1) * BC * LD, LD, vb + static_cast<size_t>(k1) * D,
                           min(BC, sk - k1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const T* tK = sK + (st * BC + ws) * LD;  // the warp's slice of the tile
    const T* tV = sV + (st * BC + ws) * LD;
    const int key0 = k0 + ws;
    // a slice past sk, or under the causal mask past the fragment's last
    // row, has p == 0 for all its rows
    if (!(key0 >= sk || (causal && key0 > q0 + wr + 15))) {
      // S = Q K^T and dP = dO V^T: the warp's 16 rows x KS keys
      float s[kSTiles][4], dp[kSTiles][4];
      sdp_products<T, false, kSTiles, D, kUnroll>(
          s, dp,
          [&](int kk, FA& as, FA& ad) {
            if constexpr (C::kQInRegs) {
              as = qf[kk / KK];
              ad = of[kk / KK];
            } else {
              load_a_mk(as, sQ + wr * LD + kk, LD, lane);
              load_a_mk(ad, sO + wr * LD + kk, LD, lane);
            }
          },
          [&](int kk, int n, auto& bs, auto& bd) {
            load_b_nk(bs, tK + 8 * n * LD + kk, LD, lane);
            load_b_nk(bd, tV + 8 * n * LD + kk, LD, lane);
          });
      // ds: the C fragments hold rows g, g + 8 and keys 2t, 2t + 1 of each n8 tile
      float ds[kSTiles][4];
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + wr + g + 8 * h;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + 8 * n + 2 * t + e;
            const bool live = row < sq && key < sk && (!causal || key <= row);
            float p;
            prob_ds(s[n][2 * h + e], dp[n][2 * h + e], r_lse[h], r_delta[h], live, p,
                    ds[n][2 * h + e]);
          }
        }
      }
      dq_product<D, KS>(acc, ds, tK, LD, lane);
    }
    __syncthreads();  // stage st is refilled by the copy issued at step j + 1
  }

  if constexpr (C::kSlices > 1) {
    // the slices' partial dq, in slice order, into slice 0's registers; the
    // K and V stages are free (the loop ended on a barrier, or never ran)
    float* parts = reinterpret_cast<float*>(sK);
    if (sl > 0) {
      float* part = parts + ((sl - 1) * C::kRowGroups + rg) * kPart + lane;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(4 * n + e) * 32] = acc[n][e];
      }
    }
    __syncthreads();
    if (sl > 0) return;
#pragma unroll 1
    for (int other = 1; other < C::kSlices; ++other) {
      const float* src = parts + ((other - 1) * C::kRowGroups + rg) * kPart + lane;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += src[(4 * n + e) * 32];
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= sq) continue;
    T* out = dq + (static_cast<size_t>(bh) * sq + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) store2(out + 8 * n, acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// ---- kernels 3 and 4 ----

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
    int sq, int sk, int num_kb, int causal) {
  using C = DkvCfg<T, D>;
  using FA = typename Frag<T>::A;
  using FB = typename Frag<T>::B;
  constexpr int BR = C::kBr;
  constexpr int BC = C::kBc;
  constexpr int LD = C::kLd;
  constexpr int LDP = C::kLdP;
  constexpr int KK = Frag<T>::kK;
  constexpr int kNq = BR / C::kSplit;  // queries of a warp's S^T slab
  constexpr int kSTiles = kNq / 8;  // its n8 tiles
  constexpr int kDw = D / C::kSplit;  // dK, dV columns of a warp
  constexpr int kDTiles = kDw / 8;
  static_assert(kSTiles % 2 == 0 && kDTiles % 2 == 0, "B fragments come two n8 tiles at a time");
  static_assert(BC % BR == 0, "a causal q loop starts on a q tile");
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
    stage_row_stats<BR>(sLse + st * BR, sDelta + st * BR, lb + q0, db + q0, valid);
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
    // a key group past sk, or under the causal mask past the tile's last
    // row, has p == 0 for the whole tile
    const bool dead = k0 + wk >= sk || (causal && k0 + wk > q0 + BR - 1);

    // S^T = K Q^T and dP^T = V dO^T: the group's 16 keys x kNq queries
    float s[kSTiles][4], dp[kSTiles][4];
    if (dead) {
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
    } else {
      sdp_products<T, true, kSTiles, D, kUnroll>(
          s, dp,
          [&](int kk, FA& ak, FA& av) {
            load_a_mk(ak, sK + wk * LD + kk, LD, lane);
            load_a_mk(av, sV + wk * LD + kk, LD, lane);
          },
          [&](int kk, int n, auto& bq, auto& bo) {
            load_b_nk(bq, tQ + (wq + 8 * n) * LD + kk, LD, lane);
            load_b_nk(bo, tO + (wq + 8 * n) * LD + kk, LD, lane);
          });
    }
    // P^T and dS^T, rounded to T, into shared memory: the C fragment holds
    // keys g, g + 8 and queries 2t, 2t + 1 of each n8 tile
    uint32_t pa[kRegA ? kSTiles : 1][2], sa[kRegA ? kSTiles : 1][2];  // kRegA: (n, h) bf16 pairs
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
          prob_ds(s[n][2 * h + e], dp[n][2 * h + e], tLse[ql + e], tDelta[ql + e], live, p[e],
                  ds[e]);
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
      }
    }

    if constexpr (Fused && kRegA) __syncthreads();  // dS^T is whole for the dq part

    if constexpr (Fused) {
      // the tile's dq part dS K (BR x D): warp w takes rows 16 (w % kRowGroups)
      // and kDqCols columns from kDqCols (w / kRowGroups), in passes of
      // kPassCols (32 f32 registers a thread beside the dK, dV accumulators,
      // 16 for f32, whose fragments take twice the registers); at f32 D = 32
      // only the first kRowGroups * kColGroups warps
      constexpr int kRowGroups = BR / 16;
      constexpr int kColGroups =
          kWarps / kRowGroups < D / 16 ? kWarps / kRowGroups : D / 16;
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
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    int sq, int sk, int num_kb, int causal) {
  dkv_block<T, D, false>(q, k, v, dout, lse2, delta, dk, dv, dq_acc, dq_lock, sq, sk, num_kb,
                         causal);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    int sq, int sk, int num_kb, int causal) {
  dkv_block<T, D, true>(q, k, v, dout, lse2, delta, dk, dv, dq_acc, dq_lock, sq, sk, num_kb,
                        causal);
}

// ---- the test entry of the one s, dp computation ----

// Block i takes tile i: 16 queries (q, dout, lse2, delta) and 16 keys (k,
// v). Warp 0 computes s, dp and ds query-major, as kernel 2 does (A = Q,
// dO), warp 1 key-major, as kernels 3 and 4 do (A = K, V); both through
// sdp_products and prob_ds, every pair live. out (2 roles, 3 quantities s,
// dp, ds, tiles, 16 queries, 16 keys), f32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_roles_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse2, const float* __restrict__ delta,
                       float* __restrict__ out, int tiles) {
  using FA = typename Frag<T>::A;
  constexpr int LD = D + 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // 16 x LD each
  T* sO = sQ + 16 * LD;
  T* sK = sO + 16 * LD;
  T* sV = sK + 16 * LD;
  float* sLse = reinterpret_cast<float*>(sV + 16 * LD);  // 16
  float* sDelta = sLse + 16;  // 16
  const size_t row0 = static_cast<size_t>(blockIdx.x) * 16;
  stage_rows<T, D, 16>(sQ, LD, q + row0 * D, 16);
  stage_rows<T, D, 16>(sO, LD, dout + row0 * D, 16);
  stage_rows<T, D, 16>(sK, LD, k + row0 * D, 16);
  stage_rows<T, D, 16>(sV, LD, v + row0 * D, 16);
  stage_row_stats<16>(sLse, sDelta, lse2 + row0, delta + row0, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  if (warp > 1) return;
  const bool key_major = warp == 1;
  float s[2][4], dp[2][4];
  if (key_major) {
    sdp_products<T, true, 2, D, 1>(
        s, dp,
        [&](int kk, FA& ak, FA& av) {
          load_a_mk(ak, sK + kk, LD, lane);
          load_a_mk(av, sV + kk, LD, lane);
        },
        [&](int kk, int n, auto& bq, auto& bo) {
          load_b_nk(bq, sQ + 8 * n * LD + kk, LD, lane);
          load_b_nk(bo, sO + 8 * n * LD + kk, LD, lane);
        });
  } else {
    sdp_products<T, false, 2, D, 1>(
        s, dp,
        [&](int kk, FA& aq, FA& ao) {
          load_a_mk(aq, sQ + kk, LD, lane);
          load_a_mk(ao, sO + kk, LD, lane);
        },
        [&](int kk, int n, auto& bk, auto& bv) {
          load_b_nk(bk, sK + 8 * n * LD + kk, LD, lane);
          load_b_nk(bv, sV + 8 * n * LD + kk, LD, lane);
        });
  }
  // C fragment element (n, 2h + e): A row g + 8h, B column 8n + 2t + e
  const size_t plane = static_cast<size_t>(tiles) * 256;
  float* o = out + warp * 3 * plane + blockIdx.x * 256;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int a_row = g + 8 * h;
        const int b_col = 8 * n + 2 * t + e;
        const int qi = key_major ? b_col : a_row;
        const int ki = key_major ? a_row : b_col;
        float p, ds;
        prob_ds(s[n][2 * h + e], dp[n][2 * h + e], sLse[qi], sDelta[qi], true, p, ds);
        o[qi * 16 + ki] = s[n][2 * h + e];
        o[plane + qi * 16 + ki] = dp[n][2 * h + e];
        o[2 * plane + qi * 16 + ki] = ds;
      }
    }
  }
}

enum class Entry { kDq, kDkv, kFused, kRoles };

struct Args {
  const void *q, *k, *v, *dout, *lse2, *delta;
  void *out0, *out1, *out2;  // dq; or dk and dv; or the f32 dq buffer, dk and dv
  void* dq_lock;  // kernel 4's dq counters, else nullptr
  int bh, sq, sk, causal;  // the roles entry: bh = tiles
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  using C = DqCfg<T, D>;
  static_assert(C::kSmem <= 232448, "shared memory of one block");
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_qb = (a.sq + C::kBr - 1) / C::kBr;
  kernel<<<num_qb * a.bh, kThreads, C::kSmem, a.stream>>>(
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
  kernel<<<num_kb * a.bh, kThreads, C::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<T*>(dk), static_cast<T*>(dv),
      Fused ? static_cast<float*>(a.out0) : nullptr,
      Fused ? static_cast<int*>(a.dq_lock) : nullptr, a.sq, a.sk, num_kb, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_roles(const Args& a) {
  constexpr size_t smem = (sizeof(T) * 4 * 16 * (D + 16 / sizeof(T))) + sizeof(float) * 32;
  auto kernel = flash_bwd_roles_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.bh, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<float*>(a.out0), a.bh);
  return static_cast<int>(cudaGetLastError());
}

template <Entry E, typename T, int D>
int launch_entry(const Args& a) {
  if constexpr (E == Entry::kDq) {
    return launch_dq<T, D>(a);
  } else if constexpr (E == Entry::kRoles) {
    return launch_roles<T, D>(a);
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
  const Args a{q,  k,  v,  dout,   lse2, delta, dq, nullptr, nullptr, nullptr,
               bh, sq, sk, causal, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kDq>(a, d, dtype, device);
}

// The same inputs; dk and dv (bh, sk, d) in the input type.
extern "C" int gm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse2, const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int d, int dtype, int causal, int device,
                                void* stream) {
  const Args a{q,  k,  v,  dout,   lse2, delta, dk, dv, nullptr, nullptr,
               bh, sq, sk, causal, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kDkv>(a, d, dtype, device);
}

// The same inputs; one launch adds dq into `dq_acc`, f32 (bh, sq, d) and
// zeroed by the caller, in the order kept by `dq_lock`, int32, at least
// bh * ceil(sq / Br) of them (Br = kBrBf16 or kBrF32 by input type) and
// zeroed by the caller, and writes dk and dv (bh, sk, d) in the input type.
extern "C" int gm_flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse2, const void* delta, void* dq_acc,
                                  void* dq_lock, void* dk, void* dv, int bh, int sq, int sk, int d,
                                  int dtype, int causal, int device, void* stream) {
  const Args a{q,  k,  v,  dout,   lse2, delta, dq_acc, dk, dv, dq_lock,
               bh, sq, sk, causal, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kFused>(a, d, dtype, device);
}

// Test entry of the s, dp computation that kernels 2-4 share: q, k, v and
// dout (tiles, 16, d) in one type, lse2 and delta (tiles, 16) f32; writes
// out, f32 (2, 3, tiles, 16, 16): s, dp and ds of each tile's (query, key)
// pairs computed query-major (out[0]) and key-major (out[1]).
extern "C" int gm_flash_bwd_roles(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse2, const void* delta, void* out, int tiles,
                                  int d, int dtype, int device, void* stream) {
  const Args a{q,     k, v, dout, lse2, delta, out, nullptr, nullptr, nullptr,
               tiles, 16, 16, 0, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kRoles>(a, d, dtype, device);
}
