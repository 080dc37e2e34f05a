// The two attention-forward probe kernels for Hopper (sm_90a), plain C
// interface for ctypes. Both run their two products as warpgroup products
// (wgmma.mma_async, bf16 operands, f32 accumulation), as the TPU kernels'
// dot_general(..., preferred_element_type=f32) run theirs on the MXU, fed
// by TMA from a producer warpgroup.
//
// flash_probe_overlap_kernel replaces the Pallas TPU kernel
// benchmarks/probe_overlap.py::_kernel (and _kernel_q2, _score_probs, called
// from flash_var). q arrives prescaled by bf16(scale * log2(e)) (the
// launcher does it, as the JAX wrapper does outside its kernel); there is no
// running max, so the result does not depend on the tiling beyond f32
// summation order:
//   s = q k^T (f32);
//   full, ilv2, ilv4, q2:   p = bf16(exp2(min(s, 80)));
//   bf16dom, ilv2_bf16:     p = exp2(min(bf16(s), 80)) in packed bf16, as
//                           jnp.exp2 computes it on bf16: exp(bf16(x *
//                           bf16(ln 2))) (min.bf16x2, mul.rn.bf16x2, then
//                           the packed exp below);
//   mxu_only:               p = bf16(s), no clamp and no exp2;
//   l = f32 sum of the bf16 p, o = bf16(acc / max(l, 1e-30)).
// The TPU variants are program orders for Mosaic's scheduler; here each asks
// the same question of wgmma, per 128-key tile of a consumer warpgroup:
//   full (and bf16dom, mxu_only): the serial chain QK, wait, clamp + exp2,
//     PV, wait; only the loads (TMA, four tiles ahead) overlap the chain
//     within a warpgroup. mxu_only drops the clamp and exp2: the floor of
//     this design's products;
//   ilv2, ilv4 (and ilv2_bf16): the tile in 2 or 4 key sub-tiles; every QK
//     product of the tile is issued first, then sub-tile by sub-tile: wait,
//     exp2, and its PV products issued without waiting (the TPU probe's s1,
//     s2, p1, pv1, p2, pv2), so one sub-tile's exp2 runs while the previous
//     sub-tile's products are in the tensor cores;
//   q2: the block's two consumer warpgroups (which share every K/V stage in
//     all variants) take turns at the tensor cores, ordered by two named
//     barriers: each issues its QK (then its PV) only after the other has
//     issued its own, so one's exp2 runs under the other's products.
//
// flash_probe_vpu_kernel replaces benchmarks/probe_attn_vpu.py
// ::_fwd_kernel_var: the online-max natural-exp forward, per 128-key tile
//   s = q k^T (f32), times scale unless q was prescaled outside;
//   m_new = max(m, rowmax(s)) (m starts at -1e30), alpha = exp(m - m_new);
//   bf16_p:  p = exp(bf16(s - m_new)) in packed bf16, l = l alpha + f32
//            sum(p);
//   else:    p = exp(s - m_new) in f32, l = l alpha + sum(p) (unrounded);
//   acc = acc alpha + bf16(p) V;  o = bf16(acc / max(l, 1e-30)).
// Because p is rounded against the running max, the result depends on the
// key step (128, kBlockK); the plain version takes it as block_k. Its
// pipeline overlaps within a warpgroup, in FlashAttention-3's order: the QK
// product of tile j and the PV product of tile j - 1 are issued together, and
// the softmax of tile j runs while that PV product is in the tensor cores; O
// is rescaled once it is done. ptxas keeps the products asynchronous only if
// the loop body has no branch, the softmax writes no accumulator register
// and no register a product in flight reads: the two sets of PV A fragments
// keep fixed roles over a loop step of two tiles, as a copy between them
// would write the in-flight product's input. Else it serializes every
// product of the kernel (its C7513 and C7514 notes, which chip_smoke.py's
// phase 1 prints and fails on).
// The packed exp of a bf16 pair x is ex2.approx.ftz.bf16x2(bf16(x log2(e))),
// with log2(e) split into two bf16 constants so that the product is rounded
// once: it departs from the plain version's bf16(exp(x)) by the rounding of
// that argument to bf16 (2**-9 of it), about one bf16 ulp of p where |x| <= 1.
//
// What bounds them on this card: at the probe shape (BH=2, S=32768, D=64)
// the two products are 4 * BH * S^2 * D = 5.5e11 operations on 16 MB of
// operands, 0.556 ms at the bf16 tensor-core rate (989 TFLOP/s) against
// 0.005 ms for the bytes: bound by operations. At D = 64 each score costs
// 256 tensor-core operations, so the card finishes ~3.9e12 scores a second,
// about what the SFU issues exp2 at (16 a clock per SM): the softmax is not
// free beside the products unless it overlaps them or runs packed, which is
// what the variants measure.
// What the design does about it: a block is two consumer warpgroups of 64
// query rows each and a producer warpgroup, one thread of which issues every
// load (warp specialisation; the producer lowers its register limit to 24 and
// the consumers raise theirs to 240, which the 384 threads' 168 at launch
// leave room for).
// The producer loads each warpgroup's Q tile once and keeps K and V tiles of
// 128 keys x 64 (16 KB each, one 128-byte swizzled row a key) in flight by
// TMA into a ring of four stages, each with a full mbarrier for K, one for V
// and an empty one that the eight consumer warps release (144 KB of dynamic
// shared memory: one block an SM, which the raised register limit needs).
// s = q k^T is wgmma m64n128k16 (m64n64 / m64n32 for the sub-tiles of
// ilv2 / ilv4) with Q and K from shared memory by descriptor, K-major; o +=
// p v is wgmma m64n64k16 with p from registers (the S accumulator of two n8
// blocks, rounded to bf16 pairs, is the A fragment) and V from shared memory,
// MN-major through the descriptor's transpose bit. Kernel 6 takes the row
// sum l of its bf16 p by one more product a PV k-step, m64n8k16 of the same A
// fragment against a 256-byte block of ones in shared memory: the TPU's ones
// column, 1/8 more PV work on the tensor cores in place of four CUDA-core
// instructions a pair of p (unpack and add) beside the SFU. Kernel 7 sums in
// registers, a quad shuffle at the end (its f32 p is unrounded; for its bf16
// p the extra products cost more than the adds: each way was timed on the
// H100, and each kernel keeps the faster), and its exponent is one FFMA,
// s log2(e) - m log2(e), before the ex2.
// The tiles of a row of blocks are the same across the card, so the K and V
// tiles come from L2 after their first read.
// Sk: kernel 6 takes multiples of 64: a last half tile is zero-filled by TMA
// and its keys get p = 0; kernel 7 takes multiples of kBlockK (its key step).
// Sq: multiples of 64; a block past Sq computes on its last rows again and
// stores nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_sm90.cuh"

namespace {

constexpr int kD = 64;                                 // head width
constexpr int kRowsWg = 64;                            // query rows a consumer warpgroup
constexpr int kConsumers = 2;                          // consumer warpgroups a block
constexpr int kBlockQ = kConsumers * kRowsWg;          // query rows a block
constexpr int kBlockK = 128;                           // keys a tile (a ring stage)
constexpr int kStages = 4;                             // the K/V ring
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 128;       // + the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;  // arrivals that empty a stage
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kQBytes = kRowsWg * kD * 2;     // 8 KB
constexpr int kTileBytes = kBlockK * kD * 2;  // 16 KB
constexpr int kDSteps = kD / 16;              // k-steps of the QK product
constexpr int kPvSteps = kBlockK / 16;        // k-steps of the PV product in a tile
constexpr int kORegs = kD / 2;                // accumulator registers of O (m64n64)
constexpr int kSRegs = kBlockK / 2;           // accumulator registers of S (m64n128)
constexpr uint32_t kOnes = 0x3F803F80u;       // bf16x2 (1, 1)
constexpr uint32_t kClamp = 0x42A042A0u;      // bf16x2 (80, 80)
constexpr uint32_t kLn2 = 0x3F313F31u;  // bf16x2 (ln 2) = 0.69140625, jnp.exp2's constant
constexpr uint32_t kLog2eHi = 0x3FB83FB8u;  // bf16x2 1.4375
constexpr uint32_t kLog2eLo = 0x3BAA3BAAu;  // bf16x2 0.00518798828125: hi + lo = log2(e) - 7e-6
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels

// dynamic shared memory, from a 1024-byte-aligned base: the Q tiles, the K
// and V stages, the mbarriers (q_full[kConsumers], k_full[kStages],
// v_full[kStages], empty[kStages]), then the ones of kernel 6's row-sum
// product
constexpr int kSmemQ = 0;
constexpr int kSmemK = kSmemQ + kConsumers * kQBytes;
constexpr int kSmemV = kSmemK + kStages * kTileBytes;
constexpr int kSmemBars = kSmemV + kStages * kTileBytes;
constexpr int kSmemOnes = kSmemBars + 128;
constexpr int kOnesBytes = 256;  // two 8 x 16-byte core matrices: a k16 x n8 B operand
static_assert(8 * (kConsumers + 3 * kStages) <= kSmemOnes - kSmemBars, "barriers overlap");
constexpr int kSmemBytes = kSmemOnes + kOnesBytes + 1024;  // + alignment

// the variants of the overlap probe, in the order of OVERLAP_VARIANTS in
// ops/flash_probes.py
enum Variant { kFull = 0, kMxuOnly, kIlv2, kIlv4, kQ2, kBf16Dom, kIlv2Bf16 };

struct Ring {
  unsigned char* base;  // 1024-byte aligned
  uint64_t* bars;

  __device__ unsigned char* q(int w) const { return base + kSmemQ + w * kQBytes; }
  __device__ unsigned char* k(int st) const { return base + kSmemK + st * kTileBytes; }
  __device__ unsigned char* v(int st) const { return base + kSmemV + st * kTileBytes; }
  __device__ uint64_t* q_full(int w) const { return bars + w; }
  __device__ uint64_t* k_full(int st) const { return bars + kConsumers + st; }
  __device__ uint64_t* v_full(int st) const { return bars + kConsumers + kStages + st; }
  __device__ uint64_t* empty(int st) const { return bars + kConsumers + 2 * kStages + st; }
  // B of the row-sum product: all ones, so its layout is moot
  __device__ uint64_t ones_desc() const {
    return wgmma_desc_plain(smem_addr(base + kSmemOnes), 128, 128);
  }
};

// The ring in this block's dynamic shared memory, its barriers initialised
// and its ones written (the one __syncthreads of the kernel: the roles split
// after it)
__device__ __forceinline__ Ring make_ring(unsigned char* raw) {
  Ring r;
  r.base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  r.bars = reinterpret_cast<uint64_t*>(r.base + kSmemBars);
  if (threadIdx.x < kOnesBytes / 4) {
    reinterpret_cast<uint32_t*>(r.base + kSmemOnes)[threadIdx.x] = kOnes;
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w) mbar_init(r.q_full(w));
    for (int st = 0; st < kStages; ++st) {
      mbar_init(r.k_full(st));
      mbar_init(r.v_full(st));
      mbar_init(r.empty(st), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// The producer warpgroup: its first thread loads each consumer warpgroup's Q
// tile once, then the K and V tiles into the ring, a stage as soon as the
// consumers have emptied it.
// A Q tile past Sq loads the last 64 rows again (its warpgroup stores nothing).
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* q_map,
                                        const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        int bh, int row0, int sq, int tiles) {
  if (threadIdx.x != kConsumerThreads) return;
  for (int w = 0; w < kConsumers; ++w) {
    mbar_expect(r.q_full(w), kQBytes);
    tma_load_3d(r.q(w), q_map, r.q_full(w), 0, min(row0 + w * kRowsWg, sq - kRowsWg), bh);
  }
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    if (j >= kStages) mbar_wait(r.empty(st), (j / kStages - 1) & 1);
    mbar_expect(r.k_full(st), kTileBytes);
    tma_load_3d(r.k(st), k_map, r.k_full(st), 0, j * kBlockK, bh);
    mbar_expect(r.v_full(st), kTileBytes);
    tma_load_3d(r.v(st), v_map, r.v_full(st), 0, j * kBlockK, bh);
  }
}

// a consumer warp's release of stage st (its wgmmas on the stage are done)
__device__ __forceinline__ void release(const Ring& r, int st) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(r.empty(st));
}

__device__ __forceinline__ float ex2_f32(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t min_bf16x2(uint32_t a, uint32_t b) {
  uint32_t y;
  asm("min.bf16x2 %0, %1, %2;\n" : "=r"(y) : "r"(a), "r"(b));
  return y;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t y;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(y) : "r"(a), "r"(b));
  return y;
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(y) : "r"(a), "r"(b), "r"(c));
  return y;
}

// exp of a bf16 pair, in bf16: ex2 of x log2(e), the product rounded once
__device__ __forceinline__ uint32_t exp_bf16x2(uint32_t x) {
  return ex2_bf16x2(fma_bf16x2(x, kLog2eHi, mul_bf16x2(x, kLog2eLo)));
}

// the f32 sum of the two halves of a bf16 pair
__device__ __forceinline__ float pair_sum(uint32_t x) {
  return __uint_as_float(x << 16) + __uint_as_float(x & 0xFFFF0000u);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// exp(x) in f32 on the SFU
__device__ __forceinline__ float exp_f32(float x) { return ex2_f32(x * kLog2e); }

// p of two neighbouring scores as a bf16 pair, by the overlap variant's rule
template <int V>
__device__ __forceinline__ uint32_t probs(float lo, float hi) {
  if (V == kMxuOnly) return pack_bf16(lo, hi);
  if (V == kBf16Dom || V == kIlv2Bf16) {
    return exp_bf16x2(mul_bf16x2(min_bf16x2(pack_bf16(lo, hi), kClamp), kLn2));
  }
  return pack_bf16(ex2_f32(fminf(lo, 80.f)), ex2_f32(fminf(hi, 80.f)));
}

// s = q k^T for the Keys keys of a K tile at k_desc: kDSteps wgmmas
// m64n<Keys>k16 (s overwritten)
template <int Keys>
__device__ __forceinline__ void qk_products(float (&s)[Keys / 2], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    wgmma_ss<Keys>(s, wgmma_desc_add(q_desc, 32 * kk), wgmma_desc_add(k_desc, 32 * kk), kk > 0);
  }
}

// acc += p V for PV k-steps first .. first + N - 1 of a V stage
template <int N>
__device__ __forceinline__ void pv_products(float (&acc)[kORegs],
                                            const uint32_t (&p)[kPvSteps][4], int first,
                                            uint64_t v_desc) {
#pragma unroll
  for (int js = 0; js < N; ++js) {
    wgmma_rs_n64<true>(acc, p[first + js], wgmma_desc_add(v_desc, 2048 * (first + js)), 1);
  }
}

// pv_products, each k-step followed by l += p 1 against the ones (every
// column of l holds the row sum: l[0] of row g, l[2] of row g + 8)
template <int N>
__device__ __forceinline__ void pv_products_rowsum(float (&acc)[kORegs], float (&l)[4],
                                                   const uint32_t (&p)[kPvSteps][4], int first,
                                                   uint64_t v_desc, uint64_t ones_desc) {
#pragma unroll
  for (int js = 0; js < N; ++js) {
    wgmma_rs_n64<true>(acc, p[first + js], wgmma_desc_add(v_desc, 2048 * (first + js)), 1);
    wgmma_rs<8>(l, p[first + js], ones_desc);
  }
}

// o = bf16(acc / max(l, 1e-30)) for this thread's rows of a warpgroup tile
// starting at row `row` (rows g and g + 8 of the warp's 16); l0, l1 their
// row sums; rows past Sq are not stored
__device__ __forceinline__ void store_out(bf16* __restrict__ o, const float (&acc)[kORegs],
                                          float l0, float l1, int row, int sq) {
  const int lane = threadIdx.x % 32;
  const int r0 = row + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const float d[2] = {fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= sq) continue;
    bf16* out = o + static_cast<size_t>(r0 + 8 * h) * kD + 2 * (lane % 4);
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(out + 8 * nb) =
          pack_bf16(acc[4 * nb + 2 * h] / d[h], acc[4 * nb + 2 * h + 1] / d[h]);
    }
  }
}

template <int V>
struct OverlapCfg {
  static constexpr int kSub = V == kIlv4 ? 4 : (V == kIlv2 || V == kIlv2Bf16) ? 2 : 1;
  static constexpr int kSubKeys = kBlockK / kSub;
  static constexpr int kStepsPerSub = kPvSteps / kSub;  // PV k-steps a sub-tile
  static constexpr bool kPingPong = V == kQ2;
};

// A consumer warpgroup of the overlap kernel: its 64 rows over every tile.
// The named barriers of q2: 1 + w lets warpgroup w issue its products.
template <int V>
__device__ __forceinline__ void overlap_consume(const Ring& r, bf16* __restrict__ o, int row,
                                                int sq, int sk, int tiles) {
  using Cfg = OverlapCfg<V>;
  constexpr int kSub = Cfg::kSub;
  constexpr int kSteps = Cfg::kStepsPerSub;
  const int wg = threadIdx.x / 128;
  const int other = 1 + (wg ^ 1);
  const uint64_t q_desc = wgmma_desc_sw128(smem_addr(r.q(wg)));
  const bool half = sk % kBlockK != 0;  // the last tile holds 64 keys
  const uint64_t ones_desc = r.ones_desc();
  float acc[kORegs];
  float l[4];  // the row sums, from the ones product
#pragma unroll
  for (int i = 0; i < kORegs; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = 0.f;

  mbar_wait(r.q_full(wg), 0);
  if (Cfg::kPingPong && wg == 1) named_arrive(other, kConsumerThreads);  // warpgroup 0 first
#pragma unroll 1
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    const int ph = (j / kStages) & 1;
    const bool masked = half && j == tiles - 1;
    const uint64_t k_desc = wgmma_desc_sw128(smem_addr(r.k(st)));
    const uint64_t v_desc = wgmma_desc_sw128(smem_addr(r.v(st)));
    float s[kSub][Cfg::kSubKeys / 2];
    uint32_t p[kPvSteps][4];

    mbar_wait(r.k_full(st), ph);
    if (Cfg::kPingPong) named_sync(1 + wg, kConsumerThreads);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kSub; ++h) {
      qk_products<Cfg::kSubKeys>(s[h], q_desc, wgmma_desc_add(k_desc, h * Cfg::kSubKeys * 128));
      wgmma_commit();
    }
    if (Cfg::kPingPong) named_arrive(other, kConsumerThreads);
    mbar_wait(r.v_full(st), ph);
#pragma unroll
    for (int h = 0; h < kSub; ++h) {
      // pending: QK of sub-tiles h .. kSub - 1 and PV of 0 .. h - 1, in that
      // order of issue, so at most kSub - 1 groups still running means QK h is done
      wgmma_wait<kSub - 1>();
      reg_fence(s[h]);
#pragma unroll
      for (int js = 0; js < kSteps; ++js) {
        const int step = h * kSteps + js;
        const float* x = &s[h][8 * js];
        p[step][0] = probs<V>(x[0], x[1]);  // row g, keys 16 step + 2t, + 1
        p[step][1] = probs<V>(x[2], x[3]);  // row g + 8
        p[step][2] = probs<V>(x[4], x[5]);  // row g, keys + 8
        p[step][3] = probs<V>(x[6], x[7]);  // row g + 8, keys + 8
        if (masked && step >= kPvSteps / 2) {  // keys past Sk
#pragma unroll
          for (int e = 0; e < 4; ++e) p[step][e] = 0u;
        }
      }
      if (Cfg::kPingPong) named_sync(1 + wg, kConsumerThreads);
      wgmma_fence();
      pv_products_rowsum<kSteps>(acc, l, p, h * kSteps, v_desc, ones_desc);
      wgmma_commit();
      if (Cfg::kPingPong && !(wg == 1 && j == tiles - 1)) named_arrive(other, kConsumerThreads);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(l);
    reg_fence(p);
    release(r, st);
  }
  store_out(o, acc, l[0], l[2], row, sq);
}

// The online softmax of one tile's raw scores s (this thread's 64: rows g
// and g + 8 of its warp, 32 keys each; kScaleIn: s times scale). The
// running max m0, m1 moves on, alpha0, alpha1 are the tile's rescale
// factors, p the PV A fragments (bf16 pairs); l0 and l1 (this thread's part
// of the two rows' sums) move on too. The max of the scaled scores is the
// scaled max (scale > 0); each s - m is one FFMA.
template <bool kScaleIn, bool kBf16P>
__device__ __forceinline__ void online_softmax(const float (&s)[kSRegs], float scale, float& m0,
                                               float& m1, float& l0, float& l1, float& alpha0,
                                               float& alpha1, uint32_t (&p)[kPvSteps][4]) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int nb = 0; nb < kBlockK / 8; ++nb) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * nb], s[4 * nb + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
  }
  const float mul = kScaleIn ? scale : 1.f;
  const float n0 = fmaxf(m0, quad_max(mx0) * mul);
  const float n1 = fmaxf(m1, quad_max(mx1) * mul);
  alpha0 = exp_f32(m0 - n0);
  alpha1 = exp_f32(m1 - n1);
  m0 = n0;
  m1 = n1;
  if (kBf16P) {
#pragma unroll
    for (int js = 0; js < kPvSteps; ++js) {
      const float* x = &s[8 * js];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // exp(bf16(s - m)) of keys 2t, 2t + 1 (+ 8) of a row
        const float n = (e & 1) ? n1 : n0;
        p[js][e] = exp_bf16x2(pack_bf16(fmaf(x[2 * e], mul, -n), fmaf(x[2 * e + 1], mul, -n)));
      }
    }
    float part0 = 0.f, part1 = 0.f;
#pragma unroll
    for (int js = 0; js < kPvSteps; ++js) {
      part0 += pair_sum(p[js][0]) + pair_sum(p[js][2]);
      part1 += pair_sum(p[js][1]) + pair_sum(p[js][3]);
    }
    l0 = l0 * alpha0 + part0;
    l1 = l1 * alpha1 + part1;
    return;
  }
  const float e0 = mul * kLog2e, c0 = -n0 * kLog2e, c1 = -n1 * kLog2e;
  float part0 = 0.f, part1 = 0.f;
#pragma unroll
  for (int js = 0; js < kPvSteps; ++js) {
    // fresh registers: writing s, the accumulator of a product of the same
    // wgmma stage, would make ptxas serialize the kernel's products
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = ex2_f32(fmaf(s[8 * js + e], e0, (e & 2) ? c1 : c0));
    part0 += x[0] + x[1] + x[4] + x[5];
    part1 += x[2] + x[3] + x[6] + x[7];
    p[js][0] = pack_bf16(x[0], x[1]);
    p[js][1] = pack_bf16(x[2], x[3]);
    p[js][2] = pack_bf16(x[4], x[5]);
    p[js][3] = pack_bf16(x[6], x[7]);
  }
  l0 = l0 * alpha0 + part0;
  l1 = l1 * alpha1 + part1;
}

// One tile j >= 1 of the VPU kernel's pipeline: the QK product of tile j is
// issued with the PV product of tile j - 1 (A fragments `p`), tile j's
// softmax runs while the latter is in flight and writes `pn`, then acc =
// that times alpha_j.
template <bool kScaleIn, bool kBf16P>
__device__ __forceinline__ void vpu_tile(const Ring& r, int j, uint64_t q_desc, float scale,
                                         float (&s)[kSRegs], float (&acc)[kORegs],
                                         uint32_t (&p)[kPvSteps][4],
                                         uint32_t (&pn)[kPvSteps][4], float& m0, float& m1,
                                         float& l0, float& l1) {
  const int st = j % kStages;
  const int prev = (j - 1) % kStages;
  float alpha0, alpha1;
  wgmma_fence();
  mbar_wait(r.k_full(st), (j / kStages) & 1);
  qk_products<kBlockK>(s, q_desc, wgmma_desc_sw128(smem_addr(r.k(st))));
  wgmma_commit();
  mbar_wait(r.v_full(prev), ((j - 1) / kStages) & 1);
  pv_products<kPvSteps>(acc, p, 0, wgmma_desc_sw128(smem_addr(r.v(prev))));
  wgmma_commit();
  wgmma_wait<1>();  // QK of tile j
  reg_fence(s);
  online_softmax<kScaleIn, kBf16P>(s, scale, m0, m1, l0, l1, alpha0, alpha1, pn);
  wgmma_wait<0>();  // PV of tile j - 1
  reg_fence(acc);
  reg_fence(p);
  release(r, prev);
#pragma unroll
  for (int nb = 0; nb < kD / 8; ++nb) {
    acc[4 * nb] *= alpha0;
    acc[4 * nb + 1] *= alpha0;
    acc[4 * nb + 2] *= alpha1;
    acc[4 * nb + 3] *= alpha1;
  }
}

// The last tile's PV product (A fragments `p`)
__device__ __forceinline__ void vpu_last(const Ring& r, int tiles, float (&acc)[kORegs],
                                         uint32_t (&p)[kPvSteps][4]) {
  const int last = (tiles - 1) % kStages;
  wgmma_fence();
  mbar_wait(r.v_full(last), ((tiles - 1) / kStages) & 1);
  pv_products<kPvSteps>(acc, p, 0, wgmma_desc_sw128(smem_addr(r.v(last))));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(p);
  release(r, last);
}

// A consumer warpgroup of the VPU kernel: tile 0's QK product and softmax,
// then vpu_tile for tiles 1 .. tiles - 1, two a loop step with the two sets
// of A fragments in fixed roles (a copy between them would write an input of
// the product in flight, and ptxas would serialize the pipeline), then the
// last PV product.
template <bool kScaleIn, bool kBf16P>
__device__ __forceinline__ void vpu_consume(const Ring& r, bf16* __restrict__ o, int row, int sq,
                                            int tiles, float scale) {
  const int wg = threadIdx.x / 128;
  const uint64_t q_desc = wgmma_desc_sw128(smem_addr(r.q(wg)));
  float acc[kORegs];
#pragma unroll
  for (int i = 0; i < kORegs; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, alpha0, alpha1;
  float s[kSRegs];
  uint32_t pa[kPvSteps][4], pb[kPvSteps][4];  // A fragments of even and odd tiles

  mbar_wait(r.q_full(wg), 0);
  mbar_wait(r.k_full(0), 0);
  wgmma_fence();
  qk_products<kBlockK>(s, q_desc, wgmma_desc_sw128(smem_addr(r.k(0))));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  online_softmax<kScaleIn, kBf16P>(s, scale, m0, m1, l0, l1, alpha0, alpha1, pa);
  int j = 1;
#pragma unroll 1
  for (; j + 1 < tiles; j += 2) {
    vpu_tile<kScaleIn, kBf16P>(r, j, q_desc, scale, s, acc, pa, pb, m0, m1, l0, l1);
    vpu_tile<kScaleIn, kBf16P>(r, j + 1, q_desc, scale, s, acc, pb, pa, m0, m1, l0, l1);
  }
  if (j < tiles) {  // an even tile count: one more tile, then the last (odd) tile's PV
    vpu_tile<kScaleIn, kBf16P>(r, j, q_desc, scale, s, acc, pa, pb, m0, m1, l0, l1);
    vpu_last(r, tiles, acc, pb);
  } else {
    vpu_last(r, tiles, acc, pa);
  }
  store_out(o, acc, quad_sum(l0), quad_sum(l1), row, sq);
}

// Grid: x = query blocks of kBlockQ rows, y = BH; kThreads threads and
// kSmemBytes of dynamic shared memory. Warpgroups 0 and 1 consume, 2
// produces: one if-else, the roles never rejoin.
template <int V>
__global__ void __launch_bounds__(kThreads, 1)
flash_probe_overlap_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                           int sq, int sk) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = make_ring(smem_raw);
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ;
  const int tiles = (sk + kBlockK - 1) / kBlockK;
  if (threadIdx.x >= kConsumerThreads) {
    regs_lower<kProducerRegs>();
    produce(r, &q_map, &k_map, &v_map, bh, row0, sq, tiles);
  } else {
    regs_raise<kConsumerRegs>();
    overlap_consume<V>(r, o + static_cast<size_t>(bh) * sq * kD,
                       row0 + threadIdx.x / 128 * kRowsWg, sq, sk, tiles);
  }
}

// Grid and roles as the overlap kernel's. kScaleIn: s times `scale` (q not
// prescaled).
template <bool kScaleIn, bool kBf16P>
__global__ void __launch_bounds__(kThreads, 1)
flash_probe_vpu_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int sq,
                       int sk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = make_ring(smem_raw);
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ;
  const int tiles = sk / kBlockK;
  if (threadIdx.x >= kConsumerThreads) {
    regs_lower<kProducerRegs>();
    produce(r, &q_map, &k_map, &v_map, bh, row0, sq, tiles);
  } else {
    regs_raise<kConsumerRegs>();
    vpu_consume<kScaleIn, kBf16P>(r, o + static_cast<size_t>(bh) * sq * kD,
                                  row0 + threadIdx.x / 128 * kRowsWg, sq, tiles, scale);
  }
}

// The maps of q (box: a warpgroup's 64 rows), k and v (box: a 128-key tile),
// each (bh, s, 64) bf16 contiguous seen as (64, s, bh), rows of 128 bytes in
// the 128-byte swizzle
cudaError_t encode_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, int bh,
                        int sq, int sk) {
  const void* base[3] = {q, k, v};
  const int rows[3] = {sq, sk, sk};
  const cuuint32_t box_rows[3] = {kRowsWg, kBlockK, kBlockK};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[3] = {kD, static_cast<cuuint64_t>(rows[i]),
                                static_cast<cuuint64_t>(bh)};
    const cuuint64_t strides[2] = {kD * 2, static_cast<cuuint64_t>(rows[i]) * kD * 2};
    const cuuint32_t box[3] = {kD, box_rows[i], 1};
    const cudaError_t err = encode_tiled_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                             base[i], dims, strides, box,
                                             CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const void* q, const void* k, const void* v, int bh, int sq, int sk,
           cudaStream_t stream, Args... args) {
  CUtensorMap maps[3];
  cudaError_t err = encode_maps(maps, q, k, v, bh, sq, sk);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sq + kBlockQ - 1) / kBlockQ, bh), kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], args...);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_overlap(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                   cudaStream_t stream) {
  return launch(flash_probe_overlap_kernel<V>, q, k, v, bh, sq, sk, stream,
                static_cast<bf16*>(o), sq, sk);
}

template <bool kScaleIn, bool kBf16P>
int launch_vpu(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
               float scale, cudaStream_t stream) {
  return launch(flash_probe_vpu_kernel<kScaleIn, kBf16P>, q, k, v, bh, sq, sk, stream,
                static_cast<bf16*>(o), sq, sk, scale);
}

}  // namespace

// q (prescaled by bf16(scale * log2(e))), o (bh, sq, 64), k and v (bh, sk,
// 64), all bf16, contiguous and 16-byte aligned; sq a multiple of 64 (128
// for q2), sk of 64. variant: the index in OVERLAP_VARIANTS
// (ops/flash_probes.py). Launches on `stream` of `device`; returns the first
// CUDA error of the maps' encoding, the shared-memory attribute or the
// launch (0 on success).
extern "C" int gm_flash_probe_overlap(const void* q, const void* k, const void* v, void* o,
                                      int bh, int sq, int sk, int variant, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sq % kRowsWg || sk % (kBlockK / 2) || sq <= 0 || sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return launch_overlap<kFull>(q, k, v, o, bh, sq, sk, s);
    case kMxuOnly: return launch_overlap<kMxuOnly>(q, k, v, o, bh, sq, sk, s);
    case kIlv2: return launch_overlap<kIlv2>(q, k, v, o, bh, sq, sk, s);
    case kIlv4: return launch_overlap<kIlv4>(q, k, v, o, bh, sq, sk, s);
    case kQ2:
      if (sq % kBlockQ) return static_cast<int>(cudaErrorInvalidValue);
      return launch_overlap<kQ2>(q, k, v, o, bh, sq, sk, s);
    case kBf16Dom: return launch_overlap<kBf16Dom>(q, k, v, o, bh, sq, sk, s);
    case kIlv2Bf16: return launch_overlap<kIlv2Bf16>(q, k, v, o, bh, sq, sk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (prescaled by scale outside when scale_in_kernel is 0), o (bh, sq, 64),
// k and v (bh, sk, 64), all bf16, contiguous and 16-byte aligned; sq a
// multiple of 64, sk of 128 (the key step). Same return and stream as
// gm_flash_probe_overlap.
extern "C" int gm_flash_probe_vpu(const void* q, const void* k, const void* v, void* o, int bh,
                                  int sq, int sk, int scale_in_kernel, int bf16_p, float scale,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sq % kRowsWg || sk % kBlockK || sq <= 0 || sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale_in_kernel) {
    return bf16_p ? launch_vpu<true, true>(q, k, v, o, bh, sq, sk, scale, s)
                  : launch_vpu<true, false>(q, k, v, o, bh, sq, sk, scale, s);
  }
  return bf16_p ? launch_vpu<false, true>(q, k, v, o, bh, sq, sk, scale, s)
                : launch_vpu<false, false>(q, k, v, o, bh, sq, sk, scale, s);
}
