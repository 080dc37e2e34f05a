// The two attention-forward probe kernels for Hopper (sm_90a), plain C
// interface for ctypes. Both run their products on the tensor cores with
// mma.sync m16n8k16 (bf16 operands, f32 accumulation), as the TPU kernels'
// dot_general(..., preferred_element_type=f32) run theirs on the MXU.
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
// The variants differ in program order and sharing only:
//   ilv2 / ilv4 (and ilv2_bf16): the 64-key step is split into 2 or 4
//     sub-tiles; every QK product of the step is issued first, then each
//     sub-tile's exp2 followed by its PV products (the TPU probe's order
//     s1, s2, p1, pv1, p2, pv2), so one sub-tile's exp2 can run while the
//     previous sub-tile's products are in the tensor pipe;
//   q2: each warp owns two 16-row q fragments that share every K and V
//     fragment it reads from shared memory (the TPU probe's two q tiles over
//     one K/V tile): two independent chains and half the shared-memory reads
//     per query row.
//
// flash_probe_vpu_kernel replaces benchmarks/probe_attn_vpu.py
// ::_fwd_kernel_var: the online-max natural-exp forward, per 64-key tile
//   s = q k^T (f32), times scale unless q was prescaled outside;
//   m_new = max(m, rowmax(s)) (m starts at -1e30), alpha = exp(m - m_new);
//   bf16_p:  p = exp(bf16(s - m_new)) in packed bf16, l = l alpha + f32
//            sum(p);
//   else:    p = exp(s - m_new) in f32, l = l alpha + sum(p) (unrounded);
//   acc = acc alpha + bf16(p) V;  o = bf16(acc / max(l, 1e-30)).
// Because p is rounded against the running max, the result depends on the
// key step (64); the plain version takes it as block_k.
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
// What the design does about it: both products on the tensor cores, with the
// FlashAttention-2 register reuse: a warp owns 16 query rows (an m16
// fragment; two for q2), keeps its Q fragments in registers for the whole
// key loop, and its S accumulator, converted to bf16 pairs, is the A
// operand of the PV product without a trip through shared memory. A block
// of 4 warps (64 rows; 128 for q2) stages 64-key K and V tiles in shared
// memory with cp.async, two stages deep, so the next tile's copy overlaps
// this tile's products. K fragments are read with 32-bit loads (rows padded
// to 72 bf16, so a fragment's 8 rows x 4 words fall in 32 distinct banks),
// V fragments with ldmatrix.trans. The row sum l of the overlap kernel (and
// of bf16_p) comes from one more n8 product against a tile of ones, the
// TPU's ones column appended to V, so even mxu_only does no CUDA-core
// reduction. wgmma, TMA and warp specialisation are not used: these are
// probes of the mma.sync path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kD = 64;                 // head width
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;            // keys a step
constexpr int kLd = kD + 8;            // shared-memory row stride in bf16 (144 bytes)
constexpr int kDSteps = kD / 16;       // k-steps of the QK product
constexpr int kKeyTiles = kBlockK / 8;   // n8 tiles of S in a step
constexpr int kKeySteps = kBlockK / 16;  // k-steps of the PV product in a step
constexpr int kDTiles = kD / 8;        // n8 tiles of O
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 (1, 1)
constexpr uint32_t kClamp = 0x42A042A0u;  // bf16x2 (80, 80)
constexpr uint32_t kLn2 = 0x3F313F31u;  // bf16x2 (ln 2) = 0.69140625, jnp.exp2's constant
constexpr uint32_t kLog2eHi = 0x3FB83FB8u;  // bf16x2 1.4375
constexpr uint32_t kLog2eLo = 0x3BAA3BAAu;  // bf16x2 0.00518798828125: hi + lo = log2(e) - 7e-6
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels

// the variants of the overlap probe, in the order of OVERLAP_VARIANTS in
// ops/flash_probes.py
enum Variant { kFull = 0, kMxuOnly, kIlv2, kIlv4, kQ2, kBf16Dom, kIlv2Bf16 };

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// Stage one 64-key tile (kBlockK rows of kD bf16, contiguous) into shared
// memory with row stride kLd: 8 16-byte copies a row, 4 a thread.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* __restrict__ src) {
#pragma unroll
  for (int i = threadIdx.x; i < kBlockK * kD / 8; i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    cp_async16(dst + r * kLd + c, src + r * kD + c);
  }
}

// The A fragments of M 16-row q fragments starting at `q` (rows of kD bf16):
// for k-step kk, rows g and g + 8, columns 16 kk + 2t (+1) and + 8.
template <int M>
__device__ __forceinline__ void load_q(uint32_t (&qf)[M][kDSteps][4], const bf16* __restrict__ q,
                                       int g, int t) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const bf16* r0 = q + (16 * m + g) * kD;
    const bf16* r1 = r0 + 8 * kD;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      const int c = 16 * kk + 2 * t;
      qf[m][kk][0] = *reinterpret_cast<const uint32_t*>(r0 + c);
      qf[m][kk][1] = *reinterpret_cast<const uint32_t*>(r1 + c);
      qf[m][kk][2] = *reinterpret_cast<const uint32_t*>(r0 + c + 8);
      qf[m][kk][3] = *reinterpret_cast<const uint32_t*>(r1 + c + 8);
    }
  }
}

// s[m] = q[m] k^T for the staged 64-key tile; each K fragment is read once
// for all M q fragments. B fragment of key tile nt, k-step kk: key nt*8 + g,
// columns 16 kk + 2t (+1) and + 8.
template <int M>
__device__ __forceinline__ void qk_product(float (&s)[M][kKeyTiles][4],
                                           const uint32_t (&qf)[M][kDSteps][4], const bf16* sK,
                                           int g, int t) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][nt][e] = 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
      const bf16* kp = sK + (nt * 8 + g) * kLd + 16 * kk + 2 * t;
      const uint32_t b0 = lds32(kp);
      const uint32_t b1 = lds32(kp + 8);
#pragma unroll
      for (int m = 0; m < M; ++m) mma_bf16(s[m][nt], qf[m][kk], b0, b1);
    }
  }
}

// acc[m] += p[m] V for PV k-step j (keys 16 j .. 16 j + 15 of the staged
// tile), each V fragment read once for all M; with kRowSum also
// l[m] += p[m] 1 (every column of l holds the row sum).
template <int M, bool kRowSum>
__device__ __forceinline__ void pv_product(float (&acc)[M][kDTiles][4], float (&l)[M][4],
                                           const uint32_t (&p)[M][4], const bf16* sV, int j,
                                           int lane) {
  const int mi = lane >> 3;
  const bf16* base = sV + (16 * j + (mi & 1) * 8 + (lane & 7)) * kLd + (mi >> 1) * 8;
#pragma unroll
  for (int dp = 0; dp < kD / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, base + 16 * dp);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mma_bf16(acc[m][2 * dp], p[m], b[0], b[1]);
      mma_bf16(acc[m][2 * dp + 1], p[m], b[2], b[3]);
    }
  }
  if (kRowSum) {
#pragma unroll
    for (int m = 0; m < M; ++m) mma_bf16(l[m], p[m], kOnes, kOnes);
  }
}

// p of two neighbouring scores as a bf16 pair, by the variant's rule
template <int V>
__device__ __forceinline__ uint32_t probs(float lo, float hi) {
  if (V == kMxuOnly) return pack_bf16(lo, hi);
  if (V == kBf16Dom || V == kIlv2Bf16) {
    return exp_bf16x2(mul_bf16x2(min_bf16x2(pack_bf16(lo, hi), kClamp), kLn2));
  }
  return pack_bf16(ex2_f32(fminf(lo, 80.f)), ex2_f32(fminf(hi, 80.f)));
}

// The A fragment of PV k-step j from the S accumulators of key tiles 2j and
// 2j + 1 (the C layout of one mma is the A layout of the next).
template <int V>
__device__ __forceinline__ void probs_fragment(uint32_t (&a)[4], const float (&s)[kKeyTiles][4],
                                               int j) {
  a[0] = probs<V>(s[2 * j][0], s[2 * j][1]);
  a[1] = probs<V>(s[2 * j][2], s[2 * j][3]);
  a[2] = probs<V>(s[2 * j + 1][0], s[2 * j + 1][1]);
  a[3] = probs<V>(s[2 * j + 1][2], s[2 * j + 1][3]);
}

// o = bf16(acc / max(l, 1e-30)) for M 16-row fragments starting at `o`;
// l0, l1 are the row sums of rows g and g + 8.
template <int M>
__device__ __forceinline__ void store_out(bf16* __restrict__ o, const float (&acc)[M][kDTiles][4],
                                          const float (&l0)[M], const float (&l1)[M], int g,
                                          int t) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float d0 = fmaxf(l0[m], 1e-30f);
    const float d1 = fmaxf(l1[m], 1e-30f);
    bf16* r0 = o + (16 * m + g) * kD + 2 * t;
    bf16* r1 = r0 + 8 * kD;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(r0 + nt * 8) =
          pack_bf16(acc[m][nt][0] / d0, acc[m][nt][1] / d0);
      *reinterpret_cast<uint32_t*>(r1 + nt * 8) =
          pack_bf16(acc[m][nt][2] / d1, acc[m][nt][3] / d1);
    }
  }
}

template <int V>
struct OverlapCfg {
  static constexpr int kM = V == kQ2 ? 2 : 1;  // 16-row q fragments a warp
  static constexpr int kSub = V == kIlv4 ? 4 : (V == kIlv2 || V == kIlv2Bf16) ? 2 : 1;
  static constexpr int kBlockQ = kWarps * 16 * kM;
  static constexpr int kStepsPerSub = kKeySteps / kSub;  // PV k-steps a sub-tile
};

// Grid: x = query blocks of kBlockQ rows, y = BH. Sq and Sk are multiples of
// kBlockQ and kBlockK (the launcher checks).
template <int V>
__global__ void __launch_bounds__(kThreads)
flash_probe_overlap_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int sq, int sk) {
  using Cfg = OverlapCfg<V>;
  constexpr int M = Cfg::kM;
  __shared__ __align__(16) bf16 sK[2][kBlockK * kLd];
  __shared__ __align__(16) bf16 sV[2][kBlockK * kLd];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * Cfg::kBlockQ + warp * 16 * M;
  const bf16* kb = k + bh * sk * kD;
  const bf16* vb = v + bh * sk * kD;

  uint32_t qf[M][kDSteps][4];
  load_q<M>(qf, q + (bh * sq + row0) * kD, g, t);
  float acc[M][kDTiles][4];
  float l[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) l[m][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
    }
  }

  const int num_k = sk / kBlockK;
  stage_tile(sK[0], kb);
  stage_tile(sV[0], vb);
  cp_async_commit();
  for (int j = 0; j < num_k; ++j) {
    const int st = j & 1;
    if (j + 1 < num_k) {  // the next tile's copy runs under this tile's products
      stage_tile(sK[st ^ 1], kb + static_cast<size_t>(j + 1) * kBlockK * kD);
      stage_tile(sV[st ^ 1], vb + static_cast<size_t>(j + 1) * kBlockK * kD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[M][kKeyTiles][4];
    qk_product<M>(s, qf, sK[st], g, t);
#pragma unroll
    for (int h = 0; h < Cfg::kSub; ++h) {
      uint32_t p[Cfg::kStepsPerSub][M][4];
#pragma unroll
      for (int js = 0; js < Cfg::kStepsPerSub; ++js) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          probs_fragment<V>(p[js][m], s[m], h * Cfg::kStepsPerSub + js);
        }
      }
#pragma unroll
      for (int js = 0; js < Cfg::kStepsPerSub; ++js) {
        pv_product<M, true>(acc, l, p[js], sV[st], h * Cfg::kStepsPerSub + js, lane);
      }
    }
    __syncthreads();  // stage st is refilled by the copy issued at step j + 1
  }

  float l0[M], l1[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    l0[m] = l[m][0];
    l1[m] = l[m][2];
  }
  store_out<M>(o + (bh * sq + row0) * kD, acc, l0, l1, g, t);
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

// exp(bf16(x - m)) of two neighbouring scores, in bf16
__device__ __forceinline__ uint32_t exp_shifted(float x0, float x1, float m) {
  return exp_bf16x2(pack_bf16(x0 - m, x1 - m));
}

// Grid as the overlap kernel's, 64-row query blocks. kScaleIn: s times
// `scale` (q not prescaled).
template <bool kScaleIn, bool kBf16P>
__global__ void __launch_bounds__(kThreads)
flash_probe_vpu_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int sq, int sk,
                       float scale) {
  constexpr int kBlockQ = kWarps * 16;
  __shared__ __align__(16) bf16 sK[2][kBlockK * kLd];
  __shared__ __align__(16) bf16 sV[2][kBlockK * kLd];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ + warp * 16;
  const bf16* kb = k + bh * sk * kD;
  const bf16* vb = v + bh * sk * kD;

  uint32_t qf[1][kDSteps][4];
  load_q<1>(qf, q + (bh * sq + row0) * kD, g, t);
  float acc[1][kDTiles][4];
  float lmma[1][4];  // bf16_p: the row sums from the ones product
  float lsum[2] = {0.f, 0.f};  // f32 p: this thread's part of rows g, g + 8
  float mrow[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < 4; ++e) lmma[0][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.f;
  }

  const int num_k = sk / kBlockK;
  stage_tile(sK[0], kb);
  stage_tile(sV[0], vb);
  cp_async_commit();
  for (int j = 0; j < num_k; ++j) {
    const int st = j & 1;
    if (j + 1 < num_k) {
      stage_tile(sK[st ^ 1], kb + static_cast<size_t>(j + 1) * kBlockK * kD);
      stage_tile(sV[st ^ 1], vb + static_cast<size_t>(j + 1) * kBlockK * kD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[1][kKeyTiles][4];
    qk_product<1>(s, qf, sK[st], g, t);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
      if (kScaleIn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][nt][e] *= scale;
      }
      mx0 = fmaxf(mx0, fmaxf(s[0][nt][0], s[0][nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[0][nt][2], s[0][nt][3]));
    }
    const float m0 = fmaxf(mrow[0], quad_max(mx0));
    const float m1 = fmaxf(mrow[1], quad_max(mx1));
    const float alpha0 = exp_f32(mrow[0] - m0);
    const float alpha1 = exp_f32(mrow[1] - m1);
    mrow[0] = m0;
    mrow[1] = m1;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      acc[0][nt][0] *= alpha0;
      acc[0][nt][1] *= alpha0;
      acc[0][nt][2] *= alpha1;
      acc[0][nt][3] *= alpha1;
    }

    uint32_t p[kKeySteps][1][4];
    if (kBf16P) {
      lmma[0][0] *= alpha0;
      lmma[0][1] *= alpha0;
      lmma[0][2] *= alpha1;
      lmma[0][3] *= alpha1;
#pragma unroll
      for (int jj = 0; jj < kKeySteps; ++jj) {
        const float(&s0)[4] = s[0][2 * jj];
        const float(&s1)[4] = s[0][2 * jj + 1];
        p[jj][0][0] = exp_shifted(s0[0], s0[1], m0);
        p[jj][0][1] = exp_shifted(s0[2], s0[3], m1);
        p[jj][0][2] = exp_shifted(s1[0], s1[1], m0);
        p[jj][0][3] = exp_shifted(s1[2], s1[3], m1);
      }
    } else {
      float part0 = 0.f, part1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
        s[0][nt][0] = exp_f32(s[0][nt][0] - m0);
        s[0][nt][1] = exp_f32(s[0][nt][1] - m0);
        s[0][nt][2] = exp_f32(s[0][nt][2] - m1);
        s[0][nt][3] = exp_f32(s[0][nt][3] - m1);
        part0 += s[0][nt][0] + s[0][nt][1];
        part1 += s[0][nt][2] + s[0][nt][3];
      }
      lsum[0] = lsum[0] * alpha0 + part0;
      lsum[1] = lsum[1] * alpha1 + part1;
#pragma unroll
      for (int jj = 0; jj < kKeySteps; ++jj) probs_fragment<kMxuOnly>(p[jj][0], s[0], jj);
    }
#pragma unroll
    for (int jj = 0; jj < kKeySteps; ++jj) {
      pv_product<1, kBf16P>(acc, lmma, p[jj], sV[st], jj, lane);
    }
    __syncthreads();
  }

  float l0[1], l1[1];
  if (kBf16P) {
    l0[0] = lmma[0][0];
    l1[0] = lmma[0][2];
  } else {
    l0[0] = quad_sum(lsum[0]);
    l1[0] = quad_sum(lsum[1]);
  }
  store_out<1>(o + (bh * sq + row0) * kD, acc, l0, l1, g, t);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int block_q, int bh, int sq, cudaStream_t stream, Args... args) {
  kernel<<<dim3(sq / block_q, bh), kThreads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_overlap(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int sq, int sk,
                   cudaStream_t stream) {
  return launch(flash_probe_overlap_kernel<V>, OverlapCfg<V>::kBlockQ, bh, sq, stream, q, k, v,
                o, sq, sk);
}

}  // namespace

// q (prescaled by bf16(scale * log2(e))), o (bh, sq, 64), k and v (bh, sk,
// 64), all bf16 and contiguous; sq a multiple of 64 (128 for q2), sk of 64.
// variant: the index in OVERLAP_VARIANTS (ops/flash_probes.py). Launches on
// `stream` of `device`; returns cudaGetLastError() of the launch (0 on
// success).
extern "C" int gm_flash_probe_overlap(const void* q, const void* k, const void* v, void* o,
                                      int bh, int sq, int sk, int variant, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return launch_overlap<kFull>(qq, kk, vv, oo, bh, sq, sk, s);
    case kMxuOnly: return launch_overlap<kMxuOnly>(qq, kk, vv, oo, bh, sq, sk, s);
    case kIlv2: return launch_overlap<kIlv2>(qq, kk, vv, oo, bh, sq, sk, s);
    case kIlv4: return launch_overlap<kIlv4>(qq, kk, vv, oo, bh, sq, sk, s);
    case kQ2: return launch_overlap<kQ2>(qq, kk, vv, oo, bh, sq, sk, s);
    case kBf16Dom: return launch_overlap<kBf16Dom>(qq, kk, vv, oo, bh, sq, sk, s);
    case kIlv2Bf16: return launch_overlap<kIlv2Bf16>(qq, kk, vv, oo, bh, sq, sk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (prescaled by scale outside when scale_in_kernel is 0), o (bh, sq, 64),
// k and v (bh, sk, 64), all bf16 and contiguous; sq and sk multiples of 64.
// Same return and stream as gm_flash_probe_overlap.
extern "C" int gm_flash_probe_vpu(const void* q, const void* k, const void* v, void* o, int bh,
                                  int sq, int sk, int scale_in_kernel, int bf16_p, float scale,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kBlockQ = kWarps * 16;
  if (scale_in_kernel) {
    if (bf16_p) {
      return launch(flash_probe_vpu_kernel<true, true>, kBlockQ, bh, sq, s, qq, kk, vv, oo, sq, sk,
                    scale);
    }
    return launch(flash_probe_vpu_kernel<true, false>, kBlockQ, bh, sq, s, qq, kk, vv, oo, sq, sk,
                  scale);
  }
  if (bf16_p) {
    return launch(flash_probe_vpu_kernel<false, true>, kBlockQ, bh, sq, s, qq, kk, vv, oo, sq, sk,
                  scale);
  }
  return launch(flash_probe_vpu_kernel<false, false>, kBlockQ, bh, sq, s, qq, kk, vv, oo, sq, sk,
                scale);
}
