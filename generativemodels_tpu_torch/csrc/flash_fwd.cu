// Flash-attention forward for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel generativemodels_tpu/ops/flash_attention.py
// ::_flash_fwd_impl (its `_fwd_kernel`, with _fwd_tile, _build_mask and
// _pv_update) in its three contracts (flash_contract.cuh), each kernel
// instantiated for each. The default one, kNoMax: q arrives unscaled and is multiplied
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
// kRunningMax keeps that prescale and domain but no clamp: each warp keeps
// the running max m of its rows (a tile's row max, then a quad shuffle), p =
// exp2(s - m), its l and O accumulators are rescaled by exp2(m_prev - m) as
// m grows, l sums the unrounded p, and lse = lse_mul * (m + log2(l)).
// kUpcast (f32 only) takes q as it is (qscale 1), multiplies each score by
// sscale (the softmax scale) after the product, and runs the same running
// max with exp in the natural domain; lse = m + log(l). Under both, a row
// all of whose keys so far are masked keeps m = -inf and offsets its scores
// by 0, so no exp meets -inf - -inf (a key tile past a ragged Sk of 1, or a
// causal tile above a row), and the f32 kernel's key slices, each with its
// own m, are merged by rescaling to their common max.
//
// What bounds it on this card:
// - 3D shape (BH=2, S=32768, D=64, bf16): 4 BH S^2 D = 5.5e11 operations on
//   16 MB of operands, 0.556 ms at the bf16 tensor-core rate (989 TFLOP/s)
//   against 0.005 ms for the bytes: bound by operations. With mma.sync the
//   tensor pipe's issue rate and the K/V fragment reads from shared memory
//   set the floor (the probes of csrc/flash_probes.cu measured it: 1.86 ms
//   for the products alone, 1.85-1.90 ms with two 16-row fragments a warp);
//   on the wgmma route the softmax between the products and each block's
//   reads of its head's K and V from L2 (8 MB a block at the 3D shape).
// - bench.py's 2D training shape (BH=128, S=1024, D=256, bf16): 1.4e11
//   operations, 0.139 ms; each 128-row block reads its head's K and V from
//   L2 (1 MB a block, 1 GB a launch), and S = Q K^T reads both operands
//   from shared memory (m64n64k16: 4 KB each 32 tensor cycles, the 128
//   bytes a cycle shared memory gives).
// - f32 (the 2D recipe's (64, 1024, 1024, 256), the serving shape (4, 1024,
//   1024, 256), ControlNet's D = 128): the tensor cores run each f32
//   product as 3xTF32 (three TF32 products), so the bound is 3 x the useful
//   operations at the TF32 rate (495 TFLOP/s): 0.416, 0.026 and (batch 16)
//   0.052 ms. The serving shape has only 4096 query rows: 64 blocks of 64
//   rows would leave half of the 132 SMs idle (one warp a 16-row fragment,
//   an earlier design, left each SM sub-partition one warp walking all 1024
//   keys and was slower than the plain version).
//
// Three routes, each input taking one body: the `route` argument of the C
// entry names it (ops/flash_attention.py::attention_route picks it; an
// unknown route, or a route the inputs do not take, returns an error and
// launches nothing):
// - kRouteWgmma, bf16 at D = 64 in the two exp2 contracts (the 3D UNet's
//   attention, the latent UNet's, the 3D LDM's bf16 stages and the
//   sequence-parallel calls): flash_fwd_wgmma_kernel, kernel 6's main loop
//   (csrc/flash_probes.cu) with the contract's masks and rows. A producer
//   warpgroup's first thread loads each consumer's 64 Q rows once and keeps
//   128-key K and V tiles in flight by TMA into a four-stage ring (maps of
//   (64, S, BH): rows past S read as 0); each consumer warpgroup scales its
//   Q tile by qscale in place (rounded to bf16, as load_q_bf16), then per
//   tile issues S = Q K^T as wgmma m64n128k16 (both operands from shared
//   memory, K-major) and, with the next tile's, O += P V as m64n64k16 with P
//   rounded to bf16 pairs as the register A operand and V MN-major, and
//   waits once; the softmax runs between the waits (ex2.approx.ftz on the
//   SFU). kNoMax: p = exp2(min(s, 80)) and l from one m64n8k16 product of
//   the same A fragment against a block of ones a k-step (the f32 sum of the
//   bf16 p, the JAX kernel's fold_l); kRunningMax: a running max m a row
//   (quad shuffles), p = exp2(s - m), l the f32 sum of the unrounded p, O
//   rescaled by exp2(m_prev - m) once the product adding to it is done.
//   Masked keys get p = 0 exactly, tested only in a tile that reaches past
//   Sk or across the causal diagonal (a uniform branch with no product in
//   flight); under the causal mask key tiles wholly above a block are
//   never loaded. A block is two consumers (128 rows) unless BH *
//   ceil(Sq / 128) blocks leave half of the card's SMs or more idle, then
//   one (64 rows: the latent UNet's (2, 4096, 4096) takes 128 blocks, not
//   64); keys are never split, so a row is computed by one warpgroup over
//   every key tile in the same order and its bits do not depend on Sq or
//   the block height (the sequence-parallel rows equal the unsharded ones).
//   FlashAttention-3's intra-warpgroup order (the PV product in flight
//   during the next tile's softmax, kernel 7's loop) was 4-11% faster under
//   kNoMax at the 3D and sequence-parallel shapes, not at the latent one,
//   and ptxas serialized its running-max products (C7520): not kept.
//   kRouteWgmma at bf16 D = 256 in the same contracts (the 2D UNets'
//   256-wide heads: bench.py's training step): flash_fwd_wide_kernel
//   (namespace wd), the same roles, block heights and loop, widened as
//   flash_bwd.cu's wd widens kernels 2 and 3. A 512-byte row is four
//   128-byte swizzle atoms, each loaded by its own 64-column TMA box (maps
//   of (256, S, BH); atom a of a tile holds its columns 64a .. 64a + 63):
//   S = Q K^T is m64n64k16 over 16 k-steps, each inside one atom (the
//   descriptors step from atom to atom); O += P V is one m64n64k16 an atom
//   of V (MN-major: no descriptor spans atoms) a k-step, into the atom's
//   64-column chunk of O. Registers (240 a consumer thread): O, m64n256
//   f32, 128; S, m64n64, 32; P, 16; the row max and sums, 4; addresses and
//   indices the rest (ptxas: no spills). The 64-key stages fill the shared
//   memory Q leaves: two of K and V beside two consumers' Q (64 KB), three
//   beside one's. The row sum is each thread's f32 sum of the unrounded p
//   and a quad shuffle in both contracts (the JAX kernel's rule at D % 128
//   == 0: no product against ones, which would sum the bf16-rounded p).
// - kRouteTf32, f32 operands at D = 128 and 256 in all three contracts (the
//   2D f32 recipe, the serving sampler, ControlNet; upcast at those widths,
//   whose bf16 inputs the launcher casts to f32): flash_fwd_stream_kernel
//   (namespace ts), one template over D / 32 atoms after flash_bwd.cu's ts
//   body of kernels 2 and 3. A block holds 64 query rows: Q resident raw
//   as TMA wrote it (32-column atoms of 64 rows), K and V streamed in tiles
//   of 32 keys through a ring of 16 KB stages (a K stage: two atoms, split
//   into TF32 hi over the raw atoms and lo after them by the producer
//   warpgroup's warps 1-3; a V stage: four raw atoms). The two consumer
//   warpgroups take every other tile, each with its own P buffers, running
//   max and O, and no barrier between them until the end:
//   - S = Q K^T over d, an atom at a time (m64n32k8, 3xTF32: lo x hi, hi x
//     lo, hi x hi), A the consumer's Q fragments loaded raw, times qscale
//     and split in registers by integer operations (round_tf32), B the
//     stage's split atom;
//   - p, the running max and the row sums, as the wgmma route's, in the
//     contract's domain (kUpcast: s times sscale, natural exp); p's hi and
//     lo go to the consumer's P buffers, row by query and the keys in the
//     order the next product's A fragment reads them;
//   - TF32 wgmma reads both shared-memory operands K-major, so V cannot be
//     B as it lies: the product is transposed, O^T = V^T P^T, with the V
//     tile the register A operand (loaded from its raw atoms and split, a
//     64-row slab of D at a time, m64n64k8) and P the B operand, so no tile
//     is copied transposed. O^T's columns are the query rows, held by other
//     threads than the S rows: the running max's factors reach them through
//     shared memory (two buffers, one barrier of the warpgroup a tile).
//   S is summed an atom at a time from zero and added in f32 (summed over
//   all of d in the wgmma accumulator, O's error came close to the f32
//   tolerance at D = 256), O^T in its accumulator
//   (a part beside it spilled at D = 256). At the end consumer 1's state
//   (O^T, the rows' max and sums) is merged into consumer 0's through
//   shared memory, each rescaled to the larger max, in that order (the
//   maxes and sums stay in shared memory, so the merge holds only O^T in
//   registers). Where BH
//   x ceil(Sq / 64) blocks would leave half of the card's SMs or more idle
//   (the serving shape and ControlNet's sampler: 64 blocks), two blocks of
//   a cluster share a row block's key tiles (the first half, the second),
//   and the second's merged state joins the first's through distributed
//   shared memory (mapa) between two cluster barriers; so at these widths a
//   row's bits depend on the split (not on any run: every merge is in a
//   fixed order, no atomics), unlike the D = 64 rows. Registers: O^T 2 or 4
//   m64n64 slabs (64 or 128 a thread), S and an atom's part 16 each, two
//   k-steps' hi and lo A fragments 16; setmaxnreg 232 / 40 (at 224 / 56,
//   ts's shares, ptxas spilled the running-max contracts at D = 256: it
//   keeps the loop-invariant descriptors of the P buffers and the lanes'
//   shared-memory offsets in registers beside O^T and the factors that
//   rescale it).
// - kRouteMma, every other case: the mma.sync bodies below (bf16 at D = 32
//   and 128, f32 and upcast at D = 32 and 64; those at bf16 D = 64 and 256
//   in the exp2 contracts and at f32 D = 128 and 256 are not built).
//
// What the mma.sync design does about it (the FlashAttention-2 register
// reuse, as the probes): a warp owns 16-row fragments of q, and the warps
// of a block loop over key tiles staged in shared memory by cp.async two
// deep, so the next tile's copy runs under this tile's products; the TPU's
// sequential innermost grid axis becomes that loop.
// - bf16: both products with mma.sync m16n8k16 (bf16 operands, f32
//   accumulation). Two fragments a warp at D = 32 (128-row blocks), so each
//   K/V fragment read from shared memory feeds two products; one at D =
//   128. Q fragments stay in registers for the whole loop. K fragments by
//   ldmatrix, V fragments by ldmatrix.trans, rows
//   padded to D + 8 bf16 so the eight rows an ldmatrix reads fall in
//   distinct banks. The S accumulator, rounded to bf16 pairs, is the A
//   operand of the PV product without a trip through shared memory. At
//   D % 128 != 0 l comes from one more n8 product against a tile of ones
//   (exactly JAX's ones column); at D % 128 == 0 each thread sums its
//   unrounded p and a quad shuffle finishes the rows.
// - f32: mma.sync m16n8k8 TF32 as 3xTF32. A block of 8 warps holds 32
//   query rows; warp w takes row group w / 4 and a quarter (slice w % 4) of
//   every key tile, so few query rows still give each SM sub-partition two
//   warps; without a running max the slices' partial O and l simply add, in slice
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

#include "async_sm90.cuh"
#include "flash_contract.cuh"

namespace {

constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 (1, 1)

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// p of a score (a masked score is -inf, so 0): kNoMax, exp2 of the score
// clamped at 80; the running-max contracts, exp of the score already offset
// by the row's max
template <int K>
__device__ __forceinline__ float prob(float s) {
  if constexpr (K == kNoMax) {
    return exp2f(fminf(s, 80.f));
  } else {
    return softmax_exp<K>(s);
  }
}

// The lse of a row from its row sum (already at least 1e-30) and, under the
// running-max contracts, its max m: lse_mul * log2(l) (kNoMax), lse_mul *
// (m + log2(l)) (kRunningMax), m + log(l) (kUpcast)
template <int K>
__device__ __forceinline__ float row_lse(float l, float m, float lse_mul) {
  const float mo = m == -INFINITY ? 0.f : m;
  if constexpr (K == kNoMax) {
    return log2f(l) * lse_mul;
  } else if constexpr (K == kRunningMax) {
    return (mo + log2f(l)) * lse_mul;
  } else {
    return mo + logf(l);
  }
}

// Under the running-max contracts, advance the running max m[h] of rows g
// (h = 0) and g + 8 (h = 1) by a tile's scores (C fragments of `KeyTiles` n8
// tiles), rescale the rows' O accumulators (`DTiles` n8 tiles) and l parts,
// and offset the scores by the max
template <int K, int KeyTiles, int DTiles>
__device__ __forceinline__ void online_max(float (&s)[KeyTiles][4], float (&acc)[DTiles][4],
                                           float (&l)[2], float (&m)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < KeyTiles; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
    float alpha;
    const float offset = advance_max<K>(m[h], quad_max(mx), alpha);
    l[h] *= alpha;
#pragma unroll
    for (int nt = 0; nt < DTiles; ++nt) {
      acc[nt][2 * h] *= alpha;
      acc[nt][2 * h + 1] *= alpha;
    }
#pragma unroll
    for (int nt = 0; nt < KeyTiles; ++nt) {
      s[nt][2 * h] -= offset;
      s[nt][2 * h + 1] -= offset;
    }
  }
}

// Tile shapes of one instantiation.
template <typename T, int D>
struct Cfg;

// bf16 (D = 32 and 128): 4 warps, each owning kM 16-row fragments and
// every key of a tile.
template <int D>
struct Cfg<bf16, D> {
  static constexpr int kM = D <= 64 ? 2 : 1;  // 16-row q fragments a warp
  static constexpr int kThreads = 128;
  static constexpr int kBlockQ = 4 * 16 * kM;
  static constexpr int kBlockK = 64;  // keys a tile
  static constexpr int kLd = D + 8;  // shared-memory row stride in elements
  // the scaled Q tile and two stages of K and V tiles
  static constexpr size_t kSmem = sizeof(bf16) * (kBlockQ + 4 * kBlockK) * kLd;
};

// f32 (D = 32 and 64): 8 warps, 2 groups of 16 query rows x 4 slices of
// each key tile, so that few query rows still give each SM sub-partition
// two warps; the slices' partial sums add (under a running max, after each
// is rescaled to the slices' common max).
template <int D>
struct Cfg<float, D> {
  static constexpr int kRowGroups = 2;
  static constexpr int kKeySlices = 4;
  static constexpr int kThreads = 32 * kRowGroups * kKeySlices;
  static constexpr int kBlockQ = 16 * kRowGroups;
  static constexpr int kBlockK = 64;
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
template <int D, int K>
__global__ void __launch_bounds__(Cfg<bf16, D>::kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      int sq, int sk, int num_qb, int causal, float qscale, float lse_mul,
                      float sscale) {
  using C = Cfg<bf16, D>;
  constexpr int M = C::kM;
  constexpr int BK = C::kBlockK;
  constexpr int LD = C::kLd;
  constexpr int kDSteps = D / 16;      // k-steps of the QK product
  constexpr int kKeyTiles = BK / 8;    // n8 tiles of S
  constexpr int kKeySteps = BK / 16;   // k-steps of the PV product
  constexpr int kDTiles = D / 8;       // n8 tiles of O
  // l from a product against ones: the sum of the bf16-rounded p (kNoMax)
  constexpr bool kFoldL = K == kNoMax && D % 128 != 0;
  static_assert(kDSteps % 2 == 0, "K fragments are read two k-steps at a time");
  static_assert(K != kUpcast, "upcast runs the f32 kernel");
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

  // Q fragments, in registers for the whole key loop: fragment m, k-step
  // kk by ldmatrix.x4 of rows (mi & 1) * 8 + (lane & 7), columns 16 kk +
  // (mi >> 1) * 8
  const bf16* qa = sQ + (wr + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
  uint32_t qf[M][kDSteps][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) ldsm_x4(qf[m][kk], qa + m * 16 * LD + kk * 16);
  }

  float acc[M][kDTiles][4];
  float lmma[M][4];  // kFoldL: every column holds the row sums of rows g, g + 8
  float lpart[M][2];  // else: this thread's part of rows g, g + 8
  float mrow[M][2];  // the running max of rows g, g + 8 (kRunningMax)
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) lmma[m][e] = 0.f;
    lpart[m][0] = lpart[m][1] = 0.f;
    mrow[m][0] = mrow[m][1] = -INFINITY;
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
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
          uint32_t b[4];
          ldsm_x4(b, kbase + nt * 8 * LD + kk * 16);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            mma_bf16(s[m][nt], qf[m][kk], b[0], b[1]);
            mma_bf16(s[m][nt], qf[m][kk + 1], b[2], b[3]);
          }
        }
      }
      if (k0 + BK > sk || (causal && k0 + BK - 1 > wrow0)) {
#pragma unroll
        for (int m = 0; m < M; ++m) mask_scores(s[m], wrow0 + 16 * m + g, k0, sk, causal, t);
      }
      if constexpr (K != kNoMax) {
#pragma unroll
        for (int m = 0; m < M; ++m) online_max<K>(s[m], acc[m], lpart[m], mrow[m]);
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
            for (int e = 0; e < 4; ++e) p[h][e] = prob<K>(s[m][2 * js + h][e]);
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
      if (t == 0) lse[off] = row_lse<K>(ls, mrow[m][h], lse_mul);
    }
  }
}

// Grid as the bf16 kernel's. Warp w owns the 16 query rows of row group
// w / kKeySlices and, of each key tile, the kBlockK / kKeySlices keys of
// slice w % kKeySlices; at the end the slices' partial O and l are summed
// in slice order through shared memory (under the running-max contracts,
// each rescaled to the slices' common max first).
template <int D, int K>
__global__ void __launch_bounds__(Cfg<float, D>::kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int sq, int sk, int num_qb, int causal, float qscale, float lse_mul,
                     float sscale) {
  using C = Cfg<float, D>;
  constexpr int BK = C::kBlockK;
  constexpr int LD = C::kLd;
  constexpr int kSlices = C::kKeySlices;
  constexpr int KS = BK / kSlices;   // keys of a warp's slice of a tile
  constexpr int kDSteps = D / 8;     // k8 steps of the QK product
  constexpr int kKeyTiles = KS / 8;  // n8 tiles of S, each one k8 step of PV
  constexpr int kDTiles = D / 8;     // n8 tiles of O
  // a warp's partial O, l and m for the final sum: 4 kDTiles + 4 floats a lane
  constexpr int kPart = 32 * (4 * kDTiles + 4);
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
  float mrow[2] = {-INFINITY, -INFINITY};  // their running max (K != kNoMax)
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
      if constexpr (K == kUpcast) {  // the scale multiplies s after the product
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= sscale;
        }
      }
      if (s0 + KS > sk || (causal && s0 + KS - 1 > wrow0)) {
        mask_scores(s, wrow0 + g, s0, sk, causal, t);
      }
      if constexpr (K != kNoMax) online_max<K>(s, acc, lpart, mrow);

      // acc += p V in 3xTF32, one k8 step per S tile nt: its A operand
      // takes keys 2t, 2t + 1 as columns t, t + 4, so the B operand reads V
      // rows nt * 8 + 2t and + 1 at column 8 dn + g
      const float* vp = tV + 2 * t * LD + g;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = prob<K>(s[nt][e]);
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
    part[(4 * kDTiles + 2) * 32] = mrow[0];
    part[(4 * kDTiles + 3) * 32] = mrow[1];
  }
  __syncthreads();
  if (ks > 0) return;
#pragma unroll 1
  for (int sl = 1; sl < kSlices; ++sl) {
    const float* src = sK + ((sl - 1) * C::kRowGroups + rg) * kPart + lane;
    // the two sides' factors: 1 and 1 without a running max, else each
    // side rescaled to the larger max of the two
    float a_own[2] = {1.f, 1.f}, a_src[2] = {1.f, 1.f};
    if constexpr (K != kNoMax) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_src = src[(4 * kDTiles + 2 + h) * 32];
        const float offset = advance_max<K>(mrow[h], m_src, a_own[h]);
        a_src[h] = softmax_exp<K>(m_src - offset);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[nt][e] = acc[nt][e] * a_own[e >> 1] + src[(4 * nt + e) * 32] * a_src[e >> 1];
      }
    }
    lpart[0] = lpart[0] * a_own[0] + src[4 * kDTiles * 32] * a_src[0];
    lpart[1] = lpart[1] * a_own[1] + src[(4 * kDTiles + 1) * 32] * a_src[1];
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
    if (t == 0) lse[off] = row_lse<K>(ls, mrow[h], lse_mul);
  }
}

// ---- the wgmma body (kRouteWgmma): bf16, D = 64, the exp2 contracts ----

namespace wg {

constexpr int kD = 64;                        // head width: one 128-byte swizzle row
constexpr int kRows = 64;                     // query rows of a consumer warpgroup (wgmma's M)
constexpr int kBlockK = 128;                  // keys of a ring stage
constexpr int kStages = 4;                    // the K/V ring
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kQBytes = kRows * kD * 2;       // 8 KB
constexpr int kTileBytes = kBlockK * kD * 2;  // 16 KB: a K or V stage
constexpr int kDSteps = kD / 16;              // k-steps of the QK product
constexpr int kPvSteps = kBlockK / 16;        // k-steps of the PV product in a tile
constexpr int kORegs = kD / 2;                // accumulator floats of O (m64n64)
constexpr int kSRegs = kBlockK / 2;           // accumulator floats of S (m64n128)
constexpr int kOnesBytes = 256;               // a k16 x n8 B operand of ones

// Dynamic shared memory of a block of C consumer warpgroups, from a
// 1024-byte-aligned base: the Q tiles, the K and V stages, the mbarriers
// (q_full[C], k_full[kStages], v_full[kStages], empty[kStages]), the ones of
// the kNoMax row-sum product
template <int C>
struct Smem {
  static constexpr int kThreads = C * 128 + 128;  // + the producer warpgroup
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + C * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kOnes = kBars + 128;
  static_assert(8 * (C + 3 * kStages) <= 128, "barriers overlap the ones");
  static constexpr int kBytes = kOnes + kOnesBytes + 1024;  // + alignment
};

template <int C>
struct Ring {
  using S = Smem<C>;
  unsigned char* base;  // 1024-byte aligned
  uint64_t* bars;

  __device__ unsigned char* q(int w) const { return base + S::kQ + w * kQBytes; }
  __device__ unsigned char* k(int st) const { return base + S::kK + st * kTileBytes; }
  __device__ unsigned char* v(int st) const { return base + S::kV + st * kTileBytes; }
  __device__ uint64_t* q_full(int w) const { return bars + w; }
  __device__ uint64_t* k_full(int st) const { return bars + C + st; }
  __device__ uint64_t* v_full(int st) const { return bars + C + kStages + st; }
  __device__ uint64_t* empty(int st) const { return bars + C + 2 * kStages + st; }
  // B of the row-sum product: all ones, so its layout is moot
  __device__ uint64_t ones_desc() const {
    return wgmma_desc_plain(smem_addr(base + S::kOnes), 128, 128);
  }
};

// the ring in this block's dynamic shared memory, its barriers initialised
// and its ones written (the one __syncthreads of the kernel: the roles split
// after it)
template <int C>
__device__ __forceinline__ Ring<C> make_ring(unsigned char* raw) {
  Ring<C> r;
  r.base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  r.bars = reinterpret_cast<uint64_t*>(r.base + Smem<C>::kBars);
  if (threadIdx.x < kOnesBytes / 4) {
    reinterpret_cast<uint32_t*>(r.base + Smem<C>::kOnes)[threadIdx.x] = kOnes;
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int w = 0; w < C; ++w) mbar_init(r.q_full(w));
    for (int st = 0; st < kStages; ++st) {
      mbar_init(r.k_full(st));
      mbar_init(r.v_full(st));
      mbar_init(r.empty(st), 4 * C);  // every consumer warp releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The consumer's Q tile (kBytes) times qscale, rounded to bf16, in place
// (every element alike, so the swizzle is moot), then made visible to its
// wgmmas: the rounded prescale of load_q_bf16
template <int kBytes = kQBytes>
__device__ __forceinline__ void scale_q(unsigned char* tile, float qscale, int w) {
  uint4* chunks = reinterpret_cast<uint4*>(tile) + threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < kBytes / 16; i += 128) {
    uint4 raw = chunks[i];
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
    chunks[i] = raw;
  }
  fence_proxy_async();
  named_sync(1 + w, 128);
}

// s = q k^T over one K stage: kDSteps wgmmas m64n128k16, both operands
// K-major from shared memory (s overwritten)
__device__ __forceinline__ void qk_products(float (&s)[kSRegs], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    wgmma_ss<kBlockK>(s, wgmma_desc_add(q_desc, 32 * kk), wgmma_desc_add(k_desc, 32 * kk), kk > 0);
  }
}

// acc += p V over one V stage (V MN-major) and, under kNoMax, l += p 1
// against the ones (every column of l holds a row sum: l[0] of row g, l[2]
// of row g + 8)
template <int K>
__device__ __forceinline__ void pv_products(float (&acc)[kORegs], float (&l)[4],
                                            const uint32_t (&p)[kPvSteps][4], uint64_t v_desc,
                                            uint64_t ones_desc) {
#pragma unroll
  for (int js = 0; js < kPvSteps; ++js) {
    wgmma_rs_n64<true>(acc, p[js], wgmma_desc_add(v_desc, 2048 * js), 1);
    if constexpr (K == kNoMax) wgmma_rs<8>(l, p[js], ones_desc);
  }
}

// The softmax of one tile's scores s (this thread's rows row and row + 8 of
// the warpgroup, 32 keys each, from key0) into the PV A fragments p (bf16
// pairs). kMasked: keys past sk, and under the causal mask keys past the
// row, get p = 0. kNoMax: p = exp2(min(s, 80)). kRunningMax: the rows' max
// m and their unrounded sums l (this thread's parts) move on, p = exp2(s -
// m), and acc is rescaled to the new max.
template <int K, bool kMasked>
__device__ __forceinline__ void tile_probs(const float (&s)[kSRegs], uint32_t (&p)[kPvSteps][4],
                                           float (&acc)[kORegs], float (&m)[2], float (&l)[2],
                                           int row, int key0, int sk, int causal) {
  const int t = threadIdx.x % 4;
  auto live = [&](int i) {  // element i: row + 8 ((i / 2) & 1), key key0 + 8 (i / 4) + 2t + i % 2
    const int key = key0 + 8 * (i / 4) + 2 * t + (i & 1);
    return !kMasked || (key < sk && (!causal || key <= row + 8 * ((i >> 1) & 1)));
  };
  if constexpr (K == kNoMax) {
#pragma unroll
    for (int js = 0; js < kPvSteps; ++js) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * js + 2 * e;
        p[js][e] = pack_bf16(live(i) ? ex2(fminf(s[i], 80.f)) : 0.f,
                             live(i + 1) ? ex2(fminf(s[i + 1], 80.f)) : 0.f);
      }
    }
  } else {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) {
      if (live(i)) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float offset[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) offset[h] = advance_max<K>(m[h], quad_max(mx[h]), alpha[h]);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int js = 0; js < kPvSteps; ++js) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * js + 2 * e;
        const int h = e & 1;
        const float a = live(i) ? ex2(s[i] - offset[h]) : 0.f;
        const float b = live(i + 1) ? ex2(s[i + 1] - offset[h]) : 0.f;
        part[h] += a + b;
        p[js][e] = pack_bf16(a, b);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + part[h];
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      acc[4 * nb] *= alpha[0];
      acc[4 * nb + 1] *= alpha[0];
      acc[4 * nb + 2] *= alpha[1];
      acc[4 * nb + 3] *= alpha[1];
    }
  }
}

// tile_probs, masked where the warpgroup's tile (rows row0 .. row0 + 63,
// keys key0 .. key0 + 127) reaches past sk or across the causal diagonal (a
// uniform branch: no product of the warpgroup is in flight)
template <int K>
__device__ __forceinline__ void probs(const float (&s)[kSRegs], uint32_t (&p)[kPvSteps][4],
                                      float (&acc)[kORegs], float (&m)[2], float (&l)[2], int row,
                                      int row0, int key0, int sk, int causal) {
  if (key0 + kBlockK > sk || (causal && key0 + kBlockK - 1 > row0)) {
    tile_probs<K, true>(s, p, acc, m, l, row, key0, sk, causal);
  } else {
    tile_probs<K, false>(s, p, acc, m, l, row, key0, sk, causal);
  }
}

// A consumer warpgroup: its 64 query rows from row0 over every K, V tile.
// Tile j's PV product is issued with tile j + 1's QK product in one group,
// so a tile costs one wait; the softmax runs between the waits.
template <int K, int C>
__device__ __forceinline__ void consume(const Ring<C>& r, bf16* __restrict__ o,
                                        float* __restrict__ lse, int row0, int sq, int sk,
                                        int tiles, int causal, float qscale, float lse_mul) {
  const int w = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // this thread's rows row and row + 8 (C fragments)
  const int row = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  mbar_wait(r.q_full(w), 0);
  scale_q(r.q(w), qscale, w);
  const uint64_t q_desc = wgmma_desc_sw128(smem_addr(r.q(w)));
  const uint64_t ones_desc = r.ones_desc();
  float acc[kORegs], s[kSRegs];
  float lsum[4] = {0.f, 0.f, 0.f, 0.f};  // kNoMax: the ones product's row sums
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // kRunningMax
  uint32_t p[kPvSteps][4];
#pragma unroll
  for (int i = 0; i < kORegs; ++i) acc[i] = 0.f;

  // tiles >= 1: a launch has sk >= 1, and the causal mask leaves key 0
  mbar_wait(r.k_full(0), 0);
  wgmma_fence();
  qk_products(s, q_desc, wgmma_desc_sw128(smem_addr(r.k(0))));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
#pragma unroll 1
  for (int j = 0; j + 1 < tiles; ++j) {
    const int st = j % kStages;
    const int next = (j + 1) % kStages;
    probs<K>(s, p, acc, m, l, row, row0, j * kBlockK, sk, causal);
    mbar_wait(r.v_full(st), (j / kStages) & 1);
    mbar_wait(r.k_full(next), ((j + 1) / kStages) & 1);
    wgmma_fence();
    pv_products<K>(acc, lsum, p, wgmma_desc_sw128(smem_addr(r.v(st))), ones_desc);
    qk_products(s, q_desc, wgmma_desc_sw128(smem_addr(r.k(next))));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(lsum);
    reg_fence(s);
    reg_fence(p);
    warp_arrive(r.empty(st));
  }
  const int last = tiles - 1;
  const int st = last % kStages;
  probs<K>(s, p, acc, m, l, row, row0, last * kBlockK, sk, causal);
  mbar_wait(r.v_full(st), (last / kStages) & 1);
  wgmma_fence();
  pv_products<K>(acc, lsum, p, wgmma_desc_sw128(smem_addr(r.v(st))), ones_desc);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(lsum);
  reg_fence(p);
  warp_arrive(r.empty(st));

  const float rows_l[2] = {K == kNoMax ? lsum[0] : quad_sum(l[0]),
                           K == kNoMax ? lsum[2] : quad_sum(l[1])};
  const int t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r_h = row + 8 * h;
    if (r_h >= sq) continue;
    const float ls = fmaxf(rows_l[h], 1e-30f);
    bf16* orow = o + static_cast<size_t>(r_h) * kD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(orow + 8 * nb) =
          pack_bf16(acc[4 * nb + 2 * h] / ls, acc[4 * nb + 2 * h + 1] / ls);
    }
    if (t == 0) lse[r_h] = row_lse<K>(ls, m[h], lse_mul);
  }
}

}  // namespace wg

// Kernel 1 on the wgmma route. Grid: one block per (bh, C * 64 query rows),
// flattened into blockIdx.x; Smem<C>::kThreads threads and Smem<C>::kBytes of dynamic shared
// memory. Warpgroups 0 .. C - 1 consume, C produces: its first thread loads
// each consumer's Q tile once (a tile wholly past sq loads rows 0 .. 63: its
// warpgroup stores nothing), then the K and V tiles into the ring, a stage
// as soon as every consumer warp has released it (maps of (64, s, bh), rows
// past s read as 0).
template <int K, int C>
__global__ void __launch_bounds__(wg::Smem<C>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                       float* __restrict__ lse, int sq, int sk, int num_qb, int causal,
                       float qscale, float lse_mul) {
  static_assert(K != kUpcast, "the wgmma route runs the exp2 contracts");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const wg::Ring<C> r = wg::make_ring<C>(smem_raw);
  const int bh = blockIdx.x / num_qb;
  const int row0 = (blockIdx.x % num_qb) * C * wg::kRows;
  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, row0 + C * wg::kRows) : sk;
  const int tiles = (kv_end + wg::kBlockK - 1) / wg::kBlockK;
  if (threadIdx.x >= C * 128) {
    regs_lower<wg::kProducerRegs>();
    if (threadIdx.x != C * 128) return;
    for (int w = 0; w < C; ++w) {
      const int first = row0 + w * wg::kRows;
      mbar_expect(r.q_full(w), wg::kQBytes);
      tma_load_3d(r.q(w), &q_map, r.q_full(w), 0, first < sq ? first : 0, bh);
    }
    for (int j = 0; j < tiles; ++j) {
      const int st = j % wg::kStages;
      if (j >= wg::kStages) mbar_wait(r.empty(st), (j / wg::kStages - 1) & 1);
      mbar_expect(r.k_full(st), wg::kTileBytes);
      tma_load_3d(r.k(st), &k_map, r.k_full(st), 0, j * wg::kBlockK, bh);
      mbar_expect(r.v_full(st), wg::kTileBytes);
      tma_load_3d(r.v(st), &v_map, r.v_full(st), 0, j * wg::kBlockK, bh);
    }
  } else {
    regs_raise<wg::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sq;
    wg::consume<K, C>(r, o + head * wg::kD, lse + head, row0 + threadIdx.x / 128 * wg::kRows, sq,
                      sk, tiles, causal, qscale, lse_mul);
  }
}

// ---- the wgmma body at D = 256 (kRouteWgmma): bf16, the exp2 contracts ----

namespace wd {

constexpr int kD = 256;                        // head width: four 128-byte swizzle atoms a row
constexpr int kAtomCols = 64;                  // bf16 columns of an atom (one TMA box's width)
constexpr int kAtoms = kD / kAtomCols;
constexpr int kBlockK = 64;                    // keys of a ring stage
constexpr int kQBytes = wg::kRows * kD * 2;    // 32 KB: a consumer's Q tile
constexpr int kQAtom = wg::kRows * 128;        // 8 KB: an atom of it
constexpr int kTileBytes = kBlockK * kD * 2;   // 32 KB: a K or V stage
constexpr int kTileAtom = kBlockK * 128;       // 8 KB: an atom of it
constexpr int kDSteps = kD / 16;               // k-steps of S = Q K^T
constexpr int kPvSteps = kBlockK / 16;         // k-steps of O += P V in a tile
constexpr int kOChunk = 32;                    // accumulator floats of an m64n64 chunk of O
constexpr int kSRegs = kBlockK / 2;            // accumulator floats of S (m64n64)

// Dynamic shared memory of a block of C consumer warpgroups, from a
// 1024-byte-aligned base: the Q tiles, as many K and V stages as fit, the
// mbarriers (q_full[C], k_full[kStages], v_full[kStages], empty[kStages]);
// each tile as four atoms, one per 64-column TMA box, kQAtom or kTileAtom
// bytes apart
template <int C>
struct Smem {
  static constexpr int kThreads = C * 128 + 128;  // + the producer warpgroup
  static constexpr int kStages = (232448 - 1024 - 256 - C * kQBytes) / (2 * kTileBytes);
  static constexpr int kK = C * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (C + 3 * kStages) + 1024;  // + alignment
  static_assert(kStages >= 2 && kBytes <= 232448, "shared memory of one block");
};

template <int C>
struct Ring {
  using S = Smem<C>;
  unsigned char* base;  // 1024-byte aligned
  uint64_t* bars;

  __device__ unsigned char* q(int w) const { return base + w * kQBytes; }
  __device__ unsigned char* k(int st) const { return base + S::kK + st * kTileBytes; }
  __device__ unsigned char* v(int st) const { return base + S::kV + st * kTileBytes; }
  __device__ uint64_t* q_full(int w) const { return bars + w; }
  __device__ uint64_t* k_full(int st) const { return bars + C + st; }
  __device__ uint64_t* v_full(int st) const { return bars + C + S::kStages + st; }
  __device__ uint64_t* empty(int st) const { return bars + C + 2 * S::kStages + st; }
};

// the ring in this block's dynamic shared memory, its barriers initialised
// (the one __syncthreads of the kernel: the roles split after it)
template <int C>
__device__ __forceinline__ Ring<C> make_ring(unsigned char* raw) {
  Ring<C> r;
  r.base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  r.bars = reinterpret_cast<uint64_t*>(r.base + Smem<C>::kBars);
  if (threadIdx.x == 0) {
    for (int w = 0; w < C; ++w) mbar_init(r.q_full(w));
    for (int st = 0; st < Smem<C>::kStages; ++st) {
      mbar_init(r.k_full(st));
      mbar_init(r.v_full(st));
      mbar_init(r.empty(st), 4 * C);  // every consumer warp releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// s = q k^T over one K stage, from zero: kDSteps wgmmas m64n64k16, both
// operands K-major from shared memory, a k-step of 16 columns inside one
// atom (the k-steps step from atom to atom)
__device__ __forceinline__ void qk_products(float (&s)[kSRegs], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    const uint32_t at = 32 * (kk % 4);  // the k-step's 32 bytes in the atom's rows
    wgmma_ss<kBlockK>(s, desc_at(q_desc, kk / 4 * kQAtom + at),
                      desc_at(k_desc, kk / 4 * kTileAtom + at), kk > 0);
  }
}

// acc += p V over one V stage: per k-step, one wgmma m64n64k16 an atom of
// V (MN-major, so no descriptor spans atoms), each into its 64-column chunk
__device__ __forceinline__ void pv_products(float (&acc)[kAtoms][kOChunk],
                                            const uint32_t (&p)[kPvSteps][4], uint64_t v_desc) {
#pragma unroll
  for (int js = 0; js < kPvSteps; ++js) {
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      wgmma_rs_n64<true>(acc[a], p[js], desc_at(v_desc, a * kTileAtom + 2048 * js), 1);
    }
  }
}

// The softmax of one tile's scores s (this thread's rows row and row + 8 of
// the warpgroup, 64 keys each, from key0; wg::tile_probs's layout) into the
// PV A fragments p (bf16 pairs). kMasked: keys past sk, and under the
// causal mask keys past the row, get p = 0. The row sums l are this
// thread's parts of the f32 sums of the unrounded p, as the JAX kernel's
// row sum at D % 128 == 0 (no product against ones: that would sum the
// bf16-rounded p). kNoMax: p = exp2(min(s, 80)); kRunningMax: the rows' max
// m moves on, p = exp2(s - m), and l and acc are rescaled to the new max.
template <int K, bool kMasked>
__device__ __forceinline__ void tile_probs(const float (&s)[kSRegs], uint32_t (&p)[kPvSteps][4],
                                           float (&acc)[kAtoms][kOChunk], float (&m)[2],
                                           float (&l)[2], int row, int key0, int sk, int causal) {
  const int t = threadIdx.x % 4;
  auto live = [&](int i) {  // element i: row + 8 ((i / 2) & 1), key key0 + 8 (i / 4) + 2t + i % 2
    const int key = key0 + 8 * (i / 4) + 2 * t + (i & 1);
    return !kMasked || (key < sk && (!causal || key <= row + 8 * ((i >> 1) & 1)));
  };
  float offset[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  if constexpr (K != kNoMax) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) {
      if (live(i)) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) offset[h] = advance_max<K>(m[h], quad_max(mx[h]), alpha[h]);
  }
  auto prob_at = [&](int i, int h) {
    if constexpr (K == kNoMax) return live(i) ? wg::ex2(fminf(s[i], 80.f)) : 0.f;
    else return live(i) ? wg::ex2(s[i] - offset[h]) : 0.f;
  };
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int js = 0; js < kPvSteps; ++js) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * js + 2 * e;
      const int h = e & 1;
      const float a = prob_at(i, h);
      const float b = prob_at(i + 1, h);
      part[h] += a + b;
      p[js][e] = pack_bf16(a, b);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + part[h];
  if constexpr (K != kNoMax) {
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
      for (int nb = 0; nb < kOChunk / 4; ++nb) {
        acc[a][4 * nb] *= alpha[0];
        acc[a][4 * nb + 1] *= alpha[0];
        acc[a][4 * nb + 2] *= alpha[1];
        acc[a][4 * nb + 3] *= alpha[1];
      }
    }
  }
}

// tile_probs, masked where the warpgroup's tile (rows row0 .. row0 + 63,
// keys key0 .. key0 + 63) reaches past sk or across the causal diagonal (a
// uniform branch: no product of the warpgroup is in flight)
template <int K>
__device__ __forceinline__ void probs(const float (&s)[kSRegs], uint32_t (&p)[kPvSteps][4],
                                      float (&acc)[kAtoms][kOChunk], float (&m)[2], float (&l)[2],
                                      int row, int row0, int key0, int sk, int causal) {
  if (key0 + kBlockK > sk || (causal && key0 + kBlockK - 1 > row0)) {
    tile_probs<K, true>(s, p, acc, m, l, row, key0, sk, causal);
  } else {
    tile_probs<K, false>(s, p, acc, m, l, row, key0, sk, causal);
  }
}

// reg_fence of each 64-column chunk of O
__device__ __forceinline__ void fence_chunks(float (&acc)[kAtoms][kOChunk]) {
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) reg_fence(acc[a]);
}

// A consumer warpgroup: its 64 query rows from row0 over every K, V tile,
// in wg::consume's order (tile j's PV product issued with tile j + 1's QK
// product in one group, the softmax between the waits).
template <int K, int C>
__device__ __forceinline__ void consume(const Ring<C>& r, bf16* __restrict__ o,
                                        float* __restrict__ lse, int row0, int sq, int sk,
                                        int tiles, int causal, float qscale, float lse_mul) {
  constexpr int S = Smem<C>::kStages;
  const int w = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // this thread's rows row and row + 8 (C fragments)
  const int row = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  mbar_wait(r.q_full(w), 0);
  wg::scale_q<kQBytes>(r.q(w), qscale, w);
  const uint64_t q_desc = wgmma_desc_sw128(smem_addr(r.q(w)));
  auto desc = [](unsigned char* p) { return wgmma_desc_sw128(smem_addr(p)); };
  float acc[kAtoms][kOChunk], s[kSRegs];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t p[kPvSteps][4];
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
    for (int i = 0; i < kOChunk; ++i) acc[a][i] = 0.f;
  }

  // tiles >= 1: a launch has sk >= 1, and the causal mask leaves key 0
  mbar_wait(r.k_full(0), 0);
  wgmma_fence();
  qk_products(s, q_desc, desc(r.k(0)));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
#pragma unroll 1
  for (int j = 0; j + 1 < tiles; ++j) {
    const int st = j % S;
    const int next = (j + 1) % S;
    probs<K>(s, p, acc, m, l, row, row0, j * kBlockK, sk, causal);
    mbar_wait(r.v_full(st), (j / S) & 1);
    mbar_wait(r.k_full(next), ((j + 1) / S) & 1);
    wgmma_fence();
    pv_products(acc, p, desc(r.v(st)));
    qk_products(s, q_desc, desc(r.k(next)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_chunks(acc);
    reg_fence(s);
    reg_fence(p);
    warp_arrive(r.empty(st));
  }
  const int last = tiles - 1;
  const int st = last % S;
  probs<K>(s, p, acc, m, l, row, row0, last * kBlockK, sk, causal);
  mbar_wait(r.v_full(st), (last / S) & 1);
  wgmma_fence();
  pv_products(acc, p, desc(r.v(st)));
  wgmma_commit();
  wgmma_wait<0>();
  fence_chunks(acc);
  reg_fence(p);
  warp_arrive(r.empty(st));

  const int t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r_h = row + 8 * h;
    const float ls = fmaxf(quad_sum(l[h]), 1e-30f);
    if (r_h >= sq) continue;
    bf16* orow = o + static_cast<size_t>(r_h) * kD + 2 * t;
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
      for (int nb = 0; nb < kOChunk / 4; ++nb) {
        *reinterpret_cast<uint32_t*>(orow + kAtomCols * a + 8 * nb) =
            pack_bf16(acc[a][4 * nb + 2 * h] / ls, acc[a][4 * nb + 2 * h + 1] / ls);
      }
    }
    if (t == 0) lse[r_h] = row_lse<K>(ls, m[h], lse_mul);
  }
}

}  // namespace wd

// Kernel 1 on the wgmma route at D = 256. Grid: one block per (bh, C * 64
// query rows), flattened into blockIdx.x; wd::Smem<C>::kThreads threads and
// wd::Smem<C>::kBytes of dynamic shared memory. Warpgroups 0 .. C - 1
// consume, C produces: its first thread loads each consumer's Q tile once
// (a tile wholly past sq loads rows 0 .. 63: its warpgroup stores nothing),
// then the K and V tiles into the ring, each as four 64-column boxes (maps
// of (256, s, bh), rows past s read as 0).
template <int K, int C>
__global__ void __launch_bounds__(wd::Smem<C>::kThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int num_qb, int causal,
                      float qscale, float lse_mul) {
  static_assert(K != kUpcast, "the wgmma route runs the exp2 contracts");
  constexpr int S = wd::Smem<C>::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const wd::Ring<C> r = wd::make_ring<C>(smem_raw);
  const int bh = blockIdx.x / num_qb;
  const int row0 = (blockIdx.x % num_qb) * C * wg::kRows;
  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, row0 + C * wg::kRows) : sk;
  const int tiles = (kv_end + wd::kBlockK - 1) / wd::kBlockK;
  if (threadIdx.x >= C * 128) {
    regs_lower<wg::kProducerRegs>();
    if (threadIdx.x != C * 128) return;
    for (int w = 0; w < C; ++w) {
      const int first = row0 + w * wg::kRows;
      mbar_expect(r.q_full(w), wd::kQBytes);
      for (int a = 0; a < wd::kAtoms; ++a) {
        tma_load_3d(r.q(w) + a * wd::kQAtom, &q_map, r.q_full(w), a * wd::kAtomCols,
                    first < sq ? first : 0, bh);
      }
    }
    for (int j = 0; j < tiles; ++j) {
      const int st = j % S;
      if (j >= S) mbar_wait(r.empty(st), (j / S - 1) & 1);
      mbar_expect(r.k_full(st), wd::kTileBytes);
      for (int a = 0; a < wd::kAtoms; ++a) {
        tma_load_3d(r.k(st) + a * wd::kTileAtom, &k_map, r.k_full(st), a * wd::kAtomCols,
                    j * wd::kBlockK, bh);
      }
      mbar_expect(r.v_full(st), wd::kTileBytes);
      for (int a = 0; a < wd::kAtoms; ++a) {
        tma_load_3d(r.v(st) + a * wd::kTileAtom, &v_map, r.v_full(st), a * wd::kAtomCols,
                    j * wd::kBlockK, bh);
      }
    }
  } else {
    regs_raise<wg::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sq;
    wd::consume<K, C>(r, o + head * wd::kD, lse + head, row0 + threadIdx.x / 128 * wg::kRows, sq,
                      sk, tiles, causal, qscale, lse_mul);
  }
}

// ---- the TF32 body at D = 128 and 256 (kRouteTf32): f32, every contract ----

namespace ts {

constexpr int kAtomCols = 32;    // f32 columns of an atom: one 128-byte swizzle row, one TMA box
constexpr int kRows = 64;        // query rows of a block: S's M, O^T's N
constexpr int kTile = 32;        // keys of a tile
constexpr int kConsumers = 2;    // consumer warpgroups, each taking every other tile
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kConverterWarps = 3;                // the producer warpgroup's warps 1-3
constexpr int kConverterThreads = 32 * kConverterWarps;
// setmaxnreg's shares of the 168 registers a thread the launch holds: 2 x
// 128 x 232 + 128 x 40 = 64512 (the consumers at 224 spilled the
// running-max contracts at D = 256; the converters fit in 40 by splitting
// half of their pieces at a time)
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kAcc = 16;                    // accumulator floats of S (m64n32)
constexpr int kSlabAcc = 32;                // accumulator floats of a 64-row slab of O^T (m64n64)
constexpr int kSteps = kAtomCols / 8;       // k8 steps of an atom (or of a tile's 32 keys)
constexpr int kResAtom = kRows * 128;       // 8 KB: an atom of Q
constexpr int kTileAtom = kTile * 128;      // 4 KB: an atom of a K or V tile
constexpr int kStageBytes = 4 * kTileAtom;  // a stage: two K atoms and their lo parts, or four V atoms
constexpr int kBufBytes = kRows * 128;      // P's B operand, hi or lo: 64 query rows x 32 keys
constexpr int kSplits = 2;                  // blocks of a cluster that share a row block's keys
static_assert(kTile == kAtomCols, "a row of a P buffer is one 128-byte swizzle row");

// Dynamic shared memory from a 1024-byte-aligned base, for kAtoms = D / 32
// atoms a row: Q (64 rows, raw f32 as TMA wrote it, atom a at a kResAtom),
// each consumer's P buffers (TF32 hi, lo: 64 rows of 32 positions), the
// rows' numbers (each consumer's rescale factors in two buffers, its row
// max and sum, and the block's merged max and sum for its cluster peer: 640
// floats), the ring (as many stages as the rest leaves room for), then its
// full, ready and empty barriers and Q's. kLoads is the stages of a tile:
// kAtoms / 2 of K for S (two atoms a stage, then their lo parts), then
// kAtoms / 4 of V for O^T (two 64-row slabs of D, four raw atoms, a stage)
template <int kAtoms>
struct Layout {
  static constexpr int kAtomsN = kAtoms;
  static constexpr int kSlabs = kAtoms / 2;  // m64 slabs of D in O^T
  static constexpr int kKLoads = kAtoms / 2;
  static constexpr int kLoads = kKLoads + kSlabs / 2;
  static constexpr int kResBytes = kAtoms * kResAtom;
  static constexpr int kBufAt = kResBytes;
  static constexpr int kRowsAt = kBufAt + kConsumers * 2 * kBufBytes;
  static constexpr int kRingAt = kRowsAt + 3072;
  static constexpr int kStagesN = (232448 - 1024 - 256 - kRingAt) / kStageBytes;
  static constexpr int kBarsAt = kRingAt + kStagesN * kStageBytes;
  static constexpr int kBytes = kBarsAt + (3 * kStagesN + 1) * 8 + 1024;  // + alignment
  static_assert(kStagesN >= kLoads && kBytes <= 232448, "shared memory of one block");
  static_assert(kStagesN * kStageBytes >= kSlabs * kSlabAcc * 128 * 4,
                "a consumer's O^T fits in the ring");
};

template <class L>
struct Smem {
  unsigned char* base;  // 1024-byte aligned
  uint64_t* bars;

  __device__ unsigned char* res(int a) const { return base + a * kResAtom; }
  // consumer c's P buffer, TF32 hi (o = 0) or lo (o = 1)
  __device__ unsigned char* buf(int c, int o) const {
    return base + L::kBufAt + (2 * c + o) * kBufBytes;
  }
  __device__ float* rows() const { return reinterpret_cast<float*>(base + L::kRowsAt); }
  // consumer c's rescale factors of a tile, in buffer b (its tiles alternate)
  __device__ float* alpha(int c, int b) const { return rows() + 64 * (2 * c + b); }
  // consumer c's row max and row sum after its last tile
  __device__ float* row_m(int c) const { return rows() + 256 + 64 * c; }
  __device__ float* row_l(int c) const { return rows() + 384 + 64 * c; }
  // the row max and sum of the block's merged state (its cluster's block 0
  // reads block 1's)
  __device__ float* merged_m() const { return rows() + 512; }
  __device__ float* merged_l() const { return rows() + 576; }
  // a consumer's O^T for a merge (the ring is free by then)
  __device__ float* dump() const { return reinterpret_cast<float*>(base + L::kRingAt); }
  __device__ unsigned char* stage(int st) const { return base + L::kRingAt + st * kStageBytes; }
  // a stage's raw atoms are in (TMA), split (converters), free again (its consumer)
  __device__ uint64_t* full(int st) const { return bars + st; }
  __device__ uint64_t* ready(int st) const { return bars + L::kStagesN + st; }
  __device__ uint64_t* empty(int st) const { return bars + 2 * L::kStagesN + st; }
  __device__ uint64_t* res_full() const { return bars + 3 * L::kStagesN; }
};

// the layout in this block's dynamic shared memory, its barriers
// initialised (the one __syncthreads of the kernel: the roles split after it)
template <class L>
__device__ __forceinline__ Smem<L> make_smem(unsigned char* raw) {
  Smem<L> m;
  m.base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  m.bars = reinterpret_cast<uint64_t*>(m.base + L::kBarsAt);
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStagesN; ++st) {
      mbar_init(m.full(st));
      mbar_init(m.ready(st), kConverterWarps);
      mbar_init(m.empty(st), 4);  // the warps of the consumer whose tile the stage holds
    }
    mbar_init(m.res_full());
    mbar_fence_init();
  }
  __syncthreads();
  return m;
}

// The producer warpgroup's first thread: the block's Q rows (box 32
// columns x 64 rows from row0) once, then the kLoads stages of each of the
// block's tiles (keys key0 + j kTile; box 32 columns x 32 keys): atoms 2l,
// 2l + 1 of K, then atoms 4u .. 4u + 3 of V; rows past the tensor's read as 0
template <class L>
__device__ __forceinline__ void produce(const Smem<L>& m, const CUtensorMap* q,
                                        const CUtensorMap* k, const CUtensorMap* v, int bh,
                                        int row0, int key0, int tiles) {
  if (tiles == 0) return;
  mbar_expect(m.res_full(), L::kResBytes);
  for (int a = 0; a < L::kAtomsN; ++a) {
    tma_load_3d(m.res(a), q, m.res_full(), a * kAtomCols, row0, bh);
  }
  int g = 0;  // loads so far
  for (int j = 0; j < tiles; ++j) {
    const int row = key0 + j * kTile;
    for (int l = 0; l < L::kLoads; ++l, ++g) {
      const int st = g % L::kStagesN;
      if (g >= L::kStagesN) mbar_wait(m.empty(st), (g / L::kStagesN - 1) & 1);
      const bool kl = l < L::kKLoads;
      const int atoms = kl ? 2 : 4;
      const int a0 = kl ? 2 * l : 4 * (l - L::kKLoads);
      mbar_expect(m.full(st), atoms * kTileAtom);
      for (int i = 0; i < atoms; ++i) {
        tma_load_3d(m.stage(st) + i * kTileAtom, kl ? k : v, m.full(st), (a0 + i) * kAtomCols,
                    row, bh);
      }
    }
  }
}

// The converters (the producer warpgroup's warps 1-3): the TF32 split of
// each K stage as TMA lands it (hi over the raw atoms, lo after them: B
// operands of S); the V stages stay raw (A operands of O^T, split by the
// consumers as they load them)
template <class L>
__device__ __forceinline__ void convert(const Smem<L>& m, int tiles) {
  const int ct = threadIdx.x - kConsumerThreads - 32;
  constexpr int kPer = (2 * kTileAtom / 16 + kConverterThreads - 1) / kConverterThreads;
  int g = 0;
  for (int j = 0; j < tiles; ++j) {
    for (int l = 0; l < L::kLoads; ++l, ++g) {
      const int st = g % L::kStagesN;
      mbar_wait(m.full(st), (g / L::kStagesN) & 1);
      if (l < L::kKLoads) {
        // this thread's 16-byte pieces, half of them loaded before any of
        // those is split (all at once took more than the 40 registers)
        unsigned char* hi = m.stage(st);
#pragma unroll
        for (int i0 = 0; i0 < kPer; i0 += kPer / 2) {
          float4 x[kPer / 2];
#pragma unroll
          for (int i = 0; i < kPer / 2; ++i) {
            const int o = 16 * (ct + (i0 + i) * kConverterThreads);
            if (o < 2 * kTileAtom) x[i] = *reinterpret_cast<const float4*>(hi + o);
          }
#pragma unroll
          for (int i = 0; i < kPer / 2; ++i) {
            const int o = 16 * (ct + (i0 + i) * kConverterThreads);
            if (o < 2 * kTileAtom) {
              uint4 h, lo;
              split_tf32_bits(x[i].x, h.x, lo.x);
              split_tf32_bits(x[i].y, h.y, lo.y);
              split_tf32_bits(x[i].z, h.z, lo.z);
              split_tf32_bits(x[i].w, h.w, lo.w);
              *reinterpret_cast<uint4*>(hi + o) = h;
              *reinterpret_cast<uint4*>(hi + 2 * kTileAtom + o) = lo;
            }
          }
        }
        fence_proxy_async();
      }
      warp_arrive(m.ready(st));
    }
  }
}

// The probabilities of one tile from its S accumulator x (element 4i + 2h
// + e: the block's query row rw + 8h, key key0 + 8i + 2t + e; kUpcast's
// scale applied). kMasked: keys past sk, and under the causal mask keys
// past the row, get p = 0. kNoMax: p = exp2(min(s, 80)); the running-max
// contracts: the rows' max mr moves on, p = exp(s - mr) in the contract's
// domain, and the factors that rescale the rows' l and O go to `alpha`
// (O^T's columns are other threads'). lr: this thread's parts of the row
// sums of the unrounded p. p's TF32 hi and lo go to the P buffers `hi`,
// `lo` at (query row, position 8i + 4e + t), the k order in which the O^T
// products' A fragments read the V tile's keys, then are made visible to
// the wgmmas that read them. rw, t: this thread's S row in the block and
// its lane % 4.
template <int K, bool kMasked>
__device__ __forceinline__ void tile_probs(unsigned char* hi, unsigned char* lo, float* alpha,
                                           const float (&x)[kAcc], float (&mr)[2],
                                           float (&lr)[2], int rw, int t, int row0, int key0,
                                           int sk, int causal) {
  auto live = [&](int i) {
    const int key = key0 + 8 * (i / 4) + 2 * t + (i & 1);
    return !kMasked || (key < sk && (!causal || key <= row0 + rw + 8 * ((i >> 1) & 1)));
  };
  float offset[2] = {0.f, 0.f}, a[2] = {1.f, 1.f};
  if constexpr (K != kNoMax) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      if (live(i)) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) offset[h] = advance_max<K>(mr[h], quad_max(mx[h]), a[h]);
  }
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kAcc / 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 4 * i + 2 * h + e;
        const float p = live(n) ? prob<K>(x[n] - offset[h]) : 0.f;
        part[h] += p;
        uint32_t ph, pl;
        split_tf32_bits(p, ph, pl);
        const int at = swizzle128_f32(rw + 8 * h, 8 * i + 4 * e + t);
        *reinterpret_cast<uint32_t*>(hi + at) = ph;
        *reinterpret_cast<uint32_t*>(lo + at) = pl;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lr[h] = lr[h] * a[h] + part[h];
    if (K != kNoMax && t == 0) alpha[rw + 8 * h] = a[h];
  }
  fence_proxy_async();
}

// Consumer c of a block: tiles c, c + 2, ... of the block's `tiles` (keys
// from key0) over its 64 query rows (from row0). Per tile:
// - S = Q K^T over d, one atom at a time (two a K stage): A this thread's
//   fragments of Q's atom (rows rw + 8h, columns 8ks + t + 4e), loaded raw,
//   multiplied by qscale and split into TF32 hi and lo in registers; B the
//   stage's split atom; each atom's part from zero (m64n32k8: lo x hi, hi
//   x lo, hi x hi over two k-steps, then over the next two), added in f32;
// - tile_probs, then a barrier of the warpgroup (its P buffers and factors
//   are whole) and O^T's columns rescaled by the factors;
// - O^T += V^T P^T, transposed so that the streamed V tile is A (from
//   registers) and B is P, K-major as tile_probs wrote it: per V stage two
//   64-row slabs of D (m64n64k8, the same three chains two k-steps at a
//   time), each into its slab of O^T in the wgmma accumulator, as the
//   mma.sync f32 body's products add into its mma accumulators (a part
//   from zero beside O^T took 32 registers that D = 256 lacks: it spilled).
// The A fragments are loaded and split two k-steps at a time: all four
// k-steps' took registers the running-max contracts lack at D = 256.
// S is summed from zero an atom at a time: summed in the wgmma accumulator
// over all of d (the tensor cores do not round their sums to nearest), O's
// error against the plain version came close to the f32 tolerance at D =
// 256; O^T's parts made no such difference.
// Returns O^T in acc (element 4i + 2h + e of slab s: d = 64 s + 16 w + g +
// 8h, query row 8i + 2t + e of the block) and writes the row max and sum of
// its rows to row_m(c), row_l(c).
template <class L, int K>
__device__ __forceinline__ void consume(const Smem<L>& m, float (&acc)[L::kSlabs][kSlabAcc],
                                        int row0, int key0, int tiles, int sk, int causal,
                                        float qscale, float sscale) {
  constexpr int S = L::kStagesN;
  const int c = threadIdx.x / 128;
  const int w = threadIdx.x % 128 / 32;
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  const int rw = 16 * w + g;  // this thread's S rows rw and rw + 8, O^T rows (d) from it
  auto desc = [](const unsigned char* p) { return wgmma_desc_sw128(smem_addr(p)); };
#pragma unroll
  for (int s = 0; s < L::kSlabs; ++s) {
#pragma unroll
    for (int i = 0; i < kSlabAcc; ++i) acc[s][i] = 0.f;
  }
  float mr[2] = {-INFINITY, -INFINITY}, lr[2] = {0.f, 0.f};
  if (tiles > c) mbar_wait(m.res_full(), 0);
  const unsigned char* res = m.res(0) + rw * 128;
#pragma unroll 1
  for (int j = c, n = 0; j < tiles; j += kConsumers, ++n) {
    const int k0 = key0 + j * kTile;
    int gl = j * L::kLoads;  // the tile's first load
    float x[kAcc];
#pragma unroll 1
    for (int a = 0; a < L::kAtomsN; ++a) {
      const int ga = gl + a / 2;
      const int st = ga % S;
      const unsigned char* ra = res + a * kResAtom;
      const uint64_t bh = desc(m.stage(st) + (a % 2) * kTileAtom);
      const uint64_t bl = desc(m.stage(st) + (2 + a % 2) * kTileAtom);
      float part[kAcc];
#pragma unroll
      for (int kp = 0; kp < kSteps; kp += 2) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          const int ks = kp + kq;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = *reinterpret_cast<const float*>(ra + h * 1024 +
                                                              (((2 * ks + e) ^ g) << 4) + 4 * t);
              split_tf32_bits(v * qscale, ah[kq][2 * e + h], al[kq][2 * e + h]);
            }
          }
        }
        if (a % 2 == 0 && kp == 0) mbar_wait(m.ready(st), (ga / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          wgmma_tf32_rs_n32(part, al[kq], desc_at(bh, 32 * (kp + kq)), kp + kq > 0);
        }
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) wgmma_tf32_rs_n32(part, ah[kq], desc_at(bl, 32 * (kp + kq)), 1);
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) wgmma_tf32_rs_n32(part, ah[kq], desc_at(bh, 32 * (kp + kq)), 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(part);
        reg_fence(ah);
        reg_fence(al);
      }
      if (a % 2 == 1) warp_arrive(m.empty(st));
#pragma unroll
      for (int i = 0; i < kAcc; ++i) x[i] = a > 0 ? x[i] + part[i] : part[i];
    }
    gl += L::kKLoads;
    if constexpr (K == kUpcast) {  // the scale multiplies s after the product
#pragma unroll
      for (int i = 0; i < kAcc; ++i) x[i] *= sscale;
    }
    float* alpha = m.alpha(c, n & 1);
    if (k0 + kTile > sk || (causal && k0 + kTile - 1 > row0)) {
      // (opaque: without it ptxas spilled the running-max contracts at D = 256)
      tile_probs<K, true>(m.buf(c, 0), m.buf(c, 1), alpha, x, mr, lr, opaque(rw), opaque(t), row0,
                          k0, sk, causal);
    } else {
      tile_probs<K, false>(m.buf(c, 0), m.buf(c, 1), alpha, x, mr, lr, opaque(rw), opaque(t), row0,
                           k0, sk, causal);
    }
    named_sync(1 + c, 128);  // the consumer's P buffers and factors are whole
    if constexpr (K != kNoMax) {  // O^T's column 8i + 2t + e takes its row's factor
#pragma unroll
      for (int i = 0; i < kSlabAcc / 4; ++i) {
        const float2 f = *reinterpret_cast<const float2*>(alpha + 8 * i + 2 * t);
#pragma unroll
        for (int s = 0; s < L::kSlabs; ++s) {
          acc[s][4 * i] *= f.x;
          acc[s][4 * i + 1] *= f.y;
          acc[s][4 * i + 2] *= f.x;
          acc[s][4 * i + 3] *= f.y;
        }
      }
    }
    const uint64_t ph = desc(m.buf(c, 0));
    const uint64_t pl = desc(m.buf(c, 1));
#pragma unroll
    for (int u = 0; u < L::kSlabs / 2; ++u, ++gl) {
      const int st = gl % S;
      mbar_wait(m.ready(st), (gl / S) & 1);
      mbar_wait(m.full(st), (gl / S) & 1);
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        // A: slab 2u + sl's d (rows 16w + g + 8hh: column 16 (w % 2) + g +
        // 8hh of the stage's atom 2 sl + w / 2) x the tile's keys 8ks + 2t +
        // e (k positions t + 4e), two k-steps a group (all four took the
        // registers the running-max contracts lack at D = 256: spills)
        const unsigned char* at = m.stage(st) + (2 * sl + w / 2) * kTileAtom;
        float (&o)[kSlabAcc] = acc[2 * u + sl];
#pragma unroll
        for (int kp = 0; kp < kSteps; kp += 2) {
          uint32_t fh[2][4], fl[2][4];
#pragma unroll
          for (int kq = 0; kq < 2; ++kq) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = 8 * (kp + kq) + 2 * t + e;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int col = 16 * (w % 2) + g + 8 * hh;
                const float v = *reinterpret_cast<const float*>(
                    at + row * 128 + (((col / 4) ^ (row % 8)) << 4) + 4 * (col % 4));
                split_tf32_bits(v, fh[kq][2 * e + hh], fl[kq][2 * e + hh]);
              }
            }
          }
          wgmma_fence();
#pragma unroll
          for (int kq = 0; kq < 2; ++kq) wgmma_tf32_rs_n64(o, fl[kq], desc_at(ph, 32 * (kp + kq)), 1);
#pragma unroll
          for (int kq = 0; kq < 2; ++kq) wgmma_tf32_rs_n64(o, fh[kq], desc_at(pl, 32 * (kp + kq)), 1);
#pragma unroll
          for (int kq = 0; kq < 2; ++kq) wgmma_tf32_rs_n64(o, fh[kq], desc_at(ph, 32 * (kp + kq)), 1);
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(o);
          reg_fence(fh);
          reg_fence(fl);
        }
      }
      warp_arrive(m.empty(st));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = quad_sum(lr[h]);
    if (t == 0) {
      m.row_m(c)[rw + 8 * h] = mr[h];
      m.row_l(c)[rw + 8 * h] = l;
    }
  }
}

// Merge another state of the block's 64 rows into this thread's O^T (its
// columns 8i + 2t + e): the other's O^T at src (this thread's element (s,
// n) at (s kSlabAcc + n) * 128 + its index in the warpgroup), the two
// states' row max and sum at own_m, own_l and src_m, src_l; each side is
// rescaled to the larger max of the two (1 and 1 under kNoMax), the merge of
// the mma.sync f32 body's key slices in O^T's column space. The merged max
// and sum go to out_m, out_l (from the warpgroup's threads 0-3, which hold
// every column between them); the maxes and sums stay in shared memory, so
// that no register beyond O^T's is live across the merge.
template <class L, int K>
__device__ __forceinline__ void merge(float (&acc)[L::kSlabs][kSlabAcc], const float* src,
                                      const float* own_m, const float* own_l, const float* src_m,
                                      const float* src_l, float* out_m, float* out_l) {
  const int t = threadIdx.x % 4;
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 8 * i + 2 * t + e;
      float mq = own_m[q], a_own = 1.f, a_src = 1.f;
      if constexpr (K != kNoMax) {
        const float m_src = src_m[q];
        const float offset = advance_max<K>(mq, m_src, a_own);
        a_src = softmax_exp<K>(m_src - offset);
      }
#pragma unroll
      for (int s = 0; s < L::kSlabs; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 4 * i + 2 * h + e;
          acc[s][n] = acc[s][n] * a_own + src[(s * kSlabAcc + n) * 128 + tid] * a_src;
        }
      }
      if (tid < 4) {
        out_m[q] = mq;
        out_l[q] = own_l[q] * a_own + src_l[q] * a_src;
      }
    }
  }
}

// this thread's O^T columns, each divided by its row sum, as the rows of O
// from row0 (rows at or past sq not stored), and the rows' lse (from the
// warpgroup's threads 0-3); the rows' max and sum at rm, rl
template <class L, int K>
__device__ __forceinline__ void store_rows(const float (&acc)[L::kSlabs][kSlabAcc],
                                           const float* rm, const float* rl,
                                           float* __restrict__ o, float* __restrict__ lse,
                                           int row0, int sq, float lse_mul) {
  constexpr int kD = L::kAtomsN * kAtomCols;
  const int t = threadIdx.x % 4;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32;
  const int g = tid % 32 / 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 8 * i + 2 * t + e;
      if (row0 + q >= sq) continue;
      const float ls = fmaxf(rl[q], 1e-30f);
      float* dst = o + static_cast<size_t>(row0 + q) * kD + 16 * w + g;
#pragma unroll
      for (int s = 0; s < L::kSlabs; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) dst[64 * s + 8 * h] = acc[s][4 * i + 2 * h + e] / ls;
      }
      if (tid < 4) lse[row0 + q] = row_lse<K>(ls, rm[q], lse_mul);
    }
  }
}

}  // namespace ts

// Kernel 1 on the TF32 route at D = 32 kAtoms (128, 256). Grid: one block
// per (bh, 64 query rows), or, where those blocks would leave half of the
// card's SMs or more idle, a cluster of `splits` = 2 such blocks, each taking
// its share of the key tiles (blockIdx.x = splits * row block + rank),
// flattened into blockIdx.x; ts::kThreads threads, ts::Layout<kAtoms>::kBytes
// of dynamic shared memory. Warpgroups 0 and 1 consume (every other tile
// each); in warpgroup 2 the first thread loads by TMA the block's Q rows
// (map of (D, sq, bh), box 32 columns x 64 rows) and the K and V atoms
// (maps of (D, sk, bh), box 32 columns x 32 keys), and warps 1-3 convert.
// At the end consumer 1's state (O^T, the rows' max and sum) is merged into
// consumer 0's through shared memory, and in a cluster block 1's merged
// state into block 0's through distributed shared memory, each in a fixed
// order; block 0's consumer 0 then divides by l and stores O and the lse.
template <int kAtoms, int K>
__global__ void __launch_bounds__(ts::kThreads, 1)
flash_fwd_stream_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                        float* __restrict__ lse, int sq, int sk, int num_qb, int splits,
                        int causal, float qscale, float lse_mul, float sscale) {
  using L = ts::Layout<kAtoms>;
  constexpr int kD = kAtoms * ts::kAtomCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ts::Smem<L> m = ts::make_smem<L>(smem_raw);
  const int rank = blockIdx.x % splits;
  const int rb = blockIdx.x / splits;  // the row block
  const int bh = rb / num_qb;
  const int row0 = (rb % num_qb) * ts::kRows;
  // under the causal mask, keys past the block's last row are dead for every
  // row; the cluster's blocks take ceil(all / splits) tiles each, in rank order
  const int kv_end = causal ? min(sk, row0 + ts::kRows) : sk;
  const int all = (kv_end + ts::kTile - 1) / ts::kTile;
  const int share = (all + splits - 1) / splits;
  const int first = min(all, rank * share);
  const int tiles = min(all, first + share) - first;
  const int key0 = first * ts::kTile;
  if (threadIdx.x >= ts::kConsumerThreads) {
    regs_lower<ts::kProducerRegs>();
    const int pt = threadIdx.x - ts::kConsumerThreads;
    if (pt == 0) {
      ts::produce(m, &q_map, &k_map, &v_map, bh, row0, key0, tiles);
    } else if (pt >= 32) {
      ts::convert(m, tiles);
    }
    __syncwarp();
    if (splits > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  regs_raise<ts::kConsumerRegs>();
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  float acc[L::kSlabs][ts::kSlabAcc];
  ts::consume<L, K>(m, acc, row0, key0, tiles, sk, causal, qscale, sscale);
  named_sync(3, ts::kConsumerThreads);  // both consumers are done with the ring
  if (c == 1) {
#pragma unroll
    for (int s = 0; s < L::kSlabs; ++s) {
#pragma unroll
      for (int i = 0; i < ts::kSlabAcc; ++i) m.dump()[(s * ts::kSlabAcc + i) * 128 + tid] = acc[s][i];
    }
  }
  named_sync(3, ts::kConsumerThreads);
  if (c == 0) {
    ts::merge<L, K>(acc, m.dump(), m.row_m(0), m.row_l(0), m.row_m(1), m.row_l(1), m.merged_m(),
                    m.merged_l());
  }
  // the rows' max and sum of the state that is stored
  const float* rm = m.merged_m();
  const float* rl = m.merged_l();
  if (splits > 1) {
    if (rank == 1 && c == 0) {  // for block 0 (in place: each element's own thread)
#pragma unroll
      for (int s = 0; s < L::kSlabs; ++s) {
#pragma unroll
        for (int i = 0; i < ts::kSlabAcc; ++i) m.dump()[(s * ts::kSlabAcc + i) * 128 + tid] = acc[s][i];
      }
    }
    cluster_sync();
    if (rank == 0 && c == 0) {  // block 1's state, into the factors' buffers (free by now)
      ts::merge<L, K>(acc, cluster_peer(m.dump(), 1), m.merged_m(), m.merged_l(),
                      cluster_peer(m.merged_m(), 1), cluster_peer(m.merged_l(), 1),
                      m.alpha(0, 0), m.alpha(0, 1));
      rm = m.alpha(0, 0);
      rl = m.alpha(0, 1);
    }
    cluster_sync();  // block 1's shared memory outlives block 0's reads
  }
  if (rank != 0 || c != 0) return;
  named_sync(1, 128);  // the rows' max and sum are whole
  const size_t head = static_cast<size_t>(bh) * sq;
  ts::store_rows<L, K>(acc, rm, rl, o + head * kD, lse + head, row0, sq, lse_mul);
}

// The kernel of an input type and contract, chosen at compile time.
template <typename T, int D, int K>
struct KernelOf;
template <int D, int K>
struct KernelOf<bf16, D, K> {
  static constexpr auto fn = flash_fwd_bf16_kernel<D, K>;
};
template <int D, int K>
struct KernelOf<float, D, K> {
  static constexpr auto fn = flash_fwd_f32_kernel<D, K>;
};

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int bh, sq, sk, causal;
  float qscale, lse_mul, sscale;
  cudaStream_t stream;
};

template <typename T, int D, int K>
int launch(const Args& a) {
  using C = Cfg<T, D>;
  auto kernel = KernelOf<T, D, K>::fn;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_qb = (a.sq + C::kBlockQ - 1) / C::kBlockQ;
  kernel<<<num_qb * a.bh, C::kThreads, C::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<float*>(a.lse), a.sq, a.sk, num_qb, a.causal, a.qscale,
      a.lse_mul, a.sscale);
  return static_cast<int>(cudaGetLastError());
}

// the bodies of kernel 1 (ops/flash_attention.py::attention_route picks one)
enum Route : int { kRouteMma = 0, kRouteWgmma = 1, kRouteTf32 = 2 };

// bf16 at D = wg::kD and wd::kD in the exp2 contracts runs only the wgmma
// bodies, f32 at D = 128 and 256 only the TF32 body: those mma.sync
// instances are never built, and kRouteMma is refused there (as upcast on
// bf16, which the launcher casts to f32)
template <typename T, int D, int K>
constexpr bool kNoMmaSync = (sizeof(T) == 2 && (D == wg::kD || D == wd::kD || K == kUpcast)) ||
                            (sizeof(T) == 4 && D >= 128);

template <typename T, int D, int K>
int launch_mma(const Args& a) {
  if constexpr (kNoMmaSync<T, D, K>) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return launch<T, D, K>(a);
  }
}

template <typename T, int D>
int launch_contract(const Args& a, int contract) {
  switch (contract) {
    case kNoMax: return launch_mma<T, D, kNoMax>(a);
    case kRunningMax: return launch_mma<T, D, kRunningMax>(a);
    case kUpcast: return launch_mma<T, D, kUpcast>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_d(const Args& a, int d, int contract) {
  switch (d) {
    case 32: return launch_contract<T, 32>(a, contract);
    case 64: return launch_contract<T, 64>(a, contract);
    case 128: return launch_contract<T, 128>(a, contract);
    case 256: return launch_contract<T, 256>(a, contract);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The devices (bit d: device d < 64) on which the shared-memory attribute
// of a kernel of the wgmma or TF32 bodies is set, once a device: at the
// latent shape a launch takes ~0.035 ms on the card, so the host's work for
// it shows.
template <int D, int K, int C>
uint64_t attribute_set = 0;

template <int D, int K, int C, class F>
cudaError_t set_smem_attribute(F kernel, int bytes, int device) {
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (attribute_set<D, K, C> & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) attribute_set<D, K, C> |= bit;
  return err;
}

// the bf16 wgmma bodies at D (wg::kD or wd::kD), C consumer warpgroups a
// block: maps of (D, s, bh) with boxes of at most 64 columns (one 128-byte
// swizzle row) x a consumer's rows (Q) or a stage's keys (K, V)
template <int D, int K, int C>
int launch_wgmma_blocks(const Args& a, int device) {
  constexpr bool kWide = D == wd::kD;
  constexpr int kBox = kWide ? wd::kAtomCols : wg::kD;
  constexpr int kKeys = kWide ? wd::kBlockK : wg::kBlockK;
  constexpr int kThreads = kWide ? wd::Smem<C>::kThreads : wg::Smem<C>::kThreads;
  constexpr int kBytes = kWide ? wd::Smem<C>::kBytes : wg::Smem<C>::kBytes;
  const auto kernel = [] {
    if constexpr (kWide) return flash_fwd_wide_kernel<K, C>;
    else return flash_fwd_wgmma_kernel<K, C>;
  }();
  CUtensorMap maps[3];
  cudaError_t err = encode_head_rows_map(&maps[0], a.q, D, a.sq, a.bh, kBox, wg::kRows);
  if (err == cudaSuccess) err = encode_head_rows_map(&maps[1], a.k, D, a.sk, a.bh, kBox, kKeys);
  if (err == cudaSuccess) err = encode_head_rows_map(&maps[2], a.v, D, a.sk, a.bh, kBox, kKeys);
  if (err == cudaSuccess) err = set_smem_attribute<D, K, C>(kernel, kBytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_qb = (a.sq + C * wg::kRows - 1) / (C * wg::kRows);
  kernel<<<num_qb * a.bh, kThreads, kBytes, a.stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(a.o), static_cast<float*>(a.lse), a.sq, a.sk,
      num_qb, a.causal, a.qscale, a.lse_mul);
  return static_cast<int>(cudaGetLastError());
}

// The card's SMs, or 0 on an error
int sm_count(int device) {
  int sms = 0;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess
             ? sms : 0;
}

// 128-row blocks (two consumer warpgroups) unless they leave half of the
// card's SMs or more idle, then 64-row blocks (one), which still fit in one
// wave: a row is computed by one warpgroup over every key tile in the same
// order either way, so its bits do not depend on the choice. (64-row blocks
// in two waves were 1.65x slower than 128-row ones in one at the 3D shape's
// sequence-parallel rows, (2, 8192, 32768, 64): each block reads its head's
// K and V once, and one consumer gets no other's products under its softmax.)
template <int D, int K>
int launch_wgmma_rows(const Args& a, int device) {
  const int sms = sm_count(device);
  if (sms == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(a.bh) * ((a.sq + 2 * wg::kRows - 1) /
                                                           (2 * wg::kRows));
  return 2 * blocks <= sms ? launch_wgmma_blocks<D, K, 1>(a, device)
                           : launch_wgmma_blocks<D, K, 2>(a, device);
}

template <int D>
int launch_wgmma_d(const Args& a, int contract, int device) {
  switch (contract) {
    case kNoMax: return launch_wgmma_rows<D, kNoMax>(a, device);
    case kRunningMax: return launch_wgmma_rows<D, kRunningMax>(a, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_wgmma(const Args& a, int d, int dtype, int contract, int device) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case wg::kD: return launch_wgmma_d<wg::kD>(a, contract, device);
    case wd::kD: return launch_wgmma_d<wd::kD>(a, contract, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The TF32 body at D = 32 kAtoms: a cluster of ts::kSplits blocks a row
// block, each taking its share of the keys, where one block a row block
// leaves half of the card's SMs or more idle (the serving shape's 4096
// rows: 64 blocks on 132 SMs), else one block
template <int kAtoms, int K>
int launch_stream(const Args& a, int device) {
  using L = ts::Layout<kAtoms>;
  constexpr int kD = kAtoms * ts::kAtomCols;
  const auto kernel = flash_fwd_stream_kernel<kAtoms, K>;
  CUtensorMap maps[3];
  cudaError_t err = encode_f32_rows_map(&maps[0], a.q, kD, a.sq, a.bh, ts::kRows);
  if (err == cudaSuccess) err = encode_f32_rows_map(&maps[1], a.k, kD, a.sk, a.bh, ts::kTile);
  if (err == cudaSuccess) err = encode_f32_rows_map(&maps[2], a.v, kD, a.sk, a.bh, ts::kTile);
  if (err == cudaSuccess) err = set_smem_attribute<kD, K, 0>(kernel, L::kBytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(device);
  if (sms == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int num_qb = (a.sq + ts::kRows - 1) / ts::kRows;
  const long long blocks = static_cast<long long>(a.bh) * num_qb;
  const int splits = 2 * blocks <= sms ? ts::kSplits : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks * splits));
  cfg.blockDim = dim3(ts::kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], static_cast<float*>(a.o),
                           static_cast<float*>(a.lse), a.sq, a.sk, num_qb, splits, a.causal,
                           a.qscale, a.lse_mul, a.sscale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kAtoms>
int launch_stream_d(const Args& a, int contract, int device) {
  switch (contract) {
    case kNoMax: return launch_stream<kAtoms, kNoMax>(a, device);
    case kRunningMax: return launch_stream<kAtoms, kRunningMax>(a, device);
    case kUpcast: return launch_stream<kAtoms, kUpcast>(a, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_tf32(const Args& a, int d, int dtype, int contract, int device) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 128: return launch_stream_d<128 / ts::kAtomCols>(a, contract, device);
    case 256: return launch_stream_d<256 / ts::kAtomCols>(a, contract, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d) in one type (dtype 0 =
// f32, 1 = bf16), lse (bh, sq) f32; all contiguous and 16-byte aligned.
// contract is a Contract of flash_contract.cuh (kUpcast needs f32). qscale
// multiplies q (scale*log2(e) already rounded to the input type; 1 under
// kUpcast), sscale the scores after the product (kUpcast only: the softmax
// scale); lse_mul is ln2 for a natural-log lse, 1 for a log2 one (not read
// under kUpcast, whose lse is natural). route is a Route (ops/flash_attention.py
// ::attention_route): kRouteWgmma runs the bf16 wgmma bodies, which take d =
// 64 and 256 in the two exp2 contracts; kRouteTf32 the TF32 body, which takes
// f32 at d = 128 and 256 in every contract (a cluster of two blocks a row
// block where one block a row block would leave half of the SMs or more
// idle); kRouteMma the mma.sync bodies, which take every other type, width
// and contract; any other route, or a route on inputs it does not take,
// returns cudaErrorInvalidValue and launches nothing. What bounds each body,
// and its design, is in the head note above.
// Launches on `stream` of `device` and returns the first CUDA error of the
// tensor maps' encoding, the shared-memory attribute or the launch (0 on
// success).
extern "C" int gm_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int sq, int sk, int d, int dtype, int causal, int contract,
                            float qscale, float lse_mul, float sscale, int route, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q,      k,       v,      o, lse, bh, sq, sk, causal,
               qscale, lse_mul, sscale, static_cast<cudaStream_t>(stream)};
  if (route == kRouteWgmma) return launch_wgmma(a, d, dtype, contract, device);
  if (route == kRouteTf32) return launch_tf32(a, d, dtype, contract, device);
  if (route != kRouteMma) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_d<float>(a, d, contract);
  if (dtype == 1) return launch_d<bf16>(a, d, contract);
  return static_cast<int>(cudaErrorInvalidValue);
}
