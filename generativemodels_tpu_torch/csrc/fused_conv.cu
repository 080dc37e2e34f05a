// Fused GroupNorm-affine + SiLU -> 3x3x3 convolution -> bias [+ residual],
// for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel generativemodels_tpu/ops/fused_conv.py
// ::_kernel (called from _fused_impl). It computes
//
//     out = conv3x3x3(silu(x * scale + shift)) + bias [+ residual]
//
// with stride 1 and padding 1, x of shape (B, D, H, W, Cin), scale and shift
// (B, Cin) f32 (the folded GroupNorm affine), bias (Cout) f32, and an
// optional residual of the output's shape. As in the TPU kernel: the
// prologue normalises and applies SiLU in f32 and rounds the activation to
// x's type (bf16 or f32); taps that fall outside the volume are zero in the
// activation's domain (after SiLU), as the TPU kernel's zero padding and its
// `valid` mask of out-of-range depth taps are; products take the activation
// and the kernel in x's type and accumulate in f32; bias and residual are
// added in f32 before the one cast to x's type. With apply_act = 0 the
// prologue is the identity.
//
// x, residual and out are addressed through five strides each (b, d, h, w,
// c, in elements), so one kernel reads and writes both a contiguous
// channels-last tensor and a channels-first one seen through
// permute(0, 2, 3, 4, 1). The UNet passes its channels-first activations that
// way and gets a channels-first output: no layout copy on either side.
//
// What bounds it on this card. The 3D UNet's 22 launches a forward do
// 1.83e12 FLOP (2 * voxels * 27 * Cin * Cout) on ~3.2 GB of activations: at
// the tensor-core rate (989 TFLOP/s bf16) 1.85 ms, against ~1 ms to move the
// bytes, so by the card's peaks the work is bound by arithmetic at every
// level. What holds the kernel back is what feeds the products: at Cout = 32
// (the 128^3 level, two thirds of the time) a 128-voxel x 32-channel x
// 16-channel product is small beside the prologue of its input (a load, an
// affine, an exp and a reciprocal per input element and channel), the
// fragment reads and the block's barriers. In the 128^3 96 -> 32 call on an
// H100 at 700 W, taking out the products saves 42% of the time, the
// normalise pass 26%, the loads 6% (probes/conv_variants.py split).
//
// What the design does about it (bf16, the sampling path,
// fused_conv_mma_kernel): an implicit GEMM with M = output voxels, N = Cout,
// K = 27 * Cin. A block owns a 4 x 32 tile of output voxels, BN = 32 output
// channels and a run of R consecutive output depth planes d0 .. d0 + R - 1
// (R from ops/fused_conv.py::conv_tiles: the longest run of 4, 2, 1 whose
// grid still fills two waves of the card). For each chunk of 16 input
// channels it walks the input planes d0 - 1 .. d0 + R once each, an item a
// plane:
// - the raw halo of the item, 16 channels x 6 rows x 48 columns of the
//   channels-first tensor, comes in one TMA load (a 5-D tiled map over the
//   strided tensor, zero past its edges), three items ahead, into a ring of
//   three stages with an mbarrier each; where the strides do not allow a
//   map (channels-last, rows not 16-byte aligned) the threads load it
//   element by element;
// - one pass normalises it (shared to shared memory: affine, SiLU with the
//   fast exp and reciprocal, rounded to bf16, zero outside the volume) into
//   the [position][channel] layout the fragments want, the two 16-byte
//   halves of a position swapped every 4 positions against bank conflicts
//   and halo rows 40 positions apart, so that each lane's fragment address is
//   one base plus constants: each input element is normalised (R + 2) / R
//   times over the 204 / 128 halo, not 3 times;
// - between two barriers the block normalises item i + 1 and runs the
//   products of item i: each normalised plane feeds the (up to) three output
//   planes that read it, through depth taps 2, 1 and 0, so the R
//   accumulator tiles stay in registers for the whole run and every A
//   fragment (ldmatrix, one row address per voxel: a tap's shifted window
//   costs no copy) serves the three depth taps; the products are mma.sync
//   m16n8k16 with f32 accumulation, B fragments by ldmatrix (wgmma
//   m64n16k16 with A from the same registers was slower at 128^3: its N
//   is 16);
// - the kernel slice of a chunk, all 27 taps ([tap][n][k], swapped as the
//   planes are) and its 16 scales and shifts come by cp.async one chunk
//   ahead, double-buffered: the weights are read once per block;
// - the epilogue stages the R output planes in shared memory while one TMA
//   load brings the residual's box, then writes with consecutive threads on
//   consecutive addresses.
// Every output element belongs to one block and sums in a fixed order, so
// two launches agree to the bit.
//
// f32 (off the sampling path): fused_conv_f32_kernel, f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), 8 channels a chunk, one output plane a block;
// each thread owns one output column, kTH rows of it and BN / 8 channels,
// and reuses each halo value it reads for the three kh taps.

#include "async_sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 32;  // output columns per block: one per lane
constexpr int kCK = 8;   // input channels per staged chunk of the f32 kernel

struct Strides {
  long long b, d, h, w, c;
};

// ---- f32 on the CUDA cores ----------------------------------------------

// BN output channels a block, kTH output rows a block (32, 32 and 64
// accumulators a thread for BN 32, 64 and 128)
template <int BN>
struct Tile {
  static constexpr int kTH = BN == 32 ? 8 : 4;
  static constexpr int kTN = BN / kWarps;  // output channels a thread
  static constexpr int kHaloRows = kTH + 2;
  static constexpr int kHaloCols = kTW + 2;
  static constexpr int kHalo = kHaloRows * kHaloCols;
};

// Grid: x = h tiles * w tiles, y = B * D (output plane), z = Cout tiles.
template <int BN>
__global__ void __launch_bounds__(kThreads)
fused_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ bias, const void* __restrict__ residual,
                      float* __restrict__ out, int depth, int height, int width, int cin,
                      int cout, Strides xs, Strides rs, Strides os, int res_bf16,
                      int apply_act) {
  using Cfg = Tile<BN>;
  constexpr int kTH = Cfg::kTH;
  constexpr int kTN = Cfg::kTN;
  static_assert(kTN % 4 == 0, "a thread reads its kernel row as float4s");
  __shared__ __align__(16) float sA[kCK * Cfg::kHalo];  // [c][halo row][halo col]
  __shared__ __align__(16) float sW[9 * kCK * BN];      // [kh * 3 + kw][c][n]

  const int w_tiles = (width + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / w_tiles) * kTH;
  const int w0 = (blockIdx.x % w_tiles) * kTW;
  const int bi = blockIdx.y / depth;
  const int od = blockIdx.y % depth;
  const int n0 = blockIdx.z * BN;
  const int tx = threadIdx.x % 32;  // output column in the tile
  const int ty = threadIdx.x / 32;  // channel group: kTN channels from n0 + ty * kTN

  float acc[kTH][kTN];
#pragma unroll
  for (int r = 0; r < kTH; ++r) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[r][j] = 0.f;
  }

  const float* xb = x + bi * xs.b;
  for (int kd = 0; kd < 3; ++kd) {
    const int sd = od + kd - 1;
    if (sd < 0 || sd >= depth) continue;  // the tap reads zeros: no contribution
    const float* xp = xb + sd * xs.d;
    const float* wk = w + static_cast<size_t>(kd) * 9 * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += kCK) {
      __syncthreads();  // the previous chunk is fully consumed
      // the halo of this chunk, prologue applied, zero outside the volume
      for (int i = threadIdx.x; i < kCK * Cfg::kHalo; i += kThreads) {
        const int c = i / Cfg::kHalo;
        const int pos = i % Cfg::kHalo;
        const int hh = h0 + pos / Cfg::kHaloCols - 1;
        const int ww = w0 + pos % Cfg::kHaloCols - 1;
        const int cc = c0 + c;
        float v = 0.f;
        if (hh >= 0 && hh < height && ww >= 0 && ww < width && cc < cin) {
          v = xp[hh * xs.h + ww * xs.w + cc * xs.c];
          if (apply_act) {
            // x * scale + shift rounded twice, as the plain version computes it
            v = __fadd_rn(__fmul_rn(v, scale[bi * cin + cc]), shift[bi * cin + cc]);
            v = v / (1.f + expf(-v));
          }
        }
        sA[i] = v;
      }
      // the kernel slice w[kd, kh, kw, c0 + c, n0 + n]
      for (int i = threadIdx.x; i < 9 * kCK * BN; i += kThreads) {
        const int n = i % BN;
        const int c = (i / BN) % kCK;
        const int tap = i / (BN * kCK);
        const int cc = c0 + c;
        const int nn = n0 + n;
        sW[i] = (cc < cin && nn < cout) ? wk[(static_cast<size_t>(tap) * cin + cc) * cout + nn]
                                        : 0.f;
      }
      __syncthreads();

      // (at BN = 128 one channel at a time: two would need more than the 128
      // registers ptxas gives it, and spill)
#pragma unroll (BN == 128 ? 1 : 2)
      for (int c = 0; c < kCK; ++c) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float a[Cfg::kHaloRows];
          const float* col = sA + c * Cfg::kHalo + tx + kw;
#pragma unroll
          for (int r = 0; r < Cfg::kHaloRows; ++r) a[r] = col[r * Cfg::kHaloCols];
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            const float* wrow = sW + ((kh * 3 + kw) * kCK + c) * BN + ty * kTN;
            float b[kTN];
#pragma unroll
            for (int j = 0; j < kTN; j += 4) {
              const float4 q = *reinterpret_cast<const float4*>(wrow + j);
              b[j] = q.x;
              b[j + 1] = q.y;
              b[j + 2] = q.z;
              b[j + 3] = q.w;
            }
#pragma unroll
            for (int r = 0; r < kTH; ++r) {
#pragma unroll
              for (int j = 0; j < kTN; ++j) acc[r][j] = fmaf(a[r + kh], b[j], acc[r][j]);
            }
          }
        }
      }
    }
  }

  // epilogue: + bias, + residual
  const int ow = w0 + tx;
  if (ow >= width) return;
  const long long roff = bi * rs.b + od * rs.d + ow * rs.w;
  const float* rf = residual != nullptr && !res_bf16
                        ? static_cast<const float*>(residual) + roff : nullptr;
  const bf16* rh = residual != nullptr && res_bf16
                       ? static_cast<const bf16*>(residual) + roff : nullptr;
  float* ob = out + bi * os.b + od * os.d + ow * os.w;
#pragma unroll
  for (int r = 0; r < kTH; ++r) {
    const int oh = h0 + r;
    if (oh >= height) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + ty * kTN + j;
      if (n >= cout) break;
      float v = acc[r][j] + bias[n];
      const long long ro = oh * rs.h + n * rs.c;
      if (rf != nullptr) v += rf[ro];
      if (rh != nullptr) v += __bfloat162float(rh[ro]);
      ob[oh * os.h + n * os.c] = v;
    }
  }
}

// ---- bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulation) ----

constexpr int kRows = 4;                         // output rows a block: one per warp row
constexpr int kBN = 32;                          // output channels a block
constexpr int kM = kRows * kTW;                  // 128 output voxels a plane
constexpr int kHaloRows = kRows + 2;             // 6
constexpr int kHaloCols = kTW + 2;               // 34
constexpr int kHalo = kHaloRows * kHaloCols;     // 204 halo positions
constexpr int kHaloPitch = 40;                   // positions a halo row takes in shared memory
constexpr int kChunk = 16;                       // input channels a chunk: one mma's K
constexpr int kRawCols = kTW + 16;               // columns w0 - 8 .. w0 + 39: 16-byte aligned
constexpr int kRawPlane = kHaloRows * kRawCols;  // one channel of the raw halo
constexpr int kRawElems = kChunk * kRawPlane;    // raw [channel][halo row][column]
constexpr int kRawStages = 3;                    // the staging ring of raw halos
constexpr int kAElems = kHaloRows * kHaloPitch * kChunk;  // normalised [position][channel]
constexpr int kTaps = 27;
constexpr int kStageLd = kM + 4;                 // f32 row of the epilogue's staging

// Offset of (row, k) in a [row][16] bf16 array whose two 16-byte halves swap
// every 4 rows: the 8 rows of an ldmatrix (any 8 consecutive rows) or of a
// 16-byte store by 8 threads then fall in 32 distinct banks. Adding a multiple
// of 8 rows keeps the swap, so a fragment's address is a per-lane base plus
// a constant: halo rows are kHaloPitch = 40 positions apart for that.
__device__ __forceinline__ int swz(int row, int k) {
  return row * kChunk + ((((k >> 3) ^ (row >> 2)) & 1) << 3) + (k & 7);
}

// f(Plane<p>{}) for the runtime p < N: code specialised to each input plane of a run
template <int P>
struct Plane {
  static constexpr int value = P;
};
template <int N, typename F>
__device__ __forceinline__ void with_plane(int p, F&& f) {
  if constexpr (N > 0) {
    if (p == N - 1) {
      f(Plane<N - 1>{});
      return;
    }
    with_plane<N - 1>(p, f);
  }
}

__host__ __device__ constexpr int w_elems() {
  return kTaps * kBN * kChunk;  // one chunk's kernel slice [tap][n][k]
}

// Shared memory: in the loop two kernel slices, the raw ring, two normalised
// planes and two chunks' scale and shift; in the epilogue the R accumulator
// planes (f32 [r][n][voxel]) and the residual's box (bf16 [n][r][row][col]);
// then the mbarriers of the ring stages and of the residual
__host__ __device__ constexpr size_t loop_bytes() {
  return sizeof(bf16) * (2 * w_elems() + kRawStages * kRawElems + 2 * kAElems)
         + sizeof(float) * 2 * 2 * kChunk;
}
template <int R>
__host__ __device__ constexpr size_t staging_bytes() {
  return sizeof(float) * R * kBN * kStageLd;
}
template <int R>
__host__ __device__ constexpr size_t barrier_offset() {
  constexpr size_t epilogue = staging_bytes<R>() + sizeof(bf16) * R * kBN * kM;
  return ((loop_bytes() > epilogue ? loop_bytes() : epilogue) + 7) / 8 * 8;
}
template <int R>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return barrier_offset<R>() + sizeof(uint64_t) * (kRawStages + 1);
}

// The same function as fused_conv_f32_kernel for bf16, with the products on
// the tensor cores. wt is the kernel transposed and padded, (3, 3, 3,
// cout_p, cin_p) contiguous with zeros past Cout and Cin (cout_p a multiple
// of kBN, cin_p of 16). 8 warps: warp (wm, wn) owns output row wm of the
// tile (two 16-voxel fragments) and kBN / 2 channels, in R accumulator tiles,
// one per output plane of the run; two blocks share an SM. `fast`: x is
// 16-byte aligned, its w stride is 1 and its other strides and W are
// multiples of 8 (the UNet's channels-first tensors), so the raw halo comes
// by TMA through x_map; `res_box`: the same holds for a bf16 residual, whose
// box comes by TMA through res_map.
// Grid: x = h tiles * w tiles, y = B * depth runs, z = Cout tiles.
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
fused_conv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ bias, const void* __restrict__ residual,
                      bf16* __restrict__ out, int depth, int height, int width, int cin,
                      int cin_p, int cout, Strides xs, Strides rs, Strides os, int res_bf16,
                      int apply_act, const __grid_constant__ CUtensorMap x_map, int fast,
                      const __grid_constant__ CUtensorMap res_map, int res_box) {
  constexpr int kNT = kBN / 16;  // 8-channel n-tiles a warp
  constexpr int kPlanes = R + 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];  // TMA boxes land 128-byte aligned
  bf16* sW = reinterpret_cast<bf16*>(smem_raw);  // 2 x [tap][n][k]
  bf16* sRaw = sW + 2 * w_elems();               // kRawStages x [c][halo row][column]
  bf16* sA = sRaw + kRawStages * kRawElems;      // 2 x [halo position][k]
  float* sScale = reinterpret_cast<float*>(sA + 2 * kAElems);  // 2 x [k]
  float* sShift = sScale + 2 * kChunk;                         // 2 x [k]
  // a ring stage's TMA load has landed; the residual's box has
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem_raw + barrier_offset<R>());
  uint64_t* res_full = raw_full + kRawStages;

  const int w_tiles = (width + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / w_tiles) * kRows;
  const int w0 = (blockIdx.x % w_tiles) * kTW;
  const int runs = (depth + R - 1) / R;
  const int bi = blockIdx.y / runs;
  const int d0 = (blockIdx.y % runs) * R;
  const int n0 = blockIdx.z * kBN;
  const int cout_p = gridDim.z * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp % kRows;
  const int wn = warp / kRows;
  const int chunks = cin_p / kChunk;
  const int items = chunks * kPlanes;
  const bf16* xb = x + bi * xs.b;

  // item = chunk * kPlanes + p: input plane d0 - 1 + p, channels chunk * 16 ..
  auto issue_raw = [&](int item, int stage) {
    const int sd = d0 - 1 + item % kPlanes;
    if (sd < 0 || sd >= depth) {  // a plane outside the volume: nothing to read
      if (fast && tid == 0) mbar_expect(&raw_full[stage], 0);  // the stage's phase moves on
      return;
    }
    const int c0 = item / kPlanes * kChunk;
    bf16* raw = sRaw + stage * kRawElems;
    if (fast) {
      // one TMA load of the [c][row][column] box, zero past the tensor's edges
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(&raw_full[stage], kRawElems * sizeof(bf16));
        tma_load_5d(raw, &x_map, &raw_full[stage], w0 - 8, h0 - 1, sd, c0, bi);
      }
    } else {
      // element by element, consecutive threads on consecutive addresses of x
      const bf16* xp = xb + sd * xs.d;
      const bool last = xs.c == 1;
#pragma unroll 1
      for (int e = tid; e < kChunk * kHalo; e += kThreads) {
        const int c = last ? e % kChunk : e / kHalo;
        const int pos = last ? e / kChunk : e % kHalo;
        const int hh = h0 - 1 + pos / kHaloCols;
        const int ww = w0 - 1 + pos % kHaloCols;
        bf16 v = __float2bfloat16(0.f);
        if (c0 + c < cin && hh >= 0 && hh < height && ww >= 0 && ww < width) {
          v = xp[(c0 + c) * xs.c + hh * xs.h + ww * xs.w];
        }
        raw[c * kRawPlane + (pos / kHaloCols) * kRawCols + pos % kHaloCols + 7] = v;
      }
    }
  };
  // the kernel slice and the affine of chunk `chunk` into buffer chunk % 2
  auto issue_chunk = [&](int chunk) {
    const int c0 = chunk * kChunk;
    bf16* dst = sW + (chunk & 1) * w_elems();
#pragma unroll 1
    for (int u = tid; u < kTaps * kBN * 2; u += kThreads) {
      const int row = u / 2;  // tap * kBN + n
      const int half = u % 2;
      const bf16* src = wt + (static_cast<size_t>(row / kBN) * cout_p + n0 + row % kBN) * cin_p
                        + c0 + 8 * half;
      cp_async16(dst + swz(row, 8 * half), src);
    }
    if (apply_act && tid < 2 * kChunk) {
      const int c = tid % kChunk;
      const bool valid = c0 + c < cin;
      const float* src = (tid < kChunk ? scale : shift) + (valid ? bi * cin + c0 + c : 0);
      cp_async4((tid < kChunk ? sScale : sShift) + (chunk & 1) * kChunk + c, src, valid);
    }
  };

  // per-lane shared addresses of the fragments: the swap of an A row depends
  // only on the lane and kw, of a B row only on the lane
  const uint32_t a_lane = smem_addr(sA);
  uint32_t a_kw[3];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    a_kw[kw] = 2 * swz(wm * kHaloPitch + kw + (lane & 15), (lane >> 4) * 8);
  }
  const uint32_t b_lane =
      smem_addr(sW) + 2 * swz(wn * (kBN / 2) + (lane & 7) + ((lane >> 4) << 3),
                              ((lane >> 3) & 1) * 8);

  float acc[R][2][kNT][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][i][j][e] = 0.f;
      }
    }
  }

  // the normalise pass of item `at` (input plane d0 - 1 + p of chunk `chunk`):
  // raw [c][row][column] in ring stage at % kRawStages -> [position][c] in
  // normalised plane at % 2, 8 channels a thread
  auto normalise = [&](int at, int chunk, int p) {
    const int sd = d0 - 1 + p;
    if (sd < 0 || sd >= depth) return;
    const bf16* raw = sRaw + at % kRawStages * kRawElems;
    if (fast) mbar_wait(&raw_full[at % kRawStages], at / kRawStages & 1);
    bf16* abuf = sA + (at & 1) * kAElems;
    const float* cs = sScale + (chunk & 1) * kChunk;
    const float* ch = sShift + (chunk & 1) * kChunk;
    const int c0 = chunk * kChunk;
#pragma unroll 1
    for (int it = tid; it < 2 * kHalo; it += kThreads) {
      const int half = it / kHalo;
      const int hr = it % kHalo / kHaloCols;
      const int hc = it % kHaloCols;
      const int hh = h0 - 1 + hr;
      const int ww = w0 - 1 + hc;
      const bool inside = hh >= 0 && hh < height && ww >= 0 && ww < width;
      const bf16* src = raw + half * 8 * kRawPlane + hr * kRawCols + hc + 7;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = half * 8 + e;
        float a = __bfloat162float(src[e * kRawPlane]);
        if (apply_act) {
          // x * scale + shift rounded twice, as the plain version computes it
          a = __fadd_rn(__fmul_rn(a, cs[k]), ch[k]);
          a = __fdividef(a, 1.f + __expf(-a));  // fast exp and reciprocal: rounded to bf16 next
        }
        v[e] = inside && c0 + k < cin ? a : 0.f;
      }
      uint4 packed;
      packed.x = pack_bf16(v[0], v[1]);
      packed.y = pack_bf16(v[2], v[3]);
      packed.z = pack_bf16(v[4], v[5]);
      packed.w = pack_bf16(v[6], v[7]);
      *reinterpret_cast<uint4*>(abuf + swz(hr * kHaloPitch + hc, 8 * half)) = packed;
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kRawStages; ++i) mbar_init(&raw_full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Items are issued kRawStages ahead, one cp.async group committed for each
  // (item i's as group i, most of them empty): the slice and affine of chunk
  // c + 1 ride in the group issued at chunk c's first item, chunk 0's in
  // group 0, so the wait for item i + 1's group covers its chunk's slice.
  // The raw halos come by TMA, a stage's landing told by its mbarrier (or,
  // without a map, by plain stores that the barrier makes visible). Between
  // two barriers the block normalises item i + 1 and runs the products of
  // item i, so one warp's prologue overlaps another's products.
  issue_raw(0, 0);
  issue_chunk(0);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kRawStages; ++i) {
    issue_raw(i, i);
    cp_async_commit();
  }
  cp_async_wait<kRawStages - 1>();
  __syncthreads();
  normalise(0, 0, 0);

  // products of input plane d0 - 1 + P into output planes d0 + r through
  // depth tap kd = P - r (an output plane past the volume's end is computed
  // and not stored)
  auto products = [&](auto plane, uint32_t a_item, uint32_t b_chunk) {
    constexpr int P = decltype(plane)::value;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tap = kh * 3 + kw;
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ldsm_x4(a[i], a_item + a_kw[kw] + (kh * kHaloPitch + i * 16) * kChunk * 2);
        }
        uint32_t b[3][kNT / 2][4];
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          if (P - kd < 0 || P - kd >= R) continue;
#pragma unroll
          for (int q = 0; q < kNT / 2; ++q) {
            ldsm_x4(b[kd][q], b_chunk + ((kd * 9 + tap) * kBN + q * 16) * kChunk * 2);
          }
        }
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const int r = P - kd;
          if (r < 0 || r >= R) continue;
#pragma unroll
          for (int q = 0; q < kNT / 2; ++q) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[r][i][2 * q], a[i], b[kd][q][0], b[kd][q][1]);
              mma_bf16(acc[r][i][2 * q + 1], a[i], b[kd][q][2], b[kd][q][3]);
            }
          }
        }
      }
    }
  };

#pragma unroll 1
  for (int item = 0; item < items; ++item) {
    const int chunk = item / kPlanes;
    const int p = item % kPlanes;
    cp_async_wait<kRawStages - 2>();  // the slice and affine of item + 1's chunk landed
    __syncthreads();  // ... for every thread; item's plane is normalised; the ring stage and
                      // the normalised plane written below are free
    {
      const int next = item + kRawStages;
      if (next < items) issue_raw(next, next % kRawStages);
      if (p == 0 && chunk + 1 < chunks) issue_chunk(chunk + 1);
      cp_async_commit();
    }
    if (item + 1 < items) normalise(item + 1, (item + 1) / kPlanes, (item + 1) % kPlanes);
    const int sd = d0 - 1 + p;
    if (sd < 0 || sd >= depth) continue;
    const uint32_t a_item = a_lane + (item & 1) * kAElems * 2;
    const uint32_t b_chunk = b_lane + (chunk & 1) * w_elems() * 2;
    with_plane<kPlanes>(p, [&](auto plane) { products(plane, a_item, b_chunk); });
  }

  // epilogue: the R accumulator planes through shared memory (all of it is
  // free now), then + bias, + residual, in f32; one cast; kBatch outputs a
  // thread at a time, their residual loads in flight together
  cp_async_wait<0>();
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem_raw);  // [r][n][voxel]
  const bf16* sRes = reinterpret_cast<const bf16*>(smem_raw + staging_bytes<R>());
  if (res_box && tid == 0) {
    // the residual of the block's outputs by one TMA load, while the
    // accumulators are staged
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(res_full, sizeof(bf16) * R * kBN * kM);
    tma_load_5d(smem_raw + staging_bytes<R>(), &res_map, res_full, w0, h0, d0, n0, bi);
  }
  {
    const int g = lane / 4;
    const int t = lane % 4;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = wm * kTW + i * 16 + g + 8 * (e / 2);
            const int n = wn * (kBN / 2) + j * 8 + 2 * t + e % 2;
            st[(r * kBN + n) * kStageLd + m] = acc[r][i][j][e];
          }
        }
      }
    }
  }
  __syncthreads();
  if (res_box) mbar_wait(res_full, 0);
  const bool last = os.c == 1;  // channels-last output: consecutive threads on channels
  // output element idx of the block: plane r, channel n, voxel (oh, ow); false past the edges
  auto place = [&](int idx, int& r, int& n, int& oh, int& ow) {
    r = idx / (kBN * kM);
    const int rem = idx % (kBN * kM);
    n = last ? rem % kBN : rem / kM;
    const int m = last ? rem / kBN : rem % kM;
    oh = h0 + m / kTW;
    ow = w0 + m % kTW;
    return d0 + r < depth && oh < height && ow < width && n0 + n < cout;
  };
  constexpr int kBatch = 8;
  static_assert(R * kBN * kM % (kThreads * kBatch) == 0, "whole batches");
#pragma unroll 1
  for (int base = tid; base < R * kBN * kM; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      int r, n, oh, ow;
      v[e] = 0.f;
      if (!place(base + e * kThreads, r, n, oh, ow)) continue;
      v[e] = st[(r * kBN + n) * kStageLd + (oh - h0) * kTW + ow - w0] + bias[n0 + n];
      if (res_box) {
        v[e] += __bfloat162float(sRes[((n * R + r) * kRows + oh - h0) * kTW + ow - w0]);
      } else if (residual != nullptr) {
        const long long ro =
            bi * rs.b + (d0 + r) * rs.d + oh * rs.h + ow * rs.w + (n0 + n) * rs.c;
        v[e] += res_bf16 ? __bfloat162float(static_cast<const bf16*>(residual)[ro])
                         : static_cast<const float*>(residual)[ro];
      }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      int r, n, oh, ow;
      if (!place(base + e * kThreads, r, n, oh, ow)) continue;
      out[bi * os.b + (d0 + r) * os.d + oh * os.h + ow * os.w + (n0 + n) * os.c] =
          __float2bfloat16(v[e]);
    }
  }
}

// The TMA map of a bf16 tensor seen as (W, H, D, C, B), W contiguous (the
// channels-first layout), with the box `box` in that order.
cudaError_t encode_map(CUtensorMap* map, const void* x, int b, int d, int h, int wd, int c,
                       const Strides& xs, const cuuint32_t (&box)[5]) {
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(wd), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(xs.h) * 2,
                                 static_cast<cuuint64_t>(xs.d) * 2,
                                 static_cast<cuuint64_t>(xs.c) * 2,
                                 static_cast<cuuint64_t>(xs.b) * 2};
  return encode_tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, x, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int R>
int launch_mma(const void* x, const void* w, const float* scale, const float* shift,
               const float* bias, const void* residual, void* out, int b, int d, int h, int wd,
               int cin, int cout, const Strides& xs, const Strides& rs, const Strides& os,
               int res_bf16, int apply_act, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<R>();
  auto kernel = fused_conv_mma_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w_tiles = (wd + kTW - 1) / kTW;
  const int h_tiles = (h + kRows - 1) / kRows;
  const dim3 grid(w_tiles * h_tiles, b * ((d + R - 1) / R), (cout + kBN - 1) / kBN);
  const int cin_p = (cin + kChunk - 1) / kChunk * kChunk;
  const int fast = reinterpret_cast<uintptr_t>(x) % 16 == 0 && xs.w == 1 && xs.h % 8 == 0
                   && xs.d % 8 == 0 && xs.c % 8 == 0 && xs.b % 8 == 0 && wd % 8 == 0;
  // x and a bf16 residual by TMA where their strides allow it (16-byte rows)
  CUtensorMap x_map{}, res_map{};
  if (fast) {
    err = encode_map(&x_map, x, b, d, h, wd, cin, xs, {kRawCols, kHaloRows, 1, kChunk, 1});
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int res_box = residual != nullptr && res_bf16
                      && reinterpret_cast<uintptr_t>(residual) % 16 == 0 && rs.w == 1
                      && rs.h % 8 == 0 && rs.d % 8 == 0 && rs.c % 8 == 0 && rs.b % 8 == 0
                      && wd % 8 == 0;
  if (res_box) {
    err = encode_map(&res_map, residual, b, d, h, wd, cout, rs, {kTW, kRows, R, kBN, 1});
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, shift, bias, residual,
      static_cast<bf16*>(out), d, h, wd, cin, cin_p, cout, xs, rs, os, res_bf16, apply_act,
      x_map, fast, res_map, res_box);
  return static_cast<int>(cudaGetLastError());
}

// the depth runs built, as ops/fused_conv.py::CONV_RUNS lists them
int launch_mma_run(int rd, const void* x, const void* w, const float* scale, const float* shift,
                   const float* bias, const void* residual, void* out, int b, int d, int h,
                   int wd, int cin, int cout, const Strides& xs, const Strides& rs,
                   const Strides& os, int res_bf16, int apply_act, cudaStream_t stream) {
  switch (rd) {
    case 1:
      return launch_mma<1>(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs,
                           rs, os, res_bf16, apply_act, stream);
    case 2:
      return launch_mma<2>(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs,
                           rs, os, res_bf16, apply_act, stream);
    case 4:
      return launch_mma<4>(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs,
                           rs, os, res_bf16, apply_act, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


template <int BN>
int launch_f32(const void* x, const void* w, const float* scale, const float* shift,
               const float* bias, const void* residual, void* out, int b, int d, int h, int wd,
               int cin, int cout, const Strides& xs, const Strides& rs, const Strides& os,
               int res_bf16, int apply_act, cudaStream_t stream) {
  const int w_tiles = (wd + kTW - 1) / kTW;
  const int h_tiles = (h + Tile<BN>::kTH - 1) / Tile<BN>::kTH;
  const dim3 grid(w_tiles * h_tiles, b * d, (cout + BN - 1) / BN);
  fused_conv_f32_kernel<BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), scale, shift, bias, residual,
      static_cast<float*>(out), d, h, wd, cin, cout, xs, rs, os, res_bf16, apply_act);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32_bn(const void* x, const void* w, const float* scale, const float* shift,
                  const float* bias, const void* residual, void* out, int b, int d, int h,
                  int wd, int cin, int cout, const Strides& xs, const Strides& rs,
                  const Strides& os, int res_bf16, int apply_act, cudaStream_t stream) {
  if (cout <= 32) {
    return launch_f32<32>(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs,
                          rs, os, res_bf16, apply_act, stream);
  }
  if (cout <= 64) {
    return launch_f32<64>(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs,
                          rs, os, res_bf16, apply_act, stream);
  }
  return launch_f32<128>(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs,
                         rs, os, res_bf16, apply_act, stream);
}

Strides strides_at(const long long* s) { return Strides{s[0], s[1], s[2], s[3], s[4]}; }

}  // namespace

// x (b, d, h, wd, cin) and out (b, d, h, wd, cout) in one type (dtype 0 =
// f32, 1 = bf16), each addressed by five element strides. w in that type,
// contiguous: (3, 3, 3, cin, cout) for f32; for bf16 transposed and padded
// with zeros, (3, 3, 3, cout_p, cin_p), cout_p the multiple of bn and cin_p
// the multiple of 16 at or above cout and cin. scale, shift (b, cin) and bias
// (cout) f32 contiguous (scale and shift unread when apply_act is 0);
// residual null or of out's shape, f32 (res_dtype 0) or bf16 (1). `strides`
// holds 15 values: x's, residual's and out's (b, d, h, w, c) strides. bn and
// rd are the bf16 kernel's output channels a block (which must be its 32) and
// output planes a block (1, 2 or 4), as ops/fused_conv.py::conv_tiles chose
// them (unread for f32). Launches on `stream` of `device` and returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int gm_fused_conv3d(const void* x, const void* w, const float* scale,
                               const float* shift, const float* bias, const void* residual,
                               void* out, int b, int d, int h, int wd, int cin, int cout,
                               const long long* strides, int dtype, int res_dtype, int apply_act,
                               int bn, int rd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b * d > 65535 || cin < 1 || cout < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs = strides_at(strides), rs = strides_at(strides + 5),
                os = strides_at(strides + 10);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_f32_bn(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs, rs,
                         os, res_dtype, apply_act, s);
  }
  if (dtype == 1) {
    if (bn != kBN) return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma_run(rd, x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout,
                          xs, rs, os, res_dtype, apply_act, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
