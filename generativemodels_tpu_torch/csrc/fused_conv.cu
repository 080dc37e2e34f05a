// Fused GroupNorm-affine + SiLU -> 3x3x3 convolution -> bias [+ residual],
// for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel generativemodels_tpu/ops/fused_conv.py
// ::_kernel (called from _fused_impl). It computes
//
//     out = conv3x3x3(silu(x * scale + shift)) + bias [+ residual]
//
// with stride 1 and padding 1, x of shape (B, D, H, W, Cin), the kernel w of
// shape (3, 3, 3, Cin, Cout) (the bf16 kernel reads it transposed, (3, 3, 3,
// Cout, Cin)), scale and shift (B, Cin) f32 (the
// folded GroupNorm affine), bias (Cout) f32, and an optional residual of the
// output's shape. As in the TPU kernel: the prologue normalises and applies
// SiLU in f32 and rounds the activation to x's type (bf16 or f32); taps that
// fall outside the volume are zero in the activation's domain (after SiLU),
// as the TPU kernel's zero padding and its `valid` mask of out-of-range depth
// taps are; products take the activation and the kernel in x's type and
// accumulate in f32; bias and residual are added in f32 before the one cast
// to x's type. With apply_act = 0 the prologue is the identity.
//
// x, residual and out are addressed through five strides each (b, d, h, w,
// c, in elements), so one kernel reads and writes both a contiguous
// channels-last tensor and a channels-first one seen through
// permute(0, 2, 3, 4, 1). The UNet passes its channels-first activations that
// way and gets a channels-first output: no layout copy on either side.
//
// What bounds it on this card: the 3D UNet's 22 launches a forward do 1.83e12
// FLOP (2 * voxels * 27 * Cin * Cout) on ~3.2 GB of activations: at the
// tensor-core rate (989 TFLOP/s bf16) 1.85 ms, against ~1 ms to move the
// bytes, so the work is bound by arithmetic.
// What the design does about it: an implicit GEMM with M = output voxels,
// N = Cout, K = 27 * Cin. A block owns a tile of output rows x 32 columns of
// one output depth plane and BN output channels, so blocks are independent
// (the TPU kernel's sequential grid over depth becomes a loop over the three
// depth taps inside the block). For each depth tap and each chunk of input
// channels, the block stages the halo of its tile in the source plane in
// shared memory with the prologue applied as it is loaded - the normalised
// activation never reaches device memory, as on the TPU - and the slice of
// the kernel. Depth taps outside the volume are skipped whole; ragged H, W,
// Cin and Cout are masked. Two kernels share that plan:
// - bf16 (the sampling path): fused_conv_mma_kernel, the products on the
//   tensor cores with mma.sync m16n8k16 (f32 accumulation), 16 channels a
//   chunk. Its prologue (each halo element normalised once for each of the
//   three depth taps, about 1.6x over for the halo) costs about as much as
//   the products at Cout = 32; a ring of depth planes, wgmma and TMA are
//   later work.
// - f32: fused_conv_f32_kernel, f32 FMAs on the CUDA cores (67 TFLOP/s
//   peak), 8 channels a chunk; each thread owns one output column, kTH rows
//   of it and BN / 8 channels, and reuses each halo value it reads for the
//   three kh taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 32;  // output columns per block: one per lane
constexpr int kCK = 8;   // input channels per staged chunk of the f32 kernel

struct Strides {
  long long b, d, h, w, c;
};

// ---- f32 on the CUDA cores ----------------------------------------------

// BN output channels a block, kTH output rows a block (32 accumulators a
// thread for BN 32 and 64, 64 for BN 128).
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

#pragma unroll 2
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
  const __nv_bfloat16* rh = residual != nullptr && res_bf16
                                ? static_cast<const __nv_bfloat16*>(residual) + roff : nullptr;
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

constexpr int kMmaTH = 4;       // output rows a block: M = 4 x 32 = 128 voxels
constexpr int kMmaCK = 16;      // input channels a chunk: one mma's K
constexpr int kLd = kMmaCK + 8;  // bf16 row stride in shared memory: conflict-free fragment reads
constexpr int kMmaHalo = (kMmaTH + 2) * (kTW + 2);

// 8 warps over the 128-voxel x BN tile: each warp owns kMT 16-voxel and kNT
// 8-channel fragments (16, 32 and 64 accumulators a thread for BN 32, 64, 128)
template <int BN>
struct MmaTile {
  static constexpr int kWarpsM = BN == 32 ? 8 : 4;
  static constexpr int kWarpsN = kWarps / kWarpsM;
  static constexpr int kMT = kMmaTH * kTW / 16 / kWarpsM;
  static constexpr int kNT = BN / 8 / kWarpsN;
};

template <int BN>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kMmaHalo * kLd + 9 * BN * kLd);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same function as fused_conv_f32_kernel for bf16, with the products on the
// tensor cores. It reads the kernel transposed, wt (3, 3, 3, Cout, Cin)
// contiguous. Per depth tap and chunk of 16 input channels the block
// stages the (kMmaTH + 2) x 34 halo [position][channel] with the prologue
// applied, and the kernel slice as [tap][n][channel]; each of the
// 9 in-plane taps is then one 128 x BN x 16 product of fragments read
// straight from shared memory (rows padded to 24 bf16, so the 8 rows x 4
// words of a fragment fall in 32 distinct banks).
// Grid as fused_conv_f32_kernel's, with kMmaTH rows a block.
template <int BN>
__global__ void __launch_bounds__(kThreads)
fused_conv_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ bias, const void* __restrict__ residual,
                      __nv_bfloat16* __restrict__ out, int depth, int height, int width, int cin,
                      int cout, Strides xs, Strides rs, Strides os, int res_bf16,
                      int apply_act) {
  using Cfg = MmaTile<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [halo position][kLd]
  __nv_bfloat16* sB = sA + kMmaHalo * kLd;                          // [tap][n][kLd]

  const int w_tiles = (width + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / w_tiles) * kMmaTH;
  const int w0 = (blockIdx.x % w_tiles) * kTW;
  const int bi = blockIdx.y / depth;
  const int od = blockIdx.y % depth;
  const int n0 = blockIdx.z * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in the group
  const int wm = warp % Cfg::kWarpsM;
  const int wn = warp / Cfg::kWarpsM;

  float acc[Cfg::kMT][Cfg::kNT][4];
#pragma unroll
  for (int i = 0; i < Cfg::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < Cfg::kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  const __nv_bfloat16* xb = x + bi * xs.b;
  for (int kd = 0; kd < 3; ++kd) {
    const int sd = od + kd - 1;
    if (sd < 0 || sd >= depth) continue;  // the tap reads zeros: no contribution
    const __nv_bfloat16* xp = xb + sd * xs.d;
    const __nv_bfloat16* wk = w + static_cast<size_t>(kd) * 9 * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += kMmaCK) {
      __syncthreads();  // the previous chunk is fully consumed
      // the halo of this chunk, two channels a thread, prologue applied
      for (int i = threadIdx.x; i < (kMmaCK / 2) * kMmaHalo; i += kThreads) {
        const int cp = i / kMmaHalo;
        const int pos = i % kMmaHalo;
        const int hh = h0 + pos / (kTW + 2) - 1;
        const int ww = w0 + pos % (kTW + 2) - 1;
        float v[2] = {0.f, 0.f};
        if (hh >= 0 && hh < height && ww >= 0 && ww < width) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = c0 + 2 * cp + e;
            if (cc >= cin) continue;
            float a = __bfloat162float(xp[hh * xs.h + ww * xs.w + cc * xs.c]);
            if (apply_act) {
              // x * scale + shift rounded twice, as the plain version computes it
              a = __fadd_rn(__fmul_rn(a, scale[bi * cin + cc]), shift[bi * cin + cc]);
              a = a / (1.f + expf(-a));
            }
            v[e] = a;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(sA + pos * kLd + 2 * cp) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
      // the kernel slice sB[tap][n][k] = wt[kd, tap, n0 + n, c0 + k], 8 channels an item
      for (int i = threadIdx.x; i < 9 * BN * 2; i += kThreads) {
        const int half = i % 2;
        const int n = (i / 2) % BN;
        const int tap = i / (2 * BN);
        const int cc = c0 + 8 * half;
        const int nn = n0 + n;
        const __nv_bfloat16* src = wk + (static_cast<size_t>(tap) * cout + nn) * cin + cc;
        __nv_bfloat16* dst = sB + (tap * BN + n) * kLd + 8 * half;
        if (nn < cout && cc + 8 <= cin && cin % 8 == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dst[e] = (nn < cout && cc + e < cin) ? src[e] : __float2bfloat16(0.f);
          }
        }
      }
      __syncthreads();

#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int kh = tap / 3;
        const int kw = tap % 3;
        uint32_t a[Cfg::kMT][4];
#pragma unroll
        for (int i = 0; i < Cfg::kMT; ++i) {
          const int m0 = (wm * Cfg::kMT + i) * 16;  // 16 voxels of one output row
          const int pos0 = (m0 / kTW + kh) * (kTW + 2) + m0 % kTW + kw;
          const __nv_bfloat16* p = sA + (pos0 + g) * kLd + 2 * t;
          a[i][0] = lds32(p);
          a[i][1] = lds32(p + 8 * kLd);
          a[i][2] = lds32(p + 8);
          a[i][3] = lds32(p + 8 * kLd + 8);
        }
#pragma unroll
        for (int j = 0; j < Cfg::kNT; ++j) {
          const __nv_bfloat16* q = sB + (tap * BN + (wn * Cfg::kNT + j) * 8 + g) * kLd + 2 * t;
          const uint32_t b0 = lds32(q);
          const uint32_t b1 = lds32(q + 8);
#pragma unroll
          for (int i = 0; i < Cfg::kMT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
        }
      }
    }
  }

  // epilogue: + bias, + residual, in f32; one cast
#pragma unroll
  for (int i = 0; i < Cfg::kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (wm * Cfg::kMT + i) * 16 + g + 8 * half;
      const int oh = h0 + m / kTW;
      const int ow = w0 + m % kTW;
      if (oh >= height || ow >= width) continue;
      const long long roff = bi * rs.b + od * rs.d + oh * rs.h + ow * rs.w;
      __nv_bfloat16* ob = out + bi * os.b + od * os.d + oh * os.h + ow * os.w;
#pragma unroll
      for (int j = 0; j < Cfg::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + (wn * Cfg::kNT + j) * 8 + 2 * t + e;
          if (n >= cout) continue;
          float v = acc[i][j][2 * half + e] + bias[n];
          if (residual != nullptr) {
            const long long ro = roff + n * rs.c;
            v += res_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(residual)[ro])
                          : static_cast<const float*>(residual)[ro];
          }
          ob[n * os.c] = __float2bfloat16(v);
        }
      }
    }
  }
}

template <int BN>
int launch_mma(const void* x, const void* w, const float* scale, const float* shift,
               const float* bias, const void* residual, void* out, int b, int d, int h, int wd,
               int cin, int cout, const Strides& xs, const Strides& rs, const Strides& os,
               int res_bf16, int apply_act, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<BN>();
  auto kernel = fused_conv_mma_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w_tiles = (wd + kTW - 1) / kTW;
  const int h_tiles = (h + kMmaTH - 1) / kMmaTH;
  const dim3 grid(w_tiles * h_tiles, b * d, (cout + BN - 1) / BN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), scale, shift,
      bias, residual, static_cast<__nv_bfloat16*>(out), d, h, wd, cin, cout, xs, rs, os,
      res_bf16, apply_act);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma_bn(const void* x, const void* w, const float* scale, const float* shift,
                  const float* bias, const void* residual, void* out, int b, int d, int h,
                  int wd, int cin, int cout, const Strides& xs, const Strides& rs,
                  const Strides& os, int res_bf16, int apply_act, cudaStream_t stream) {
  if (cout <= 32) {
    return launch_mma<32>(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs,
                          rs, os, res_bf16, apply_act, stream);
  }
  if (cout <= 64) {
    return launch_mma<64>(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs,
                          rs, os, res_bf16, apply_act, stream);
  }
  return launch_mma<128>(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs,
                         rs, os, res_bf16, apply_act, stream);
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
// f32, 1 = bf16), each addressed by five element strides; w in that type,
// contiguous, (3, 3, 3, cin, cout) for f32 and (3, 3, 3, cout, cin) for bf16; scale, shift (b, cin) and bias (cout) f32
// contiguous (scale and shift unread when apply_act is 0); residual null or
// of out's shape, f32 (res_dtype 0) or bf16 (1). `strides` holds 15 values:
// x's, residual's and out's (b, d, h, w, c) strides. Launches on `stream` of
// `device` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int gm_fused_conv3d(const void* x, const void* w, const float* scale,
                               const float* shift, const float* bias, const void* residual,
                               void* out, int b, int d, int h, int wd, int cin, int cout,
                               const long long* strides, int dtype, int res_dtype, int apply_act,
                               int device, void* stream) {
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
    return launch_mma_bn(x, w, scale, shift, bias, residual, out, b, d, h, wd, cin, cout, xs, rs,
                         os, res_dtype, apply_act, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
