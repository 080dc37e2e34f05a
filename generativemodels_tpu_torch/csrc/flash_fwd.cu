// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel generativemodels_tpu/ops/flash_attention.py
// ::_fwd_kernel (with _fwd_tile, _build_mask and _pv_update) in its default
// contract: q arrives prescaled by scale*log2(e) (rounded to q's type, as the
// JAX wrapper does), scores live in the log2 domain and are clamped at 80,
// there is no running max, p = exp2(s), l = sum(p), O = (p V) / max(l, 1e-30)
// and lse = lse_mul * log2(max(l, 1e-30)): with lse_mul = ln2 the natural-log
// row logsumexp, with lse_mul = 1 the log2-domain lse the backward reads.
// Masked keys (ragged kv edge, causal upper triangle) get p == 0 exactly.
// For bf16 inputs p is rounded to bf16 before the PV product, and both
// products take bf16 operands (exact in f32) with f32 accumulation; for f32
// inputs everything is f32 on the CUDA cores, with no TF32.
//
// What bounds it on this card: at the serving shape (BH=4, S=1024, D=256)
// the work is 2*BH*S*S*D multiply-adds on 16 MB of operands (K and V of a
// head take 1 MB each and stay in the 50 MB L2), so it is bound by
// arithmetic. This first version runs the two products as f32
// FMAs on the CUDA cores, reading its operands from shared memory, so
// shared-memory bandwidth and FMA issue bound it, far below the tensor-core
// rate. With one head at batch 4 the grid has BH*S/32 = 128 blocks for the
// 132 SMs, so one block per SM is all the parallelism there is.
// What the design does about it: each block owns 32 query rows (8 per
// warp) and loops over key tiles of 32 (one key per lane), in place of the
// TPU's sequential innermost grid axis. Tiles are staged in dynamic shared
// memory as f32, so one code path serves both input types and D=256 fits
// (about 100 KB a block, above the 48 KB static limit). K rows are padded by
// 4 floats so that the 16-byte K reads of a warp hit distinct banks; Q and P
// reads are warp-wide broadcasts. The P tile of a warp's rows is private to
// that warp, so only __syncwarp separates its write from the PV product.
// The (32 x D) f32 accumulator lives in registers, 8 rows x D/32 columns a
// thread. The tensor-core path (wgmma with TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane

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

// Copy `rows` rows of width D (row-major, contiguous) into shared memory as
// f32 with row stride `ld`; rows at or past `valid` are zero-filled so that
// a masked p of 0 never meets a stale value. With `scale` each element is
// multiplied by `mul` and rounded back to T (the q prescale).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int rows, int valid, float mul, bool scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecsPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i % kVecsPerRow) * kVec;
    float vals[kVec];
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        vals[j] = scale ? round_to<T>(to_float(e[j]) * mul) : to_float(e[j]);
      }
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 4) + kBlockK * D + kBlockQ * kBlockK);
}

// Grid: one block per (bh, 32-row query block), flattened into blockIdx.x.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int num_qb,
                 int causal, float qscale, float lse_mul) {
  static_assert(D % 32 == 0, "head width must be a multiple of 32");
  constexpr int kLdK = D + 4;
  constexpr int kCols = D / 32;  // accumulator columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                 // kBlockQ x D
  float* sK = sQ + kBlockQ * D;     // kBlockK x kLdK
  float* sV = sK + kBlockK * kLdK;  // kBlockK x D
  float* sP = sV + kBlockK * D;     // kBlockQ x kBlockK

  const int bh = blockIdx.x / num_qb;
  const int q0 = (blockIdx.x % num_qb) * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;  // first tile row of this warp

  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;
  load_tile<T, D>(sQ, D, q + (static_cast<size_t>(bh) * sq + q0) * D, kBlockQ,
                  min(kBlockQ, sq - q0), qscale, true);

  float acc[kRowsPerWarp][kCols];
  float lsum[kRowsPerWarp];  // this lane's share of each row sum
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    lsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, q0 + kBlockQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    const int kvalid = min(kBlockK, sk - k0);
    load_tile<T, D>(sK, kLdK, kb + static_cast<size_t>(k0) * D, kBlockK, kvalid, 1.f, false);
    load_tile<T, D>(sV, D, vb + static_cast<size_t>(k0) * D, kBlockK, kvalid, 1.f, false);
    __syncthreads();

    // s[i] = q[r0 + i] . k[lane]
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = sK + lane * kLdK;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(sQ + (r0 + i) * D + d);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    const int col = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = q0 + r0 + i;
      const bool live = col < sk && (!causal || col <= row);
      const float p = live ? exp2f(fminf(s[i], 80.f)) : 0.f;
      lsum[i] += p;
      sP[(r0 + i) * kBlockK + lane] = round_to<T>(p);
    }
    __syncwarp();

    // acc[i][j] += sum_c p[r0 + i][c] * v[c][lane + 32 j]
#pragma unroll 2
    for (int c = 0; c < kBlockK; c += 4) {
      float4 pp[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        pp[i] = *reinterpret_cast<const float4*>(sP + (r0 + i) * kBlockK + c);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float v0 = sV[(c + 0) * D + lane + 32 * j];
        const float v1 = sV[(c + 1) * D + lane + 32 * j];
        const float v2 = sV[(c + 2) * D + lane + 32 * j];
        const float v3 = sV[(c + 3) * D + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          acc[i][j] = fmaf(pp[i].x, v0, acc[i][j]);
          acc[i][j] = fmaf(pp[i].y, v1, acc[i][j]);
          acc[i][j] = fmaf(pp[i].z, v2, acc[i][j]);
          acc[i][j] = fmaf(pp[i].w, v3, acc[i][j]);
        }
      }
    }
    __syncwarp();  // P is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float l = fmaxf(warp_sum(lsum[i]), 1e-30f);
    const int row = q0 + r0 + i;
    if (row >= sq) continue;
    T* orow = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[lane + 32 * j] = from_float<T>(acc[i][j] / l);
    if (lane == 0) lse[static_cast<size_t>(bh) * sq + row] = log2f(l) * lse_mul;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
           int sk, int causal, float qscale, float lse_mul, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_qb = (sq + kBlockQ - 1) / kBlockQ;
  kernel<<<num_qb * bh, kThreads, smem, stream>>>(
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
// f32, 1 = bf16), lse (bh, sq) f32; all contiguous. qscale is scale*log2(e)
// already rounded to the input type; lse_mul is ln2 for a natural-log lse, 1
// for a log2 one. Launches on `stream` of `device` and returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int gm_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int sq, int sk, int d, int dtype, int causal, float qscale,
                            float lse_mul, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, o, lse, bh, sq, sk, d, causal, qscale, lse_mul, s);
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, causal, qscale, lse_mul, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
