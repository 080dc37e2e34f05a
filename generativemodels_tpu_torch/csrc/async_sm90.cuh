// Hopper's asynchronous copies and products, shared by the kernels of this
// directory that use them (fused_conv.cu, flash_probes.cu, flash_fwd.cu,
// flash_bwd.cu) on sm_90a:
// - mbarriers, the tensor-memory accelerator's tiled loads (TMA) into
//   shared memory and reductions into global memory, and the host-side
//   encoding of their tensor maps (reached
//   through the runtime's driver entry point, so a library needs no link to
//   the driver);
// - warpgroup products (wgmma.mma_async) of bf16 and TF32 operands with f32
//   accumulation, their shared-memory descriptors in the 128-byte swizzle
//   that TMA writes, and the fence, commit and wait that order them;
// - named barriers and the warpgroup register limit (setmaxnreg) of warp
//   specialisation, and the barrier and shared-memory window of a thread
//   block cluster.
// ops/native.py hashes every .cuh of this directory into each library's
// name, so an edit here rebuilds all of them.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "mma_sm90.cuh"

namespace {

// ---- mbarriers

// `count` arrivals complete a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// after the barriers' init, before any thread or copy uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` from the copies tied to the barrier
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// one arrival of this warp on `bar`, after its lanes' work (a consumer
// warp's release of a ring stage, a converter warp's "split")
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}
// until the phase of parity `parity` has completed (the n-th completion,
// counting from 0, has parity n & 1)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA: the box of `map` at the given coordinates (innermost first),
// zero outside the tensor; the bytes are counted on `bar`

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_addr(bar))
      : "memory");
}

// ---- TMA reductions: the box of `map` at the coordinates += the tile at
// `src` (f32 add, outside the tensor dropped), as one bulk group of the
// issuing thread (bulk_commit, then bulk_wait until at most N of the
// thread's groups are still running)
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// global-memory accesses of this thread ordered against those of the
// asynchronous proxy (the TMA reductions it issues or has completed)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The tiled TMA map of a `rank`-D tensor of `type` at `base`: dims and box
// innermost first, strides in bytes of dims 1 .. rank - 1, L2 promotion of
// 128 bytes, zero fill outside the tensor. cuTensorMapEncodeTiled comes from
// the runtime's driver entry point.
inline cudaError_t encode_tiled_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                    const void* base, const cuuint64_t* dims,
                                    const cuuint64_t* strides, const cuuint32_t* box,
                                    CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, step,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA map of a contiguous (bh, rows, width) bf16 tensor (attention's
// heads) seen as (width, rows, bh): a box of `box_cols` columns x `box_rows`
// rows in `swizzle`, rows past `rows` of a head read as 0. A box is at most
// one swizzle row wide (64 columns in the 128-byte swizzle), so a wider head
// is loaded as one box per 64 columns
inline cudaError_t encode_head_rows_map(CUtensorMap* map, const void* base, int width, int rows,
                                        int bh, int box_cols, int box_rows,
                                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t w = static_cast<cuuint64_t>(width);
  const cuuint64_t dims[3] = {w, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {w * 2, static_cast<cuuint64_t>(rows) * w * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1};
  return encode_tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                          swizzle);
}

// The TMA map of a contiguous (bh, rows, width) f32 tensor seen as (width,
// rows, bh): a box of 32 columns (one 128-byte swizzle row) x `box_rows`
// rows, rows past `rows` of a head read as 0
inline cudaError_t encode_f32_rows_map(CUtensorMap* map, const void* base, int width, int rows,
                                       int bh, int box_rows) {
  const cuuint64_t w = static_cast<cuuint64_t>(width);
  const cuuint64_t dims[3] = {w, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {w * 4, static_cast<cuuint64_t>(rows) * w * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  return encode_tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---- wgmma

// The descriptor of a bf16 tile as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 64 elements (128 bytes), the 16-byte
// chunks of row r permuted by r % 8, 8-row groups 1024 bytes apart (the
// stride byte offset), the tile 1024-byte aligned (base offset 0). The same
// tile is K-major for an operand whose rows run along M or N (Q and K of
// s = q k^T: a k-step of 16 columns adds 32 bytes to the address, inside
// the swizzle's row) and MN-major, with the transpose bit, for one whose rows
// run along K (V of o = p v: a k-step of 16 rows adds 2048 bytes). The
// leading byte offset is not read at this width: a K-major row and an
// MN-major row of 64 elements are each one swizzle atom wide. A wider bf16
// row (256 columns: four atoms) lies as one such tile per 64 columns, each
// loaded by its own TMA box: a K-major k-step of 16 columns stays inside
// one atom (the k-steps over d move from atom to atom), and an MN-major
// operand is read one atom, N = 64, at a time.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}
// The descriptor of a bf16 tile without swizzle: core matrices of 8 rows x
// 16 bytes, `lead` bytes apart along K and `stride` bytes apart along M or N.
__device__ __forceinline__ uint64_t wgmma_desc_plain(uint32_t addr, uint32_t lead,
                                                     uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16)
         | (static_cast<uint64_t>(stride >> 4) << 32);
}
// The descriptor of a bf16 tile as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_64B: rows of 32 elements (64 bytes), 8-row groups
// 512 bytes apart (the stride byte offset), the tile 1024-byte aligned. Read
// MN-major (transposed) it is an operand of N = 32 whose rows run along K (a
// k-step of 16 rows adds 1024 bytes); the leading byte offset, the next
// 32 elements along N, is not read at that width.
__device__ __forceinline__ uint64_t wgmma_desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(512 >> 4) << 32)
         | (static_cast<uint64_t>(2) << 62);
}
// the byte offset of (row, column col) in a tile of 32-f32 rows in the
// 128-byte swizzle (one swizzle row a tile row), as TMA writes such a tile
// and wgmma_desc_sw128 reads it: the TF32 bodies' B operands written by
// their consumers
__device__ __forceinline__ int swizzle128_f32(int row, int col) {
  return row * 128 + (((col / 4) ^ (row % 8)) << 4) + 4 * (col % 4);
}
// the descriptor moved by `bytes` (a multiple of 16)
__device__ __forceinline__ uint64_t wgmma_desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}
// the same, computed where the wgmma that reads it is issued: an opaque
// add, so that the compiler does not hoist the loop-invariant descriptors of
// resident operands (some 60 64-bit values a tile in flash_bwd.cu's TF32
// body, 32 in its D = 256 one) out of the tile loop, where they would take
// the registers of the accumulators and spill
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  uint64_t moved;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(moved) : "l"(desc), "l"(uint64_t{bytes >> 4}));
  return moved;
}

// before the first wgmma, and between registers written by other
// instructions and a wgmma that reads them (its A fragment, its accumulator)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// the wgmmas issued since the last commit form one group
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are still running (groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The compiler does not know that a wgmma writes its accumulator, and reads
// its A fragment, after the instruction: these keep reads and writes of
// those registers from moving across the wait that ends it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
  }
}

// d (+)= a b for a 64 x N tile, K = 16: A and B from shared memory by
// descriptor, both K-major; scale_d 0 overwrites d. d is the m64nN
// accumulator: thread t of warp w holds rows 16 w + t / 4 and that + 8, and
// for each n8 block i, d[4 i] and d[4 i + 1] (columns 8 i + 2 (t % 4), + 1)
// of the first row, d[4 i + 2] and d[4 i + 3] of the second.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
// shared-memory writes of this thread made visible to the asynchronous
// proxy (the wgmmas and TMA copies that read them)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a b for a 64 x 64 tile, K = 16: A from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows: rows g, g + 8, columns 2 (t %
// 4) + {0, 1} and + 8; the accumulator of two n8 blocks rounded to bf16
// pairs is one), B from shared memory by descriptor, MN-major (TransB:
// transposed) or K-major; scale_d 0 overwrites d.
template <bool TransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d);
// d += a b for a 64 x N tile, K = 16: A from registers as wgmma_rs_n64's, B
// K-major
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b for a 64 x 32 tile, K = 16: A and B from shared memory by
// descriptor, both MN-major (transposed: A's rows and B's rows run along K);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32_mn(float (&d)[16], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b for a 64 x 64 tile, K = 16: A and B from shared memory by
// descriptor, A K-major and B MN-major (transposed: B's rows run along K);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64_trans_b(float (&d)[32], uint64_t a, uint64_t b,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <bool TransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB ? 1 : 0));
}

// d (+)= a b for a 64 x 32 tile, K = 8, TF32 operands (f32 bit patterns
// rounded to TF32, low 13 bits zero): A and B from shared memory by
// descriptor, both K-major (TF32 has no transposed operand; a k-step of 8
// values adds 32 bytes, as bf16's of 16); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b for a 64 x 32 tile, K = 8, TF32 operands: A from registers as
// wgmma_tf32_rs_n64's (below), B K-major from shared memory by descriptor;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= a b for a 64 x 64 tile, K = 8, TF32 operands: A from registers
// (the mma.sync m16n8k8 TF32 A fragment of each warp's 16 rows: rows g,
// g + 8, columns t % 4 and + 4), B K-major from shared memory by descriptor;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- warp specialisation

// named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads: sync
// waits for them all, arrive counts this warp and goes on
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// ---- thread block clusters

// every thread of every block of the cluster arrives, then waits for the
// others: shared-memory writes before it are visible to the cluster's
// reads after it (every thread of the blocks executes it, none having
// exited)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the generic address of `p` (this block's shared memory) in the shared
// memory of the cluster's block `rank`
__device__ __forceinline__ const float* cluster_peer(const float* p, uint32_t rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// the warpgroup's register limit, raised or lowered (a multiple of 8 in
// [24, 256]); every warp of the warpgroup executes it
template <int N>
__device__ __forceinline__ void regs_raise() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_lower() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace
