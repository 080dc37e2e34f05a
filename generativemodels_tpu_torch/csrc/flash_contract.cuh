// The three softmax contracts of the JAX flash-attention kernel
// (generativemodels_tpu/ops/flash_attention.py), shared by the forward
// (flash_fwd.cu, kernel 1) and the backward (flash_bwd.cu, kernels 2-4),
// each a compile-time parameter of their kernels:
// - kNoMax, the default (`no_max`, GMTPU_FLASH_NOMAX unset or 1): q arrives
//   prescaled by scale*log2(e), scores live in the log2 domain and are
//   clamped above at 80, and there is no running max (`_fwd_tile`'s no_max
//   branch); the backward's p is exp2(min(s, 80) - lse2).
// - kRunningMax (`no_max=False`, GMTPU_FLASH_NOMAX=0): the same prescaled q
//   and log2 domain, no clamp, and the online softmax with a running row max
//   m: p = exp2(s - m), l and acc rescaled by exp2(m_prev - m) (`_fwd_tile`
//   :190-199); the backward's p is exp2(s - lse2).
// - kUpcast (`upcast=True`, the reference's upcast_attention): f32
//   operands, q not prescaled, the softmax scale multiplies s after the
//   product, natural exp, and a running max (`flash_attention` :926-932);
//   the lse is the natural-log one, and the backward's p is exp(s * scale -
//   lse). Only the f32 kernels take it: the launcher casts bf16 inputs to f32.
// ops/native.py hashes every .cuh of this directory into each library's
// name, so an edit here rebuilds all of them.
#pragma once

#include <math.h>

namespace {

enum Contract : int { kNoMax = 0, kRunningMax = 1, kUpcast = 2 };

// exp in the contract's domain: natural under kUpcast, base 2 otherwise
template <int K>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (K == kUpcast) {
    return expf(x);
  } else {
    return exp2f(x);
  }
}

// The running max of one row after a tile whose largest score is `tile_max`:
// updates `m` and returns the offset that the tile's scores and the rescale
// subtract (m, or 0 while every key of the row so far was masked, so that no
// exp sees -inf - -inf) and, in `alpha`, the factor that rescales the row's
// l and acc.
template <int K>
__device__ __forceinline__ float advance_max(float& m, float tile_max, float& alpha) {
  const float m_new = fmaxf(m, tile_max);
  const float offset = m_new == -INFINITY ? 0.f : m_new;
  alpha = softmax_exp<K>(m - offset);
  m = m_new;
  return offset;
}

}  // namespace
