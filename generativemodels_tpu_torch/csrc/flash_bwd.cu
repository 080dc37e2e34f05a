// Flash-attention backward for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes. How chip_smoke.py's phase 2 checks these kernels:
// kernels 2 + 3 and kernel 4 against flash_attention_backward_reference at
// every BACKWARD_CASES and CONTRACT_CASES shape (dq, dk, dv within 2e-2 of
// the largest gradient in bf16, 1e-4 in f32), two launches of kernels 2
// and 4 equal to the bit, and kernel 4's dq against kernel 2's within 1e-5
// of its largest value plus one bf16 ulp; its dk and dv against kernel 3's
// to the bit where the two share a body (the same dV and dK products in
// the same order: dkv_block on the mma.sync route, dkv_tile_probs and
// products_over_tile on the wgmma route at D = 64, kernel 3's consumer code
// itself in wd::dkv_consume at bf16 D = 256 and tf::dkv_consume at f32 D =
// 64), and within that margin where they do not: in f32 at D = 128 and 256,
// where kernel 3 runs the ts body and kernel 4 the mma.sync one.
//
// Replaces the Pallas TPU kernels of the backward `_flash_bwd` in
// generativemodels_tpu/ops/flash_attention.py: the split backward's
// `_dq_kernel` (with _dq_tile) becomes flash_bwd_dq_kernel (kernel 2) and
// `_dkv_kernel` (with _dkv_tile) flash_bwd_dkv_kernel (kernel 3); the fused
// backward's `_dfused_kernel` (with _dfused_tile, run under
// GMTPU_FLASH_FUSED_BWD=1) becomes flash_bwd_fused_kernel (kernel 4). The
// last two share one body, dkv_block. On the wgmma route (below) kernels
// 2-4 are flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel and
// flash_bwd_fused_wgmma_kernel at D = 64, and flash_bwd_dq_wide_kernel,
// flash_bwd_dkv_wide_kernel and flash_bwd_fused_wide_kernel at D = 256; on
// the TF32 route they are flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel
// and flash_bwd_fused_tf32_kernel at D = 64, and kernels 2 and 3
// flash_bwd_dq_stream_kernel and flash_bwd_dkv_stream_kernel at D = 128 and
// 256.
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
// The other two contracts of flash_contract.cuh, each kernel instantiated
// for each: kRunningMax (the same inputs, the lse2 of the forward's running
// max) drops the clamp, p = exp2(q.k - lse2) (the JAX tiles' branch that is
// not no_max: _dq_tile :309, _dkv_tile :439, _dfused_tile :532); kUpcast
// (f32 only) takes q unscaled, dO without the ln2 and the natural-log lse,
// and computes p = exp(q.k * scale - lse) and ds = scale * p (do.v - delta),
// which carries the scale that JAX multiplies into each dq and dk part, and
// dv = p^T dO with no log2(e).
//
// What bounds them on this card: at the 3D training shape (BH=2, S=32768,
// D=64, bf16) kernel 2 does 3 products of BH*S*S*D multiply-adds (s, dp,
// dq), 8.2e11 operations, kernel 3 four (s, dp, dv, dk), 1.1e12 operations,
// on 17 MB: 0.83 and 1.11 ms at the bf16 tensor-core rate (989 TFLOP/s),
// bound by operations; kernel 4 adds the fifth, dq (1.39 ms), and adds its
// key blocks' dq parts into an f32 buffer: BH * Sq * D * Sk / 128 adds, 4.3
// GB of reductions at the 3D shape, ordered across the key blocks.
//
// Three bodies of each of kernels 2, 3 and 4, each (kernel, input) taking
// one: the `route` argument of their C entries names it
// (ops/flash_attention.py::attention_route picks it; an unknown route, or a
// route the inputs do not take, raises; nothing falls back to another
// body):
// - kRouteWgmma, bf16 at D = 64 in the two exp2 contracts (the 3D training
//   step, the latent UNet, the 3D LDM's bf16 stages): warpgroup products
//   (wgmma) fed by a TMA ring from a producer warpgroup, below. The
//   softmax arithmetic between the products (an exp2 on the SFU and a
//   handful of CUDA-core instructions a score) is what keeps it from the
//   tensor-core bound. Kernels 2-4 take the route at bf16 D = 256 too
//   (the 2D UNets' 256-wide heads: bench.py's training step), on a body of
//   their own (namespace wd, below).
// - kRouteTf32, kernels 2 and 3 on f32 operands at D = 64, 128 and 256 in
//   all three contracts, kernel 4 at D = 64 (the f32 3D LDM recipe's
//   stage-1 and stage-2 attention at D = 64, the 2D f32 recipe's and
//   ControlNet's training steps at D = 256 and 128, upcast at those
//   widths): warpgroup products on TF32 operands (wgmma m64nNk8, 3xTF32)
//   fed by a TMA ring and a converter role, on two bodies below (namespace
//   tf at D = 64, ts at 128 and 256).
// - kRouteMma, every other case (f32 and upcast as 3xTF32 at D = 32 and in
//   kernel 4 at D = 128 and 256, bf16 at D = 32 and 128; kernels 2-4 have
//   no mma.sync instance at bf16 D = 64 and 256 in the exp2 contracts nor
//   in f32 at D = 64, kernels 2 and 3 none in f32 at D = 128 and 256): the
//   mma.sync bodies, where
//   the tensor pipe's issue rate (mma.sync, as kernel 1) and the operand
//   fragments read from shared memory by ldmatrix set the floor.
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
// - bf16, D = 32: 8 row groups (128 rows), 64-key tiles, the Q and dO A
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
// On the mma.sync route kernel 4 adds each q tile's dq part into one zeroed
// f32 (BH, Sq, D) buffer in a fixed order, so dq is the same to the bit from
// run to run
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
//
// Kernels 2-4 on the wgmma route (namespace wg, flash_bwd_dq_wgmma_kernel,
// flash_bwd_dkv_wgmma_kernel and flash_bwd_fused_wgmma_kernel; the design
// of kernels 6 and 7 in
// flash_probes.cu, helpers in async_sm90.cuh). A block is three
// warpgroups: two consumers of 64 rows each and a producer, with setmaxnreg
// giving the consumers 240 registers and the producer 24. The producer's
// first thread loads 64-row tiles by TMA into a ring of six stages on full
// and empty mbarriers, from maps of the (BH, S, 64) bf16 tensors seen as
// (64, S, BH): rows past S of a head read as 0, and each 128-byte row is one
// 128-byte swizzle row, which wgmma_desc_sw128 reads K-major (a k-step of 16
// columns, 32 bytes) or MN-major (a k-step of 16 rows, 2048 bytes). Each
// consumer holds its 64 rows' A operands of the d products (Q and dO, or K
// and V) in registers, loaded once from device memory, so every product is
// wgmma m64n64k16 with A from registers:
// - kernel 3, key-major: a block owns 128 keys and streams q tiles (Q, dO,
//   and the tile's lse2 and delta rows, which the producer's second warp
//   copies with plain loads: a head's f32 rows start at any 4-byte offset,
//   where TMA needs 16-byte aligned addresses). Per tile a consumer
//   computes S^T = K Q^T and dP^T = V dO^T (B the tile K-major), then P^T
//   and dS^T in registers by prob_ds's formula, and dV += round(P^T) dO,
//   dK += dS^T Q with the two rounded to bf16 pairs as the A operands (a
//   wgmma accumulator of two n8 blocks is an A fragment) and B the tile
//   MN-major. dK, dV stay in registers and are stored once;
// - kernel 2, query-major: a block owns 128 query rows and streams K, V
//   tiles of 64 keys. Per tile a consumer computes S = Q K^T and dP = dO
//   V^T, dS in registers, and the tile's dq part dS K (B = K MN-major) from
//   zero, added in f32 to the running dq, so dq sums the same 64-key parts
//   in the same order as the mma.sync body: each dq row belongs to one
//   warpgroup, no partial dq is summed across warps, and dq is cast once.
// - kernel 4, kernel 3's block and consumers (the same dV and dK products
//   in the same order, so its dk and dv have kernel 3's bits) and each q
//   tile's dq part dS K over the block's 128 keys: both consumers write
//   their dS^T (bf16, 64 keys x 64 queries each, as TMA writes a tile in
//   the 128-byte swizzle) to one of two buffers and meet at a named
//   barrier; each then computes its 32 columns of the part as wgmma
//   m64n32k16 with A = dS read MN-major from the buffers (the descriptor's
//   transpose bit) and B = its half of the block's K, loaded once by TMA in
//   the 64-byte swizzle and read MN-major (16 f32 registers beside kernel
//   3's), issued with the tile's dV, dK and the next tile's S^T, dP^T. The
//   part goes to a ring of four f32 staging stages (the 128-byte swizzle);
//   two threads of the producer warpgroup, one for the even and one for the
//   odd q tiles, add it into the zeroed f32 dq buffer by TMA reductions
//   (cp.reduce.async.bulk.tensor .add.f32, two 32-column boxes a tile) in
//   key-block order: each waits until the q tile's counter reads the number
//   of key blocks before this one that add into the same buffer, reduces,
//   waits until the reduction is complete, fences and counts the block
//   (the consumers never wait on another block, and issue no atomics).
//   The key blocks of a head fall into the caller's groups (kb % groups),
//   each with its own buffer and counters, which the caller sums: a chain
//   of blocks that wait on one another is one group's, 32 blocks at the 3D
//   shape in place of 256. dq is the same to the bit from run to run.
// Per tile a consumer issues the tile's last products (dV, dK or the dq
// part) and the next tile's S and dP in one commit group and waits once;
// no branch lies between a product's issue and its wait and no register a
// product in flight reads or writes is touched, so ptxas keeps every
// product asynchronous (chip_smoke.py's phase 1 fails on its C7513 and
// C7514 notes, and on a stack frame or spills). The two consumers of a
// block share every stage and overlap one's softmax arithmetic with the
// other's products. p is exp2 on the SFU (ex2.approx.ftz: within 2 ulp of
// exp2f; on the card it has given the mma.sync body's bits); p and ds are
// exactly 0 for masked pairs, tested only in a tile that reaches past Sq,
// Sk or the causal diagonal (a uniform branch taken with no product in
// flight). Under the causal mask kernel 3's q loop starts at its first key
// and kernel 2's key loop ends at its last row, so tiles wholly past the
// diagonal are never loaded. The grid is one block per 128 rows (512
// blocks at the 3D shape, 3.9 waves on 132 SMs); a persistent grid would
// save the last wave's tail, about 3%. Kernels 2 and 3 use no atomics, and
// kernel 4 adds in a fixed order: two launches give the same bits. D = 32
// and 128 are not this code with another constant (a
// 64-byte row takes another swizzle; a 256-byte row is two swizzle atoms,
// and a 64 x 128 accumulator takes 64 registers a thread): they keep the
// mma.sync body. D = 256 is another design again (below).
//
// Kernels 2 and 3 on the wgmma route at bf16 D = 256 (namespace wd,
// flash_bwd_dq_wide_kernel and flash_bwd_dkv_wide_kernel, both exp2
// contracts; the 2D UNets' attention at 1024 tokens in heads of 256). Three
// warpgroups as above (setmaxnreg 240 / 24), but a row of 256 bf16 is 512
// bytes, four 128-byte swizzle atoms, and an m64n256 f32 accumulator takes
// 128 registers a thread:
// - Each operand tile lies in shared memory as four atoms, one per
//   64-column TMA box (maps of (256, S, BH), box 64 columns; atom a holds
//   columns 64a .. 64a + 63 of the tile's rows, 128 bytes a row in the
//   128-byte swizzle, the atoms rows x 128 bytes apart). A K-major k-step of
//   16 columns stays inside one atom, so the products over d (S, dP; S^T,
//   dP^T) step from atom to atom by moving the descriptor's address; an
//   MN-major operand (K in dq's part; Q and dO in dK's and dV's) is read
//   one atom, N = 64, at a time, so no descriptor spans atoms and the
//   leading byte offset stays unread.
// - Registers: the accumulators that live over the tile loop (dq, or half
//   of dK's and dV's columns: 64 + 64 a thread) leave no room for A
//   operands resident in registers (the D = 64 body's design, 64 a thread
//   each at D = 256) nor for a whole part beside them. So the products over d read
//   A and B from shared memory (m64n32), and each tile's part is summed
//   from zero over the tile's keys or queries in 64-column chunks (m64n64,
//   one 32-register part accumulator), each added in f32 once its group is
//   waited for; the next tile's S and dP (or S^T and dP^T) are issued with
//   the last chunk, in one group. (A second part accumulator, each chunk's
//   add under the next chunk's products, spilled kernel 2 and gained 3% in
//   kernel 3: not kept.)
// - Kernel 2 (query-major): a block owns 128 query rows, 64 a consumer; Q
//   and dO of the block stay resident (128 KB) and K, V come in 32-key
//   tiles through a three-stage ring (96 KB). Per tile a consumer computes
//   S = Q K^T and dP = dO V^T (m64n32k16, 16 k-steps each), dS in
//   registers (rounded to bf16 pairs: the A fragments of the part), and the
//   dq part dS K (m64n64k16 with A from registers, B an atom of the K tile
//   MN-major) in four chunks. Shared memory 230456 bytes.
// - Kernel 3 (key-major): a block owns 64 keys, which both consumers
//   share; K and V stay resident (64 KB) and Q, dO come in 64-row tiles
//   through a two-stage ring (128 KB). Per tile consumer c computes S^T =
//   K Q^T and dP^T = V dO^T for the tile's queries 32c .. 32c + 31
//   (m64n32k16), P^T and dS^T of those, rounded to bf16 and stored into
//   its half of the tile's P^T and dS^T buffers (64 keys x 64 queries
//   each, as TMA writes a tile in the 128-byte swizzle); after both meet at
//   named barrier 1 it computes its 128 columns of dV += P^T dO and dK +=
//   dS^T Q over all 64 queries (A the buffers K-major, B the tile's atoms
//   2c and 2c + 1 MN-major), in four chunks. The buffers alternate between
//   tiles, so one barrier a tile keeps a buffer from being rewritten while
//   the other consumer reads it. The tile's lse2 and delta rows come as
//   above (the producer's second warp). Shared memory 231464 bytes, of the
//   232448 a block may take: that sets the two stages and the 64-row tile.
// - The masks, the ragged edges (rows past S read as 0 by TMA, p = 0 for
//   pairs past Sq, Sk or the causal diagonal, tested only in a tile that
//   reaches them) and the causal loop bounds are the D = 64 body's; the
//   grid is one block per 128 query rows (kernel 2) or 64 keys (kernel 3).
// - What bounds it at (128, 1024, 1024, 256): the operations (0.21 ms for
//   kernel 2, 0.28 for kernel 3 at 989 TFLOP/s) and shared memory's
//   bandwidth close behind: the m64n32 products read 3 KB of operands
//   each 16 tensor cycles, above the 128 bytes a cycle shared memory
//   gives, so the products over d run at ~2/3 of the tensor rate; then the
//   chunks' waits. Each block also re-reads its head's streamed operands
//   from L2 (kernel 3: 1 MiB of Q and dO a block).
// Kernel 4 on the wgmma route at bf16 D = 256 (flash_bwd_fused_wide_kernel):
// kernel 3's block, roles and consumer code (wd::dkv_consume, so its dk and
// dv have kernel 3's bits) and each q tile's dq part dS K over the block's
// 64 keys. Nothing of shared memory is free beside kernel 3's layout (984
// bytes), and a 64 x 256 f32 part is 64 KB; nor are registers (dK and dV
// take 128 a thread, and the next tile's S^T and dP^T 32 more while the
// part runs). So:
// - consumer c computes the part's columns 128c .. 128c + 127 in two
//   m64n64k16 chunks in its chunk accumulator (kernel 3's): A = dS^T from
//   the tile's buffer (both consumers' halves, written before named barrier
//   1) read MN-major, B = atoms 2c and 2c + 1 of the resident K read
//   MN-major (bf16 transposes either operand);
// - each chunk is staged over the consumer's own atoms of the q tile's
//   stage once this consumer's dV and dK chunks, the only products that
//   read them then, are done: chunk 1 over dO's atoms 2c, 2c + 1 after dV's
//   two chunks, chunk 0 over Q's after dK's last (32 KB a consumer, two
//   32-column f32 boxes a chunk in the 128-byte swizzle), each counted on
//   its own barrier;
// - the producer warpgroup's third and fourth warps (one thread each, for
//   the tiles of stage 0 and of stage 1) add the staged part into the
//   caller's f32 group buffer by TMA reductions in key-block order (wg's
//   counters and groups, one counter per 64-row q tile; the launcher gives
//   this body one group: the 16 key blocks a head at the bench shape wait
//   on one another for less than 8 groups' 1 GB of buffers costs), chunk 1
//   while the consumers run dK's last chunk, and free the stage for its next load
//   once the reductions have read it (the stage's empty barrier counts the
//   reducer, not the consumers' warps). So the next load into a stage waits
//   for the tile's dq part; a block whose group's blocks before it lag
//   waits for them only there.
//
// Kernels 2 and 3 on the TF32 route (namespace tf, flash_bwd_dq_tf32_kernel
// and flash_bwd_dkv_tf32_kernel): f32 at D = 64, every contract (kUpcast
// with its natural exp). The same three warpgroups, with setmaxnreg giving
// the consumers 224 registers and the producer 56 (its converters' loops
// spilled at 40), but a TF32 wgmma is no bf16 one with another type:
// - TF32 has no transposed operand: both shared-memory operands are read
//   K-major. The d products (S = Q K^T and dP = dO V^T, or S^T = K Q^T and
//   dP^T = V dO^T) read the tensors as they lie, but the tile products (dq
//   += dS K; dV += P^T dO and dK += dS^T Q) contract over the streamed
//   tile's rows, so they read a transposed copy of it (K^T; Q^T and dO^T),
//   64 rows of the tile's 32 rows each, one 128-byte swizzle row.
// - 3xTF32 needs each operand's hi = tf32(x) and lo = tf32(x - hi) (cvt.rna,
//   as split_tf32); TMA copies raw f32. hi is written over the raw tile in
//   place, so whatever a TF32 read does with the low 13 bits of a raw f32
//   never matters, and lo beside it in the same swizzle.
// - The A operand of a tile product is an accumulator (P^T, dS^T or dS):
//   a TF32 A fragment holds columns t, t + 4 of its row, the accumulator
//   columns 2t, 2t + 1, so the transposed copy lays the tile's rows in the
//   order tile_pos gives (row 2u + e of each 8 at position u + 4e), and
//   each accumulator splits into its hi and lo A fragments in registers.
// - An f32 row of 64 is 256 bytes, two 128-byte swizzle atoms: each tile is
//   two 32-column halves, one TMA box each (box 32 columns), and a k-step of
//   8 values (32 bytes) stays inside a half, whose descriptor is
//   wgmma_desc_sw128's (its leading byte offset is still not read).
// Roles: the producer warpgroup's first thread loads by TMA the block's
// resident operands once (Q and dO for kernel 2's 128 query rows, K and V
// for kernel 3's 128 keys: the A operands of the d products, 64 rows a
// consumer) and the streamed 32-row tiles (K and V, or Q and dO) into a
// ring of two stages; its warps 1-3 convert (tf::convert): the split of the
// resident operands once and of each stage as it lands (and, kernel 3, the
// stage's lse2 and delta rows, by plain loads), a tile ahead of the
// consumers. The consumers write each tile's transposed hi and lo copies
// (done by the three converter warps, the transposes set the pace of the
// tile loop, 5700 of its 8300 cycles), meeting at a named barrier before
// and after (consumers_meet): kernel 3's two share one copy of Q^T and
// dO^T, kernel 2's each write their own K^T, so they need not keep in step
// (one's transpose and probabilities run beside the other's products: 4%
// faster for kernel 2 at the 3D shape than one shared copy). Shared
// memory: resident 2 x 2 x 128 x 64 f32 (128 KB), two stages of 2 x 2 x 32
// x 64 (64 KB), the transposed tiles 4 x 64 x 32 (32 KB), the rows and
// barriers: 229952 bytes of the 232448 a block may take, which is what sets
// the 32-row tile (wgmma N = 32 for the d products) and kernel 3's one
// transposed copy. Registers set the consumers' A operands: the resident
// ones' hi and lo would take 128 registers a thread, so the d products read
// A from shared memory (wgmma_tf32_ss_n32) and the tile products from
// registers (wgmma_tf32_rs_n64, P and dS split in place). A consumer issues
// each 3xTF32 product as 3 chains (lo x hi over all k, then hi x lo, then hi
// x hi), from zero; per tile j the d products, then the tile products
// (kernel 2's dq part; kernel 3's dV part, then its dK part: one part
// accumulator between them, so that kernel 3's consumers need no more than
// 160 registers of accumulators and fragments), a group each (no branch
// between a product's issue and its wait; chip_smoke.py's phase 1 fails on
// ptxas's C7513 and C7514 notes, and on a stack frame or spills). The wgmma
// descriptors are moved by an opaque add where they are used (desc_at):
// hoisted out of the tile loop, those of the resident and transposed
// operands spilled kernel 3. Each tile's part is summed over the tile's 32
// keys or queries from zero and added in f32 to the running dq, dk or dv,
// as the other bodies do, so the sums over 32768 keys stay within f32
// summation error; no atomics, so two launches give the same bits. Rows
// past Sq or Sk read as 0 (TMA) and their p is 0 (tile_probs tests each
// pair only in a tile that reaches past Sq, Sk or the causal diagonal);
// under the causal mask kernel 3's q loop starts at its first key and
// kernel 2's key loop ends at its last row.
// Kernel 4 on the TF32 route (flash_bwd_fused_tf32_kernel): kernel 3's
// block, roles and consumer code (tf::dkv_consume, so its dk and dv have
// kernel 3's bits) and each 32-row q tile's dq part dS K over the block's
// 128 keys. TF32 has no transposed operand, so dq = dS K would need dS with
// 64 rows (a q tile has 32) or K^T in shared memory (64 KB in hi and lo,
// where 2.5 KB are free); transposing is what already sets the body's pace.
// So each consumer computes the part over its own 64 keys transposed, dq^T
// = K^T dS^T (m64n32k8, M the 64 columns of d): A = K^T, whose fragments
// are loaded from the resident K's hi and lo by scalar loads (a fragment's
// rows are columns of K: no transposed copy), B = the consumer's dS, rows by
// query, which it writes from its split dS^T fragments over its own half of
// the q tile's stage: the stage is read once the consumers meet after the
// probabilities, and its 32 KB are exactly both consumers' dS in hi and lo.
// Consumer 0 stages its part, rows by query, over its dS hi; consumer 1
// adds its own to it (named barrier 4) and counts the stage's dq barrier.
// The producer's first thread adds the staged part by TMA reductions (two
// 32-column boxes of 32 rows) in key-block order (wg's counters and groups,
// one counter per 32-row q tile) just before it loads the stage again (in
// one thread: a lone lane beside the loads in the same warp would spin
// beside them), frees the stage once the reductions have read it, and
// counts the block after the next load is issued. The upcast contract's
// instance loads K^T's fragments two k-steps at a time (more at once, its
// producer warpgroup spilled: ptxas assigns the registers of the values
// both roles keep, as the loop bounds, over the whole kernel).
//
// Kernels 2 and 3 on the TF32 route at D = 128 and 256 (namespace ts,
// flash_bwd_dq_stream_kernel and flash_bwd_dkv_stream_kernel, one template
// over the atoms of a row, kAtoms = D / 32 = 4 or 8; every contract; the 2D
// f32 recipe's attention at D = 256, ControlNet's at D = 128). The tf body
// does not scale to these widths: it keeps the resident operands in hi and
// lo, 256 KB at D = 128 and 512 KB at D = 256. What fits in the 232448
// bytes a block may take, with f32 at 4 D bytes a row and 8 D in hi and lo:
// - The resident side of a block is 64 rows (kernel 2: query rows, Q and
//   dO; kernel 3: keys, K and V), kept raw as TMA wrote them (64 KB at D =
//   128, 128 KB at D = 256). The consumers split their A fragments into hi
//   and lo in registers as they load them, each tile again.
// - The streamed side (kernel 2: K, V; kernel 3: Q, dO) comes in 32-row
//   tiles, each as atoms of 32 columns (one 128-byte swizzle row of f32,
//   one TMA box) through a ring of 16 KB stages. A whole tile in hi and lo
//   (64 KB an operand at D = 256) does not fit beside the resident rows, so
//   the d products are a k-loop over D, a stage an atom of each operand
//   (two atoms split by the converters, hi over the raw atoms and lo after
//   them), and the tile products load the tile's atoms a second time from
//   L2, a stage two 64-column slabs (four raw atoms). The stages are as
//   many as the rest leaves room for (Layout::kStagesN): 3-4 at D = 256,
//   7-8 at D = 128. At D = 128 a layout holding whole split tiles would
//   fit, but one template serves both widths: D = 128 streams as well.
// - No transposed copy (the tf body's converters spent most of a tile on
//   it): the tile products run transposed, dq^T = K^T dS^T (kernel 2) and
//   dV^T = dO^T P, dK^T = Q^T dS (kernel 3), so that the streamed tile is
//   the A operand, loaded from its raw atoms by ld.shared in the order the
//   fragment needs and split in registers, and B is P^T, dS or dS^T as the
//   consumers write them from their accumulators, K-major (a row of 32 f32
//   is one swizzle row). A fragment's k columns t and t + 4 read the tile's
//   rows 2t and 2t + 1 (the B buffers hold column c of the tile at
//   position tile_pos(c)), which also puts the eight rows a warp's lanes
//   read at once in eight distinct 16-byte chunks. Consumer c takes slab 2p
//   + c of each stage's pair p, N all 64 resident rows (m64n64): its
//   accumulators are D / 2 x 64, D / 128 m64n64 tiles an output.
// - Roles, a tile: consumer 0 computes x = S (or S^T) over d, consumer 1
//   dP (or dP^T), both m64n32 (A its resident operand, B the stage's split
//   atom); consumer 0 then p, into an exchange in shared memory and
//   (kernel 3) the P^T buffers, consumer 1 ds from it into the dS buffers
//   (named barriers 1-3: consumer 0 writes only once consumer 1 is done
//   with the last tile's); then both run the tile products, a slab a stage.
// - Registers: kernel 3's dV^T and dK^T take D / 2 f32 a thread (128 at D
//   = 256: setmaxnreg 224 / 56, as tf: 232 / 48 asks for more registers
//   than the launch holds, and setmaxnreg.inc then waits for ever), a
//   fragment set 32 (4 k-steps, hi and lo), a part 16 or 32. Loading and
//   splitting the next two k-steps' fragments while the last ones' products
//   run (a second set, one chain over all of d) spilled kernel 3 at D = 256
//   and gained little in kernel 2: not kept.
// - Rates (a microbenchmark on the H100): with two warpgroups issuing,
//   TF32 m64n32k8 from registers and m64n64k8 either way run at the tensor
//   cores' rate, m64n32k8 with A from shared memory below it, and so does
//   one warpgroup alone. The products are not what holds the body back: a
//   stage's loads, splits and waits are, since each consumer issues, waits
//   and then prepares the next.
// - The TF32 split: integer operations on the bits (round_tf32, the same
//   bits as cvt.rna.tf32.f32), for the consumers' fragments and the
//   converters' stages alike: with cvt.rna.tf32.f32 the conversions' rate
//   held the body back (timed side by side on the H100).
// - What bounds it: the operations are 0.6247 + 0.8330 ms at (64, 1024,
//   1024, 256) f32 (the H100's published 3xTF32 rate at 700 W); shared memory carries ~1 MB a tile of kernel 2 at D =
//   256 (the converters' split, the fragments' loads, the B operands),
//   about twice the tensor cores' 4.6K cycles at 128 bytes a cycle, and the
//   L2 reloads of the streamed tile (3 GB a launch of kernel 2, 4 GB of
//   kernel 3 there) stay under 2 TB/s. On the H100, leaving a stage's
//   work out in turn (the products, the splits) shows neither alone sets
//   the pace; the converters' split was on the critical path until each
//   thread loaded all its pieces before splitting any.
// - Sums: each d product is summed an atom at a time from zero (lo x hi
//   over the atom's 4 k-steps, then hi x lo, then hi x hi) and added in
//   f32; each tile part over the tile's 32 rows from zero, added in f32. No
//   atomics: two launches give the same bits. Edges as the other bodies:
//   rows past S read as 0 (TMA), p = 0 past Sq, Sk and the causal diagonal,
//   tested only in a tile that reaches them; the causal loop bounds of tf.
// Kernel 4 keeps dkv_block (mma.sync) at f32 D = 128 and 256, so its dk and
// dv there differ from kernel 3's in summation order (within the fused dq
// margin), not to the bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_sm90.cuh"
#include "flash_contract.cuh"

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

// p and ds of one (query, key) pair, p = 0 for a masked pair: kNoMax p =
// exp2(min(s, 80) - lse2), ds = p (dp - delta); kRunningMax the same without
// the clamp; kUpcast p = exp(s * sscale - lse), ds = sscale * p (dp - delta).
// prob and grad_s are its two halves (the TF32 body at D = 128 and 256
// computes them in different warpgroups)
template <int K>
__device__ __forceinline__ float prob(float s, float lse2, bool live, float sscale) {
  if constexpr (K == kUpcast) {
    return live ? expf(s * sscale - lse2) : 0.f;
  } else {
    return live ? exp2f((K == kNoMax ? fminf(s, 80.f) : s) - lse2) : 0.f;
  }
}
template <int K>
__device__ __forceinline__ float grad_s(float p, float dp, float delta, float sscale) {
  if constexpr (K == kUpcast) {
    return sscale * (p * (dp - delta));
  } else {
    return p * (dp - delta);
  }
}
template <int K>
__device__ __forceinline__ void prob_ds(float s, float dp, float lse2, float delta, bool live,
                                        float sscale, float& p, float& ds) {
  p = prob<K>(s, lse2, live, sscale);
  ds = grad_s<K>(p, dp, delta, sscale);
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
template <typename T, int D, int K>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse2,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    int num_qb, int causal, float sscale) {
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
            prob_ds<K>(s[n][2 * h + e], dp[n][2 * h + e], r_lse[h], r_delta[h], live, sscale, p,
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
template <typename T, int D, bool Fused, int K>
__device__ __forceinline__ void dkv_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    int sq, int sk, int num_kb, int causal, float sscale) {
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
          prob_ds<K>(s[n][2 * h + e], dp[n][2 * h + e], tLse[ql + e], tDelta[ql + e], live,
                     sscale, p[e], ds[e]);
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
      // dO arrived multiplied by ln2 for ds (not under kUpcast); dv must not carry it
      constexpr float kDvMul = K == kUpcast ? 1.f : kLog2e;
      store2(dv + off + 8 * n, acc_v[n][2 * h] * kDvMul, acc_v[n][2 * h + 1] * kDvMul);
    }
  }
}

// Kernel 3 and kernel 4: one signature, so that one launcher serves both.
template <typename T, int D, int K>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    int sq, int sk, int num_kb, int causal, float sscale) {
  dkv_block<T, D, false, K>(q, k, v, dout, lse2, delta, dk, dv, dq_acc, dq_lock, sq, sk, num_kb,
                            causal, sscale);
}

template <typename T, int D, int K>
__global__ void __launch_bounds__(kThreads) flash_bwd_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse2, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ dq_lock,
    int sq, int sk, int num_kb, int causal, float sscale) {
  dkv_block<T, D, true, K>(q, k, v, dout, lse2, delta, dk, dv, dq_acc, dq_lock, sq, sk, num_kb,
                           causal, sscale);
}

// ---- kernels 2 and 3 on the wgmma route (kRouteWgmma): bf16, D = 64 ----

namespace wg {

constexpr int kD = 64;                         // head width: one 128-byte swizzle row
constexpr int kRows = 64;                      // A rows of a consumer warpgroup (wgmma's M)
constexpr int kConsumers = 2;                  // consumer warpgroups a block
constexpr int kBlockRows = kConsumers * kRows;  // query rows (kernel 2) or keys (kernel 3) a block
constexpr int kTile = 64;                      // keys (kernel 2) or query rows (kernel 3) a stage
constexpr int kStages = 6;                     // the ring
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;  // arrivals that empty a stage
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kTileBytes = kTile * kD * 2;     // 8 KB: K or V (kernel 2), Q or dO (kernel 3)
constexpr int kRowBytes = kTile * 4;           // 256 B: lse2 or delta of a q tile (kernel 3)
constexpr int kDSteps = kD / 16;               // k-steps over d: S, dP (and S^T, dP^T)
constexpr int kTileSteps = kTile / 16;         // k-steps over a tile: dq (and dV, dK)
constexpr int kAcc = 32;                       // accumulator floats of an m64n64 tile
static_assert(kTile == 64 && kD == 64, "every product is m64n64k16");

constexpr int kKdqCols = kD / kConsumers;       // kernel 4: dq columns of a consumer
constexpr int kKdqBytes = kBlockRows * kKdqCols * 2;  // 8 KB: K's columns for one consumer's dq
constexpr int kDsBytes = kRows * kTile * 2;     // 8 KB: one consumer's dS^T of a q tile
constexpr int kDqAcc = kTile * kKdqCols / 128;  // accumulator floats of an m64n32 tile
constexpr int kDqStages = 4;                    // kernel 4: the dq parts' staging ring
constexpr int kDqHalfBytes = kTile * kKdqCols * 4;  // 8 KB: one consumer's f32 dq part

// dynamic shared memory from a 1024-byte-aligned base: kStages stages of two
// tiles (K, V or Q, dO), then kernels 3 and 4's lse2 and delta rows of each
// stage, then the full and empty mbarriers of each stage, kernel 4's K
// barrier and the full and empty mbarriers of its dq staging stages; kernel
// 4 adds, 1024-byte aligned, the block's K in two 64-byte swizzled halves of
// 32 columns (B of the dq parts), two buffers of the q tile's dS^T, both
// consumers' 64 keys each (A of the dq parts), and kDqStages stages of the
// q tile's f32 dq part, both consumers' 32 columns each in the 128-byte
// swizzle (what the TMA reductions read)
constexpr int kSmemRows = kStages * 2 * kTileBytes;
constexpr int kSmemBars = kSmemRows + kStages * 2 * kRowBytes;
constexpr int kSmemBarsEnd = kSmemBars + (2 * kStages + 1 + 2 * kDqStages) * 8;
constexpr int kSmemBytes = kSmemBarsEnd + 1024;  // + alignment
constexpr int kSmemKdq = (kSmemBarsEnd + 1023) / 1024 * 1024;
constexpr int kSmemDs = kSmemKdq + kConsumers * kKdqBytes;
constexpr int kSmemDq = kSmemDs + 2 * kConsumers * kDsBytes;
constexpr int kSmemFusedBytes = kSmemDq + kDqStages * kConsumers * kDqHalfBytes + 1024;
static_assert(kSmemFusedBytes <= 232448, "shared memory of one block");

struct Ring {
  unsigned char* base;  // 1024-byte aligned
  uint64_t* bars;

  __device__ unsigned char* first(int st) const { return base + st * 2 * kTileBytes; }
  __device__ unsigned char* second(int st) const { return first(st) + kTileBytes; }
  __device__ float* lse(int st) const {
    return reinterpret_cast<float*>(base + kSmemRows + st * 2 * kRowBytes);
  }
  __device__ float* delta(int st) const { return lse(st) + kTile; }
  __device__ uint64_t* full(int st) const { return bars + st; }
  __device__ uint64_t* empty(int st) const { return bars + kStages + st; }
  // kernel 4: the K halves' barrier, the half of consumer c, dS^T buffer b,
  // the dq part of staging stage b (and its barriers)
  __device__ uint64_t* kdq_full() const { return bars + 2 * kStages; }
  __device__ unsigned char* kdq(int c) const { return base + kSmemKdq + c * kKdqBytes; }
  __device__ unsigned char* ds(int b) const { return base + kSmemDs + b * kConsumers * kDsBytes; }
  __device__ unsigned char* dq(int b) const {
    return base + kSmemDq + b * kConsumers * kDqHalfBytes;
  }
  __device__ uint64_t* dq_full(int b) const { return bars + 2 * kStages + 1 + b; }
  __device__ uint64_t* dq_empty(int b) const { return bars + 2 * kStages + 1 + kDqStages + b; }
};

// the ring in this block's dynamic shared memory, its barriers initialised,
// `fills` arrivals filling a stage (the one __syncthreads of the kernels: the
// roles split after it)
__device__ __forceinline__ Ring make_ring(unsigned char* raw, int fills) {
  Ring r;
  r.base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  r.bars = reinterpret_cast<uint64_t*>(r.base + kSmemBars);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(r.full(st), fills);
      mbar_init(r.empty(st), kConsumerWarps);
    }
    mbar_init(r.kdq_full());
    for (int b = 0; b < kDqStages; ++b) {
      mbar_init(r.dq_full(b), kConsumerWarps);
      mbar_init(r.dq_empty(b));
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// a consumer warp's release of stage st (its wgmmas on the stage are done)
__device__ __forceinline__ void release(const Ring& r, int st) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(r.empty(st));
}

// the producer's wait before it refills the stage of load j
__device__ __forceinline__ int claim(const Ring& r, int j) {
  const int st = j % kStages;
  if (j >= kStages) mbar_wait(r.empty(st), (j / kStages - 1) & 1);
  return st;
}

// The A fragments (k-steps over d) of 64 rows of a (S, 64) bf16 head from
// device memory, this thread's rows row and row + 8 of its warp's 16 (rows
// at or past s read as 0): the mma.sync m16n8k16 A layout that a register
// operand of wgmma takes, loaded once per block
__device__ __forceinline__ void load_rows(uint32_t (&f)[kDSteps][4], const bf16* __restrict__ head,
                                          int row, int s) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < s;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        head + static_cast<size_t>(ok ? row + 8 * h : 0) * kD + 2 * t);
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      f[kk][h] = ok ? src[8 * kk] : 0u;         // columns 16 kk + 2t, + 1
      f[kk][h + 2] = ok ? src[8 * kk + 4] : 0u;  // columns + 8
    }
  }
}

// x = a b^T over d, from zero: A fragments from registers, B the 64-row
// tile at `tile` (K-major; kDSteps wgmmas)
__device__ __forceinline__ void products_over_d(float (&x)[kAcc], const uint32_t (&a)[kDSteps][4],
                                                const unsigned char* tile) {
  const uint64_t desc = wgmma_desc_sw128(smem_addr(tile));
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    wgmma_rs_n64<false>(x, a[kk], wgmma_desc_add(desc, 32 * kk), kk > 0);
  }
}

// x (+)= a b over a tile's 64 rows: A fragments from registers, B the tile
// at `tile` (MN-major; kTileSteps wgmmas); from_zero: x = a b
__device__ __forceinline__ void products_over_tile(float (&x)[kAcc],
                                                   const uint32_t (&a)[kTileSteps][4],
                                                   const unsigned char* tile, bool from_zero) {
  const uint64_t desc = wgmma_desc_sw128(smem_addr(tile));
#pragma unroll
  for (int js = 0; js < kTileSteps; ++js) {
    wgmma_rs_n64<true>(x, a[js], wgmma_desc_add(desc, 2048 * js), !(from_zero && js == 0));
  }
}

// this thread's rows row and row + 8 of an m64n64 f32 accumulator rounded
// to bf16 and stored at `out` (rows of 64), times `mul`; rows at or past s
// are not stored
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&x)[kAcc], int row,
                                           int s, float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= s) continue;
    bf16* dst = out + static_cast<size_t>(row + 8 * h) * kD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      store2(dst + 8 * nb, x[4 * nb + 2 * h] * mul, x[4 * nb + 2 * h + 1] * mul);
    }
  }
}

// p and ds of one (query, key) pair by prob_ds's formula in the exp2
// contracts, exp2 on the SFU (ex2.approx.ftz: within 2 ulp of exp2f, and 0
// below 2^-126, where a p of that size adds nothing to a bf16 product)
template <int K>
__device__ __forceinline__ void prob_ds_sfu(float s, float dp, float lse2, float delta, bool live,
                                            float& p, float& ds) {
  static_assert(K != kUpcast, "the wgmma route runs the exp2 contracts");
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"((K == kNoMax ? fminf(s, 80.f) : s) - lse2));
  p = live ? e : 0.f;
  ds = p * (dp - delta);
}

// ds of one K, V tile (keys from `key0`), rounded to bf16 pairs: the A
// fragments of dq's k-steps (this thread's rows row and row + 8); kMasked:
// some (row, key) pair of the warpgroup's tile is past sq, sk or the causal
// diagonal, so each pair is tested
template <int K, bool kMasked>
__device__ __forceinline__ void dq_ds(uint32_t (&df)[kTileSteps][4], const float (&s)[kAcc],
                                      const float (&dp)[kAcc], const float (&r_lse)[2],
                                      const float (&r_delta)[2], int row, int key0, int sq,
                                      int sk, int causal) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int js = 0; js < kTileSteps; ++js) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // row + 8 (e & 1), keys 16 js + 8 (e >> 1) + 2t, + 1
      const int h = e & 1;
      const int rq = row + 8 * h;
      const int key = key0 + 16 * js + 8 * (e >> 1) + 2 * t;
      float p, ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool live = !kMasked || (rq < sq && key + c < sk && (!causal || key + c <= rq));
        prob_ds_sfu<K>(s[8 * js + 2 * e + c], dp[8 * js + 2 * e + c], r_lse[h], r_delta[h], live,
                       p, ds[c]);
      }
      df[js][e] = pack_bf16(ds[0], ds[1]);
    }
  }
}

// dq_ds, masked where the warpgroup's tile (rows row0 .., keys key0 ..)
// reaches past sq, sk or the causal diagonal (a uniform branch: no product of
// the warpgroup is in flight)
template <int K>
__device__ __forceinline__ void dq_tile_ds(uint32_t (&df)[kTileSteps][4], const float (&s)[kAcc],
                                           const float (&dp)[kAcc], const float (&r_lse)[2],
                                           const float (&r_delta)[2], int row, int row0,
                                           int key0, int sq, int sk, int causal) {
  if (row0 + kRows > sq || key0 + kTile > sk || (causal && key0 + kTile - 1 > row0)) {
    dq_ds<K, true>(df, s, dp, r_lse, r_delta, row, key0, sq, sk, causal);
  } else {
    dq_ds<K, false>(df, s, dp, r_lse, r_delta, row, key0, sq, sk, causal);
  }
}

// Kernel 2's consumer warpgroup: its 64 query rows over every K, V tile.
// S and dP of tile j + 1 are issued with tile j's dq part in one group, so a
// tile costs one wait; the part is summed over the tile's keys from zero and
// then added in f32.
template <int K>
__device__ __forceinline__ void dq_consume(const Ring& r, const bf16* __restrict__ q,
                                           const bf16* __restrict__ dout,
                                           const float* __restrict__ lse2,
                                           const float* __restrict__ delta,
                                           bf16* __restrict__ dq, int row0, int sq, int sk,
                                           int tiles, int causal) {
  const int lane = threadIdx.x % 32;
  // this thread's rows row and row + 8 (C and A fragments alike)
  const int row = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  uint32_t qf[kDSteps][4], of[kDSteps][4];
  load_rows(qf, q, row, sq);
  load_rows(of, dout, row, sq);
  float r_lse[2], r_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < sq;
    r_lse[h] = ok ? lse2[row + 8 * h] : 0.f;
    r_delta[h] = ok ? delta[row + 8 * h] : 0.f;
  }
  float acc[kAcc], part[kAcc], s[kAcc], dp[kAcc];
  uint32_t df[kTileSteps][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;

  // tiles >= 1: a launch has sk >= 1, and the causal mask leaves key 0
  mbar_wait(r.full(0), 0);
  wgmma_fence();
  products_over_d(s, qf, r.first(0));   // S = Q K^T
  products_over_d(dp, of, r.second(0));  // dP = dO V^T
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  reg_fence(dp);
#pragma unroll 1
  for (int j = 0; j + 1 < tiles; ++j) {
    const int st = j % kStages;
    const int next = (j + 1) % kStages;
    dq_tile_ds<K>(df, s, dp, r_lse, r_delta, row, row0, j * kTile, sq, sk, causal);
    mbar_wait(r.full(next), ((j + 1) / kStages) & 1);
    wgmma_fence();
    products_over_tile(part, df, r.first(st), true);  // tile j's dq part dS K
    products_over_d(s, qf, r.first(next));
    products_over_d(dp, of, r.second(next));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(s);
    reg_fence(dp);
    release(r, st);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
  }
  const int last = tiles - 1;
  dq_tile_ds<K>(df, s, dp, r_lse, r_delta, row, row0, last * kTile, sq, sk, causal);
  wgmma_fence();
  products_over_tile(part, df, r.first(last % kStages), true);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(part);
  release(r, last % kStages);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
  store_rows(dq, acc, row, sq, 1.f);
}

// P^T and dS^T of one q tile (queries from q0; lse2 and delta rows from the
// stage), rounded to bf16 pairs: the A fragments of dV's and dK's k-steps
// over the tile's queries (this thread's keys key and key + 8); kMasked as
// dq_ds's
template <int K, bool kMasked>
__device__ __forceinline__ void dkv_probs(uint32_t (&pf)[kTileSteps][4],
                                          uint32_t (&sf)[kTileSteps][4], const float (&s)[kAcc],
                                          const float (&dp)[kAcc], const float* lse,
                                          const float* del, int key, int q0, int sq, int sk,
                                          int causal) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int js = 0; js < kTileSteps; ++js) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // key + 8 (e & 1), queries 16 js + 8 (e >> 1) + 2t, + 1
      const int kr = key + 8 * (e & 1);
      const int col = 16 * js + 8 * (e >> 1) + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
      const float2 dl = *reinterpret_cast<const float2*>(del + col);
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int rq = q0 + col + c;
        const bool live = !kMasked || (rq < sq && kr < sk && (!causal || kr <= rq));
        prob_ds_sfu<K>(s[8 * js + 2 * e + c], dp[8 * js + 2 * e + c], c ? l2.y : l2.x,
                       c ? dl.y : dl.x, live, p[c], ds[c]);
      }
      pf[js][e] = pack_bf16(p[0], p[1]);
      sf[js][e] = pack_bf16(ds[0], ds[1]);
    }
  }
}

// dkv_probs, masked where the warpgroup's tile (keys key0 .., queries q0 ..)
// reaches past sq, sk or the causal diagonal
template <int K>
__device__ __forceinline__ void dkv_tile_probs(uint32_t (&pf)[kTileSteps][4],
                                               uint32_t (&sf)[kTileSteps][4],
                                               const float (&s)[kAcc], const float (&dp)[kAcc],
                                               const float* lse, const float* del, int key,
                                               int key0, int q0, int sq, int sk, int causal) {
  if (q0 + kTile > sq || key0 + kRows > sk || (causal && key0 + kRows - 1 > q0)) {
    dkv_probs<K, true>(pf, sf, s, dp, lse, del, key, q0, sq, sk, causal);
  } else {
    dkv_probs<K, false>(pf, sf, s, dp, lse, del, key, q0, sq, sk, causal);
  }
}

// Kernel 3's consumer warpgroup: its 64 keys over every q tile. S^T and dP^T
// of tile j + 1 are issued with tile j's dV and dK products in one group.
template <int K>
__device__ __forceinline__ void dkv_consume(const Ring& r, const bf16* __restrict__ k,
                                            const bf16* __restrict__ v, bf16* __restrict__ dk,
                                            bf16* __restrict__ dv, int key0, int q_begin, int sq,
                                            int sk, int tiles, int causal) {
  const int lane = threadIdx.x % 32;
  // this thread's keys key and key + 8
  const int key = key0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  uint32_t kf[kDSteps][4], vf[kDSteps][4];
  load_rows(kf, k, key, sk);
  load_rows(vf, v, key, sk);
  float acc_k[kAcc], acc_v[kAcc], s[kAcc], dp[kAcc];
  uint32_t pf[kTileSteps][4], sf[kTileSteps][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (tiles > 0) {
    mbar_wait(r.full(0), 0);
    wgmma_fence();
    products_over_d(s, kf, r.first(0));   // S^T = K Q^T
    products_over_d(dp, vf, r.second(0));  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
#pragma unroll 1
    for (int j = 0; j + 1 < tiles; ++j) {
      const int st = j % kStages;
      const int next = (j + 1) % kStages;
      dkv_tile_probs<K>(pf, sf, s, dp, r.lse(st), r.delta(st), key, key0, q_begin + j * kTile, sq,
                        sk, causal);
      mbar_wait(r.full(next), ((j + 1) / kStages) & 1);
      wgmma_fence();
      products_over_tile(acc_v, pf, r.second(st), false);  // dV += P^T dO
      products_over_tile(acc_k, sf, r.first(st), false);   // dK += dS^T Q
      products_over_d(s, kf, r.first(next));
      products_over_d(dp, vf, r.second(next));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc_v);
      reg_fence(acc_k);
      reg_fence(s);
      reg_fence(dp);
      release(r, st);
    }
    const int last = tiles - 1;
    const int st = last % kStages;
    dkv_tile_probs<K>(pf, sf, s, dp, r.lse(st), r.delta(st), key, key0, q_begin + last * kTile, sq,
                      sk, causal);
    wgmma_fence();
    products_over_tile(acc_v, pf, r.second(st), false);
    products_over_tile(acc_k, sf, r.first(st), false);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc_v);
    reg_fence(acc_k);
    release(r, st);
  }
  store_rows(dk, acc_k, key, sk, 1.f);
  // dO arrived multiplied by ln2 for ds; dv must not carry it
  store_rows(dv, acc_v, key, sk, kLog2e);
}

// Kernel 4: this consumer's dS^T fragments (its 64 keys x the q tile's 64
// queries, bf16 pairs) into its tile of dS^T buffer `buf` as TMA would write
// a (64, 64) bf16 tile in the 128-byte swizzle, rows by key, then made
// visible to the wgmmas that read it as the MN-major A operand of dS K
__device__ __forceinline__ void store_ds(unsigned char* buf, const uint32_t (&sf)[kTileSteps][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  unsigned char* tile = buf + threadIdx.x / 128 * kDsBytes;
#pragma unroll
  for (int js = 0; js < kTileSteps; ++js) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // key + 8 (e & 1), queries 16 js + 8 (e >> 1) + 2t, + 1
      const int kl = (threadIdx.x % 128) / 32 * 16 + g + 8 * (e & 1);  // kl % 8 == g
      const int chunk = 2 * js + (e >> 1);  // the 16-byte chunk of the key's 128-byte row
      *reinterpret_cast<uint32_t*>(tile + kl * 128 + ((chunk ^ g) << 4) + 4 * t) = sf[js][e];
    }
  }
  fence_proxy_async();
}

// Kernel 4: the q tile's dq part dS K over the block's 128 keys, this
// consumer's 32 columns, from zero: A = dS^T of both consumers (`buf`,
// MN-major), B = the consumer's K half (MN-major, 64-byte swizzle)
__device__ __forceinline__ void dq_part(float (&x)[kDqAcc], const unsigned char* buf,
                                        const unsigned char* kdq) {
  const uint64_t a = wgmma_desc_sw128(smem_addr(buf));
  const uint64_t b = wgmma_desc_sw64(smem_addr(kdq));
#pragma unroll
  for (int js = 0; js < kBlockRows / 16; ++js) {
    wgmma_ss_n32_mn(x, wgmma_desc_add(a, 2048 * js), wgmma_desc_add(b, 1024 * js), js > 0);
  }
}

// Kernel 4: this consumer's dq part (its 32 columns of the q tile's 64
// rows, an m64n32 accumulator) into staging stage j % kDqStages, as TMA
// reads a (32, 64) f32 box in the 128-byte swizzle, once the reduction of
// the tile kDqStages before has read the stage; each warp then arrives on
// the stage's full barrier (its writes made visible to the TMA unit first)
__device__ __forceinline__ void stage_dq(const Ring& r, int j, const float (&x)[kDqAcc]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int b = j % kDqStages;
  if (j >= kDqStages) mbar_wait(r.dq_empty(b), (j / kDqStages - 1) & 1);
  unsigned char* half = r.dq(b) + threadIdx.x / 128 * kDqHalfBytes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (threadIdx.x % 128) / 32 * 16 + g + 8 * h;  // row % 8 == g
#pragma unroll
    for (int nb = 0; nb < kKdqCols / 8; ++nb) {  // columns 8 nb + 2t, + 1: chunk 2 nb + t / 2
      *reinterpret_cast<float2*>(half + row * 128 + (((2 * nb + t / 2) ^ g) << 4) + 8 * (t % 2)) =
          make_float2(x[4 * nb + 2 * h], x[4 * nb + 2 * h + 1]);
    }
  }
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(r.dq_full(b));
}

// Kernel 4's ordered adds, by one thread of the producer warpgroup for each
// q tile j of `tiles` with j % `step` == `first`: it waits until both
// consumers have staged the tile's dq part and until `lock` (the q tile's
// counter of this group's key blocks that have added their part) reads
// `ahead`, the key blocks of the group before this one; then adds the part
// into the f32 buffer of `dq_map` (coordinates (column, row, gbh)) by two
// TMA reductions, waits until they have completed, and counts the block.
// Rows past sq fall outside the map and are dropped.
__device__ __forceinline__ void reduce_dq(const Ring& r, const CUtensorMap* dq_map,
                                          int* __restrict__ locks, int ahead, int gbh,
                                          int q_begin, int tiles, int first, int step) {
  for (int j = first; j < tiles; j += step) {
    const int b = j % kDqStages;
    const int q0 = q_begin + j * kTile;
    int* lock = locks + q0 / kTile;
    mbar_wait(r.dq_full(b), (j / kDqStages) & 1);
    while (ld_acquire(lock) < ahead) __nanosleep(32);
    fence_proxy_async_global();  // the reductions come after the blocks before
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
      tma_reduce_add_3d(dq_map, r.dq(b) + c * kDqHalfBytes, c * kKdqCols, q0, gbh);
    }
    bulk_commit();
    bulk_wait<0>();
    fence_proxy_async_global();  // the completed reductions come before the count
    __threadfence();
    atomicAdd(lock, 1);
    mbar_arrive(r.dq_empty(b));
  }
}

// Kernel 4's consumer warpgroup: kernel 3's (its 64 keys over every q tile,
// the same dV and dK products in the same order, so dk and dv have kernel
// 3's bits) and each q tile's dq part. Per tile the two consumers write
// their dS^T to the tile's buffer and meet at named barrier 1; each then
// issues the tile's dV, dK and dq part and the next tile's S^T and dP^T in
// one group, waits once, and stages its dq columns for reduce_dq.
template <int K>
__device__ __forceinline__ void fused_consume(const Ring& r, const bf16* __restrict__ k,
                                              const bf16* __restrict__ v, bf16* __restrict__ dk,
                                              bf16* __restrict__ dv, int key0, int q_begin,
                                              int sq, int sk, int tiles, int causal) {
  const int lane = threadIdx.x % 32;
  const int c = threadIdx.x / 128;
  // this thread's keys key and key + 8
  const int key = key0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  uint32_t kf[kDSteps][4], vf[kDSteps][4];
  load_rows(kf, k, key, sk);
  load_rows(vf, v, key, sk);
  float acc_k[kAcc], acc_v[kAcc], s[kAcc], dp[kAcc], part[kDqAcc];
  uint32_t pf[kTileSteps][4], sf[kTileSteps][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (tiles > 0) {
    const unsigned char* kdq = r.kdq(c);
    mbar_wait(r.kdq_full(), 0);
    mbar_wait(r.full(0), 0);
    wgmma_fence();
    products_over_d(s, kf, r.first(0));   // S^T = K Q^T
    products_over_d(dp, vf, r.second(0));  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
#pragma unroll 1
    for (int j = 0; j + 1 < tiles; ++j) {
      const int st = j % kStages;
      const int next = (j + 1) % kStages;
      dkv_tile_probs<K>(pf, sf, s, dp, r.lse(st), r.delta(st), key, key0, q_begin + j * kTile, sq,
                        sk, causal);
      store_ds(r.ds(j & 1), sf);
      named_sync(1, kConsumerThreads);  // both halves of dS^T are in
      mbar_wait(r.full(next), ((j + 1) / kStages) & 1);
      wgmma_fence();
      products_over_tile(acc_v, pf, r.second(st), false);  // dV += P^T dO
      products_over_tile(acc_k, sf, r.first(st), false);   // dK += dS^T Q
      dq_part(part, r.ds(j & 1), kdq);                      // dS K
      products_over_d(s, kf, r.first(next));
      products_over_d(dp, vf, r.second(next));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc_v);
      reg_fence(acc_k);
      reg_fence(part);
      reg_fence(s);
      reg_fence(dp);
      release(r, st);
      stage_dq(r, j, part);
    }
    const int last = tiles - 1;
    const int st = last % kStages;
    dkv_tile_probs<K>(pf, sf, s, dp, r.lse(st), r.delta(st), key, key0, q_begin + last * kTile,
                      sq, sk, causal);
    store_ds(r.ds(last & 1), sf);
    named_sync(1, kConsumerThreads);
    wgmma_fence();
    products_over_tile(acc_v, pf, r.second(st), false);
    products_over_tile(acc_k, sf, r.first(st), false);
    dq_part(part, r.ds(last & 1), kdq);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc_v);
    reg_fence(acc_k);
    reg_fence(part);
    release(r, st);
    stage_dq(r, last, part);
  }
  store_rows(dk, acc_k, key, sk, 1.f);
  // dO arrived multiplied by ln2 for ds; dv must not carry it
  store_rows(dv, acc_v, key, sk, kLog2e);
}

}  // namespace wg

// Kernel 2 on the wgmma route. Grid: one block per (bh, wg::kBlockRows query
// rows), flattened into blockIdx.x; wg::kThreads threads, wg::kSmemBytes of
// dynamic shared memory. Warpgroups 0 and 1 consume, 2 produces: its first
// thread loads the K and V tiles by TMA (maps of (64, sk, bh), box 64 keys).
template <int K>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const bf16* __restrict__ q,
                          const bf16* __restrict__ dout, const float* __restrict__ lse2,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int sq, int sk,
                          int num_qb, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const wg::Ring r = wg::make_ring(smem_raw, 1);
  const int bh = blockIdx.x / num_qb;
  const int q0 = (blockIdx.x % num_qb) * wg::kBlockRows;
  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, q0 + wg::kBlockRows) : sk;
  const int tiles = (kv_end + wg::kTile - 1) / wg::kTile;
  if (threadIdx.x >= wg::kConsumerThreads) {
    regs_lower<wg::kProducerRegs>();
    if (threadIdx.x != wg::kConsumerThreads) return;
    for (int j = 0; j < tiles; ++j) {
      const int st = wg::claim(r, j);
      mbar_expect(r.full(st), 2 * wg::kTileBytes);
      tma_load_3d(r.first(st), &k_map, r.full(st), 0, j * wg::kTile, bh);
      tma_load_3d(r.second(st), &v_map, r.full(st), 0, j * wg::kTile, bh);
    }
  } else {
    regs_raise<wg::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sq;
    wg::dq_consume<K>(r, q + head * wg::kD, dout + head * wg::kD, lse2 + head, delta + head,
                      dq + head * wg::kD, q0 + threadIdx.x / 128 * wg::kRows, sq, sk, tiles,
                      causal);
  }
}

namespace wg {

// The producer warpgroup of kernels 3 and 4 after its first thread's other
// loads: that thread loads each q tile's Q and dO rows by TMA (maps of (64,
// sq, bh), box 64 rows); its second warp copies the tile's lse2 and delta
// rows (0 past sq) with plain loads and stores, since a head's f32 rows start
// at any 4-byte offset and TMA reads a box from 16-byte aligned addresses.
// Two arrivals fill a stage: the TMA thread's, counting the bytes, and the
// warp's after its stores.
__device__ __forceinline__ void produce_q_tiles(const Ring& r, const CUtensorMap* q_map,
                                                const CUtensorMap* do_map,
                                                const float* __restrict__ lse2,
                                                const float* __restrict__ delta, int bh, int sq,
                                                int q_begin, int tiles) {
  const int pt = threadIdx.x - kConsumerThreads;
  if (pt == 0) {
    for (int j = 0; j < tiles; ++j) {
      const int st = claim(r, j);
      const int q0 = q_begin + j * kTile;
      mbar_expect(r.full(st), 2 * kTileBytes);
      tma_load_3d(r.first(st), q_map, r.full(st), 0, q0, bh);
      tma_load_3d(r.second(st), do_map, r.full(st), 0, q0, bh);
    }
  } else if (pt / 32 == 1) {
    const int lane = pt % 32;
    const float* lb = lse2 + static_cast<size_t>(bh) * sq;
    const float* db = delta + static_cast<size_t>(bh) * sq;
    for (int j = 0; j < tiles; ++j) {
      const int st = claim(r, j);
      const int q0 = q_begin + j * kTile;
#pragma unroll
      for (int i = lane; i < kTile; i += 32) {
        const bool ok = q0 + i < sq;
        r.lse(st)[i] = ok ? lb[q0 + i] : 0.f;
        r.delta(st)[i] = ok ? db[q0 + i] : 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(r.full(st));
    }
  }
}

}  // namespace wg

// Kernel 3 on the wgmma route. Grid: one block per (bh, wg::kBlockRows keys),
// flattened into blockIdx.x; threads, shared memory and roles as kernel 2's;
// the producer runs produce_q_tiles.
template <int K>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const float* __restrict__ lse2, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                           int num_kb, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const wg::Ring r = wg::make_ring(smem_raw, 2);
  const int bh = blockIdx.x / num_kb;
  const int k0 = (blockIdx.x % num_kb) * wg::kBlockRows;
  // under the causal mask, query rows before the block's first key are dead
  // (k0 is a multiple of the q tile)
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + wg::kTile - 1) / wg::kTile : 0;
  if (threadIdx.x >= wg::kConsumerThreads) {
    regs_lower<wg::kProducerRegs>();
    wg::produce_q_tiles(r, &q_map, &do_map, lse2, delta, bh, sq, q_begin, tiles);
  } else {
    regs_raise<wg::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sk * wg::kD;
    wg::dkv_consume<K>(r, k + head, v + head, dk + head, dv + head,
                       k0 + threadIdx.x / 128 * wg::kRows, q_begin, sq, sk, tiles, causal);
  }
}

// Kernel 4 on the wgmma route. Grid, threads and roles as kernel 3's, with
// wg::kSmemFusedBytes of dynamic shared memory; the producer's first thread
// first loads the block's K by TMA in two 32-column halves (a map of (64,
// sk, bh), box 32 columns x 128 keys in the 64-byte swizzle), and its third
// and fourth warps' first threads add the staged dq parts of the even and
// the odd q tiles (reduce_dq). The key blocks of a head fall into `groups`
// interleaved groups (key block kb in group kb % groups), each with its own
// f32 dq buffer (the map `dq_map` of the caller's zeroed (groups, bh, sq,
// 64) buffer seen as (64, sq, groups * bh), box 32 columns x 64 rows in the
// 128-byte swizzle) and its own counters, dq_lock, int (groups, bh, ceil(sq
// / 64)), zeroed by the caller, who sums the groups' buffers in a fixed
// order: a group's key blocks add their dq parts into its buffer in key
// block order. Groups shorten the chains of blocks that wait on one another
// (each link costs a reduction's trip to L2 and back).
template <int K>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_fused_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const __grid_constant__ CUtensorMap kdq_map,
                             const __grid_constant__ CUtensorMap dq_map,
                             const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const float* __restrict__ lse2, const float* __restrict__ delta,
                             int* __restrict__ dq_lock, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int sq, int sk, int num_kb, int causal,
                             int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const wg::Ring r = wg::make_ring(smem_raw, 2);
  const int bh = blockIdx.x / num_kb;
  const int kbi = blockIdx.x % num_kb;
  const int k0 = kbi * wg::kBlockRows;
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + wg::kTile - 1) / wg::kTile : 0;
  const int q_tiles = (sq + wg::kTile - 1) / wg::kTile;
  // this block's dq buffer and counters: its group's, and in them its head's
  const int gbh = kbi % groups * (gridDim.x / num_kb) + bh;
  if (threadIdx.x >= wg::kConsumerThreads) {
    regs_lower<wg::kProducerRegs>();
    const int pt = threadIdx.x - wg::kConsumerThreads;
    if (pt == 0 && tiles > 0) {
      mbar_expect(r.kdq_full(), wg::kConsumers * wg::kKdqBytes);
      for (int c = 0; c < wg::kConsumers; ++c) {
        tma_load_3d(r.kdq(c), &kdq_map, r.kdq_full(), c * wg::kKdqCols, k0, bh);
      }
    }
    wg::produce_q_tiles(r, &q_map, &do_map, lse2, delta, bh, sq, q_begin, tiles);
    if (pt % 32 == 0 && pt / 32 >= 2) {  // a block waits for the blocks of its group before it
      wg::reduce_dq(r, &dq_map, dq_lock + static_cast<size_t>(gbh) * q_tiles, kbi / groups, gbh,
                    q_begin, tiles, pt / 32 - 2, 2);
    }
  } else {
    regs_raise<wg::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sk * wg::kD;
    wg::fused_consume<K>(r, k + head, v + head, dk + head, dv + head,
                         k0 + threadIdx.x / 128 * wg::kRows, q_begin, sq, sk, tiles, causal);
  }
}

// ---- kernels 2 and 3 on the TF32 wgmma route (kRouteTf32): f32, D = 64 ----

namespace tf {

constexpr int kD = 64;                          // head width: two 128-byte swizzle rows
constexpr int kRows = 64;                       // A rows of a consumer warpgroup (wgmma's M)
constexpr int kConsumers = 2;                   // consumer warpgroups a block
constexpr int kBlockRows = kConsumers * kRows;  // query rows (kernel 2) or keys (kernel 3) a block
constexpr int kTile = 32;                       // keys (kernel 2) or query rows (kernel 3) a stage
constexpr int kStages = 2;                      // streamed tiles in flight
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kConverterWarps = 3;              // the producer warpgroup's warps 1-3
constexpr int kConverterThreads = 32 * kConverterWarps;
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;  // the converters' loops spilled at 40
constexpr int kHalfCols = 32;                   // f32 columns of a 128-byte swizzle row
constexpr int kDSteps = kD / 8;                 // k8 steps over d: S, dP (and S^T, dP^T)
constexpr int kTileSteps = kTile / 8;           // k8 steps over a tile: dq (and dV, dK)
constexpr int kSAcc = kTile / 2;                // accumulator floats of an m64n32 tile
constexpr int kAcc = kD / 2;                    // accumulator floats of an m64n64 tile
constexpr int kResHalf = kBlockRows * 128;      // 16 KB: 32 columns of the block's rows
constexpr int kResPart = 2 * kResHalf;          // 32 KB: hi or lo of one resident operand
constexpr int kNatHalf = kTile * 128;           // 4 KB: 32 columns of a streamed tile
constexpr int kNatPart = 2 * kNatHalf;          // 8 KB: hi or lo of one streamed tile
constexpr int kTPart = kD * kTile * 4;          // 8 KB: hi or lo of one transposed tile
constexpr int kStageBytes = 4 * kNatPart;       // two tiles, hi and lo
static_assert(kTile == kHalfCols, "a transposed tile row is one 128-byte swizzle row");

// dynamic shared memory from a 1024-byte-aligned base: the two resident
// operands (Q and dO, or K and V: the A operands of the d products) hi then
// lo, kStages stages of the two streamed tiles (K and V, or Q and dO: B of
// the d products) hi then lo, the transposed tiles (each consumer's K^T; or
// Q^T and dO^T: B of the tile products) hi and lo, kernels 3 and 4's lse2
// and delta rows of each stage, then the mbarriers (kernel 4's dq barriers
// last)
constexpr int kSmemNat = 4 * kResPart;
constexpr int kSmemT = kSmemNat + kStages * kStageBytes;
constexpr int kSmemRows = kSmemT + 4 * kTPart;
constexpr int kSmemBars = kSmemRows + kStages * 2 * kTile * 4;
constexpr int kBars = 4 * kStages + 2;
constexpr int kSmemBytes = kSmemBars + kBars * 8 + 1024;  // + alignment
static_assert(kSmemBytes <= 232448, "shared memory of one block");

struct Smem {
  unsigned char* base;  // 1024-byte aligned
  uint64_t* bars;

  // resident operand o, part 0 (hi: where TMA wrote the raw tile) or 1 (lo)
  __device__ unsigned char* res(int o, int part) const { return base + (2 * part + o) * kResPart; }
  // streamed tile o of stage st, part as res's
  __device__ unsigned char* nat(int st, int o, int part) const {
    return base + kSmemNat + st * kStageBytes + (2 * part + o) * kNatPart;
  }
  // transposed tile o (kernel 2: the consumer's own K^T), part 0 (hi) or 1 (lo)
  __device__ unsigned char* tr(int o, int part) const {
    return base + kSmemT + (2 * o + part) * kTPart;
  }
  __device__ float* lse(int st) const {
    return reinterpret_cast<float*>(base + kSmemRows) + st * 2 * kTile;
  }
  __device__ float* delta(int st) const { return lse(st) + kTile; }
  // a stage's raw tiles are in (TMA), split (converters), free again
  // (consumers)
  __device__ uint64_t* full(int st) const { return bars + st; }
  __device__ uint64_t* ready(int st) const { return bars + kStages + st; }
  __device__ uint64_t* empty(int st) const { return bars + 2 * kStages + st; }
  // the resident operands are in (TMA), split
  __device__ uint64_t* res_full() const { return bars + 3 * kStages; }
  __device__ uint64_t* res_ready() const { return bars + 3 * kStages + 1; }
  // kernel 4: stage st's q tile's dq part is staged (both consumers' keys)
  __device__ uint64_t* dq_full(int st) const { return bars + 3 * kStages + 2 + st; }
};

// the layout in this block's dynamic shared memory, its barriers
// initialised (the one __syncthreads of the kernels: the roles split after
// it); a stage is freed by the consumers' warps, or (kernel 4, `fused`) by
// its reducer once it has read the stage's dq part
__device__ __forceinline__ Smem make_smem(unsigned char* raw, bool fused = false) {
  Smem m;
  m.base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  m.bars = reinterpret_cast<uint64_t*>(m.base + kSmemBars);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(m.full(st));
      mbar_init(m.ready(st), kConverterWarps);
      mbar_init(m.empty(st), fused ? 1 : kConsumerWarps);
      mbar_init(m.dq_full(st), kConsumerWarps / kConsumers);
    }
    mbar_init(m.res_full());
    mbar_init(m.res_ready(), kConverterWarps);
    mbar_fence_init();
  }
  __syncthreads();
  return m;
}

struct NoHook {
  __device__ void operator()(int) const {}
};

// The producer warpgroup's first thread: the block's two resident operands
// (maps res0, res1 of (64, rows, bh), box 32 columns x kBlockRows rows from
// row res_row) once, then the two streamed tiles of each stage (maps nat0,
// nat1, box 32 columns x kTile rows from row nat_row + j kTile), each as
// two 32-column halves, rows past the tensor's read as 0; before and after
// the loads of tile j it runs `before(j)` and `after(j)` (kernel 4: the
// reductions of tile j - kStages, whose stage it frees)
template <class Before = NoHook, class After = NoHook>
__device__ __forceinline__ void produce(const Smem& m, const CUtensorMap* res0,
                                        const CUtensorMap* res1, const CUtensorMap* nat0,
                                        const CUtensorMap* nat1, int bh, int res_row,
                                        int nat_row, int tiles, Before before = {},
                                        After after = {}) {
  if (tiles == 0) return;
  mbar_expect(m.res_full(), 4 * kResHalf);
  for (int h = 0; h < 2; ++h) {
    tma_load_3d(m.res(0, 0) + h * kResHalf, res0, m.res_full(), h * kHalfCols, res_row, bh);
    tma_load_3d(m.res(1, 0) + h * kResHalf, res1, m.res_full(), h * kHalfCols, res_row, bh);
  }
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    before(j);
    if (j >= kStages) mbar_wait(m.empty(st), (j / kStages - 1) & 1);
    mbar_expect(m.full(st), 4 * kNatHalf);
    const int row = nat_row + j * kTile;
    for (int h = 0; h < 2; ++h) {
      tma_load_3d(m.nat(st, 0, 0) + h * kNatHalf, nat0, m.full(st), h * kHalfCols, row, bh);
      tma_load_3d(m.nat(st, 1, 0) + h * kNatHalf, nat1, m.full(st), h * kHalfCols, row, bh);
    }
    after(j);
  }
}

// The TF32 split of kBytes of f32 values at `hi`: hi = tf32(x) in place and
// lo = tf32(x - hi) at the same offset from `lo` (both keep the swizzle TMA
// wrote, so the wgmma descriptors read them alike); 16 bytes a step, this
// converter thread's share
template <int kBytes>
__device__ __forceinline__ void split_in_place(unsigned char* hi, unsigned char* lo, int ct) {
  for (int o = 16 * ct; o < kBytes; o += 16 * kConverterThreads) {
    const float4 x = *reinterpret_cast<const float4*>(hi + o);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// the position of row l of a streamed tile along the k of the tile
// products: in each 8-row group, row 2u + e at u + 4e, so that the TF32 A
// fragment built from an accumulator (columns 2t, 2t + 1 of each n8 block:
// positions t and t + 4) meets the right B rows
__device__ __forceinline__ int tile_pos(int l) {
  return (l & ~7) | ((l & 1) << 2) | ((l >> 1) & 3);
}

// A streamed tile's `kOps` operands, hi and lo parts (kTile rows x 64
// columns each, two 32-column halves in the 128-byte swizzle), transposed
// by the consumers: column n of operand o's part to row n of m.tr(o, part)
// (64 rows of kTile positions, one swizzle row each), row l at position
// tile_pos(l): K-major for the tile products. kOwn (kernel 2, one operand):
// each consumer writes its own copy, m.tr(consumer, part), with its four
// warps; else both consumers' eight warps write one. An item is 4 columns
// of one part, a lane a row (the 32 stores of a column fill one swizzle
// row, in distinct banks); warp w of the writers takes items w, w + warps,
// ..., all loads first, then the stores, in straight-line code
template <int kOps, bool kOwn>
__device__ __forceinline__ void transpose_tile(const Smem& m, int st) {
  constexpr int kWarps = kOwn ? kConsumerWarps / kConsumers : kConsumerWarps;
  constexpr int kPer = kOps * 2 * 16 / kWarps;  // items a warp
  const int cw = threadIdx.x / 32 % kWarps;
  const int lane = threadIdx.x % 32;
  const int p = tile_pos(lane);
  float4 x[kPer];
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int item = cw + kWarps * b;
    const int cg = item % 16;  // the 4-column group, chunk cg % 8 of half cg / 8
    x[b] = *reinterpret_cast<const float4*>(m.nat(st, item / 32, item / 16 % 2) +
                                            cg / 8 * kNatHalf + lane * 128 +
                                            (((cg % 8) ^ (lane & 7)) << 4));
  }
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int item = cw + kWarps * b;
    unsigned char* dst = m.tr(kOwn ? threadIdx.x / 128 : item / 32, item / 16 % 2);
    const float v[4] = {x[b].x, x[b].y, x[b].z, x[b].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * (item % 16) + j;
      *reinterpret_cast<float*>(dst + n * 128 + (((p >> 2) ^ (n & 7)) << 4) + 4 * (p & 3)) = v[j];
    }
  }
  fence_proxy_async();
}

// The converters (the producer warpgroup's warps 1-3): the resident
// operands' split once, then each streamed tile's as TMA lands it (and,
// kernel 3, its lse2 and delta rows, 0 past sq, by plain loads: a head's
// f32 rows start at any 4-byte offset, where TMA needs 16-byte aligned
// addresses), a tile ahead of the consumers.
template <bool kRowsToo>
__device__ __forceinline__ void convert(const Smem& m, int tiles, const float* __restrict__ lse2,
                                        const float* __restrict__ delta, int q_begin, int sq) {
  if (tiles == 0) return;
  const int ct = threadIdx.x - kConsumerThreads - 32;
  mbar_wait(m.res_full(), 0);
  split_in_place<2 * kResPart>(m.res(0, 0), m.res(0, 1), ct);
  fence_proxy_async();
  warp_arrive(m.res_ready());
  auto split_tile = [&](int j) {
    const int st = j % kStages;
    // kernel 3: the tile's lse2 or delta row of this thread, loaded first
    // (its latency under the split)
    const int row = q_begin + j * kTile + ct % kTile;
    const float row_value = kRowsToo && ct < 2 * kTile && row < sq
                                ? (ct < kTile ? lse2 : delta)[row]
                                : 0.f;
    mbar_wait(m.full(st), (j / kStages) & 1);
    split_in_place<2 * kNatPart>(m.nat(st, 0, 0), m.nat(st, 0, 1), ct);
    if (kRowsToo && ct < 2 * kTile) (ct < kTile ? m.lse(st) : m.delta(st))[ct % kTile] = row_value;
    fence_proxy_async();
    warp_arrive(m.ready(st));
  };
  for (int j = 0; j < tiles; ++j) split_tile(j);
}

// x = a b^T over d, from zero, in 3xTF32: A the consumer's 64 rows of a
// resident operand (a_hi, a_lo: its rows in the first 32-column half), B a
// streamed tile (b_hi, b_lo); the lo x hi products over all of d, then hi x
// lo, then hi x hi (the small terms summed first)
__device__ __forceinline__ void products_over_d(float (&x)[kSAcc], const unsigned char* a_hi,
                                                const unsigned char* a_lo,
                                                const unsigned char* b_hi,
                                                const unsigned char* b_lo) {
  const uint64_t ah = wgmma_desc_sw128(smem_addr(a_hi));
  const uint64_t al = wgmma_desc_sw128(smem_addr(a_lo));
  const uint64_t bh = wgmma_desc_sw128(smem_addr(b_hi));
  const uint64_t bl = wgmma_desc_sw128(smem_addr(b_lo));
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    wgmma_tf32_ss_n32(x, desc_at(al, kk / 4 * kResHalf + 32 * (kk % 4)),
                      desc_at(bh, kk / 4 * kNatHalf + 32 * (kk % 4)), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    wgmma_tf32_ss_n32(x, desc_at(ah, kk / 4 * kResHalf + 32 * (kk % 4)),
                      desc_at(bl, kk / 4 * kNatHalf + 32 * (kk % 4)), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    wgmma_tf32_ss_n32(x, desc_at(ah, kk / 4 * kResHalf + 32 * (kk % 4)),
                      desc_at(bh, kk / 4 * kNatHalf + 32 * (kk % 4)), 1);
  }
}

// x = a b over a tile, from zero, in 3xTF32: A fragments (hi, lo) from
// registers, B a transposed tile (b_hi, b_lo); in the order of
// products_over_d
__device__ __forceinline__ void products_over_tile(float (&x)[kAcc],
                                                   const uint32_t (&a_hi)[kTileSteps][4],
                                                   const uint32_t (&a_lo)[kTileSteps][4],
                                                   const unsigned char* b_hi,
                                                   const unsigned char* b_lo) {
  const uint64_t bh = wgmma_desc_sw128(smem_addr(b_hi));
  const uint64_t bl = wgmma_desc_sw128(smem_addr(b_lo));
#pragma unroll
  for (int js = 0; js < kTileSteps; ++js) {
    wgmma_tf32_rs_n64(x, a_lo[js], desc_at(bh, 32 * js), js > 0);
  }
#pragma unroll
  for (int js = 0; js < kTileSteps; ++js) {
    wgmma_tf32_rs_n64(x, a_hi[js], desc_at(bl, 32 * js), 1);
  }
#pragma unroll
  for (int js = 0; js < kTileSteps; ++js) {
    wgmma_tf32_rs_n64(x, a_hi[js], desc_at(bh, 32 * js), 1);
  }
}

// this thread's rows row and row + 8 of an m64n64 f32 accumulator times
// `mul` at `out` (rows of 64); rows at or past s are not stored
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float (&x)[kAcc], int row,
                                           int s, float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= s) continue;
    float* dst = out + static_cast<size_t>(row + 8 * h) * kD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      store2(dst + 8 * nb, x[4 * nb + 2 * h] * mul, x[4 * nb + 2 * h + 1] * mul);
    }
  }
}

// p and ds of an m64n32 accumulator pair by prob_ds (the mma.sync body's
// arithmetic), split into TF32 hi and lo A fragments of the tile products:
// element (A row a + 8h, column 8i + 2t + e) of s, dp goes to register 2e +
// h of k-step i (column t + 4e of the fragment, tile_pos of that column).
// The A rows are queries (kernel 2: `qrow(h)`, lse2 and delta from r_*) or
// keys (kernel 3: lse2 and delta of the columns from shared memory); `live`
// masks a pair, tested only under kMasked
template <int K, bool kKeyMajor, bool kMasked>
__device__ __forceinline__ void tile_probs(uint32_t (&ph)[kTileSteps][4],
                                           uint32_t (&pl)[kTileSteps][4],
                                           uint32_t (&sh)[kTileSteps][4],
                                           uint32_t (&sl)[kTileSteps][4], const float (&s)[kSAcc],
                                           const float (&dp)[kSAcc], const float* lse,
                                           const float* del, const float (&r_lse)[2],
                                           const float (&r_delta)[2], int arow, int col0, int sq,
                                           int sk, int causal, float sscale) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < kTileSteps; ++i) {
    // kernel 3: the lse2 and delta of the thread's columns 8i + 2t, + 1
    float2 l2 = {0.f, 0.f}, dl = {0.f, 0.f};
    if constexpr (kKeyMajor) {
      l2 = *reinterpret_cast<const float2*>(lse + 8 * i + 2 * t);
      dl = *reinterpret_cast<const float2*>(del + 8 * i + 2 * t);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * i + 2 * t + e;  // the column in the tile
        const int a = arow + 8 * h;
        const int row = kKeyMajor ? col0 + cl : a;  // query
        const int key = kKeyMajor ? a : col0 + cl;
        const bool live = !kMasked || (row < sq && key < sk && (!causal || key <= row));
        float p, ds;
        prob_ds<K>(s[4 * i + 2 * h + e], dp[4 * i + 2 * h + e],
                   kKeyMajor ? (e ? l2.y : l2.x) : r_lse[h],
                   kKeyMajor ? (e ? dl.y : dl.x) : r_delta[h], live, sscale, p, ds);
        if constexpr (kKeyMajor) split_tf32(p, ph[i][2 * e + h], pl[i][2 * e + h]);
        split_tf32(ds, sh[i][2 * e + h], sl[i][2 * e + h]);
      }
    }
  }
}

// tile_probs, masked where the warpgroup's tile (A rows a0 .., columns col0
// ..) reaches past sq, sk or the causal diagonal (a uniform branch: no
// product of the warpgroup is in flight)
template <int K, bool kKeyMajor>
__device__ __forceinline__ void tile_probs_at(uint32_t (&ph)[kTileSteps][4],
                                              uint32_t (&pl)[kTileSteps][4],
                                              uint32_t (&sh)[kTileSteps][4],
                                              uint32_t (&sl)[kTileSteps][4],
                                              const float (&s)[kSAcc], const float (&dp)[kSAcc],
                                              const float* lse, const float* del,
                                              const float (&r_lse)[2], const float (&r_delta)[2],
                                              int arow, int a0, int col0, int sq, int sk,
                                              int causal, float sscale) {
  const int q_end = kKeyMajor ? col0 + kTile : a0 + kRows;  // past the last query
  const int k_end = kKeyMajor ? a0 + kRows : col0 + kTile;  // past the last key
  const int q_first = kKeyMajor ? col0 : a0;
  if (q_end > sq || k_end > sk || (causal && k_end - 1 > q_first)) {
    tile_probs<K, kKeyMajor, true>(ph, pl, sh, sl, s, dp, lse, del, r_lse, r_delta, arow, col0, sq,
                                   sk, causal, sscale);
  } else {
    tile_probs<K, kKeyMajor, false>(ph, pl, sh, sl, s, dp, lse, del, r_lse, r_delta, arow, col0,
                                    sq, sk, causal, sscale);
  }
}

// Per streamed tile j a consumer: wait for the split of tile j, meet (every
// tile product of tile j - 1 is done: the transposed tiles are free),
// transpose the tile, run its d products, compute its probabilities, meet
// again (the transposed tiles are whole), free the stage and run the tile
// products. Kernel 3's two consumers share one transposed copy (Q^T and
// dO^T: there is room for one) and meet at named barrier 1; kernel 2's
// each write their own K^T and meet their own warps only (barrier 2 + c),
// so they need not keep in step, and one's transpose and probabilities
// run beside the other's products. (The transpose issued while the d
// products run, its straight-line loads and stores between their issue and
// wait, crashed nvcc with a segmentation fault.)
template <bool kOwn>
__device__ __forceinline__ void consumers_meet() {
  if constexpr (kOwn) {
    named_sync(2 + threadIdx.x / 128, 128);
  } else {
    named_sync(1, kConsumerThreads);
  }
}

// Kernel 2's consumer warpgroup: its 64 query rows (from row0, A rows of the
// resident Q, dO) over every K, V tile: S and dP, dS, then the tile's dq
// part dS K (one group; the part summed over the tile's keys from zero,
// then added in f32).
template <int K>
__device__ __forceinline__ void dq_consume(const Smem& m, const float* __restrict__ lse2,
                                           const float* __restrict__ delta,
                                           float* __restrict__ dq, int row0, int sq, int sk,
                                           int tiles, int causal, float sscale) {
  const int c = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // this thread's rows row and row + 8 (C and A fragments alike)
  const int row = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  float r_lse[2], r_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < sq;
    r_lse[h] = ok ? lse2[row + 8 * h] : 0.f;
    r_delta[h] = ok ? delta[row + 8 * h] : 0.f;
  }
  const unsigned char* qh = m.res(0, 0) + c * kRows * 128;
  const unsigned char* ql = m.res(0, 1) + c * kRows * 128;
  const unsigned char* oh = m.res(1, 0) + c * kRows * 128;
  const unsigned char* ol = m.res(1, 1) + c * kRows * 128;
  float acc[kAcc], part[kAcc], s[kSAcc], dp[kSAcc];
  uint32_t dh[kTileSteps][4], dl[kTileSteps][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // tiles >= 1: a launch has sk >= 1, and the causal mask leaves key 0
  mbar_wait(m.res_ready(), 0);
#pragma unroll 1
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(m.ready(st), (j / kStages) & 1);
    consumers_meet<true>();
    transpose_tile<1, true>(m, st);  // this consumer's K^T
    consumers_meet<true>();
    wgmma_fence();
    products_over_d(s, qh, ql, m.nat(st, 0, 0), m.nat(st, 0, 1));   // S = Q K^T
    products_over_d(dp, oh, ol, m.nat(st, 1, 0), m.nat(st, 1, 1));  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    // kernel 2 has no P: only dS's fragments (dh, dl) are written
    tile_probs_at<K, false>(dh, dh, dh, dl, s, dp, nullptr, nullptr, r_lse, r_delta, row, row0,
                            j * kTile, sq, sk, causal, sscale);
    warp_arrive(m.empty(st));
    wgmma_fence();
    products_over_tile(part, dh, dl, m.tr(c, 0), m.tr(c, 1));  // the dq part dS K
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(dh);
    reg_fence(dl);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
  }
  store_rows(dq, acc, row, sq, 1.f);
}

// Kernel 4: this consumer's dS^T split fragments (its 64 keys x the q
// tile's 32 queries) written as dS, rows by query, into its own part of
// stage st (hi over the Q tile's hi and lo over its lo for consumer 0, over
// the dO tile's for consumer 1: the stage is read once the consumers meet
// after the probabilities), in the layout of a streamed tile (two 32-key
// halves in the 128-byte swizzle): the K-major B operand of its dq part
__device__ __forceinline__ void store_ds(const Smem& m, int st,
                                         const uint32_t (&sh)[kTileSteps][4],
                                         const uint32_t (&sl)[kTileSteps][4]) {
  const int tid = opaque(threadIdx.x);  // the offsets below computed each tile
  const int c = tid / 128;
  const int lane = tid % 32;
  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < kTileSteps; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // register r = 2e + h: key 16w + g + 8h, query 8i + 2t + e
      const int key = (tid % 128) / 32 * 16 + lane / 4 + 8 * (r % 2);
      const int off = key / kHalfCols * kNatHalf + swizzle128_f32(8 * i + 2 * t + r / 2,
                                                                  key % kHalfCols);
      *reinterpret_cast<uint32_t*>(m.nat(st, c, 0) + off) = sh[i][r];
      *reinterpret_cast<uint32_t*>(m.nat(st, c, 1) + off) = sl[i][r];
    }
  }
  fence_proxy_async();
}

// Kernel 4: the q tile's dq part over this consumer's 64 keys, transposed:
// dq^T = K^T dS^T (m64n32k8 in 3xTF32, M the 64 columns of d, N the tile's
// 32 queries), from zero: A the consumer's K^T, its fragments loaded from
// the resident K's hi and lo (a fragment's rows are columns of K: scalar
// loads), kChunk k-steps at a time (each chunk's lo x hi, hi x lo and hi x
// hi products in one group: the upcast contract's instance, its consumers'
// registers fuller, spilled the producer warpgroup's loop bounds with four
// or eight k-steps' fragments at once), B the consumer's dS from store_ds
// (hi, lo). Consumer 0 stages its part, rows by query, over its dS hi (as
// TMA reads two (32, 32) f32 boxes in the 128-byte swizzle) and arrives at
// named barrier 4; consumer 1 waits there, adds its part to the staged one
// (keys 0-63, then 64-127: one order run to run) and arrives on the
// stage's dq barrier.
template <int K>
constexpr int kDqChunk = K == kUpcast ? 2 : kDSteps;

template <int kChunk>
__device__ __forceinline__ void dq_tile(const Smem& m, int st) {
  const int tid = opaque(threadIdx.x);  // the offsets below computed each tile
  const int c = tid / 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int d0 = (tid % 128) / 32 * 16 + g;  // this thread's A rows d0, d0 + 8
  const uint64_t bh = wgmma_desc_sw128(smem_addr(m.nat(st, c, 0)));
  const uint64_t bl = wgmma_desc_sw128(smem_addr(m.nat(st, c, 1)));
  float x[kSAcc];
  named_sync(2 + c, 128);  // the warpgroup's dS is written (store_ds)
#pragma unroll
  for (int k0 = 0; k0 < kDSteps; k0 += kChunk) {
    uint32_t ah[kChunk][4], al[kChunk][4];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // A (d0 + 8 (r % 2), key 8 (k0 + i) + t + 4 (r / 2))
        const int d = d0 + 8 * (r % 2);
        const int off = d / kHalfCols * kResHalf +
                        swizzle128_f32(c * kRows + 8 * (k0 + i) + t + 4 * (r / 2), d % kHalfCols);
        ah[i][r] = *reinterpret_cast<const uint32_t*>(m.res(0, 0) + off);
        al[i][r] = *reinterpret_cast<const uint32_t*>(m.res(0, 1) + off);
      }
    }
    auto b_at = [&](uint64_t b, int kk) { return desc_at(b, kk / 4 * kNatHalf + 32 * (kk % 4)); };
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kChunk; ++i) wgmma_tf32_rs_n32(x, al[i], b_at(bh, k0 + i), k0 + i > 0);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) wgmma_tf32_rs_n32(x, ah[i], b_at(bl, k0 + i), 1);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) wgmma_tf32_rs_n32(x, ah[i], b_at(bh, k0 + i), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(x);
    reg_fence(ah);
    reg_fence(al);
  }
  unsigned char* staged = m.nat(st, 0, 0);
  if (c == 1) named_sync(4, kConsumerThreads);  // consumer 0's part is staged
#pragma unroll
  for (int i = 0; i < kSAcc / 4; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // x[4i + r]: d0 + 8 (r / 2), query 8i + 2t + r % 2
      const int d = d0 + 8 * (r / 2);
      float* p = reinterpret_cast<float*>(staged + d / kHalfCols * kNatHalf +
                                          swizzle128_f32(8 * i + 2 * t + r % 2, d % kHalfCols));
      *p = c == 0 ? x[4 * i + r] : *p + x[4 * i + r];
    }
  }
  if (c == 0) {
    named_arrive(4, kConsumerThreads);
  } else {
    fence_proxy_async();
    warp_arrive(m.dq_full(st));
  }
}

// Kernel 4's ordered adds of q tile j's dq part, by the producer's first
// thread between its loads (produce's hooks: in one thread, a stage is freed
// exactly when the next load into it needs it): reduce_start waits until
// the consumers have staged the part and until `lock` (the q tile's counter
// of this group's key blocks that have added their part) reads `ahead`, the
// key blocks of the group before this one, adds the part (two 32-column
// boxes of 32 rows at stage st's Q hi tile) into the f32 buffer of `dq_map`
// (coordinates (column, row, gbh)) by TMA reductions and frees the stage once
// they have read it; reduce_finish, after the next load is issued, waits
// until they have completed and counts the block. Rows past sq fall outside
// the map and are dropped.
struct DqReducer {
  const Smem* m;
  const CUtensorMap* dq_map;
  int* locks;
  int ahead, gbh, q_begin;

  __device__ int* lock(int j) const { return locks + (q_begin + j * kTile) / kTile; }
  __device__ void start(int j) const {
    const int st = j % kStages;
    mbar_wait(m->dq_full(st), (j / kStages) & 1);
    while (ld_acquire(lock(j)) < ahead) __nanosleep(32);
    fence_proxy_async_global();  // the reductions come after the blocks before
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tma_reduce_add_3d(dq_map, m->nat(st, 0, 0) + h * kNatHalf, h * kHalfCols,
                        q_begin + j * kTile, gbh);
    }
    bulk_commit();
    bulk_wait_read<0>();
    mbar_arrive(m->empty(st));  // the stage may be loaded again
  }
  __device__ void finish(int j) const {
    bulk_wait<0>();
    fence_proxy_async_global();  // the completed reductions come before the count
    __threadfence();
    atomicAdd(lock(j), 1);
  }
};

// Kernel 3's consumer warpgroup (and kernel 4's, kFused): its 64 keys
// (from key0, A rows of the
// resident K, V) over every q tile: S^T and dP^T, P^T and dS^T, then dV's
// part and dK's part (a group each: one part accumulator between them, so
// that the consumers need no more than 160 registers of accumulators and
// fragments; each part summed over the tile's queries from zero, then
// added in f32). Kernel 4 writes dS^T over the stage (store_ds) in place of
// freeing it, and after dK's part runs the tile's dq part (dq_tile): the
// same dV and dK products in the same order, so dk and dv have kernel 3's
// bits.
template <int K, bool kFused>
__device__ __forceinline__ void dkv_consume(const Smem& m, float* __restrict__ dk,
                                            float* __restrict__ dv, int key0, int q_begin,
                                            int sq, int sk, int tiles, int causal, float sscale) {
  const int c = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // this thread's keys key and key + 8
  const int key = key0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const unsigned char* kh = m.res(0, 0) + c * kRows * 128;
  const unsigned char* kl = m.res(0, 1) + c * kRows * 128;
  const unsigned char* vh = m.res(1, 0) + c * kRows * 128;
  const unsigned char* vl = m.res(1, 1) + c * kRows * 128;
  const float none[2] = {0.f, 0.f};
  float acc_k[kAcc], acc_v[kAcc], part[kAcc], s[kSAcc], dp[kSAcc];
  uint32_t ph[kTileSteps][4], pl[kTileSteps][4], sh[kTileSteps][4], sl[kTileSteps][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (tiles > 0) mbar_wait(m.res_ready(), 0);
#pragma unroll 1
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(m.ready(st), (j / kStages) & 1);
    consumers_meet<false>();
    transpose_tile<2, false>(m, st);  // Q^T and dO^T
    wgmma_fence();
    products_over_d(s, kh, kl, m.nat(st, 0, 0), m.nat(st, 0, 1));   // S^T = K Q^T
    products_over_d(dp, vh, vl, m.nat(st, 1, 0), m.nat(st, 1, 1));  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    tile_probs_at<K, true>(ph, pl, sh, sl, s, dp, m.lse(st), m.delta(st), none, none, key, key0,
                           q_begin + j * kTile, sq, sk, causal, sscale);
    consumers_meet<false>();
    if constexpr (kFused) {
      store_ds(m, st, sh, sl);
    } else {
      warp_arrive(m.empty(st));  // the stage's tiles and rows are read
    }
    wgmma_fence();
    products_over_tile(part, ph, pl, m.tr(1, 0), m.tr(1, 1));  // dV part P^T dO
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(ph);
    reg_fence(pl);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc_v[i] += part[i];
    wgmma_fence();
    products_over_tile(part, sh, sl, m.tr(0, 0), m.tr(0, 1));  // dK part dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(sh);
    reg_fence(sl);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc_k[i] += part[i];
    if constexpr (kFused) dq_tile<kDqChunk<K>>(m, st);
  }
  store_rows(dk, acc_k, key, sk, 1.f);
  // dO arrived multiplied by ln2 for ds (not under kUpcast); dv must not carry it
  store_rows(dv, acc_v, key, sk, K == kUpcast ? 1.f : kLog2e);
}

}  // namespace tf

// Kernel 2 on the TF32 route. Grid: one block per (bh, tf::kBlockRows query
// rows), flattened into blockIdx.x; tf::kThreads threads, tf::kSmemBytes of
// dynamic shared memory. Warpgroups 0 and 1 consume; in warpgroup 2 the
// first thread loads by TMA the block's Q and dO rows (maps of (64, sq,
// bh), box 32 columns x 128 rows) and the K and V tiles (maps of (64, sk,
// bh), box 32 columns x 32 keys), and warps 1-3 convert (tf::convert).
template <int K>
__global__ void __launch_bounds__(tf::kThreads, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         float* __restrict__ dq, int sq, int sk, int num_qb, int causal,
                         float sscale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tf::Smem m = tf::make_smem(smem_raw);
  const int bh = blockIdx.x / num_qb;
  const int q0 = (blockIdx.x % num_qb) * tf::kBlockRows;
  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, q0 + tf::kBlockRows) : sk;
  const int tiles = (kv_end + tf::kTile - 1) / tf::kTile;
  if (threadIdx.x >= tf::kConsumerThreads) {
    regs_lower<tf::kProducerRegs>();
    const int pt = threadIdx.x - tf::kConsumerThreads;
    if (pt == 0) {
      tf::produce(m, &q_map, &do_map, &k_map, &v_map, bh, q0, 0, tiles);
    } else if (pt >= 32) {
      tf::convert<false>(m, tiles, nullptr, nullptr, 0, sq);
    }
  } else {
    regs_raise<tf::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sq;
    tf::dq_consume<K>(m, lse2 + head, delta + head, dq + head * tf::kD,
                      q0 + threadIdx.x / 128 * tf::kRows, sq, sk, tiles, causal, sscale);
  }
}

// Kernel 3 on the TF32 route. Grid: one block per (bh, tf::kBlockRows keys),
// flattened into blockIdx.x; threads, shared memory and roles as kernel 2's,
// with K and V resident (box 128 keys) and Q, dO streamed (box 32 rows).
template <int K>
__global__ void __launch_bounds__(tf::kThreads, 1)
flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse2, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
                          int num_kb, int causal, float sscale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tf::Smem m = tf::make_smem(smem_raw);
  const int bh = blockIdx.x / num_kb;
  const int k0 = (blockIdx.x % num_kb) * tf::kBlockRows;
  // under the causal mask, query rows before the block's first key are dead
  // (k0 is a multiple of the q tile)
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + tf::kTile - 1) / tf::kTile : 0;
  if (threadIdx.x >= tf::kConsumerThreads) {
    regs_lower<tf::kProducerRegs>();
    const int pt = threadIdx.x - tf::kConsumerThreads;
    if (pt == 0) {
      tf::produce(m, &k_map, &v_map, &q_map, &do_map, bh, k0, q_begin, tiles);
    } else if (pt >= 32) {
      const size_t rows = static_cast<size_t>(bh) * sq;
      tf::convert<true>(m, tiles, lse2 + rows, delta + rows, q_begin, sq);
    }
  } else {
    regs_raise<tf::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sk * tf::kD;
    tf::dkv_consume<K, false>(m, dk + head, dv + head, k0 + threadIdx.x / 128 * tf::kRows,
                              q_begin, sq, sk, tiles, causal, sscale);
  }
}

// Kernel 4 on the TF32 route. Grid, threads, shared memory, maps and roles
// as kernel 3's; the producer's first thread also adds the staged dq parts
// (tf::DqReducer), each before it loads the stage again. The key
// blocks of a head fall into `groups` interleaved groups, each with its own
// f32 dq buffer (the map `dq_map` of the caller's zeroed (groups, bh, sq,
// 64) buffer seen as (64, sq, groups * bh), box 32 columns x 32 rows) and
// its own counters, dq_lock, int (groups, bh, ceil(sq / 32)), zeroed by the
// caller, who sums the groups' buffers: as flash_bwd_fused_wgmma_kernel's.
template <int K>
__global__ void __launch_bounds__(tf::kThreads, 1)
flash_bwd_fused_tf32_kernel(const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __grid_constant__ CUtensorMap dq_map,
                            const float* __restrict__ lse2, const float* __restrict__ delta,
                            int* __restrict__ dq_lock, float* __restrict__ dk,
                            float* __restrict__ dv, int sq, int sk, int num_kb, int causal,
                            float sscale, int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tf::Smem m = tf::make_smem(smem_raw, true);
  const int bh = blockIdx.x / num_kb;
  const int kbi = blockIdx.x % num_kb;
  const int k0 = kbi * tf::kBlockRows;
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + tf::kTile - 1) / tf::kTile : 0;
  const int q_tiles = (sq + tf::kTile - 1) / tf::kTile;
  // this block's dq buffer and counters: its group's, and in them its head's
  const int gbh = kbi % groups * (gridDim.x / num_kb) + bh;
  if (threadIdx.x >= tf::kConsumerThreads) {
    regs_lower<tf::kProducerRegs>();
    const int pt = threadIdx.x - tf::kConsumerThreads;
    if (pt == 0) {  // a block waits for the blocks of its group before it
      const tf::DqReducer red{&m, &dq_map, dq_lock + static_cast<size_t>(gbh) * q_tiles,
                              kbi / groups, gbh, q_begin};
      tf::produce(
          m, &k_map, &v_map, &q_map, &do_map, bh, k0, q_begin, tiles,
          [&](int j) { if (j >= tf::kStages) red.start(j - tf::kStages); },
          [&](int j) { if (j >= tf::kStages) red.finish(j - tf::kStages); });
      for (int j = max(tiles - tf::kStages, 0); j < tiles; ++j) {
        red.start(j);
        red.finish(j);
      }
    } else if (pt >= 32) {
      const size_t rows = static_cast<size_t>(bh) * sq;
      tf::convert<true>(m, tiles, lse2 + rows, delta + rows, q_begin, sq);
    }
  } else {
    regs_raise<tf::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sk * tf::kD;
    tf::dkv_consume<K, true>(m, dk + head, dv + head, k0 + threadIdx.x / 128 * tf::kRows,
                             q_begin, sq, sk, tiles, causal, sscale);
  }
}

// ---- kernels 2 and 3 on the wgmma route (kRouteWgmma): bf16, D = 256 ----

namespace wd {

constexpr int kD = 256;                       // head width: four 128-byte swizzle atoms a row
constexpr int kAtomCols = 64;                 // bf16 columns of an atom (one TMA box's width)
constexpr int kRows = 64;                     // rows of a consumer warpgroup (wgmma's M)
constexpr int kConsumers = 2;                 // consumer warpgroups a block
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;  // arrivals that empty a stage
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kDSteps = kD / 16;              // k-steps over d: S, dP (and S^T, dP^T)
constexpr int kPartAcc = 32;                  // accumulator floats of an m64n64 part
// kernel 2: a block of 128 query rows (64 a consumer), Q and dO resident,
// K and V streamed in tiles of 32 keys
constexpr int kDqRows = kConsumers * kRows;
constexpr int kDqTile = 32;
constexpr int kDqStages = 3;
constexpr int kDqTileSteps = kDqTile / 16;    // k-steps of a dq part over the tile's keys
constexpr int kSAcc = kDqTile / 2;            // accumulator floats of an m64n32 tile
constexpr int kDqAcc = kD / 2;                // accumulator floats of an m64n256 tile (dq)
// kernel 3: a block of 64 keys (both consumers), K and V resident, Q and dO
// streamed in tiles of 64 query rows; a consumer computes S^T and dP^T for
// half of a tile's queries and owns half of dK's and dV's columns
constexpr int kDkvKeys = kRows;
constexpr int kDkvTile = 64;
constexpr int kDkvStages = 2;
constexpr int kHalfTile = kDkvTile / kConsumers;  // 32 queries of a consumer's S^T, dP^T
constexpr int kDkvCols = kD / kConsumers;         // 128 columns of a consumer's dK, dV
constexpr int kDkvTileSteps = kDkvTile / 16;      // k-steps of dV's, dK's parts
constexpr int kDkvAcc = kDkvCols / 2;             // accumulator floats of dK or dV (m64n128)
static_assert(kHalfTile == kDqTile, "S^T, dP^T and S, dP are both m64n32 tiles");
static_assert(kDkvTile * 2 == 128, "a P^T or dS^T row is one 128-byte swizzle row");

// Dynamic shared memory from a 1024-byte-aligned base: the two resident
// operands (Q and dO, or K and V), kStages stages of the two streamed ones
// (K and V, or Q and dO), each an operand of `rows` x 256 bf16 as four atoms,
// one per 64-column TMA box (atom a: columns 64a .. 64a + 63 of the rows,
// 128 bytes a row in the 128-byte swizzle, atoms rows x 128 bytes apart);
// kernels 3 and 4 (kProbs) then two buffers of the q tile's P^T and dS^T
// (64 keys x 64 queries each, one atom), and the lse2 and delta rows of each
// stage; then the full and empty mbarriers of each stage, the resident
// operands' barrier and, kernel 4 (kFused), each stage's two barriers of
// its staged dq part (one for each 64-column chunk of a consumer)
template <int kResRows, int kTileRows, int kStages, bool kProbs, bool kFused = false>
struct Layout {
  static constexpr int kResRowsN = kResRows;
  static constexpr int kTileRowsN = kTileRows;
  static constexpr int kStagesN = kStages;
  static constexpr bool kFusedN = kFused;
  static constexpr int kResBytes = kResRows * kD * 2;    // one resident operand
  static constexpr int kTileBytes = kTileRows * kD * 2;  // one streamed operand
  static constexpr int kStagesAt = 2 * kResBytes;
  static constexpr int kBufAt = kStagesAt + kStages * 2 * kTileBytes;
  static constexpr int kBufBytes = kProbs ? kDkvKeys * kDkvTile * 2 : 0;  // P^T or dS^T, 8 KB
  static constexpr int kRowsAt = kBufAt + 2 * 2 * kBufBytes;
  static constexpr int kRowBytes = kProbs ? kTileRows * 4 : 0;  // lse2 or delta of a stage
  static constexpr int kBarsAt = kRowsAt + kStages * 2 * kRowBytes;
  static constexpr int kBars = 2 * kStages + 1 + (kFused ? 2 * kStages : 0);
  static constexpr int kBytes = kBarsAt + kBars * 8 + 1024;  // + alignment
};
using DqLayout = Layout<kDqRows, kDqTile, kDqStages, false>;
using DkvLayout = Layout<kDkvKeys, kDkvTile, kDkvStages, true>;
using FusedLayout = Layout<kDkvKeys, kDkvTile, kDkvStages, true, true>;
// 128 KB of Q and dO + 3 x 32 KB of K, V tiles
static_assert(DqLayout::kBytes == 230456, "kernel 2's shared memory");
// 64 KB of K and V + 2 x 64 KB of Q, dO tiles + 2 x 16 KB of P^T, dS^T + 1 KB of rows
static_assert(DkvLayout::kBytes == 231464, "kernel 3's shared memory");
// kernel 3's and four barriers: the dq parts are staged over the stages' tiles
static_assert(FusedLayout::kBytes == 231496, "kernel 4's shared memory");
static_assert(FusedLayout::kBytes <= 232448 && DqLayout::kBytes <= 232448,
              "shared memory of one block");

template <class L>
struct Smem {
  unsigned char* base;  // 1024-byte aligned
  uint64_t* bars;

  // resident operand o (0: Q or K, 1: dO or V)
  __device__ unsigned char* res(int o) const { return base + o * L::kResBytes; }
  // streamed operand o (0: K or Q, 1: V or dO) of stage st
  __device__ unsigned char* tile(int st, int o) const {
    return base + L::kStagesAt + (2 * st + o) * L::kTileBytes;
  }
  // kernel 3: P^T (o = 0) or dS^T (o = 1) of buffer b
  __device__ unsigned char* probs(int b, int o) const {
    return base + L::kBufAt + (2 * b + o) * L::kBufBytes;
  }
  __device__ float* lse(int st) const {
    return reinterpret_cast<float*>(base + L::kRowsAt + st * 2 * L::kRowBytes);
  }
  __device__ float* delta(int st) const { return lse(st) + L::kTileRowsN; }
  __device__ uint64_t* full(int st) const { return bars + st; }
  __device__ uint64_t* empty(int st) const { return bars + L::kStagesN + st; }
  __device__ uint64_t* res_full() const { return bars + 2 * L::kStagesN; }
  // kernel 4: both consumers' chunk h of stage st's q tile's dq part are staged
  __device__ uint64_t* dq_full(int st, int h) const {
    return bars + 2 * L::kStagesN + 1 + 2 * st + h;
  }
};

// the layout in this block's dynamic shared memory, its barriers
// initialised, `fills` arrivals filling a stage and the consumers' warps
// emptying it (kernel 4: its reducer, once it has read the stage's dq
// part; the one __syncthreads of the kernels: the roles split after it)
template <class L>
__device__ __forceinline__ Smem<L> make_smem(unsigned char* raw, int fills) {
  Smem<L> m;
  m.base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  m.bars = reinterpret_cast<uint64_t*>(m.base + L::kBarsAt);
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStagesN; ++st) {
      mbar_init(m.full(st), fills);
      mbar_init(m.empty(st), L::kFusedN ? 1 : kConsumerWarps);
      if (L::kFusedN) {
        mbar_init(m.dq_full(st, 0), kConsumerWarps);
        mbar_init(m.dq_full(st, 1), kConsumerWarps);
      }
    }
    mbar_init(m.res_full());
    mbar_fence_init();
  }
  __syncthreads();
  return m;
}

// the producer's wait before it refills the stage of load j
template <class L>
__device__ __forceinline__ int claim(const Smem<L>& m, int j) {
  const int st = j % L::kStagesN;
  if (j >= L::kStagesN) mbar_wait(m.empty(st), (j / L::kStagesN - 1) & 1);
  return st;
}

// The producer warpgroup's first thread: the block's two resident operands
// (maps res0, res1, box 64 columns x kResRows rows from row res_row) once,
// then the two streamed operands of each stage (maps nat0, nat1, box 64
// columns x kTileRows rows from row nat_row + j kTileRows), each as four
// 64-column atoms; rows past the tensor's read as 0
template <class L>
__device__ __forceinline__ void produce(const Smem<L>& m, const CUtensorMap* res0,
                                        const CUtensorMap* res1, const CUtensorMap* nat0,
                                        const CUtensorMap* nat1, int bh, int res_row, int nat_row,
                                        int tiles) {
  if (tiles == 0) return;
  constexpr int kResAtom = L::kResRowsN * 128;
  constexpr int kTileAtom = L::kTileRowsN * 128;
  mbar_expect(m.res_full(), 2 * L::kResBytes);
  for (int a = 0; a < kD / kAtomCols; ++a) {
    tma_load_3d(m.res(0) + a * kResAtom, res0, m.res_full(), a * kAtomCols, res_row, bh);
    tma_load_3d(m.res(1) + a * kResAtom, res1, m.res_full(), a * kAtomCols, res_row, bh);
  }
  for (int j = 0; j < tiles; ++j) {
    const int st = claim(m, j);
    const int row = nat_row + j * L::kTileRowsN;
    mbar_expect(m.full(st), 2 * L::kTileBytes);
    for (int a = 0; a < kD / kAtomCols; ++a) {
      tma_load_3d(m.tile(st, 0) + a * kTileAtom, nat0, m.full(st), a * kAtomCols, row, bh);
      tma_load_3d(m.tile(st, 1) + a * kTileAtom, nat1, m.full(st), a * kAtomCols, row, bh);
    }
  }
}

// a consumer warp's release of stage st (its wgmmas on the stage are done)
template <class L>
__device__ __forceinline__ void release(const Smem<L>& m, int st) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(m.empty(st));
}

// x = a b^T over d, from zero: A 64 rows of a resident operand at `a`
// (K-major, its atoms kAAtom bytes apart), B 32 rows of a streamed operand
// at `b` (K-major, atoms kBAtom bytes apart); kDSteps wgmma m64n32k16, a
// k-step of 16 columns inside one atom
template <int kAAtom, int kBAtom>
__device__ __forceinline__ void products_over_d(float (&x)[kSAcc], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    const uint32_t at = 32 * (kk % 4);  // the k-step's 32 bytes in the atom's rows
    wgmma_ss<kSAcc * 2>(x, desc_at(a, kk / 4 * kAAtom + at), desc_at(b, kk / 4 * kBAtom + at),
                        kk > 0);
  }
}

// the part accumulator added into 64 columns (chunk h) of an accumulator
// of m64n64 chunks
template <int N>
__device__ __forceinline__ void add_part(float (&acc)[N], const float (&part)[kPartAcc], int h) {
#pragma unroll
  for (int i = 0; i < kPartAcc; ++i) acc[kPartAcc * h + i] += part[i];
}

// this thread's rows row and row + 8 of an accumulator of `kCols` columns
// (m64 x kCols f32) rounded to bf16, times `mul`, at columns col0 .. of
// `out` (rows of kD); rows at or past s are not stored
template <int kCols>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&x)[kCols / 2],
                                           int row, int col0, int s, float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= s) continue;
    bf16* dst = out + static_cast<size_t>(row + 8 * h) * kD + col0 + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kCols / 8; ++nb) {
      store2(dst + 8 * nb, x[4 * nb + 2 * h] * mul, x[4 * nb + 2 * h + 1] * mul);
    }
  }
}

// ds of one K, V tile of 32 keys (keys from `key0`), rounded to bf16 pairs:
// the A fragments of the dq part's k-steps (this thread's rows row and row +
// 8; wg::dq_ds's layout); kMasked: some (row, key) pair of the warpgroup's
// tile is past sq, sk or the causal diagonal, so each pair is tested
template <int K, bool kMasked>
__device__ __forceinline__ void dq_ds(uint32_t (&df)[kDqTileSteps][4], const float (&s)[kSAcc],
                                      const float (&dp)[kSAcc], const float (&r_lse)[2],
                                      const float (&r_delta)[2], int row, int key0, int sq,
                                      int sk, int causal) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int js = 0; js < kDqTileSteps; ++js) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // row + 8 (e & 1), keys 16 js + 8 (e >> 1) + 2t, + 1
      const int h = e & 1;
      const int rq = row + 8 * h;
      const int key = key0 + 16 * js + 8 * (e >> 1) + 2 * t;
      float p, ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool live = !kMasked || (rq < sq && key + c < sk && (!causal || key + c <= rq));
        wg::prob_ds_sfu<K>(s[8 * js + 2 * e + c], dp[8 * js + 2 * e + c], r_lse[h], r_delta[h],
                           live, p, ds[c]);
      }
      df[js][e] = pack_bf16(ds[0], ds[1]);
    }
  }
}

// dq_ds, masked where the warpgroup's tile (rows row0 .., keys key0 ..)
// reaches past sq, sk or the causal diagonal (a uniform branch: no product
// of the warpgroup is in flight)
template <int K>
__device__ __forceinline__ void dq_tile_ds(uint32_t (&df)[kDqTileSteps][4],
                                           const float (&s)[kSAcc], const float (&dp)[kSAcc],
                                           const float (&r_lse)[2], const float (&r_delta)[2],
                                           int row, int row0, int key0, int sq, int sk,
                                           int causal) {
  if (row0 + kRows > sq || key0 + kDqTile > sk || (causal && key0 + kDqTile - 1 > row0)) {
    dq_ds<K, true>(df, s, dp, r_lse, r_delta, row, key0, sq, sk, causal);
  } else {
    dq_ds<K, false>(df, s, dp, r_lse, r_delta, row, key0, sq, sk, causal);
  }
}

// kernel 2: the tile's dq part of columns 64 h .. 64 h + 63, dS K over the
// tile's 32 keys, from zero: A the dS fragments, B atom h of the K tile at
// `k_atom` (MN-major: a k-step of 16 keys is 2048 bytes)
__device__ __forceinline__ void dq_part(float (&part)[kPartAcc],
                                        const uint32_t (&df)[kDqTileSteps][4], uint64_t k_atom) {
#pragma unroll
  for (int js = 0; js < kDqTileSteps; ++js) {
    wgmma_rs_n64<true>(part, df[js], desc_at(k_atom, 2048 * js), js > 0);
  }
}

// Kernel 2's consumer warpgroup: its 64 query rows (from row0, rows of the
// resident Q and dO) over every K, V tile. Per tile: S = Q K^T and dP = dO
// V^T (m64n32, A and B from shared memory), dS in registers, then the dq
// part dS K in four 64-column chunks, each summed over the tile's 32 keys
// from zero and added in f32 to the running dq (a chunk at a time: the
// m64n256 dq accumulator takes 128 registers a thread, so a whole part
// would not fit beside it). The next tile's S and dP are issued with the
// last chunk, in one group.
template <int K>
__device__ __forceinline__ void dq_consume(const Smem<DqLayout>& m,
                                           const float* __restrict__ lse2,
                                           const float* __restrict__ delta,
                                           bf16* __restrict__ dq, int row0, int sq, int sk,
                                           int tiles, int causal) {
  constexpr int kResAtom = kDqRows * 128;  // 16 KB: an atom of Q or dO
  constexpr int kTileAtom = kDqTile * 128;  // 4 KB: an atom of a K or V tile
  const int c = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // this thread's rows row and row + 8 (C and A fragments alike)
  const int row = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  float r_lse[2], r_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < sq;
    r_lse[h] = ok ? lse2[row + 8 * h] : 0.f;
    r_delta[h] = ok ? delta[row + 8 * h] : 0.f;
  }
  // the consumer's 64 rows of Q and dO: A of S and dP
  const uint64_t qd = wgmma_desc_sw128(smem_addr(m.res(0) + c * kRows * 128));
  const uint64_t od = wgmma_desc_sw128(smem_addr(m.res(1) + c * kRows * 128));
  float acc[kDqAcc], part[kPartAcc], s[kSAcc], dp[kSAcc];
  uint32_t df[kDqTileSteps][4];
#pragma unroll
  for (int i = 0; i < kDqAcc; ++i) acc[i] = 0.f;
  auto kdesc = [&](int st, int o) { return wgmma_desc_sw128(smem_addr(m.tile(st, o))); };

  // tiles >= 1: a launch has sk >= 1, and the causal mask leaves key 0
  mbar_wait(m.res_full(), 0);
  mbar_wait(m.full(0), 0);
  wgmma_fence();
  products_over_d<kResAtom, kTileAtom>(s, qd, kdesc(0, 0));   // S = Q K^T
  products_over_d<kResAtom, kTileAtom>(dp, od, kdesc(0, 1));  // dP = dO V^T
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  reg_fence(dp);
  // the dq part's chunks 0-2 of tile j (stage st), each waited for and added
  auto first_chunks = [&](int st) {
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      wgmma_fence();
      dq_part(part, df, wgmma_desc_add(kdesc(st, 0), h * kTileAtom));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(part);
      add_part(acc, part, h);
    }
  };
#pragma unroll 1
  for (int j = 0; j + 1 < tiles; ++j) {
    const int st = j % kDqStages;
    const int next = (j + 1) % kDqStages;
    dq_tile_ds<K>(df, s, dp, r_lse, r_delta, row, row0, j * kDqTile, sq, sk, causal);
    first_chunks(st);
    mbar_wait(m.full(next), ((j + 1) / kDqStages) & 1);
    wgmma_fence();
    dq_part(part, df, wgmma_desc_add(kdesc(st, 0), 3 * kTileAtom));  // chunk 3
    products_over_d<kResAtom, kTileAtom>(s, qd, kdesc(next, 0));
    products_over_d<kResAtom, kTileAtom>(dp, od, kdesc(next, 1));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(s);
    reg_fence(dp);
    reg_fence(df);
    release(m, st);
    add_part(acc, part, 3);
  }
  const int last = tiles - 1;
  const int st = last % kDqStages;
  dq_tile_ds<K>(df, s, dp, r_lse, r_delta, row, row0, last * kDqTile, sq, sk, causal);
  first_chunks(st);
  wgmma_fence();
  dq_part(part, df, wgmma_desc_add(kdesc(st, 0), 3 * kTileAtom));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(part);
  reg_fence(df);
  release(m, st);
  add_part(acc, part, 3);
  store_rows<kD>(dq, acc, row, 0, sq, 1.f);
}

// P^T and dS^T of a q tile's 64 keys x this consumer's 32 queries (from
// q0 + 32 c; lse2 and delta rows from the stage), rounded to bf16 pairs and
// stored into this consumer's half of the buffers `pbuf`, `sbuf` as TMA
// would write a (64, 64) bf16 tile in the 128-byte swizzle (rows by key),
// then made visible to the wgmmas that read them as dV's and dK's K-major
// A operands; kMasked as dq_ds's
template <int K, bool kMasked>
__device__ __forceinline__ void dkv_probs(unsigned char* pbuf, unsigned char* sbuf,
                                          const float (&s)[kSAcc], const float (&dp)[kSAcc],
                                          const float* lse, const float* del, int key, int q0,
                                          int sq, int sk, int causal) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int c = threadIdx.x / 128;
  // the thread's key row in the tile (kl % 8 == g), and kl + 8
  const int kl = (threadIdx.x % 128) / 32 * 16 + g;
#pragma unroll
  for (int i = 0; i < kSAcc / 4; ++i) {  // n8 block i: queries 8i + 2t, + 1 of the consumer's 32
    const int col = c * kHalfTile + 8 * i + 2 * t;  // the query's column in the tile
    const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
    const float2 dl = *reinterpret_cast<const float2*>(del + col);
    const int chunk = col / 8;  // the 16-byte chunk of the key's 128-byte row
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // keys key, key + 8
      const int kr = key + 8 * h;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rq = q0 + col + e;
        const bool live = !kMasked || (rq < sq && kr < sk && (!causal || kr <= rq));
        wg::prob_ds_sfu<K>(s[4 * i + 2 * h + e], dp[4 * i + 2 * h + e], e ? l2.y : l2.x,
                           e ? dl.y : dl.x, live, p[e], ds[e]);
      }
      const int off = (kl + 8 * h) * 128 + ((chunk ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(pbuf + off) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(sbuf + off) = pack_bf16(ds[0], ds[1]);
    }
  }
  fence_proxy_async();
}

// dkv_probs, masked where the block's tile (keys key0 .., queries q0 ..)
// reaches past sq, sk or the causal diagonal
template <int K>
__device__ __forceinline__ void dkv_tile_probs(unsigned char* pbuf, unsigned char* sbuf,
                                               const float (&s)[kSAcc], const float (&dp)[kSAcc],
                                               const float* lse, const float* del, int key,
                                               int key0, int q0, int sq, int sk, int causal) {
  if (q0 + kDkvTile > sq || key0 + kDkvKeys > sk || (causal && key0 + kDkvKeys - 1 > q0)) {
    dkv_probs<K, true>(pbuf, sbuf, s, dp, lse, del, key, q0, sq, sk, causal);
  } else {
    dkv_probs<K, false>(pbuf, sbuf, s, dp, lse, del, key, q0, sq, sk, causal);
  }
}

// kernel 3: a part of 64 columns of dV (or dK) over a q tile's 64 queries,
// from zero: A the block's P^T (or dS^T) at `a` (K-major), B an atom of the
// tile's dO (or Q) at `b` (MN-major)
__device__ __forceinline__ void dkv_part(float (&part)[kPartAcc], uint64_t a, uint64_t b) {
#pragma unroll
  for (int js = 0; js < kDkvTileSteps; ++js) {
    wgmma_ss_n64_trans_b(part, desc_at(a, 32 * js), desc_at(b, 2048 * js), js > 0);
  }
}

// Kernel 4: chunk h of the q tile's dq part dS K over the block's 64 keys,
// this consumer's columns 128 c + 64 h .. + 63 (m64n64k16: A the tile's
// dS^T in buffer b, both consumers' halves, MN-major; B atom 2c + h of the
// resident K, MN-major), from zero, waited for and staged over this
// consumer's own atoms of stage st that its dV and dK chunks have read
// (chunk 1 over the dO tile's atoms 2c and 2c + 1 once dV's chunks are
// done, chunk 0 over the Q tile's once dK's are: no other product reads
// them, and the reducer frees the stage once it has read them), as TMA
// reads two (32, 64) f32 boxes in the 128-byte swizzle; then each warp
// arrives on the stage's barrier of chunk h, so the reducer adds chunk 1
// while the consumers run dK's last chunk. `part` is the consumer's chunk
// accumulator (dV's and dK's parts are summed in it too).
constexpr int kDkvAtom = kDkvKeys * 128;  // 8 KB: an atom of K, V or a Q, dO tile (64 rows)
constexpr int kDqBox = kDkvAtom;          // 8 KB: a staged (32, 64) f32 box of a dq part

__device__ __forceinline__ void stage_dq_chunk(unsigned char* dst, const float (&x)[kPartAcc]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (threadIdx.x % 128) / 32 * 16 + g + 8 * h;  // row % 8 == g
#pragma unroll
    for (int nb = 0; nb < kPartAcc / 4; ++nb) {  // columns 8 nb + 2t, + 1: box nb / 4
      unsigned char* box = dst + nb / 4 * kDqBox;
      const int chunk = 2 * (nb % 4) + t / 2;
      *reinterpret_cast<float2*>(box + row * 128 + ((chunk ^ g) << 4) + 8 * (t % 2)) =
          make_float2(x[4 * nb + 2 * h], x[4 * nb + 2 * h + 1]);
    }
  }
}

template <class L>
__device__ __forceinline__ void dq_chunk(const Smem<L>& m, int st, int b, int h,
                                         float (&part)[kPartAcc]) {
  const int c = threadIdx.x / 128;
  const uint64_t ds = wgmma_desc_sw128(smem_addr(m.probs(b, 1)));
  const uint64_t kd = wgmma_desc_sw128(smem_addr(m.res(0) + (2 * c + h) * kDkvAtom));
  wgmma_fence();
#pragma unroll
  for (int js = 0; js < kDkvKeys / 16; ++js) {
    wgmma_ss_n64_mn(part, desc_at(ds, 2048 * js), desc_at(kd, 2048 * js), js > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(part);
  stage_dq_chunk(m.tile(st, h) + 2 * c * kDkvAtom, part);
  fence_proxy_async();
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(m.dq_full(st, h));
}

// Kernel 4's ordered adds, by one thread of the producer warpgroup for the
// q tiles j of `tiles` in stage `first` (j % kDkvStages == first): it waits
// until both consumers have staged chunk 1 of the tile's dq part and until
// `lock` (the q tile's counter of this group's key blocks that have added
// their part) reads `ahead`, the key blocks of the group before this one;
// then adds chunk 1, and chunk 0 once staged, into the f32 buffer of
// `dq_map` (coordinates (column, row, gbh)) by four TMA reductions each,
// frees the stage once they have read it, waits until they have completed
// and counts the block. Rows past sq fall outside the map and are dropped.
__device__ __forceinline__ void reduce_dq(const Smem<FusedLayout>& m, const CUtensorMap* dq_map,
                                          int* __restrict__ locks, int ahead, int gbh,
                                          int q_begin, int tiles, int first) {
  for (int j = first; j < tiles; j += kDkvStages) {
    const int st = j % kDkvStages;
    const int q0 = q_begin + j * kDkvTile;
    int* lock = locks + q0 / kDkvTile;
    const int parity = (j / kDkvStages) & 1;
    mbar_wait(m.dq_full(st, 1), parity);
    while (ld_acquire(lock) < ahead) __nanosleep(32);
    fence_proxy_async_global();  // the reductions come after the blocks before
    for (int h = 1; h >= 0; --h) {
      if (h == 0) mbar_wait(m.dq_full(st, 0), parity);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          tma_reduce_add_3d(dq_map, m.tile(st, h) + (2 * c + x) * kDkvAtom,
                            kDkvCols * c + kAtomCols * h + 32 * x, q0, gbh);
        }
      }
      bulk_commit();
    }
    bulk_wait_read<0>();
    mbar_arrive(m.empty(st));  // the producer may load the stage again
    bulk_wait<0>();
    fence_proxy_async_global();  // the completed reductions come before the count
    __threadfence();
    atomicAdd(lock, 1);
  }
}

// Kernel 3's consumer warpgroup c (and kernel 4's: L = FusedLayout): the
// block's 64 keys (from key0) over every q tile. Per tile: S^T = K Q^T and
// dP^T = V dO^T for the tile's
// queries 32 c .. 32 c + 31 (m64n32, A and B from shared memory), P^T and
// dS^T of those into the tile's buffers; after both consumers meet at named
// barrier 1, dV's and dK's parts of its columns 128 c .. 128 c + 127 over
// all 64 queries, in 64-column chunks (two accumulators of m64n128 take 128
// registers a thread: a part beside them is one m64n64 chunk), each summed
// from zero and added in f32. The next tile's S^T and dP^T are issued with
// the last chunk, in one group; the buffers alternate between tiles, so
// one barrier a tile keeps a buffer from being rewritten while read.
// Kernel 4 also runs the tile's dq part (dq_chunk: chunk 1 after dV's
// chunks, chunk 0 after dK's) and leaves the stage to its reducer: the same
// dV and dK products in the same order, so dk and dv have kernel 3's bits.
template <int K, class L>
__device__ __forceinline__ void dkv_consume(const Smem<L>& m, bf16* __restrict__ dk,
                                            bf16* __restrict__ dv, int key0, int q_begin,
                                            int sq, int sk, int tiles, int causal) {
  constexpr int kAtom = kDkvAtom;
  const int c = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // this thread's keys key and key + 8
  const int key = key0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  float acc_k[kDkvAcc], acc_v[kDkvAcc], part[kPartAcc], s[kSAcc], dp[kSAcc];
#pragma unroll
  for (int i = 0; i < kDkvAcc; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (tiles > 0) {
    const uint64_t kd = wgmma_desc_sw128(smem_addr(m.res(0)));
    const uint64_t vd = wgmma_desc_sw128(smem_addr(m.res(1)));
    // the consumer's 32 queries of a tile (B of S^T, dP^T)
    auto half = [&](int st, int o) {
      return wgmma_desc_sw128(smem_addr(m.tile(st, o) + c * kHalfTile * 128));
    };
    // atom 2c + h of a tile's Q (o = 0) or dO (o = 1): B of dK's or dV's chunk h
    auto cols = [&](int st, int o, int h) {
      return wgmma_desc_sw128(smem_addr(m.tile(st, o) + (kConsumers * c + h) * kAtom));
    };
    auto buf = [&](int b, int o) { return wgmma_desc_sw128(smem_addr(m.probs(b, o))); };
    // the tile's P^T and dS^T in buffer b, both consumers' halves, once both meet
    auto write_probs = [&](int j, int st, int b) {
      dkv_tile_probs<K>(m.probs(b, 0), m.probs(b, 1), s, dp, m.lse(st), m.delta(st), key, key0,
                        q_begin + j * kDkvTile, sq, sk, causal);
      named_sync(1, kConsumerThreads);
    };
    // dV's chunks 0, 1 and dK's chunk 0 of the tile, each waited for and added
    auto first_chunks = [&](int st, int b) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const int o = n < 2 ? 1 : 0;  // dV = P^T dO, then dK = dS^T Q
        wgmma_fence();
        dkv_part(part, buf(b, n < 2 ? 0 : 1), cols(st, o, n % 2));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(part);
        if (n < 2) {
          add_part(acc_v, part, n);
        } else {
          add_part(acc_k, part, 0);
        }
      }
    };
    mbar_wait(m.res_full(), 0);
    mbar_wait(m.full(0), 0);
    wgmma_fence();
    products_over_d<kAtom, kAtom>(s, kd, half(0, 0));   // S^T = K Q^T
    products_over_d<kAtom, kAtom>(dp, vd, half(0, 1));  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
#pragma unroll 1
    for (int j = 0; j + 1 < tiles; ++j) {
      const int st = j % kDkvStages;
      const int next = (j + 1) % kDkvStages;
      const int b = j & 1;
      write_probs(j, st, b);
      first_chunks(st, b);
      if constexpr (L::kFusedN) dq_chunk(m, st, b, 1, part);
      mbar_wait(m.full(next), ((j + 1) / kDkvStages) & 1);
      wgmma_fence();
      dkv_part(part, buf(b, 1), cols(st, 0, 1));  // dK's chunk 1
      products_over_d<kAtom, kAtom>(s, kd, half(next, 0));
      products_over_d<kAtom, kAtom>(dp, vd, half(next, 1));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(part);
      reg_fence(s);
      reg_fence(dp);
      if constexpr (!L::kFusedN) release(m, st);
      add_part(acc_k, part, 1);
      if constexpr (L::kFusedN) dq_chunk(m, st, b, 0, part);
    }
    const int last = tiles - 1;
    const int st = last % kDkvStages;
    const int b = last & 1;
    write_probs(last, st, b);
    first_chunks(st, b);
    if constexpr (L::kFusedN) dq_chunk(m, st, b, 1, part);
    wgmma_fence();
    dkv_part(part, buf(b, 1), cols(st, 0, 1));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    if constexpr (!L::kFusedN) release(m, st);
    add_part(acc_k, part, 1);
    if constexpr (L::kFusedN) dq_chunk(m, st, b, 0, part);
  }
  store_rows<kDkvCols>(dk, acc_k, key, kDkvCols * c, sk, 1.f);
  // dO arrived multiplied by ln2 for ds; dv must not carry it
  store_rows<kDkvCols>(dv, acc_v, key, kDkvCols * c, sk, kLog2e);
}

// The producer warpgroup's second warp in kernels 3 and 4: each q tile's
// lse2 and delta rows (0 past sq) with plain loads and stores, as
// wg::produce_q_tiles copies them (a head's f32 rows start at any 4-byte
// offset, where TMA needs 16-byte aligned addresses), one of the stage's two
// fills
template <class L>
__device__ __forceinline__ void produce_rows(const Smem<L>& m,
                                             const float* __restrict__ lse2,
                                             const float* __restrict__ delta, int sq,
                                             int q_begin, int tiles) {
  const int lane = threadIdx.x % 32;
  for (int j = 0; j < tiles; ++j) {
    const int st = claim(m, j);
    const int q0 = q_begin + j * kDkvTile;
#pragma unroll
    for (int i = lane; i < kDkvTile; i += 32) {
      const bool ok = q0 + i < sq;
      m.lse(st)[i] = ok ? lse2[q0 + i] : 0.f;
      m.delta(st)[i] = ok ? delta[q0 + i] : 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(m.full(st));
  }
}

}  // namespace wd

// Kernel 2 on the wgmma route at D = 256. Grid: one block per (bh,
// wd::kDqRows query rows), flattened into blockIdx.x; wd::kThreads threads,
// wd::DqLayout::kBytes of dynamic shared memory. Warpgroups 0 and 1
// consume, 2 produces: its first thread loads by TMA the block's Q and dO
// rows (maps of (256, sq, bh), box 64 columns x 128 rows) and the K and V
// tiles (maps of (256, sk, bh), box 64 columns x 32 keys), four boxes an
// operand.
template <int K>
__global__ void __launch_bounds__(wd::kThreads, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int sq, int sk, int num_qb, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const wd::Smem<wd::DqLayout> m = wd::make_smem<wd::DqLayout>(smem_raw, 1);
  const int bh = blockIdx.x / num_qb;
  const int q0 = (blockIdx.x % num_qb) * wd::kDqRows;
  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, q0 + wd::kDqRows) : sk;
  const int tiles = (kv_end + wd::kDqTile - 1) / wd::kDqTile;
  if (threadIdx.x >= wd::kConsumerThreads) {
    regs_lower<wd::kProducerRegs>();
    if (threadIdx.x != wd::kConsumerThreads) return;
    wd::produce(m, &q_map, &do_map, &k_map, &v_map, bh, q0, 0, tiles);
  } else {
    regs_raise<wd::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sq;
    wd::dq_consume<K>(m, lse2 + head, delta + head, dq + head * wd::kD,
                      q0 + threadIdx.x / 128 * wd::kRows, sq, sk, tiles, causal);
  }
}

// Kernel 3 on the wgmma route at D = 256. Grid: one block per (bh,
// wd::kDkvKeys keys), flattened into blockIdx.x; threads and roles as
// kernel 2's, with K and V resident (box 64 keys) and Q, dO streamed (box
// 64 rows), wd::DkvLayout::kBytes of dynamic shared memory; the producer's
// second warp copies each q tile's lse2 and delta rows (wd::produce_rows).
template <int K>
__global__ void __launch_bounds__(wd::kThreads, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse2, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                          int num_kb, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const wd::Smem<wd::DkvLayout> m = wd::make_smem<wd::DkvLayout>(smem_raw, 2);
  const int bh = blockIdx.x / num_kb;
  const int k0 = (blockIdx.x % num_kb) * wd::kDkvKeys;
  // under the causal mask, query rows before the block's first key are dead
  // (k0 is a multiple of the q tile)
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + wd::kDkvTile - 1) / wd::kDkvTile : 0;
  if (threadIdx.x >= wd::kConsumerThreads) {
    regs_lower<wd::kProducerRegs>();
    const int pt = threadIdx.x - wd::kConsumerThreads;
    if (pt == 0) {
      wd::produce(m, &k_map, &v_map, &q_map, &do_map, bh, k0, q_begin, tiles);
    } else if (pt / 32 == 1) {
      const size_t rows = static_cast<size_t>(bh) * sq;
      wd::produce_rows(m, lse2 + rows, delta + rows, sq, q_begin, tiles);
    }
  } else {
    regs_raise<wd::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sk * wd::kD;
    wd::dkv_consume<K>(m, dk + head, dv + head, k0, q_begin, sq, sk, tiles, causal);
  }
}

// Kernel 4 on the wgmma route at D = 256. Grid, threads, maps and roles as
// kernel 3's at D = 256, wd::FusedLayout::kBytes of dynamic shared memory;
// the producer's third and fourth warps' first threads add the staged dq
// parts of the q tiles of stage 0 and of stage 1 (wd::reduce_dq). The key
// blocks of a head fall into `groups` interleaved groups (key block kb in
// group kb % groups), each with its own f32 dq buffer (the map `dq_map` of
// the caller's zeroed (groups, bh, sq, 256) buffer seen as (256, sq, groups
// * bh), box 32 columns x 64 rows in the 128-byte swizzle) and its own
// counters, dq_lock, int (groups, bh, ceil(sq / 64)), zeroed by the caller,
// who sums the groups' buffers: as flash_bwd_fused_wgmma_kernel's.
template <int K>
__global__ void __launch_bounds__(wd::kThreads, 1)
flash_bwd_fused_wide_kernel(const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __grid_constant__ CUtensorMap dq_map,
                            const float* __restrict__ lse2, const float* __restrict__ delta,
                            int* __restrict__ dq_lock, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int sq, int sk, int num_kb, int causal,
                            int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const wd::Smem<wd::FusedLayout> m = wd::make_smem<wd::FusedLayout>(smem_raw, 2);
  const int bh = blockIdx.x / num_kb;
  const int kbi = blockIdx.x % num_kb;
  const int k0 = kbi * wd::kDkvKeys;
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + wd::kDkvTile - 1) / wd::kDkvTile : 0;
  const int q_tiles = (sq + wd::kDkvTile - 1) / wd::kDkvTile;
  // this block's dq buffer and counters: its group's, and in them its head's
  const int gbh = kbi % groups * (gridDim.x / num_kb) + bh;
  if (threadIdx.x >= wd::kConsumerThreads) {
    regs_lower<wd::kProducerRegs>();
    const int pt = threadIdx.x - wd::kConsumerThreads;
    if (pt == 0) {
      wd::produce(m, &k_map, &v_map, &q_map, &do_map, bh, k0, q_begin, tiles);
    } else if (pt / 32 == 1) {
      const size_t rows = static_cast<size_t>(bh) * sq;
      wd::produce_rows(m, lse2 + rows, delta + rows, sq, q_begin, tiles);
    } else if (pt % 32 == 0) {  // a block waits for the blocks of its group before it
      wd::reduce_dq(m, &dq_map, dq_lock + static_cast<size_t>(gbh) * q_tiles, kbi / groups, gbh,
                    q_begin, tiles, pt / 32 - 2);
    }
  } else {
    regs_raise<wd::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sk * wd::kD;
    wd::dkv_consume<K>(m, dk + head, dv + head, k0, q_begin, sq, sk, tiles, causal);
  }
}

// ---- kernels 2 and 3 on the TF32 route at D = 128 and 256: f32, streamed over D ----

namespace ts {

constexpr int kAtomCols = 32;    // f32 columns of an atom: one 128-byte swizzle row, one TMA box
constexpr int kRows = 64;        // resident rows of a block (kernel 2: queries, 3: keys): wgmma's M
constexpr int kTile = 32;        // streamed rows of a tile (kernel 2: keys, 3: queries)
constexpr int kConsumerThreads = 2 * 128;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;  // arrivals that empty a stage
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;
constexpr int kAcc = 16;                    // accumulator floats of an m64n32 tile
constexpr int kPartAcc = 32;                // accumulator floats of an m64n64 tile
constexpr int kSteps = kAtomCols / 8;       // k8 steps of an atom (or of a tile's 32 rows)
constexpr int kResAtom = kRows * 128;       // 8 KB: an atom of a resident operand
constexpr int kTileAtom = kTile * 128;      // 4 KB: an atom of a streamed tile
constexpr int kStageBytes = 4 * kTileAtom;  // a stage: four atoms (two, then their lo parts)
constexpr int kBufBytes = kRows * 128;      // a tile product's B operand, hi or lo: 64 rows x 32
constexpr int kXLd = kTile + 8;             // floats a row of the P exchange (float2s in distinct banks)
constexpr int kXBytes = kRows * kXLd * 4;
static_assert(kTile == kAtomCols, "a row of a B buffer is one 128-byte swizzle row");
static_assert(kXBytes % 1024 == 0, "the ring starts 1024-byte aligned");

// Dynamic shared memory from a 1024-byte-aligned base, for kAtoms = D / 32
// atoms a row: the two resident operands (Q and dO, or K and V: 64 rows,
// raw f32 as TMA wrote them, atom a at a * kResAtom), the tile products' B
// operands (kernel 2: dS hi, lo; kernel 3 (kDkv): P^T hi, lo, dS^T hi, lo;
// 64 rows of 32 positions each), the P exchange (64 x kXLd f32), the ring
// (as many stages as the rest leaves room for), then its full, ready and
// empty barriers and the resident operands' one. kLoads is the stages of a
// tile: kAtoms for the d products (two atoms a stage, then their lo
// parts), then for the tile products two 64-column slabs a stage (four raw
// atoms): kernel 2's kAtoms / 4 (K), kernel 3's kAtoms / 2 (dO, then Q, of
// each pair of slabs)
template <int kAtoms, bool kDkv>
struct Layout {
  static constexpr int kAtomsN = kAtoms;
  static constexpr bool kDkvN = kDkv;
  static constexpr int kSlabs = kAtoms / 2;  // m64 slabs of D in the tile products
  static constexpr int kPairs = kSlabs / 2;  // tile-product stages of one operand
  static constexpr int kLoads = kAtoms + (kDkv ? 2 : 1) * kPairs;
  static constexpr int kResBytes = kAtoms * kResAtom;
  static constexpr int kBufAt = 2 * kResBytes;
  static constexpr int kXAt = kBufAt + (kDkv ? 4 : 2) * kBufBytes;
  static constexpr int kRingAt = kXAt + kXBytes;
  static constexpr int kStagesN = (232448 - 1024 - 256 - kRingAt) / kStageBytes;
  static constexpr int kBarsAt = kRingAt + kStagesN * kStageBytes;
  static constexpr int kBytes = kBarsAt + (3 * kStagesN + 1) * 8 + 1024;  // + alignment
  static_assert(kStagesN >= 3 && kBytes <= 232448, "shared memory of one block");
};

template <class L>
struct Smem {
  unsigned char* base;  // 1024-byte aligned
  uint64_t* bars;

  // resident operand o (0: Q or K, 1: dO or V)
  __device__ unsigned char* res(int o) const { return base + o * L::kResBytes; }
  // B operand buffer b (as Layout lists them)
  __device__ unsigned char* buf(int b) const { return base + L::kBufAt + b * kBufBytes; }
  __device__ float* xch() const { return reinterpret_cast<float*>(base + L::kXAt); }
  __device__ unsigned char* stage(int st) const { return base + L::kRingAt + st * kStageBytes; }
  // a stage's raw atoms are in (TMA), split (converters), free again (consumers)
  __device__ uint64_t* full(int st) const { return bars + st; }
  __device__ uint64_t* ready(int st) const { return bars + L::kStagesN + st; }
  __device__ uint64_t* empty(int st) const { return bars + 2 * L::kStagesN + st; }
  __device__ uint64_t* res_full() const { return bars + 3 * L::kStagesN; }
};

// the layout in this block's dynamic shared memory, its barriers
// initialised (the one __syncthreads of the kernels: the roles split after
// it)
template <class L>
__device__ __forceinline__ Smem<L> make_smem(unsigned char* raw) {
  Smem<L> m;
  m.base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  m.bars = reinterpret_cast<uint64_t*>(m.base + L::kBarsAt);
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStagesN; ++st) {
      mbar_init(m.full(st));
      mbar_init(m.ready(st), tf::kConverterWarps);
      mbar_init(m.empty(st), kConsumerWarps);
    }
    mbar_init(m.res_full());
    mbar_fence_init();
  }
  __syncthreads();
  return m;
}

// The producer warpgroup's first thread: the block's two resident operands
// (maps r0, r1, box 32 columns x 64 rows from row res_row) once, then the
// kLoads stages of each tile (rows tile_row + j kTile; maps t0, t1, box 32
// columns x 32 rows): atom a of t0 and of t1 for the d products; then for
// the tile products the four atoms of each pair of 64-column slabs, of t0
// (kernel 2: K) or of t1 and then t0 (kernel 3: dO, then Q); rows past the
// tensor's read as 0
template <class L>
__device__ __forceinline__ void produce(const Smem<L>& m, const CUtensorMap* r0,
                                        const CUtensorMap* r1, const CUtensorMap* t0,
                                        const CUtensorMap* t1, int bh, int res_row, int tile_row,
                                        int tiles) {
  if (tiles == 0) return;
  mbar_expect(m.res_full(), 2 * L::kResBytes);
  for (int a = 0; a < L::kAtomsN; ++a) {
    tma_load_3d(m.res(0) + a * kResAtom, r0, m.res_full(), a * kAtomCols, res_row, bh);
    tma_load_3d(m.res(1) + a * kResAtom, r1, m.res_full(), a * kAtomCols, res_row, bh);
  }
  int g = 0;  // loads so far
  for (int j = 0; j < tiles; ++j) {
    const int row = tile_row + j * kTile;
    for (int l = 0; l < L::kLoads; ++l, ++g) {
      const int st = g % L::kStagesN;
      if (g >= L::kStagesN) mbar_wait(m.empty(st), (g / L::kStagesN - 1) & 1);
      if (l < L::kAtomsN) {
        mbar_expect(m.full(st), 2 * kTileAtom);
        tma_load_3d(m.stage(st), t0, m.full(st), l * kAtomCols, row, bh);
        tma_load_3d(m.stage(st) + kTileAtom, t1, m.full(st), l * kAtomCols, row, bh);
      } else {
        const int u = l - L::kAtomsN;  // the tile products' load
        const CUtensorMap* map = L::kDkvN && u % 2 == 0 ? t1 : t0;
        const int col = 4 * kAtomCols * (L::kDkvN ? u / 2 : u);
        mbar_expect(m.full(st), 4 * kTileAtom);
        for (int i = 0; i < 4; ++i) {
          tma_load_3d(m.stage(st) + i * kTileAtom, map, m.full(st), col + i * kAtomCols, row, bh);
        }
      }
    }
  }
}

// The converters (the producer warpgroup's warps 1-3): the TF32 split of
// each d-product stage as TMA lands it (hi over the raw atoms, lo after
// them: B operands of the d products); the tile products' stages stay raw
// (their atoms are A operands, split by the consumers as they load them)
template <class L>
__device__ __forceinline__ void convert(const Smem<L>& m, int tiles) {
  const int ct = threadIdx.x - kConsumerThreads - 32;
  int g = 0;
  for (int j = 0; j < tiles; ++j) {
    for (int l = 0; l < L::kLoads; ++l, ++g) {
      const int st = g % L::kStagesN;
      mbar_wait(m.full(st), (g / L::kStagesN) & 1);
      if (l < L::kAtomsN) {  // hi over the raw atoms, lo at the same offset after them
        // this thread's 16-byte pieces, all loaded before any is split
        unsigned char* hi = m.stage(st);
        constexpr int kPer = (2 * kTileAtom / 16 + tf::kConverterThreads - 1) /
                             tf::kConverterThreads;
        float4 x[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int o = 16 * (ct + i * tf::kConverterThreads);
          if (o < 2 * kTileAtom) x[i] = *reinterpret_cast<const float4*>(hi + o);
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int o = 16 * (ct + i * tf::kConverterThreads);
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
        fence_proxy_async();
      }
      warp_arrive(m.ready(st));
    }
  }
}

// The probabilities of one tile, from the d products' accumulators (x:
// consumer 0's S or S^T, consumer 1's dP or dP^T; element 4i + 2h + e is
// resident row rw + 8h, tile column 8i + 2t + e). Consumer 0 computes p
// (once consumer 1 is done with the last tile's), writes it to the
// exchange and, kernel 3, its TF32 hi and lo to the P^T buffers; consumer 1
// then reads it and writes ds's hi and lo to the dS (or dS^T) buffers. A
// buffer row is a resident row, column c of the tile at position tile_pos(c)
// (8i + 4e + t), the k order in which the tile products' A fragments read
// the tile's rows. stat: kernel 2, the lse2 (consumer 0) or delta of rows
// rw, rw + 8; kernel 3, of columns 8i + 2t + e. kMasked: the pair (resident
// row r0 + row, tile column t0 + col) is live only inside sq, sk and the
// causal diagonal
template <class L, int K, bool kMasked>
__device__ __forceinline__ void tile_probs(const Smem<L>& m, const float (&x)[kAcc],
                                           const float (&stat)[4][2], int rw, int r0, int t0,
                                           int sq, int sk, int causal, float sscale, int j) {
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 4;
  float* xch = m.xch();
  if (c == 0) {
    if (j > 0) named_sync(1, kConsumerThreads);  // consumer 1 is done with tile j - 1
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw + 8 * h;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * t + e;
          const int q = L::kDkvN ? t0 + col : r0 + row;
          const int k = L::kDkvN ? r0 + row : t0 + col;
          const bool live = !kMasked || (q < sq && k < sk && (!causal || k <= q));
          p[e] = prob<K>(x[4 * i + 2 * h + e], L::kDkvN ? stat[i][e] : stat[h][0], live, sscale);
          if constexpr (L::kDkvN) {
            uint32_t hi, lo;
            split_tf32_bits(p[e], hi, lo);
            const int at = swizzle128_f32(row, 8 * i + 4 * e + t);
            *reinterpret_cast<uint32_t*>(m.buf(0) + at) = hi;
            *reinterpret_cast<uint32_t*>(m.buf(1) + at) = lo;
          }
        }
        *reinterpret_cast<float2*>(xch + row * kXLd + 8 * i + 2 * t) = make_float2(p[0], p[1]);
      }
    }
    if constexpr (L::kDkvN) fence_proxy_async();
    named_arrive(2, kConsumerThreads);
  } else {
    named_sync(2, kConsumerThreads);
    unsigned char* ds_hi = m.buf(L::kDkvN ? 2 : 0);
    unsigned char* ds_lo = m.buf(L::kDkvN ? 3 : 1);
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw + 8 * h;
        const float2 p = *reinterpret_cast<const float2*>(xch + row * kXLd + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ds = grad_s<K>(e ? p.y : p.x, x[4 * i + 2 * h + e],
                                     L::kDkvN ? stat[i][e] : stat[h][0], sscale);
          uint32_t hi, lo;
          split_tf32_bits(ds, hi, lo);
          const int at = swizzle128_f32(row, 8 * i + 4 * e + t);
          *reinterpret_cast<uint32_t*>(ds_hi + at) = hi;
          *reinterpret_cast<uint32_t*>(ds_lo + at) = lo;
        }
      }
    }
    fence_proxy_async();
  }
  named_sync(3, kConsumerThreads);  // the buffers are whole
}

// A consumer warpgroup of either kernel (c = 0 or 1), over the block's 64
// resident rows (from r0) and `tiles` tiles of 32 streamed rows (from
// t_begin). Per tile:
// - the d products: consumer c's x = R_c T_c^T over d (kernel 2: S = Q K^T,
//   dP = dO V^T; kernel 3: S^T = K Q^T, dP^T = V dO^T), one stage an atom:
//   A this thread's fragments of resident operand c, loaded from its raw
//   atom and split into TF32 hi and lo in registers, B the stage's split
//   atom of T_c; each atom's part (lo x hi over its 4 k-steps, then hi x
//   lo, then hi x hi) from zero, added in f32;
// - tile_probs;
// - the tile products, transposed so that the streamed tile is A (from
//   registers) and all 64 resident rows are N: kernel 2 dq^T += K^T dS^T,
//   kernel 3 dV^T += dO^T P and dK^T += Q^T dS, two m64 slabs of D a
//   stage, consumer c taking slab 2p + c of pair p, each part (m64n64)
//   summed over the tile's 32 rows from zero and added in f32. Accumulator
//   element 4i + 2h + e of pair p is d = 64 (2p + c) + 16 w + g + 8h of
//   resident row 8i + 2t + e.
// out0: dq (kernel 2) or dk, out1: dv, each (rows, D) of the head; rows at
// or past `limit` are not stored.
template <class L, int K>
__device__ __forceinline__ void consume(const Smem<L>& m, const float* __restrict__ lse2,
                                        const float* __restrict__ delta, float* __restrict__ out0,
                                        float* __restrict__ out1, int r0, int t_begin, int sq,
                                        int sk, int tiles, int causal, float sscale) {
  constexpr int kAtoms = L::kAtomsN;
  constexpr int kPairs = L::kPairs;
  constexpr int kD = kAtoms * kAtomCols;
  constexpr int kProds = L::kDkvN ? 2 : 1;  // kernel 3: dV^T (0) and dK^T (1)
  constexpr int S = L::kStagesN;
  const int c = threadIdx.x / 128;
  const int w = threadIdx.x % 128 / 32;
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  const int rw = 16 * w + g;  // this thread's A and C rows rw and rw + 8
  float acc[kProds][kPairs][kPartAcc];
#pragma unroll
  for (int p = 0; p < kProds; ++p) {
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
#pragma unroll
      for (int i = 0; i < kPartAcc; ++i) acc[p][s][i] = 0.f;
    }
  }
  // kernel 2: the lse2 (consumer 0) or delta (consumer 1) of rows rw, rw + 8
  float stat[4][2] = {};
  const float* __restrict__ stats = c == 0 ? lse2 : delta;
  if constexpr (!L::kDkvN) {
#pragma unroll
    for (int h = 0; h < 2; ++h) stat[h][0] = r0 + rw + 8 * h < sq ? stats[r0 + rw + 8 * h] : 0.f;
  }
  if (tiles > 0) mbar_wait(m.res_full(), 0);
  const unsigned char* res = m.res(c) + rw * 128;
  int gl = 0;  // loads so far
#pragma unroll 1
  for (int j = 0; j < tiles; ++j) {
    const int t0 = t_begin + j * kTile;
    if constexpr (L::kDkvN) {  // the lse2 or delta of this thread's columns
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = t0 + 8 * i + 2 * t + e;
          stat[i][e] = q < sq ? stats[q] : 0.f;
        }
      }
    }
    float x[kAcc], part[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) x[i] = 0.f;
#pragma unroll 1
    for (int a = 0; a < kAtoms; ++a, ++gl) {
      const int st = gl % S;
      // this thread's A fragments of atom a: rows rw + 8h, columns 8ks + t + 4e
      uint32_t ah[kSteps][4], al[kSteps][4];
      const unsigned char* ra = res + a * kResAtom;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v =
                *reinterpret_cast<const float*>(ra + h * 1024 + (((2 * ks + e) ^ g) << 4) + 4 * t);
            split_tf32_bits(v, ah[ks][2 * e + h], al[ks][2 * e + h]);
          }
        }
      }
      mbar_wait(m.ready(st), (gl / S) & 1);
      const uint64_t bh = wgmma_desc_sw128(smem_addr(m.stage(st) + c * kTileAtom));
      const uint64_t bl = wgmma_desc_sw128(smem_addr(m.stage(st) + (2 + c) * kTileAtom));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32_rs_n32(part, al[ks], desc_at(bh, 32 * ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32_rs_n32(part, ah[ks], desc_at(bl, 32 * ks), 1);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32_rs_n32(part, ah[ks], desc_at(bh, 32 * ks), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(part);
      reg_fence(ah);
      reg_fence(al);
      warp_arrive(m.empty(st));
#pragma unroll
      for (int i = 0; i < kAcc; ++i) x[i] += part[i];
    }
    const bool edge = L::kDkvN
        ? r0 + kRows > sk || t0 + kTile > sq || (causal && r0 + kRows - 1 > t0)
        : r0 + kRows > sq || t0 + kTile > sk || (causal && t0 + kTile - 1 > r0);
    if (edge) {
      tile_probs<L, K, true>(m, x, stat, rw, r0, t0, sq, sk, causal, sscale, j);
    } else {
      tile_probs<L, K, false>(m, x, stat, rw, r0, t0, sq, sk, causal, sscale, j);
    }
    // the tile products: load u of the tile is slab pair u (kernel 2) or
    // pair u / 2, dV^T for even u and dK^T for odd (kernel 3)
    float tp[kPartAcc];
#pragma unroll
    for (int u = 0; u < L::kLoads - kAtoms; ++u, ++gl) {
      const int pair = L::kDkvN ? u / 2 : u;
      const int prod = L::kDkvN ? u % 2 : 0;
      const int st = gl % S;
      mbar_wait(m.ready(st), (gl / S) & 1);
      mbar_wait(m.full(st), (gl / S) & 1);
      // A: slab c's d (rows 16w + g + 8hh: column 16 (w % 2) + g + 8hh of
      // atom 2c + w / 2) x the tile's rows 8ks + 2t + e (k positions t + 4e)
      const unsigned char* at = m.stage(st) + (2 * c + w / 2) * kTileAtom;
      uint32_t fh[kSteps][4], fl[kSteps][4];
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * ks + 2 * t + e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = 16 * (w % 2) + g + 8 * hh;
            const float v = *reinterpret_cast<const float*>(
                at + row * 128 + (((col / 4) ^ (row % 8)) << 4) + 4 * (col % 4));
            split_tf32_bits(v, fh[ks][2 * e + hh], fl[ks][2 * e + hh]);
          }
        }
      }
      // B: the 64 rows of P^T (kernel 3's dV), dS^T (its dK) or dS (kernel
      // 2), hi then lo
      const unsigned char* b = m.buf(2 * prod);
      const uint64_t bh = wgmma_desc_sw128(smem_addr(b));
      const uint64_t bl = wgmma_desc_sw128(smem_addr(b + kBufBytes));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32_rs_n64(tp, fl[ks], desc_at(bh, 32 * ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32_rs_n64(tp, fh[ks], desc_at(bl, 32 * ks), 1);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32_rs_n64(tp, fh[ks], desc_at(bh, 32 * ks), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(tp);
      reg_fence(fh);
      reg_fence(fl);
      warp_arrive(m.empty(st));
#pragma unroll
      for (int i = 0; i < kPartAcc; ++i) acc[prod][pair][i] += tp[i];
    }
    // consumer 0 may overwrite the exchange and the buffers for tile j + 1
    if (c == 1 && j + 1 < tiles) named_arrive(1, kConsumerThreads);
  }
  const int limit = L::kDkvN ? sk : sq;
#pragma unroll
  for (int p = 0; p < kProds; ++p) {
    // kernel 3's dv: dO arrived multiplied by ln2 for ds (not under kUpcast)
    float* out = L::kDkvN && p == 0 ? out1 : out0;
    const float mul = L::kDkvN && p == 0 && K != kUpcast ? kLog2e : 1.f;
#pragma unroll
    for (int i = 0; i < kPartAcc / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + 8 * i + 2 * t + e;
        if (row >= limit) continue;
        float* dst = out + static_cast<size_t>(row) * kD + 64 * c + rw;
#pragma unroll
        for (int s = 0; s < kPairs; ++s) {
#pragma unroll
          for (int h = 0; h < 2; ++h) dst[128 * s + 8 * h] = acc[p][s][4 * i + 2 * h + e] * mul;
        }
      }
    }
  }
}

}  // namespace ts

// Kernel 2 on the TF32 route at D = 32 kAtoms (128, 256). Grid: one block
// per (bh, 64 query rows), flattened into blockIdx.x; ts::kThreads threads,
// ts::Layout<kAtoms, false>::kBytes of dynamic shared memory. Warpgroups 0
// and 1 consume; in warpgroup 2 the first thread loads by TMA the block's Q
// and dO rows (maps of (D, sq, bh), box 32 columns x 64 rows) and the K and
// V atoms (maps of (D, sk, bh), box 32 columns x 32 keys), and warps 1-3
// convert (ts::convert).
template <int kAtoms, int K>
__global__ void __launch_bounds__(ts::kThreads, 1)
flash_bwd_dq_stream_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const float* __restrict__ lse2, const float* __restrict__ delta,
                           float* __restrict__ dq, int sq, int sk, int num_qb, int causal,
                           float sscale) {
  using L = ts::Layout<kAtoms, false>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ts::Smem<L> m = ts::make_smem<L>(smem_raw);
  const int bh = blockIdx.x / num_qb;
  const int q0 = (blockIdx.x % num_qb) * ts::kRows;
  // under the causal mask, keys past the block's last row are dead for every row
  const int kv_end = causal ? min(sk, q0 + ts::kRows) : sk;
  const int tiles = (kv_end + ts::kTile - 1) / ts::kTile;
  if (threadIdx.x >= ts::kConsumerThreads) {
    regs_lower<ts::kProducerRegs>();
    const int pt = threadIdx.x - ts::kConsumerThreads;
    if (pt == 0) {
      ts::produce(m, &q_map, &do_map, &k_map, &v_map, bh, q0, 0, tiles);
    } else if (pt >= 32) {
      ts::convert(m, tiles);
    }
  } else {
    regs_raise<ts::kConsumerRegs>();
    const size_t head = static_cast<size_t>(bh) * sq;
    ts::consume<L, K>(m, lse2 + head, delta + head, dq + head * kAtoms * ts::kAtomCols, nullptr,
                      q0, 0, sq, sk, tiles, causal, sscale);
  }
}

// Kernel 3 on the TF32 route at D = 32 kAtoms. Grid: one block per (bh, 64
// keys), flattened into blockIdx.x; threads and roles as kernel 2's, with K
// and V resident (box 64 keys) and Q, dO streamed (box 32 rows),
// ts::Layout<kAtoms, true>::kBytes of dynamic shared memory.
template <int kAtoms, int K>
__global__ void __launch_bounds__(ts::kThreads, 1)
flash_bwd_dkv_stream_kernel(const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse2, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
                            int num_kb, int causal, float sscale) {
  using L = ts::Layout<kAtoms, true>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ts::Smem<L> m = ts::make_smem<L>(smem_raw);
  const int bh = blockIdx.x / num_kb;
  const int k0 = (blockIdx.x % num_kb) * ts::kRows;
  // under the causal mask, query rows before the block's first key are dead
  // (k0 is a multiple of the q tile)
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + ts::kTile - 1) / ts::kTile : 0;
  if (threadIdx.x >= ts::kConsumerThreads) {
    regs_lower<ts::kProducerRegs>();
    const int pt = threadIdx.x - ts::kConsumerThreads;
    if (pt == 0) {
      ts::produce(m, &k_map, &v_map, &q_map, &do_map, bh, k0, q_begin, tiles);
    } else if (pt >= 32) {
      ts::convert(m, tiles);
    }
  } else {
    regs_raise<ts::kConsumerRegs>();
    const size_t rows = static_cast<size_t>(bh) * sq;
    const size_t head = static_cast<size_t>(bh) * sk * kAtoms * ts::kAtomCols;
    ts::consume<L, K>(m, lse2 + rows, delta + rows, dk + head, dv + head, k0, q_begin, sq, sk,
                      tiles, causal, sscale);
  }
}

// ---- the test entry of the one s, dp computation ----

// Block i takes tile i: 16 queries (q, dout, lse2, delta) and 16 keys (k,
// v). Warp 0 computes s, dp and ds query-major, as kernel 2 does (A = Q,
// dO), warp 1 key-major, as kernels 3 and 4 do (A = K, V); both through
// sdp_products and prob_ds of contract K, every pair live. out (2 roles, 3
// quantities s, dp, ds, tiles, 16 queries, 16 keys), f32.
template <typename T, int D, int K>
__global__ void __launch_bounds__(kThreads)
flash_bwd_roles_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse2, const float* __restrict__ delta,
                       float* __restrict__ out, int tiles, float sscale) {
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
        prob_ds<K>(s[n][2 * h + e], dp[n][2 * h + e], sLse[qi], sDelta[qi], true, sscale, p, ds);
        o[qi * 16 + ki] = s[n][2 * h + e];
        o[plane + qi * 16 + ki] = dp[n][2 * h + e];
        o[2 * plane + qi * 16 + ki] = ds;
      }
    }
  }
}

enum class Entry { kDq, kDkv, kFused, kRoles };

// the bodies of kernels 2, 3 and 4, chosen by ops/flash_attention.py::attention_route
enum Route : int { kRouteMma = 0, kRouteWgmma = 1, kRouteTf32 = 2 };

struct Args {
  const void *q, *k, *v, *dout, *lse2, *delta;
  void *out0, *out1, *out2;  // dq; or dk and dv; or the f32 dq buffer, dk and dv
  void* dq_lock;  // kernel 4's dq counters, else nullptr
  int groups;  // kernel 4's groups of key blocks (1 on the mma.sync route), else 1
  int bh, sq, sk, causal;  // the roles entry: bh = tiles
  int contract;  // a Contract of flash_contract.cuh
  float sscale;  // the softmax scale under kUpcast, else unread
  int route;  // a Route: the body of kernels 2, 3 and 4 (the roles entry: kRouteMma)
  cudaStream_t stream;
};

template <typename T, int D, int K>
int launch_dq(const Args& a) {
  using C = DqCfg<T, D>;
  static_assert(C::kSmem <= 232448, "shared memory of one block");
  auto kernel = flash_bwd_dq_kernel<T, D, K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_qb = (a.sq + C::kBr - 1) / C::kBr;
  kernel<<<num_qb * a.bh, kThreads, C::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.sq, a.sk, num_qb, a.causal,
      a.sscale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool Fused, int K>
int launch_dkv(const Args& a) {
  using C = DkvCfg<T, D>;
  static_assert(C::kSmem <= 232448, "shared memory of one block");
  // only the kernel launched is instantiated (kernel 4 at bf16 D = 64 needs no kernel 3)
  auto kernel = [] {
    if constexpr (Fused) return flash_bwd_fused_kernel<T, D, K>;
    else return flash_bwd_dkv_kernel<T, D, K>;
  }();
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
      Fused ? static_cast<int*>(a.dq_lock) : nullptr, a.sq, a.sk, num_kb, a.causal, a.sscale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int K>
int launch_roles(const Args& a) {
  constexpr size_t smem = (sizeof(T) * 4 * 16 * (D + 16 / sizeof(T))) + sizeof(float) * 32;
  auto kernel = flash_bwd_roles_kernel<T, D, K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.bh, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<float*>(a.out0), a.bh, a.sscale);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_dq_wgmma(const Args& a) {
  CUtensorMap maps[2];
  cudaError_t err = encode_head_rows_map(&maps[0], a.k, wg::kD, a.sk, a.bh, wg::kD, wg::kTile);
  if (err == cudaSuccess) {
    err = encode_head_rows_map(&maps[1], a.v, wg::kD, a.sk, a.bh, wg::kD, wg::kTile);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = flash_bwd_dq_wgmma_kernel<K>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_qb = (a.sq + wg::kBlockRows - 1) / wg::kBlockRows;
  kernel<<<num_qb * a.bh, wg::kThreads, wg::kSmemBytes, a.stream>>>(
      maps[0], maps[1], static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse2), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.sq, a.sk, num_qb, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_dkv_wgmma(const Args& a) {
  CUtensorMap maps[2];
  cudaError_t err = encode_head_rows_map(&maps[0], a.q, wg::kD, a.sq, a.bh, wg::kD, wg::kTile);
  if (err == cudaSuccess) {
    err = encode_head_rows_map(&maps[1], a.dout, wg::kD, a.sq, a.bh, wg::kD, wg::kTile);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = flash_bwd_dkv_wgmma_kernel<K>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_kb = (a.sk + wg::kBlockRows - 1) / wg::kBlockRows;
  kernel<<<num_kb * a.bh, wg::kThreads, wg::kSmemBytes, a.stream>>>(
      maps[0], maps[1], static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const float*>(a.lse2), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.sq, a.sk, num_kb, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_fused_wgmma(const Args& a) {
  CUtensorMap maps[4];
  cudaError_t err = encode_head_rows_map(&maps[0], a.q, wg::kD, a.sq, a.bh, wg::kD, wg::kTile);
  if (err == cudaSuccess) {
    err = encode_head_rows_map(&maps[1], a.dout, wg::kD, a.sq, a.bh, wg::kD, wg::kTile);
  }
  if (err == cudaSuccess) {
    err = encode_head_rows_map(&maps[2], a.k, wg::kD, a.sk, a.bh, wg::kKdqCols, wg::kBlockRows,
                               CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err == cudaSuccess) {  // the groups' f32 dq buffers, box 32 columns x 64 rows
    const cuuint64_t dims[3] = {wg::kD, static_cast<cuuint64_t>(a.sq),
                                static_cast<cuuint64_t>(a.groups) * a.bh};
    const cuuint64_t strides[2] = {wg::kD * 4, static_cast<cuuint64_t>(a.sq) * wg::kD * 4};
    const cuuint32_t box[3] = {wg::kKdqCols, wg::kTile, 1};
    err = encode_tiled_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a.out0, dims, strides,
                           box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = flash_bwd_fused_wgmma_kernel<K>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::kSmemFusedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_kb = (a.sk + wg::kBlockRows - 1) / wg::kBlockRows;
  kernel<<<num_kb * a.bh, wg::kThreads, wg::kSmemFusedBytes, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<int*>(a.dq_lock),
      static_cast<bf16*>(a.out1), static_cast<bf16*>(a.out2), a.sq, a.sk, num_kb, a.causal,
      a.groups);
  return static_cast<int>(cudaGetLastError());
}

// kernel 2 (E = kDq) or 3 on the TF32 route: the resident operands' maps
// (Q, dO or K, V; box kBlockRows rows), then the streamed ones' (box kTile)
template <Entry E, int K>
int launch_tf32_entry(const Args& a) {
  const bool dq = E == Entry::kDq;
  const void* res[2] = {dq ? a.q : a.k, dq ? a.dout : a.v};
  const void* nat[2] = {dq ? a.k : a.q, dq ? a.v : a.dout};
  const int res_rows = dq ? a.sq : a.sk;
  const int nat_rows = dq ? a.sk : a.sq;
  CUtensorMap maps[4];
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    err = encode_f32_rows_map(&maps[i], res[i], tf::kD, res_rows, a.bh, tf::kBlockRows);
    if (err == cudaSuccess) {
      err = encode_f32_rows_map(&maps[2 + i], nat[i], tf::kD, nat_rows, a.bh, tf::kTile);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = [] {
    if constexpr (E == Entry::kDq) return flash_bwd_dq_tf32_kernel<K>;
    else return flash_bwd_dkv_tf32_kernel<K>;
  }();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tf::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (res_rows + tf::kBlockRows - 1) / tf::kBlockRows;
  if constexpr (E == Entry::kDq) {
    kernel<<<blocks * a.bh, tf::kThreads, tf::kSmemBytes, a.stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse2),
        static_cast<const float*>(a.delta), static_cast<float*>(a.out0), a.sq, a.sk, blocks,
        a.causal, a.sscale);
  } else {
    kernel<<<blocks * a.bh, tf::kThreads, tf::kSmemBytes, a.stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse2),
        static_cast<const float*>(a.delta), static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.sq, a.sk, blocks, a.causal, a.sscale);
  }
  return static_cast<int>(cudaGetLastError());
}

// kernel 2 (E = kDq) or 3 on the TF32 route at D = 32 kAtoms (ts): the
// resident operands' maps (Q, dO or K, V; box ts::kRows rows), then the
// streamed ones' (box ts::kTile rows)
template <Entry E, int kAtoms, int K>
int launch_stream_entry(const Args& a) {
  constexpr int kD = kAtoms * ts::kAtomCols;
  const bool dq = E == Entry::kDq;
  const void* res[2] = {dq ? a.q : a.k, dq ? a.dout : a.v};
  const void* nat[2] = {dq ? a.k : a.q, dq ? a.v : a.dout};
  const int res_rows = dq ? a.sq : a.sk;
  const int nat_rows = dq ? a.sk : a.sq;
  CUtensorMap maps[4];
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    err = encode_f32_rows_map(&maps[i], res[i], kD, res_rows, a.bh, ts::kRows);
    if (err == cudaSuccess) {
      err = encode_f32_rows_map(&maps[2 + i], nat[i], kD, nat_rows, a.bh, ts::kTile);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (res_rows + ts::kRows - 1) / ts::kRows;
  if constexpr (E == Entry::kDq) {
    auto kernel = flash_bwd_dq_stream_kernel<kAtoms, K>;
    constexpr int smem = ts::Layout<kAtoms, false>::kBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks * a.bh, ts::kThreads, smem, a.stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse2),
        static_cast<const float*>(a.delta), static_cast<float*>(a.out0), a.sq, a.sk, blocks,
        a.causal, a.sscale);
  } else {
    auto kernel = flash_bwd_dkv_stream_kernel<kAtoms, K>;
    constexpr int smem = ts::Layout<kAtoms, true>::kBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks * a.bh, ts::kThreads, smem, a.stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse2),
        static_cast<const float*>(a.delta), static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.sq, a.sk, blocks, a.causal, a.sscale);
  }
  return static_cast<int>(cudaGetLastError());
}

// the groups' f32 dq buffers of kernel 4, (groups, bh, sq, d) at a.out0, seen
// as (d, sq, groups * bh), box 32 columns x `rows` rows in the 128-byte
// swizzle: what its TMA reductions add into
inline cudaError_t encode_dq_groups_map(CUtensorMap* map, const Args& a, int d, int rows) {
  return encode_f32_rows_map(map, a.out0, d, a.sq, a.groups * a.bh, rows);
}

// kernel 4 on the TF32 route (f32 at D = tf::kD): kernel 3's maps, then the
// dq buffers' (box kTile rows)
template <int K>
int launch_fused_tf32(const Args& a) {
  CUtensorMap maps[5];
  cudaError_t err = cudaSuccess;
  const void* ops[4] = {a.k, a.v, a.q, a.dout};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = encode_f32_rows_map(&maps[i], ops[i], tf::kD, i < 2 ? a.sk : a.sq, a.bh,
                              i < 2 ? tf::kBlockRows : tf::kTile);
  }
  if (err == cudaSuccess) err = encode_dq_groups_map(&maps[4], a, tf::kD, tf::kTile);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = flash_bwd_fused_tf32_kernel<K>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tf::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_kb = (a.sk + tf::kBlockRows - 1) / tf::kBlockRows;
  kernel<<<num_kb * a.bh, tf::kThreads, tf::kSmemBytes, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<int*>(a.dq_lock),
      static_cast<float*>(a.out1), static_cast<float*>(a.out2), a.sq, a.sk, num_kb, a.causal,
      a.sscale, a.groups);
  return static_cast<int>(cudaGetLastError());
}

// kernel 2 or 3 on the TF32 route in contract K: the tf body at D = tf::kD,
// the ts body at D = 128 and 256; kernel 4 the tf body at D = tf::kD
template <Entry E, int K>
int launch_tf32_entry_d(const Args& a, int d) {
  if constexpr (E == Entry::kFused) {
    return d == tf::kD ? launch_fused_tf32<K>(a) : static_cast<int>(cudaErrorInvalidValue);
  } else {
    switch (d) {
      case tf::kD: return launch_tf32_entry<E, K>(a);
      case 128: return launch_stream_entry<E, 128 / ts::kAtomCols, K>(a);
      case 256: return launch_stream_entry<E, 256 / ts::kAtomCols, K>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

// Kernels 2 and 3 on the TF32 route: f32 at D = 64, 128 and 256, every
// contract; kernel 4 at D = 64 (it keeps mma.sync at 128 and 256)
template <Entry E>
int launch_tf32(const Args& a, int d, int dtype) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.contract) {
    case kNoMax: return launch_tf32_entry_d<E, kNoMax>(a, d);
    case kRunningMax: return launch_tf32_entry_d<E, kRunningMax>(a, d);
    case kUpcast: return launch_tf32_entry_d<E, kUpcast>(a, d);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kernel 2 (E = kDq) or 3 on the wgmma route at D = wd::kD: the resident
// operands' maps (Q, dO or K, V; box the block's rows), then the streamed
// ones' (box a stage's rows), each box 64 columns wide
template <Entry E, int K>
int launch_wide_entry(const Args& a) {
  const bool dq = E == Entry::kDq;
  const void* res[2] = {dq ? a.q : a.k, dq ? a.dout : a.v};
  const void* nat[2] = {dq ? a.k : a.q, dq ? a.v : a.dout};
  const int res_rows = dq ? a.sq : a.sk;
  const int nat_rows = dq ? a.sk : a.sq;
  const int res_box = dq ? wd::kDqRows : wd::kDkvKeys;
  const int nat_box = dq ? wd::kDqTile : wd::kDkvTile;
  CUtensorMap maps[4];
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    err = encode_head_rows_map(&maps[i], res[i], wd::kD, res_rows, a.bh, wd::kAtomCols, res_box);
    if (err == cudaSuccess) {
      err = encode_head_rows_map(&maps[2 + i], nat[i], wd::kD, nat_rows, a.bh, wd::kAtomCols,
                                 nat_box);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (res_rows + res_box - 1) / res_box;
  if constexpr (E == Entry::kDq) {
    auto kernel = flash_bwd_dq_wide_kernel<K>;
    constexpr int smem = wd::DqLayout::kBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks * a.bh, wd::kThreads, smem, a.stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse2),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0), a.sq, a.sk, blocks,
        a.causal);
  } else {
    auto kernel = flash_bwd_dkv_wide_kernel<K>;
    constexpr int smem = wd::DkvLayout::kBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks * a.bh, wd::kThreads, smem, a.stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse2),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0),
        static_cast<bf16*>(a.out1), a.sq, a.sk, blocks, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// kernel 4 on the wgmma route at D = wd::kD: kernel 3's maps, then the dq
// buffers' (box a q tile's rows)
template <int K>
int launch_fused_wide(const Args& a) {
  CUtensorMap maps[5];
  cudaError_t err = cudaSuccess;
  const void* ops[4] = {a.k, a.v, a.q, a.dout};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = encode_head_rows_map(&maps[i], ops[i], wd::kD, i < 2 ? a.sk : a.sq, a.bh,
                               wd::kAtomCols, i < 2 ? wd::kDkvKeys : wd::kDkvTile);
  }
  if (err == cudaSuccess) err = encode_dq_groups_map(&maps[4], a, wd::kD, wd::kDkvTile);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = flash_bwd_fused_wide_kernel<K>;
  constexpr int smem = wd::FusedLayout::kBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_kb = (a.sk + wd::kDkvKeys - 1) / wd::kDkvKeys;
  kernel<<<num_kb * a.bh, wd::kThreads, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(a.lse2),
      static_cast<const float*>(a.delta), static_cast<int*>(a.dq_lock),
      static_cast<bf16*>(a.out1), static_cast<bf16*>(a.out2), a.sq, a.sk, num_kb, a.causal,
      a.groups);
  return static_cast<int>(cudaGetLastError());
}

template <Entry E, int K>
int launch_wgmma_entry(const Args& a, int d) {
  if (d == wd::kD) {
    if constexpr (E == Entry::kFused) {
      return launch_fused_wide<K>(a);
    } else {
      return launch_wide_entry<E, K>(a);
    }
  }
  if constexpr (E == Entry::kDq) return launch_dq_wgmma<K>(a);
  else if constexpr (E == Entry::kDkv) return launch_dkv_wgmma<K>(a);
  else return launch_fused_wgmma<K>(a);
}

// Kernels 2, 3 and 4 on the wgmma route: bf16 at D = wg::kD and wd::kD, in
// the exp2 contracts
template <Entry E>
int launch_wgmma(const Args& a, int d, int dtype) {
  if (dtype != 1 || (d != wg::kD && d != wd::kD)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.contract) {
    case kNoMax: return launch_wgmma_entry<E, kNoMax>(a, d);
    case kRunningMax: return launch_wgmma_entry<E, kRunningMax>(a, d);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 at D = wg::kD and wd::kD in the exp2 contracts: kernels 2, 3 and 4
// run only their wgmma bodies there (launch_wgmma); f32, every contract:
// kernels 2 and 3 at D = 64, 128 and 256 and kernel 4 at D = 64 run only
// their TF32 bodies (launch_tf32). So kRouteMma is refused there, and those
// mma.sync instances are never built
template <Entry E, typename T, int D, int K>
constexpr bool kWgmmaOnly =
    (E != Entry::kRoles && sizeof(T) == 2 && (D == wg::kD || D == wd::kD) && K != kUpcast) ||
    ((E == Entry::kDq || E == Entry::kDkv) && sizeof(T) == 4 && D >= tf::kD) ||
    (E == Entry::kFused && sizeof(T) == 4 && D == tf::kD);

template <Entry E, typename T, int D, int K>
int launch_entry(const Args& a) {
  if constexpr (kWgmmaOnly<E, T, D, K>) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (E == Entry::kDq) {
    return launch_dq<T, D, K>(a);
  } else if constexpr (E == Entry::kRoles) {
    return launch_roles<T, D, K>(a);
  } else {
    return launch_dkv<T, D, E == Entry::kFused, K>(a);
  }
}

template <Entry E, typename T, int D>
int launch_contract(const Args& a) {
  switch (a.contract) {
    case kNoMax: return launch_entry<E, T, D, kNoMax>(a);
    case kRunningMax: return launch_entry<E, T, D, kRunningMax>(a);
    case kUpcast:  // f32 operands only
      if constexpr (sizeof(T) == 4) return launch_entry<E, T, D, kUpcast>(a);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <Entry E, typename T>
int launch_d(const Args& a, int d) {
  switch (d) {
    case 32: return launch_contract<E, T, 32>(a);
    case 64: return launch_contract<E, T, 64>(a);
    case 128: return launch_contract<E, T, 128>(a);
    case 256: return launch_contract<E, T, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <Entry E>
int launch(const Args& a, int d, int dtype, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.groups < 1 || (a.groups > 1 && a.route == kRouteMma)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.route == kRouteWgmma) {
    if constexpr (E != Entry::kRoles) return launch_wgmma<E>(a, d, dtype);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.route == kRouteTf32) {
    if constexpr (E != Entry::kRoles) return launch_tf32<E>(a, d, dtype);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.route != kRouteMma) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_d<E, float>(a, d);
  if (dtype == 1) return launch_d<E, __nv_bfloat16>(a, d);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (bh, sq, d) prescaled, k and v (bh, sk, d), dout (bh, sq, d) times ln2,
// all in one type (dtype 0 = f32, 1 = bf16); lse2 and delta (bh, sq) f32;
// dq (bh, sq, d) in the input type. All contiguous. contract is a Contract
// of flash_contract.cuh: under kUpcast (f32 only) q is unscaled, dout has no
// ln2, lse2 is the natural-log lse and sscale the softmax scale (sscale is
// not read otherwise). route is a Route (ops/flash_attention.py::
// attention_route): kRouteWgmma runs the wgmma bodies, which take bf16 at
// d = 64 and 256 in the two exp2 contracts, kRouteTf32 the TF32 wgmma
// bodies, which take f32 at d = 64 in every contract (and, in the dq and
// dkv entries, at d = 128 and 256), kRouteMma the mma.sync body, which
// takes every other type, width and
// contract; any other route, or a route on inputs it does not take,
// returns cudaErrorInvalidValue and launches nothing. Launches on `stream`
// of `device` and returns the first CUDA error of the tensor maps'
// encoding, the shared-memory attribute or the launch (0 on success).
extern "C" int gm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse2, const void* delta, void* dq, int bh, int sq,
                               int sk, int d, int dtype, int causal, int contract, float sscale,
                               int route, int device, void* stream) {
  const Args a{q,  k,  v,  dout,   lse2,     delta,  dq,    nullptr, nullptr, nullptr, 1,
               bh, sq, sk, causal, contract, sscale, route, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kDq>(a, d, dtype, device);
}

// The same inputs and route; dk and dv (bh, sk, d) in the input type.
extern "C" int gm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse2, const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int d, int dtype, int causal, int contract,
                                float sscale, int route, int device, void* stream) {
  const Args a{q,  k,  v,  dout,   lse2,     delta,  dk,    dv, nullptr, nullptr, 1,
               bh, sq, sk, causal, contract, sscale, route, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kDkv>(a, d, dtype, device);
}

// The same inputs and route; one launch adds dq into `dq_acc`, f32 (groups,
// bh, sq, d) and zeroed by the caller (key block kb into group kb % groups;
// the caller sums the groups), in the order kept by `dq_lock`, int32,
// zeroed by the caller, at least groups * bh * ceil(sq / Br) of them (Br =
// kBrBf16 or kBrF32 by input type on the mma.sync route, wg::kTile or
// wd::kDkvTile on the wgmma route, tf::kTile on the TF32 route), and writes
// dk and dv (bh, sk, d) in the input type. groups is 1 on the mma.sync
// route, at least 1 on the wgmma and TF32 routes; another value returns
// cudaErrorInvalidValue.
extern "C" int gm_flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse2, const void* delta, void* dq_acc,
                                  void* dq_lock, void* dk, void* dv, int bh, int sq, int sk, int d,
                                  int dtype, int causal, int contract, float sscale, int route,
                                  int groups, int device, void* stream) {
  const Args a{q,  k,  v,  dout,   lse2,     delta,  dq_acc, dk, dv, dq_lock, groups,
               bh, sq, sk, causal, contract, sscale, route,  static_cast<cudaStream_t>(stream)};
  return launch<Entry::kFused>(a, d, dtype, device);
}

// Test entry of the s, dp computation that kernels 2-4 share: q, k, v and
// dout (tiles, 16, d) in one type, lse2 and delta (tiles, 16) f32; writes
// out, f32 (2, 3, tiles, 16, 16): s, dp and ds of each tile's (query, key)
// pairs computed query-major (out[0]) and key-major (out[1]), with the p
// and ds of `contract` (sscale as in gm_flash_bwd_dq).
extern "C" int gm_flash_bwd_roles(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse2, const void* delta, void* out, int tiles,
                                  int d, int dtype, int contract, float sscale, int device,
                                  void* stream) {
  const Args a{q,     k,  v,  dout, lse2,     delta,  out,       nullptr, nullptr, nullptr, 1,
               tiles, 16, 16, 0,    contract, sscale, kRouteMma, static_cast<cudaStream_t>(stream)};
  return launch<Entry::kRoles>(a, d, dtype, device);
}
