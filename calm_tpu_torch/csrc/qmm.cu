// Dequantizing matvecs over layer-stacked fp8-e5m2 / fp16 / e4m3 weights
// and natural gf4 words, for decode and a verify's rows (B <= 64 activation
// rows; the fused epilogues B <= 16).
//
// Replaces six Pallas kernels of calm_tpu/ops/pallas_qmm.py:
//   - _layered_qmm_kernel (:92, via qmm_decode :219): y = x . W[layer]^T
//     -> calm_qmm_decode below;
//   - _layered_gf4_kernel (:100, via qmm_decode :219): the same product on
//     gf4 words, from 2 rows -> calm_qmm_decode with fmt 2 (one row keeps
//     calm_gf4_matvec in gf4.cu);
//   - _qx_offn_qkv_kernel (:942, via qx_offn_qkv :1198): one layer's
//     epilogue, wo + residual, ffn-norm, w1/w3 + act, w2 + residual, and
//     the next layer's attn-norm + q/k/v -> calm_qx_offn_qkv below, six
//     launches from this file with no torch op between them (eight on the
//     multi-row path, which stages a and h before their products);
//   - _gf4_offn_qkv_kernel (:737, via gf4_offn_qkv :927): the same
//     epilogue on gf4 weights, which the TPU reads in plane-permuted
//     layouts for Mosaic -> calm_qx_offn_qkv with fmt 2 on natural words;
//   - _gf4_ffn_kernel (:464, via gf4_ffn :571): the gf4 FFN alone, w2 .
//     (act(w1 . x) * (w3 . x)), which parallel-norm (Cohere) decode runs
//     on the attn-normed input -> calm_gf4_ffn below: the epilogue's dual
//     w1/w3 launch, then its w2 launch with no residual. The TPU kernel
//     reads plane-major w1/w3 and word-transposed w2 so that h needs no
//     lane shuffle; natural words need none here;
//   - _gf4_offn_kernel (:601, via gf4_offn :729): wo + residual, ffn-norm
//     and the FFN, returning ffn and r1 apart (the CALM_ROT=0 decode) ->
//     calm_gf4_offn below: the epilogue's first four launches with no
//     residual in the w2 launch (six on the multi-row path). The TPU kernel
//     runs on a plane-permuted residual stream, Mosaic's layout; the port
//     keeps natural order.
//   - at 2-16 rows, the MoE expert sweep of moe.cu: _moe_dense_kernel and
//     _moe_dense_gf4_kernel (:1248, :1256, via _qmm_moe_dense :1273), Y[a] =
//     x[min(a, Ax-1)] . W[layer, eidx[a]]^T -> calm_moe_mmv below (K10), and
//     the expert FFN, _gf4_moe_ffn_kernel (:1361, K11) on gf4 words and the
//     three _qmm_moe_dense calls with their activation (calm_tpu/model.py
//     :810-816) on fp16/fp8 -> calm_moe_ffn below. One row stays on
//     moe.cu's loops (see the MoE note below).
//
// K6 and K7 are bound like the epilogue: by their weight bytes (3 H D / 2,
// plus Q D / 2 for K7's wo), and they are made of its launches.
//
// What bounds it on an H100: the weight bytes. At B=1 a matvec does
// 2 flops per weight byte (fp8), below the ~20 flop/byte where the card's
// fp32 pipes (67 TFLOP/s against 3.35 TB/s) would limit, so the least
// time is the weight bytes over the HBM rate.
//
// Design: one warp per output row, eight warps per block. A lane step
// covers four weights, one 4-byte (fp8) or 8-byte (fp16) streaming load,
// and the matching float4 of x, so neighbouring lanes read neighbouring
// addresses of both: a warp's x read is one contiguous 512-byte span, the
// fewest L1 wavefronts per weight byte. Each lane keeps 32 bytes of each
// weight's loads in flight (64 for the w1/w3 pair): on an H100 that timed
// faster than 64 or 128 bytes, with fewer registers (PERF.md). e5m2
// decodes exactly to f16 by placing the byte in the high half of a 16-bit
// word (the reference's trick, pallas_qmm.py:12-13), two values per
// __byte_perm. The activation row (up to 14336 f32 = 57 KB for w2) stays
// in global memory, read through the read-only path, and is
// L1/L2-resident across the rows of a block. Accumulation is f32; a
// warp-shuffle tree closes each row.
// The attn- and ffn-norms run as a one-block-per-row launch that writes
// the normalised rows to scratch, so the w1/w3 and q/k/v matvecs share the
// plain inner loop instead of each block recomputing row statistics and
// normalising x per weight. This loop (qmv_kernel) serves one row (B = 1)
// of fp16 and fp8; gf4 takes the one-row gf4 path, 2-16 rows the
// multi-row path (both below).
//
// The one-row gf4 path (B = 1 on gf4 words; gf4_row_kernel): K8's, K7's
// and K6's products, the same launches and norm launches as above.
//   - What bounds it: the weight bytes, half a byte a weight. A gf4 word of
//     eight weights reads two float4 of x, so one row a warp reads 8 bytes
//     of x through L1 for each weight byte, and a decode of ~4.5
//     instructions a weight (shift, mask under 2^23's mantissa, subtract,
//     FMA) comes close to the card's issue rate at the byte bound.
//   - R rows a warp (a constant of the kernel: 4, and 2 for the dual
//     w1/w3 launch, whose rows carry two weights): each lane's two
//     float4 of x serve all of its R (x 2) words, x traffic 2x the weight
//     bytes. A lane keeps 16 words in flight over its rows (64 bytes).
//   - The decode, exact and ~3.5 instructions a weight: codes 0-4 are
//     masked where they lie (bits 8 + 3k) and ORed under an exponent that
//     puts the field's lowest bit at 1, one LOP3 a code (the exponents live
//     in registers), so the float is 2^p + code; one subtract of 2^p + 4
//     leaves code - 4 exactly. One shift of the word brings codes 5-7 to
//     bits 8, 11, 14, under the first three exponents. Neither x nor the
//     products are scaled, so nothing underflows that the plain decode
//     keeps. The scale byte is read as the high byte of an f16 and
//     multiplies the word's eight-product sum; its / -4 multiplies the
//     row's sum.
//   - The narrow launches (wo and w2: 4096 rows, a few µs of bytes) split
//     k into contiguous word ranges over ks warps of a block until about
//     two thousand warps fill the card; the partial sums meet in shared
//     memory in warp order (the result does not depend on the timing).
//   - On an H100 more words in flight (32, at more registers a thread),
//     8 rows a warp, loads that bypass L1 or fetch 256 bytes into L2, and
//     loading the next words while the present ones compute timed no faster
//     (PERF.md).
//
// The multi-row path (2 <= B <= 16 rows; mmv_kernel) replaces, for fp16
// and fp8, the same two TPU kernels, _layered_qmm_kernel (:92) and
// _qx_offn_qkv_kernel (:942), where the serving tick runs them at B slots,
// and for gf4 _gf4_offn_qkv_kernel (:737), _gf4_ffn_kernel (:464),
// _gf4_offn_kernel (:601) and _layered_gf4_kernel (:100) (see the gf4 note
// below).
// What bounds it: still the weight bytes (one read serves every row), but
// at B > 1 the loop above is held back by two costs that grow with B: B
// float4 loads of x per weight word (32 B of L1 reads per weight byte at
// B = 8), and f32 FMAs, 2 B operations per weight, which at 67 TFLOP/s
// reach the byte bound near B = 10. The design moves the products to the
// tensor cores and x out of the inner loop:
//   - mma.sync m16n8k16, f16 operands, f32 sums. A is 16 output rows x 16
//     k of weights, decoded in registers (e5m2 -> f16 exactly by byte
//     placement, fp16 as it is); B is 16 k x 8 rows of x (two n-tiles past
//     8 rows, zero columns past B).
//   - k is permuted within each 64-value chunk, alike in the weight
//     fragment and in x's staging (a dot product ignores k's order): lane
//     (g, t) holds k = 16 t + 4 s + j at step s, so its weights of a chunk
//     are 16 contiguous values of its row, one 16-byte streaming load
//     (two for fp16), a quad of lanes 64 contiguous values.
//   - x is staged once per launch, before the product (split_kernel, or
//     the norm launch that produces it): per (row, chunk) a power-of-two
//     scale 2^e >= max |x|, hi = f16(x 2^-e), lo = f16(x 2^-e - hi), in
//     the fragments' order, so a warp reads its x fragment of a step as
//     512 contiguous bytes (2 bytes of x per weight byte and 16-row tile).
//     Weights are exact in f16, hi + lo carries x to 2^-22 of its chunk's
//     scale, and the scale keeps hi from overflowing and lo, near the
//     chunk's max, out of the subnormals: two products per weight into one
//     f32 accumulator per chunk, then times 2^e into the running sum.
//   - k is split across the warps of a block (qmv_plan in
//     ops/hopper_qmm.py picks 16 or 32 rows a warp and the split from the
//     launch's rows and n), so the narrow launches (wo, w2: 4096 rows)
//     still keep thousands of warps' loads in flight; the partial C
//     fragments meet in shared memory, then the epilogue as above. A lane
//     keeps two chunks' weight loads in flight where they fit in 128
//     bytes, else one; on an H100 that timed faster than one chunk or 256
//     bytes, and loading x's fragments with the weights (more registers)
//     slower (PERF.md).
//
// gf4 on the multi-row path (K8 calm_qx_offn_qkv with fmt 2, K6
// calm_gf4_ffn, K7 calm_gf4_offn and K3 calm_qmm_decode with fmt 2, at
// 2 <= B <= 16):
//   - What bounds it: still the weight bytes, now 0.5 a weight, so a
//     launch's loads take half of fp8's time for the same rows, and the
//     product's fixed costs (x's fragments, the decode, the two mma a step)
//     weigh twice as much per byte.
//   - The decode is exact in f16: a value is (code - 4) e5m2(scale) / -4;
//     (code - 4) in [-4, 3] has at most 2 significant bits and the scale 3,
//     so their product fits f16's 11; f16 has e5m2's exponent range (the
//     largest value, 57344, is below 65504, the smallest, 2^-18 from a
//     subnormal scale byte, a multiple of f16's subnormal step 2^-24), and
//     every intermediate step below is exact too. The scale folds into A:
//     one product's k spans four lanes, four different words.
//   - gf4_frag turns half a word into the two f16x2 operands of a step:
//     two shifts and a byte permute put a pair of codes at bit 0 of each
//     half and the next pair at bit 6, under the mantissa of 1024 (one
//     LOP3 a pair); a subtract and a multiply by the scale (/ -4 and /
//     -256, made once a word) finish each pair: about 20 instructions for 8
//     weights, each weight decoded once a launch for both x parts and every
//     n-tile.
//   - A lane's 16 values of a row and chunk are two words, one 8-byte load
//     (the chunk permutation and x's staging are fp8's); it keeps 4 chunks
//     in flight (32 or 64 bytes), which timed faster than 1 or 2 and no
//     slower than 8. A cp.async ring of whole 128-byte rows in shared
//     memory and L2 prefetch hints timed no better than loads into
//     registers; 16-byte loads over a permutation of 128 values, which
//     would need a staging order of their own, are weighed in PERF.md.
//   - The weight and x pointers step along k, so a load's address is a
//     register plus a constant: computing each chunk's 64-bit addresses
//     would take a third of the loop's instructions (fp16/fp8 share the
//     loop).
//   - Rows of n % 16 == 8 (an odd word count, K6 at model widths such as
//     1032, K3 at n = 1032 or 8) take the ODD instantiation: word loads, the
//     second zero past the row, one m-tile a warp.
//   - K3's lm-head (up to 256000 rows of Aya 23 8B's tied vocabulary) takes
//     qmv_plan's 32 rows a warp, and its thousands of row groups leave k
//     whole; the output's row stride is d.
//
// The MoE sweep on the multi-row path (K10 calm_moe_mmv, the expert FFN
// calm_moe_ffn, 2 <= B <= 16):
//   - What bounds it: the live experts' weight bytes, each read once for
//     all B rows. Mixtral 8x7B's serving tick (8 rows, top-2 of 8 experts)
//     fills up to 8 slots (~7.2 for routing uniform over experts): one
//     layer's FFN is then up to 8 x 3 x 58.7 M weights,
//     470 MB a product in fp8 (0.140 ms at 3.35 TB/s). moe.cu's f32 loop
//     reads B float4 of x per weight word from L1 and does 2 B FMAs a
//     weight, as the loop above did before this path (~10% of its bound at
//     B = 8 on K9).
//   - mmv_kernel's MOE instantiations add a slot axis, blockIdx.y: a block
//     reads its slot's expert id on the device (eidx[a], clamped to [0, E))
//     and offsets its weight, staged-x and output pointers; a dead slot (a
//     >= cnt) writes zeros and reads no weight, as moe.cu's contract. No id
//     passes through the host, so the step stays capturable.
//   - x is staged once a launch by split_kernel: one staging that every
//     slot shares for w1/w3 (Ax = 1), one a slot for w2 (Ax = A: h of
//     slot a staged by a third grid axis of split_kernel).
//   - The FFN is two products, as ffn_staged's: the dual w1/w3 launch
//     writes h = act(x w1^T) (x w3^T) (A, B, H), h is staged slot by slot,
//     the w2 launch writes z (A, B, D). fp16/fp8 ran three K10 launches and
//     PyTorch's activation; gf4 (K11) ran moe.cu's two f32 launches.
//   - qmv_plan tiles a launch over slots x row groups: with 8 slots the
//     wide launches need no k split, the narrow w2 (4096 rows a slot) keeps
//     one.
//   - The MOE flag is a template argument, so the instantiations that the
//     dense paths launch are compiled as before.
//
// fp8e4 (FMT 3: e4m3 codes and a power-of-two scale per tensor, per
// (layer, expert) in MoE stacks), K2 calm_qmm_decode and the MoE sweep's
// calm_moe_mmv / calm_moe_ffn (moe.cu's loop at one row). The reference
// has no Pallas kernel for it: calm_tpu/ops/qmm.py:179-205 runs it through
// XLA, the scale on the output. A decode matvec that widened the plane to
// bf16 first would move 5 bytes a weight where one suffices, so the e4m3
// body sits in the same loops as e5m2, at the same bytes:
//   - The decode is exact: Hopper's cvt.rn.f16x2.e4m3x2 turns a pair of
//     bytes into f16x2 in one instruction (f16 holds every finite e4m3
//     value), as e5m2's byte placement takes one byte_perm a pair. A bit
//     placement (e5m2's, then the sign kept and the seven other bits moved
//     down one: f16 of e4m3(b) / 256, one shift and one LOP3 more a pair)
//     timed 17% slower than e5m2 on the expert FFN at 3 live slots of 8
//     (B = 8, PERF.md), where the conversion timed even. chip_smoke.py holds
//     the kernels on planes of all 254 finite bytes.
//   - The scale stays on the device: a kernel reads it at the pointer the
//     wrapper gives (the layer's entry), plus the slot's expert id where it
//     reads that id, and multiplies each product's sum before the
//     activation (SiLU and GELU are not linear) and before any residual. A
//     dead slot reads neither. The captured step replays it as it is.
//   - Only the launches that the paths make are built: FMT 3 at ACT 0 in
//     qmv_kernel and the dense mmv_kernel (per-op decode: JAX's fused
//     epilogue takes fp8/fp16 only, calm_tpu/model.py:1231), and the MOE
//     dual and w2 instantiations.
//
// The wide path (17 <= B <= 64 rows; wide_kernel): K2 calm_qmm_decode
// (fp16, e5m2, e4m3, gf4: K3), and the MoE sweep's K10 calm_moe_mmv and
// expert FFN calm_moe_ffn (K11 on gf4 words), where JAX runs these products
// in XLA (calm_tpu/ops/qmm.py:189-205, bf16 operands and f32 sums; the MoE
// per-token vmap, calm_tpu/model.py:829-857): a speculative verify's 8 x 5
// rows, a tick of 17-64 slots.
//   - What bounds it: still the weight bytes, read once for every row; at
//     64 rows a weight byte (fp8) carries 128 operations, under the card's
//     ~295 for f16 tensor cores. The first design (mmw_kernel, mma.sync, a
//     warp's own x fragments from L2) reached 24-65% of bound: each warp
//     re-read x, B / 16 bytes of x per weight byte, and waited on it.
//   - A block (two consumer warpgroups and a producer warp) owns T output
//     rows, 64 a warpgroup (the dual w1/w3 launch: 64 rows, warpgroup 0 of
//     w1, 1 of w3), and a k part. The producer keeps TMA loads of 128-value
//     stages in a ring of shared memory (a full and an empty barrier a
//     stage): each warpgroup's 64 rows of weights in their natural bytes
//     (e5m2/e4m3 and fp16 in the 128-byte swizzle, gf4 64 bytes a row), and
//     x's two 64-value boxes, staged once a launch and loaded once a stage
//     for the whole block. Rows of x past B arrive as zeros (TMA's bounds),
//     up to the compiled width N (32, 40, 64).
//   - The consumers decode their rows exactly to f16 A fragments in
//     registers (e5m2 by byte placement, e4m3 by cvt.rn.f16x2.e4m3x2, gf4
//     by gf4_frag, fp16 as it is) and issue eight wgmma m64nNk16 a stage
//     against x in shared memory, f32 sums. A lane reads k = 32 t .. 32 t +
//     31 of its row, 16-byte loads over the swizzle (every bank once a
//     quarter-warp; fp16 twice); stage_wide_kernel writes x in the order
//     this gives wgmma's k slots (hopper_qmm.wide_perm), so no lane shuffles.
//   - x: one power-of-two scale a row, one f16 term (x to 2^-11 of each
//     value down to 2^-14 of the row's max, finer than JAX's bf16 operand),
//     (B, n rounded up to 128) f16 a TMA box reads; the row's scale
//     multiplies the sums once they are whole.
//   - k split: a tile's k parts are the blocks of one cluster (hopper_qmm.
//     wide_plan: split while the launch has fewer than a block an SM, to 8
//     parts of 4 stages or more: Mistral-7B's k/v planes have 8 tiles of 128
//     rows). Each block's sums go through shared memory; each then adds
//     every part's sums for its share of x's rows, in rank order, through
//     distributed shared memory: no atomics, two identical calls give the
//     same bits (chip_smoke.py holds them so).
//   - The epilogue stores four rows a thread (float4), row-fastest; the
//     rows' scales, the e4m3 scales and the dual launch's activation apply
//     there. MoE: blockIdx.y is the slot, its expert the 3-D maps' third
//     coordinate, read on the device; a dead slot writes zeros and reads no
//     weight; no id reaches the host, so the verify's capture holds.
//   - On an H100 two blocks an SM (a ring of ~104 KB) timed faster than one
//     with twice the ring, and a block an SM faster as the split's target
//     than two; what is left of a small launch is its fixed cost (the first
//     stage's latency, the epilogue's stores: ~7 us of k/v's 7.3). A
//     programmatic dependent launch after the staging gained 1-2 us on some
//     launches and lost 3-13 on others (its early blocks pack two an SM).
//     PERF.md has the timings.
//   - mmw_kernel (below) keeps --precise, a route of the mode (hi + lo,
//     each 64-value chunk summed apart: a run of 64 mma.sync sums read
//     ~1.4e-6 of a row's max from the float64 product on an H100, past the
//     mode's 5e-7; wgmma's long sums, not measured so, are not taken for
//     it), and gf4 rows of n % 32 != 0 (TMA reads rows of 16-byte
//     multiples): a warp's weights through a cp.async ring, x's fragments
//     two steps ahead, mma.sync m16n8k16; 32 rows of x a launch under
//     --precise.
//
// The quality mode (--precise, calm_tpu/ops/qmm.py:190-197: JAX's f32
// product at Precision.HIGHEST) takes the same multi-row path at 2-16 rows,
// x in hi + lo as above: each weight read once for every row, where the
// one-row loops on a grid axis over rows read the plane once a row. Against
// the float64 product (each row to its max |y|) it reads ~2.2-3.4e-7 on
// the lm-head, about half an f32 matmul's distance (chip_smoke.py holds it
// below 5e-7); the f32 loops' rows axis read ~1.3-1.9e-7. A third f16
// term of x gained little on the card: mma's f32 sums, not x's 22 bits,
// set that distance. qmv_kernel and gf4_mv_kernel (gf4.cu) take one row;
// calm_qmm_decode without a plan, and calm_gf4_matvec, refuse B >= 2.

#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#define WARPS 8

namespace {

struct Seg {
  const uint8_t* w;    // (rows, n / PER) words of this segment's weight
  const uint8_t* w3;   // dual mode: the w3 weight (same shape), else null
  float* out;          // out[b * ld + r]
  const float* resid;  // optional: out = resid + y, resid[b * ld + r]
  const float* s;      // e4m3 (FMT 3): w's scale on the device (MOE: + expert id)
  const float* s3;     // e4m3 dual mode: w3's scale
  int rows;
  int ld;
};

struct Args {
  const float* x;  // (B, n) f32, row-major
  Seg seg[3];
  int nseg;
  int B;
  int n;
};

__device__ __forceinline__ float2 h2f2(uint32_t bits) {
  __half2 h;
  *reinterpret_cast<uint32_t*>(&h) = bits;
  return __half22float2(h);
}

__device__ __forceinline__ float dot4(float4 w, float4 x) {
  return w.x * x.x + w.y * x.y + w.z * x.z + w.w * x.w;
}

// FMT 0: fp16, 1: fp8 e5m2, 3: fp8 e4m3 (gf4 at one row: gf4_row_kernel). Word: the
// load that holds PER weights; dec() turns it into Dec, dot() multiplies Dec
// by the PER values of x held in PER / 4 float4 registers.
template <int FMT>
struct Fmt;
template <>
struct Fmt<0> {
  using Word = uint2;
  using Dec = float4;
  static constexpr int PER = 4;
  static __device__ __forceinline__ Dec dec(uint2 q) {
    const float2 lo = h2f2(q.x), hi = h2f2(q.y);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ float dot(const Dec& w, const float4* x) {
    return dot4(w, x[0]);
  }
};
template <>
struct Fmt<1> {
  using Word = uint32_t;
  using Dec = float4;
  static constexpr int PER = 4;
  static __device__ __forceinline__ Dec dec(uint32_t q) {
    // bytes [0, b0, 0, b1] and [0, b2, 0, b3]: e5m2 in the high byte
    const float2 lo = h2f2(__byte_perm(q, 0u, 0x1404));
    const float2 hi = h2f2(__byte_perm(q, 0u, 0x3424));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ float dot(const Dec& w, const float4* x) {
    return dot4(w, x[0]);
  }
};
template <>
struct Fmt<3> {
  using Word = uint32_t;
  using Dec = float4;
  static constexpr int PER = 4;
  static __device__ __forceinline__ Dec dec(uint32_t q) {
    const float2 lo = h2f2(e4m3x2_f16x2((unsigned short)(q & 0xffffu)));
    const float2 hi = h2f2(e4m3x2_f16x2((unsigned short)(q >> 16)));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ float dot(const Dec& w, const float4* x) {
    return dot4(w, x[0]);
  }
};
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

#define NORM_THREADS 1024
#define NORM_VEC 4  // float4s per thread: rows of up to 16384 values
#define CH 64       // multi-row path: k values a chunk, one x scale per (row, chunk)
#define SPLIT_THREADS 256

__device__ float norm_block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_THREADS / 32; i++) s += red[i];
  return s;
}

__device__ __forceinline__ uint32_t h2bits(__half a, __half b) {
  __half2 h = __halves2half2(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The multi-row path's staging of x. Thread c holds x[b, 4c .. 4c + 3]
// (zeros past n4 float4s); the 16 threads of a chunk, an aligned half-warp
// whose warp is whole, share its max |x|, m < 2^e. Writes hi = f16(x 2^-e) and
// lo = f16(x 2^-e - hi) of the four values as one 16-byte fragment
// {hi01, hi23, lo01, lo23} at xs[((chunk * 4 + s) * ns + b) * 4 + t], with
// chunk = c / 16, t = c % 16 / 4, s = c % 4 (k = 16 t + 4 s + j within the
// chunk: the order mmv_kernel's lanes read), and by the chunk's first
// thread sc[chunk * ns + b] = 2^e; a chunk that n cuts is written whole,
// zeros past n, since every lane of mmv_kernel reads all of its x
// fragments. ns: row slots a (chunk, step), 8 NT.
__device__ __forceinline__ void stage4(float4 v, int n4, int b, int c, int ns,
                                       uint4* xs, float* sc) {
  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  // e with m = f 2^e, f in [0.5, 1), as frexpf (e = 0 for m = 0): |x 2^-e| < 1;
  // from the exponent field for normal m below 2^126, else by frexpf
  const int E = (__float_as_uint(m) >> 23) & 0xff;
  int e;
  float inv;  // 2^-e
  if (E >= 1 && E <= 252) {
    e = E - 126;
    inv = __uint_as_float((uint32_t)(253 - E) << 23);
  } else {
    frexpf(m, &e);
    inv = ldexpf(1.0f, -e);
  }
  const float f[4] = {v.x * inv, v.y * inv, v.z * inv, v.w * inv};
  __half hi[4], lo[4];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    hi[j] = __float2half_rn(f[j]);
    lo[j] = __float2half_rn(f[j] - __half2float(hi[j]));  // the difference is exact
  }
  if ((c & ~15) < n4) {
    const int chunk = c >> 4, t = (c >> 2) & 3, s = c & 3;
    xs[((size_t)(chunk * 4 + s) * ns + b) * 4 + t] =
        make_uint4(h2bits(hi[0], hi[1]), h2bits(hi[2], hi[3]), h2bits(lo[0], lo[1]),
                   h2bits(lo[2], lo[3]));
    if ((c & 15) == 0) sc[(size_t)chunk * ns + b] = ldexpf(1.0f, e);
  }
}

// out[b] = (x[b] - mu) * rsqrt(mean((x[b] - mu)^2) + eps) * g, with mu the
// row mean when sub_mean and 0 otherwise; one block per row, the row held
// in registers between the two reductions. n % 4 == 0, n <= 16384. Writes
// out (f32) when given, and the multi-row path's staging (xs, sc; see
// stage4) when given.
__global__ void __launch_bounds__(NORM_THREADS)
    norm_kernel(const float* x, const float* g, float* out, uint4* xs, float* sc,
                int ns, int n, float eps, int sub_mean) {
  __shared__ float red[NORM_THREADS / 32];
  const int n4 = n >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)blockIdx.x * n);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* o4 = out ? reinterpret_cast<float4*>(out + (size_t)blockIdx.x * n) : nullptr;
  float4 v[NORM_VEC];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NORM_VEC; k++) {
    const int c = threadIdx.x + k * NORM_THREADS;
    v[k] = c < n4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  }
  const float mu = sub_mean ? norm_block_sum(s, red) / n : 0.f;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NORM_VEC; k++) {
    if (threadIdx.x + k * NORM_THREADS < n4) {
      const float a = v[k].x - mu, b = v[k].y - mu, c = v[k].z - mu, d = v[k].w - mu;
      ss += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rs = rsqrtf(norm_block_sum(ss, red) / n + eps);
#pragma unroll
  for (int k = 0; k < NORM_VEC; k++) {
    const int c = threadIdx.x + k * NORM_THREADS;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < n4) {
      const float4 gv = g4[c];
      o = make_float4((v[k].x - mu) * rs * gv.x, (v[k].y - mu) * rs * gv.y,
                      (v[k].z - mu) * rs * gv.z, (v[k].w - mu) * rs * gv.w);
      if (o4) o4[c] = o;
    }
    // warp-uniform: a warp stages while any of its lanes holds a value
    if (xs && (threadIdx.x & ~31) + k * NORM_THREADS < n4)
      stage4(o, n4, blockIdx.x, c, ns, xs, sc);
  }
}

// The staging of x (B, n) f32 alone (see stage4): grid (n / 4 / 256 up,
// B, slots), one float4 a thread; slot z stages rows z B .. z B + B - 1 of
// x into xs + z xslot and sc + z scslot (the MoE sweep's h, one staging a
// slot).
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_kernel(const float* x, uint4* xs, float* sc, int ns, int n, size_t xslot,
                 size_t scslot) {
  const int n4 = n >> 2, c = blockIdx.x * SPLIT_THREADS + threadIdx.x;
  const size_t row = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const float4 v = c < n4 ? reinterpret_cast<const float4*>(x + row * n)[c]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  stage4(v, n4, blockIdx.y, c, ns, xs + blockIdx.z * xslot, sc + blockIdx.z * scslot);
}

__device__ __forceinline__ float act_fn(int act, float y) {
  if (act == 1) return y * (1.0f / (1.0f + expf(-y)));
  const float ga = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * y * (1.0f + tanhf(ga * (y + 0.044715f * y * y * y)));
}

// ACT: 0 plain matvec, 1 dual SiLU (h = silu(x.w1) * x.w3), 2 dual tanh-GELU.
// One row of x (B = 1; 2-16 rows take mmv_kernel, in the quality mode
// too). FMT 3 (e4m3, ACT 0): the sum times s, read on the device, before
// any residual.
template <int FMT, int ACT>
__global__ void __launch_bounds__(WARPS * 32, 4) qmv_kernel(Args a) {
  using F = Fmt<FMT>;
  using Word = typename F::Word;
  constexpr int XV = F::PER / 4;              // float4s of x per word
  constexpr int U = 32 / (int)sizeof(Word);   // loads in flight per lane and weight: 32 bytes

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int row = blockIdx.x * WARPS + warp;
  Seg sg;
  if (row < a.seg[0].rows) {
    sg = a.seg[0];
  } else if (a.nseg > 1 && row - a.seg[0].rows < a.seg[1].rows) {
    sg = a.seg[1];
    row -= a.seg[0].rows;
  } else if (a.nseg > 2 &&
             row - a.seg[0].rows - a.seg[1].rows < a.seg[2].rows) {
    sg = a.seg[2];
    row -= a.seg[0].rows + a.seg[1].rows;
  } else {
    return;
  }

  const int nw = a.n / F::PER;  // lane steps (words) per row
  const Word* wr = reinterpret_cast<const Word*>(sg.w) + (size_t)row * nw;
  const Word* wr3 = ACT ? reinterpret_cast<const Word*>(sg.w3) + (size_t)row * nw : nullptr;
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  float acc = 0.f, acc3 = 0.f;

  for (int c0 = lane; c0 < nw; c0 += 32 * U) {
    Word q[U], q3[U];
#pragma unroll
    for (int u = 0; u < U; u++) {
      const int c = c0 + u * 32;
      if (c < nw) {
        q[u] = __ldcs(wr + c);
        if (ACT) q3[u] = __ldcs(wr3 + c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; u++) {
      const int c = c0 + u * 32;
      if (c < nw) {
        const typename F::Dec w = F::dec(q[u]);
        float4 xv[XV];
#pragma unroll
        for (int i = 0; i < XV; i++) xv[i] = __ldg(x4 + (size_t)c * XV + i);
        acc += F::dot(w, xv);
        if (ACT) acc3 += F::dot(F::dec(q3[u]), xv);
      }
    }
  }

  float y = warp_sum(acc);
  if constexpr (FMT == 3) y *= __ldg(sg.s);
  if (ACT) {
    float y3 = warp_sum(acc3);
    if constexpr (FMT == 3) y3 *= __ldg(sg.s3);
    y = act_fn(ACT, y) * y3;
  }
  if (lane == 0) sg.out[row] = sg.resid ? sg.resid[row] + y : y;
}

// ---------------------------------------------------------------------------
// The one-row gf4 path: B = 1 on gf4 words (K8, K7 and K6's launches), see
// the note at the top.
// ---------------------------------------------------------------------------

#define G1_WORDS 16  // gf4 words a lane keeps in flight over its rows and weights
#define G1_ROWS 4       // output rows a warp: one load of x serves them
#define G1_ROWS_DUAL 2  // the same for the dual w1/w3 launch (two weights a row)
#define G1_PLAN 2    // ints of one launch's plan: {ks, grid}

// (w & MASK) | e as a float: MASK selects one 3-bit field of a gf4 word and
// e is the exponent that puts the field's lowest bit at 1, so the float is
// 2^p + code for the power 2^p just above the field.
template <uint32_t MASK>
__device__ __forceinline__ float gf4_field(uint32_t w, uint32_t e) {
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(v) : "r"(w), "n"(MASK), "r"(e));
  return __uint_as_float(v);
}

// sum_k (code_k - 4) x_k of one gf4 word, exactly as the plain decode's
// values times x: codes 0-4 decode where they lie (bits 8 + 3k) under the
// exponents e[k] (2^(15 - 3k) + code_k), codes 5-7 after one shift of the
// word to bits 8, 11, 14 under e[0..2]; one subtract of 2^p + 4 each.
__device__ __forceinline__ float gf4_dot8(uint32_t w, float4 xa, float4 xb,
                                          const uint32_t (&e)[5]) {
  const uint32_t h = w >> 15;
  float s = (gf4_field<0x700u>(w, e[0]) - 32772.0f) * xa.x;
  s = fmaf(gf4_field<0x3800u>(w, e[1]) - 4100.0f, xa.y, s);
  s = fmaf(gf4_field<0x1C000u>(w, e[2]) - 516.0f, xa.z, s);
  s = fmaf(gf4_field<0xE0000u>(w, e[3]) - 68.0f, xa.w, s);
  s = fmaf(gf4_field<0x700000u>(w, e[4]) - 12.0f, xb.x, s);
  s = fmaf(gf4_field<0x700u>(h, e[0]) - 32772.0f, xb.y, s);
  s = fmaf(gf4_field<0x3800u>(h, e[1]) - 4100.0f, xb.z, s);
  return fmaf(gf4_field<0x1C000u>(h, e[2]) - 516.0f, xb.w, s);
}

// One row of x against R rows a warp of gf4 words (4; both w1 and w3 for
// ACT 1, 2 rows), k split into ks contiguous word ranges over ks warps of a block
// (gf4_row_plan; WARPS / ks row groups a block, the groups of segment 0,
// then 1, then 2).
// Lane l reads words l, l + 32, ... of its range in each row, and the two
// float4 of x beside each word once for all R (x DUAL) rows. Rows past a
// segment's end re-read its last row and are not written. Sums: f32, a
// word's eight products by FMA, times its scale into the lane's sum, a
// warp-shuffle tree, then the ks partials in warp order through shared
// memory; the scale's / -4 is applied to the row's sum.
template <int ACT>
__global__ void __launch_bounds__(WARPS * 32) gf4_row_kernel(Args a, int ks) {
  constexpr int DUAL = ACT ? 2 : 1;
  constexpr int R = ACT ? G1_ROWS_DUAL : G1_ROWS;
  constexpr int U = G1_WORDS / (R * DUAL);  // word steps in flight
  __shared__ float red[WARPS][DUAL * R];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = a.n >> 3;  // words a row
  const int grp = blockIdx.x * (WARPS / ks) + warp / ks, kw = warp % ks;
  const int g0 = (a.seg[0].rows + R - 1) / R;
  const int g1 = a.nseg > 1 ? (a.seg[1].rows + R - 1) / R : 0;
  const int g2 = a.nseg > 2 ? (a.seg[2].rows + R - 1) / R : 0;
  const bool live = grp < g0 + g1 + g2;
  Seg sg = a.seg[0];
  int r0 = grp * R;
  if (live && grp >= g0) {
    const bool one = grp < g0 + g1;
    sg = one ? a.seg[1] : a.seg[2];
    r0 = (one ? grp - g0 : grp - g0 - g1) * R;
  }
  const int c0 = live ? kw * nw / ks : 0;
  const int len = live ? (kw + 1) * nw / ks - c0 : 0;  // words of the warp's range

  const uint32_t* wp[DUAL][R];
#pragma unroll
  for (int r = 0; r < R; r++) {
    const size_t off = (size_t)min(r0 + r, sg.rows - 1) * nw + c0 + lane;
    wp[0][r] = reinterpret_cast<const uint32_t*>(sg.w) + off;
    if (ACT) wp[DUAL - 1][r] = reinterpret_cast<const uint32_t*>(sg.w3) + off;
  }
  const float4* xp = reinterpret_cast<const float4*>(a.x) + 2 * (c0 + lane);
  uint32_t e[5];  // in registers: one LOP3 a field
  asm("mov.b32 %0, 0x47000000;" : "=r"(e[0]));
  asm("mov.b32 %0, 0x45800000;" : "=r"(e[1]));
  asm("mov.b32 %0, 0x44000000;" : "=r"(e[2]));
  asm("mov.b32 %0, 0x42800000;" : "=r"(e[3]));
  asm("mov.b32 %0, 0x41000000;" : "=r"(e[4]));

  float acc[DUAL][R];
#pragma unroll
  for (int d = 0; d < DUAL; d++)
#pragma unroll
    for (int r = 0; r < R; r++) acc[d][r] = 0.f;

  for (int c = lane; c < len; c += 32 * U) {
    uint32_t q[U][DUAL][R];
#pragma unroll
    for (int u = 0; u < U; u++)
#pragma unroll
      for (int d = 0; d < DUAL; d++)
#pragma unroll
        for (int r = 0; r < R; r++) q[u][d][r] = c + 32 * u < len ? __ldcs(wp[d][r] + 32 * u) : 0u;
#pragma unroll
    for (int u = 0; u < U; u++) {
      if (c + 32 * u >= len) break;
      const float4 xa = __ldg(xp + 64 * u), xb = __ldg(xp + 64 * u + 1);
#pragma unroll
      for (int d = 0; d < DUAL; d++)
#pragma unroll
        for (int r = 0; r < R; r++) {
          const uint32_t w = q[u][d][r];
          // the e5m2 byte in the high half of an f16 is the same value, exactly
          const float sc = __half2float(__ushort_as_half((unsigned short)(w << 8)));
          acc[d][r] = fmaf(gf4_dot8(w, xa, xb, e), sc, acc[d][r]);
        }
    }
#pragma unroll
    for (int d = 0; d < DUAL; d++)
#pragma unroll
      for (int r = 0; r < R; r++) wp[d][r] += 32 * U;
    xp += 64 * U;
  }

#pragma unroll
  for (int d = 0; d < DUAL; d++)
#pragma unroll
    for (int r = 0; r < R; r++) acc[d][r] = warp_sum(acc[d][r]);
  if (ks > 1) {  // the k split's partial sums meet in shared memory
    if (lane == 0)
#pragma unroll
      for (int d = 0; d < DUAL; d++)
#pragma unroll
        for (int r = 0; r < R; r++) red[warp][d * R + r] = acc[d][r];
    __syncthreads();
    if (kw == 0)
      for (int j = 1; j < ks; j++)
#pragma unroll
        for (int d = 0; d < DUAL; d++)
#pragma unroll
          for (int r = 0; r < R; r++) acc[d][r] += red[warp + j][d * R + r];
  }
  if (kw != 0 || !live) return;
#pragma unroll
  for (int r = 0; r < R; r++) {
    const int row = r0 + r;
    if (lane == r && row < sg.rows) {
      float y = acc[0][r] * -0.25f;
      if (ACT) y = act_fn(ACT, y) * (acc[DUAL - 1][r] * -0.25f);
      sg.out[row] = sg.resid ? sg.resid[row] + y : y;
    }
  }
}

// plan (from gf4_row_plan): {ks, grid}
template <int ACT>
cudaError_t launch_g1(const Args& a, const int* plan, cudaStream_t st) {
  if (!plan) return cudaErrorInvalidValue;
  constexpr int R = ACT ? G1_ROWS_DUAL : G1_ROWS;
  const int ks = plan[0], grid = plan[1];
  if (a.B != 1 || a.n < 8 || a.n % 8 != 0 || ks < 1 || ks > WARPS || WARPS % ks != 0 ||
      grid < 1)
    return cudaErrorInvalidValue;
  long long groups = 0;  // every row group needs a warp group of the grid
  for (int s = 0; s < a.nseg; s++) groups += (a.seg[s].rows + R - 1) / R;
  if ((long long)grid * (WARPS / ks) < groups) return cudaErrorInvalidValue;
  gf4_row_kernel<ACT><<<grid, WARPS * 32, 0, st>>>(a, ks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The multi-row path: 2 <= B <= 16 rows of x, fp16 (FMT 0) and e5m2 (1)
// weights, on the tensor cores (see the note at the top).
// ---------------------------------------------------------------------------

#define MV_INFLIGHT 128  // fp16/fp8: weight bytes a lane keeps in flight, at most
#define MV_U_GF4 4        // gf4: chunks a lane keeps in flight (32-64 bytes)

struct MArgs {
  const uint4* xs;  // x staged by stage4: [chunk][step][slot < ns][t] fragments
  const float* sc;  // [chunk][slot < ns] 2^e
  Seg seg[3];
  int nseg;
  int B;
  int n;
  int ks;  // warps that split k for one row group (qmv_plan)
  // the expert-slot axis of the MOE instantiations (slot a = blockIdx.y;
  // one segment)
  const int* eidx;  // (A,) expert ids, clamped to [0, E)
  const int* cnt;   // live slots: a >= cnt writes zeros and reads no weight
  int E;
  size_t wslot;   // bytes from one expert's plane to the next
  size_t xslot;   // uint4 fragments from one slot's staged x to the next (0: shared)
  size_t scslot;  // floats from one slot's scales to the next (0: shared)
  size_t oslot;   // floats from one slot's output to the next
  // the wide path (mmw_kernel): x's terms (1, or 2 under --precise), the
  // uint2 fragments from a staging's hi to its lo, and the launch's first
  // row of x (under --precise a launch takes WIDE_PREC_ROWS of them)
  int terms;
  size_t lo;
  int b0;
};

__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t hmul2u(uint32_t a, uint32_t b) {
  __half2 r = __hmul2(*reinterpret_cast<const __half2*>(&a), *reinterpret_cast<const __half2*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t hsub2u(uint32_t a, uint32_t b) {
  __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&a), *reinterpret_cast<const __half2*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Codes 4 h .. 4 h + 3 of a gf4 word as the f16x2 pairs (4 h, 4 h + 1) and
// (4 h + 2, 4 h + 3), each (code - 4) e5m2(scale) / -4, exactly: the two
// codes of a pair go under the mantissa of 1024, the first pair's at bit 0
// of each half (1024 + c, less 1028: c - 4), the second's at bit 6 (1024 +
// 64 c, less 1280: 64 (c - 4)), then one multiply by the scale, / -4 or
// / -256. The scale byte in the high byte of an f16 is the same e5m2 value.
// k1024: 0x64006400 (1024, 1024) in a register (one LOP3 a pair of codes:
// with both masks as immediates the compiler spends two).
__device__ __forceinline__ void gf4_frag(uint32_t w, int h, uint32_t k1024, uint32_t& a01,
                                         uint32_t& a23) {
  const uint32_t e2 = __byte_perm(w, 0u, 0x0404);  // [0, b0, 0, b0]
  const uint32_t lo = h ? w >> 20 : w >> 8;  // codes 4h, 4h + 2 to bits 0, 6
  const uint32_t hi = h ? w >> 7 : w << 5;   // codes 4h + 1, 4h + 3 to bits 16, 22
  const uint32_t m = __byte_perm(lo, hi, 0x7610);
  uint32_t v01, v23;  // (m & mask) | k1024
  asm("lop3.b32 %0, %1, 0x00070007, %2, 0xEA;" : "=r"(v01) : "r"(m), "r"(k1024));
  asm("lop3.b32 %0, %1, 0x01C001C0, %2, 0xEA;" : "=r"(v23) : "r"(m), "r"(k1024));
  a01 = hmul2u(hsub2u(v01, 0x64046404u), hmul2u(e2, 0xB400B400u));  // 1028; -1/4
  a23 = hmul2u(hsub2u(v23, 0x65006500u), hmul2u(e2, 0x9C009C00u));  // 1280; -1/256
}

// A lane's weights of one row and chunk, k = 16 t .. 16 t + 15, as 32-bit
// words: one 16-byte load (e5m2, e4m3), two (fp16), or two gf4 words, one 8-byte
// load (ODD: rows of n % 16 == 8 words, 4-byte aligned: word by word, the
// second zero past the row, where a stray inf or NaN scale times x's zero
// would be NaN); left: values of the row from the lane's first. frag gives
// the f16x2 A operands of (j0, j1) and (j2, j3) at step s (k = 16 t + 4 s +
// j).
template <int FMT>
struct MW {
  static constexpr int WORDS = FMT == 2 ? 2 : FMT == 0 ? 8 : 4;
  static constexpr int B16 = 4 * WORDS;  // bytes of 16 values
  template <bool ODD>
  static __device__ __forceinline__ void load(uint32_t (&w)[WORDS], const uint8_t* p,
                                              int left) {
    if constexpr (ODD) {
      w[0] = __ldcs(reinterpret_cast<const uint32_t*>(p));
      w[1] = left > 8 ? __ldcs(reinterpret_cast<const uint32_t*>(p) + 1) : 0u;
    } else if constexpr (FMT == 2) {
      const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));
      w[0] = a.x, w[1] = a.y;
    } else {
      const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
      if constexpr (WORDS == 8) {
        const uint4 b = __ldcs(reinterpret_cast<const uint4*>(p) + 1);
        w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
      }
    }
  }
  static __device__ __forceinline__ void frag(const uint32_t (&w)[WORDS], int s, uint32_t k1024,
                                              uint32_t& a01, uint32_t& a23) {
    if constexpr (FMT == 2) {
      gf4_frag(w[s >> 1], s & 1, k1024, a01, a23);
    } else if constexpr (FMT == 1) {
      a01 = __byte_perm(w[s], 0u, 0x1404);  // [0, b0, 0, b1]
      a23 = __byte_perm(w[s], 0u, 0x3424);  // [0, b2, 0, b3]
    } else if constexpr (FMT == 3) {  // e4m3, exactly
      a01 = e4m3x2_f16x2((unsigned short)(w[s] & 0xffffu));
      a23 = e4m3x2_f16x2((unsigned short)(w[s] >> 16));
    } else {
      a01 = w[2 * s], a23 = w[2 * s + 1];
    }
  }
};

// One warp: MT 16-row m-tiles of one row group x chunks [c0, c1) of k, for
// NT 8-row n-tiles of x. Lane (g, t) = (lane / 4, lane % 4) holds rows g
// and g + 8 of each m-tile in its A fragments, x row g of each n-tile in
// its B fragments, and C at rows g, g + 8 and x rows 2 t, 2 t + 1. ks warps
// of a block share a row group (k split), WARPS / ks groups a block, the
// groups of segment 0, then 1, then 2, each ceil(rows / 16 MT). The weight
// and x pointers step along k with the chunks, so a load's address is a
// register plus a constant. MOE: the MoE sweep's slot axis (see MArgs).
// FMT 3 (e4m3): each weight's sum times its scale s (w1's and w3's apart,
// before the activation), read on the device at the segment's scale, plus
// the slot's expert id under MOE, before any residual.
template <int FMT, int ACT, int MT, int NT, bool ODD, bool MOE = false>
__global__ void __launch_bounds__(WARPS * 32, 2) mmv_kernel(MArgs a) {
  using W = MW<FMT>;
  constexpr int NW = W::WORDS;
  constexpr int DUAL = ACT ? 2 : 1;
  constexpr int PER = DUAL * MT * 2 * W::B16;  // weight bytes a lane loads a chunk
  // chunks in flight: fp16/fp8 two where they fit in MV_INFLIGHT bytes, else
  // one; gf4 MV_U_GF4
  constexpr int U = FMT == 2 ? MV_U_GF4 : 2 * PER <= MV_INFLIGHT ? 2 : 1;
  constexpr int GR = 16 * MT;
  constexpr int NS = 8 * NT;
  constexpr int NACC = DUAL * MT * NT * 4;
  constexpr int XCH = 4 * NS * 4;  // uint4 fragments of x a chunk
  __shared__ float red[WARPS][NACC][32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ks = a.ks;
  const int grp = blockIdx.x * (WARPS / ks) + warp / ks, kw = warp % ks;
  const int g0 = (a.seg[0].rows + GR - 1) / GR;
  const int g1 = a.nseg > 1 ? (a.seg[1].rows + GR - 1) / GR : 0;
  const int g2 = a.nseg > 2 ? (a.seg[2].rows + GR - 1) / GR : 0;
  const bool live = grp < g0 + g1 + g2;
  Seg sg = a.seg[0];
  int r0 = grp * GR;
  if (live && grp >= g0) {
    const bool one = grp < g0 + g1;
    sg = one ? a.seg[1] : a.seg[2];
    r0 = (one ? grp - g0 : grp - g0 - g1) * GR;
  }
  const int nc = (a.n + CH - 1) / CH;
  const int c0 = live ? kw * nc / ks : 0, c1 = live ? (kw + 1) * nc / ks : 0;
  const uint4* xs = a.xs;
  const float* scs = a.sc;
  if constexpr (MOE) {  // the block's slot: every warp of it returns here, or none
    const int slot = blockIdx.y;
    sg.out += (size_t)slot * a.oslot;
    const int e = slot < __ldg(a.cnt) ? min(max(__ldg(a.eidx + slot), 0), a.E - 1) : -1;
    if (e < 0) {  // a dead slot: zeros, and no weight read
      if (kw == 0 && live)
        for (int i = lane; i < GR * a.B; i += 32) {
          const int row = r0 + i % GR;
          if (row < sg.rows) sg.out[(size_t)(i / GR) * sg.ld + row] = 0.f;
        }
      return;
    }
    sg.w += (size_t)e * a.wslot;
    if (ACT) sg.w3 += (size_t)e * a.wslot;
    if constexpr (FMT == 3) {  // the expert's scale, beside its id
      sg.s += e;
      if (ACT) sg.s3 += e;
    }
    xs += (size_t)slot * a.xslot;
    scs += (size_t)slot * a.scslot;
  }

  // rows g and g + 8 of each m-tile from chunk c0; bytes a row: n / 16 B16
  // (+ 4 for gf4 rows of n % 16 == 8)
  const size_t rb = (size_t)(a.n / 16) * W::B16 + (ODD ? 4 : 0);
  const uint8_t* wp[DUAL][MT][2];
#pragma unroll
  for (int m = 0; m < MT; m++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int row = min(r0 + 16 * m + 8 * h + g, sg.rows - 1);  // past rows: discarded
      const size_t off = (size_t)row * rb + (size_t)c0 * 4 * W::B16 + t * W::B16;
      wp[0][m][h] = sg.w + off;
      if (ACT) wp[DUAL - 1][m][h] = sg.w3 + off;
    }
  // x: lane (g, t)'s fragment of step 0 of chunk c0, n-tile 0; scales of its
  // C columns (x rows 2 t, 2 t + 1)
  const uint4* xp = xs + (size_t)c0 * XCH + g * 4 + t;
  const float* sp = scs + (size_t)c0 * NS + 2 * t;
  int left = a.n - (c0 * CH + 16 * t);  // values of the row from the lane's first
  uint32_t k1024;  // gf4_frag's constant, kept in a register
  asm("mov.b32 %0, 0x64006400;" : "=r"(k1024));

  float acc[DUAL][MT][NT][4];
#pragma unroll
  for (int d = 0; d < DUAL; d++)
#pragma unroll
    for (int m = 0; m < MT; m++)
#pragma unroll
      for (int nt = 0; nt < NT; nt++)
#pragma unroll
        for (int i = 0; i < 4; i++) acc[d][m][nt][i] = 0.f;

  for (int c = c0; c < c1; c += U) {
    uint32_t q[U][DUAL][MT][2][NW];
#pragma unroll
    for (int u = 0; u < U; u++) {
      // n % 16 == 0: a lane's 16 values are all inside the row or all past it
      const bool ok = c + u < c1 && left - u * CH > 0;
#pragma unroll
      for (int d = 0; d < DUAL; d++)
#pragma unroll
        for (int m = 0; m < MT; m++)
#pragma unroll
          for (int h = 0; h < 2; h++) {
            if (ok) {
              W::template load<ODD>(q[u][d][m][h], wp[d][m][h] + u * 4 * W::B16,
                                    left - u * CH);
            } else {
#pragma unroll
              for (int i = 0; i < NW; i++) q[u][d][m][h][i] = 0u;
            }
          }
    }
#pragma unroll
    for (int u = 0; u < U; u++) {
      if (c + u >= c1) break;
      uint4 xf[4][NT];  // x fragments: {hi, lo} of steps 0..3, zero for x rows past B
      float2 sv[NT];    // 2^e of this lane's two C columns
#pragma unroll
      for (int nt = 0; nt < NT; nt++) {
#pragma unroll
        for (int s = 0; s < 4; s++)
          xf[s][nt] = nt * 8 + g < a.B ? __ldg(xp + u * XCH + (s * NS + nt * 8) * 4)
                                       : make_uint4(0u, 0u, 0u, 0u);
        const int sl = nt * 8 + 2 * t;
        sv[nt] = sl < a.B ? __ldg(reinterpret_cast<const float2*>(sp + u * NS + nt * 8))
                          : make_float2(0.f, 0.f);
        if (sl + 1 >= a.B) sv[nt].y = 0.f;
      }
      float p[DUAL][MT][NT][4];
#pragma unroll
      for (int d = 0; d < DUAL; d++)
#pragma unroll
        for (int m = 0; m < MT; m++)
#pragma unroll
          for (int nt = 0; nt < NT; nt++)
#pragma unroll
            for (int i = 0; i < 4; i++) p[d][m][nt][i] = 0.f;
#pragma unroll
      for (int s = 0; s < 4; s++) {
        // A of step s, decoded once for every n-tile and both x parts
        uint32_t af[DUAL][MT][4];
#pragma unroll
        for (int d = 0; d < DUAL; d++)
#pragma unroll
          for (int m = 0; m < MT; m++) {
            W::frag(q[u][d][m][0], s, k1024, af[d][m][0], af[d][m][2]);  // row g
            W::frag(q[u][d][m][1], s, k1024, af[d][m][1], af[d][m][3]);  // row g + 8
          }
#pragma unroll
        for (int nt = 0; nt < NT; nt++) {
          const uint4 xv = xf[s][nt];
#pragma unroll
          for (int d = 0; d < DUAL; d++)
#pragma unroll
            for (int m = 0; m < MT; m++) {
              const uint32_t(&f)[4] = af[d][m];
              mma16816(p[d][m][nt], f[0], f[1], f[2], f[3], xv.x, xv.y);  // hi
              mma16816(p[d][m][nt], f[0], f[1], f[2], f[3], xv.z, xv.w);  // lo
            }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt++) {
        const float2 sc = sv[nt];
#pragma unroll
        for (int d = 0; d < DUAL; d++)
#pragma unroll
          for (int m = 0; m < MT; m++) {
            acc[d][m][nt][0] = fmaf(p[d][m][nt][0], sc.x, acc[d][m][nt][0]);
            acc[d][m][nt][1] = fmaf(p[d][m][nt][1], sc.y, acc[d][m][nt][1]);
            acc[d][m][nt][2] = fmaf(p[d][m][nt][2], sc.x, acc[d][m][nt][2]);
            acc[d][m][nt][3] = fmaf(p[d][m][nt][3], sc.y, acc[d][m][nt][3]);
          }
      }
    }
#pragma unroll
    for (int d = 0; d < DUAL; d++)
#pragma unroll
      for (int m = 0; m < MT; m++)
#pragma unroll
        for (int h = 0; h < 2; h++) wp[d][m][h] += U * 4 * W::B16;
    xp += U * XCH;
    sp += U * NS;
    left -= U * CH;
  }

  if (ks > 1) {  // the k split's partial C fragments meet in shared memory
#pragma unroll
    for (int d = 0; d < DUAL; d++)
#pragma unroll
      for (int m = 0; m < MT; m++)
#pragma unroll
        for (int nt = 0; nt < NT; nt++)
#pragma unroll
          for (int i = 0; i < 4; i++)
            red[warp][((d * MT + m) * NT + nt) * 4 + i][lane] = acc[d][m][nt][i];
    __syncthreads();
    if (kw == 0) {
      for (int j = 1; j < ks; j++)
#pragma unroll
        for (int d = 0; d < DUAL; d++)
#pragma unroll
          for (int m = 0; m < MT; m++)
#pragma unroll
            for (int nt = 0; nt < NT; nt++)
#pragma unroll
              for (int i = 0; i < 4; i++)
                acc[d][m][nt][i] += red[warp + j][((d * MT + m) * NT + nt) * 4 + i][lane];
    }
  }
  if (kw != 0 || !live) return;

  float s1 = 1.f, s3 = 1.f;  // e4m3: the scales of w and w3
  if constexpr (FMT == 3) {
    s1 = __ldg(sg.s);
    if (ACT) s3 = __ldg(sg.s3);
  }
#pragma unroll
  for (int m = 0; m < MT; m++)
#pragma unroll
    for (int nt = 0; nt < NT; nt++)
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const int row = r0 + 16 * m + g + 8 * (i >> 1);
        const int slot = nt * 8 + 2 * t + (i & 1);
        if (row < sg.rows && slot < a.B) {
          float y = acc[0][m][nt][i];
          if constexpr (FMT == 3) y *= s1;
          if (ACT) {
            float y3 = acc[DUAL - 1][m][nt][i];
            if constexpr (FMT == 3) y3 *= s3;
            y = act_fn(ACT, y) * y3;
          }
          const size_t o = (size_t)slot * sg.ld + row;
          sg.out[o] = sg.resid ? sg.resid[o] + y : y;
        }
      }
}

template <int FMT, int ACT, int MT, bool ODD, bool MOE>
cudaError_t launch_mmv_nt(const MArgs& a, int nt, dim3 grid, cudaStream_t st) {
  if (nt == 1)
    mmv_kernel<FMT, ACT, MT, 1, ODD, MOE><<<grid, WARPS * 32, 0, st>>>(a);
  else
    mmv_kernel<FMT, ACT, MT, 2, ODD, MOE><<<grid, WARPS * 32, 0, st>>>(a);
  return cudaGetLastError();
}

// 32 rows a warp (two m-tiles) only for one weight's launches of whole
// 16-value steps, as qmv_plan gives them: the dual launch and rows of an
// odd word count keep one
template <int FMT, int ACT, bool ODD, bool MOE>
cudaError_t launch_mmv_mt(const MArgs& a, int mt, int nt, dim3 grid, cudaStream_t st) {
  if constexpr (ACT == 0 && !ODD) {
    if (mt == 2) return launch_mmv_nt<FMT, ACT, 2, ODD, MOE>(a, nt, grid, st);
  }
  return launch_mmv_nt<FMT, ACT, 1, ODD, MOE>(a, nt, grid, st);
}

// plan (from qmv_plan): {mt, nt, ks, grid}; MOE: grid x slots blocks, the
// slot axis of a.eidx / a.cnt
template <int ACT, bool MOE = false>
cudaError_t launch_mmv(int fmt, MArgs a, const int* plan, cudaStream_t st, int slots = 1) {
  const int mt = plan[0], nt = plan[1], ks = plan[2], grid = plan[3];
  // fp16/fp8 rows of whole 16-value steps; a gf4 row may end half-way
  // (n % 16 == 8, one m-tile a warp)
  const bool odd = a.n % 16 != 0;
  if ((mt != 1 && mt != 2) || (nt != 1 && nt != 2) || a.B < 2 || a.B > 8 * nt ||
      ks < 1 || ks > WARPS || WARPS % ks != 0 || grid < 1 || a.n < 1 ||
      a.n % (fmt == 2 ? 8 : 16) != 0 || (mt == 2 && (odd || ACT != 0)) || slots < 1 ||
      slots > 65535 || (MOE && (!a.eidx || !a.cnt || a.E < 1 || a.nseg != 1)))
    return cudaErrorInvalidValue;
  a.ks = ks;
  const dim3 g(grid, slots);
  if (fmt == 2)
    return odd ? launch_mmv_mt<2, ACT, true, MOE>(a, mt, nt, g, st)
               : launch_mmv_mt<2, ACT, false, MOE>(a, mt, nt, g, st);
  if (fmt == 3) {  // e4m3: the dense products and the MoE sweep (no fused epilogue)
    if (!a.seg[0].s || (ACT && !a.seg[0].s3)) return cudaErrorInvalidValue;
    if constexpr (ACT == 0 || MOE) return launch_mmv_mt<3, ACT, false, MOE>(a, mt, nt, g, st);
    return cudaErrorInvalidValue;
  }
  return fmt == 1 ? launch_mmv_mt<1, ACT, false, MOE>(a, mt, nt, g, st)
                  : launch_mmv_mt<0, ACT, false, MOE>(a, mt, nt, g, st);
}

// ---------------------------------------------------------------------------
// The wide path's mma.sync kernel (mmw_kernel): 17 <= B <= 64 rows of x under
// --precise, and gf4 rows of n % 32 != 0 (see the note at the top), with or
// without the MoE slot axis; wide_kernel below takes the rest.
// ---------------------------------------------------------------------------

#define WIDE_ROWS 64       // rows of x the wide path takes, at most
#define WIDE_NT 8          // 8-row n-tiles a warp holds (those past B are skipped)
#define WIDE_PREC_ROWS 32  // --precise: rows of x a launch (4 n-tiles, one m-tile)
#define WIDE_RING 8192     // bytes of a warp's ring of weight chunks in shared memory
#define WIDE_BLOCKS 1      // blocks an SM the registers are budgeted for
#define WIDE_XAHEAD 2      // steps of x loaded ahead of the one that multiplies (< 4)
#define WIDE_RED 16        // accumulators a lane a round of the k split's sums

// the wide path on TMA (wide_kernel, below) takes x in one f16 term and
// weight rows of 16-byte multiples (gf4: n % 32 == 0); mmw_kernel the rest
bool wide_tma(int fmt, int n, int terms) { return terms == 1 && (fmt != 2 || n % 32 == 0); }

// One row of the wide staging, block b = blockIdx.x of slot blockIdx.y
// (rows z B .. z B + B - 1 of x, the MoE sweep's h): m = max |x| of the row,
// 2^e > m (e = 0 for a row of zeros, as stage4), hi = f16(x 2^-e) as uint2
// {hi01, hi23} at xs[((chunk * 4 + s) * WIDE_ROWS + b) * 4 + t] for the
// float4 c = 16 chunk + 4 t + s of the row (the order mmw_kernel's lanes
// read), and under terms 2 lo = f16(x 2^-e - hi) at xs + lo in the same
// order; sc[b] = 2^e. Chunks that n cuts are written whole, zeros past n.
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_rows_kernel(const float* x, uint2* xs, float* sc, int n, int terms, size_t lo,
                      size_t xslot, size_t scslot) {
  __shared__ float red[SPLIT_THREADS / 32];
  const int b = blockIdx.x, n4 = n >> 2, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* xr =
      reinterpret_cast<const float4*>(x + ((size_t)blockIdx.y * gridDim.x + b) * n);
  xs += blockIdx.y * xslot;
  sc += blockIdx.y * scslot;
  float m = 0.f;
  for (int c = threadIdx.x; c < n4; c += SPLIT_THREADS) {
    const float4 v = xr[c];
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int i = 0; i < SPLIT_THREADS / 32; i++) m = fmaxf(m, red[i]);
  int e;
  frexpf(m, &e);  // m = f 2^e, f in [0.5, 1): |x 2^-e| < 1 (e = 0 for m = 0)
  const float inv = ldexpf(1.0f, -e);
  const int c_end = ((n4 + 15) >> 4) << 4;  // whole chunks
  for (int c = threadIdx.x; c < c_end; c += SPLIT_THREADS) {
    const float4 v = c < n4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float f[4] = {v.x * inv, v.y * inv, v.z * inv, v.w * inv};
    __half hi[4], lw[4];
#pragma unroll
    for (int j = 0; j < 4; j++) {
      hi[j] = __float2half_rn(f[j]);
      lw[j] = __float2half_rn(f[j] - __half2float(hi[j]));  // the difference is exact
    }
    const int chunk = c >> 4, t = (c >> 2) & 3, s = c & 3;
    const size_t o = ((size_t)(chunk * 4 + s) * WIDE_ROWS + b) * 4 + t;
    xs[o] = make_uint2(h2bits(hi[0], hi[1]), h2bits(hi[2], hi[3]));
    if (terms == 2) xs[lo + o] = make_uint2(h2bits(lw[0], lw[1]), h2bits(lw[2], lw[3]));
  }
  if (threadIdx.x == 0) sc[b] = ldexpf(1.0f, e);
}

template <int FMT, int ACT, int MT, bool PREC>
struct Wide {
  using W = MW<FMT>;
  static constexpr int DUAL = ACT ? 2 : 1;
  static constexpr int NT = PREC ? WIDE_PREC_ROWS / 8 : WIDE_NT;
  static constexpr int PIECES = DUAL * MT * 2;     // (weight, m-tile, half) a lane loads
  static constexpr int LANE = PIECES * W::B16;     // weight bytes a lane a chunk
  // chunks in the ring: WIDE_RING bytes a warp, at most 8
  static constexpr int S = WIDE_RING / (32 * LANE) < 8 ? WIDE_RING / (32 * LANE) : 8;
  static constexpr size_t SMEM = (size_t)WARPS * S * 32 * LANE;  // dynamic shared memory
  static_assert(S >= 2, "two chunks in the ring at least");
  static_assert(SMEM >= (size_t)WARPS * WIDE_RED * 32 * 4, "the k split's sums reuse the ring");
};

// 16 bytes (8 for gf4, 4 + 4 for ODD gf4) of global memory to shared
// memory by cp.async, bypassing registers; src_size 0 writes zeros (a
// lane's values past the row)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// One warp: MT 16-row m-tiles of one row group x chunks [c0, c1) of k, for
// the ceil(B / 8) 8-row n-tiles of x that B fills (of NT), rows b0 .. b0 +
// B - 1 of the staging. Lanes, fragments, the k split, the segments and
// the MOE slot axis as mmv_kernel's. A lane's weights of a chunk go
// through a ring of S chunks in shared memory by cp.async, its own bytes
// only (no barrier), S - 1 chunks in flight while one computes; x's
// fragments are the wide staging's (split_rows_kernel), loaded
// WIDE_XAHEAD steps ahead in registers, one scale a row applied to the
// sums at the end. Default: one term, the mma sums straight
// into the accumulators (WIDE_NT n-tiles). PREC (--precise): hi and lo,
// each chunk's sums into a second set of accumulators and then added, as
// mmv_kernel's (a run of 64 mma sums on the tensor cores read ~1.4e-6 of a
// row's max from the float64 product on an H100, against ~2.8e-7 so);
// the registers of both sets hold WIDE_PREC_ROWS rows of x, so a call of
// more rows launches once for each 32. FMT 3: each weight's sum times its
// scale, as mmv_kernel.
template <int FMT, int ACT, int MT, bool ODD, bool MOE = false, bool PREC = false>
__global__ void __launch_bounds__(WARPS * 32, WIDE_BLOCKS) mmw_kernel(MArgs a) {
  using K = Wide<FMT, ACT, MT, PREC>;
  using W = MW<FMT>;
  constexpr int NW = W::WORDS;
  constexpr int DUAL = K::DUAL, NT = K::NT, S = K::S, LANE = K::LANE;
  constexpr int GR = 16 * MT;
  constexpr int NACC = DUAL * MT * NT * 4;
  constexpr int XCH = 4 * WIDE_ROWS * 4;  // uint2 fragments of one term a chunk
  static_assert(NACC % WIDE_RED == 0, "the k split's rounds");
  extern __shared__ __align__(16) uint8_t ring[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ks = a.ks;
  const int grp = blockIdx.x * (WARPS / ks) + warp / ks, kw = warp % ks;
  const int g0 = (a.seg[0].rows + GR - 1) / GR;
  const int g1 = a.nseg > 1 ? (a.seg[1].rows + GR - 1) / GR : 0;
  const int g2 = a.nseg > 2 ? (a.seg[2].rows + GR - 1) / GR : 0;
  const bool live = grp < g0 + g1 + g2;
  Seg sg = a.seg[0];
  int r0 = grp * GR;
  if (live && grp >= g0) {
    const bool one = grp < g0 + g1;
    sg = one ? a.seg[1] : a.seg[2];
    r0 = (one ? grp - g0 : grp - g0 - g1) * GR;
  }
  const int nc = (a.n + CH - 1) / CH;
  const int c0 = live ? kw * nc / ks : 0, c1 = live ? (kw + 1) * nc / ks : 0;
  const uint2* xs = reinterpret_cast<const uint2*>(a.xs);
  const float* scs = a.sc;
  if constexpr (MOE) {  // the block's slot: every warp of it returns here, or none
    const int slot = blockIdx.y;
    sg.out += (size_t)slot * a.oslot;
    const int e = slot < __ldg(a.cnt) ? min(max(__ldg(a.eidx + slot), 0), a.E - 1) : -1;
    if (e < 0) {  // a dead slot: zeros, and no weight read
      if (kw == 0 && live)
        for (int i = lane; i < GR * a.B; i += 32) {
          const int row = r0 + i % GR;
          if (row < sg.rows) sg.out[(size_t)(a.b0 + i / GR) * sg.ld + row] = 0.f;
        }
      return;
    }
    sg.w += (size_t)e * a.wslot;
    if (ACT) sg.w3 += (size_t)e * a.wslot;
    if constexpr (FMT == 3) {
      sg.s += e;
      if (ACT) sg.s3 += e;
    }
    xs += (size_t)slot * a.xslot;
    scs += (size_t)slot * a.scslot;
  }
  const int ntl = (a.B + 7) >> 3;  // n-tiles that B fills

  const size_t rb = (size_t)(a.n / 16) * W::B16 + (ODD ? 4 : 0);
  const uint8_t* wp[DUAL][MT][2];
#pragma unroll
  for (int m = 0; m < MT; m++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int row = min(r0 + 16 * m + 8 * h + g, sg.rows - 1);  // past rows: discarded
      const size_t off = (size_t)row * rb + (size_t)c0 * 4 * W::B16 + t * W::B16;
      wp[0][m][h] = sg.w + off;
      if (ACT) wp[DUAL - 1][m][h] = sg.w3 + off;
    }
  // this lane's bytes of stage st, piece p: lane-major, so that a warp's
  // copy and read of a piece are whole contiguous rows of banks
  const uint32_t mine = (uint32_t)__cvta_generic_to_shared(ring) +
                        (uint32_t)(warp * S * 32 * LANE + lane * W::B16);
  // chunk c (c0 + i) of the weights into stage i % S; chunks past c1 or
  // values past the row (the row's last chunk) as zeros
  auto fill = [&](int i) {
    const int c = c0 + i;
    const int left = a.n - (c * CH + 16 * t);  // values of the row from the lane's first
    const bool ok = c < c1 && left > 0;
    const uint32_t st = mine + (uint32_t)((i % S) * K::PIECES * 32 * W::B16);
#pragma unroll
    for (int d = 0; d < DUAL; d++)
#pragma unroll
      for (int m = 0; m < MT; m++)
#pragma unroll
        for (int h = 0; h < 2; h++) {
          const int p = (d * MT + m) * 2 + h;
          const uint8_t* src = wp[d][m][h] + (size_t)i * 4 * W::B16;
          const uint32_t dst = st + (uint32_t)(p * 32 * W::B16);
          if constexpr (ODD) {  // 4-byte aligned words; the second zero past the row
            cp_async4(dst, src, ok);
            cp_async4(dst + 4, src + 4, ok && left > 8);
          } else if constexpr (W::B16 == 8) {
            cp_async8(dst, src, ok);
          } else {
#pragma unroll
            for (int j = 0; j < W::B16; j += 16) cp_async16(dst + j, src + j, ok);
          }
        }
  };
  // lane (g, t)'s fragment of step 0 of chunk c0, n-tile 0 (row b0 + g)
  const uint2* xp = xs + (size_t)c0 * XCH + (a.b0 + g) * 4 + t;
  uint32_t k1024;
  asm("mov.b32 %0, 0x64006400;" : "=r"(k1024));

  float acc[DUAL][MT][NT][4];
#pragma unroll
  for (int d = 0; d < DUAL; d++)
#pragma unroll
    for (int m = 0; m < MT; m++)
#pragma unroll
      for (int nt = 0; nt < NT; nt++)
#pragma unroll
        for (int i = 0; i < 4; i++) acc[d][m][nt][i] = 0.f;

#pragma unroll
  for (int i = 0; i < S - 1; i++) {
    fill(i);
    cp_async_commit();
  }
  // x's fragments of (chunk i, step s) into dst (lo into dl under PREC),
  // zeros for x rows past B and when !ok; WIDE_XAHEAD steps ahead, in
  // four buffers indexed by the step (the indices stay constants)
  uint2 xf[4][NT], xl[4][PREC ? NT : 1];
  auto loadx = [&](int i, int s, uint2 (&dst)[NT], uint2 (&dl)[PREC ? NT : 1], bool ok) {
    const uint2* xq = xp + (size_t)i * XCH + s * WIDE_ROWS * 4;
#pragma unroll
    for (int nt = 0; nt < NT; nt++) {
      const bool in = ok && nt * 8 + g < a.B;
      dst[nt] = in ? __ldg(xq + nt * 32) : make_uint2(0u, 0u);
      if constexpr (PREC) dl[nt] = in ? __ldg(xq + a.lo + nt * 32) : make_uint2(0u, 0u);
    }
  };
#pragma unroll
  for (int s = 0; s < WIDE_XAHEAD; s++)
    loadx(0, s, xf[s], xl[s], c0 < c1);
  for (int i = 0; c0 + i < c1; i++) {
    fill(i + S - 1);  // into the stage read last round
    cp_async_commit();
    cp_async_wait<S - 1>();  // chunk i has landed
    uint32_t q[DUAL][MT][2][NW];
    const uint32_t st = mine + (uint32_t)((i % S) * K::PIECES * 32 * W::B16);
#pragma unroll
    for (int d = 0; d < DUAL; d++)
#pragma unroll
      for (int m = 0; m < MT; m++)
#pragma unroll
        for (int h = 0; h < 2; h++) {
          const uint32_t src = st + (uint32_t)(((d * MT + m) * 2 + h) * 32 * W::B16);
          if constexpr (NW == 2) {
            asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                         : "=r"(q[d][m][h][0]), "=r"(q[d][m][h][1]) : "r"(src));
          } else {
#pragma unroll
            for (int j = 0; j < NW; j += 4)
              asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                           : "=r"(q[d][m][h][j]), "=r"(q[d][m][h][j + 1]),
                             "=r"(q[d][m][h][j + 2]), "=r"(q[d][m][h][j + 3])
                           : "r"(src + 4 * j));
          }
        }
    // PREC: this chunk's sums, added to acc after it; else acc itself
    float p[PREC ? DUAL : 1][PREC ? MT : 1][PREC ? NT : 1][4];
    if constexpr (PREC) {
#pragma unroll
      for (int d = 0; d < DUAL; d++)
#pragma unroll
        for (int m = 0; m < MT; m++)
#pragma unroll
          for (int nt = 0; nt < NT; nt++)
#pragma unroll
            for (int j = 0; j < 4; j++) p[d][m][nt][j] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < 4; s++) {
      // x of step s + WIDE_XAHEAD (of the next chunk past step 3) in
      // flight while this one multiplies
      loadx(i + (s + WIDE_XAHEAD) / 4, (s + WIDE_XAHEAD) & 3, xf[(s + WIDE_XAHEAD) & 3],
            xl[(s + WIDE_XAHEAD) & 3], s + WIDE_XAHEAD < 4 || c0 + i + 1 < c1);
      uint32_t af[DUAL][MT][4];
#pragma unroll
      for (int d = 0; d < DUAL; d++)
#pragma unroll
        for (int m = 0; m < MT; m++) {
          W::frag(q[d][m][0], s, k1024, af[d][m][0], af[d][m][2]);  // row g
          W::frag(q[d][m][1], s, k1024, af[d][m][1], af[d][m][3]);  // row g + 8
        }
#pragma unroll
      for (int nt = 0; nt < NT; nt++) {
        if (nt < ntl) {  // warp-uniform: tiles past B are skipped
          const uint2 xv = xf[s][nt], xw = xl[s][PREC ? nt : 0];
#pragma unroll
          for (int d = 0; d < DUAL; d++)
#pragma unroll
            for (int m = 0; m < MT; m++) {
              const uint32_t(&f)[4] = af[d][m];
              if constexpr (PREC) {
                mma16816(p[d][m][nt], f[0], f[1], f[2], f[3], xv.x, xv.y);
                mma16816(p[d][m][nt], f[0], f[1], f[2], f[3], xw.x, xw.y);
              } else {
                mma16816(acc[d][m][nt], f[0], f[1], f[2], f[3], xv.x, xv.y);
              }
            }
        }
      }
    }
    if constexpr (PREC) {
#pragma unroll
      for (int d = 0; d < DUAL; d++)
#pragma unroll
        for (int m = 0; m < MT; m++)
#pragma unroll
          for (int nt = 0; nt < NT; nt++)
#pragma unroll
            for (int j = 0; j < 4; j++) acc[d][m][nt][j] += p[d][m][nt][j];
    }
  }
  cp_async_wait<0>();  // the ring's last (empty) groups, before it is reused

  if (ks > 1) {  // the k split's partial sums meet in the ring, WIDE_RED a round
    // (acc indexed by constants only: an address of it would put it in
    // local memory for the whole kernel)
    float* red = reinterpret_cast<float*>(ring);  // [WARPS][WIDE_RED][32]
    __syncthreads();  // every warp is past its ring
#pragma unroll
    for (int r = 0; r < NACC / WIDE_RED; r++) {
#pragma unroll
      for (int d = 0; d < DUAL; d++)
#pragma unroll
        for (int m = 0; m < MT; m++)
#pragma unroll
          for (int nt = 0; nt < NT; nt++)
#pragma unroll
            for (int i = 0; i < 4; i++) {
              const int f = ((d * MT + m) * NT + nt) * 4 + i;
              if (f / WIDE_RED == r)
                red[(warp * WIDE_RED + f % WIDE_RED) * 32 + lane] = acc[d][m][nt][i];
            }
      __syncthreads();
      if (kw == 0)
        for (int j = 1; j < ks; j++)
#pragma unroll
          for (int d = 0; d < DUAL; d++)
#pragma unroll
            for (int m = 0; m < MT; m++)
#pragma unroll
              for (int nt = 0; nt < NT; nt++)
#pragma unroll
                for (int i = 0; i < 4; i++) {
                  const int f = ((d * MT + m) * NT + nt) * 4 + i;
                  if (f / WIDE_RED == r)
                    acc[d][m][nt][i] += red[((warp + j) * WIDE_RED + f % WIDE_RED) * 32 + lane];
                }
      __syncthreads();
    }
  }
  if (kw != 0 || !live) return;

  float s1 = 1.f, s3 = 1.f;  // e4m3: the scales of w and w3
  if constexpr (FMT == 3) {
    s1 = __ldg(sg.s);
    if (ACT) s3 = __ldg(sg.s3);
  }
#pragma unroll
  for (int nt = 0; nt < NT; nt++) {
    if (nt >= ntl) break;
    const int sl = nt * 8 + 2 * t;  // this lane's x rows b0 + sl, b0 + sl + 1
    const float x0 = sl < a.B ? __ldg(scs + a.b0 + sl) : 0.f;
    const float x1 = sl + 1 < a.B ? __ldg(scs + a.b0 + sl + 1) : 0.f;
#pragma unroll
    for (int m = 0; m < MT; m++)
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const int row = r0 + 16 * m + g + 8 * (i >> 1);
        const int slot = a.b0 + sl + (i & 1);
        if (row < sg.rows && sl + (i & 1) < a.B) {
          const float xsc = i & 1 ? x1 : x0;
          float y = acc[0][m][nt][i] * xsc;
          if constexpr (FMT == 3) y *= s1;
          if (ACT) {
            float y3 = acc[DUAL - 1][m][nt][i] * xsc;
            if constexpr (FMT == 3) y3 *= s3;
            y = act_fn(ACT, y) * y3;
          }
          const size_t o = (size_t)slot * sg.ld + row;
          sg.out[o] = sg.resid ? sg.resid[o] + y : y;
        }
      }
  }
}

// one instantiation's launch, its dynamic shared memory allowed at first use
template <int FMT, int ACT, int MT, bool ODD, bool MOE, bool PREC>
void launch_mmw_one(const MArgs& a, dim3 g, cudaStream_t st) {
  using K = Wide<FMT, ACT, MT, PREC>;
  static const cudaError_t set = cudaFuncSetAttribute(
      mmw_kernel<FMT, ACT, MT, ODD, MOE, PREC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)K::SMEM);
  (void)set;  // a refusal shows as the launch's error
  mmw_kernel<FMT, ACT, MT, ODD, MOE, PREC><<<g, WARPS * 32, K::SMEM, st>>>(a);
}

// the default's one term takes gf4 only here (rows TMA cannot read; the
// other formats take wide_kernel), --precise every format
template <int ACT, bool MOE, bool PREC>
void launch_mmw_fmt(int fmt, bool odd, const MArgs& a, dim3 g, cudaStream_t st) {
  constexpr int MT = ACT == 0 && !PREC ? 2 : 1;
  if (fmt == 2) {
    if (odd)
      launch_mmw_one<2, ACT, 1, true, MOE, PREC>(a, g, st);
    else
      launch_mmw_one<2, ACT, MT, false, MOE, PREC>(a, g, st);
  } else if constexpr (PREC) {
    if (fmt == 3)
      launch_mmw_one<3, ACT, MT, false, MOE, PREC>(a, g, st);
    else if (fmt == 1)
      launch_mmw_one<1, ACT, MT, false, MOE, PREC>(a, g, st);
    else
      launch_mmw_one<0, ACT, MT, false, MOE, PREC>(a, g, st);
  }
}

// plan (from qmv_plan, 17-64 rows): {mt, nt, ks, grid}; by default nt =
// WIDE_NT and mt 2 for one weight's launches of whole 16-value steps, else
// 1 (the dual launch, gf4 rows of an odd word count); under --precise
// (a.terms 2) nt = WIDE_PREC_ROWS / 8 and mt 1, one launch for each
// WIDE_PREC_ROWS rows of x. MOE: grid x slots blocks.
template <int ACT, bool MOE = false>
cudaError_t launch_mmw(int fmt, MArgs a, const int* plan, cudaStream_t st, int slots = 1) {
  const int mt = plan[0], nt = plan[1], ks = plan[2], grid = plan[3];
  const bool odd = a.n % 16 != 0, prec = a.terms == 2;
  if (mt != (ACT == 0 && !odd && !prec ? 2 : 1) ||
      nt != (prec ? WIDE_PREC_ROWS / 8 : WIDE_NT) || a.B <= 16 || a.B > WIDE_ROWS ||
      ks < 1 || ks > WARPS || WARPS % ks != 0 || grid < 1 || a.n < 1 ||
      a.n % (fmt == 2 ? 8 : 16) != 0 || (a.terms != 1 && a.terms != 2) || fmt < 0 ||
      fmt > 3 || slots < 1 || slots > 65535 ||
      (MOE && (!a.eidx || !a.cnt || a.E < 1 || a.nseg != 1)))
    return cudaErrorInvalidValue;
  if (fmt == 3 && (!a.seg[0].s || (ACT && !a.seg[0].s3))) return cudaErrorInvalidValue;
  if (ACT != 0 && !MOE) return cudaErrorInvalidValue;  // the fused epilogues stop at 16 rows
  if (wide_tma(fmt, a.n, a.terms)) return cudaErrorInvalidValue;  // wide_kernel's launches
  a.ks = ks;
  const dim3 g(grid, slots);
  if constexpr (ACT == 0 || MOE) {
    if (!prec) {
      launch_mmw_fmt<ACT, MOE, false>(fmt, odd, a, g, st);
    } else {
      const int B = a.B;
      for (int b0 = 0; b0 < B; b0 += WIDE_PREC_ROWS) {
        a.b0 = b0;
        a.B = min(WIDE_PREC_ROWS, B - b0);
        launch_mmw_fmt<ACT, MOE, true>(fmt, odd, a, g, st);
      }
    }
  }
  return cudaGetLastError();
}

// uint2 fragments of one term of the wide staging of n values, and the
// floats of its scales (one a row)
size_t wide_frags(int n) { return (size_t)((n + CH - 1) / CH) * 4 * WIDE_ROWS * 4; }
#define WIDE_SCALES WIDE_ROWS

// ---------------------------------------------------------------------------
// The wide path on TMA and wgmma (wide_kernel): 17 <= B <= 64 rows of x in
// one f16 term, every format whose weight rows TMA reads (16-byte multiples:
// all but gf4 rows of n % 32 != 0), with or without the MoE slot axis (see
// the note at the top). --precise and those gf4 rows take mmw_kernel above.
// ---------------------------------------------------------------------------

#define WT_K 128        // k values a stage; the staging permutes k within each 128
#define WT_ROWS 64      // weight rows a consumer warpgroup
#define WT_THREADS 288  // two consumer warpgroups (warps 0-7) and the producer warp (8)
#define WT_RING 106496  // bytes of a block's ring at most: two blocks an SM
#define WT_EP 68        // floats a row of the epilogue's sums (64 + 4: no bank conflicts)
#define WT_KS 8         // k parts a tile at most: the blocks of a portable cluster
#define STAGE_THREADS 1024
#define STAGE_VEC 4     // float4s of x a staging thread holds: rows of 16384 values read once

// n rounded up to whole stages; halfs of one row slot set of its staging
__host__ __device__ size_t wt_npad(int n) { return (size_t)(n + WT_K - 1) / WT_K * WT_K; }
size_t wt_halfs(int n) { return WIDE_ROWS * wt_npad(n); }

template <int FMT, int N>
struct WT {
  static constexpr int WB = FMT == 0 ? 256 : FMT == 2 ? 64 : 128;  // weight bytes a row a stage
  static constexpr int BOX = WB < 128 ? WB : 128;  // bytes a row of one TMA box
  static constexpr int WTILE = WT_ROWS * WB;       // one warpgroup's weights a stage
  static constexpr int XBOX = N * 128;             // one of x's two 64-value boxes
  static constexpr int STAGE = 2 * WTILE + 2 * XBOX;
  static constexpr int S = WT_RING / STAGE < 8 ? WT_RING / STAGE : 8;  // stages in the ring
  static constexpr int SMEM = S * STAGE + 1024;    // + the 1024-byte alignment
  static constexpr int NW = WB / 16;               // words of a row a lane holds a stage
  static_assert(S >= 2, "two stages at least");
  static_assert(2 * N * WT_EP * 4 <= S * STAGE, "the sums reuse the ring");
};

struct WArgs {
  float* out;       // out[b * ld + row] (+ slot * oslot under the MoE slot axis)
  const float* s0;  // e4m3: the scale of map 0's weight on the device (MoE: + expert id)
  const float* s1;  // e4m3 dual launch: map 1's (w3)
  const float* sc;  // x's row scales 2^e (+ slot * WIDE_SCALES where x is a slot's own)
  const int* eidx;  // MoE: (A,) expert ids, clamped to [0, E); null for a dense launch
  const int* cnt;   // MoE: live slots; a >= cnt writes zeros and reads no weight
  size_t oslot;
  int E;
  int xslots;  // x's stagings: 1 (shared) or one a slot
  int rows;    // output rows (of each weight)
  int ld;
  int B;
  int stages;  // WT_K-value stages of k
  int ks;      // k parts: the blocks of a cluster
  int dual;    // the w1/w3 launch: map 0 w1, map 1 w3, the same 64 rows
  int act;     // its activation: 1 SiLU, 2 GELU
};

__device__ __forceinline__ void ld_shared_v4(uint32_t* q, uint32_t addr) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
               : "r"(addr));
}

// A lane's words of weight row r (of its warpgroup's 64) in one stage: k =
// 32 t .. 32 t + 31 of the stage's 128, in order. e5m2/e4m3: 16-byte chunks
// 2 t and 2 t + 1 of the row's 128 bytes, which TMA's 128-byte swizzle puts
// at chunk ^ (r % 8); fp16: chunks 4 (t % 2) .. + 3 of box t / 2 (k 0-63,
// 64-127, 128 bytes a row each), swizzled alike; gf4: chunk t of the row's 64
// bytes (no swizzle). A quarter-warp (rows 2 i, 2 i + 1) reads eight
// different chunks, every bank once (fp16: twice).
template <int FMT>
__device__ __forceinline__ void wt_load(uint32_t* q, const uint8_t* tile, int r, int t) {
  const uint32_t base = smem_u32(tile);
  if constexpr (FMT == 2) {
    ld_shared_v4(q, base + r * 64 + 16 * t);
  } else if constexpr (FMT == 0) {
    const uint32_t row = base + (t >> 1) * (WT_ROWS * 128) + r * 128;
#pragma unroll
    for (int h = 0; h < 4; h++) ld_shared_v4(q + 4 * h, row + 16 * ((4 * (t & 1) + h) ^ (r & 7)));
  } else {
#pragma unroll
    for (int h = 0; h < 2; h++) ld_shared_v4(q + 4 * h, base + r * 128 + 16 * ((2 * t + h) ^ (r & 7)));
  }
}

// step k (of 8, 16 values each) of a lane's words: the f16x2 A operands of
// the stage's values 32 t + 4 k + (0, 1) and (2, 3), decoded as mmv_kernel's
// (MW::frag)
template <int FMT>
__device__ __forceinline__ void wt_frag(const uint32_t* q, int k, uint32_t k1024, uint32_t& a01,
                                        uint32_t& a23) {
  if constexpr (FMT == 2) {
    gf4_frag(q[k >> 1], k & 1, k1024, a01, a23);
  } else if constexpr (FMT == 1) {
    a01 = __byte_perm(q[k], 0u, 0x1404);
    a23 = __byte_perm(q[k], 0u, 0x3424);
  } else if constexpr (FMT == 3) {
    a01 = e4m3x2_f16x2((unsigned short)(q[k] & 0xffffu));
    a23 = e4m3x2_f16x2((unsigned short)(q[k] >> 16));
  } else {
    a01 = q[2 * k];
    a23 = q[2 * k + 1];
  }
}

// The wide staging for wide_kernel, row b = blockIdx.x of slot blockIdx.y
// (rows z B .. z B + B - 1 of x: the MoE sweep's h): one scale a row as
// split_rows_kernel (2^e > max |x|, e = 0 for a row of zeros) and hi = f16(x
// 2^-e) at xs[b * npad + p] (npad = n rounded up to WT_K, zeros past n): the
// stage's value k = 32 t + 4 s + j goes to p = 16 s + 2 t + j (j < 2) or 16 s
// + 8 + 2 t + j - 2, the slot of step s that wgmma's A fragment gives lane t's
// weights (wt_load, wt_frag); sc[b] = 2^e. Slot z's staging is xslot halfs
// and scslot floats after slot z - 1's. A thread holds STAGE_VEC float4s of
// the row in registers between the max and the writes (rows past 16384
// values read the rest twice).
__device__ __forceinline__ void stage_wide4(float4 v, float inv, int c, __half* xo) {
  const int k = 4 * c, t = (k >> 5) & 3, s = (k >> 2) & 7;
  uint32_t* o = reinterpret_cast<uint32_t*>(xo + (k & ~(WT_K - 1)) + 16 * s + 2 * t);
  o[0] = h2bits(__float2half_rn(v.x * inv), __float2half_rn(v.y * inv));
  o[4] = h2bits(__float2half_rn(v.z * inv), __float2half_rn(v.w * inv));  // 8 halfs on
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__global__ void __launch_bounds__(STAGE_THREADS)
    stage_wide_kernel(const float* x, __half* xs, float* sc, int n, size_t xslot, size_t scslot) {
  __shared__ float red[STAGE_THREADS / 32];
  const int b = blockIdx.x, n4 = n >> 2, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int np4 = (int)(wt_npad(n) >> 2);
  const float4* xr =
      reinterpret_cast<const float4*>(x + ((size_t)blockIdx.y * gridDim.x + b) * n);
  __half* xo = xs + blockIdx.y * xslot + (size_t)b * (4 * np4);
  float4 v[STAGE_VEC];
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < STAGE_VEC; k++) {
    const int c = threadIdx.x + k * STAGE_THREADS;
    v[k] = c < n4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    m = fmaxf(m, abs_max4(v[k]));
  }
  for (int c = threadIdx.x + STAGE_VEC * STAGE_THREADS; c < n4; c += STAGE_THREADS)
    m = fmaxf(m, abs_max4(xr[c]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int i = 0; i < STAGE_THREADS / 32; i++) m = fmaxf(m, red[i]);
  int e;
  frexpf(m, &e);  // m = f 2^e, f in [0.5, 1): |x 2^-e| < 1 (e = 0 for m = 0)
  const float inv = ldexpf(1.0f, -e);
#pragma unroll
  for (int k = 0; k < STAGE_VEC; k++) {
    const int c = threadIdx.x + k * STAGE_THREADS;
    if (c < np4) stage_wide4(v[k], inv, c, xo);
  }
  for (int c = threadIdx.x + STAGE_VEC * STAGE_THREADS; c < np4; c += STAGE_THREADS)
    stage_wide4(c < n4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f), inv, c, xo);
  if (threadIdx.x == 0) sc[blockIdx.y * scslot + b] = ldexpf(1.0f, e);
}

// One block: output rows r0 .. r0 + T - 1 (T = 128: two warpgroups of 64 rows
// of one weight; the dual launch T = 64, warpgroup 0 w1's rows and 1 w3's)
// against k part blockIdx.x % ks of the stages, all B rows of x (N, the
// compiled width, >= B: rows past B arrive as zeros). The producer warp keeps
// TMA loads of the weights (in their natural bytes) and x's two 64-value
// boxes in an S-stage ring, a full and an empty barrier a stage; each
// consumer warpgroup decodes its 64 rows of a stage to f16 A fragments in
// registers (exactly) and issues eight wgmma m64nNk16 against x in shared
// memory, f32 sums. The epilogue: the sums through shared memory; the ks
// blocks of a cluster (the k parts of one tile) then each add every part's
// sums, in rank order, for their share of x's rows through distributed
// shared memory (no atomics: the order is fixed), times x's row scale (and
// the e4m3 scales), the activation for the dual launch, stored row-fastest.
// MoE: blockIdx.y is the slot, its expert the 3-D maps' third coordinate, a
// dead slot writes zeros and reads no weight.
template <int FMT, int N>
__global__ void __launch_bounds__(WT_THREADS, 2)
    wide_kernel(const __grid_constant__ CUtensorMap wmap0,
                const __grid_constant__ CUtensorMap wmap1,
                const __grid_constant__ CUtensorMap xmap, WArgs a) {
  using P = WT<FMT, N>;
  extern __shared__ uint8_t wt_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wt_raw) + 1023) & ~(uintptr_t)1023);
  __shared__ __align__(8) uint64_t full[P::S], empty[P::S];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ks = a.ks, kp = blockIdx.x % ks;
  const int T = a.dual ? WT_ROWS : 2 * WT_ROWS;
  const int r0 = (blockIdx.x / ks) * T;
  const int slot = blockIdx.y;
  const int b_lo = kp * a.B / ks, b_hi = (kp + 1) * a.B / ks;  // rows of x this block stores
  float* out = a.out;
  int e = 0;
  if (a.eidx) {  // every block of the cluster returns here, or none
    out += (size_t)slot * a.oslot;
    e = slot < __ldg(a.cnt) ? min(max(__ldg(a.eidx + slot), 0), a.E - 1) : -1;
    if (e < 0) {
      for (int i = tid; i < (b_hi - b_lo) * T; i += WT_THREADS) {
        const int row = r0 + i % T;
        if (row < a.rows) out[(size_t)(b_lo + i / T) * a.ld + row] = 0.f;
      }
      return;
    }
  }
  const int st0 = kp * a.stages / ks, nst = (kp + 1) * a.stages / ks - st0;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < P::S; s++) {
      mbar_init(full + s, 1);   // the producer's arrival and the bytes
      mbar_init(empty + s, 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; i++) acc[i] = 0.f;
  if (warp == 8) {
    if (lane == 0) {
      const int xz = a.xslots > 1 ? slot : 0, r1 = a.dual ? r0 : r0 + WT_ROWS;
      auto weights = [&](int i) {  // stage i's weights, and the bytes of the whole stage
        const int s = i % P::S, kb = (st0 + i) * P::WB;
        uint8_t* st = ring + s * P::STAGE;
        mbar_expect_tx(full + s, P::STAGE);
#pragma unroll
        for (int h = 0; h < P::WB / P::BOX; h++) {
          tma_load_3d(st + h * WT_ROWS * P::BOX, &wmap0, full + s, kb + h * P::BOX, r0, e);
          tma_load_3d(st + P::WTILE + h * WT_ROWS * P::BOX, &wmap1, full + s, kb + h * P::BOX,
                      r1, e);
        }
      };
      auto xtile = [&](int i) {
        const int s = i % P::S, kx = (st0 + i) * WT_K;
        uint8_t* st = ring + s * P::STAGE;
        tma_load_3d(st + 2 * P::WTILE, &xmap, full + s, kx, 0, xz);
        tma_load_3d(st + 2 * P::WTILE + P::XBOX, &xmap, full + s, kx + 64, 0, xz);
      };
      for (int i = 0; i < nst; i++) {
        if (i >= P::S) mbar_wait(empty + i % P::S, ((i / P::S) - 1) & 1);
        weights(i);
        xtile(i);
      }
    }
  } else {
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int ra = 16 * (warp & 3) + g;  // this lane's rows ra, ra + 8 of its warpgroup's 64
    uint32_t k1024;
    asm("mov.b32 %0, 0x64006400;" : "=r"(k1024));
    uint32_t af[8][4];  // A of the stage's eight steps: rows ra, ra + 8 x values (0, 1), (2, 3)
#pragma unroll
    for (int k = 0; k < 8; k++)
#pragma unroll
      for (int j = 0; j < 4; j++) af[k][j] = 0u;
    for (int i = 0; i < nst; i++) {
      const int s = i % P::S;
      mbar_wait(full + s, (i / P::S) & 1);
      wgmma_wait<0>();  // the last stage's products are done: its x and the A registers are free
      fence_acc<N / 2>(acc);
      fence_regs<32>(&af[0][0]);
      if (i > 0 && lane == 0) mbar_arrive(empty + (i - 1) % P::S);
      const uint8_t* st = ring + s * P::STAGE;
      uint32_t q[2][P::NW];
      wt_load<FMT>(q[0], st + wg * P::WTILE, ra, t);
      wt_load<FMT>(q[1], st + wg * P::WTILE, ra + 8, t);
#pragma unroll
      for (int k = 0; k < 8; k++) {
        wt_frag<FMT>(q[0], k, k1024, af[k][0], af[k][2]);
        wt_frag<FMT>(q[1], k, k1024, af[k][1], af[k][3]);
      }
      const uint64_t xd = wgmma_desc(st + 2 * P::WTILE);
      fence_acc<N / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 8; k++)
        wgmma_rs_f16<N>(acc, af[k], xd + (k >> 2) * (P::XBOX >> 4) + 2 * (k & 3));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc<N / 2>(acc);
  }

  __syncthreads();  // every stage is consumed: the ring takes the sums
  float* ep = reinterpret_cast<float*>(ring);  // [warpgroup][row of x][row], WT_EP a row
  __shared__ float xsc[WIDE_ROWS];             // x's row scales
  if (tid < a.B) xsc[tid] = a.sc[(a.xslots > 1 ? (size_t)slot * WIDE_SCALES : 0) + tid];
  if (warp < 8) {
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3, ra = 16 * (warp & 3) + g;
    // register i: row ra + 8 ((i / 2) % 2), x row 8 (i / 4) + 2 t + i % 2
#pragma unroll
    for (int i = 0; i < N / 2; i++)
      ep[(wg * N + 8 * (i >> 2) + 2 * t + (i & 1)) * WT_EP + ra + 8 * ((i >> 1) & 1)] = acc[i];
  }
  float s0 = 1.f, s1 = 1.f;  // e4m3: the scales of the two weights
  if constexpr (FMT == 3) {
    s0 = __ldg(a.s0 + e);
    if (a.dual) s1 = __ldg(a.s1 + e);
  }
  __syncwarp();
  cluster_sync();
  // four rows a thread: float4 loads of the sums and stores of the outputs
  const int qsh = a.dual ? 4 : 5;  // T / 4 = 2^qsh
  const bool vec = (a.ld & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int i = tid; i < (b_hi - b_lo) << qsh; i += WT_THREADS) {
    const int b = b_lo + (i >> qsh), r = (i << 2) & (T - 1), row = r0 + r;
    const float* p0 = ep + ((r >> 6) * N + b) * WT_EP + (r & 63);
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f), y3 = y;
    if (ks == 1) {
      y = *reinterpret_cast<const float4*>(p0);
      if (a.dual) y3 = *reinterpret_cast<const float4*>(p0 + N * WT_EP);
    } else {  // every part's sums loaded at once, then added in rank order
      float4 v[WT_KS], v3[WT_KS];
#pragma unroll
      for (int p = 0; p < WT_KS; p++) {
        v[p] = v3[p] = y;
        if (p < ks) {
          v[p] = ld_cluster4(p0, p);
          if (a.dual) v3[p] = ld_cluster4(p0 + N * WT_EP, p);
        }
      }
#pragma unroll
      for (int p = 0; p < WT_KS; p++) {
        if (p < ks) {
          y = make_float4(y.x + v[p].x, y.y + v[p].y, y.z + v[p].z, y.w + v[p].w);
          y3 = make_float4(y3.x + v3[p].x, y3.y + v3[p].y, y3.z + v3[p].z, y3.w + v3[p].w);
        }
      }
    }
    const float xs = xsc[b];
    float o[4] = {y.x, y.y, y.z, y.w};
    const float o3[4] = {y3.x, y3.y, y3.z, y3.w};
#pragma unroll
    for (int j = 0; j < 4; j++) {
      o[j] *= xs;
      if constexpr (FMT == 3) o[j] *= s0;
      if (a.dual) {
        float z = o3[j] * xs;
        if constexpr (FMT == 3) z *= s1;
        o[j] = act_fn(a.act, o[j]) * z;
      }
    }
    float* dst = out + (size_t)b * a.ld + row;
    if (vec && row + 3 < a.rows) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; j++)
        if (row + j < a.rows) dst[j] = o[j];
    }
  }
  if (ks > 1) {  // no block leaves while another reads its sums
    __syncwarp();
    cluster_sync_relaxed();
  }
}

template <int FMT, int N>
cudaError_t launch_wide_one(const CUtensorMap& m0, const CUtensorMap& m1, const CUtensorMap& mx,
                            const WArgs& a, dim3 grid, cudaStream_t st) {
  using P = WT<FMT, N>;
  static const cudaError_t set = cudaFuncSetAttribute(
      wide_kernel<FMT, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (set != cudaSuccess) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WT_THREADS);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.ks > 1;  // a whole k: each block its own cluster
  const cudaError_t e = cudaLaunchKernelEx(&cfg, wide_kernel<FMT, N>, m0, m1, mx, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int FMT>
cudaError_t launch_wide_n(int N, const CUtensorMap& m0, const CUtensorMap& m1,
                          const CUtensorMap& mx, const WArgs& a, dim3 grid, cudaStream_t st) {
  if (N == 32) return launch_wide_one<FMT, 32>(m0, m1, mx, a, grid, st);
  if (N == 40) return launch_wide_one<FMT, 40>(m0, m1, mx, a, grid, st);
  return launch_wide_one<FMT, 64>(m0, m1, mx, a, grid, st);
}

size_t row_bytes(int fmt, int n);

// One launch of the TMA wide path: out (B, rows) = x . W^T, x staged at
// xs/sc by stage_wide_kernel, W (rows, n) in fmt (0 fp16, 1 e5m2, 2 gf4
// words, 3 e4m3 times s0); w3 (not null): the dual launch, out = act(x .
// W^T s0) (x . W3^T s1) with act 1 SiLU or 2 GELU. MoE (eidx, cnt): w the
// layer's (E, rows, n) stack, `slots` slots of grid x slots blocks, x shared
// (xslots 1) or a slot's own (xslots = slots), outputs oslot floats apart.
// plan (qmv_plan): {mt, nt, ks, grid}, mt = T / 16 (8, or 4 dual), nt = N /
// 8 for a compiled width N in {32, 40, 64}, grid = tiles x ks.
cudaError_t launch_wide(int fmt, const void* w, const void* w3, const void* s0, const void* s1,
                        void* out, int rows, int ld, const __half* xs, const float* sc, int B,
                        int n, int act, const int* plan, cudaStream_t st,
                        const void* eidx = nullptr, const void* cnt = nullptr, int E = 1,
                        int slots = 1, int xslots = 1, size_t oslot = 0) {
  const bool dual = w3 != nullptr;
  const int mt = plan[0], N = 8 * plan[1], ks = plan[2], grid = plan[3];
  const int T = dual ? WT_ROWS : 2 * WT_ROWS;
  const int stages = (n + WT_K - 1) / WT_K, tiles = (rows + T - 1) / T;
  const size_t rb = row_bytes(fmt, n);
  if (mt != T / 16 || (N != 32 && N != 40 && N != 64) || B <= 16 || B > N ||
      (ks != 1 && ks != 2 && ks != 4 && ks != WT_KS) || stages < ks || grid != tiles * ks ||
      rows < 1 || n < 1 || fmt < 0 || fmt > 3 || !wide_tma(fmt, n, 1) || rb % 16 != 0 ||
      (fmt == 3) != (s0 != nullptr) || (fmt == 3 && dual && !s1) ||
      (dual ? act != 1 && act != 2 : act != 0) || (eidx == nullptr) != (cnt == nullptr) ||
      slots < 1 || slots > 65535 || (!eidx && (slots != 1 || xslots != 1)) ||
      (xslots != 1 && xslots != slots) || E < 1)
    return cudaErrorInvalidValue;
  const int planes = eidx ? E : 1, box = fmt == 2 ? 64 : 128;
  const size_t plane = (size_t)rows * rb;
  const CUtensorMapSwizzle wsw = fmt != 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap m0, m1, mx;
  cudaError_t e = wt_map(&m0, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, rb, rows, planes, rb, plane, box,
                         WT_ROWS, wsw);
  if (e == cudaSuccess && dual)
    e = wt_map(&m1, CU_TENSOR_MAP_DATA_TYPE_UINT8, w3, rb, rows, planes, rb, plane, box, WT_ROWS,
               wsw);
  if (e == cudaSuccess)
    e = wt_map(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, xs, wt_npad(n), B, xslots, 2 * wt_npad(n),
               2 * wt_halfs(n), 64, N, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  WArgs a;
  a.out = static_cast<float*>(out);
  a.s0 = static_cast<const float*>(s0);
  a.s1 = static_cast<const float*>(s1);
  a.sc = sc;
  a.eidx = static_cast<const int*>(eidx);
  a.cnt = static_cast<const int*>(cnt);
  a.oslot = oslot;
  a.E = E;
  a.xslots = xslots;
  a.rows = rows;
  a.ld = ld;
  a.B = B;
  a.stages = stages;
  a.ks = ks;
  a.dual = dual;
  a.act = act;
  const CUtensorMap& m1r = dual ? m1 : m0;
  const dim3 g(grid, slots);
  if (fmt == 0) return launch_wide_n<0>(N, m0, m1r, mx, a, g, st);
  if (fmt == 1) return launch_wide_n<1>(N, m0, m1r, mx, a, g, st);
  if (fmt == 2) return launch_wide_n<2>(N, m0, m1r, mx, a, g, st);
  return launch_wide_n<3>(N, m0, m1r, mx, a, g, st);
}

// x (slots x B rows of n) staged for wide_kernel, slot z's staging wt_halfs(n)
// halfs and WIDE_SCALES scales after slot z - 1's
cudaError_t launch_stage_wide(const void* x, void* xs, float* sc, int B, int n, cudaStream_t st,
                              int slots = 1) {
  stage_wide_kernel<<<dim3(B, slots), STAGE_THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<__half*>(xs), sc, n, wt_halfs(n), WIDE_SCALES);
  return cudaGetLastError();
}

// x (slots x B rows of n) staged for the wide path, slot z's staging
// xslot uint2 and scslot floats after slot z - 1's
cudaError_t launch_split_rows(const void* x, uint2* xs, float* sc, int B, int n, int terms,
                              cudaStream_t st, int slots = 1, size_t xslot = 0,
                              size_t scslot = 0) {
  split_rows_kernel<<<dim3(B, slots), SPLIT_THREADS, 0, st>>>(
      static_cast<const float*>(x), xs, sc, n, terms, wide_frags(n), xslot, scslot);
  return cudaGetLastError();
}

// slots > 1: x holds slots x B rows, staged slot by slot xslot fragments
// and scslot scales apart
cudaError_t launch_split(const void* x, uint4* xs, float* sc, int ns, int B, int n,
                         cudaStream_t st, int slots = 1, size_t xslot = 0,
                         size_t scslot = 0) {
  const dim3 grid(((n >> 2) + SPLIT_THREADS - 1) / SPLIT_THREADS, B, slots);
  split_kernel<<<grid, SPLIT_THREADS, 0, st>>>(static_cast<const float*>(x), xs, sc,
                                               ns, n, xslot, scslot);
  return cudaGetLastError();
}

MArgs margs(const uint4* xs, const float* sc, int B, int n) {
  MArgs a;
  a.xs = xs;
  a.sc = sc;
  a.nseg = 1;
  a.B = B;
  a.n = n;
  a.ks = 1;
  a.eidx = a.cnt = nullptr;
  a.E = 0;
  a.wslot = a.xslot = a.scslot = a.oslot = 0;
  a.terms = 1;
  a.lo = 0;
  a.b0 = 0;
  return a;
}

// The MoE sweep's slot axis on m: experts' planes wslot bytes apart, each
// slot's staged x xslot fragments and scslot scales apart (0: shared), its
// output oslot floats apart.
void moe_slots(MArgs& m, const void* eidx, const void* cnt, int E, size_t wslot,
               size_t xslot, size_t scslot, size_t oslot) {
  m.eidx = static_cast<const int*>(eidx);
  m.cnt = static_cast<const int*>(cnt);
  m.E = E;
  m.wslot = wslot;
  m.xslot = xslot;
  m.scslot = scslot;
  m.oslot = oslot;
}

// bytes of a weight row of n values: fp16 2 n, e5m2 and e4m3 n, gf4 n / 2
size_t row_bytes(int fmt, int n) {
  return fmt == 2 ? (size_t)n / 2 : fmt == 0 ? 2 * (size_t)n : (size_t)n;
}

// uint4 fragments and scales of one row slot set's staging of n values
// (ns row slots a chunk): what stage4 writes
size_t staged_frags(int n, int ns) { return (size_t)((n + CH - 1) / CH) * 16 * ns; }
size_t staged_scales(int n, int ns) { return (size_t)((n + CH - 1) / CH) * ns; }

// one row (qmv_kernel); 2-16 rows take launch_mmv
template <int FMT, int ACT>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if (a.B != 1) return cudaErrorInvalidValue;
  int rows = 0;
  for (int s = 0; s < a.nseg; s++) rows += a.seg[s].rows;
  qmv_kernel<FMT, ACT><<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(a);
  return cudaGetLastError();
}

// one row in any format: gf4 takes gf4_row_kernel with its plan (unused
// for fp16/fp8)
template <int ACT>
cudaError_t launch_fmt(int fmt, const Args& a, const int* plan, cudaStream_t st) {
  if (fmt == 2) return launch_g1<ACT>(a, plan, st);
  return fmt == 1 ? launch<1, ACT>(a, st) : launch<0, ACT>(a, st);
}

cudaError_t launch_norm(const void* x, const void* g, void* out, int B, int n,
                        float eps, int sub_mean, cudaStream_t st, uint4* xs = nullptr,
                        float* sc = nullptr, int ns = 0) {
  norm_kernel<<<B, NORM_THREADS, 0, st>>>(static_cast<const float*>(x),
                                        static_cast<const float*>(g),
                                        static_cast<float*>(out), xs, sc, ns, n, eps,
                                        sub_mean);
  return cudaGetLastError();
}

Seg seg(const void* w, const void* w3, void* out, const void* resid, int rows,
        int ld, const void* sc = nullptr, const void* sc3 = nullptr) {
  Seg s;
  s.w = static_cast<const uint8_t*>(w);
  s.w3 = static_cast<const uint8_t*>(w3);
  s.out = static_cast<float*>(out);
  s.resid = static_cast<const float*>(resid);
  s.s = static_cast<const float*>(sc);
  s.s3 = static_cast<const float*>(sc3);
  s.rows = rows;
  s.ld = ld;
  return s;
}

Args args(const void* x, int B, int n) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.nseg = 1;
  a.B = B;
  a.n = n;
  return a;
}

// h = act(x . w1^T) * (x . w3^T), then out = [resid +] h . w2^T: two
// launches; x (B, D), h (B, H) scratch, out and resid (B, D). plans: for gf4,
// gf4_row_plan's {ks, grid} of w1/w3 and w2 (else unused).
cudaError_t ffn(int fmt, const void* x, const void* w1, const void* w3,
                const void* w2, void* h, void* out, const void* resid, int B,
                int D, int H, int act_gelu, const int* plans, cudaStream_t st) {
  Args s2 = args(x, B, D);
  s2.seg[0] = seg(w1, w3, h, nullptr, H, H);
  cudaError_t e =
      act_gelu ? launch_fmt<2>(fmt, s2, plans, st) : launch_fmt<1>(fmt, s2, plans, st);
  if (e != cudaSuccess) return e;
  Args s3 = args(h, B, H);
  s3.seg[0] = seg(w2, nullptr, out, resid, D, D);
  return launch_fmt<0>(fmt, s3, plans ? plans + G1_PLAN : nullptr, st);
}

// r1 = r + a . wo^T, xn = ffn-norm(r1), then ffn() of xn into out with
// [resid +]: the epilogue's stages before the next layer's q/k/v. plans:
// for gf4, gf4_row_plan's of wo, w1/w3 and w2.
cudaError_t offn(int fmt, const void* a, const void* r, const void* g,
                 const void* wo, const void* w1, const void* w3, const void* w2,
                 void* r1, void* xn, void* h, void* out, const void* resid,
                 int B, int D, int H, int Qd, int act_gelu, float eps,
                 int sub_mean, const int* plans, cudaStream_t st) {
  Args s1 = args(a, B, Qd);
  s1.seg[0] = seg(wo, nullptr, r1, r, D, D);
  cudaError_t e = launch_fmt<0>(fmt, s1, plans, st);
  if (e != cudaSuccess) return e;
  if ((e = launch_norm(r1, g, xn, B, D, eps, sub_mean, st)) != cudaSuccess) return e;
  return ffn(fmt, xn, w1, w3, w2, h, out, resid, B, D, H, act_gelu,
             plans ? plans + G1_PLAN : nullptr, st);
}

// The multi-row path's FFN from x (B, D) already staged in xs/sc: the
// dual w1/w3 launch into h, h staged, the w2 launch into out [resid +].
// plans: qmv_plan's {mt, nt, ks, grid} of w1/w3 and w2.
cudaError_t ffn_staged(int fmt, const void* w1, const void* w3, const void* w2, void* h,
                       void* out, const void* resid, int B, int D, int H, int act_gelu,
                       uint4* xs, float* sc, const int* plans, cudaStream_t st) {
  MArgs m = margs(xs, sc, B, D);
  m.seg[0] = seg(w1, w3, h, nullptr, H, H);
  cudaError_t e =
      act_gelu ? launch_mmv<2>(fmt, m, plans, st) : launch_mmv<1>(fmt, m, plans, st);
  if (e != cudaSuccess) return e;
  if ((e = launch_split(h, xs, sc, 8 * plans[1], B, H, st)) != cudaSuccess) return e;
  m = margs(xs, sc, B, H);
  m.seg[0] = seg(w2, nullptr, out, resid, D, D);
  return launch_mmv<0>(fmt, m, plans + 4, st);
}

// offn() on the multi-row path, each product by mmv_kernel from x staged
// just before it: a by split_kernel, ffn-norm(r1) by the norm launch (no
// f32 copy), then ffn_staged. plans: qmv_plan's of wo, w1/w3 and w2.
cudaError_t offn_mr(int fmt, const void* a, const void* r, const void* g, const void* wo,
                    const void* w1, const void* w3, const void* w2, void* r1, void* h,
                    void* out, const void* resid, int B, int D, int H, int Qd, int act_gelu,
                    float eps, int sub_mean, uint4* xs, float* sc, const int* plans,
                    cudaStream_t st) {
  const int ns = 8 * plans[1];
  cudaError_t e = launch_split(a, xs, sc, ns, B, Qd, st);
  if (e != cudaSuccess) return e;
  MArgs m = margs(xs, sc, B, Qd);
  m.seg[0] = seg(wo, nullptr, r1, r, D, D);  // r1 = r + a . wo^T
  if ((e = launch_mmv<0>(fmt, m, plans, st)) != cudaSuccess) return e;
  if ((e = launch_norm(r1, g, nullptr, B, D, eps, sub_mean, st, xs, sc, ns)) != cudaSuccess)
    return e;
  return ffn_staged(fmt, w1, w3, w2, h, out, resid, B, D, H, act_gelu, xs, sc, plans + 4, st);
}

// The epilogue on the multi-row path: offn_mr into x = r1 + ffn, then
// attn-norm(x) staged by its norm launch and the q/k/v launch.
// plans: qmv_plan's {mt, nt, ks, grid} of wo, w1/w3, w2 and q/k/v.
cudaError_t qx_offn_qkv_mr(int fmt, const void* a, const void* r, const void* g,
                           const void* anx, const void* wo, const void* w1,
                           const void* w3, const void* w2, const void* wq,
                           const void* wk, const void* wv, void* r1, void* h, void* x,
                           void* qkv, int B, int D, int H, int Qd, int KVd,
                           int act_gelu, float eps, int sub_mean, uint4* xs, float* sc,
                           const int* plans, cudaStream_t st) {
  cudaError_t e = offn_mr(fmt, a, r, g, wo, w1, w3, w2, r1, h, x, r1, B, D, H, Qd, act_gelu,
                          eps, sub_mean, xs, sc, plans, st);
  if (e != cudaSuccess) return e;
  if ((e = launch_norm(x, anx, nullptr, B, D, eps, sub_mean, st, xs, sc, 8 * plans[1])) !=
      cudaSuccess)
    return e;
  MArgs m = margs(xs, sc, B, D);
  const int ld = Qd + 2 * KVd;
  float* o = static_cast<float*>(qkv);
  m.seg[0] = seg(wq, nullptr, o, nullptr, Qd, ld);
  m.seg[1] = seg(wk, nullptr, o + Qd, nullptr, KVd, ld);
  m.seg[2] = seg(wv, nullptr, o + Qd + KVd, nullptr, KVd, ld);
  m.nseg = 3;
  return launch_mmv<0>(fmt, m, plans + 12, st);
}

}  // namespace

extern "C" {

// y (B, d) = x (B, n) . W^T for W (d, n) in fp16 (fmt 0), fp8 e5m2 (fmt
// 1) or fp8 e4m3 (fmt 3, times its scale: a device pointer, at the layer's
// entry; null for the other formats), or W (d, n/8) gf4 words (fmt 2) from
// 2 rows (one gf4 row: calm_gf4_matvec, gf4.cu); w points at the layer's
// plane. B >= 2 takes the multi-row path and needs a plan: x staged into
// xs/sc (caller-allocated, qmv_plan's sizes), then plan's launch (2-16
// rows mmv_kernel, 17-64 the wide path: wide_kernel with x in one f16
// term, or under --precise (`terms` 2; 1 otherwise, unused below 17 rows)
// and for gf4 rows of n % 32 != 0 mmw_kernel); B = 1 the loop of
// one row (xs, sc and plan unused). B >= 2 without a plan returns
// cudaErrorInvalidValue.
int calm_qmm_decode(const void* x, const void* w, void* y, int B, int d, int n,
                    int fmt, const void* scale, void* xs, void* sc, const void* plan,
                    int terms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((fmt == 3) != (scale != nullptr)) return (int)cudaErrorInvalidValue;
  if (B > 16) {  // the wide path
    if (!plan) return (int)cudaErrorInvalidValue;
    float* scf = static_cast<float*>(sc);
    if (wide_tma(fmt, n, terms)) {
      cudaError_t e = launch_stage_wide(x, xs, scf, B, n, st);
      if (e != cudaSuccess) return (int)e;
      return (int)launch_wide(fmt, w, nullptr, scale, nullptr, y, d, d,
                              static_cast<const __half*>(xs), scf, B, n, 0,
                              static_cast<const int*>(plan), st);
    }
    uint2* xs2 = static_cast<uint2*>(xs);
    cudaError_t e = launch_split_rows(x, xs2, scf, B, n, terms, st);
    if (e != cudaSuccess) return (int)e;
    MArgs m = margs(static_cast<const uint4*>(xs), scf, B, n);
    m.terms = terms;
    m.lo = wide_frags(n);
    m.seg[0] = seg(w, nullptr, y, nullptr, d, d, scale);
    return (int)launch_mmw<0>(fmt, m, static_cast<const int*>(plan), st);
  }
  if (B >= 2) {
    if (!plan) return (int)cudaErrorInvalidValue;
    const int* p = static_cast<const int*>(plan);
    uint4* xs4 = static_cast<uint4*>(xs);
    float* scf = static_cast<float*>(sc);
    cudaError_t e = launch_split(x, xs4, scf, 8 * p[1], B, n, st);
    if (e != cudaSuccess) return (int)e;
    MArgs m = margs(xs4, scf, B, n);
    m.seg[0] = seg(w, nullptr, y, nullptr, d, d, scale);
    return (int)launch_mmv<0>(fmt, m, p, st);
  }
  if (fmt == 2) return (int)cudaErrorInvalidValue;
  Args a = args(x, B, n);
  a.seg[0] = seg(w, nullptr, y, nullptr, d, d, scale);
  if (fmt == 3) return (int)launch<3, 0>(a, st);
  return (int)launch_fmt<0>(fmt, a, nullptr, st);
}

// One layer's epilogue (see pallas_qmm._qx_offn_qkv_kernel), for fp16
// (fmt 0), fp8 e5m2 (1) or gf4 words (2). Weight pointers are at their
// layer planes (wq/wk/wv and anx already at
// min(layer + 1, L - 1)). r1 (B, D), xn (B, D) and h (B, H) are
// caller-allocated scratch; qkv is (B, Qd + 2 KVd) with q, k and v side by
// side. B >= 2 takes the multi-row path with the staging scratch xs/sc and
// qmv_plan's four plans (xn unused); B = 1 the loop of one row (xs and sc
// unused), gf4 on gf4_row_kernel with gf4_row_plan's four plans (fp16/fp8:
// plans unused).
int calm_qx_offn_qkv(const void* a, const void* r, const void* g,
                     const void* anx, const void* wo, const void* w1,
                     const void* w3, const void* w2, const void* wq,
                     const void* wk, const void* wv, void* r1, void* xn,
                     void* h, void* x, void* qkv, int B, int D, int H, int Qd,
                     int KVd, int fmt, int act_gelu, float eps, int sub_mean,
                     void* xs, void* sc, const void* plans, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B >= 2)
    return (int)qx_offn_qkv_mr(fmt, a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, r1, h, x,
                               qkv, B, D, H, Qd, KVd, act_gelu, eps, sub_mean,
                               static_cast<uint4*>(xs), static_cast<float*>(sc),
                               static_cast<const int*>(plans), st);
  // x = r1 + ffn(ffn-norm(r1)), r1 = r + a . wo^T
  const int* p = static_cast<const int*>(plans);
  cudaError_t e = offn(fmt, a, r, g, wo, w1, w3, w2, r1, xn, h, x, r1, B, D, H,
                       Qd, act_gelu, eps, sub_mean, p, st);
  if (e != cudaSuccess) return (int)e;

  // q/k/v of the next layer from xn = attn-norm(x)
  if ((e = launch_norm(x, anx, xn, B, D, eps, sub_mean, st)) != cudaSuccess)
    return (int)e;
  Args s4 = args(xn, B, D);
  const int ld = Qd + 2 * KVd;
  float* o = static_cast<float*>(qkv);
  s4.seg[0] = seg(wq, nullptr, o, nullptr, Qd, ld);
  s4.seg[1] = seg(wk, nullptr, o + Qd, nullptr, KVd, ld);
  s4.seg[2] = seg(wv, nullptr, o + Qd + KVd, nullptr, KVd, ld);
  s4.nseg = 3;
  return (int)launch_fmt<0>(fmt, s4, p ? p + 3 * G1_PLAN : nullptr, st);
}

// K6: out (B, D) = w2 . (act(w1 . x) * (w3 . x)) on natural gf4 words at
// the layer's planes: w1/w3 (H, D/8), w2 (D, H/8); h (B, H) scratch. B >= 2
// takes the multi-row path (x staged by split_kernel, then ffn_staged) with
// the staging scratch xs/sc and qmv_plan's plans of w1/w3 and w2; B = 1
// gf4_row_kernel with gf4_row_plan's plans of w1/w3 and w2 (xs, sc unused).
int calm_gf4_ffn(const void* x, const void* w1, const void* w3, const void* w2,
                 void* h, void* out, int B, int D, int H, int act_gelu, void* xs,
                 void* sc, const void* plans, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B >= 2) {
    const int* p = static_cast<const int*>(plans);
    uint4* xs4 = static_cast<uint4*>(xs);
    float* scf = static_cast<float*>(sc);
    cudaError_t e = launch_split(x, xs4, scf, 8 * p[1], B, D, st);
    if (e != cudaSuccess) return (int)e;
    return (int)ffn_staged(2, w1, w3, w2, h, out, nullptr, B, D, H, act_gelu, xs4, scf, p,
                           st);
  }
  return (int)ffn(2, x, w1, w3, w2, h, out, nullptr, B, D, H, act_gelu,
                  static_cast<const int*>(plans), st);
}

// K7: r1 (B, D) = r + a . wo^T and ffn (B, D) = the FFN of ffn-norm(r1),
// apart, on natural gf4 words at the layer's planes (wo (D, Qd/8)); g is
// the layer's ffn-norm row; h (B, H) scratch. B >= 2 takes the multi-row
// path (offn_mr, with no residual in the w2 launch) with the staging
// scratch xs/sc and qmv_plan's plans of wo, w1/w3 and w2 (xn unused); B = 1
// gf4_row_kernel with xn (B, D) scratch and gf4_row_plan's plans of wo,
// w1/w3 and w2 (xs, sc unused).
int calm_gf4_offn(const void* a, const void* r, const void* g, const void* wo,
                  const void* w1, const void* w3, const void* w2, void* r1,
                  void* xn, void* h, void* ffn_out, int B, int D, int H, int Qd,
                  int act_gelu, float eps, int sub_mean, void* xs, void* sc,
                  const void* plans, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B >= 2)
    return (int)offn_mr(2, a, r, g, wo, w1, w3, w2, r1, h, ffn_out, nullptr, B, D, H, Qd,
                        act_gelu, eps, sub_mean, static_cast<uint4*>(xs),
                        static_cast<float*>(sc), static_cast<const int*>(plans), st);
  return (int)offn(2, a, r, g, wo, w1, w3, w2, r1, xn, h, ffn_out, nullptr, B, D, H, Qd,
                   act_gelu, eps, sub_mean, static_cast<const int*>(plans), st);
}

// K10 at 2-64 rows: y (A, B, d) f32 = x[min(a, Ax-1)] (B, n) . W[eidx[a]]^T
// for the A expert slots, on the multi-row path; w points at the layer's
// plane (E, d, n) fp16 (fmt 0), fp8 e5m2 (1) or e4m3 (3, times scale[eidx[a]]:
// scale points at the layer's (E,) scales on the device; null for the
// other formats), or (E, d, n/8) gf4 words
// (2); eidx (A,) and cnt (1,) int32 on the device, Ax 1 (x shared) or A;
// n a multiple of 16 (gf4: of 8). x staged into xs/sc (caller-allocated,
// Ax stagings of qmv_plan's size), then plan's launch (qmv_plan with
// slots = A) of A slots; slots a >= cnt write zeros and read no weight.
// 17-64 rows take the wide path (x staged with one scale a row, `terms`
// f16 terms: 1, or 2 under --precise; unused below 17 rows). One row takes
// moe.cu's calm_moe_dense.
int calm_moe_mmv(const void* x, const void* w, void* y, const void* eidx, const void* cnt,
                 int Ax, int A, int B, int d, int n, int E, int fmt, const void* scale,
                 void* xs, void* sc, const void* plan, int terms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((fmt == 3) != (scale != nullptr)) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(plan);
  if (Ax != 1 && Ax != A) return (int)cudaErrorInvalidValue;
  if (B > 16 && wide_tma(fmt, n, terms)) {  // the wide path on TMA
    float* scf = static_cast<float*>(sc);
    cudaError_t e = launch_stage_wide(x, xs, scf, B, n, st, Ax);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_wide(fmt, w, nullptr, scale, nullptr, y, d, d,
                            static_cast<const __half*>(xs), scf, B, n, 0, p, st, eidx, cnt, E,
                            A, Ax, (size_t)B * d);
  }
  if (B > 16) {  // the wide path of --precise, and of gf4 rows TMA cannot read
    const size_t xslot = terms * wide_frags(n);
    cudaError_t e = launch_split_rows(x, static_cast<uint2*>(xs), static_cast<float*>(sc),
                                      B, n, terms, st, Ax, xslot, WIDE_SCALES);
    if (e != cudaSuccess) return (int)e;
    MArgs m = margs(static_cast<const uint4*>(xs), static_cast<float*>(sc), B, n);
    m.terms = terms;
    m.lo = wide_frags(n);
    m.seg[0] = seg(w, nullptr, y, nullptr, d, d, scale);
    moe_slots(m, eidx, cnt, E, (size_t)d * row_bytes(fmt, n), Ax > 1 ? xslot : 0,
              Ax > 1 ? WIDE_SCALES : 0, (size_t)B * d);
    return (int)launch_mmw<0, true>(fmt, m, p, st, A);
  }
  const int ns = 8 * p[1];
  uint4* xs4 = static_cast<uint4*>(xs);
  float* scf = static_cast<float*>(sc);
  const size_t xslot = staged_frags(n, ns), scslot = staged_scales(n, ns);
  cudaError_t e = launch_split(x, xs4, scf, ns, B, n, st, Ax, xslot, scslot);
  if (e != cudaSuccess) return (int)e;
  MArgs m = margs(xs4, scf, B, n);
  m.seg[0] = seg(w, nullptr, y, nullptr, d, d, scale);
  moe_slots(m, eidx, cnt, E, (size_t)d * row_bytes(fmt, n), Ax > 1 ? xslot : 0,
            Ax > 1 ? scslot : 0, (size_t)B * d);
  return (int)launch_mmv<0, true>(fmt, m, p, st, A);
}

// The expert FFN at 2-64 rows: z (A, B, D) f32, z[a] = (act(x W1[e]^T) *
// (x W3[e]^T)) W2[e]^T with e = eidx[a], for x (B, D) f32; w1/w3 point at
// the layer's planes (E, H, D) and w2 at (E, D, H), fp16 (fmt 0), fp8 e5m2
// (1), fp8 e4m3 (3) or gf4 words (2, n/8 words a row); s1, s3, s2: for e4m3
// the layer's (E,) scales of w1, w3 and w2 on the device (w1's and w3's
// applied before the activation), else null; h (A, B, H) f32 scratch. Four
// launches: x staged once, the dual w1/w3 launch of every slot into h, h
// staged slot by slot, the w2 launch into z; slots a >= cnt give zeros.
// plans: qmv_plan's (slots = A) of w1/w3 and w2; xs/sc hold A stagings of
// H values. 17-64 rows take the same four launches on the wide path
// (stage_wide_kernel and wide_kernel; under --precise, `terms` 2, and for
// gf4 rows of n % 32 != 0 split_rows_kernel and mmw_kernel: each product by
// its own k; `terms` unused below 17 rows).
int calm_moe_ffn(const void* x, const void* w1, const void* w3, const void* w2,
                 const void* eidx, const void* cnt, void* h, void* z, int A, int B, int D,
                 int H, int E, int fmt, int act_gelu, const void* s1, const void* s3,
                 const void* s2, void* xs, void* sc, const void* plans, int terms,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool e4 = fmt == 3;
  if (e4 != (s1 != nullptr) || e4 != (s3 != nullptr) || e4 != (s2 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(plans);
  if (B > 16) {  // the wide path: x staged once, h a slot at a time; each product on
                 // wide_kernel where its k allows, else mmw_kernel
    float* scf = static_cast<float*>(sc);
    cudaError_t e;
    if (wide_tma(fmt, D, terms)) {
      if ((e = launch_stage_wide(x, xs, scf, B, D, st)) != cudaSuccess) return (int)e;
      e = launch_wide(fmt, w1, w3, s1, s3, h, H, H, static_cast<const __half*>(xs), scf, B, D,
                      act_gelu ? 2 : 1, p, st, eidx, cnt, E, A, 1, (size_t)B * H);
    } else {
      uint2* xs2 = static_cast<uint2*>(xs);
      if ((e = launch_split_rows(x, xs2, scf, B, D, terms, st)) != cudaSuccess) return (int)e;
      MArgs m = margs(static_cast<const uint4*>(xs), scf, B, D);
      m.terms = terms;
      m.lo = wide_frags(D);
      m.seg[0] = seg(w1, w3, h, nullptr, H, H, s1, s3);
      moe_slots(m, eidx, cnt, E, (size_t)H * row_bytes(fmt, D), 0, 0, (size_t)B * H);
      e = act_gelu ? launch_mmw<2, true>(fmt, m, p, st, A) : launch_mmw<1, true>(fmt, m, p, st, A);
    }
    if (e != cudaSuccess) return (int)e;
    if (wide_tma(fmt, H, terms)) {
      if ((e = launch_stage_wide(h, xs, scf, B, H, st, A)) != cudaSuccess) return (int)e;
      return (int)launch_wide(fmt, w2, nullptr, s2, nullptr, z, D, D,
                              static_cast<const __half*>(xs), scf, B, H, 0, p + 4, st, eidx, cnt,
                              E, A, A, (size_t)B * D);
    }
    uint2* xs2 = static_cast<uint2*>(xs);
    const size_t xslot = terms * wide_frags(H);
    if ((e = launch_split_rows(h, xs2, scf, B, H, terms, st, A, xslot, WIDE_SCALES)) !=
        cudaSuccess)
      return (int)e;
    MArgs m = margs(static_cast<const uint4*>(xs), scf, B, H);
    m.terms = terms;
    m.lo = wide_frags(H);
    m.seg[0] = seg(w2, nullptr, z, nullptr, D, D, s2);
    moe_slots(m, eidx, cnt, E, (size_t)D * row_bytes(fmt, H), xslot, WIDE_SCALES,
              (size_t)B * D);
    return (int)launch_mmw<0, true>(fmt, m, p + 4, st, A);
  }
  const int ns = 8 * p[1];
  uint4* xs4 = static_cast<uint4*>(xs);
  float* scf = static_cast<float*>(sc);
  cudaError_t e = launch_split(x, xs4, scf, ns, B, D, st);
  if (e != cudaSuccess) return (int)e;
  MArgs m = margs(xs4, scf, B, D);
  m.seg[0] = seg(w1, w3, h, nullptr, H, H, s1, s3);
  moe_slots(m, eidx, cnt, E, (size_t)H * row_bytes(fmt, D), 0, 0, (size_t)B * H);
  e = act_gelu ? launch_mmv<2, true>(fmt, m, p, st, A) : launch_mmv<1, true>(fmt, m, p, st, A);
  if (e != cudaSuccess) return (int)e;
  const size_t xslot = staged_frags(H, ns), scslot = staged_scales(H, ns);
  if ((e = launch_split(h, xs4, scf, ns, B, H, st, A, xslot, scslot)) != cudaSuccess)
    return (int)e;
  m = margs(xs4, scf, B, H);
  m.seg[0] = seg(w2, nullptr, z, nullptr, D, D, s2);
  moe_slots(m, eidx, cnt, E, (size_t)D * row_bytes(fmt, H), xslot, scslot, (size_t)B * D);
  return (int)launch_mmv<0, true>(fmt, m, p + 4, st, A);
}

// the dynamic shared memory one wide_kernel block of format fmt and width
// (32, 40 or 64 rows of x) asks for (for reports); -1 for none
int calm_wide_smem(int fmt, int width) {
  const int i = width == 32 ? 0 : width == 40 ? 1 : width == 64 ? 2 : -1;
  if (i < 0 || fmt < 0 || fmt > 3) return -1;
  const int smem[4][3] = {{WT<0, 32>::SMEM, WT<0, 40>::SMEM, WT<0, 64>::SMEM},
                          {WT<1, 32>::SMEM, WT<1, 40>::SMEM, WT<1, 64>::SMEM},
                          {WT<2, 32>::SMEM, WT<2, 40>::SMEM, WT<2, 64>::SMEM},
                          {WT<3, 32>::SMEM, WT<3, 40>::SMEM, WT<3, 64>::SMEM}};
  return smem[fmt][i];
}

const char* calm_qmm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
