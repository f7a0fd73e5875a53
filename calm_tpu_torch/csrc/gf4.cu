// gf4 products over layer-stacked natural gf4 words (L, d, n/8) int32.
//
// A gf4 word packs eight weights: an e5m2 scale byte in bits 0-7 and eight
// 3-bit codes at bits 8 + 3k; value_k = (code_k - 4) * e5m2(w & 0xff) / -4
// (calm_tpu/ops/qmm.py:82-94). The words are read in their natural order:
// the plane-permuted activations of the TPU kernels exist only for Mosaic.
//
// Replaces three Pallas kernels of calm_tpu/ops/pallas_qmm.py:
//   - _layered_gf4_kernel (:100, via qmm_decode :219): y (B <= 16, d) =
//     x . W[layer]^T -> calm_gf4_matvec below (K3) at one row; 2-16 rows,
//     the quality mode's too, take qmm.cu's multi-row path (calm_qmm_decode
//     with fmt 2);
//   - _gf4_mm_kernel (:238, via qmm_prefill :335): the same product for
//     R >= 32 rows, x in bf16 -> calm_gf4_matmul below (K4);
//   - _gf4_mmt_kernel (:346, via qmm_prefill_t :416): the FFN's w2
//     product at prefill, which the TPU reads from word-transposed words
//     so Mosaic needs no in-kernel transpose. On natural words it is the
//     K4 product, and calm_gf4_matmul serves it too (K5).
//
// K3 at one row, what bounds it on an H100: the weight bytes (half a byte
// per weight, 2 flops each), and close behind them the decode: four integer
// and float instructions per weight (shift, or into the mantissa of 2^23,
// one subtract, one FMA) against 3.35 TB/s of words is ~27 T thread-ops/s,
// near the card's ~30. Design: a warp owns four output rows and walks their
// words together, so each float4 pair of x it loads serves four rows (x
// traffic twice the weight bytes instead of eight times); each lane keeps
// 4 words of each row (64 bytes) in flight; the code-to-float step is
// exact and needs no int-to-float conversion (those issue at 1/4 rate).
//
// K4, what bounds it: the tensor cores, 2 R d n flops (at R = 2048 the
// words are read once per 128-row block of x, a small share of the time).
// Design, one 128 x 128 output tile a block of two warpgroups, 64-deep k
// tiles in a ring of MM_STAGES stages:
// - x arrives as bf16 (the wrapper or the model rounds it once, as JAX
//   casts x before its pallas_call, pallas_qmm.py:303, :384) and reaches
//   shared memory by TMA in the 128-byte swizzle, one thread issuing the
//   load of each stage onto its mbarrier; rows past R and columns past n
//   arrive as zeros.
// - Each k tile's W words (128 rows x 8 words) are decoded ONCE, by all
//   256 threads, into a bf16 tile in the same swizzle (exact: (code - 4) *
//   scale has <= 5 significant bits; the codes go under the mantissa of
//   128 and one bf16x2 subtract and multiply finish a pair) and serve the
//   block's 128 rows of x: the TPU kernel's decode-once idea
//   (pallas_qmm.py:238-258). Words past d or n8 decode to zeros.
// - wgmma m64n128k16 (bf16, f32 accumulate) reads both tiles from shared
//   memory, each warpgroup 64 rows of x. One product stays in flight while
//   the threads decode the tile MM_STAGES - 1 ahead into the stage the
//   last product freed; the next words wait in registers.
// - Row blocks run fastest in the grid, so the blocks that share a W tile
//   run together and read it from L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float gf4_scale(uint32_t w) {
  // the e5m2 byte in the high half of an f16 is the same value, exactly
  return __half2float(__ushort_as_half((unsigned short)((w & 0xffu) << 8))) * -0.25f;
}

// code_k - 4, exactly: the 3-bit field under the mantissa of 2^23
__device__ __forceinline__ float gf4_code(uint32_t w, int k) {
  return __uint_as_float(0x4B000000u | ((w >> (8 + 3 * k)) & 7u)) - 8388612.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// K3: matvec, one row of x (2-16 rows: calm_qmm_decode in qmm.cu)
// ---------------------------------------------------------------------------

#define MV_WARPS 4
#define MV_ROWS 4  // output rows per warp
#define MV_U 4     // words in flight per lane and row

// One row of x (B = 1; 2-16 rows, --precise too, take qmm.cu's mmv_kernel).
__global__ void __launch_bounds__(MV_WARPS * 32)
    gf4_mv_kernel(const float* __restrict__ x, const uint32_t* __restrict__ w,
                  float* __restrict__ y, int d, int n8) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * MV_WARPS + warp) * MV_ROWS;
  if (row0 >= d) return;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const uint32_t* wr[MV_ROWS];
#pragma unroll
  for (int r = 0; r < MV_ROWS; r++)  // rows past d re-read row d-1, unused
    wr[r] = w + (size_t)min(row0 + r, d - 1) * n8;
  float acc[MV_ROWS];
#pragma unroll
  for (int r = 0; r < MV_ROWS; r++) acc[r] = 0.f;

  for (int c0 = lane; c0 < n8; c0 += 32 * MV_U) {
    uint32_t q[MV_U][MV_ROWS];
#pragma unroll
    for (int u = 0; u < MV_U; u++) {
      const int c = c0 + u * 32;
#pragma unroll
      for (int r = 0; r < MV_ROWS; r++) q[u][r] = c < n8 ? __ldcs(wr[r] + c) : 0u;
    }
#pragma unroll
    for (int u = 0; u < MV_U; u++) {
      const int c = c0 + u * 32;
      if (c >= n8) break;
      const float4 xa = __ldg(x4 + 2 * c), xb = __ldg(x4 + 2 * c + 1);
#pragma unroll
      for (int r = 0; r < MV_ROWS; r++) {
        const uint32_t v = q[u][r];
        float s = gf4_code(v, 0) * xa.x;
        s = fmaf(gf4_code(v, 1), xa.y, s);
        s = fmaf(gf4_code(v, 2), xa.z, s);
        s = fmaf(gf4_code(v, 3), xa.w, s);
        s = fmaf(gf4_code(v, 4), xb.x, s);
        s = fmaf(gf4_code(v, 5), xb.y, s);
        s = fmaf(gf4_code(v, 6), xb.z, s);
        s = fmaf(gf4_code(v, 7), xb.w, s);
        acc[r] = fmaf(s, gf4_scale(v), acc[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < MV_ROWS; r++) {
    const float s = warp_sum(acc[r]);
    if (lane == 0 && row0 + r < d) y[row0 + r] = s;
  }
}

// ---------------------------------------------------------------------------
// K4: matmul, R >= 32 rows of x, wgmma on the tensor cores
// ---------------------------------------------------------------------------

#define MM_BM 128       // rows of x a block: two consumer warpgroups of 64
#define MM_BN 128       // output columns (rows of W) a block
#define MM_BK 64        // k a tile: 128 bytes of bf16, eight gf4 words of a W row
#define MM_STAGES 3     // ring of (x, decoded W) tiles
#define MM_THREADS 256
#define MM_TILE (MM_BM * MM_BK * 2)  // bytes of one x (or W) tile: 16 KB
#define MM_STAGE (2 * MM_TILE)
#define MM_SMEM (MM_STAGES * MM_STAGE + 1024 + 64)  // + alignment, barriers

// one gf4 word -> its eight weights in bf16, exactly: the codes go under the
// mantissa of 128 (bf16 0x4300 | code = 128 + code), 132 comes off (code
// - 4, exact), and one multiply by the scale (<= 5 significant bits, exact)
__device__ __forceinline__ uint4 gf4_bf16x8(uint32_t w) {
  const __nv_bfloat16 s = __float2bfloat16(gf4_scale(w));
  const __nv_bfloat162 sc2 = __halves2bfloat162(s, s);
  const uint32_t four = 0x43044304u;  // 132, 132
  const uint32_t a = w >> 8;
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const uint32_t t = a >> (6 * k);
    const uint32_t v = (t & 7u) | ((t << 13) & 0x70000u) | 0x43004300u;
    __nv_bfloat162 x = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                               *reinterpret_cast<const __nv_bfloat162*>(&four));
    x = __hmul2(x, sc2);
    o[k] = *reinterpret_cast<const uint32_t*>(&x);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(MM_THREADS, 2)
    gf4_mm_kernel(const __grid_constant__ CUtensorMap xmap, const uint32_t* __restrict__ w,
                  float* __restrict__ y, int R, int d, int n8) {
  extern __shared__ unsigned char mm_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(mm_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + MM_STAGES * MM_STAGE);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * MM_BM, n0 = blockIdx.y * MM_BN;
  const int nk = (n8 + 7) / 8;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < MM_STAGES; s++) mbar_init(bar + s, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the W role of every thread: half a k tile (four words) of row wr
  const int wr = tid >> 1, wh = tid & 1;
  const bool wrow = n0 + wr < d;
  const uint32_t* wp = w + (size_t)min(n0 + wr, d - 1) * n8;
  const bool wvec = (n8 & 3) == 0;
  uint32_t wv[4];
  auto wload = [&](int kt) {
    const int c = kt * 8 + wh * 4;
    if (wrow && wvec && c + 4 <= n8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(wp + c));
      wv[0] = u.x; wv[1] = u.y; wv[2] = u.z; wv[3] = u.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; i++) wv[i] = (wrow && c + i < n8) ? __ldg(wp + c + i) : 0u;
    }
  };
  auto wstore = [&](int kt) {  // decoded into the 128-byte swizzle TMA gives x
    unsigned char* row = sm + (kt % MM_STAGES) * MM_STAGE + MM_TILE + wr * 128;
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int j = wh * 4 + i;
      *reinterpret_cast<uint4*>(row + ((j ^ (wr & 7)) << 4)) = gf4_bf16x8(wv[i]);
    }
  };
  auto xload = [&](int kt) {
    if (tid == 0) {
      uint64_t* b = bar + kt % MM_STAGES;
      mbar_expect_tx(b, MM_TILE);
      tma_load(sm + (kt % MM_STAGES) * MM_STAGE, &xmap, b, kt * MM_BK, m0);
    }
  };

#pragma unroll
  for (int i = 0; i < MM_STAGES - 1; i++) {
    if (i < nk) {
      xload(i);
      wload(i);
      wstore(i);
    }
  }
  if (MM_STAGES - 1 < nk) wload(MM_STAGES - 1);
  fence_proxy_async();
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; i++) acc[i] = 0.f;
  for (int kt = 0; kt < nk; kt++) {
    const int s = kt % MM_STAGES;
    mbar_wait(bar + s, (kt / MM_STAGES) & 1);
    const uint64_t da = wgmma_desc(sm + s * MM_STAGE + wg * (64 * 128));
    const uint64_t db = wgmma_desc(sm + s * MM_STAGE + MM_TILE);
    fence_acc<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < MM_BK / 16; k++) wgmma_ss128(acc, da + 2 * k, db + 2 * k, 1);
    wgmma_commit();
    fence_acc<64>(acc);
    wgmma_wait<1>();  // this warpgroup's product of tile kt - 1 is done
    __syncthreads();  // both are: its stage takes tile kt + MM_STAGES - 1
    const int kn = kt + MM_STAGES - 1;
    if (kn < nk) {
      xload(kn);
      wstore(kn);
      fence_proxy_async();
      if (kn + 1 < nk) wload(kn + 1);
    }
  }
  wgmma_wait<0>();
  fence_acc<64>(acc);

  // register i of a thread: row 16 warp + lane / 4 + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's 64 x 128 tile
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const bool vec = (d & 1) == 0;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int c = n0 + 8 * (i >> 2) + 2 * (lane & 3);
    if (r >= R) continue;
    float* o = y + (size_t)r * d + c;
    if (vec && c + 1 < d) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
    } else {
      if (c < d) o[0] = acc[i];
      if (c + 1 < d) o[1] = acc[i + 1];
    }
  }
}

}  // namespace

extern "C" {

// y (1, d) f32 = x (1, n) f32 . W^T, W (d, n/8) gf4 words at the layer's
// plane; x 16-byte aligned. B must be 1: 2-16 rows, the quality mode's
// too, take qmm.cu's multi-row path (calm_qmm_decode); B >= 2 returns
// cudaErrorInvalidValue.
int calm_gf4_matvec(const void* x, const void* w, void* y, int B, int d, int n8,
                    void* stream) {
  if (B != 1) return (int)cudaErrorInvalidValue;
  const int grid = (d + MV_WARPS * MV_ROWS - 1) / (MV_WARPS * MV_ROWS);
  gf4_mv_kernel<<<grid, MV_WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(w), static_cast<float*>(y),
      d, n8);
  return (int)cudaGetLastError();
}

// y (R, d) f32 = x (R, n) bf16 . W^T, W (d, n/8) gf4 words at the layer's
// plane; x contiguous and 16-byte aligned, n = 8 n8 a multiple of 8; f32
// sums.
int calm_gf4_matmul(const void* x, const void* w, void* y, int R, int d, int n8,
                    void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gf4_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)8 * n8, (cuuint64_t)R};
  const cuuint64_t strides[1] = {(cuuint64_t)16 * n8};  // bytes a row of x
  const cuuint32_t box[2] = {MM_BK, MM_BM};
  const cuuint32_t estr[2] = {1, 1};
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
          estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // row blocks fastest: the blocks that share a W tile run together
  dim3 grid((R + MM_BM - 1) / MM_BM, (d + MM_BN - 1) / MM_BN);
  gf4_mm_kernel<<<grid, MM_THREADS, MM_SMEM, (cudaStream_t)stream>>>(
      map, static_cast<const uint32_t*>(w), static_cast<float*>(y), R, d, n8);
  return (int)cudaGetLastError();
}

// the dynamic shared memory one matmul block asks for (for reports)
int calm_gf4_mm_smem() { return MM_SMEM; }

const char* calm_gf4_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
