// gf4 products over layer-stacked natural gf4 words (L, d, n/8) int32.
//
// A gf4 word packs eight weights: an e5m2 scale byte in bits 0-7 and eight
// 3-bit codes at bits 8 + 3k; value_k = (code_k - 4) * e5m2(w & 0xff) / -4
// (calm_tpu/ops/qmm.py:82-94). The words are read in their natural order:
// the plane-permuted activations of the TPU kernels exist only for Mosaic.
//
// Replaces three Pallas kernels of calm_tpu/ops/pallas_qmm.py:
//   - _layered_gf4_kernel (:100, via qmm_decode :219): y (B <= 16, d) =
//     x . W[layer]^T -> calm_gf4_matvec below (K3);
//   - _gf4_mm_kernel (:238, via qmm_prefill :335): the same product for
//     R >= 32 rows, x in bf16 -> calm_gf4_matmul below (K4);
//   - _gf4_mmt_kernel (:346, via qmm_prefill_t :416): the FFN's w2
//     product at prefill, which the TPU reads from word-transposed words
//     so Mosaic needs no in-kernel transpose. On natural words it is the
//     K4 product, and calm_gf4_matmul serves it too (K5).
//
// K3, what bounds it on an H100: the weight bytes (half a byte per weight,
// 2 flops each at B=1), and close behind them the decode: four integer and
// float instructions per weight (shift, or into the mantissa of 2^23, one
// subtract, one FMA) against 3.35 TB/s of words is ~27 T thread-ops/s, near
// the card's ~30. Design: a warp owns four output rows and walks their
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
// K3: matvec, B <= 16 rows of x
// ---------------------------------------------------------------------------

#define MV_WARPS 4
#define MV_ROWS 4  // output rows per warp
#define MV_U 4     // words in flight per lane and row

// NB: compile-time bound on B (accumulator registers)
template <int NB>
__global__ void __launch_bounds__(MV_WARPS * 32)
    gf4_mv_kernel(const float* __restrict__ x, const uint32_t* __restrict__ w,
                  float* __restrict__ y, int B, int d, int n8) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * MV_WARPS + warp) * MV_ROWS;
  if (row0 >= d) return;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const int n4 = 2 * n8;  // float4s per row of x
  const uint32_t* wr[MV_ROWS];
#pragma unroll
  for (int r = 0; r < MV_ROWS; r++)  // rows past d re-read row d-1, unused
    wr[r] = w + (size_t)min(row0 + r, d - 1) * n8;
  float acc[MV_ROWS][NB];
#pragma unroll
  for (int r = 0; r < MV_ROWS; r++)
#pragma unroll
    for (int b = 0; b < NB; b++) acc[r][b] = 0.f;

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
      if (NB == 1) {
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
          acc[r][0] = fmaf(s, gf4_scale(v), acc[r][0]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < MV_ROWS; r++) {
          const uint32_t v = q[u][r];
          float cv[8];
#pragma unroll
          for (int k = 0; k < 8; k++) cv[k] = gf4_code(v, k);
          const float sc = gf4_scale(v);
#pragma unroll
          for (int b = 0; b < NB; b++) {
            if (b < B) {
              const float4 xa = __ldg(x4 + (size_t)b * n4 + 2 * c);
              const float4 xb = __ldg(x4 + (size_t)b * n4 + 2 * c + 1);
              float s = cv[0] * xa.x;
              s = fmaf(cv[1], xa.y, s);
              s = fmaf(cv[2], xa.z, s);
              s = fmaf(cv[3], xa.w, s);
              s = fmaf(cv[4], xb.x, s);
              s = fmaf(cv[5], xb.y, s);
              s = fmaf(cv[6], xb.z, s);
              s = fmaf(cv[7], xb.w, s);
              acc[r][b] = fmaf(s, sc, acc[r][b]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < MV_ROWS; r++) {
#pragma unroll
    for (int b = 0; b < NB; b++) {
      if (b < B) {
        const float s = warp_sum(acc[r][b]);
        if (lane == 0 && row0 + r < d) y[(size_t)b * d + row0 + r] = s;
      }
    }
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// waits for the phase of this parity; a load that never lands traps (a
// launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (uint32_t i = 0; !mbar_try(bar, parity); i++)
    if (i == (1u << 24)) __trap();
}

// a 2-D TMA load of box (64 k, 128 rows) at (k0, r0) into dst; out-of-bounds
// elements arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int k0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(r0)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (8-row groups 1024 bytes apart), 1024-byte aligned
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the accumulators in their registers across the asynchronous products
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; i++) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32 across the warpgroup) += A (64 x 16) . B (128 x 16)^T,
// both bf16 in shared memory, K-major
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < MM_BK / 16; k++) wgmma_128(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    fence_acc(acc);
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
  fence_acc(acc);

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

// cuTensorMapEncodeTiled from the driver, without linking libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

}  // namespace

extern "C" {

// y (B, d) f32 = x (B, n) f32 . W^T, W (d, n/8) gf4 words at the layer's
// plane; 1 <= B <= 16; x 16-byte aligned.
int calm_gf4_matvec(const void* x, const void* w, void* y, int B, int d, int n8,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = (d + MV_WARPS * MV_ROWS - 1) / (MV_WARPS * MV_ROWS);
  const float* xf = static_cast<const float*>(x);
  const uint32_t* wu = static_cast<const uint32_t*>(w);
  float* yf = static_cast<float*>(y);
  if (B <= 1)
    gf4_mv_kernel<1><<<grid, MV_WARPS * 32, 0, st>>>(xf, wu, yf, B, d, n8);
  else if (B <= 4)
    gf4_mv_kernel<4><<<grid, MV_WARPS * 32, 0, st>>>(xf, wu, yf, B, d, n8);
  else
    gf4_mv_kernel<16><<<grid, MV_WARPS * 32, 0, st>>>(xf, wu, yf, B, d, n8);
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
