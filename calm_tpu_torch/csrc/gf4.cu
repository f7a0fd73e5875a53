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
//     R >= 32 rows -> calm_gf4_matmul below (K4);
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
// K4, what bounds it: the tensor cores (2 R d n flops; at R = 2048 the
// weights are read once per 128-row block and are a small share of the
// time). Design: a 128 x 128 output tile per block of eight warps, 32-deep
// k tiles. Each k tile's W words (128 rows x 4 words) are decoded ONCE
// into shared memory as bf16 (exact: (code - 4) * scale has <= 5
// significant bits) and serve all 128 rows of x in the block, the TPU
// kernel's decode-once idea at the size of one block. x is rounded once to
// bf16 as it is staged, as the TPU kernel rounds it (pallas_qmm.py:303).
// mma.sync m16n8k16 bf16 with f32 sums, two shared buffers, the next
// tile's global loads in registers while the current one is multiplied.
// Both edges (rows R, columns d) and a k tail (n/8 not a multiple of 4,
// e.g. 11008/8 = 1376 words is, 1000/8 = 125 is not) are masked.

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
// K4: matmul, R >= 32 rows of x, bf16 tensor cores
// ---------------------------------------------------------------------------

#define MM_BM 128
#define MM_BN 128
#define MM_BK 32              // k per tile: four words of each W row
#define MM_LD (MM_BK + 8)     // bf16 per shared row: 80 bytes, no bank conflicts
#define MM_THREADS 256
#define MM_TILE (MM_BM * MM_LD)  // bf16 per shared tile (BM == BN)
#define MM_SMEM (4 * MM_TILE * 2)  // x, W; two buffers each: 40960 B

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(MM_THREADS)
    gf4_mm_kernel(const float* __restrict__ x, const uint32_t* __restrict__ w,
                  float* __restrict__ y, int R, int d, int n8) {
  extern __shared__ __align__(16) unsigned char mm_raw[];
  __nv_bfloat16* mm_smem = reinterpret_cast<__nv_bfloat16*>(mm_raw);
  // [buf][row][MM_LD] tiles: x, decoded W
  auto sA = reinterpret_cast<__nv_bfloat16(*)[MM_BM][MM_LD]>(mm_smem);
  auto sB = reinterpret_cast<__nv_bfloat16(*)[MM_BN][MM_LD]>(mm_smem + 2 * MM_TILE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * MM_BN, m0 = blockIdx.y * MM_BM;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // warp tile 64 x 32
  const int n = 8 * n8;
  const int nk = (n8 + 3) / 4;

  float4 xs[4];  // staging: 4 float4 of x and 2 words of W per thread
  uint32_t ws[2];
  auto load = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int idx = tid + i * MM_THREADS, r = idx >> 3, c4 = idx & 7;
      const int gr = m0 + r, gk = kt * MM_BK + c4 * 4;
      xs[i] = (gr < R && gk < n)
                  ? __ldg(reinterpret_cast<const float4*>(x + (size_t)gr * n + gk))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 2; j++) {
      const int idx = tid + j * MM_THREADS, r = idx >> 2, cw = idx & 3;
      const int gn = n0 + r, gw = kt * 4 + cw;
      ws[j] = (gn < d && gw < n8) ? __ldg(w + (size_t)gn * n8 + gw) : 0u;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int idx = tid + i * MM_THREADS, r = idx >> 3, c4 = idx & 7;
      *reinterpret_cast<uint2*>(&sA[buf][r][c4 * 4]) =
          make_uint2(pack_bf16(xs[i].x, xs[i].y), pack_bf16(xs[i].z, xs[i].w));
    }
#pragma unroll
    for (int j = 0; j < 2; j++) {
      const int idx = tid + j * MM_THREADS, r = idx >> 2, cw = idx & 3;
      const uint32_t v = ws[j];
      const float sc = gf4_scale(v);  // a zero word decodes to zeros
      uint4 o;
      o.x = pack_bf16(gf4_code(v, 0) * sc, gf4_code(v, 1) * sc);
      o.y = pack_bf16(gf4_code(v, 2) * sc, gf4_code(v, 3) * sc);
      o.z = pack_bf16(gf4_code(v, 4) * sc, gf4_code(v, 5) * sc);
      o.w = pack_bf16(gf4_code(v, 6) * sc, gf4_code(v, 7) * sc);
      *reinterpret_cast<uint4*>(&sB[buf][r][cw * 8]) = o;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; i++)
#pragma unroll
    for (int j = 0; j < 4; j++)
#pragma unroll
      for (int k = 0; k < 4; k++) acc[i][j][k] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; kt++) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1);  // in flight while this tile multiplies
#pragma unroll
    for (int ks = 0; ks < MM_BK; ks += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; nt++) {
        const int c = wn + nt * 8 + g;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&sB[cur][c][ks + t4 * 2]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&sB[cur][c][ks + t4 * 2 + 8]);
      }
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; mt++) {
        const int r = wm + mt * 16 + g;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&sA[cur][r][ks + t4 * 2]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&sA[cur][r + 8][ks + t4 * 2]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&sA[cur][r][ks + t4 * 2 + 8]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&sA[cur][r + 8][ks + t4 * 2 + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; mt++)
#pragma unroll
        for (int nt = 0; nt < 4; nt++) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    // the other buffer was last read before the previous iteration's sync
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; mt++) {
#pragma unroll
    for (int nt = 0; nt < 4; nt++) {
      const int r = m0 + wm + mt * 16 + g;
      const int c = n0 + wn + nt * 8 + t4 * 2;
#pragma unroll
      for (int h = 0; h < 2; h++) {
        const int rr = r + 8 * h;
        if (rr < R) {
          float* o = y + (size_t)rr * d;
          if (c < d) o[c] = acc[mt][nt][2 * h];
          if (c + 1 < d) o[c + 1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
  }
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

// y (R, d) f32 = x (R, n) f32 . W^T, W (d, n/8) gf4 words at the layer's
// plane; x 16-byte aligned; x rounded to bf16, f32 sums.
int calm_gf4_matmul(const void* x, const void* w, void* y, int R, int d, int n8,
                    void* stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      gf4_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((d + MM_BN - 1) / MM_BN, (R + MM_BM - 1) / MM_BM);
  gf4_mm_kernel<<<grid, MM_THREADS, MM_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(w),
      static_cast<float*>(y), R, d, n8);
  return (int)cudaGetLastError();
}

const char* calm_gf4_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
