// Products past 64 rows of x over fp16 / fp8 e5m2 / fp8 e4m3 weights read in
// their stored bytes: y (R, d) f32 = bf16(x) (R, n) . W^T, W the (d, n) plane
// of a layer-stacked (or expert-stacked) weight; e4m3 times its power-of-two
// scale, read on the device.
//
// Replaces no Pallas kernel: JAX runs these products in XLA
// (calm_tpu/ops/qmm.py:189-205: the plane dequantized to bf16, x cast to
// bf16, one dot with f32 sums; the e4m3 scale multiplies the output). The
// port ran the same through the library: a bf16 copy of every plane written
// to device memory by a second pass, then torch.mm on it. This kernel keeps
// that arithmetic (x rounded once to bf16, the weights widened exactly to
// bf16, fp16 rounded to nearest-even as .to(torch.bfloat16) rounds it, f32
// sums, the scale on the f32 output) and writes no copy: only the order of
// the sums differs.
//
// What bounds it on an H100: 2 R operations a weight byte (fp8; R a fp16
// byte) against the card's ~295 for bf16 tensor cores. A Mixtral expert group
// of 65-300 rows sits at or below that ridge: the weight bytes, read once for
// all of R, bound it. A dense prefill of 900-2048 rows is bound by the tensor
// cores: the widening's cost is spread over a token tile of up to 256 rows.
//
// Design (the wide path's, wide_kernel in qmm.cu, carried past 64 rows):
//   - A block owns 128 output rows (weight rows, the M side: two consumer
//     warpgroups of 64) against one token tile of N rows of x (N = 128, 192
//     or 256, hopper_qmm.mm8_plan's choice from R: one tile covers R up to
//     256, so an expert group reads each weight tile once; past that the
//     split that pads R least) and a k part. The
//     blocks of one weight tile (its token tiles and k parts) are adjacent
//     in the grid, so a tile read for one token tile comes from L2 for the
//     next.
//   - A producer warp keeps TMA loads of 64-value stages in a ring of shared
//     memory (a full and an empty barrier a stage): the block's 128 weight
//     rows in their natural bytes (e5m2/e4m3 64 bytes a row in the 64-byte
//     swizzle, fp16 128 bytes in the 128-byte swizzle) through a 3-D map over
//     (plane, row, k), and x's 64-value box (bf16, N rows, the 128-byte
//     swizzle). Rows past d and past R arrive as zeros (TMA's bounds).
//   - The consumers widen their rows to bf16: e5m2 by byte placement into
//     f16, e4m3 by cvt.rn.f16x2.e4m3x2, then f16 to bf16 exactly (the
//     magnitude shifted under bf16's exponent, times 2^112, subnormals
//     included); fp16 through f32, rounded to nearest even. x keeps its
//     natural k order, so x needs no staging of its own: the bf16 cast that
//     K4 takes too is all (prefill_operand; products that share x share it).
//     Four wgmma m64nNk16 a stage (bf16, f32 sums) against x in shared
//     memory. Where the widening lands depends on N, measured both ways on
//     an H100 (PERF.md): at N = 128 and 192 in registers, as wgmma's A
//     operand (a lane reads its row's values k = 16 s + 2 t, 2 t + 1 and 16 s
//     + 8 + 2 t, 2 t + 9 of step s as two 16-bit loads, fp16 two 32-bit, which
//     the swizzle spreads over distinct banks), the two warpgroups' products
//     covering each other's widening (two sets of A registers, to widen a
//     stage while the last one multiplies, made ptxas serialize the wgmmas,
//     C7513, and timed 3-10% slower): 10-20% faster at the expert groups'
//     128-300 rows, where the bytes bound it; at N = 256 into a bf16 tile a
//     warpgroup in shared memory (128-byte rows in the 128-byte swizzle, two
//     tiles, so a stage's widening overlaps the last stage's products), A
//     read from there: at N = 256 and 1025-2048 rows 4-14% faster than in
//     registers, where the tensor cores bound it and a warpgroup's own
//     products cover its widening (in registers N = 256 also spills).
//   - k split (filling the card): the parts of a tile are the blocks of one
//     cluster, as the wide path's: 8 where a launch has 16 row x token tiles
//     or fewer (k/v up to 512 rows), 2 where that fills the waves of one
//     block an SM better (w2, q and o up to 256 rows and at 1025), as
//     hopper_qmm.mm8_plan picks them from an H100's timings (clusters of 4
//     timed slower than of 2 or 8 everywhere). Each block's sums go through
//     shared memory; each block then adds every part's sums for its share of
//     the tile's tokens, in rank order, through distributed shared memory:
//     no atomics, two identical calls give the same bits.
//   - The epilogue stores four rows of a token a thread (float4), rows
//     fastest, times the e4m3 scale.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

#define MM_K 64         // k values a stage
#define MM_ROWS 128     // weight rows a block: two consumer warpgroups of 64
#define MM_THREADS 288  // the consumers (warps 0-7) and the producer warp (8)
#define MM_RING 225280  // bytes of the ring at most (220 KB): one block an SM
#define MM_MAX_STAGES 8
#define MM_KS 8         // k parts a tile at most: the blocks of a portable cluster
#define MM_EP 68        // floats a token's 64 rows take in the epilogue (+ 4: no bank conflicts)
#define MM_ATILE 8192   // one warpgroup's 64 widened rows of a stage: 64 x 64 bf16

// the widening's place by the token tile: a shared tile at N = 256, else
// registers (see the note at the top)
template <int N>
__host__ __device__ constexpr bool tile_a() {
  return N == 256;
}

template <int FMT, int N, bool TA = tile_a<N>()>
struct MP {
  static constexpr int WB = FMT == 0 ? 128 : 64;  // weight bytes a row a stage
  static constexpr int WTILE = MM_ROWS * WB;      // the block's weights a stage
  static constexpr int XTILE = N * 128;           // N rows of 64 bf16
  static constexpr int STAGE = WTILE + XTILE;
  static constexpr int ABUF = TA ? 4 * MM_ATILE : 0;  // two widened tiles a warpgroup
  static constexpr int RING = MM_RING - ABUF;
  static constexpr int S = RING / STAGE < MM_MAX_STAGES ? RING / STAGE : MM_MAX_STAGES;
  static constexpr int SMEM = S * STAGE + ABUF + 1024;  // + the 1024-byte alignment
  static_assert(S >= 2, "two stages at least");
  static_assert(2 * N * MM_EP * 4 <= S * STAGE, "the sums reuse the ring");
};

struct MmArgs {
  float* y;            // (R, d)
  const float* scale;  // e4m3: the plane's scale on the device; else null
  int R, d;
  int T;       // token tiles
  int ks;      // k parts: the blocks of a cluster
  int stages;  // MM_K-value stages of k
};

// f16x2 -> bf16x2, exact for values of at most 8 significant bits (e5m2, e4m3
// widened to f16): the magnitude shifted down 3 puts f16's exponent and top
// mantissa bits under bf16's (2^-112 of the value, a bf16 subnormal where the
// f16 is one), the sign back in place, one multiply by 2^112
__device__ __forceinline__ uint32_t f16x2_bf16x2(uint32_t h) {
  const uint32_t m = ((h & 0x7fff7fffu) >> 3) | (h & 0x80008000u);
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(m), "r"(0x77807780u));
  return r;
}

// fp16x2 -> bf16x2 rounded to nearest even, as .to(torch.bfloat16)
__device__ __forceinline__ uint32_t fp16x2_bf16x2_rn(uint32_t h) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  const __nv_bfloat162 b = __float22bfloat162_rn(f);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// A fragments of one stage's four steps for this lane's rows `row` and row +
// 8 of the block's 128: af[s] = {row at k 16 s + 2 t (+1), row + 8 there, row
// at 16 s + 8 + 2 t (+1), row + 8 there}, the layout of wgmma's register A
template <int FMT>
__device__ __forceinline__ void mm_frags(uint32_t (&af)[4][4], const uint8_t* wt, int row,
                                         int t) {
#pragma unroll
  for (int s = 0; s < 4; s++) {
#pragma unroll
    for (int h = 0; h < 2; h++) {
#pragma unroll
      for (int r = 0; r < 2; r++) {
        const int rr = row + 8 * r;
        if constexpr (FMT == 0) {  // 128-byte rows, chunk c at c ^ (row % 8)
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              wt + rr * 128 + (((2 * s + h) ^ (rr & 7)) << 4) + 4 * t);
          af[s][r + 2 * h] = fp16x2_bf16x2_rn(v);
        } else {  // 64-byte rows, chunk c at c ^ (row / 2 % 4)
          const unsigned short v = *reinterpret_cast<const unsigned short*>(
              wt + rr * 64 + ((s ^ ((rr >> 1) & 3)) << 4) + 8 * h + 2 * t);
          const uint32_t f = FMT == 1 ? __byte_perm((uint32_t)v, 0u, 0x1404) : e4m3x2_f16x2(v);
          af[s][r + 2 * h] = f16x2_bf16x2(f);
        }
      }
    }
  }
}

// this warpgroup's 64 rows of one stage (thread c: row c / 2, values 32
// (c % 2) .. + 31) widened into a bf16 tile of 128-byte rows in the 128-byte
// swizzle, wgmma's shared A operand
template <int FMT>
__device__ __forceinline__ void mm_widen_tile(uint8_t* at, const uint8_t* wt, int wg, int c) {
  const int r = c >> 1, h = c & 1, tr = 64 * wg + r;  // tr: the row of the block's 128
#pragma unroll
  for (int j = 0; j < 2; j++) {
    if constexpr (FMT == 0) {  // 8 values a chunk, the same chunk in bf16
#pragma unroll
      for (int q = 0; q < 2; q++) {
        const int ch = 4 * h + 2 * j + q;
        const uint4 v = *reinterpret_cast<const uint4*>(wt + tr * 128 + ((ch ^ (tr & 7)) << 4));
        *reinterpret_cast<uint4*>(at + r * 128 + ((ch ^ (r & 7)) << 4)) =
            make_uint4(fp16x2_bf16x2_rn(v.x), fp16x2_bf16x2_rn(v.y), fp16x2_bf16x2_rn(v.z),
                       fp16x2_bf16x2_rn(v.w));
      }
    } else {  // 16 values a chunk: two chunks of bf16
      const int ch = 2 * h + j;
      const uint4 v = *reinterpret_cast<const uint4*>(wt + tr * 64 + ((ch ^ ((tr >> 1) & 3)) << 4));
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[8];
#pragma unroll
      for (int q = 0; q < 4; q++) {
        const uint32_t lo = FMT == 1 ? __byte_perm(w4[q], 0u, 0x1404)
                                     : e4m3x2_f16x2((unsigned short)(w4[q] & 0xffffu));
        const uint32_t hi = FMT == 1 ? __byte_perm(w4[q], 0u, 0x3424)
                                     : e4m3x2_f16x2((unsigned short)(w4[q] >> 16));
        o[2 * q] = f16x2_bf16x2(lo);
        o[2 * q + 1] = f16x2_bf16x2(hi);
      }
      *reinterpret_cast<uint4*>(at + r * 128 + (((2 * ch) ^ (r & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(at + r * 128 + (((2 * ch + 1) ^ (r & 7)) << 4)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
}

// One block: weight rows r0 .. r0 + 127 of tile b / (T ks), token tile b / ks
// % T (rows t0 .. t0 + N - 1 of x), k part b % ks of the stages: the ks parts
// of a tile are the blocks of one cluster, which add their sums in rank order
// through distributed shared memory, each for its share of the tile's tokens.
template <int FMT, int N>
__global__ void __launch_bounds__(MM_THREADS, 1)
    mm8_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
               MmArgs a) {
  using P = MP<FMT, N>;
  constexpr bool TA = tile_a<N>();
  extern __shared__ uint8_t mm_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(mm_raw) + 1023) & ~(uintptr_t)1023);
  __shared__ __align__(8) uint64_t full[P::S], empty[P::S];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kp = blockIdx.x % a.ks, tt = blockIdx.x / a.ks % a.T, rt = blockIdx.x / (a.ks * a.T);
  const int r0 = rt * MM_ROWS, t0 = tt * N;
  const int st0 = kp * a.stages / a.ks, nst = (kp + 1) * a.stages / a.ks - st0;
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
      for (int i = 0; i < nst; i++) {
        const int s = i % P::S;
        if (i >= P::S) mbar_wait(empty + s, ((i / P::S) - 1) & 1);
        uint8_t* st = ring + s * P::STAGE;
        mbar_expect_tx(full + s, P::STAGE);
        tma_load_3d(st, &wmap, full + s, (st0 + i) * P::WB, r0, 0);
        tma_load_3d(st + P::WTILE, &xmap, full + s, (st0 + i) * MM_K, t0, 0);
      }
    }
  } else if constexpr (TA) {
    const int wg = warp >> 2, c = tid & 127;
    uint8_t* abuf = ring + P::S * P::STAGE + wg * 2 * MM_ATILE;
    for (int i = 0; i < nst; i++) {
      const int s = i % P::S;
      uint8_t* at = abuf + (i & 1) * MM_ATILE;
      mbar_wait(full + s, (i / P::S) & 1);
      mm_widen_tile<FMT>(at, ring + s * P::STAGE, wg, c);
      fence_proxy_async();
      bar_sync(1 + wg, 128);  // the warpgroup's tile is whole
      const uint64_t ad = wgmma_desc(at), xd = wgmma_desc(ring + s * P::STAGE + P::WTILE);
      fence_acc<N / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; k++) wgmma_ss_bf16<N>(acc, ad + 2 * k, xd + 2 * k);
      wgmma_commit();
      fence_acc<N / 2>(acc);
      wgmma_wait<1>();  // stage i - 1's products are done: its x and tile are free
      if (i > 0 && lane == 0) mbar_arrive(empty + (i - 1) % P::S);
    }
    wgmma_wait<0>();
    fence_acc<N / 2>(acc);
  } else {
    const int t = lane & 3;
    const int row = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
    uint32_t af[4][4];
#pragma unroll
    for (int s = 0; s < 4; s++)
#pragma unroll
      for (int j = 0; j < 4; j++) af[s][j] = 0u;
    for (int i = 0; i < nst; i++) {
      const int s = i % P::S;
      mbar_wait(full + s, (i / P::S) & 1);
      wgmma_wait<0>();  // the last stage's products are done: its x and the A registers are free
      fence_acc<N / 2>(acc);
      fence_regs<16>(&af[0][0]);
      if (i > 0 && lane == 0) mbar_arrive(empty + (i - 1) % P::S);
      const uint8_t* st = ring + s * P::STAGE;
      mm_frags<FMT>(af, st, row, t);
      const uint64_t xd = wgmma_desc(st + P::WTILE);
      fence_acc<N / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; k++) wgmma_rs_bf16<N>(acc, af[k], xd + 2 * k);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc<N / 2>(acc);
  }

  // the sums through shared memory, [warpgroup][token][row] (MM_EP a token),
  // then four rows a thread added over the cluster's parts in rank order,
  // times the e4m3 scale, stored row-fastest (float4)
  __syncthreads();  // every stage is consumed: the ring takes the sums
  float* ep = reinterpret_cast<float*>(ring);
  if (warp < 8) {
    const int wg = warp >> 2, t = lane & 3, ra = 16 * (warp & 3) + (lane >> 2);
    // register i: row ra + 8 ((i / 2) % 2), token 8 (i / 4) + 2 t + i % 2
#pragma unroll
    for (int i = 0; i < N / 2; i++)
      ep[(wg * N + 8 * (i >> 2) + 2 * t + (i & 1)) * MM_EP + ra + 8 * ((i >> 1) & 1)] = acc[i];
  }
  const float sc = FMT == 3 ? __ldg(a.scale) : 1.f;
  cluster_sync();
  const int ks = a.ks, b_lo = kp * N / ks, b_hi = (kp + 1) * N / ks;  // this block's tokens
  const bool vec = (a.d & 3) == 0;
  for (int i = tid; i < (b_hi - b_lo) << 5; i += MM_THREADS) {
    const int b = b_lo + (i >> 5), r = (i << 2) & (MM_ROWS - 1), row = r0 + r, tok = t0 + b;
    if (tok >= a.R) continue;
    const float* p0 = ep + ((r >> 6) * N + b) * MM_EP + (r & 63);
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ks == 1) {
      y = *reinterpret_cast<const float4*>(p0);
    } else {  // every part's sums loaded at once, then added in rank order
      float4 v[MM_KS];
#pragma unroll
      for (int p = 0; p < MM_KS; p++) v[p] = p < ks ? ld_cluster4(p0, p) : y;
#pragma unroll
      for (int p = 0; p < MM_KS; p++)
        if (p < ks) y = make_float4(y.x + v[p].x, y.y + v[p].y, y.z + v[p].z, y.w + v[p].w);
    }
    float* dst = a.y + (size_t)tok * a.d + row;
    if (vec && row + 3 < a.d) {
      *reinterpret_cast<float4*>(dst) = make_float4(y.x * sc, y.y * sc, y.z * sc, y.w * sc);
    } else {
      const float o[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; j++)
        if (row + j < a.d) dst[j] = o[j] * sc;
    }
  }
  if (ks > 1) {  // no block leaves while another reads its sums
    __syncwarp();
    cluster_sync_relaxed();
  }
}

template <int FMT, int N>
cudaError_t launch_mm_one(const CUtensorMap& mw, const CUtensorMap& mx, const MmArgs& a, int grid,
                          cudaStream_t st) {
  using P = MP<FMT, N>;
  static const cudaError_t set = cudaFuncSetAttribute(
      mm8_kernel<FMT, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (set != cudaSuccess) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(MM_THREADS);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.ks > 1;  // a whole k: each block its own cluster
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mm8_kernel<FMT, N>, mw, mx, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int FMT>
cudaError_t launch_mm_n(int N, const CUtensorMap& mw, const CUtensorMap& mx, const MmArgs& a,
                        int grid, cudaStream_t st) {
  if (N == 128) return launch_mm_one<FMT, 128>(mw, mx, a, grid, st);
  if (N == 192) return launch_mm_one<FMT, 192>(mw, mx, a, grid, st);
  return launch_mm_one<FMT, 256>(mw, mx, a, grid, st);
}

}  // namespace

extern "C" {

// y (R, d) f32 = x (R, n) bf16 . W^T for W (d, n) at the plane's address in
// fp16 (fmt 0), fp8 e5m2 (1) or fp8 e4m3 (3, times *scale, a device pointer;
// null for the other formats); x contiguous and 16-byte aligned, n a
// multiple of 16. The tiling is hopper_qmm.mm8_plan's: width N (128, 192 or
// 256) with T token tiles ((T - 1) N < R <= T N), ks k parts (1, 2, 4 or 8,
// at most the 64-value stages), grid = ceil(d / 128) T ks blocks.
int calm_mm8(const void* x, const void* w, void* y, const void* scale, int R, int d, int n,
             int fmt, int width, int T, int ks, int grid, void* stream) {
  const int stages = (n + MM_K - 1) / MM_K, rtiles = (d + MM_ROWS - 1) / MM_ROWS;
  if (R < 1 || d < 1 || n < 16 || n % 16 != 0 || (fmt != 0 && fmt != 1 && fmt != 3) ||
      (width != 128 && width != 192 && width != 256) || T < 1 || (long)(T - 1) * width >= R ||
      (long)T * width < R || (ks != 1 && ks != 2 && ks != 4 && ks != MM_KS) || ks > stages ||
      (long)grid != (long)rtiles * T * ks || (fmt == 3) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t rb = fmt == 0 ? 2 * (size_t)n : (size_t)n;  // bytes a weight row
  CUtensorMap mw, mx;
  cudaError_t e = wt_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, rb, d, 1, rb, rb * d,
                         fmt == 0 ? 128 : 64, MM_ROWS,
                         fmt == 0 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == cudaSuccess)
    e = wt_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, n, R, 1, 2 * (size_t)n,
               2 * (size_t)n * R, MM_K, width, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  MmArgs a;
  a.y = static_cast<float*>(y);
  a.scale = static_cast<const float*>(scale);
  a.R = R;
  a.d = d;
  a.T = T;
  a.ks = ks;
  a.stages = stages;
  const cudaStream_t st = (cudaStream_t)stream;
  if (fmt == 0) return (int)launch_mm_n<0>(width, mw, mx, a, grid, st);
  if (fmt == 1) return (int)launch_mm_n<1>(width, mw, mx, a, grid, st);
  return (int)launch_mm_n<3>(width, mw, mx, a, grid, st);
}

// the dynamic shared memory one block of format fmt and width asks for (for
// reports); -1 for none
int calm_mm8_smem(int fmt, int width) {
  const int i = width == 128 ? 0 : width == 192 ? 1 : width == 256 ? 2 : -1;
  const int f = fmt == 0 ? 0 : fmt == 1 ? 1 : fmt == 3 ? 2 : -1;
  if (i < 0 || f < 0) return -1;
  const int smem[3][3] = {{MP<0, 128>::SMEM, MP<0, 192>::SMEM, MP<0, 256>::SMEM},
                          {MP<1, 128>::SMEM, MP<1, 192>::SMEM, MP<1, 256>::SMEM},
                          {MP<3, 128>::SMEM, MP<3, 192>::SMEM, MP<3, 256>::SMEM}};
  return smem[f][i];
}

const char* calm_mm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
