// Expert-indexed matvecs for MoE decode (one activation row; fp16/fp8 up
// to 16 rows where qmm.cu's multi-row sweep declines the shape) over
// layer-stacked expert weights: (L, E, d, n) fp16, fp8-e5m2 or fp8-e4m3
// (one row; a scale per (layer, expert)), or natural gf4 words (L, E, d,
// n/8) int32.
//
// Replaces two Pallas kernels of calm_tpu/ops/pallas_qmm.py:
//   - _moe_dense_kernel (:1248) and _moe_dense_gf4_kernel (:1256), via
//     _qmm_moe_dense (:1273): Y[a] = x[min(a, Ax-1)] . W[layer, eidx[a]]^T
//     for A expert slots -> calm_moe_dense below (K10);
//   - _gf4_moe_ffn_kernel (:1361, via _gf4_moe_ffn :1403): one layer's
//     whole expert FFN, z[a] = (act(x W1[l,e]^T) * (x W3[l,e]^T)) W2[l,e]^T
//     with e = eidx[a] -> calm_gf4_moe_ffn below (K11). The TPU kernel reads
//     plane-major w1/w3 for Mosaic; here every weight is read as the
//     container stores it.
//
// The slots' expert ids (eidx, sorted unique, padded) and the live slot
// count (cnt) stay on the device: each block reads its slot's id and
// offsets its own weight pointer, where the TPU kernel takes the ids by
// scalar prefetch. No id goes through the host, so routing needs no sync.
// Dead slots (a >= cnt) write zeros and read no weights: the TPU pads with
// the last live id and relies on Pallas skipping the repeated DMA, which
// on this card would be a real re-read. Ids outside [0, E) are clamped, so
// a bad id cannot read outside the stack (the wrapper cannot check device
// ids without a sync).
//
// What bounds both on an H100: the live experts' weight bytes. At B=1 each
// weight is used for one multiply-add, far below the ~20 flop/byte where
// the f32 pipes would limit (67 TFLOP/s against 3.35 TB/s), so the least
// time is the live slots' bytes over the HBM rate: at Mixtral 8x7B shapes
// with two live experts, 117 MB for K10's fp8 w1 (0.035 ms) and 176 MB for
// K11 (0.053 ms).
//
// Design: the matvecs of qmm.cu (K2) and gf4.cu (K3) with a second grid
// axis over expert slots. fp8/fp16: one warp per output row, four weights
// per lane step with the matching float4 of x, 32 bytes of weight loads in
// flight per lane. gf4: a warp walks four weight rows together so each
// float4 pair of x it loads serves four rows; the 3-bit codes decode
// exactly through the mantissa of 2^23, one scale multiply per word. K11's
// first launch walks two rows each of w1 and w3 (still four streams) and
// applies the activation as it writes h; its second is K10's gf4 launch on
// h and w2. Two launches and not one: blocks run in no order, so h must be
// whole before any w2 row reads it; the TPU kernel keeps h in VMEM across
// its ordered grid steps. h ((A, B, H) f32, 115 KB at Mixtral width, B=1)
// is allocated by the wrapper. A single persistent launch is later work.
//
// Since the multi-row path took the sweep, these loops serve one row (B =
// 1, at 77.6% and 53.8% of their byte bound on Mixtral 8x7B shapes, PERF.md)
// and, for fp16/fp8, the 2-16-row shapes that path declines (rows of n %
// 16 != 0): hopper_qmm.moe_multirow_supported decides by shape, on the
// host; the gf4 loop takes one row only. At 2-16 rows the fp16/fp8 loop
// reads B float4 of x from L1 per weight word and does 2 B f32 FMAs a
// weight; qmm.cu's calm_moe_mmv and calm_moe_ffn run the same contract
// (ids and cnt on the device, dead slots zero) on the tensor cores
// (mmv_kernel with an expert-slot axis), and the fp16/fp8 FFN there is two
// products (the dual w1/w3 launch, then w2) where three launches of this
// file and PyTorch's activation were.
//
// fp8e4 (FMT 3) at one row: e4m3 decodes exactly to f16 by Hopper's
// conversion (qmm.cu's e4m3x2_f16x2), and a live slot reads its expert's
// scale beside its id and multiplies the row's sum by it; a dead slot reads
// neither. The reference runs fp8e4 through XLA (calm_tpu/ops/qmm.py
// :179-205, no Pallas kernel); 2-16 rows take qmm.cu's sweep.
//
// Each .cu file is its own library (ops/build.py), so the few decode
// helpers below repeat those of qmm.cu and gf4.cu.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8   // fp8/fp16: warps per block, one output row each
#define GWARPS 4  // gf4: warps per block
#define GSTREAMS 4  // gf4: weight rows a warp walks together
#define GU 4      // gf4: words in flight per lane and stream

namespace {

__device__ __forceinline__ float2 h2f2(uint32_t bits) {
  __half2 h;
  *reinterpret_cast<uint32_t*>(&h) = bits;
  return __half22float2(h);
}

__device__ __forceinline__ float dot4(float4 w, float4 x) {
  return w.x * x.x + w.y * x.y + w.z * x.z + w.w * x.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the e5m2 byte in the high half of an f16 is the same value, exactly
__device__ __forceinline__ float gf4_scale(uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)((w & 0xffu) << 8))) * -0.25f;
}

// code_k - 4, exactly: the 3-bit field under the mantissa of 2^23
__device__ __forceinline__ float gf4_code(uint32_t w, int k) {
  return __uint_as_float(0x4B000000u | ((w >> (8 + 3 * k)) & 7u)) - 8388612.0f;
}

// ACT 1: SiLU, 2: tanh-GELU (pallas_qmm.py:1382-1386)
template <int ACT>
__device__ __forceinline__ float act(float y) {
  if (ACT == 1) return y * (1.0f / (1.0f + expf(-y)));
  const float ga = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * y * (1.0f + tanhf(ga * (y + 0.044715f * y * y * y)));
}

// Slot a's expert id, or -1 for a dead slot (a >= cnt).
__device__ __forceinline__ int slot_expert(const int* eidx, const int* cnt, int E,
                                           int a) {
  if (a >= __ldg(cnt)) return -1;
  return min(max(__ldg(eidx + a), 0), E - 1);
}

// two e4m3 bytes (b0 low) -> f16x2 {b0, b1}, exactly (see qmm.cu)
__device__ __forceinline__ uint32_t e4m3x2_f16x2(unsigned short v) {
  uint32_t r;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(r) : "h"(v));
  return r;
}

// FMT 0: fp16 (one uint2 holds four weights), 1: fp8 e5m2 (one uint32), 3:
// fp8 e4m3 (one uint32).
template <int FMT>
struct Fmt;
template <>
struct Fmt<0> {
  using Word = uint2;
  static __device__ __forceinline__ float4 dec(uint2 q) {
    const float2 lo = h2f2(q.x), hi = h2f2(q.y);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};
template <>
struct Fmt<1> {
  using Word = uint32_t;
  static __device__ __forceinline__ float4 dec(uint32_t q) {
    // bytes [0, b0, 0, b1] and [0, b2, 0, b3]: e5m2 in the high byte
    const float2 lo = h2f2(__byte_perm(q, 0u, 0x1404));
    const float2 hi = h2f2(__byte_perm(q, 0u, 0x3424));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};
template <>
struct Fmt<3> {
  using Word = uint32_t;
  static __device__ __forceinline__ float4 dec(uint32_t q) {
    const float2 lo = h2f2(e4m3x2_f16x2((unsigned short)(q & 0xffffu)));
    const float2 hi = h2f2(e4m3x2_f16x2((unsigned short)(q >> 16)));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

// ---------------------------------------------------------------------------
// K10, fp8/fp16: grid (ceil(d / WARPS), A), one warp per output row
// ---------------------------------------------------------------------------

// NB: compile-time bound on B (accumulator registers). w is the layer's
// plane (E, d, n); x is (Ax, B, n); y is (A, B, d); scale: FMT 3's (E,)
// scales of the layer.
template <int FMT, int NB>
__global__ void __launch_bounds__(WARPS * 32)
    moe_qmv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                   float* __restrict__ y, const int* __restrict__ eidx,
                   const int* __restrict__ cnt, const float* __restrict__ scale, int Ax,
                   int B, int d, int n, int E) {
  using Word = typename Fmt<FMT>::Word;
  constexpr int U = 32 / (int)sizeof(Word);  // loads in flight per lane: 32 bytes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = blockIdx.y;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= d) return;
  float* ya = y + (size_t)a * B * d;
  const int e = slot_expert(eidx, cnt, E, a);
  if (e < 0) {
    if (lane < B) ya[(size_t)lane * d + row] = 0.f;
    return;
  }
  const int nw = n >> 2;  // words (four weights) per row = float4s per row of x
  const Word* wr = reinterpret_cast<const Word*>(w) + ((size_t)e * d + row) * nw;
  const float4* x4 =
      reinterpret_cast<const float4*>(x + (size_t)min(a, Ax - 1) * B * n);
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; b++) acc[b] = 0.f;

  for (int c0 = lane; c0 < nw; c0 += 32 * U) {
    Word q[U];
#pragma unroll
    for (int u = 0; u < U; u++) {
      const int c = c0 + u * 32;
      if (c < nw) q[u] = __ldcs(wr + c);
    }
#pragma unroll
    for (int u = 0; u < U; u++) {
      const int c = c0 + u * 32;
      if (c < nw) {
        const float4 wv = Fmt<FMT>::dec(q[u]);
#pragma unroll
        for (int b = 0; b < NB; b++)
          if (b < B) acc[b] += dot4(wv, __ldg(x4 + (size_t)b * nw + c));
      }
    }
  }
  float es = 1.f;  // e4m3: the expert's scale
  if constexpr (FMT == 3) es = __ldg(scale + e);
#pragma unroll
  for (int b = 0; b < NB; b++) {
    if (b < B) {
      float s = warp_sum(acc[b]);
      if constexpr (FMT == 3) s *= es;
      if (lane == 0) ya[(size_t)b * d + row] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// gf4 (K10's gf4 body, both launches of K11) at one row: grid
// (ceil(d / (GWARPS * rows per warp)), A), a warp walks GSTREAMS word rows
// ---------------------------------------------------------------------------

// MODE 0: y = x . w^T, four rows of w per warp. MODE 1 (SiLU) / 2
// (tanh-GELU): y = act(x . w^T) * (x . w3^T), two rows each of w and w3.
// w/w3 are the layer's planes (E, d, n8); x is (Ax, 1, 8 n8); y (A, 1, d).
template <int MODE>
__global__ void __launch_bounds__(GWARPS * 32)
    moe_gf4_kernel(const float* __restrict__ x, const uint32_t* __restrict__ w,
                   const uint32_t* __restrict__ w3, float* __restrict__ y,
                   const int* __restrict__ eidx, const int* __restrict__ cnt,
                   int Ax, int d, int n8, int E) {
  constexpr int ROWS = MODE ? GSTREAMS / 2 : GSTREAMS;  // output rows per warp
  constexpr int U = GU;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = blockIdx.y;
  const int row0 = (blockIdx.x * GWARPS + warp) * ROWS;
  if (row0 >= d) return;
  float* ya = y + (size_t)a * d;
  const int e = slot_expert(eidx, cnt, E, a);
  if (e < 0) {
    if (lane < ROWS && row0 + lane < d) ya[row0 + lane] = 0.f;
    return;
  }
  const size_t plane = (size_t)e * d * n8;
  const uint32_t* ws[GSTREAMS];
#pragma unroll
  for (int s = 0; s < GSTREAMS; s++) {  // rows past d re-read row d-1, unused
    const int r = min(row0 + (MODE ? s % ROWS : s), d - 1);
    ws[s] = (MODE && s >= ROWS ? w3 : w) + plane + (size_t)r * n8;
  }
  const float4* x4 =
      reinterpret_cast<const float4*>(x + (size_t)min(a, Ax - 1) * 8 * n8);
  float acc[GSTREAMS];
#pragma unroll
  for (int s = 0; s < GSTREAMS; s++) acc[s] = 0.f;

  for (int c0 = lane; c0 < n8; c0 += 32 * U) {
    uint32_t q[U][GSTREAMS];
#pragma unroll
    for (int u = 0; u < U; u++) {
      const int c = c0 + u * 32;
#pragma unroll
      for (int s = 0; s < GSTREAMS; s++) q[u][s] = c < n8 ? __ldcs(ws[s] + c) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; u++) {
      const int c = c0 + u * 32;
      if (c >= n8) break;
      const float4 xa = __ldg(x4 + 2 * c), xb = __ldg(x4 + 2 * c + 1);
#pragma unroll
      for (int s = 0; s < GSTREAMS; s++) {
        const uint32_t v = q[u][s];
        float t = gf4_code(v, 0) * xa.x;
        t = fmaf(gf4_code(v, 1), xa.y, t);
        t = fmaf(gf4_code(v, 2), xa.z, t);
        t = fmaf(gf4_code(v, 3), xa.w, t);
        t = fmaf(gf4_code(v, 4), xb.x, t);
        t = fmaf(gf4_code(v, 5), xb.y, t);
        t = fmaf(gf4_code(v, 6), xb.z, t);
        t = fmaf(gf4_code(v, 7), xb.w, t);
        acc[s] = fmaf(t, gf4_scale(v), acc[s]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; r++) {
    float v = warp_sum(acc[r]);
    if (MODE) v = act<MODE>(v) * warp_sum(acc[(ROWS + r) % GSTREAMS]);
    if (lane == 0 && row0 + r < d) ya[row0 + r] = v;
  }
}

template <int FMT, int NB>
void launch_qmv(const float* x, const void* w, float* y, const int* eidx,
                const int* cnt, int Ax, int A, int B, int d, int n, int E,
                cudaStream_t st, const float* scale = nullptr) {
  dim3 grid((d + WARPS - 1) / WARPS, A);
  moe_qmv_kernel<FMT, NB><<<grid, WARPS * 32, 0, st>>>(
      x, static_cast<const uint8_t*>(w), y, eidx, cnt, scale, Ax, B, d, n, E);
}

template <int MODE>
void launch_gf4(const float* x, const void* w, const void* w3, float* y,
                const int* eidx, const int* cnt, int Ax, int A, int d, int n8, int E,
                cudaStream_t st) {
  constexpr int rows = GWARPS * (MODE ? GSTREAMS / 2 : GSTREAMS);
  dim3 grid((d + rows - 1) / rows, A);
  moe_gf4_kernel<MODE><<<grid, GWARPS * 32, 0, st>>>(
      x, static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(w3), y,
      eidx, cnt, Ax, d, n8, E);
}

template <int FMT>
void launch_qmv_b(const float* x, const void* w, float* y, const int* eidx,
                  const int* cnt, int Ax, int A, int B, int d, int n, int E,
                  cudaStream_t st) {
  if (B <= 1)
    launch_qmv<FMT, 1>(x, w, y, eidx, cnt, Ax, A, B, d, n, E, st);
  else if (B <= 4)
    launch_qmv<FMT, 4>(x, w, y, eidx, cnt, Ax, A, B, d, n, E, st);
  else
    launch_qmv<FMT, 16>(x, w, y, eidx, cnt, Ax, A, B, d, n, E, st);
}

}  // namespace

extern "C" {

// K10: y (A, B, d) f32 = x[min(a, Ax-1)] (B, n) . W[eidx[a]]^T for the A
// slots; w points at the layer's plane (E, d, n) fp16 (fmt 0) or fp8 e5m2
// (fmt 1), fp8 e4m3 (fmt 3, one row only, times scale[eidx[a]]: scale points
// at the layer's (E,) scales on the device; null for the other formats), or
// (E, d, n/8) gf4 words (fmt 2, one row only: 2-16 rows of gf4 and e4m3
// take qmm.cu's calm_moe_mmv); eidx (A,) and cnt (1,) int32 on the device;
// 1 <= B <= 16, n % 4 == 0, x 16-byte aligned.
int calm_moe_dense(const void* x, const void* w, void* y, const void* eidx,
                   const void* cnt, int Ax, int A, int B, int d, int n, int E,
                   int fmt, const void* scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const int* ei = static_cast<const int*>(eidx);
  const int* cn = static_cast<const int*>(cnt);
  if ((fmt == 3) != (scale != nullptr)) return (int)cudaErrorInvalidValue;
  if (fmt == 3) {
    if (B != 1) return (int)cudaErrorInvalidValue;
    launch_qmv<3, 1>(xf, w, yf, ei, cn, Ax, A, B, d, n, E, st,
                     static_cast<const float*>(scale));
  } else if (fmt == 2) {
    if (B != 1) return (int)cudaErrorInvalidValue;
    launch_gf4<0>(xf, w, nullptr, yf, ei, cn, Ax, A, d, n / 8, E, st);
  } else if (fmt == 1)
    launch_qmv_b<1>(xf, w, yf, ei, cn, Ax, A, B, d, n, E, st);
  else
    launch_qmv_b<0>(xf, w, yf, ei, cn, Ax, A, B, d, n, E, st);
  return (int)cudaGetLastError();
}

// K11 at one row: z (A, 1, D) f32, the expert FFN of each slot on x (1, D)
// f32 (2-16 rows take qmm.cu's calm_moe_ffn): w1/w3 point at the layer's
// planes (E, H, D/8), w2 at (E, D, H/8), natural gf4 words; h (A, 1, H)
// f32 is caller-allocated scratch.
int calm_gf4_moe_ffn(const void* x, const void* w1, const void* w3, const void* w2,
                     const void* eidx, const void* cnt, void* h, void* z, int A,
                     int B, int D, int H, int E, int act_gelu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B != 1) return (int)cudaErrorInvalidValue;
  const int* ei = static_cast<const int*>(eidx);
  const int* cn = static_cast<const int*>(cnt);
  float* hf = static_cast<float*>(h);
  const float* xf = static_cast<const float*>(x);
  if (act_gelu)
    launch_gf4<2>(xf, w1, w3, hf, ei, cn, 1, A, H, D / 8, E, st);
  else
    launch_gf4<1>(xf, w1, w3, hf, ei, cn, 1, A, H, D / 8, E, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  launch_gf4<0>(hf, w2, nullptr, static_cast<float*>(z), ei, cn, A, A, D, H / 8, E, st);
  return (int)cudaGetLastError();
}

const char* calm_moe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
