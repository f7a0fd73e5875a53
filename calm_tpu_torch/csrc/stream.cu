// Streaming reductions over a whole int32 buffer: the kernels of the two
// HBM-ceiling tools.
//
// Replaces three Pallas kernels:
//   - tools/dma_ceiling.py:26 _dma_kernel (K1) and tools/gf4_bound.py:42
//     _dma_kernel (K15's dma), one function: the f32 sum of every int32
//     word converted to float, plus a seed -> calm_stream_sum, mode 0;
//   - tools/gf4_bound.py:55 _decode_kernel (K15): the sum of the eight
//     decoded planes of every gf4 word, (code_k - 4) * e5m2(w & 0xff) / -4,
//     each plane optionally rounded through bf16 (``full``), plus a seed
//     -> calm_stream_sum, mode 1 (no round trip) and 2 (bf16 round trip).
//
// The TPU kernels carry one scalar from grid step to grid step in SMEM.
// Blocks run in no order here, so the sum takes two launches: pass 1 has
// each block reduce one contiguous span of the words into partials[b];
// pass 2, one block, folds the partials in float64, adds the seed (a
// device scalar, so that a timed chain feeds each call's result into the
// next) and writes the f32 result. Every word goes to a fixed thread and
// every sum runs in a fixed order, with no atomics: the result is the same
// from run to run.
//
// What bounds it on an H100: the bytes, 4 a word read once; the work is
// one convert and one add a word (mode 0) or ~5 instructions a value over
// 8 values a word (modes 1-2), far below the card's issue rate at 3.35
// TB/s. Design: 16-byte loads (int4), neighbouring threads on neighbouring
// addresses, four loads in flight per thread (64 bytes), streamed past L1
// (__ldcs); four f32 sums a thread (one per int4 lane) keep each sum's
// chain short. A span is a multiple of 4 words, so only the last block
// holds a tail of 1-3 words.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define FOLD_THREADS 256

namespace {

__device__ __forceinline__ float gf4_scale(uint32_t w) {
  // the e5m2 byte in the high half of an f16 is the same value, exactly
  return __half2float(__ushort_as_half((unsigned short)((w & 0xffu) << 8))) * -0.25f;
}

// code_k - 4, exactly: the 3-bit field under the mantissa of 2^23
__device__ __forceinline__ float gf4_code(uint32_t w, int k) {
  return __uint_as_float(0x4B000000u | ((w >> (8 + 3 * k)) & 7u)) - 8388612.0f;
}

// MODE 0: the word's value as a float; 1: the sum of its 8 decoded gf4
// values; 2: the same with each value rounded through bf16.
template <int MODE>
__device__ __forceinline__ float word_value(int q) {
  if (MODE == 0) return __int2float_rn(q);
  const uint32_t w = (uint32_t)q;
  const float s = gf4_scale(w);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    float v = gf4_code(w, k) * s;
    if (MODE == 2) v = __bfloat162float(__float2bfloat16(v));
    acc += v;
  }
  return acc;
}

template <int MODE>
__device__ __forceinline__ void add4(float4& acc, int4 q) {
  acc.x += word_value<MODE>(q.x);
  acc.y += word_value<MODE>(q.y);
  acc.z += word_value<MODE>(q.z);
  acc.w += word_value<MODE>(q.w);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// partials[b] = the sum of word_value over words [b * span, min((b + 1) *
// span, n)); span % 4 == 0, w 16-byte aligned.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
    sum_kernel(const int* __restrict__ w, long long n, long long span,
               float* __restrict__ partials) {
  __shared__ float red[THREADS / 32];
  const long long start = (long long)blockIdx.x * span;
  const long long end = min(start + span, n);
  const int4* p = reinterpret_cast<const int4*>(w);
  const long long v1 = end >> 2;  // int4s of the body: [start / 4, v1)
  const long long step = THREADS;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  long long i = (start >> 2) + threadIdx.x;
  for (; i + 3 * step < v1; i += 4 * step) {
    const int4 q0 = __ldcs(p + i), q1 = __ldcs(p + i + step);
    const int4 q2 = __ldcs(p + i + 2 * step), q3 = __ldcs(p + i + 3 * step);
    add4<MODE>(acc, q0);
    add4<MODE>(acc, q1);
    add4<MODE>(acc, q2);
    add4<MODE>(acc, q3);
  }
  for (; i < v1; i += step) add4<MODE>(acc, __ldcs(p + i));
  const long long t = (v1 << 2) + threadIdx.x;  // the last block's tail
  if (t < end) acc.x += word_value<MODE>(w[t]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = warp_sum((acc.x + acc.y) + (acc.z + acc.w));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < THREADS / 32 ? red[lane] : 0.f);
    if (lane == 0) partials[blockIdx.x] = v;
  }
}

// out[0] = seed[0] + the sum of partials[0..nblocks), in float64.
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_kernel(const float* __restrict__ partials, int nblocks,
                const float* __restrict__ seed, float* __restrict__ out) {
  __shared__ double red[FOLD_THREADS];
  double s = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += FOLD_THREADS) s += (double)partials[b];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = FOLD_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)(red[0] + (double)seed[0]);
}

}  // namespace

extern "C" {

// out (1,) f32 = seed[0] + the sum over the n words of w of mode 0 (value),
// 1 (gf4 planes) or 2 (gf4 planes through bf16); nblocks = ceil(n / span)
// blocks of span words (a multiple of 4) each; partials (nblocks,) f32
// scratch. Two launches.
int calm_stream_sum(const void* w, long long n, long long span, int nblocks,
                    const void* seed, void* partials, void* out, int mode,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* wi = static_cast<const int*>(w);
  float* pf = static_cast<float*>(partials);
  if (mode == 0)
    sum_kernel<0><<<nblocks, THREADS, 0, st>>>(wi, n, span, pf);
  else if (mode == 1)
    sum_kernel<1><<<nblocks, THREADS, 0, st>>>(wi, n, span, pf);
  else
    sum_kernel<2><<<nblocks, THREADS, 0, st>>>(wi, n, span, pf);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fold_kernel<<<1, FOLD_THREADS, 0, st>>>(pf, nblocks, static_cast<const float*>(seed),
                                          static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* calm_stream_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
