// Flash-decode attention over the layer-stacked, head-major KV cache
// (L, B, KVH, S, hd) in bf16, fp16 or fp8 e5m2.
//
// Replaces calm_tpu/ops/pallas_attn.py:_attn_body (:77) in its plain
// (_attn_kernel :49) and fresh (_attn_kernel_fresh :69) modes, reached
// through decode_attention (:291). Each of the M = H / KVH query rows of a
// kv head attends the cache rows s < kv_len[b] with scale 1/sqrt(hd). In
// fresh mode the current token's K/V (already in the cache dtype) are
// passed in and join the softmax, and the stale cache row kv_pos[b] (the
// row a rolled window is about to overwrite) is masked out.
//
// What bounds it on an H100: the cache bytes, 2 * KVH * kv_len * hd *
// bytes per (b, layer); the arithmetic is ~2 * M flops per cache value.
//
// Design: split-S. A block owns one (b, kv head, chunk of CS rows), so a
// B=1, 8-kv-head model still fills the 132 SMs (a block per whole plane
// would give 8 blocks). Its four warps take every fourth row; within a
// warp lane l holds elements l, l+32, ... of q, k, v, so each row load is
// one contiguous access per element slot. Scores close with a shuffle
// tree, and each warp keeps its own online-softmax state (max, sum, acc);
// the block merges the four in shared memory and writes the chunk's
// unnormalised partials (acc, m, l), as pallas_attn's partials mode does.
// A second small launch merges the chunks with the max-rescale of
// calm_tpu/model.py:569-576 and normalises. Chunks past kv_len exit early
// after writing an empty state, so nothing beyond kv_len is read.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define AWARPS 4
#define MAXM 16

namespace {

template <int KVT>  // 0: fp16, 1: bf16, 2: fp8 e5m2
__device__ __forceinline__ float kv_load(const void* base, size_t i);

template <>
__device__ __forceinline__ float kv_load<0>(const void* base, size_t i) {
  return __half2float(static_cast<const __half*>(base)[i]);
}
template <>
__device__ __forceinline__ float kv_load<1>(const void* base, size_t i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
}
template <>
__device__ __forceinline__ float kv_load<2>(const void* base, size_t i) {
  const uint16_t bits = (uint16_t)static_cast<const uint8_t*>(base)[i] << 8;
  return __half2float(__ushort_as_half(bits));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct AttnArgs {
  const float* q;         // (B, KVH * M, hd)
  const void* k;          // (L, B, KVH, S, hd)
  const void* v;
  const int* kv_len;      // (B,)
  const void* fk;         // fresh mode: (B, KVH, hd) in the cache dtype
  const void* fv;
  const int* kv_pos;      // fresh mode: (B,) stale row
  float* pacc;            // (B, KVH, NC, M, hd)
  float* pm;              // (B, KVH, NC, M)
  float* pl;
  int B, KVH, M, S, layer, CS, NC;
  float scale;
};

// one row's contribution to a warp's online state
template <int HPL, int KVT, int MM>
__device__ __forceinline__ void attend_row(const void* kb, const void* vb,
                                           size_t off, int lane, int M,
                                           float (*qr)[HPL],
                                           float* mrun, float* lrun,
                                           float (*acc)[HPL], float scale) {
  float kr[HPL], vr[HPL];
#pragma unroll
  for (int i = 0; i < HPL; i++) {
    kr[i] = kv_load<KVT>(kb, off + i * 32 + lane);
    vr[i] = kv_load<KVT>(vb, off + i * 32 + lane);
  }
#pragma unroll
  for (int m = 0; m < MM; m++) {
    if (m < M) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < HPL; i++) s += qr[m][i] * kr[i];
      s = warp_sum(s) * scale;
      const float mn = fmaxf(mrun[m], s);
      const float alpha = expf(mrun[m] - mn);  // exp(-inf) = 0 at start
      const float p = expf(s - mn);
      lrun[m] = lrun[m] * alpha + p;
#pragma unroll
      for (int i = 0; i < HPL; i++) acc[m][i] = acc[m][i] * alpha + p * vr[i];
      mrun[m] = mn;
    }
  }
}

// MM: compile-time bound on M (registers hold MM query rows)
template <int HPL, int KVT, int MM>
__global__ void __launch_bounds__(AWARPS * 32) attn_chunk_kernel(AttnArgs a) {
  constexpr int HD = HPL * 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = a.M;
  const int kv_len = a.kv_len[b];
  const int dead = a.kv_pos ? a.kv_pos[b] : -1;
  const size_t pidx = ((size_t)b * a.KVH + h) * a.NC + c;

  const int s0 = c * a.CS;
  const int s1 = min(min(s0 + a.CS, kv_len), a.S);
  const bool seed = a.fk != nullptr && c == 0;
  if (s0 >= s1 && !seed) {  // nothing of this chunk is visible
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      a.pm[pidx * M + i] = -INFINITY;
      a.pl[pidx * M + i] = 0.f;
    }
    for (int i = threadIdx.x; i < M * HD; i += blockDim.x)
      a.pacc[pidx * M * HD + i] = 0.f;
    return;
  }

  float qr[MM][HPL];
  float mrun[MM], lrun[MM], acc[MM][HPL];
#pragma unroll
  for (int m = 0; m < MM; m++) {
    mrun[m] = -INFINITY;
    lrun[m] = 0.f;
#pragma unroll
    for (int i = 0; i < HPL; i++) {
      acc[m][i] = 0.f;
      qr[m][i] = m < M ? a.q[(((size_t)b * a.KVH + h) * M + m) * HD + i * 32 + lane]
                       : 0.f;
    }
  }

  if (seed && warp == 0) {
    const size_t off = ((size_t)b * a.KVH + h) * HD;
    attend_row<HPL, KVT, MM>(a.fk, a.fv, off, lane, M, qr, mrun, lrun, acc, a.scale);
  }
  const size_t plane =
      ((((size_t)a.layer * a.B + b) * a.KVH + h) * (size_t)a.S) * HD;
  for (int s = s0 + warp; s < s1; s += AWARPS) {
    if (s == dead) continue;
    attend_row<HPL, KVT, MM>(a.k, a.v, plane + (size_t)s * HD, lane, M, qr, mrun,
                         lrun, acc, a.scale);
  }

  // merge the warps' states: sm = [AWARPS][M][HD + 2]
  extern __shared__ float sm[];
  const int stride = HD + 2;
#pragma unroll
  for (int m = 0; m < MM; m++) {
    if (m < M) {
      float* row = sm + (warp * M + m) * stride;
#pragma unroll
      for (int i = 0; i < HPL; i++) row[i * 32 + lane] = acc[m][i];
      if (lane == 0) {
        row[HD] = mrun[m];
        row[HD + 1] = lrun[m];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < M * HD; t += blockDim.x) {
    const int m = t / HD, d = t % HD;
    float mx = -INFINITY;
    for (int w = 0; w < AWARPS; w++) mx = fmaxf(mx, sm[(w * M + m) * stride + HD]);
    float o = 0.f, l = 0.f;
    if (mx != -INFINITY) {
      for (int w = 0; w < AWARPS; w++) {
        const float* row = sm + (w * M + m) * stride;
        const float f = expf(row[HD] - mx);
        o += row[d] * f;
        l += row[HD + 1] * f;
      }
    }
    a.pacc[pidx * M * HD + t] = o;
    if (d == 0) {
      a.pm[pidx * M + m] = mx;
      a.pl[pidx * M + m] = l;
    }
  }
}

// out (B, KVH * M, hd) = merged, normalised chunks; one block per (b, head)
__global__ void attn_merge_kernel(const float* pacc, const float* pm,
                                  const float* pl, float* out, int KVH, int M,
                                  int NC, int HD) {
  const int bh = blockIdx.x;  // b * KVH * M + h * M + m
  const int m = bh % M, h = (bh / M) % KVH, b = bh / (M * KVH);
  const size_t base = ((size_t)b * KVH + h) * NC;
  float mx = -INFINITY;
  for (int c = 0; c < NC; c++) mx = fmaxf(mx, pm[(base + c) * M + m]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float o = 0.f, l = 0.f;
    for (int c = 0; c < NC; c++) {
      const float mc = pm[(base + c) * M + m];
      if (mc == -INFINITY) continue;
      const float f = expf(mc - mx);
      o += pacc[((base + c) * M + m) * HD + d] * f;
      l += pl[(base + c) * M + m] * f;
    }
    out[(size_t)bh * HD + d] = o / l;
  }
}

template <int HPL, int KVT, int MM>
cudaError_t launch_chunks(const AttnArgs& a, cudaStream_t st) {
  const int smem = AWARPS * a.M * (HPL * 32 + 2) * (int)sizeof(float);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(attn_chunk_kernel<HPL, KVT, MM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.NC, a.KVH, a.B);
  attn_chunk_kernel<HPL, KVT, MM><<<grid, AWARPS * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HPL, int KVT>
cudaError_t launch_m(const AttnArgs& a, cudaStream_t st) {
  if (a.M <= 4) return launch_chunks<HPL, KVT, 4>(a, st);
  if (a.M <= 8) return launch_chunks<HPL, KVT, 8>(a, st);
  return launch_chunks<HPL, KVT, MAXM>(a, st);
}

template <int HPL>
cudaError_t launch_kvt(int kvt, const AttnArgs& a, cudaStream_t st) {
  if (kvt == 0) return launch_m<HPL, 0>(a, st);
  if (kvt == 1) return launch_m<HPL, 1>(a, st);
  return launch_m<HPL, 2>(a, st);
}

}  // namespace

extern "C" {

// kvt: 0 fp16, 1 bf16, 2 fp8 e5m2; hd in {64, 128}; M <= 16.
// fk/fv/kv_pos null for plain mode. Scratch pacc/pm/pl sized by the caller
// for NC = ceil(S / CS) chunks.
int calm_decode_attention(const void* q, const void* k, const void* v,
                          const void* kv_len, const void* fk, const void* fv,
                          const void* kv_pos, void* pacc, void* pm, void* pl,
                          void* out, int B, int KVH, int M, int S, int hd,
                          int layer, int CS, int kvt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  AttnArgs a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.kv_len = static_cast<const int*>(kv_len);
  a.fk = fk;
  a.fv = fv;
  a.kv_pos = static_cast<const int*>(kv_pos);
  a.pacc = static_cast<float*>(pacc);
  a.pm = static_cast<float*>(pm);
  a.pl = static_cast<float*>(pl);
  a.B = B;
  a.KVH = KVH;
  a.M = M;
  a.S = S;
  a.layer = layer;
  a.CS = CS;
  a.NC = (S + CS - 1) / CS;
  a.scale = 1.0f / sqrtf((float)hd);
  cudaError_t e;
  if (hd == 64)
    e = launch_kvt<2>(kvt, a, st);
  else
    e = launch_kvt<4>(kvt, a, st);
  if (e != cudaSuccess) return (int)e;
  attn_merge_kernel<<<B * KVH * M, 128, 0, st>>>(a.pacc, a.pm, a.pl,
                                                 static_cast<float*>(out), KVH,
                                                 M, a.NC, hd);
  return (int)cudaGetLastError();
}

const char* calm_attn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
