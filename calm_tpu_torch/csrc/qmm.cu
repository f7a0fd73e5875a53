// Dequantizing matvecs over layer-stacked fp8-e5m2 / fp16 weights and
// natural gf4 words, for decode (B <= 16 activation rows).
//
// Replaces three Pallas kernels of calm_tpu/ops/pallas_qmm.py:
//   - _layered_qmm_kernel (:92, via qmm_decode :219): y = x . W[layer]^T
//     -> calm_qmm_decode below;
//   - _qx_offn_qkv_kernel (:942, via qx_offn_qkv :1198): one layer's
//     epilogue, wo + residual, ffn-norm, w1/w3 + act, w2 + residual, and
//     the next layer's attn-norm + q/k/v -> calm_qx_offn_qkv below, six
//     launches from this file with no torch op between them;
//   - _gf4_offn_qkv_kernel (:737, via gf4_offn_qkv :927): the same
//     epilogue on gf4 weights, which the TPU reads in plane-permuted
//     layouts for Mosaic -> calm_qx_offn_qkv with fmt 2 on natural words.
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
// __byte_perm. Activations (up to 16 rows of 14336 f32 = 917 KB for w2)
// stay in global memory, read through the read-only path, and are
// L1/L2-resident across the rows of a block. A gf4 word holds eight
// weights (a lane step reads one word and two float4 of x) and decodes as
// in gf4.cu: the 3-bit codes exactly through the mantissa of 2^23, one
// scale multiply per word. Accumulation is f32 per activation row, sized
// by B at compile time (1, 4 or 16); a warp-shuffle tree closes each row. The attn- and ffn-norms run as a one-block-per-row
// launch that writes the normalised rows to scratch, so the w1/w3 and
// q/k/v matvecs share the plain inner loop instead of each block
// recomputing row statistics and normalising x per weight.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAXB 16
#define WARPS 8

namespace {

struct Seg {
  const uint8_t* w;    // (rows, n / PER) words of this segment's weight
  const uint8_t* w3;   // dual mode: the w3 weight (same shape), else null
  float* out;          // out[b * ld + r]
  const float* resid;  // optional: out = resid + y, resid[b * ld + r]
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

// FMT 0: fp16, 1: fp8 e5m2, 2: gf4. Word: the load that holds PER weights;
// dec() turns it into Dec, dot() multiplies Dec by the PER values of x held
// in PER / 4 float4 registers.
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
struct Gf4Dec {
  float c[8];  // code_k - 4
  float s;     // e5m2 scale / -4
};
template <>
struct Fmt<2> {
  using Word = uint32_t;
  using Dec = Gf4Dec;
  static constexpr int PER = 8;
  static __device__ __forceinline__ Dec dec(uint32_t q) {
    Dec d;
#pragma unroll
    for (int k = 0; k < 8; k++)  // the 3-bit field under the mantissa of 2^23
      d.c[k] = __uint_as_float(0x4B000000u | ((q >> (8 + 3 * k)) & 7u)) - 8388612.0f;
    // the e5m2 byte in the high half of an f16 is the same value, exactly
    d.s = __half2float(__ushort_as_half((unsigned short)((q & 0xffu) << 8))) * -0.25f;
    return d;
  }
  static __device__ __forceinline__ float dot(const Dec& w, const float4* x) {
    const float4 xa = x[0], xb = x[1];
    float s = w.c[0] * xa.x;
    s = fmaf(w.c[1], xa.y, s);
    s = fmaf(w.c[2], xa.z, s);
    s = fmaf(w.c[3], xa.w, s);
    s = fmaf(w.c[4], xb.x, s);
    s = fmaf(w.c[5], xb.y, s);
    s = fmaf(w.c[6], xb.z, s);
    s = fmaf(w.c[7], xb.w, s);
    return s * w.s;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

#define NORM_THREADS 1024
#define NORM_VEC 4  // float4s per thread: rows of up to 16384 values

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

// out[b] = (x[b] - mu) * rsqrt(mean((x[b] - mu)^2) + eps) * g, with mu the
// row mean when sub_mean and 0 otherwise; one block per row, the row held
// in registers between the two reductions. n % 4 == 0, n <= 16384.
__global__ void __launch_bounds__(NORM_THREADS)
    norm_kernel(const float* x, const float* g, float* out, int n, float eps,
                int sub_mean) {
  __shared__ float red[NORM_THREADS / 32];
  const int n4 = n >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)blockIdx.x * n);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* o4 = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * n);
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
    if (c < n4) {
      const float4 gv = g4[c];
      o4[c] = make_float4((v[k].x - mu) * rs * gv.x, (v[k].y - mu) * rs * gv.y,
                          (v[k].z - mu) * rs * gv.z, (v[k].w - mu) * rs * gv.w);
    }
  }
}

// ACT: 0 plain matvec, 1 dual SiLU (h = silu(x.w1) * x.w3), 2 dual tanh-GELU.
// NB: compile-time bound on B (accumulator registers).
template <int FMT, int ACT, int NB>
__global__ void __launch_bounds__(WARPS * 32, NB == 1 ? 4 : 1) qmv_kernel(Args a) {
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
  const int n4 = a.n >> 2;      // float4s per row of x
  const Word* wr = reinterpret_cast<const Word*>(sg.w) + (size_t)row * nw;
  const Word* wr3 = ACT ? reinterpret_cast<const Word*>(sg.w3) + (size_t)row * nw : nullptr;
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  float acc[NB], acc3[NB];
#pragma unroll
  for (int b = 0; b < NB; b++) acc[b] = acc3[b] = 0.f;

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
        const typename F::Dec w3 = ACT ? F::dec(q3[u]) : w;
#pragma unroll
        for (int b = 0; b < NB; b++) {
          if (b < a.B) {
            const float4* xp = x4 + (size_t)b * n4 + (size_t)c * XV;
            float4 xv[XV];
#pragma unroll
            for (int i = 0; i < XV; i++) xv[i] = __ldg(xp + i);
            acc[b] += F::dot(w, xv);
            if (ACT) acc3[b] += F::dot(w3, xv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; b++) {
    if (b < a.B) {
      float y = warp_sum(acc[b]);
      if (ACT) {
        const float h3 = warp_sum(acc3[b]);
        if (ACT == 1) {
          y = y * (1.0f / (1.0f + expf(-y)));
        } else {
          const float ga = 0.7978845608028654f;  // sqrt(2/pi)
          y = 0.5f * y * (1.0f + tanhf(ga * (y + 0.044715f * y * y * y)));
        }
        y *= h3;
      }
      if (lane == 0) {
        const size_t o = (size_t)b * sg.ld + row;
        sg.out[o] = sg.resid ? sg.resid[o] + y : y;
      }
    }
  }
}

template <int FMT, int ACT>
cudaError_t launch(const Args& a, cudaStream_t st) {
  int rows = 0;
  for (int s = 0; s < a.nseg; s++) rows += a.seg[s].rows;
  const int grid = (rows + WARPS - 1) / WARPS;
  if (a.B <= 1)
    qmv_kernel<FMT, ACT, 1><<<grid, WARPS * 32, 0, st>>>(a);
  else if (a.B <= 4)
    qmv_kernel<FMT, ACT, 4><<<grid, WARPS * 32, 0, st>>>(a);
  else
    qmv_kernel<FMT, ACT, MAXB><<<grid, WARPS * 32, 0, st>>>(a);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_fmt(int fmt, const Args& a, cudaStream_t st) {
  if (fmt == 2) return launch<2, ACT>(a, st);
  return fmt == 1 ? launch<1, ACT>(a, st) : launch<0, ACT>(a, st);
}

cudaError_t launch_norm(const void* x, const void* g, void* out, int B, int n,
                        float eps, int sub_mean, cudaStream_t st) {
  norm_kernel<<<B, NORM_THREADS, 0, st>>>(static_cast<const float*>(x),
                                        static_cast<const float*>(g),
                                        static_cast<float*>(out), n, eps,
                                        sub_mean);
  return cudaGetLastError();
}

Seg seg(const void* w, const void* w3, void* out, const void* resid, int rows,
        int ld) {
  Seg s;
  s.w = static_cast<const uint8_t*>(w);
  s.w3 = static_cast<const uint8_t*>(w3);
  s.out = static_cast<float*>(out);
  s.resid = static_cast<const float*>(resid);
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

}  // namespace

extern "C" {

// y (B, d) = x (B, n) . W^T for W (d, n) in fp16 (fmt 0) or fp8 e5m2
// (fmt 1); w points at the layer's plane.
int calm_qmm_decode(const void* x, const void* w, void* y, int B, int d, int n,
                    int fmt, void* stream) {
  Args a = args(x, B, n);
  a.seg[0] = seg(w, nullptr, y, nullptr, d, d);
  return (int)launch_fmt<0>(fmt, a, (cudaStream_t)stream);
}

// One layer's epilogue (see pallas_qmm._qx_offn_qkv_kernel), for fp16
// (fmt 0), fp8 e5m2 (1) or gf4 words (2). Weight pointers are at their
// layer planes (wq/wk/wv and anx already at
// min(layer + 1, L - 1)). r1 (B, D), xn (B, D) and h (B, H) are
// caller-allocated scratch; qkv is (B, Qd + 2 KVd) with q, k and v side by
// side.
int calm_qx_offn_qkv(const void* a, const void* r, const void* g,
                     const void* anx, const void* wo, const void* w1,
                     const void* w3, const void* w2, const void* wq,
                     const void* wk, const void* wv, void* r1, void* xn,
                     void* h, void* x, void* qkv, int B, int D, int H, int Qd,
                     int KVd, int fmt, int act_gelu, float eps, int sub_mean,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;

  Args s1 = args(a, B, Qd);  // r1 = r + a . wo^T
  s1.seg[0] = seg(wo, nullptr, r1, r, D, D);
  if ((e = launch_fmt<0>(fmt, s1, st)) != cudaSuccess) return (int)e;

  // h = act(xn . w1^T) * (xn . w3^T), xn = ffn-norm(r1)
  if ((e = launch_norm(r1, g, xn, B, D, eps, sub_mean, st)) != cudaSuccess)
    return (int)e;
  Args s2 = args(xn, B, D);
  s2.seg[0] = seg(w1, w3, h, nullptr, H, H);
  e = act_gelu ? launch_fmt<2>(fmt, s2, st) : launch_fmt<1>(fmt, s2, st);
  if (e != cudaSuccess) return (int)e;

  Args s3 = args(h, B, H);  // x = r1 + h . w2^T
  s3.seg[0] = seg(w2, nullptr, x, r1, D, D);
  if ((e = launch_fmt<0>(fmt, s3, st)) != cudaSuccess) return (int)e;

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
  return (int)launch_fmt<0>(fmt, s4, st);
}

const char* calm_qmm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
