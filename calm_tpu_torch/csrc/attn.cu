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
// Paged mode replaces the same kernel's paged grid (pallas_attn.py:168-174,
// :203-211, :247-248): the cache is a page pool (L, P, KVH, PR, hd) and
// logical row s of slot b lives at page pt[b, s / PR], row s % PR. The
// grid stays (chunk, kv head, slot); only the row address changes, one
// page-table load and one divide per row against the row's 256-512 bytes.
// So any PR that divides the window works (the TPU's >= 512-row pages are
// a Mosaic DMA size, not a need of this card), chunks past kv_len still
// exit before reading, and dead page-table entries (they point at the
// slot's page 0 or at the parking page) lie past kv_len and are never read.
//
// What bounds it on an H100: the cache bytes, 2 * KVH * kv_len * hd *
// bytes per (b, layer); the arithmetic is ~2 * M flops per cache value.
// At the serving shape (8 slots at kv_len 4096, 8 kv heads, hd 128, bf16)
// that is 134 MB, 0.040 ms at 3350 GB/s, paged or dense.
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
//
// Partials mode replaces _attn_kernel_partials (pallas_attn.py:57, outputs
// :284-287): the merge folds the chunks into one unnormalised state per
// query row, acc (not divided by l), m (the max of the scaled scores) and
// l, in JAX's convention: a row with nothing visible gives m = -inf, l = 0,
// acc = 0. Sequence-parallel decode closes it across shards with one pmax
// and two psums (calm_tpu/model.py:557-576). Like JAX it takes neither the
// fresh rows nor a page table.
//
// Head dims 64, 96, 128 and 256 (HPL = hd / 32 elements a lane). A block
// holds at most MM query rows of its kv head in registers (16, or 8 at
// HPL 8, where 16 rows of q and acc would pass 255 registers); a kv head
// with more rows than that takes several row tiles, one a grid z index,
// each reading the same cache rows.

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
  const void* k;          // (L, NP, KVH, PR, hd): NP = B, PR = S when dense
  const void* v;
  const int* kv_len;      // (B,)
  const void* fk;         // fresh mode: (B, KVH, hd) in the cache dtype
  const void* fv;
  const int* kv_pos;      // fresh mode: (B,) stale row
  const int* pt;          // paged mode: (B, S / PR) page table
  float* pacc;            // (B, KVH, NC, M, hd)
  float* pm;              // (B, KVH, NC, M)
  float* pl;
  int B, KVH, M, S, layer, CS, NC, NP, PR;  // S: the logical window
  int NT;                 // row tiles of MM rows per kv head
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

// MM: compile-time bound on the rows of one tile (registers hold MM query
// rows); PAGED: rows addressed through the page table
template <int HPL, int KVT, int MM, bool PAGED>
__global__ void __launch_bounds__(AWARPS * 32) attn_chunk_kernel(AttnArgs a) {
  constexpr int HD = HPL * 32;
  const int c = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / a.NT, m0 = (blockIdx.z % a.NT) * MM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = a.M, Mt = min(MM, M - m0);  // this tile's rows m0 .. m0 + Mt
  const int kv_len = a.kv_len[b];
  const int dead = a.kv_pos ? a.kv_pos[b] : -1;
  const size_t pidx = ((size_t)b * a.KVH + h) * a.NC + c;
  const size_t prow = pidx * M + m0;  // the tile's first row of pm / pl

  const int s0 = c * a.CS;
  const int s1 = min(min(s0 + a.CS, kv_len), a.S);
  const bool seed = a.fk != nullptr && c == 0;
  if (s0 >= s1 && !seed) {  // nothing of this chunk is visible
    for (int i = threadIdx.x; i < Mt; i += blockDim.x) {
      a.pm[prow + i] = -INFINITY;
      a.pl[prow + i] = 0.f;
    }
    for (int i = threadIdx.x; i < Mt * HD; i += blockDim.x)
      a.pacc[prow * HD + i] = 0.f;
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
      qr[m][i] = m < Mt
          ? a.q[(((size_t)b * a.KVH + h) * M + m0 + m) * HD + i * 32 + lane]
          : 0.f;
    }
  }

  if (seed && warp == 0) {
    const size_t off = ((size_t)b * a.KVH + h) * HD;
    attend_row<HPL, KVT, MM>(a.fk, a.fv, off, lane, Mt, qr, mrun, lrun, acc, a.scale);
  }
  const size_t plane =
      ((((size_t)a.layer * a.NP + b) * a.KVH + h) * (size_t)a.S) * HD;
  const int* ptb = PAGED ? a.pt + (size_t)b * (a.S / a.PR) : nullptr;
  for (int s = s0 + warp; s < s1; s += AWARPS) {
    if (s == dead) continue;
    size_t off;
    if (PAGED) {
      const size_t page = (size_t)a.layer * a.NP + ptb[s / a.PR];
      off = ((page * a.KVH + h) * a.PR + s % a.PR) * HD;
    } else {
      off = plane + (size_t)s * HD;
    }
    attend_row<HPL, KVT, MM>(a.k, a.v, off, lane, Mt, qr, mrun, lrun, acc, a.scale);
  }

  // merge the warps' states: sm = [AWARPS][Mt][HD + 2]
  extern __shared__ float sm[];
  const int stride = HD + 2;
#pragma unroll
  for (int m = 0; m < MM; m++) {
    if (m < Mt) {
      float* row = sm + (warp * Mt + m) * stride;
#pragma unroll
      for (int i = 0; i < HPL; i++) row[i * 32 + lane] = acc[m][i];
      if (lane == 0) {
        row[HD] = mrun[m];
        row[HD + 1] = lrun[m];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Mt * HD; t += blockDim.x) {
    const int m = t / HD, d = t % HD;
    float mx = -INFINITY;
    for (int w = 0; w < AWARPS; w++) mx = fmaxf(mx, sm[(w * Mt + m) * stride + HD]);
    float o = 0.f, l = 0.f;
    if (mx != -INFINITY) {
      for (int w = 0; w < AWARPS; w++) {
        const float* row = sm + (w * Mt + m) * stride;
        const float f = expf(row[HD] - mx);
        o += row[d] * f;
        l += row[HD + 1] * f;
      }
    }
    a.pacc[prow * HD + t] = o;
    if (d == 0) {
      a.pm[prow + m] = mx;
      a.pl[prow + m] = l;
    }
  }
}

// out (B, KVH * M, hd) = merged, normalised chunks; one block per (b, head).
// Partials mode (mo != null): out = the merged acc, not divided by l, and
// mo / lo (B, KVH * M) = the merged max and sum.
__global__ void attn_merge_kernel(const float* pacc, const float* pm,
                                  const float* pl, float* out, float* mo,
                                  float* lo, int KVH, int M, int NC, int HD) {
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
    if (mo == nullptr) {
      out[(size_t)bh * HD + d] = o / l;
    } else {
      out[(size_t)bh * HD + d] = o;
      if (d == 0) {
        mo[bh] = mx;
        lo[bh] = l;
      }
    }
  }
}

template <int HPL, int KVT, int MM, bool PAGED>
cudaError_t launch_chunks(const AttnArgs& a, cudaStream_t st) {
  const int smem = AWARPS * min(a.M, MM) * (HPL * 32 + 2) * (int)sizeof(float);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(attn_chunk_kernel<HPL, KVT, MM, PAGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  AttnArgs t = a;
  t.NT = (a.M + MM - 1) / MM;
  dim3 grid(a.NC, a.KVH, a.B * t.NT);
  attn_chunk_kernel<HPL, KVT, MM, PAGED><<<grid, AWARPS * 32, smem, st>>>(t);
  return cudaGetLastError();
}

// the rows of a tile: as few as M needs, at most MAXM (8 at HPL 8)
template <int HPL, int KVT, bool PAGED>
cudaError_t launch_m(const AttnArgs& a, cudaStream_t st) {
  constexpr int CAP = HPL >= 8 ? 8 : MAXM;
  if (a.M <= 4) return launch_chunks<HPL, KVT, 4, PAGED>(a, st);
  if (a.M <= 8 || CAP == 8) return launch_chunks<HPL, KVT, 8, PAGED>(a, st);
  return launch_chunks<HPL, KVT, CAP, PAGED>(a, st);
}

template <int HPL, bool PAGED>
cudaError_t launch_kvt(int kvt, const AttnArgs& a, cudaStream_t st) {
  if (kvt == 0) return launch_m<HPL, 0, PAGED>(a, st);
  if (kvt == 1) return launch_m<HPL, 1, PAGED>(a, st);
  return launch_m<HPL, 2, PAGED>(a, st);
}

template <int HPL>
cudaError_t launch_paged(int kvt, const AttnArgs& a, cudaStream_t st) {
  return a.pt ? launch_kvt<HPL, true>(kvt, a, st) : launch_kvt<HPL, false>(kvt, a, st);
}

// ---------------------------------------------------------------------------
// Prefill: causal flash attention of T queries against the carried cache.
//
// Replaces calm_tpu/ops/pallas_attn.py:_prefill_kernel (:326), reached
// through prefill_attention (:463). Query t of sequence b sits at absolute
// position pos0[b] + t and sees cache rows col < kv_len[b] and
// col <= pos0[b] + t (the T fresh rows are written into the cache first).
//
// What bounds it on an H100: the tensor cores, ~4 * H * hd * T * kv / 2
// flops per (b, layer) against ~2 * KVH * kv * hd cache bytes; at T = 2048
// it does ~170 flops per byte read from the cache by each of the T / 16
// query blocks, so device memory is not the limit.
//
// Design: a block per (query tile, kv head, b). The T * M (query, head)
// rows of a kv head are numbered R = t * M + m and a block takes 64 of
// them (row R = query R / M, head R % M), so the heads of a query share
// the staged cache tiles, as the TPU kernel packs them (:340-342), and
// any M fits: a query's heads may span two blocks. Four warps own 16 rows each. The block
// walks 64-row cache tiles from 0 to its own causal limit, a pure loop:
// blocks run in no order and carry nothing between them. Each tile is
// staged into shared memory as bf16 (bf16 and fp8 e5m2 exactly, fp16
// rounded); S = Q K^T and O += P V run on mma.sync m16n8k16 with f32 sums,
// V read with ldmatrix.trans. q and p are rounded once to bf16, as the
// TPU kernel rounds them (:355-360, 383). Online softmax in registers, in
// base 2; a row with nothing visible yet keeps m = -inf and its shift is
// clamped to 0 (:374-378), and the end divides by max(l, 1e-37) (:390).

#define PF_WARPS 4
#define PF_ROWS (PF_WARPS * 16)  // query rows (t, head) per block
#define PF_BC 64                 // cache rows per tile

struct PfArgs {
  const float* q;      // (B, T, KVH, M, hd)
  const void* k;       // (L, B, KVH, S, hd)
  const void* v;
  const int* pos0;     // (B,)
  const int* kv_len;   // (B,)
  float* out;          // (B, T, KVH, M, hd)
  int B, T, KVH, M, S, layer, Bc, boff;  // cache slots, first slot read
  float scale_log2;    // log2(e) / sqrt(hd)
};

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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// eight cache values from element i of a cache plane -> eight bf16
template <int KVT>
__device__ __forceinline__ uint4 kv_bf16x8(const void* base, size_t i);

template <>
__device__ __forceinline__ uint4 kv_bf16x8<0>(const void* base, size_t i) {  // fp16
  const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __half*>(base) + i);
  const uint32_t* h = reinterpret_cast<const uint32_t*>(&raw);
  uint4 o;
  uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(h + j));
    op[j] = pack_bf16(f.x, f.y);
  }
  return o;
}
template <>
__device__ __forceinline__ uint4 kv_bf16x8<1>(const void* base, size_t i) {  // bf16
  return *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + i);
}
template <>
__device__ __forceinline__ uint4 kv_bf16x8<2>(const void* base, size_t i) {  // e5m2
  const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(base) + i);
  const uint8_t* b8 = reinterpret_cast<const uint8_t*>(&raw);
  uint4 o;
  uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int j = 0; j < 4; j++) {  // e5m2 -> f16 (exact) -> bf16 (exact)
    const float lo = __half2float(__ushort_as_half((unsigned short)(b8[2 * j] << 8)));
    const float hi = __half2float(__ushort_as_half((unsigned short)(b8[2 * j + 1] << 8)));
    op[j] = pack_bf16(lo, hi);
  }
  return o;
}

template <int HD>
constexpr int prefill_smem() {  // q, K, V tiles of bf16
  return (PF_ROWS + 2 * PF_BC) * (HD + 8) * 2;
}

template <int HD, int KVT>
__global__ void __launch_bounds__(PF_WARPS * 32) prefill_kernel(PfArgs a) {
  constexpr int LD = HD + 8;  // bf16 per shared row: 16-byte aligned, no conflicts
  constexpr int KS = HD / 16;
  extern __shared__ __align__(16) unsigned char pf_raw[];
  auto sQ = reinterpret_cast<__nv_bfloat16(*)[LD]>(pf_raw);
  auto sK = sQ + PF_ROWS;
  auto sV = sK + PF_BC;

  const int h = blockIdx.y, b = blockIdx.z;
  const int M = a.M, TM = a.T * M;
  const int R0 = blockIdx.x * PF_ROWS;  // the block's first (query, head) row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pos0 = a.pos0[b];
  const int kv_len = min(a.kv_len[b], a.S);
  const int t_last = (min(R0 + PF_ROWS, TM) - 1) / M;
  const int c_end = min(kv_len, pos0 + t_last + 1);  // rows any query here sees

  // the block's query rows in bf16 (zeros past the end)
  for (int i = threadIdx.x; i < PF_ROWS * HD / 4; i += PF_WARPS * 32) {
    const int r = i / (HD / 4), c4 = (i % (HD / 4)) * 4;
    const int R = R0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (R < TM)
      v = *reinterpret_cast<const float4*>(
          a.q + ((((size_t)b * a.T + R / M) * a.KVH + h) * M + R % M) * HD + c4);
    *reinterpret_cast<uint2*>(&sQ[r][c4]) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }

  // this thread's two rows: g and g + 8 of the warp's 16
  int qpos[2];
  float* orow[2];
#pragma unroll
  for (int i = 0; i < 2; i++) {
    const int R = R0 + warp * 16 + g + 8 * i;
    const bool ok = R < TM;
    qpos[i] = ok ? pos0 + R / M : -1;  // -1 sees nothing
    orow[i] = ok ? a.out + ((((size_t)b * a.T + R / M) * a.KVH + h) * M + R % M) * HD
                 : nullptr;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; i++) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  const size_t plane =
      (((size_t)a.layer * a.Bc + a.boff + b) * a.KVH + h) * (size_t)a.S * HD;
  const int qr = warp * 16 + g;
  for (int c0 = 0; c0 < c_end; c0 += PF_BC) {
    __syncthreads();  // q staged; every warp is done with the previous tile
    for (int i = threadIdx.x; i < PF_BC * HD / 8; i += PF_WARPS * 32) {
      const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (c0 + r < c_end) {  // rows past the limit stay 0: 0 * garbage is NaN
        const size_t e = plane + (size_t)(c0 + r) * HD + c8;
        kk = kv_bf16x8<KVT>(a.k, e);
        vv = kv_bf16x8<KVT>(a.v, e);
      }
      *reinterpret_cast<uint4*>(&sK[r][c8]) = kk;
      *reinterpret_cast<uint4*>(&sV[r][c8]) = vv;
    }
    __syncthreads();

    float s[PF_BC / 8][4];
#pragma unroll
    for (int nt = 0; nt < PF_BC / 8; nt++) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ks++) {
      uint32_t qa[4];
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const int row = qr + 8 * (j & 1), col = ks * 16 + t4 * 2 + 8 * (j >> 1);
        qa[j] = *reinterpret_cast<const uint32_t*>(&sQ[row][col]);
      }
#pragma unroll
      for (int nt = 0; nt < PF_BC / 8; nt++) {
        uint32_t kb[2];
        kb[0] = *reinterpret_cast<const uint32_t*>(&sK[nt * 8 + g][ks * 16 + t4 * 2]);
        kb[1] = *reinterpret_cast<const uint32_t*>(&sK[nt * 8 + g][ks * 16 + t4 * 2 + 8]);
        mma_bf16(s[nt], qa, kb);
      }
    }

    // mask, then the online softmax of rows g (i = 0) and g + 8 (i = 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < PF_BC / 8; nt++) {
#pragma unroll
      for (int e = 0; e < 4; e++) {
        const int i = e >> 1;
        const int col = c0 + nt * 8 + t4 * 2 + (e & 1);
        const bool ok = col < kv_len && col <= qpos[i];
        s[nt][e] = ok ? s[nt][e] * a.scale_log2 : -INFINITY;
        mx[i] = fmaxf(mx[i], s[nt][e]);
      }
    }
    float shift[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; i++) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(mrow[i], mx[i]);
      shift[i] = mn == -INFINITY ? 0.f : mn;
      alpha[i] = mrow[i] == -INFINITY ? 0.f : exp2f(mrow[i] - shift[i]);
      mrow[i] = mn;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < PF_BC / 8; nt++) {
#pragma unroll
      for (int e = 0; e < 4; e++) {
        s[nt][e] = exp2f(s[nt][e] - shift[e >> 1]);  // -inf -> 0
        ls[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; i++) lrow[i] = lrow[i] * alpha[i] + ls[i];  // partial: 1/4 of the row
#pragma unroll
    for (int nt = 0; nt < HD / 8; nt++) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A operand's (two n-tiles
    // make one k16 step); V arrives transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < PF_BC / 16; kk++) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mi = lane >> 3;
      const int vr = kk * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int nt = 0; nt < HD / 8; nt += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, &sV[vr][nt * 8 + (mi >> 1) * 8]);
        mma_bf16(o[nt], pa, vb);
        mma_bf16(o[nt + 1], pa, vb + 2);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; i++) {
    float l = lrow[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-37f);
    if (orow[i] == nullptr) continue;
#pragma unroll
    for (int nt = 0; nt < HD / 8; nt++)
      *reinterpret_cast<float2*>(orow[i] + nt * 8 + t4 * 2) =
          make_float2(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
  }
}

template <int HD, int KVT>
cudaError_t launch_prefill_kvt(const PfArgs& a, dim3 grid, cudaStream_t st) {
  constexpr int smem = prefill_smem<HD>();
  static cudaError_t attr = cudaFuncSetAttribute(
      prefill_kernel<HD, KVT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  prefill_kernel<HD, KVT><<<grid, PF_WARPS * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_prefill(int kvt, const PfArgs& a, cudaStream_t st) {
  dim3 grid((a.T * a.M + PF_ROWS - 1) / PF_ROWS, a.KVH, a.B);
  if (kvt == 0) return launch_prefill_kvt<HD, 0>(a, grid, st);
  if (kvt == 1) return launch_prefill_kvt<HD, 1>(a, grid, st);
  return launch_prefill_kvt<HD, 2>(a, grid, st);
}

}  // namespace

extern "C" {

// kvt: 0 fp16, 1 bf16, 2 fp8 e5m2; hd in {64, 96, 128, 256}; any M.
// fk/fv/kv_pos null for plain mode. pt null for a dense cache (NP = B
// slots of S rows), else the (B, S / PR) page table of a pool of NP pages
// of PR rows (S: the logical window). Scratch pacc/pm/pl sized by the
// caller for NC = ceil(S / CS) chunks. mo/lo null for the normalised
// output; else partials mode: out = acc, mo/lo (B, KVH * M) = m and l.
int calm_decode_attention(const void* q, const void* k, const void* v,
                          const void* kv_len, const void* fk, const void* fv,
                          const void* kv_pos, const void* pt, void* pacc,
                          void* pm, void* pl, void* out, void* mo, void* lo,
                          int B, int KVH, int M, int S, int hd, int layer,
                          int CS, int kvt, int NP, int PR, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  AttnArgs a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.kv_len = static_cast<const int*>(kv_len);
  a.fk = fk;
  a.fv = fv;
  a.kv_pos = static_cast<const int*>(kv_pos);
  a.pt = static_cast<const int*>(pt);
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
  a.NP = NP;
  a.PR = PR;
  a.NT = 1;
  a.scale = 1.0f / sqrtf((float)hd);
  cudaError_t e;
  switch (hd) {
    case 64: e = launch_paged<2>(kvt, a, st); break;
    case 96: e = launch_paged<3>(kvt, a, st); break;
    case 128: e = launch_paged<4>(kvt, a, st); break;
    case 256: e = launch_paged<8>(kvt, a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  attn_merge_kernel<<<B * KVH * M, 128, 0, st>>>(
      a.pacc, a.pm, a.pl, static_cast<float*>(out), static_cast<float*>(mo),
      static_cast<float*>(lo), KVH, M, a.NC, hd);
  return (int)cudaGetLastError();
}

// q/out (B, T, KVH, M, hd) f32, caches (L, Bc, KVH, S, hd) in kvt (0 fp16,
// 1 bf16, 2 fp8 e5m2) of which sequence b reads slot boff + b, pos0/kv_len
// (B,) int32; hd in {64, 96, 128, 256}; any M.
int calm_prefill_attention(const void* q, const void* k, const void* v,
                           const void* pos0, const void* kv_len, void* out,
                           int B, int T, int KVH, int M, int S, int hd,
                           int layer, int kvt, int Bc, int boff, void* stream) {
  PfArgs a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.pos0 = static_cast<const int*>(pos0);
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.T = T;
  a.KVH = KVH;
  a.M = M;
  a.S = S;
  a.layer = layer;
  a.Bc = Bc;
  a.boff = boff;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: return (int)launch_prefill<64>(kvt, a, st);
    case 96: return (int)launch_prefill<96>(kvt, a, st);
    case 128: return (int)launch_prefill<128>(kvt, a, st);
    case 256: return (int)launch_prefill<256>(kvt, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* calm_attn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
