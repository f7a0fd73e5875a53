// Flash-decode attention over the layer-stacked, head-major KV cache
// (L, B, KVH, S, hd) in bf16, fp16 or fp8 e5m2.
//
// Replaces calm_tpu/ops/pallas_attn.py:_attn_body (:77) in its plain
// (_attn_kernel :49), fresh (_attn_kernel_fresh :69) and partials
// (_attn_kernel_partials :57) modes and its paged grid (:168-174,
// :203-211), reached through decode_attention (:291). Each of the M = H /
// KVH query rows of a kv head attends the cache rows s < kv_len[b] of slot
// batch_off + b with scale 1/sqrt(hd). In fresh mode the current token's
// K/V (already in the cache dtype) join the softmax, seeding it as JAX's
// block 0 does, and the stale cache row kv_pos[b] (the row a rolled window
// is about to overwrite) is masked out. Paged mode reads logical row s of
// slot b from page pt[b, s / PR], row s % PR, of a pool (L, P, KVH, PR,
// hd). Partials mode returns the unnormalised state in JAX's convention:
// acc (not divided by l), m (the max of the scaled scores) and l; a row
// with nothing visible gives m = -inf, l = 0, acc = 0.
//
// What bounds it on an H100: the cache bytes, 2 * KVH * kv_len * hd *
// bytes per (b, layer); at M = 4 query rows a kv head the arithmetic is
// ~4 flops per cache byte, far below the card's f32 rate. At the serving
// shape (8 slots at kv_len 4096, 8 kv heads, hd 128, bf16) that is 134 MB,
// 0.040 ms at 3350 GB/s, paged or dense. So the design is about keeping
// enough cache bytes in flight: ~16-20 KB an SM at ~0.7 us of latency.
//
// Design:
// - Split S. A block owns one (chunk of CS rows, kv head, slot and row
//   tile of MM query rows). The chunk plan (ops/hopper_attn.decode_plan)
//   aims at two blocks an SM in one resident wave, or at one block an SM
//   when two would leave chunks shorter than four tiles (a short window's
//   chunk folds cost more than their rows), and never depends on kv_len or
//   the page size, so paged and dense mode sum in the same order.
// - Tiles of TR cache rows (64, or 32 at hd 256) of K and of V, copied
//   into shared memory with 16-byte cp.async in the cache dtype (rows
//   padded 16 bytes, so the reads below are free of bank conflicts), ~35
//   KB a tile at hd 128 in bf16, double-buffered: the next tile's copies
//   fly while one is computed. One tile ahead measured faster than two or
//   three at B=1 and B=8 alike: with every SM queueing one tile, each
//   SM's next tile lands sooner, and one tile still covers an SM's share
//   of the bandwidth. A block asks for DA_SMEM_FLOOR of shared memory at
//   least, which holds the resident blocks at two an SM (a third would
//   unbalance the plan's one wave). The first copies go out before q is
//   staged, and the fresh row is loaded beside them.
// - One softmax step a tile, not a row: the block computes the tile's
//   scores at once (thread = row x part of hd, q broadcast from shared
//   memory, f32 FMA in two chains a query row), then one warp a query row
//   takes the tile's max, rescales (m, l) once and writes p; the P.V step
//   gives each thread an 8-column chunk of every eighth row and all the
//   tile's query rows, f32 FMA.
// - Paged mode: one page-table lookup a tile when pages are a multiple of
//   the tile (tiles never straddle them), else a lookup a row (pages of 16
//   or 32 rows: the rows of one page read the same entry).
// - The chunks merge in the same launch: each block writes its state
//   (acc, m, l) to the wrapper's workspace; the last block of each group,
//   found by an atomic ticket that it resets itself (one acquire-release
//   atomic a block, by thread 0 after the block's barrier), folds the live
//   chunks in chunk order (one max, weights in shared memory, then every
//   chunk's loads in flight at once) and writes the output, normalised or
//   as partials.
//   Chunks past kv_len read nothing and write nothing; they only take
//   their ticket.
// Head dims 64, 96, 128 and 256; a kv head with more than MM query rows
// (4, or 8 past 4) takes several row tiles, each reading the same rows.
// Instantiations: 4 head dims x 3 cache dtypes x 2 row tiles x paged or
// not = 48.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

#define DA_THREADS 128
#define DA_STAGES 2  // double buffer: the next tile's copies fly while one is computed
#define DA_SMEM_FLOOR (96 * 1024)  // shared memory a block asks for at least: two an SM
#define DA_MAX_CHUNKS 256  // the merge keeps one weight a chunk in shared memory

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one cache value (0: fp16, 1: bf16, 2: fp8 e5m2) -> f32
template <int KVT>
__device__ __forceinline__ float kv_load(const void* base, size_t i) {
  if (KVT == 0) return __half2float(static_cast<const __half*>(base)[i]);
  if (KVT == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  const uint16_t bits = (uint16_t)static_cast<const uint8_t*>(base)[i] << 8;
  return __half2float(__ushort_as_half(bits));
}

// four bytes of e5m2 -> four f32 (each byte is the high half of an f16)
__device__ __forceinline__ void e5m2x4(uint32_t w, float* f) {
  const uint32_t lo = __byte_perm(w, 0u, 0x1404), hi = __byte_perm(w, 0u, 0x3424);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&lo));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&hi));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// two 16-bit values of one word -> two f32
template <int KVT>
__device__ __forceinline__ void w16x2(uint32_t w, float* f) {
  if (KVT == 1) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&w));
    f[0] = a.x; f[1] = a.y;
  }
}

// 16 bytes of shared memory -> 16 / bytes-per-value f32
template <int KVT>
__device__ __forceinline__ void cvt16(const unsigned char* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if (KVT == 2) {
    e5m2x4(u.x, f); e5m2x4(u.y, f + 4); e5m2x4(u.z, f + 8); e5m2x4(u.w, f + 12);
  } else {
    w16x2<KVT>(u.x, f); w16x2<KVT>(u.y, f + 2); w16x2<KVT>(u.z, f + 4); w16x2<KVT>(u.w, f + 6);
  }
}

// eight values of shared memory -> eight f32
template <int KVT>
__device__ __forceinline__ void cvt8(const unsigned char* p, float* f) {
  if (KVT == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    e5m2x4(u.x, f); e5m2x4(u.y, f + 4);
  } else {
    cvt16<KVT>(p, f);
  }
}

struct AttnArgs {
  const float* q;      // (B, KVH * M, hd)
  const void* k;       // (L, NP, KVH, PR, hd): NP >= boff + B slots, PR = S when dense
  const void* v;
  const int* kv_len;   // (B,)
  const void* fk;      // fresh mode: (B, KVH, hd) in the cache dtype
  const void* fv;
  const int* kv_pos;   // fresh mode: (B,) stale row
  const int* pt;       // paged mode: (B, S / PR) page table
  float* pacc;         // workspace (B, KVH, NT, NC, MM, hd)
  float* pm;           // (B, KVH, NT, NC, MM)
  float* pl;
  int* ticket;         // (B, KVH, NT), zero between launches
  float* out;          // (B, KVH * M, hd)
  float* mo;           // partials mode: (B, KVH * M) m and l, else null
  float* lo;
  int B, KVH, M, S, layer, CS, NC, NP, PR, pr_shift, NT, boff;
  float scale;
};

template <int HD, int KVT>
struct DaShape {
  static constexpr int ES = KVT == 2 ? 1 : 2;  // bytes a value
  static constexpr int TR = HD > 128 ? 32 : 64;  // cache rows a tile
  static constexpr int SPL = DA_THREADS / TR;  // score threads a row
  static constexpr int RS = HD * ES + 16;  // bytes a staged row: the pad spreads banks
  static constexpr int CPR = HD * ES / 16;  // 16-byte pieces a row
  static constexpr int EP = 16 / ES;  // values a piece
  static constexpr int SPP = CPR / SPL;  // pieces a score thread
  static constexpr int NCH = HD / 8;  // P.V: 8-column chunks
  static constexpr int RG = DA_THREADS / NCH;  // P.V: row groups
  static constexpr int TILE = TR * RS;
  static_assert(CPR % SPL == 0, "a row's pieces split evenly over its score threads");
};

// shared memory: the ring (reused by the row groups' sums and the merge's
// weights), then q, the score parts, p and the softmax state; a block asks
// for DA_SMEM_FLOOR at least, which holds the resident blocks at two an SM
// (a third would unbalance the one wave the plan makes)
template <int HD, int KVT, int MM>
__host__ __device__ constexpr int decode_region0() {
  using P = DaShape<HD, KVT>;
  constexpr int ring = DA_STAGES * 2 * P::TILE, red = P::RG * MM * HD * 4,
                merge = MM * (DA_MAX_CHUNKS + 2) * 4;
  constexpr int r = ring > red ? ring : red;
  return r > merge ? r : merge;
}

template <int HD, int KVT, int MM>
__host__ __device__ constexpr int decode_smem() {
  using P = DaShape<HD, KVT>;
  constexpr int need = decode_region0<HD, KVT, MM>() +
                       4 * (MM * HD + P::SPL * MM * P::TR + P::TR * MM + 3 * MM + 4);
  return need > DA_SMEM_FLOOR ? need : DA_SMEM_FLOOR;
}

template <int HD, int KVT, int MM, bool PAGED>
__global__ void __launch_bounds__(DA_THREADS) attn_decode_kernel(AttnArgs a) {
  using P = DaShape<HD, KVT>;
  constexpr int TR = P::TR, RS = P::RS, EP = P::EP, SPP = P::SPP, NCH = P::NCH,
                RG = P::RG, TILE = P::TILE, SPL = P::SPL;
  static_assert(MM % 4 == 0, "query rows a tile: a multiple of 4");
  extern __shared__ __align__(16) unsigned char da_smem[];
  unsigned char* ring = da_smem;  // [stage][K, V][TR][RS]
  float* sQ = reinterpret_cast<float*>(da_smem + decode_region0<HD, KVT, MM>());  // [MM][HD]
  float* sS = sQ + MM * HD;                            // [SPL][MM][TR] score parts
  float* sP = sS + SPL * MM * TR;                      // [TR][MM] probabilities
  float* sM = sP + TR * MM;                            // running max, sum, rescale
  float* sL = sM + MM;
  float* sA = sL + MM;
  int* sFlag = reinterpret_cast<int*>(sA + MM);

  const int c = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / a.NT, rt = blockIdx.z % a.NT, m0 = rt * MM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Mt = min(MM, a.M - m0);
  const int kv_len = min(a.kv_len[b], a.S);
  const bool fresh = a.fk != nullptr;
  const int s0 = c * a.CS, s1 = min(s0 + a.CS, kv_len);
  const size_t grp = ((size_t)b * a.KVH + h) * a.NT + rt;
  const size_t pidx = grp * a.NC + c;

  if (s0 < s1 || (fresh && c == 0)) {
    const size_t plane =
        ((((size_t)a.layer * a.NP + a.boff + b) * a.KVH + h) * (size_t)a.S) * HD;
    const int* ptb = PAGED ? a.pt + (size_t)b * (a.S / a.PR) : nullptr;
    auto row_off = [&](int s) -> size_t {  // element offset of logical row s
      if (!PAGED) return plane + (size_t)s * HD;
      const int blk = a.pr_shift >= 0 ? s >> a.pr_shift : s / a.PR;
      const int in = s - blk * a.PR;
      const size_t page = (size_t)a.layer * a.NP + ptb[blk];
      return ((page * a.KVH + h) * a.PR + in) * HD;
    };
    const int nt = s0 < s1 ? (s1 - s0 + TR - 1) / TR : 0;
    // one page-table lookup a tile where pages are whole tiles; else one a
    // row (pages of 16 or 32 rows: the rows of a page read one entry)
    const bool tile_in_page = !PAGED || (a.PR % TR) == 0;
    auto issue = [&](int kt) {  // tile kt into stage kt % DA_STAGES
      const int t0 = s0 + kt * TR, nr = min(TR, s1 - t0);
      unsigned char* dk = ring + (kt % DA_STAGES) * 2 * TILE;
      const char* gk = static_cast<const char*>(a.k);
      const char* gv = static_cast<const char*>(a.v);
      const size_t base = tile_in_page ? row_off(t0) : 0;
      for (int i = tid; i < nr * P::CPR; i += DA_THREADS) {
        const int r = i / P::CPR, p = i % P::CPR;
        const size_t off =
            (tile_in_page ? base + (size_t)r * HD : row_off(t0 + r)) * P::ES + p * 16;
        cp_async16(dk + r * RS + p * 16, gk + off);
        cp_async16(dk + TILE + r * RS + p * 16, gv + off);
      }
    };

    // the first tile's copies go out before anything else
    if (nt > 0) issue(0);
    cp_async_commit();

    const int dead = fresh ? a.kv_pos[b] : -1;
    const int pc = tid % NCH, pg = tid / NCH;  // P.V role: chunk, row group
    float fkr[HD / 32], fvr[8];  // the fresh row, in flight beside the copies
    if (fresh && c == 0) {
      const size_t fo = ((size_t)b * a.KVH + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 32; j++) fkr[j] = kv_load<KVT>(a.fk, fo + lane + 32 * j);
#pragma unroll
      for (int j = 0; j < 8; j++) fvr[j] = pg == 0 ? kv_load<KVT>(a.fv, fo + pc * 8 + j) : 0.f;
    }
    for (int i = tid; i < MM * HD; i += DA_THREADS) {
      const int m = i / HD;
      sQ[i] = m < Mt ? a.q[(((size_t)b * a.KVH + h) * a.M + m0) * HD + i] : 0.f;
    }
    if (tid < MM) {
      sM[tid] = -INFINITY;
      sL[tid] = 0.f;
    }
    float acc[MM][8];
#pragma unroll
    for (int m = 0; m < MM; m++)
#pragma unroll
      for (int j = 0; j < 8; j++) acc[m][j] = 0.f;
    __syncthreads();

    if (fresh && c == 0) {  // the fresh row seeds chunk 0: m = score, l = 1, acc = v
      for (int m = warp; m < Mt; m += DA_THREADS / 32) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < HD / 32; j++) x += sQ[m * HD + lane + 32 * j] * fkr[j];
        x = warp_sum(x) * a.scale;
        if (lane == 0) {
          sM[m] = x;
          sL[m] = 1.f;
        }
      }
      if (pg == 0) {
#pragma unroll
        for (int j = 0; j < 8; j++)
#pragma unroll
          for (int m = 0; m < MM; m++) acc[m][j] = fvr[j];
      }
    }

    const int sr = tid % TR, sp = tid / TR;  // score role: row, part of hd
    for (int kt = 0; kt < nt; kt++) {
      cp_async_wait<0>();
      __syncthreads();  // tile kt landed; every thread is done with tile kt - 1
      if (kt + 1 < nt) issue(kt + 1);  // into the stage tile kt - 1 freed
      cp_async_commit();
      const unsigned char* dk = ring + (kt % DA_STAGES) * 2 * TILE;
      const int t0 = s0 + kt * TR, nr = min(TR, s1 - t0);

      // the tile's scores, a part of hd a thread
      {
        float sc[MM][2];  // two chains a query row: even and odd pieces
#pragma unroll
        for (int m = 0; m < MM; m++) sc[m][0] = sc[m][1] = 0.f;
        const unsigned char* kr = dk + sr * RS + sp * SPP * 16;
#pragma unroll
        for (int p = 0; p < SPP; p++) {
          float kf[EP];
          cvt16<KVT>(kr + p * 16, kf);
          const int d0 = (sp * SPP + p) * EP;
#pragma unroll
          for (int m = 0; m < MM; m++) {
            const float4* qv = reinterpret_cast<const float4*>(sQ + m * HD + d0);
#pragma unroll
            for (int e = 0; e < EP / 4; e++) {
              const float4 qq = qv[e];
              float& acc_s = sc[m][p & 1];
              acc_s = fmaf(qq.x, kf[4 * e], acc_s);
              acc_s = fmaf(qq.y, kf[4 * e + 1], acc_s);
              acc_s = fmaf(qq.z, kf[4 * e + 2], acc_s);
              acc_s = fmaf(qq.w, kf[4 * e + 3], acc_s);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < MM; m++) sS[(sp * MM + m) * TR + sr] = sc[m][0] + sc[m][1];
      }
      __syncthreads();

      // one softmax step a tile: a warp a query row
      for (int m = warp; m < MM; m += DA_THREADS / 32) {
        float sv[(TR + 31) / 32];
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < (TR + 31) / 32; j++) {
          const int r = lane + 32 * j;
          float x = 0.f;
#pragma unroll
          for (int p = 0; p < SPL; p++) x += sS[(p * MM + m) * TR + r];
          const bool ok = m < Mt && r < nr && t0 + r != dead;
          sv[j] = ok ? x * a.scale : -INFINITY;
          tmax = fmaxf(tmax, sv[j]);
        }
        tmax = warp_max(tmax);
        const float mo = sM[m], mn = fmaxf(mo, tmax);
        const float alpha = mo == -INFINITY ? 0.f : expf(mo - mn);
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < (TR + 31) / 32; j++) {
          const float p = sv[j] == -INFINITY ? 0.f : expf(sv[j] - mn);
          sP[(lane + 32 * j) * MM + m] = p;
          ls += p;
        }
        ls = warp_sum(ls);
        if (lane == 0) {
          sM[m] = mn;
          sL[m] = sL[m] * alpha + ls;
          sA[m] = alpha;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P . V: an 8-column chunk of every RG-th row
      if (pg < RG) {
#pragma unroll
        for (int m = 0; m < MM; m++) {
          const float al = sA[m];
#pragma unroll
          for (int j = 0; j < 8; j++) acc[m][j] *= al;
        }
        const unsigned char* vb = dk + TILE + pc * 8 * P::ES;
        for (int r = pg; r < nr; r += RG) {
          float vf[8];
          cvt8<KVT>(vb + r * RS, vf);
#pragma unroll
          for (int mq = 0; mq < MM / 4; mq++) {
            const float4 pp = *reinterpret_cast<const float4*>(sP + r * MM + 4 * mq);
#pragma unroll
            for (int j = 0; j < 8; j++) {
              acc[4 * mq][j] = fmaf(pp.x, vf[j], acc[4 * mq][j]);
              acc[4 * mq + 1][j] = fmaf(pp.y, vf[j], acc[4 * mq + 1][j]);
              acc[4 * mq + 2][j] = fmaf(pp.z, vf[j], acc[4 * mq + 2][j]);
              acc[4 * mq + 3][j] = fmaf(pp.w, vf[j], acc[4 * mq + 3][j]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the row groups' sums

    float* red = reinterpret_cast<float*>(da_smem);  // [RG][MM][HD]
    if (pg < RG) {
#pragma unroll
      for (int m = 0; m < MM; m++) {
        float4* dst = reinterpret_cast<float4*>(red + (pg * MM + m) * HD + pc * 8);
        dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
      }
    }
    __syncthreads();
    for (int i = tid; i < Mt * HD; i += DA_THREADS) {
      const int m = i / HD, d = i % HD;
      float o = 0.f;
#pragma unroll
      for (int g = 0; g < RG; g++) o += red[(g * MM + m) * HD + d];
      a.pacc[(pidx * MM + m) * HD + d] = o;
    }
    if (tid < Mt) {
      a.pm[pidx * MM + tid] = sM[tid];
      a.pl[pidx * MM + tid] = sL[tid];
    }
  }

  // the last block of the group folds the live chunks: the barrier orders
  // the block's writes before thread 0's ticket, an acquire-release atomic
  // at gpu scope, which in the last block also orders the reads after it
  __syncthreads();
  if (tid == 0) {
    int t;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(t)
                 : "l"(a.ticket + grp)
                 : "memory");
    const bool last = t == a.NC - 1;
    if (last) a.ticket[grp] = 0;  // ready for the next launch
    *sFlag = last;
  }
  __syncthreads();
  if (!*sFlag) return;

  // the chunk weights exp(m_c - m) and the sum l, a warp a query row; then
  // four columns a thread with every chunk's load in flight at once
  const int ncl = max((kv_len + a.CS - 1) / a.CS, fresh ? 1 : 0);
  float* sW = reinterpret_cast<float*>(da_smem);  // [MM][DA_MAX_CHUNKS]
  float* sMx = sW + MM * DA_MAX_CHUNKS;
  float* sLs = sMx + MM;
  const float* gm = a.pm + grp * a.NC * MM;
  const float* gl = a.pl + grp * a.NC * MM;
  for (int m = warp; m < Mt; m += DA_THREADS / 32) {
    float mx = -INFINITY;
    for (int cc = lane; cc < ncl; cc += 32) mx = fmaxf(mx, __ldcg(gm + cc * MM + m));
    mx = warp_max(mx);
    float l = 0.f;
    for (int cc = lane; cc < ncl; cc += 32) {
      const float mc = __ldcg(gm + cc * MM + m);
      const float f = mc == -INFINITY ? 0.f : expf(mc - mx);
      sW[m * DA_MAX_CHUNKS + cc] = f;
      l += __ldcg(gl + cc * MM + m) * f;
    }
    l = warp_sum(l);
    if (lane == 0) {
      sMx[m] = mx;
      sLs[m] = l;
    }
  }
  __syncthreads();
  const float* ga = a.pacc + grp * a.NC * MM * HD;
  for (int i = tid; i < Mt * HD / 4; i += DA_THREADS) {
    const int m = 4 * i / HD, d = 4 * i % HD;
    const float* wt = sW + m * DA_MAX_CHUNKS;
    const float4* src = reinterpret_cast<const float4*>(ga + m * HD + d);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int cc = 0; cc < ncl; cc++) {
      const float f = wt[cc];
      const float4 v = __ldcg(src + (size_t)cc * (MM * HD / 4));
      o.x = fmaf(v.x, f, o.x);
      o.y = fmaf(v.y, f, o.y);
      o.z = fmaf(v.z, f, o.z);
      o.w = fmaf(v.w, f, o.w);
    }
    const size_t bh = ((size_t)b * a.KVH + h) * a.M + m0 + m;
    float4* dst = reinterpret_cast<float4*>(a.out + bh * HD + d);
    if (a.mo == nullptr) {
      const float l = sLs[m];
      *dst = make_float4(o.x / l, o.y / l, o.z / l, o.w / l);
    } else {
      *dst = o;
      if (d == 0) {
        a.mo[bh] = sMx[m];
        a.lo[bh] = sLs[m];
      }
    }
  }
}

template <int HD, int KVT, int MM, bool PAGED>
cudaError_t launch_decode(const AttnArgs& a, cudaStream_t st) {
  constexpr int smem = decode_smem<HD, KVT, MM>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_decode_kernel<HD, KVT, MM, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (a.CS % DaShape<HD, KVT>::TR != 0 || a.NC > DA_MAX_CHUNKS) return cudaErrorInvalidValue;
  dim3 grid(a.NC, a.KVH, a.B * a.NT);
  attn_decode_kernel<HD, KVT, MM, PAGED><<<grid, DA_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD, int KVT, bool PAGED>
cudaError_t launch_mm(int mm, const AttnArgs& a, cudaStream_t st) {
  if (mm == 4) return launch_decode<HD, KVT, 4, PAGED>(a, st);
  if (mm == 8) return launch_decode<HD, KVT, 8, PAGED>(a, st);
  return cudaErrorInvalidValue;
}

template <int HD, bool PAGED>
cudaError_t launch_kvt(int kvt, int mm, const AttnArgs& a, cudaStream_t st) {
  if (kvt == 0) return launch_mm<HD, 0, PAGED>(mm, a, st);
  if (kvt == 1) return launch_mm<HD, 1, PAGED>(mm, a, st);
  return launch_mm<HD, 2, PAGED>(mm, a, st);
}

template <int HD>
cudaError_t launch_paged(int kvt, int mm, const AttnArgs& a, cudaStream_t st) {
  return a.pt ? launch_kvt<HD, true>(kvt, mm, a, st) : launch_kvt<HD, false>(kvt, mm, a, st);
}

// ---------------------------------------------------------------------------
// Prefill (K13): causal flash attention of T queries against the carried
// cache, on TMA and wgmma.
//
// Replaces calm_tpu/ops/pallas_attn.py:_prefill_kernel (:326), reached
// through prefill_attention (:463). Query t of sequence b sits at absolute
// position pos0[b] + t and sees cache rows col < kv_len[b] and
// col <= pos0[b] + t (the T fresh rows are written into the cache first).
//
// What bounds it on an H100: the tensor cores. A call does 4 * hd flops per
// visible (query head, cache row) pair against 2 * KVH * kv * hd cache
// elements and q and out in f32, each moved once: at T = 2048 from position
// 0 with M = 4, ~450 flops per byte, above the card's ~295 bf16 flops per
// byte. So the design keeps the tensor cores fed:
//
// - Work items. An item is 128 (query, head) rows of one (kv head,
//   sequence), numbered R = t * M + m as the TPU kernel packs them
//   (:340-342), so a query's M heads share every staged K/V tile and any M
//   fits. Items run heaviest first (the last query tile has the longest
//   causal range). One persistent block an SM walks them in a snake over
//   that order, a heavy item of one band paired with a light one of the
//   next, so the blocks end together (ops/hopper_attn.prefill_plan is the
//   same arithmetic in Python).
// - Roles. Two consumer warpgroups take 64 rows of an item each. A producer
//   warpgroup stages q (f32 -> bf16, rounded once as the TPU kernel rounds
//   it, :355-360) into one of two Q tiles, so the next item's q lands while
//   this one computes, and keeps K/V tiles (BN = 64 cache rows, 32 at hd
//   256) in flight in a ring of stages, each completing on an mbarrier
//   ("full") and handed back on another ("empty", all 256 consumer threads
//   arrive). The ring runs on across items.
// - bf16 caches arrive by TMA (one producer thread), already in the swizzle
//   wgmma reads: the 128-byte swizzle in 64-column blocks, or the 64-byte
//   one in 32-column blocks at hd 96 (192-byte rows take no 128-byte
//   swizzle in one box). The producer then needs few registers, so
//   setmaxnreg moves them to the consumers. fp16 and e5m2 caches are read
//   by all 128 producer threads, 16 bytes a load and a batch of loads in
//   flight, and converted once into the same swizzled bf16 tile (e5m2
//   exactly, fp16 rounded), as K4 decodes its gf4 words.
// - Products. S = Q K^T is wgmma m64nBNk16 with both operands in shared
//   memory; the online softmax runs in registers in base 2 (a row with
//   nothing visible keeps m = -inf and its shift clamped to 0, :374-378);
//   P is rounded to bf16 in registers (:383) and is the register A operand
//   of O += P V, V's tile the MN-major B operand (the instruction's
//   transpose bit). The next tile's S goes out right behind P V. Only tiles
//   that cross the diagonal or kv_len compare; the rest skip the mask. The
//   end divides by max(l, 1e-37) (:390). Sums in f32.
// - Cache rows past an item's causal limit are never multiplied: a V row at
//   or past it is zeroed in shared memory before P V (0 * a stale NaN is
//   NaN), and its score is masked. The tensor map is 3-D (hd, S, planes),
//   so a tile past S arrives as zeros.

#define PF_ROWS 128     // (query, head) rows a block: two consumer warpgroups
#define PF_THREADS 384  // two consumer warpgroups and one producer warpgroup
#define PF_SMEM_MAX 232448
// registers a thread for a bf16 cache, whose producer only stages q and
// issues TMA: 2 x 128 x 200 + 128 x 104 <= 65536 (setmaxnreg). The fp16 and
// e5m2 loaders convert, and keep the even share of 168.
#define PF_REGS_CONSUMER 200
#define PF_REGS_PRODUCER 104

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// eight fp16 -> eight bf16 (rounded)
__device__ __forceinline__ uint4 f16x8_bf16(uint4 raw) {
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

// eight e5m2 -> eight bf16, exactly: each byte becomes the high byte of an
// f16 (the same value), two at a time by a byte permute; f16 -> f32 -> bf16
__device__ __forceinline__ uint4 e5m2x8_bf16(uint32_t w0, uint32_t w1) {
  const uint32_t w[2] = {w0, w1};
  uint4 o;
  uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const uint32_t h2 = __byte_perm(w[j >> 1], 0u, (j & 1) ? 0x3424 : 0x1404);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
    op[j] = pack_bf16(f.x, f.y);
  }
  return o;
}

// the prefill kernel's tiling and shared memory, by head dim and cache type
template <int HD, int KVT>
struct Pf {
  static constexpr int SWB = HD % 64 == 0 ? 128 : 64;  // bytes a row of a column block
  static constexpr int SWZ = SWB == 128 ? 1 : 2;       // descriptor swizzle code
  static constexpr int CB = SWB / 2;                   // bf16 columns a column block
  static constexpr int NCB = HD / CB;
  // cache rows a tile: 64, or 32 at hd 256 (its O accumulator alone takes
  // 128 registers a thread, and its two Q tiles 128 KB); 64 rather than 128
  // leaves the consumers' S and P registers room
  static constexpr int BN = HD <= 128 ? 64 : 32;
  static constexpr int ES = KVT == 2 ? 1 : 2;          // cache bytes an element
  static constexpr int Q = PF_ROWS * HD * 2;           // q in bf16
  static constexpr int STAGE = 2 * BN * HD * 2;        // a bf16 K and V tile
  static constexpr int AVAIL = PF_SMEM_MAX - 1024 - 128 - 2 * Q;
  static constexpr int NS = AVAIL / STAGE > 4 ? 4 : AVAIL / STAGE;  // stages in the ring
  static constexpr int SMEM = 2 * Q + NS * STAGE + 1024 + 128;
  static_assert(NS >= 2 && SMEM <= PF_SMEM_MAX, "two stages must fit");
};

// the byte offset of 16-byte chunk j of row r of a column block, swizzled
// as TMA writes it and wgmma reads it (CUTLASS's Swizzle<3,4,3>, <2,4,3>)
template <int SWB>
__device__ __forceinline__ int swz(int r, int j) {
  const int off = r * SWB + j * 16;
  return off ^ (((off >> 7) & (SWB == 128 ? 7 : 3)) << 4);
}

struct PfArgs {
  const float* q;      // (B, T, KVH, M, hd)
  const void* k;       // (L, Bc, KVH, S, hd): read by TMA (bf16) or by loads
  const void* v;
  const int* pos0;     // (B,)
  const int* kv_len;   // (B,)
  float* out;          // (B, T, KVH, M, hd)
  int B, T, KVH, M, S, layer, Bc, boff;  // cache slots, first slot read
  float scale_log2;    // log2(e) / sqrt(hd)
};

template <int HD>
__device__ __forceinline__ void pv(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (HD == 64)
    wgmma_rs64(d, a, b);
  else if constexpr (HD == 96)
    wgmma_rs96(d, a, b);
  else if constexpr (HD == 128)
    wgmma_rs128(d, a, b);
  else
    wgmma_rs256(d, a, b);
}

template <int BN>
__device__ __forceinline__ void qk(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 64)
    wgmma_ss64(d, da, db, scale_d);
  else
    wgmma_ss32(d, da, db, scale_d);
}

// one (query tile, kv head, sequence) work item and its causal range
struct PfItem {
  int R0, h, b, pos0, kv_len, c_end, c_all, ntiles, plane;
};

// item k of this block: blocks walk the heaviest-first order in a snake,
// so every block gets a heavy and a light item of each pair of bands
// (ops/hopper_attn.prefill_plan is the same in Python); -1 past the end
__device__ __forceinline__ int item_pos(int k, int items) {
  const int G = gridDim.x, bid = blockIdx.x;
  const int pos = k * G + ((k & 1) ? G - 1 - bid : bid);
  return pos < items ? pos : -1;
}

template <int BN>
__device__ __forceinline__ PfItem make_item(const PfArgs& a, int pos, int nq) {
  PfItem it;
  const int per = a.KVH * a.B, TM = a.T * a.M;
  const int qt = nq - 1 - pos / per, rem = pos % per;
  it.h = rem % a.KVH;
  it.b = rem / a.KVH;
  it.R0 = qt * PF_ROWS;
  it.pos0 = a.pos0[it.b];
  it.kv_len = min(a.kv_len[it.b], a.S);
  const int t_first = it.R0 / a.M, t_last = (min(it.R0 + PF_ROWS, TM) - 1) / a.M;
  it.c_end = max(0, min(it.kv_len, it.pos0 + t_last + 1));  // rows any row here sees
  it.c_all = min(it.kv_len, it.pos0 + t_first + 1);         // rows every row sees
  it.ntiles = (it.c_end + BN - 1) / BN;
  it.plane = (a.layer * a.Bc + a.boff + it.b) * a.KVH + it.h;
  return it;
}

template <int HD, int KVT>
__global__ void __launch_bounds__(PF_THREADS, 1)
    prefill_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, PfArgs a) {
  using P = Pf<HD, KVT>;
  constexpr int BN = P::BN, SWB = P::SWB, CB = P::CB, TILE = P::STAGE / 2;
  extern __shared__ unsigned char pf_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(pf_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* qbuf = sm;               // two bf16 Q tiles: this item's and the next
  unsigned char* ring = sm + 2 * P::Q;    // bf16 K, V stages
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::NS * P::STAGE);
  uint64_t* empty = full + P::NS;
  uint64_t* qfull = empty + P::NS;
  uint64_t* qempty = qfull + 2;

  const int TM = a.T * a.M, nq = (TM + PF_ROWS - 1) / PF_ROWS;
  const int items = nq * a.KVH * a.B;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < P::NS; s++) {
      mbar_init(full + s, KVT == 1 ? 1 : 128);  // TMA's arrival, or the loaders'
      mbar_init(empty + s, 256);
    }
    for (int s = 0; s < 2; s++) {
      mbar_init(qfull + s, KVT == 1 ? 96 : 128);  // the threads that stage q
      mbar_init(qempty + s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: q of each item, then its K/V tiles
    if constexpr (KVT == 1) reg_dealloc<PF_REGS_PRODUCER>();
    const int pt = tid - 256;
    int gt = 0;  // tiles of earlier items: the ring's position
    for (int k = 0;; k++) {
      const int pos = item_pos(k, items);
      if (pos < 0) break;
      const PfItem it = make_item<BN>(a, pos, nq);
      // the item's 128 rows of q, f32 -> bf16, into the swizzled Q tile of
      // its buffer (free once the consumers are done with item k - 2), by
      // warps 1-3 for a bf16 cache (warp 0 keeps issuing TMA) or by all four:
      // a batch of loads in flight at once, then their stores
      constexpr int QT = KVT == 1 ? 96 : 128;  // threads that stage q
      const int qt0 = pt - (128 - QT);
      if (qt0 >= 0) {
        unsigned char* sQ = qbuf + (k & 1) * P::Q;
        if (k >= 2) mbar_wait(qempty + (k & 1), ((k >> 1) - 1) & 1);
        constexpr int QP = PF_ROWS * HD / 8;  // 8-column pieces of the tile
        for (int q0 = qt0; q0 < QP; q0 += 8 * QT) {
          float4 x[8][2];
#pragma unroll
          for (int u = 0; u < 8; u++) {
            const int i = q0 + u * QT;
            const int R = it.R0 + i / (HD / 8), c8 = (i % (HD / 8)) * 8;
            x[u][0] = x[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (i < QP && R < TM) {
              const float4* src = reinterpret_cast<const float4*>(
                  a.q + ((((size_t)it.b * a.T + R / a.M) * a.KVH + it.h) * a.M + R % a.M) *
                            HD + c8);
              x[u][0] = __ldg(src);
              x[u][1] = __ldg(src + 1);
            }
          }
#pragma unroll
          for (int u = 0; u < 8; u++) {
            const int i = q0 + u * QT;
            const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
            if (i < QP)
              *reinterpret_cast<uint4*>(sQ + (c8 / CB) * PF_ROWS * SWB +
                                        swz<SWB>(r, (c8 % CB) / 8)) =
                  make_uint4(pack_bf16(x[u][0].x, x[u][0].y), pack_bf16(x[u][0].z, x[u][0].w),
                             pack_bf16(x[u][1].x, x[u][1].y), pack_bf16(x[u][1].z, x[u][1].w));
          }
        }
        fence_proxy_async();
        mbar_arrive(qfull + (k & 1));
      }

      if constexpr (KVT == 1) {  // one thread keeps the ring full, by TMA
        if (pt == 0) {
          for (int j = 0; j < it.ntiles; j++) {
            const int g = gt + j, s = g % P::NS;
            if (g >= P::NS) mbar_wait(empty + s, ((g / P::NS) - 1) & 1);
            unsigned char* st = ring + s * P::STAGE;
            mbar_expect_tx(full + s, P::STAGE);
#pragma unroll
            for (int cb = 0; cb < P::NCB; cb++) {
              tma_load_3d(st + cb * BN * SWB, &kmap, full + s, cb * CB, j * BN, it.plane);
              tma_load_3d(st + TILE + cb * BN * SWB, &vmap, full + s, cb * CB, j * BN,
                          it.plane);
            }
          }
        }
      } else {  // all 128 threads load raw rows (16 bytes a load) and convert them
        constexpr int RC = HD * P::ES / 16;    // raw 16-byte pieces a row
        constexpr int CN = 2 * BN * RC / 128;  // pieces a thread a tile: K's, then V's
        constexpr int CBT = KVT == 0 ? 4 : 8;  // pieces a batch: loads in flight at once
        const size_t row_b = (size_t)HD * P::ES;
        const unsigned char* kp =
            static_cast<const unsigned char*>(a.k) + (size_t)it.plane * a.S * row_b;
        const unsigned char* vp =
            static_cast<const unsigned char*>(a.v) + (size_t)it.plane * a.S * row_b;
        for (int j = 0; j < it.ntiles; j++) {
          const int g = gt + j, s = g % P::NS;
          if (g >= P::NS) mbar_wait(empty + s, ((g / P::NS) - 1) & 1);
          unsigned char* st = ring + s * P::STAGE;
#pragma unroll
          for (int c0 = 0; c0 < CN; c0 += CBT) {
            uint4 w[CBT];
#pragma unroll
            for (int u = 0; u < CBT; u++) {  // rows at or past the limit: 0
              const int i = pt + (c0 + u) * 128, r = (i % (BN * RC)) / RC;
              w[u] = make_uint4(0u, 0u, 0u, 0u);
              if (c0 + u < CN && j * BN + r < it.c_end)
                w[u] = __ldg(reinterpret_cast<const uint4*>(
                    (i < BN * RC ? kp : vp) + (size_t)(j * BN + r) * row_b + (i % RC) * 16));
            }
#pragma unroll
            for (int u = 0; u < CBT && c0 + u < CN; u++) {
              const int i = pt + (c0 + u) * 128, r = (i % (BN * RC)) / RC;
              unsigned char* t = st + (i < BN * RC ? 0 : TILE);
              if constexpr (KVT == 0) {
                const int c8 = (i % RC) * 8;
                *reinterpret_cast<uint4*>(t + (c8 / CB) * BN * SWB +
                                          swz<SWB>(r, (c8 % CB) / 8)) = f16x8_bf16(w[u]);
              } else {
                const int c16 = (i % RC) * 16;
                *reinterpret_cast<uint4*>(t + (c16 / CB) * BN * SWB +
                                          swz<SWB>(r, (c16 % CB) / 8)) =
                    e5m2x8_bf16(w[u].x, w[u].y);
                *reinterpret_cast<uint4*>(t + ((c16 + 8) / CB) * BN * SWB +
                                          swz<SWB>(r, ((c16 + 8) % CB) / 8)) =
                    e5m2x8_bf16(w[u].z, w[u].w);
              }
            }
          }
          fence_proxy_async();
          mbar_arrive(full + s);
        }
      }
      gt += it.ntiles;
    }
    return;
  }

  // the consumers: this thread's rows are g and g + 8 of its warp's 16
  if constexpr (KVT == 1) reg_alloc<PF_REGS_CONSUMER>();
  const int w = (tid >> 5) & 3, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  float o[HD / 2];
  float sacc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; i++) sacc[i] = 0.f;
  uint32_t pa[BN / 16][4];
  int gt = 0;  // tiles of earlier items: the ring's position
  for (int k = 0;; k++) {
    const int pos = item_pos(k, items);
    if (pos < 0) break;
    const PfItem it = make_item<BN>(a, pos, nq);
    const unsigned char* sQ = qbuf + (k & 1) * P::Q;
    int qpos[2];
    float* orow[2];
#pragma unroll
    for (int i = 0; i < 2; i++) {
      const int R = it.R0 + wg * 64 + w * 16 + g8 + 8 * i;
      const bool ok = R < TM;
      qpos[i] = ok ? it.pos0 + R / a.M : -1;  // -1 sees nothing
      orow[i] = ok ? a.out + ((((size_t)it.b * a.T + R / a.M) * a.KVH + it.h) * a.M +
                              R % a.M) * HD
                   : nullptr;
    }
#pragma unroll
    for (int i = 0; i < HD / 2; i++) o[i] = 0.f;
    fence_acc<HD / 2>(o);  // zeroed here, not sunk into the first product's stage
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};  // m in raw score units
    mbar_wait(qfull + (k & 1), (k >> 1) & 1);

    // tile j's stage has landed; a bf16 tile that crosses the item's limit
    // gets its V rows past the limit zeroed (fp16/e5m2: by the loaders)
    auto ready = [&](int j) {
      const int gj = gt + j, s = gj % P::NS, live = it.c_end - j * BN;
      mbar_wait(full + s, (gj / P::NS) & 1);
      if constexpr (KVT == 1) {
        if (live < BN) {
          unsigned char* vt = ring + s * P::STAGE + TILE;
          constexpr int CPR = SWB / 16;  // 16-byte chunks a row of a column block
          for (int i = tid; i < (BN - live) * CPR * P::NCB; i += 256) {
            const int cb = i / ((BN - live) * CPR), q = i % ((BN - live) * CPR);
            *reinterpret_cast<uint4*>(vt + cb * BN * SWB + (live + q / CPR) * SWB +
                                      (q % CPR) * 16) = make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();
          bar_sync(1, 256);
        }
      }
    };
    // S = Q K^T of tile j: 64 rows x BN cache rows a warpgroup
    auto issue_qk = [&](int j) {
      const unsigned char* kt = ring + ((gt + j) % P::NS) * P::STAGE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ks++) {
        const int cb = ks * 16 / CB, wi = (ks * 16 % CB) * 2;
        const uint64_t da = wgmma_desc_sw(sQ + cb * PF_ROWS * SWB + wg * 64 * SWB + wi, 16,
                                          8 * SWB, P::SWZ);
        const uint64_t db = wgmma_desc_sw(kt + cb * BN * SWB + wi, 16, 8 * SWB, P::SWZ);
        qk<BN>(sacc, da, db, ks > 0);
      }
      wgmma_commit();
    };

    if (it.ntiles > 0) {
      ready(0);
      fence_acc<BN / 2>(sacc);
      issue_qk(0);
    }
    for (int j = 0; j < it.ntiles; j++) {
      const int c0 = j * BN;
      wgmma_wait<0>();  // S of tile j and P V of tile j - 1 are done
      fence_acc<BN / 2>(sacc);
      fence_acc<HD / 2>(o);
      if (j > 0) mbar_arrive(empty + (gt + j - 1) % P::NS);  // tile j - 1's stage is read

      // mask (only a tile that crosses the diagonal or kv_len), then the
      // online softmax of rows g8 (i = 0) and g8 + 8 (i = 1) in base 2;
      // register e holds row (e / 2) % 2, column 8 (e / 4) + 2 t4 + e % 2
      float mx[2] = {-INFINITY, -INFINITY};
      if (c0 + BN > it.c_all) {
#pragma unroll
        for (int e = 0; e < BN / 2; e++) {
          const int i = (e >> 1) & 1, col = c0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
          sacc[e] = (col < it.kv_len && col <= qpos[i]) ? sacc[e] : -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < BN / 2; e++) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
      float shift[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; i++) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(mrow[i], mx[i]);
        shift[i] = mn == -INFINITY ? 0.f : mn * a.scale_log2;  // clamped: nothing seen yet
        alpha[i] = mrow[i] == -INFINITY ? 0.f : ex2(mrow[i] * a.scale_log2 - shift[i]);
        mrow[i] = mn;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < BN / 2; e++) {
        const int i = (e >> 1) & 1;
        sacc[e] = ex2(fmaf(sacc[e], a.scale_log2, -shift[i]));  // -inf -> 0
        ls[i] += sacc[e];
      }
#pragma unroll
      for (int i = 0; i < 2; i++) lrow[i] = lrow[i] * alpha[i] + ls[i];  // 1/4 of the row
#pragma unroll
      for (int e = 0; e < HD / 2; e++) o[e] *= alpha[(e >> 1) & 1];

      // O += P V: P's accumulator layout is the register A operand's (16
      // columns a k step); V's tile is MN-major. Tile j + 1's S = Q K^T goes
      // out right behind it, so the tensor cores never wait on this
      // warpgroup's softmax alone.
#pragma unroll
      for (int kk = 0; kk < BN / 16; kk++) {
#pragma unroll
        for (int r = 0; r < 4; r++)
          pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
      }
      const unsigned char* vt = ring + ((gt + j) % P::NS) * P::STAGE + TILE;
      // every write of S and O lands before the stage opens
      fence_acc<BN / 2>(sacc);
      fence_acc<HD / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; kk++)
        pv<HD>(o, pa[kk], wgmma_desc_sw(vt + kk * 16 * SWB, BN * SWB, 8 * SWB, P::SWZ));
      wgmma_commit();
      if (j + 1 < it.ntiles) {
        ready(j + 1);
        issue_qk(j + 1);
      }
    }
    wgmma_wait<0>();
    fence_acc<HD / 2>(o);
    if (it.ntiles > 0) mbar_arrive(empty + (gt + it.ntiles - 1) % P::NS);
    mbar_arrive(qempty + (k & 1));  // q is read: the producer may stage item k + 2's
    gt += it.ntiles;

#pragma unroll
    for (int i = 0; i < 2; i++) {
      float l = lrow[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.0f / fmaxf(l, 1e-37f);
      if (orow[i] == nullptr) continue;
#pragma unroll
      for (int n = 0; n < HD / 8; n++)
        *reinterpret_cast<float2*>(orow[i] + 8 * n + 2 * t4) =
            make_float2(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
  }
}

template <int HD, int KVT>
cudaError_t launch_prefill_kvt(const PfArgs& a, const void* k, const void* v, int L,
                               int grid, cudaStream_t st) {
  using P = Pf<HD, KVT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_kernel<HD, KVT>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap maps[2] = {};
  if (KVT == 1) {  // 3-D maps (hd, S, planes): a tile past S arrives as zeros
    const EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)a.S,
                                (cuuint64_t)L * a.Bc * a.KVH};
    const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)a.S * HD * 2};
    const cuuint32_t box[3] = {(cuuint32_t)P::CB, (cuuint32_t)P::BN, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    const void* base[2] = {k, v};
    for (int i = 0; i < 2; i++)
      if (enc(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base[i]), dims,
              strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
              P::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
  }
  prefill_kernel<HD, KVT><<<grid, PF_THREADS, P::SMEM, st>>>(maps[0], maps[1], a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_prefill(int kvt, const PfArgs& a, const void* k, const void* v, int L,
                           int grid, cudaStream_t st) {
  if (kvt == 0) return launch_prefill_kvt<HD, 0>(a, k, v, L, grid, st);
  if (kvt == 1) return launch_prefill_kvt<HD, 1>(a, k, v, L, grid, st);
  return launch_prefill_kvt<HD, 2>(a, k, v, L, grid, st);
}

template <int HD>
int prefill_smem(int kvt) {
  return kvt == 0 ? Pf<HD, 0>::SMEM : kvt == 1 ? Pf<HD, 1>::SMEM : Pf<HD, 2>::SMEM;
}

// ---------------------------------------------------------------------------
// K13's split-S route: the few query rows of a speculative verify, and the
// draft tree's nodes, against a long cache, on mma.sync.
//
// Replaces calm_tpu/ops/pallas_attn.py:_prefill_kernel (:326) at a verify's
// shapes, reached through prefill_attention (:463): the same function as the
// persistent kernel above (query t of sequence b at position pos0[b] + t sees
// cache rows col < kv_len[b] and col <= pos0[b] + t; K/V enter the products
// as bf16, q and p rounded once to bf16, sums in f32). With a tree mask (T, T)
// bool it is also the draft tree's attention, which has no TPU kernel (jnp in
// JAX, calm_tpu/model.py:613-630): node t sees the context below the tree,
// col < kv_len - T, and inside it the nodes tree[t] marks.
//
// What bounds it on an H100: the cache bytes. At T = 5 and M = 4 a kv head's
// 20 query rows do ~20 flops a cache byte in bf16, far below the tensor
// cores' ~295; in f32 FMA (K12's arithmetic) it would be at the f32/HBM
// balance, and the tree's 40 rows past it. The persistent kernel gives such
// a call ceil(T M / 128) KVH B blocks (8 of 132 SMs at B = 1), each reading
// one kv head's whole window alone. So:
//
// - Split S, as K12 does. A block owns one (chunk of CS cache rows, kv head,
//   sequence, row group) with all the group's query rows: up to 64 (query,
//   head) rows R = t M + m, padded to 16, 32, 48 or 64, so each K/V tile is
//   read once for all of them; more rows take more groups. The plan
//   (ops/hopper_attn.verify_plan) is a pure function of the shapes that
//   aims at one resident wave and never depends on kv_len, so eager and
//   replayed runs sum in the same order. Chunks past the rows any query of
//   the group sees read nothing.
// - Tiles of TR cache rows (64, or 32 at hd 256) of K and V copied in the
//   cache dtype with 16-byte cp.async into a ring of VA_STAGES stages (rows
//   padded 16 bytes: the fragment reads are free of bank conflicts); V rows
//   past the chunk are zeroed (p = 0 there, and 0 * NaN = NaN).
// - Warps: RT row tiles x WS splits of a tile's 16-row sub-tiles. Each warp
//   runs S = Q K^T and O += P V for its 16 rows on mma.sync m16n8k16 (bf16,
//   f32 accumulators), K and V widened to bf16 as the fragments are read
//   (e5m2 exactly, fp16 rounded), an online softmax in base 2 in registers
//   (a row with nothing visible keeps m = -inf, its shift clamped to 0). The
//   WS warps of a row tile merge in shared memory at the end of the chunk.
// - The chunks fold in the same launch, as K12's: each block writes its
//   state (acc, m, l) to the workspace, and the last block of its group (an
//   acquire-release ticket it resets) folds the live chunks in chunk order
//   and writes out = acc / max(l, 1e-37).

#define VA_STAGES 3       // tiles in flight: two ahead of the one computed
#define VA_ROWS 64        // (query, head) rows a block at most: four row tiles of 16
#define VA_MAX_CHUNKS 64  // the fold keeps one weight a (row, chunk) in shared memory
#define VA_THREADS 256    // at most: RT x WS warps

template <int HD, int KVT>
struct Va {
  static constexpr int ES = KVT == 2 ? 1 : 2;     // cache bytes a value
  static constexpr int TR = HD > 128 ? 32 : 64;   // cache rows a tile
  static constexpr int SUB = TR / 16;             // 16-row sub-tiles a tile
  static constexpr int RS = HD * ES + 16;         // bytes a staged row: the pad spreads banks
  static constexpr int RB = HD * 2 + 16;          // bytes a bf16 row (q, converted K/V)
  static constexpr int CPR = HD * ES / 16;        // 16-byte pieces a row
  static constexpr int TILE = TR * RS;
  static constexpr int RING = VA_STAGES * 2 * TILE;
  static constexpr int CONV = KVT == 1 ? 0 : 2 * TR * RB;  // fp16/e5m2: the tile in bf16
  // the warps' merge ((WS - 1) * RT row tiles of o, m and l) and the fold's
  // (row, chunk) m, l and weights reuse the ring
  static constexpr int SLOTS = HD > 128 ? 4 : 6;
  static constexpr int MERGE = SLOTS * 16 * HD * 4 + SLOTS * 128 * 4;
  static constexpr int FOLD = 2 * VA_ROWS * VA_MAX_CHUNKS * 4 + VA_ROWS * 4;
  static constexpr int R1 = RING > MERGE ? RING : MERGE;
  static constexpr int REGION0 = R1 > FOLD ? R1 : FOLD;
  static constexpr int SMEM = REGION0 + CONV + VA_ROWS * RB;
  static constexpr bool QREG = HD <= 128;  // q's fragments held in registers
};

struct VaArgs {
  const float* q;               // (B, T, KVH, M, hd)
  const void* k;                // (L, Bc, KVH, S, hd)
  const void* v;
  const int* pos0;              // (B,)
  const int* kv_len;            // (B,)
  const unsigned char* tree;    // (T, T) bool, or null: causal
  float* pacc;                  // workspace (B, KVH, NG, NC, RT * 16, hd)
  float* pm;                    // (B, KVH, NG, NC, RT * 16)
  float* pl;
  int* ticket;                  // (B, KVH, NG), zero between launches
  float* out;                   // (B, T, KVH, M, hd)
  int B, T, KVH, M, S, layer, Bc, boff, CS, NC, RT, NG;
  float scale_log2;             // log2(e) / sqrt(hd)
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices of shared memory, one row address a lane
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

template <int HD, int KVT>
__global__ void __launch_bounds__(VA_THREADS) verify_kernel(VaArgs a) {
  using P = Va<HD, KVT>;
  constexpr int TR = P::TR, RS = P::RS, RB = P::RB, TILE = P::TILE, ES = P::ES;
  static_assert(KVT != 1 || RS == RB, "a bf16 tile is read where it lands");
  extern __shared__ __align__(16) unsigned char va_smem[];
  unsigned char* ring = va_smem;                        // [stage][K, V][TR][RS]
  unsigned char* conv = va_smem + P::REGION0;           // [K, V][TR][RB] (fp16, e5m2)
  unsigned char* sQ = conv + P::CONV;                   // [RT * 16][RB] bf16
  __shared__ int sFlag;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z / a.NG, grow = blockIdx.z % a.NG;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int WS = nthr / 32 / a.RT, rt = warp % a.RT, ws = warp / a.RT;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int GR = a.RT * 16, TM = a.T * a.M, R0 = grow * GR, Rn = min(GR, TM - R0);
  const int kv_len = min(a.kv_len[b], a.S);
  const bool tree = a.tree != nullptr;
  const int p0 = a.pos0[b], base = kv_len - a.T;  // base: the tree's first row
  // rows any query of the group sees (lim), and rows every one sees (c_all)
  const int lim = tree ? kv_len : max(0, min(kv_len, p0 + (R0 + Rn - 1) / a.M + 1));
  const int c_all = tree ? max(0, base) : max(0, min(kv_len, p0 + R0 / a.M + 1));
  const int ncl = (lim + a.CS - 1) / a.CS;  // chunks that hold a visible row
  const int s0 = c * a.CS, s1 = min(s0 + a.CS, lim);
  const size_t grp = ((size_t)b * a.KVH + h) * a.NG + grow;
  const size_t pidx = grp * a.NC + c;
  auto row_off = [&](int r) -> size_t {  // q's and out's offset of the group's row r
    const int R = R0 + r;
    return ((((size_t)b * a.T + R / a.M) * a.KVH + h) * a.M + R % a.M) * HD;
  };
  auto out_row = [&](int r) { return a.out + row_off(r); };

  if (ncl <= 1 && c > 0) return;  // one live chunk (or none): no fold, no ticket
  if (ncl == 0) {  // nothing visible: 0, as the plain version's sum over no row
    for (int i = tid; i < Rn * HD / 4; i += nthr)
      reinterpret_cast<float4*>(out_row(4 * i / HD))[4 * i % HD / 4] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  if (s0 < s1) {
    const size_t plane = (((size_t)a.layer * a.Bc + a.boff + b) * a.KVH + h) * (size_t)a.S;
    const unsigned char* gk = static_cast<const unsigned char*>(a.k) + plane * HD * ES;
    const unsigned char* gv = static_cast<const unsigned char*>(a.v) + plane * HD * ES;
    const int nt = (s1 - s0 + TR - 1) / TR;
    auto issue = [&](int kt) {  // tile kt into stage kt % VA_STAGES
      const int t0 = s0 + kt * TR, nr = min(TR, s1 - t0);
      unsigned char* dk = ring + (kt % VA_STAGES) * 2 * TILE;
      for (int i = tid; i < TR * P::CPR; i += nthr) {
        const int r = i / P::CPR, p = i % P::CPR;
        if (r < nr) {
          const size_t off = (size_t)(t0 + r) * HD * ES + p * 16;
          cp_async16(dk + r * RS + p * 16, gk + off);
          cp_async16(dk + TILE + r * RS + p * 16, gv + off);
        } else {  // past the chunk: V zeroed (p = 0 there, and 0 * NaN = NaN)
          *reinterpret_cast<uint4*>(dk + TILE + r * RS + p * 16) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    };
#pragma unroll
    for (int kt = 0; kt < VA_STAGES - 1; kt++) {  // the first tiles go out first
      if (kt < nt) issue(kt);
      cp_async_commit();
    }
    // the group's q rows, f32 -> bf16 once (padding rows 0)
    for (int i = tid; i < GR * (HD / 4); i += nthr) {
      const int r = i / (HD / 4), c4 = (i % (HD / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < Rn) x = __ldg(reinterpret_cast<const float4*>(a.q + row_off(r) + c4));
      *reinterpret_cast<uint2*>(sQ + r * RB + c4 * 2) =
          make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
    }

    // this thread's rows g8 (i = 0) and g8 + 8 (i = 1) of its row tile: the
    // query index t, or -1 for a padding row
    int tq[2];
#pragma unroll
    for (int i = 0; i < 2; i++) {
      const int r = rt * 16 + g8 + 8 * i;
      tq[i] = r < Rn ? (R0 + r) / a.M : -1;
    }
    auto seen = [&](int col, int i) -> bool {
      if (tq[i] < 0 || col >= lim) return false;
      if (!tree) return col <= p0 + tq[i];
      return col < base || a.tree[tq[i] * a.T + (col - base)] != 0;
    };
    // ldmatrix row addresses: A (q) rows lane % 16, columns + 8 (lane / 16);
    // K's B fragments of two n-tiles: rows lane % 8 + 8 (lane / 16), columns
    // + 8 (lane / 8 % 2); V's (transposed): rows lane % 16, columns + 8 (lane / 16)
    const unsigned char* qa = sQ + (rt * 16 + (lane & 15)) * RB + (lane >> 4) * 16;
    const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * RB + ((lane >> 3) & 1) * 16;
    const int v_off = (lane & 15) * RB + (lane >> 4) * 16;
    uint32_t qf[P::QREG ? HD / 16 : 1][4];
    if constexpr (P::QREG) {
      __syncthreads();  // q is staged
#pragma unroll
      for (int kk = 0; kk < HD / 16; kk++) ldsm4(qf[kk], qa + kk * 32);
    }

    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; n++) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};  // m in raw score units

    for (int kt = 0; kt < nt; kt++) {
      cp_async_wait<VA_STAGES - 2>();
      __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
      if (kt + VA_STAGES - 1 < nt) issue(kt + VA_STAGES - 1);  // into tile kt - 1's stage
      cp_async_commit();
      const unsigned char* tk = ring + (kt % VA_STAGES) * 2 * TILE;
      const unsigned char* tv = tk + TILE;
      if constexpr (KVT != 1) {  // fp16 / e5m2: the tile to bf16 once (e5m2 exact)
        for (int i = tid; i < 2 * TR * P::CPR; i += nthr) {
          const int kv = i / (TR * P::CPR), r = i % (TR * P::CPR) / P::CPR, p = i % P::CPR;
          const uint4 w = *reinterpret_cast<const uint4*>(tk + kv * TILE + r * RS + p * 16);
          unsigned char* d = conv + kv * TR * RB + r * RB + p * 16 * (2 / ES);
          if constexpr (KVT == 0) {
            *reinterpret_cast<uint4*>(d) = f16x8_bf16(w);
          } else {
            *reinterpret_cast<uint4*>(d) = e5m2x8_bf16(w.x, w.y);
            *reinterpret_cast<uint4*>(d + 16) = e5m2x8_bf16(w.z, w.w);
          }
        }
        __syncthreads();
        tk = conv;
        tv = conv + TR * RB;
      }
      const int t0 = s0 + kt * TR;
      for (int sub = ws; sub < P::SUB; sub += WS) {
        const int c0 = t0 + sub * 16;
        if (c0 >= s1) break;
        // S = Q K^T: 16 rows x 16 cache rows (two n-tiles of 8), k = hd
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const unsigned char* kb = tk + sub * 16 * RB + k_off;
#pragma unroll
        for (int kk = 0; kk < HD / 16; kk++) {
          uint32_t kf[4];
          ldsm4(kf, kb + kk * 32);
          if constexpr (P::QREG) {
            mma_bf16(s[0], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], kf[0], kf[1]);
            mma_bf16(s[1], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], kf[2], kf[3]);
          } else {
            uint32_t q4[4];
            ldsm4(q4, qa + kk * 32);
            mma_bf16(s[0], q4[0], q4[1], q4[2], q4[3], kf[0], kf[1]);
            mma_bf16(s[1], q4[0], q4[1], q4[2], q4[3], kf[2], kf[3]);
          }
        }
        // register e of n-tile nf: row g8 + 8 (e / 2), column c0 + 8 nf + 2 t4 + e % 2
        if (c0 + 16 > c_all) {
#pragma unroll
          for (int nf = 0; nf < 2; nf++)
#pragma unroll
            for (int e = 0; e < 4; e++)
              if (!seen(c0 + 8 * nf + 2 * t4 + (e & 1), e >> 1)) s[nf][e] = -INFINITY;
        }
        float shift[2], alpha[2];
#pragma unroll
        for (int i = 0; i < 2; i++) {
          float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]), fmaxf(s[1][2 * i], s[1][2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(mrow[i], mx);
          shift[i] = mn == -INFINITY ? 0.f : mn * a.scale_log2;  // clamped: nothing seen yet
          alpha[i] = mrow[i] == -INFINITY ? 0.f : ex2(mrow[i] * a.scale_log2 - shift[i]);
          mrow[i] = mn;
        }
        float ls[2] = {0.f, 0.f};
#pragma unroll
        for (int nf = 0; nf < 2; nf++)
#pragma unroll
          for (int e = 0; e < 4; e++) {
            s[nf][e] = ex2(fmaf(s[nf][e], a.scale_log2, -shift[e >> 1]));  // -inf -> 0
            ls[e >> 1] += s[nf][e];
          }
#pragma unroll
        for (int i = 0; i < 2; i++) lrow[i] = lrow[i] * alpha[i] + ls[i];  // a quarter of the row
        if (alpha[0] != 1.f || alpha[1] != 1.f) {  // the max moved: rescale
#pragma unroll
          for (int n = 0; n < HD / 8; n++) {
            o[n][0] *= alpha[0];
            o[n][1] *= alpha[0];
            o[n][2] *= alpha[1];
            o[n][3] *= alpha[1];
          }
        }
        // O += P V: P's accumulator layout is the A operand's (k = the 16
        // cache rows); V's fragments by transposing loads, two n-tiles each
        const uint32_t pa0 = pack_bf16(s[0][0], s[0][1]), pa1 = pack_bf16(s[0][2], s[0][3]),
                       pa2 = pack_bf16(s[1][0], s[1][1]), pa3 = pack_bf16(s[1][2], s[1][3]);
        const unsigned char* vb = tv + sub * 16 * RB + v_off;
#pragma unroll
        for (int n = 0; n < HD / 8; n += 2) {
          uint32_t vf[4];
          ldsm4_t(vf, vb + n * 16);
          mma_bf16(o[n], pa0, pa1, pa2, pa3, vf[0], vf[1]);
          mma_bf16(o[n + 1], pa0, pa1, pa2, pa3, vf[2], vf[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; i++) {  // l over the quad
      lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
      lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the merge

    // the WS warps of a row tile merge: warps ws > 0 leave (o, m, l) in
    // shared memory, fragment by fragment; warp ws = 0 folds them in
    float* mo = reinterpret_cast<float*>(ring);            // [(WS - 1) * RT][HD / 2][32]
    float* mml = mo + (WS - 1) * a.RT * (HD / 2) * 32;     // [(WS - 1) * RT][4][32]
    if (ws > 0) {
      const int slot = (ws - 1) * a.RT + rt;
      float* dst = mo + (size_t)slot * (HD / 2) * 32 + lane;
#pragma unroll
      for (int n = 0; n < HD / 8; n++)
#pragma unroll
        for (int e = 0; e < 4; e++) dst[(4 * n + e) * 32] = o[n][e];
      float* d2 = mml + slot * 128 + lane;
      d2[0] = mrow[0];
      d2[32] = mrow[1];
      d2[64] = lrow[0];
      d2[96] = lrow[1];
    }
    __syncthreads();
    if (ws == 0) {
      for (int w = 1; w < WS; w++) {
        const int slot = (w - 1) * a.RT + rt;
        const float* src = mo + (size_t)slot * (HD / 2) * 32 + lane;
        const float* s2 = mml + slot * 128 + lane;
        float f0[2], f1[2];
#pragma unroll
        for (int i = 0; i < 2; i++) {
          const float mw = s2[32 * i], mn = fmaxf(mrow[i], mw);
          f0[i] = mrow[i] == -INFINITY ? 0.f : ex2((mrow[i] - mn) * a.scale_log2);
          f1[i] = mw == -INFINITY ? 0.f : ex2((mw - mn) * a.scale_log2);
          lrow[i] = lrow[i] * f0[i] + s2[64 + 32 * i] * f1[i];
          mrow[i] = mn;
        }
#pragma unroll
        for (int n = 0; n < HD / 8; n++)
#pragma unroll
          for (int e = 0; e < 4; e++)
            o[n][e] = o[n][e] * f0[e >> 1] + src[(4 * n + e) * 32] * f1[e >> 1];
      }
      // the chunk's state, live rows only; the output itself when the
      // chunk is the only live one
#pragma unroll
      for (int i = 0; i < 2; i++) {
        const int r = rt * 16 + g8 + 8 * i;
        if (r >= Rn) continue;
        if (ncl == 1) {
          const float inv = 1.0f / fmaxf(lrow[i], 1e-37f);
          float* dst = out_row(r) + 2 * t4;
#pragma unroll
          for (int n = 0; n < HD / 8; n++)
            *reinterpret_cast<float2*>(dst + 8 * n) =
                make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
          continue;
        }
        float* dst = a.pacc + (pidx * GR + r) * HD + 2 * t4;
#pragma unroll
        for (int n = 0; n < HD / 8; n++)
          *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
        if (t4 == 0) {
          a.pm[pidx * GR + r] = mrow[i];
          a.pl[pidx * GR + r] = lrow[i];
        }
      }
    }
  }
  if (ncl == 1) return;

  // the last block of the group folds the live chunks (K12's ticket)
  __syncthreads();
  if (tid == 0) {
    int t;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(t)
                 : "l"(a.ticket + grp)
                 : "memory");
    const bool last = t == a.NC - 1;
    if (last) a.ticket[grp] = 0;  // ready for the next launch
    sFlag = last;
  }
  __syncthreads();
  if (!sFlag) return;

  // every chunk's (m, l) of every row at once; then a thread a row takes
  // its max, the weights exp(m_c - m) and 1 / max(l, 1e-37) in shared
  // memory; then two (row, four columns) items a thread, every chunk's
  // loads in flight
  float* sM = reinterpret_cast<float*>(va_smem);  // [VA_ROWS][VA_MAX_CHUNKS]: m, then weights
  float* sL = sM + VA_ROWS * VA_MAX_CHUNKS;
  float* sInv = sL + VA_ROWS * VA_MAX_CHUNKS;
  const float* gm = a.pm + grp * a.NC * GR;
  const float* gl = a.pl + grp * a.NC * GR;
#pragma unroll 4
  for (int i = tid; i < Rn * ncl; i += nthr) {
    const int r = i / ncl, cc = i % ncl;
    sM[r * VA_MAX_CHUNKS + cc] = __ldcg(gm + cc * GR + r);
    sL[r * VA_MAX_CHUNKS + cc] = __ldcg(gl + cc * GR + r);
  }
  __syncthreads();
  if (tid < Rn) {
    float* wm = sM + tid * VA_MAX_CHUNKS;
    const float* wl = sL + tid * VA_MAX_CHUNKS;
    float mx = -INFINITY, l = 0.f;
    for (int cc = 0; cc < ncl; cc++) mx = fmaxf(mx, wm[cc]);
    for (int cc = 0; cc < ncl; cc++) {
      const float f = wm[cc] == -INFINITY ? 0.f : ex2((wm[cc] - mx) * a.scale_log2);
      wm[cc] = f;
      l += wl[cc] * f;
    }
    sInv[tid] = 1.0f / fmaxf(l, 1e-37f);
  }
  __syncthreads();
  const float* ga = a.pacc + grp * a.NC * GR * HD;
  const int items = Rn * HD / 4;
  for (int i0 = tid; i0 < items; i0 += 2 * nthr) {
    const int i1 = min(i0 + nthr, items - 1);  // a second item, or the first again
    const int r0 = 4 * i0 / HD, d0 = 4 * i0 % HD, r1 = 4 * i1 / HD, d1 = 4 * i1 % HD;
    const float* w0 = sM + r0 * VA_MAX_CHUNKS;
    const float* w1 = sM + r1 * VA_MAX_CHUNKS;
    const float4* src0 = reinterpret_cast<const float4*>(ga + (size_t)r0 * HD + d0);
    const float4* src1 = reinterpret_cast<const float4*>(ga + (size_t)r1 * HD + d1);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
#pragma unroll 16
    for (int cc = 0; cc < ncl; cc++) {
      const float4 u = __ldcg(src0 + (size_t)cc * (GR * HD / 4));
      const float4 v = __ldcg(src1 + (size_t)cc * (GR * HD / 4));
      const float f = w0[cc], g = w1[cc];
      x.x = fmaf(u.x, f, x.x);
      x.y = fmaf(u.y, f, x.y);
      x.z = fmaf(u.z, f, x.z);
      x.w = fmaf(u.w, f, x.w);
      y.x = fmaf(v.x, g, y.x);
      y.y = fmaf(v.y, g, y.y);
      y.z = fmaf(v.z, g, y.z);
      y.w = fmaf(v.w, g, y.w);
    }
    const float i0v = sInv[r0], i1v = sInv[r1];
    *reinterpret_cast<float4*>(out_row(r0) + d0) =
        make_float4(x.x * i0v, x.y * i0v, x.z * i0v, x.w * i0v);
    if (i0 + nthr < items)
      *reinterpret_cast<float4*>(out_row(r1) + d1) =
          make_float4(y.x * i1v, y.y * i1v, y.z * i1v, y.w * i1v);
  }
}

template <int HD, int KVT>
cudaError_t launch_verify_kvt(const VaArgs& a, int threads, cudaStream_t st) {
  using P = Va<HD, KVT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      verify_kernel<HD, KVT>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (attr != cudaSuccess) return attr;
  if (a.CS % P::TR != 0 || a.NC < 1 || a.NC > VA_MAX_CHUNKS || a.RT < 1 || a.RT * 16 > VA_ROWS ||
      threads > VA_THREADS || threads % (32 * a.RT) != 0 || P::SUB % (threads / 32 / a.RT) != 0 ||
      (threads / 32 / a.RT - 1) * a.RT > P::SLOTS)
    return cudaErrorInvalidValue;
  dim3 grid(a.NC, a.KVH, a.B * a.NG);
  verify_kernel<HD, KVT><<<grid, threads, P::SMEM, st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_verify(int kvt, const VaArgs& a, int threads, cudaStream_t st) {
  if (kvt == 0) return launch_verify_kvt<HD, 0>(a, threads, st);
  if (kvt == 1) return launch_verify_kvt<HD, 1>(a, threads, st);
  return launch_verify_kvt<HD, 2>(a, threads, st);
}

template <int HD>
int verify_smem(int kvt) {
  return kvt == 0 ? Va<HD, 0>::SMEM : kvt == 1 ? Va<HD, 1>::SMEM : Va<HD, 2>::SMEM;
}


}  // namespace

extern "C" {

// kvt: 0 fp16, 1 bf16, 2 fp8 e5m2; hd in {64, 96, 128, 256}; any M in row
// tiles of mm (4 or 8) query rows. fk/fv/kv_pos null for plain mode. pt
// null for a dense cache (NP >= boff + B slots of S rows; local slot b
// reads slot boff + b), else the (B, S / PR) page table of a pool of NP
// pages of PR rows (S: the logical window) and boff 0. The workspace
// pacc/pm/pl holds NC = ceil(S / CS) chunks of each (b, kv head, row tile)
// and ticket one zeroed int of each, left zeroed. mo/lo null for the
// normalised output; else partials mode: out = acc, mo/lo (B, KVH * M) = m
// and l.
int calm_decode_attention(const void* q, const void* k, const void* v,
                          const void* kv_len, const void* fk, const void* fv,
                          const void* kv_pos, const void* pt, void* pacc,
                          void* pm, void* pl, void* ticket, void* out, void* mo,
                          void* lo, int B, int KVH, int M, int S, int hd,
                          int layer, int CS, int kvt, int NP, int PR, int mm,
                          int boff, void* stream) {
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
  a.ticket = static_cast<int*>(ticket);
  a.out = static_cast<float*>(out);
  a.mo = static_cast<float*>(mo);
  a.lo = static_cast<float*>(lo);
  a.B = B;
  a.KVH = KVH;
  a.M = M;
  a.S = S;
  a.layer = layer;
  a.CS = CS;
  a.NC = (S + CS - 1) / CS;
  a.NP = NP;
  a.PR = PR;
  a.pr_shift = -1;
  for (int s = 0; s < 31; s++)
    if ((1 << s) == PR) a.pr_shift = s;
  a.NT = (M + mm - 1) / mm;
  a.boff = boff;
  a.scale = 1.0f / sqrtf((float)hd);
  switch (hd) {
    case 64: return (int)launch_paged<64>(kvt, mm, a, st);
    case 96: return (int)launch_paged<96>(kvt, mm, a, st);
    case 128: return (int)launch_paged<128>(kvt, mm, a, st);
    case 256: return (int)launch_paged<256>(kvt, mm, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the dynamic shared memory one decode block asks for (for reports)
int calm_decode_smem(int hd, int kvt, int mm) {
#define DA_SMEM(H, K, MQ) \
  if (hd == H && kvt == K && mm == MQ) \
    return decode_smem<H, K, MQ>();
#define DA_SMEM_KVT(H, MQ) DA_SMEM(H, 0, MQ) DA_SMEM(H, 1, MQ) DA_SMEM(H, 2, MQ)
#define DA_SMEM_HD(H) DA_SMEM_KVT(H, 4) DA_SMEM_KVT(H, 8)
  DA_SMEM_HD(64) DA_SMEM_HD(96) DA_SMEM_HD(128) DA_SMEM_HD(256)
#undef DA_SMEM_HD
#undef DA_SMEM_KVT
#undef DA_SMEM
  return -1;
}

// q/out (B, T, KVH, M, hd) f32, caches (L, Bc, KVH, S, hd) in kvt (0 fp16,
// 1 bf16, 2 fp8 e5m2) of which sequence b reads slot boff + b, pos0/kv_len
// (B,) int32; hd in {64, 96, 128, 256}; any M; q and the caches 16-byte
// aligned. grid: the persistent blocks (at most one an SM fits), which walk
// the work items in ops/hopper_attn.prefill_plan's order.
int calm_prefill_attention(const void* q, const void* k, const void* v,
                           const void* pos0, const void* kv_len, void* out,
                           int B, int T, int KVH, int M, int S, int hd,
                           int layer, int kvt, int L, int Bc, int boff, int grid,
                           void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
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
    case 64: return (int)launch_prefill<64>(kvt, a, k, v, L, grid, st);
    case 96: return (int)launch_prefill<96>(kvt, a, k, v, L, grid, st);
    case 128: return (int)launch_prefill<128>(kvt, a, k, v, L, grid, st);
    case 256: return (int)launch_prefill<256>(kvt, a, k, v, L, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the dynamic shared memory one prefill block asks for (for reports)
int calm_prefill_smem(int hd, int kvt) {
  switch (hd) {
    case 64: return prefill_smem<64>(kvt);
    case 96: return prefill_smem<96>(kvt);
    case 128: return prefill_smem<128>(kvt);
    case 256: return prefill_smem<256>(kvt);
    default: return -1;
  }
}

// q/out (B, T, KVH, M, hd) f32, caches (L, Bc, KVH, S, hd) in kvt (0 fp16,
// 1 bf16, 2 fp8 e5m2) of which sequence b reads slot boff + b, pos0/kv_len
// (B,) int32; tree null (causal) or a (T, T) bool mask (node t sees the
// rows below kv_len - T and the tree rows tree[t] marks). CS, RT, NG and
// threads come from ops/hopper_attn.verify_plan; the workspace pacc/pm/pl
// holds NC = ceil(S / CS) chunks of each (b, kv head, row group) and ticket
// one zeroed int of each, left zeroed.
int calm_verify_attention(const void* q, const void* k, const void* v,
                          const void* pos0, const void* kv_len, const void* tree,
                          void* pacc, void* pm, void* pl, void* ticket, void* out,
                          int B, int T, int KVH, int M, int S, int hd, int layer,
                          int kvt, int Bc, int boff, int CS, int RT, int NG,
                          int threads, void* stream) {
  if (CS < 1) return (int)cudaErrorInvalidValue;
  VaArgs a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.pos0 = static_cast<const int*>(pos0);
  a.kv_len = static_cast<const int*>(kv_len);
  a.tree = static_cast<const unsigned char*>(tree);
  a.pacc = static_cast<float*>(pacc);
  a.pm = static_cast<float*>(pm);
  a.pl = static_cast<float*>(pl);
  a.ticket = static_cast<int*>(ticket);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.T = T;
  a.KVH = KVH;
  a.M = M;
  a.S = S;
  a.layer = layer;
  a.Bc = Bc;
  a.boff = boff;
  a.CS = CS;
  a.NC = (S + CS - 1) / CS;
  a.RT = RT;
  a.NG = NG;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: return (int)launch_verify<64>(kvt, a, threads, st);
    case 96: return (int)launch_verify<96>(kvt, a, threads, st);
    case 128: return (int)launch_verify<128>(kvt, a, threads, st);
    case 256: return (int)launch_verify<256>(kvt, a, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the dynamic shared memory one split-S block asks for (for reports)
int calm_verify_smem(int hd, int kvt) {
  switch (hd) {
    case 64: return verify_smem<64>(kvt);
    case 96: return verify_smem<96>(kvt);
    case 128: return verify_smem<128>(kvt);
    case 256: return verify_smem<256>(kvt);
    default: return -1;
  }
}

const char* calm_attn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
