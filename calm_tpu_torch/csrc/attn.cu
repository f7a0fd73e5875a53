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
