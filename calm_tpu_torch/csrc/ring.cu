// Sum all-reduce of n tensors (K14), a two-shot over arrays of pointers.
//
// Replaces calm_tpu/ops/pallas_collectives.py:_ring_kernel (:42), reached
// through ring_all_reduce (:111): n ranks each hold a tensor, and every rank
// ends with the elementwise sum. The data is cut into n chunks of `chunk`
// elements (a multiple of 128), and chunk c adds up in the ring's order:
// rank c's value, then c+1's, c+2's, ... round to c-1's. That order is why
// the JAX ring, its plain PyTorch version and this kernel agree bit for bit
// in f32 and bf16. The inputs stay untouched, as the JAX function's do.
//
// What bounds it on an H100: device memory, n inputs read once and n
// outputs written once (2 n numel elements). The ring moved each segment
// through its neighbour's receive slot and read it back, ~9 (n-1) chunk
// passes a rank, in 2 (n-1) steps with a flag round trip each. On one card,
// and across cards that NVLink joins all to all, a ring buys nothing, so
// this is a two-shot that moves exactly the bound's bytes:
// - Shot 1 (reduce): rank r owns chunk r. Its blocks read chunk r's
//   segment from all n ranks' inputs, 16 bytes a load, every rank's load in
//   flight before the first add, and sum them in the ring's order (owner
//   first).
// - Shot 2 (gather): the owner writes each sum into all n ranks' outputs,
//   16 bytes a store.
//
// Flags: rank r has entry (RING_GMAX) and done (RING_GMAX) u64 flags at
// fixed offsets, each carrying the call's epoch in its high 32 bits, so
// back-to-back calls need no reset launch. Block j of rank r sets entry[j]
// and waits for entry[j] of every rank (every rank's inputs are ready: on
// several cards a rank's kernel starts only after its stream's earlier
// work), sums and writes its segment, then sets done[j] (epoch | 1) after a
// fence and waits for done[j] of every rank: every owner has written
// segment j of its chunk into rank r's output before rank r returns.
//
// The device code reaches each rank's input, output and flags through
// arrays of pointers (RingArgs), so a launcher for several GPUs with peer
// pointers adds host code only (flags then need system scope). This file's
// launcher runs the n ranks on one device in one cooperative launch: rank r
// is blocks [r G, (r+1) G), and the cooperative launch fails rather than
// leave a block unscheduled while another spins on its flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define RING_MAX 16     // ranks
#define RING_GMAX 256   // blocks a rank (segments)
#define RING_THREADS 256

namespace {

typedef unsigned long long u64;

struct RingArgs {
  const void* in[RING_MAX];  // rank r's input, n * chunk elements
  void* out[RING_MAX];       // rank r's output, the same
  u64* flag[RING_MAX];       // rank r's flags: entry (GMAX), done (GMAX)
  long long chunk_vec;       // 16-byte vectors a chunk
  long long seg_vec;         // vectors a block's segment
  int G;                     // blocks a rank
  u64 epoch;
};

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void wait_at_least(const u64* p, u64 v) {
  while (ld_acquire(p) < v) {
  }
}

// the elementwise sum of two 16-byte vectors, each add rounded to T as a
// PyTorch add of two T tensors rounds it
template <typename T>
__device__ __forceinline__ uint4 vadd(uint4 a, uint4 b);

template <>
__device__ __forceinline__ uint4 vadd<float>(uint4 a, uint4 b) {
  return make_uint4(__float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x)),
                    __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y)),
                    __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z)),
                    __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w)));
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  const __nv_bfloat162 r = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <>
__device__ __forceinline__ uint4 vadd<__nv_bfloat16>(uint4 a, uint4 b) {
  return make_uint4(add_bf16x2(a.x, b.x), add_bf16x2(a.y, b.y), add_bf16x2(a.z, b.z),
                    add_bf16x2(a.w, b.w));
}

// flag offsets in a rank's 2 RING_GMAX flags, for segment j
__device__ __forceinline__ int entry_at(int j) { return j; }
__device__ __forceinline__ int done_at(int j) { return RING_GMAX + j; }

template <typename T, int N>
__global__ void __launch_bounds__(RING_THREADS) allreduce_kernel(RingArgs a) {
  const int r = blockIdx.x / a.G, j = blockIdx.x % a.G;
  const u64 E = a.epoch << 32;
  const int tid = threadIdx.x;

  // entry barrier: every rank is in this call, its inputs ready
  if (tid == 0) {
    st_release(a.flag[r] + entry_at(j), E);
#pragma unroll
    for (int q = 0; q < N; q++) wait_at_least(a.flag[q] + entry_at(j), E);
  }
  __syncthreads();

  // the owner's chunk r, segment j: inputs in the ring's order from rank r
  const uint4* in[N];
  uint4* out[N];
#pragma unroll
  for (int q = 0; q < N; q++) {
    in[q] = static_cast<const uint4*>(a.in[(r + q) % N]);
    out[q] = static_cast<uint4*>(a.out[q]);
  }
  const long long base = (long long)r * a.chunk_vec;
  const long long v1 = base + min((long long)(j + 1) * a.seg_vec, a.chunk_vec);
  for (long long v = base + (long long)j * a.seg_vec + tid; v < v1; v += RING_THREADS) {
    uint4 x[N];
#pragma unroll
    for (int q = 0; q < N; q++) x[q] = __ldcs(in[q] + v);  // read once: evict first
    uint4 s = x[0];
#pragma unroll
    for (int q = 1; q < N; q++) s = vadd<T>(s, x[q]);
#pragma unroll
    for (int q = 0; q < N; q++) out[q][v] = s;
  }

  // exit barrier: every owner has written segment j into rank r's output
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    st_release(a.flag[r] + done_at(j), E | 1);
#pragma unroll
    for (int q = 0; q < N; q++) wait_at_least(a.flag[q] + done_at(j), E | 1);
  }
}

template <typename T, int N>
cudaError_t launch(RingArgs& a, cudaStream_t st) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, allreduce_kernel<T, N>,
                                                      RING_THREADS, 0);
  if (e != cudaSuccess) return e;
  // as many blocks a rank as fit at once, none with less than a vector a thread
  long long G = std::min(RING_GMAX, per_sm * sms / N);
  G = std::min(G, (a.chunk_vec + RING_THREADS - 1) / RING_THREADS);
  a.G = G < 1 ? 1 : (int)G;
  a.seg_vec = (a.chunk_vec + a.G - 1) / a.G;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)allreduce_kernel<T, N>, dim3(N * a.G),
                                  dim3(RING_THREADS), args, 0, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int n, RingArgs& a, cudaStream_t st) {
  switch (n) {
#define RING_N(K) \
  case K:         \
    return launch<T, K>(a, st);
    RING_N(2) RING_N(3) RING_N(4) RING_N(5) RING_N(6) RING_N(7) RING_N(8) RING_N(9)
    RING_N(10) RING_N(11) RING_N(12) RING_N(13) RING_N(14) RING_N(15) RING_N(16)
#undef RING_N
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// ins/outs/flags: host arrays of n device pointers. Rank r's input and
// output hold n * chunk elements of dtype (0 f32, 1 bf16), 16-byte aligned;
// chunk a multiple of 128; its flags 2 RING_GMAX u64, zeroed once before
// the first call. epoch: above every earlier call's on these flags. n in
// [2, RING_MAX].
int calm_ring_all_reduce(const void* ins, const void* outs, const void* flags, int n,
                         long long chunk, int dtype, long long epoch, void* stream) {
  if (n < 2 || n > RING_MAX || chunk < 1 || chunk % 128 != 0 || epoch < 1)
    return (int)cudaErrorInvalidValue;
  RingArgs a;
  for (int r = 0; r < n; r++) {
    a.in[r] = static_cast<void* const*>(ins)[r];
    a.out[r] = static_cast<void* const*>(outs)[r];
    a.flag[r] = static_cast<u64* const*>(flags)[r];
  }
  a.chunk_vec = chunk / (dtype == 0 ? 4 : 8);
  a.epoch = (u64)epoch;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_n<float>(n, a, st) : launch_n<__nv_bfloat16>(n, a, st));
}

int calm_ring_gmax() { return RING_GMAX; }

const char* calm_ring_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
