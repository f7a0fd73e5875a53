// In-place ring sum all-reduce of n buffers (K14).
//
// Replaces calm_tpu/ops/pallas_collectives.py:_ring_kernel (:42), reached
// through ring_all_reduce (:111): each of n ranks holds an (n, chunk) view
// of its data and, after 2(n-1) steps over a 1-D ring, every rank holds the
// elementwise sum. At step s rank r sends chunk (r - s) mod n into its right
// neighbour's receive slot s mod 2 and receives chunk (r - s - 1) mod n from
// its left one; in the first n-1 steps it adds the received chunk to its own
// (reduce-scatter), in the rest it copies it (all-gather). So chunk c adds up
// in the ring's order: rank c's value, then c+1's, c+2's, ... round to
// c-1's, which then owns it and starts the gather.
//
// The protocol is the TPU kernel's: an entry barrier with both neighbours;
// a flag per receive slot, written with release semantics after the data;
// a consumption ack that the sender waits for before it reuses a slot two
// steps later; and a drain of the last two acks at the end. Every flag
// carries the call's epoch in its high 32 bits (and step + 1 in the low
// ones; 0 at entry), so back-to-back calls need no reset launch. The flags
// lie at fixed offsets by RING_GMAX, not by this call's block count, so a
// slot only ever holds its own kind of flag from an earlier call, which is
// below this call's epoch.
//
// The device code reaches each rank's buffer, receive slots and flags
// through arrays of pointers (RingArgs), so a launcher for several GPUs
// with peer pointers adds host code only. This file's launcher runs the n
// ranks on one device in one cooperative launch: rank r is blocks
// [r G, (r+1) G), block j of every rank works on segment j of each chunk
// (an independent ring per segment), and the cooperative launch fails
// rather than leave a block unscheduled while another spins on its flag.
//
// What bounds it on an H100: device memory. Each step moves a segment from
// the sender's chunk into the receiver's slot and reads it back (plus the
// receiver's chunk in the reduce steps): about 9 (n-1) chunk-sized passes
// a rank. One thread 0 a block spins on a flag between steps, so small
// sizes are bound by the flag round trips (a few microseconds a step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RING_MAX 16     // ranks
#define RING_GMAX 256   // blocks a rank (segments)
#define RING_THREADS 256

namespace {

typedef unsigned long long u64;

struct RingArgs {
  void* buf[RING_MAX];   // rank r's (n, chunk) data, reduced in place
  void* slot[RING_MAX];  // rank r's receive slots: (G, 2, seg)
  u64* flag[RING_MAX];   // rank r's flags: arrive (GMAX, 2), ack (GMAX), entry (GMAX)
  int n, chunk, G, seg;
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

// reads of a receive slot bypass L1: another SM wrote it since the last read
__device__ __forceinline__ float ld_slot(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_slot(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
}

// flag offsets in a rank's 4 RING_GMAX flags, for segment j
__device__ __forceinline__ int arrive_at(int j, int sl) { return j * 2 + sl; }
__device__ __forceinline__ int ack_at(int j) { return 2 * RING_GMAX + j; }
__device__ __forceinline__ int entry_at(int j) { return 3 * RING_GMAX + j; }

template <typename T>
__global__ void __launch_bounds__(RING_THREADS) ring_kernel(RingArgs a) {
  const int n = a.n, G = a.G;
  const int r = blockIdx.x / G, j = blockIdx.x % G;
  const int right = (r + 1) % n, left = (r + n - 1) % n;
  const int e0 = j * a.seg, len = min(a.seg, a.chunk - e0);  // may be <= 0
  const u64 E = a.epoch << 32;
  u64* mine = a.flag[r];
  T* buf = static_cast<T*>(a.buf[r]);
  const int tid = threadIdx.x;

  // entry barrier: both neighbours are in this call
  if (tid == 0) {
    st_release(mine + entry_at(j), E);
    wait_at_least(a.flag[left] + entry_at(j), E);
    wait_at_least(a.flag[right] + entry_at(j), E);
  }
  __syncthreads();

  const int steps = 2 * (n - 1);
  for (int s = 0; s < steps; s++) {
    const int sl = s & 1;
    const int send_c = ((r - s) % n + n) % n;
    const int recv_c = ((r - s - 1) % n + n) % n;
    if (s >= 2) {  // the right neighbour has read what we sent at step s - 2
      if (tid == 0) wait_at_least(mine + ack_at(j), E | (u64)(s - 1));
      __syncthreads();
    }
    T* dst = static_cast<T*>(a.slot[right]) + ((size_t)j * 2 + sl) * a.seg;
    const T* src = buf + (size_t)send_c * a.chunk + e0;
    for (int i = tid; i < len; i += RING_THREADS) dst[i] = src[i];
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      st_release(a.flag[right] + arrive_at(j, sl), E | (u64)(s + 1));
      wait_at_least(mine + arrive_at(j, sl), E | (u64)(s + 1));  // our slot is full
    }
    __syncthreads();
    const T* in = static_cast<const T*>(a.slot[r]) + ((size_t)j * 2 + sl) * a.seg;
    T* o = buf + (size_t)recv_c * a.chunk + e0;
    if (s < n - 1) {
      for (int i = tid; i < len; i += RING_THREADS) o[i] = add(o[i], ld_slot(in + i));
    } else {
      for (int i = tid; i < len; i += RING_THREADS) o[i] = ld_slot(in + i);
    }
    __syncthreads();
    if (tid == 0) st_release(a.flag[left] + ack_at(j), E | (u64)(s + 1));  // ack
  }
  // drain: the right neighbour has read our last two sends
  if (tid == 0) wait_at_least(mine + ack_at(j), E | (u64)steps);
}

template <typename T>
cudaError_t launch(RingArgs& a, cudaStream_t st) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel<T>,
                                                      RING_THREADS, 0);
  if (e != cudaSuccess) return e;
  // as many blocks a rank as fit at once, none with less than 4 elements a thread
  int G = min(RING_GMAX, per_sm * sms / a.n);
  G = min(G, (a.chunk + 4 * RING_THREADS - 1) / (4 * RING_THREADS));
  a.G = G < 1 ? 1 : G;
  a.seg = (a.chunk + a.G - 1) / a.G;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)ring_kernel<T>, dim3(a.n * a.G),
                                  dim3(RING_THREADS), args, 0, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bufs/slots/flags: host arrays of n device pointers. Rank r's buffer holds
// (n, chunk) elements of dtype (0 f32, 1 bf16); its slots 2 (chunk +
// RING_GMAX) elements; its flags 4 RING_GMAX u64, zeroed once before the
// first call. epoch: above every earlier call's on these flags. n in
// [2, RING_MAX].
int calm_ring_all_reduce(const void* bufs, const void* slots, const void* flags,
                         int n, int chunk, int dtype, long long epoch,
                         void* stream) {
  if (n < 2 || n > RING_MAX || chunk < 1 || epoch < 1)
    return (int)cudaErrorInvalidValue;
  RingArgs a;
  for (int r = 0; r < n; r++) {
    a.buf[r] = static_cast<void* const*>(bufs)[r];
    a.slot[r] = static_cast<void* const*>(slots)[r];
    a.flag[r] = static_cast<u64* const*>(flags)[r];
  }
  a.n = n;
  a.chunk = chunk;
  a.epoch = (u64)epoch;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch<float>(a, st) : launch<__nv_bfloat16>(a, st));
}

int calm_ring_gmax() { return RING_GMAX; }

const char* calm_ring_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
