// Per-block bucket histograms of the dataframe shuffle's key hash for
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `hash_partition_histogram`
// (src/repro/kernels/hash_partition.py, body `_hist_kernel`).
//
// What it computes: keys [R, N] int32, R independent rows (the shards of a
// table, or one), each cut into nb blocks of `block` keys:
// out[r, b, p] = the number of keys of block b of row r whose bucket is p,
// where h = k * 2654435761, h ^= h >> 16 (uint32) and the bucket is h % P.
// The last block of a row counts only the keys before N: the TPU kernel
// pads with -1 and subtracts the padding afterwards, this kernel never
// reads past N.
//
// What bounds it: bytes.  Each key is read once (4 bytes) for about six
// integer operations and one shared-memory atomic; the output is nb * P
// counters.  At one shard of 2^23 keys that is 33.6 MB, ~10 us at
// 3.35 TB/s.  The TPU kernel compares each key against every bucket
// (P x block compare-reduces on the VPU); on the card a shared-memory
// counter per bucket does the same in one atomic per key:
//   * grid (nb, R): one 256-thread block per (row, block of keys); a shard
//     of 2^23 keys at block 2048 gives 4096 blocks, enough to fill the
//     132 SMs;
//   * a histogram of P int32 counters in dynamic shared memory (above
//     48 KB by opt-in, up to the 227 KB a block may use), zeroed, filled
//     with atomicAdd and written out as the block's [P] row: device
//     memory sees each key once and each counter once;
//   * keys are read 16 bytes a thread (int4) when the block's first key is
//     16-byte aligned, else one at a time;
//   * counts are integers, so the order of the atomics changes nothing and
//     the kernel equals its plain version exactly.
// With few buckets (P = 8 shards) many lanes of a warp add into one
// counter and the shared atomics serialize; per-warp sub-histograms are
// later work.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kKnuth = 2654435761u;

__device__ __forceinline__ void count(int* hist, int key, uint32_t P) {
  uint32_t h = static_cast<uint32_t>(key) * kKnuth;
  h ^= h >> 16;
  atomicAdd(&hist[h % P], 1);
}

// grid (nb, R), kThreads threads, P ints of dynamic shared memory.
__global__ void __launch_bounds__(kThreads) hash_hist_kernel(
    const int* __restrict__ keys, int* __restrict__ out, int N, int block,
    int nb, int P) {
  extern __shared__ int hist[];
  const int b = blockIdx.x;
  const int r = blockIdx.y;
  for (int p = threadIdx.x; p < P; p += kThreads) hist[p] = 0;
  __syncthreads();

  const long long lo = (long long)b * block;
  const int len = (int)(min(lo + block, (long long)N) - lo);
  const int* src = keys + (long long)r * N + lo;
  const uint32_t up = static_cast<uint32_t>(P);
  int tail = 0;  // first key not read as part of an int4
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nvec = len / 4;
    const int4* v = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const int4 k = v[i];
      count(hist, k.x, up);
      count(hist, k.y, up);
      count(hist, k.z, up);
      count(hist, k.w, up);
    }
    tail = nvec * 4;
  }
  for (int i = tail + threadIdx.x; i < len; i += kThreads) count(hist, src[i], up);
  __syncthreads();

  int* dst = out + ((long long)r * nb + b) * P;
  for (int p = threadIdx.x; p < P; p += kThreads) dst[p] = hist[p];
}

}  // namespace

// keys [R, N] int32 -> out [R, nb, P] int32, nb = ceil(N / block).
// Returns cudaGetLastError() after the launch.
extern "C" int hash_partition(const void* keys, void* out, int R, int N,
                              int block, int nb, int P, void* stream) {
  if (R == 0) return cudaSuccess;
  if (R < 0 || R > 65535 || N <= 0 || block <= 0 || nb <= 0 || P <= 0 ||
      (long long)nb * block < N || (long long)(nb - 1) * block >= N)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)P * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hash_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  hash_hist_kernel<<<dim3(nb, R), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<int*>(out), N, block, nb, P);
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
