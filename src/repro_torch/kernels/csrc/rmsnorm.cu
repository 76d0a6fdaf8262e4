// Row RMSNorm for Hopper (sm_90a), x and w each fp32 or bf16.
//
// Replaces: the Pallas TPU kernel `rmsnorm` (src/repro/kernels/rmsnorm.py,
// body `_rms_kernel`).
//
// What it computes: for each row of x [rows, d],
// out = (x * rsqrt(mean(x^2) + eps)) * w, with x, the mean-square, rsqrt
// and both multiplies in fp32 and the result cast to x's dtype (round to
// nearest even).  This is the fused kernel's function, not the model's
// norm (which multiplies in x's dtype): the two differ in bf16.
//
// What bounds it: bytes.  One read and one write of x, about four flops
// per element.  At [4096, 2048] bf16 that is 33.6 MB, ~10 us at
// 3.35 TB/s.  The TPU kernel holds a [256, d] tile in VMEM; on the card a
// row is short enough to reduce where it is read:
//   * one warp per row when d <= 1024 (eight rows to a 256-thread block),
//     else the whole 256-thread block per row, so any d from 1 up works;
//   * each thread sums its squares in fp32, a warp reduces with shuffles
//     and, for a block per row, the eight warp sums meet in shared memory
//     and are added in a fixed order;
//   * x is read 16 bytes a thread (4 fp32 or 8 bf16) and out written the
//     same way when d is a multiple of that and the pointers are 16-byte
//     aligned; else one element at a time;
//   * the second pass re-reads the row, which its block has just read, so
//     it comes from L1/L2 and device memory sees x about once.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int TPR>
__device__ __forceinline__ float row_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (TPR == 32) return s;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  return t;
}

// TPR threads per row (32 or kThreads); VEC: 16-byte loads and stores.
template <typename TX, typename TW, int TPR, bool VEC>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
    int rows, int d, float eps) {
  __shared__ float red[kThreads / 32];
  constexpr int kRowsPerBlock = kThreads / TPR;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  if (row >= rows) return;  // a whole warp (TPR 32) or never (TPR kThreads)
  const int t = threadIdx.x % TPR;
  const TX* xr = x + row * d;
  TX* outr = out + row * d;
  constexpr int kN = 16 / sizeof(TX);  // elements per 16-byte access

  float ss = 0.f;
  if (VEC) {
    for (int i = t; i < d / kN; i += TPR) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = t; i < d; i += TPR) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(row_sum<TPR>(ss, red) / (float)d + eps);

  if (VEC) {
    for (int i = t; i < d / kN; i += TPR) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      TX* e = reinterpret_cast<TX*>(&raw);
#pragma unroll
      for (int j = 0; j < kN; ++j)
        e[j] = from_f32<TX>(to_f32(e[j]) * r * to_f32(w[i * kN + j]));
      reinterpret_cast<uint4*>(outr)[i] = raw;
    }
  } else {
    for (int i = t; i < d; i += TPR)
      outr[i] = from_f32<TX>(to_f32(xr[i]) * r * to_f32(w[i]));
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t s) {
  const bool vec = d % (int)(16 / sizeof(TX)) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  if (d <= 1024) {
    const int grid = (int)((rows + 7LL) / 8);  // 8 warps, a row each
    if (vec)
      rmsnorm_kernel<TX, TW, 32, true><<<grid, kThreads, 0, s>>>(xp, wp, op, rows, d, eps);
    else
      rmsnorm_kernel<TX, TW, 32, false><<<grid, kThreads, 0, s>>>(xp, wp, op, rows, d, eps);
  } else if (vec) {
    rmsnorm_kernel<TX, TW, kThreads, true><<<rows, kThreads, 0, s>>>(xp, wp, op, rows, d, eps);
  } else {
    rmsnorm_kernel<TX, TW, kThreads, false><<<rows, kThreads, 0, s>>>(xp, wp, op, rows, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out [rows, d]; w [d].  dtype codes: 0 = fp32, 1 = bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm(int dtype_x, int dtype_w, const void* x, const void* w,
                       void* out, int rows, int d, float eps, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (rows < 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_x == 0 && dtype_w == 0) return launch<float, float>(x, w, out, rows, d, eps, s);
  if (dtype_x == 0 && dtype_w == 1) return launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  if (dtype_x == 1 && dtype_w == 0) return launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
  if (dtype_x == 1 && dtype_w == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
