// Code shared by the kernels: fp32/bf16 conversions (the attention
// kernels and rmsnorm), the empty span and the split-K combine pass of the
// two decode kernels, and the per-card raise of a kernel's dynamic
// shared-memory cap.  Each kernel source includes this header and is
// built into its own library, so everything here sits in an anonymous
// namespace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kCombineThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// A decode block whose span holds nothing live, with its THREADS threads:
// zeros into the group's out rows [grp, grp + G*D) when a row is one span,
// else a neutral partial (m = -1e30, l = 0, acc = 0) at partial `part`,
// laid out as decode_combine_kernel reads it.
template <typename T, int D, int THREADS>
__device__ __forceinline__ void decode_empty_span(T* out, float* m_out, float* l_out,
                                                  float* acc_out, size_t grp, size_t part,
                                                  int G, int nsplit) {
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    if (nsplit == 1) {
      out[grp + i] = from_f32<T>(0.f);
    } else {
      acc_out[part * G * D + i] = 0.f;
      if (i < G) {
        m_out[part * G + i] = kNegInf;
        l_out[part * G + i] = 0.f;
      }
    }
  }
}

// grid (B*KV), kCombineThreads threads: merge the nsplit fp32 partials of
// each head, laid out [B*KV, nsplit, G] (m, l) and [B*KV, nsplit, G, D]
// (acc), into out [B, H, D] in T.
template <typename T, int D>
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ acc_in, T* __restrict__ out, int H, int KV,
    int nsplit) {
  const int bkv = blockIdx.x;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int G = H / KV;
  for (int i = threadIdx.x; i < G * D; i += kCombineThreads) {
    const int g = i / D;
    const int d = i % D;
    float m_all = kNegInf;
    for (int s = 0; s < nsplit; ++s)
      m_all = fmaxf(m_all, m_in[((size_t)bkv * nsplit + s) * G + g]);
    float l_tot = 0.f;
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t part = (size_t)bkv * nsplit + s;
      const float w = expf(m_in[part * G + g] - m_all);
      l_tot += l_in[part * G + g] * w;
      acc += acc_in[(part * G + g) * D + d] * w;
    }
    // an empty row has only neutral partials: acc 0 over 1e-30 is 0
    out[((size_t)b * H + (size_t)kv * G + g) * D + d] =
        from_f32<T>(acc / fmaxf(l_tot, 1e-30f));
  }
}

// cudaFuncSetAttribute sets the attribute of the function in the current
// card's context, so a kernel's cap is raised once on each card it runs on:
// `raised` is the caller's flags, one a card (a static array of the
// launcher, zero-initialised); the launcher's card is current (the Python
// wrappers make the tensors' card current around every launch).
constexpr int kMaxCards = 64;

template <typename Kernel>
inline cudaError_t raise_smem_cap(bool (&raised)[kMaxCards], Kernel kernel, int bytes) {
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (card < 0 || card >= kMaxCards) return cudaErrorInvalidDevice;
  if (raised[card]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) raised[card] = true;
  return e;
}

}  // namespace
