// Split-K paged decode attention for Hopper (sm_90a), fp32 and bf16.
//
// Replaces: the Pallas TPU kernel `decode_attention_paged`
// (src/repro/kernels/decode_attention.py, body `_dec_paged_kernel`) and
// its jnp `_combine_splits`.
//
// What it computes: for each row b, one query per head attends the row's
// live prefix [0, cache_len[b]) held in the shared page pool
// [num_pages, page_size, KV, D] and addressed through the row's block
// table [B, max_pages].  Table entries past the prefix may be sentinels
// (>= num_pages); they are clamped to num_pages-1 BEFORE any address is
// formed, because an unclamped sentinel is an out-of-bounds read on the
// card.  A row with cache_len == 0 returns zeros, as the Pallas kernel
// does.
//
// What bounds it: bytes.  Each live K/V element is read once and used for
// G (= H/KV, 8 at tinyllama width) query heads, about 4 FLOPs per byte
// of bf16 cache -- far below the ~295 FLOPs/byte where the H100's tensor
// cores become the limit.  So the design spends nothing on tensor cores
// and everything on reading each live page once with enough blocks in
// flight:
//   * one block per (row, KV head, span of logical pages); the span is
//     chosen by the wrapper so the grid holds ~264 blocks (2 per SM), and
//     each block runs an online softmax across its pages in fp32;
//   * the GQA group of G heads shares one K/V page tile in shared memory,
//     so a page is read from device memory once per KV head, not per head;
//   * blocks whose span starts at or past cache_len write neutral
//     partials (m = -1e30, l = 0, acc = 0) without touching the pool, so
//     the bytes read follow the live prefix, not max_pages;
//   * a second, tiny kernel merges the fp32 partials into [B, H, D] in
//     q's dtype.
// Plain FMA on CUDA cores; wgmma/TMA are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// grid (nsplit, B*KV), kThreads threads.  Partials are laid out
// [B*KV, nsplit, G] (m, l) and [B*KV, nsplit, G, D] (acc).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ cache_len, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, int H, int KV,
    int num_pages, int page_size, int max_pages, int span, int nsplit,
    float scale) {
  const int split = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int len = cache_len[b];
  const int p0 = split * span;
  const int p1 = min(p0 + span, max_pages);
  const size_t part = (size_t)bkv * nsplit + split;
  float* m_dst = m_out + part * G;
  float* l_dst = l_out + part * G;
  float* acc_dst = acc_out + part * G * D;

  if (p0 * page_size >= len) {  // span wholly past the live prefix
    for (int i = tid; i < G; i += kThreads) {
      m_dst[i] = kNegInf;
      l_dst[i] = 0.f;
    }
    for (int i = tid; i < G * D; i += kThreads) acc_dst[i] = 0.f;
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;                           // [G][D]
  float* k_s = q_s + G * D;                    // [page_size][D+1] (padded)
  float* v_s = k_s + page_size * (D + 1);      // [page_size][D]
  float* p_s = v_s + page_size * D;            // [G][page_size] scores/probs
  float* acc_s = p_s + G * page_size;          // [G][D]
  float* m_s = acc_s + G * D;                  // [G] running max
  float* l_s = m_s + G;                        // [G] running denominator
  float* a_s = l_s + G;                        // [G] rescale of this page

  const T* q_row = q + ((size_t)b * H + (size_t)kv * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q_row[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < G; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  for (int p = p0; p < p1; ++p) {
    const int lo = p * page_size;
    if (lo >= len) break;  // uniform over the block
    int phys = block_table[(size_t)b * max_pages + p];
    phys = min(max(phys, 0), num_pages - 1);  // clamp before addressing
    __syncthreads();  // the previous page's readers are done
    const size_t page_off = ((size_t)phys * page_size * KV + kv) * D;
    for (int i = tid; i < page_size * D; i += kThreads) {
      const int t = i / D;
      const int d = i % D;
      const size_t off = page_off + (size_t)t * KV * D + d;
      k_s[t * (D + 1) + d] = to_f32(k_pages[off]);
      v_s[t * D + d] = to_f32(v_pages[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * page_size; i += kThreads) {
      const int g = i / page_size;
      const int t = i % page_size;
      float s = kNegInf;
      if (lo + t < len) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += q_s[g * D + d] * k_s[t * (D + 1) + d];
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float* row = p_s + g * page_size;
      float mb = kNegInf;
      for (int t = 0; t < page_size; ++t)
        if (lo + t < len) mb = fmaxf(mb, row[t]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mb);
      float sum = 0.f;
      for (int t = 0; t < page_size; ++t) {
        const float e = (lo + t < len) ? expf(row[t] - m_new) : 0.f;
        row[t] = e;
        sum += e;
      }
      const float alpha = expf(m_old - m_new);
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      const float* row = p_s + g * page_size;
      float a = acc_s[i] * a_s[g];
      for (int t = 0; t < page_size; ++t) a += row[t] * v_s[t * D + d];
      acc_s[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G; i += kThreads) {
    m_dst[i] = m_s[i];
    l_dst[i] = l_s[i];
  }
  for (int i = tid; i < G * D; i += kThreads) acc_dst[i] = acc_s[i];
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_table, const int* cache_len, float* m,
                   float* l, float* acc, void* out, int B, int H, int KV,
                   int num_pages, int page_size, int max_pages, int span,
                   int nsplit, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)page_size * (D + 1) +
                                       (size_t)page_size * D + (size_t)G * page_size +
                                       (size_t)G * D + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_split_kernel<T, D><<<dim3(nsplit, B * KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_table, cache_len, m, l, acc, H, KV,
      num_pages, page_size, max_pages, span, nsplit, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T, D><<<B * KV, kCombineThreads, 0, stream>>>(
      m, l, acc, static_cast<T*>(out), H, KV, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* kp, const void* vp,
                         const int* bt, const int* lens, float* m, float* l,
                         float* acc, void* out, int B, int H, int KV,
                         int num_pages, int page_size, int max_pages, int span,
                         int nsplit, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, scale, s);
    case 32: return launch<T, 32>(q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, scale, s);
    case 64: return launch<T, 64>(q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, scale, s);
    case 96: return launch<T, 96>(q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, scale, s);
    case 128: return launch<T, 128>(q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_paged(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* cache_len, void* m, void* l,
    void* acc, void* out, int B, int H, int KV, int D, int num_pages,
    int page_size, int max_pages, int span, int nsplit, float scale,
    void* stream) {
  if (B == 0) return cudaSuccess;
  if (KV <= 0 || H % KV || num_pages <= 0 || page_size <= 0 || max_pages <= 0 ||
      span <= 0 || nsplit <= 0)
    return cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(cache_len);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(D, q, k_pages, v_pages, bt, lens, mf, lf, af, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(D, q, k_pages, v_pages, bt, lens, mf, lf, af, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
