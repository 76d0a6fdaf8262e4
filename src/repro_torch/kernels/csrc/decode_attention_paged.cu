// Paged decode attention for Hopper (sm_90a), fp32 and bf16.
//
// Replaces: the Pallas TPU kernel `decode_attention_paged`
// (src/repro/kernels/decode_attention.py, body `_dec_paged_kernel`) and
// its jnp `_combine_splits`.
//
// What it computes: for each row b, one query per head attends the row's
// live positions held in the shared page pool [num_pages, page_size, KV,
// D] and addressed through the row's block table [B, max_pages]:
// kpos < cache_len[b] and, when window > 0, kpos >= cache_len[b] - window.
// Table entries past the prefix may be sentinels (>= num_pages); they are
// clamped to [0, num_pages-1] BEFORE any address is formed, because an
// unclamped sentinel is an out-of-bounds read on the card.  A row with
// nothing live returns zeros, as the Pallas kernel does.
//
// What bounds it: latency.  At the serving shape (B 8, tinyllama's H 32,
// KV 4, D 64, page 16, max_pages 32, bf16, live lengths of 36-170) the
// call reads ~0.75 MB of live K/V: a 0.24 us byte bound, and ~4 FLOPs per
// byte, far below the tensor cores' ridge.  What a call costs is its chain
// of dependent steps: the launch, the length and table reads, the K/V
// round trips, each tile's score-softmax-P V chain and, when a row is
// split, a second launch that merges the partials.  The first design (the
// CUDA-core body below, always split ~264 ways with a combine launch, each
// page staged by synchronous scalar loads behind four barriers) took 23.3
// us at that shape on an NVIDIA H100 80GB HBM3 at 700 W (7.7 of it in the
// combine; PERF.md).
//
// Which body runs, and how a row is cut into spans of whole pages, is the
// wrapper's choice (kernels/decode_attention.py, `paged_plan`), passed in
// as `tensor_cores`, `span` (pages) and `nsplit`; this file checks that
// the inputs allow it and sizes nothing itself.
//
// bf16 (the serving path): `paged_decode_mma_kernel`, the GQA-packed
// mma.sync tile routine of decode_tc.cuh that the contiguous decode runs,
// with the page gather as its key offset.  One block of kDecWarps warps
// per (row, KV head, span of at most 512 positions in whole pages), so a
// row of up to 512 positions is one block and one launch: the block reads
// its span's table entries once into shared memory (clamped; the loads
// overlap the length's), then its
// warps walk the live 16-key tiles in turn, each tile's rows fetched by
// 16-byte cp.async through the table (a tile may cross pages: each
// position finds its own page), three tiles in flight per warp, the G
// heads of the group as the M rows of one m16 tile (two when G > 16),
// S = Q K^T and O += P V on the tensor cores with P in registers; the
// warps merge (m, l, O) in shared memory and the block writes out itself.
// Longer rows split into spans that write fp32 partials, merged by the
// combine pass of common.cuh in a second launch.  A span with nothing
// live reads nothing.
//
// fp32: `decode_split_kernel` on the CUDA cores, the first design, kept
// (the tensor cores would round fp32 to TF32, and the fp32 greedy streams
// are held token for token against the plain path), with its own spans:
// split-K sized to ~264 blocks.  The GQA group shares one page staged in
// shared memory as fp32; spans and pages with nothing live are skipped.
// A bf16 call whose tensors are not 16-byte aligned takes it too.
#include "decode_tc.cuh"

namespace {

constexpr int kThreads = 128;
// table entries a block of the tensor-core body holds: a span covers at
// most 512 positions in whole pages
constexpr int kMaxSpanPages = 512;

// grid (nsplit, B*KV), kThreads threads.  nsplit == 1: out [B, H, D]
// directly, as the combine pass would write it; else partials laid out
// [B*KV, nsplit, G] (m, l) and [B*KV, nsplit, G, D] (acc).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ cache_len, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, T* __restrict__ out, int H,
    int KV, int num_pages, int page_size, int max_pages, int span, int nsplit, int window,
    float scale) {
  const int split = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int len = cache_len[b];
  // live positions of the row: [lo, len)
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int p0 = split * span;
  const int p1 = min(p0 + span, max_pages);
  const size_t part = (size_t)bkv * nsplit + split;
  const size_t grp = ((size_t)b * H + (size_t)kv * G) * D;  // the group's q and out rows

  if (p0 * page_size >= len || p1 * page_size <= lo) {  // nothing live in this span
    decode_empty_span<T, D, kThreads>(out, m_out, l_out, acc_out, grp, part, G, nsplit);
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

  const T* q_row = q + grp;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q_row[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < G; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  for (int p = p0; p < p1; ++p) {
    const int pos0 = p * page_size;
    if (pos0 >= len) break;                 // uniform over the block
    if (pos0 + page_size <= lo) continue;   // wholly before the window
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
      if (pos0 + t >= lo && pos0 + t < len) {
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
        if (pos0 + t >= lo && pos0 + t < len) mb = fmaxf(mb, row[t]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mb);
      float sum = 0.f;
      for (int t = 0; t < page_size; ++t) {
        const float e = (pos0 + t >= lo && pos0 + t < len) ? expf(row[t] - m_new) : 0.f;
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
  for (int i = tid; i < G * D; i += kThreads) {
    if (nsplit == 1) {  // the combine pass's arithmetic for one partial
      out[grp + i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
    } else {
      acc_out[part * G * D + i] = acc_s[i];
      if (i < G) {
        m_out[part * G + i] = m_s[i];
        l_out[part * G + i] = l_s[i];
      }
    }
  }
}

// grid (nsplit, B*KV), kDecThreads threads; `span` logical pages a block.
// nsplit == 1: out [B, H, D] directly; else fp32 partials laid out as
// decode_combine_kernel reads them, m in units of the scaled score.
template <int D, int MT>
__global__ void __launch_bounds__(kDecThreads) paged_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ cache_len, float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, __nv_bfloat16* __restrict__ out, int H, int KV,
    int num_pages, int page_size, int max_pages, int span, int nsplit, int window,
    float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  __shared__ int phys_s[kMaxSpanPages];  // the span's pages, clamped
  const int split = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int G = H / KV;
  const int len = cache_len[b];
  // the span's table entries, read while the length is still in flight
  // (the table does not depend on it) and clamped before any address is
  // formed; no tile's copy then waits on a dependent load of the table
  const int p_first = split * span;
  const int* span_table = block_table + (size_t)b * max_pages + p_first;
  for (int i = threadIdx.x; i < min(span, max_pages - p_first); i += kDecThreads)
    phys_s[i] = min(max(span_table[i], 0), num_pages - 1);
  // live positions of the row: [lo, hi), clamped into the logical pages
  const int hi = min(max(len, 0), max_pages * page_size);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s0 = p_first * page_size;
  const int start = max(s0, lo);
  const int end = min(s0 + span * page_size, hi);
  const size_t grp = ((size_t)b * H + (size_t)kv * G) * D;  // the group's q and out rows
  const size_t part = (size_t)bkv * nsplit + split;
  if (start >= end) {  // nothing live in this span
    decode_empty_span<__nv_bfloat16, D, kDecThreads>(out, m_out, l_out, acc_out, grp, part,
                                                      G, nsplit);
    return;  // uniform over the block
  }
  __syncthreads();  // phys_s is written
  // a position's page: a shift for power-of-two pages (uniform branch)
  const int shift = (page_size & (page_size - 1)) == 0 ? __ffs(page_size) - 1 : -1;
  const size_t pos_stride = (size_t)KV * D;
  const size_t page_stride = (size_t)page_size * pos_stride;
  DecAcc<D, MT> acc;
  dec_attend<D, MT>(q + grp, G, k_pages, v_pages,
                    [&](int pos) {
                      const int lp = shift >= 0 ? pos >> shift : pos / page_size;
                      return (size_t)phys_s[lp - p_first] * page_stride +
                             (size_t)(pos - lp * page_size) * pos_stride + (size_t)kv * D;
                    },
                    start, end,
                    smem_u32(dec_smem) + (threadIdx.x / 32) * DecShape<D>::kWarpBytes,
                    scale_log2, acc);
  dec_merge<D, MT>(acc, G, dec_smem, scale_log2, [&](int g, int d, float o, float m, float l) {
    if (nsplit == 1) {
      out[grp + g * D + d] = __float2bfloat16(o / fmaxf(l, 1e-30f));
    } else {
      acc_out[(part * G + g) * D + d] = o;
      if (d == 0) {
        m_out[part * G + g] = m * scale;
        l_out[part * G + g] = l;
      }
    }
  });
}

template <int D, int MT>
cudaError_t launch_mma(const void* q, const void* k_pages, const void* v_pages,
                       const int* block_table, const int* cache_len, float* m, float* l,
                       float* acc, void* out, int B, int H, int KV, int num_pages,
                       int page_size, int max_pages, int span, int nsplit, int window,
                       float scale, cudaStream_t stream) {
  static bool raised[kMaxCards] = {};  // the dynamic shared-memory cap, a card each
  cudaError_t cap = raise_smem_cap(raised, paged_decode_mma_kernel<D, MT>,
                                   dec_smem_bytes<D, MT>(16 * MT));
  if (cap != cudaSuccess) return cap;
  paged_decode_mma_kernel<D, MT>
      <<<dim3(nsplit, B * KV), kDecThreads, dec_smem_bytes<D, MT>(H / KV), stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
          static_cast<const __nv_bfloat16*>(v_pages), block_table, cache_len, m, l, acc,
          static_cast<__nv_bfloat16*>(out), H, KV, num_pages, page_size, max_pages, span,
          nsplit, window, scale, scale * 1.4426950408889634f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  decode_combine_kernel<__nv_bfloat16, D><<<B * KV, kCombineThreads, 0, stream>>>(
      m, l, acc, static_cast<__nv_bfloat16*>(out), H, KV, nsplit);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(bool tensor_cores, const void* q, const void* k_pages,
                   const void* v_pages, const int* block_table, const int* cache_len,
                   float* m, float* l, float* acc, void* out, int B, int H, int KV,
                   int num_pages, int page_size, int max_pages, int span, int nsplit,
                   int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (nsplit > 1 && (!m || !l || !acc)) return cudaErrorInvalidValue;
  if (tensor_cores) {  // bf16, 16-byte aligned tensors (rows are D elements apart)
    if constexpr (sizeof(T) == 2) {
      if (!(aligned16(q) && aligned16(k_pages) && aligned16(v_pages) && aligned16(out)) ||
          G > 32 || span > kMaxSpanPages)
        return cudaErrorInvalidValue;
      return G <= 16 ? launch_mma<D, 1>(q, k_pages, v_pages, block_table, cache_len, m, l,
                                        acc, out, B, H, KV, num_pages, page_size, max_pages,
                                        span, nsplit, window, scale, stream)
                     : launch_mma<D, 2>(q, k_pages, v_pages, block_table, cache_len, m, l,
                                        acc, out, B, H, KV, num_pages, page_size, max_pages,
                                        span, nsplit, window, scale, stream);
    }
    return cudaErrorInvalidValue;
  }
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
      static_cast<const T*>(v_pages), block_table, cache_len, m, l, acc,
      static_cast<T*>(out), H, KV, num_pages, page_size, max_pages, span, nsplit, window,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  decode_combine_kernel<T, D><<<B * KV, kCombineThreads, 0, stream>>>(
      m, l, acc, static_cast<T*>(out), H, KV, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, bool tc, const void* q, const void* kp, const void* vp,
                         const int* bt, const int* lens, float* m, float* l, float* acc,
                         void* out, int B, int H, int KV, int num_pages, int page_size,
                         int max_pages, int span, int nsplit, int window, float scale,
                         cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(tc, q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, window, scale, s);
    case 32: return launch<T, 32>(tc, q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, window, scale, s);
    case 64: return launch<T, 64>(tc, q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, window, scale, s);
    case 96: return launch<T, 96>(tc, q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, window, scale, s);
    case 128: return launch<T, 128>(tc, q, kp, vp, bt, lens, m, l, acc, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  tensor_cores: 1 runs the mma.sync body
// (bf16, 16-byte aligned tensors, H/KV <= 32 and span <= 512 pages only,
// else cudaErrorInvalidValue), 0 the CUDA-core body.  span: logical pages
// a block walks; nsplit blocks cover max_pages.  m, l, acc: the fp32
// partials, used only when nsplit > 1 (they may be null otherwise).
// Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_paged(
    int dtype, int tensor_cores, const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* cache_len, void* m, void* l, void* acc, void* out,
    int B, int H, int KV, int D, int num_pages, int page_size, int max_pages, int span,
    int nsplit, int window, float scale, void* stream) {
  if (B == 0) return cudaSuccess;
  if (KV <= 0 || H % KV || num_pages <= 0 || page_size <= 0 || max_pages <= 0 ||
      span <= 0 || nsplit <= 0 || (long long)span * nsplit < max_pages || window < 0)
    return cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(cache_len);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = tensor_cores != 0;
  if (dtype == 0)
    return dispatch_dim<float>(D, tc, q, k_pages, v_pages, bt, lens, mf, lf, af, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, window, scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(D, tc, q, k_pages, v_pages, bt, lens, mf, lf, af, out, B, H, KV, num_pages, page_size, max_pages, span, nsplit, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
