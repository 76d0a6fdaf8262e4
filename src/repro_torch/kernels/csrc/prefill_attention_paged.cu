// Ragged causal paged prefill attention for Hopper (sm_90a), fp32 and bf16.
//
// Replaces: the Pallas TPU kernel `prefill_attention_paged`
// (src/repro/kernels/prefill_attention.py, body `paged_kernel` ->
// `_pf_kernel`).  The cache write (`write_chunk_paged`) stays a plain
// masked scatter done before this kernel, as the JAX function does it
// outside the Pallas body.
//
// What it computes: row b carries chunk_lens[b] fresh queries at
// positions base[b] + i; each valid query attends causally over the row's
// whole prefix kpos <= base[b] + i, read page by page through the row's
// block table from the pool [num_pages, page_size, KV, D] (sentinel table
// entries are clamped to num_pages-1 before any address is formed).
// Padding query rows (i >= chunk_lens[b]) are written as exact zeros; rows
// with chunk_lens == 0 are inert (all zeros).
//
// What bounds it: at serving shapes (a 64-token chunk over a prefix of a
// few hundred tokens) each K/V page is used by G*bq = 128 query rows, ~64
// FLOPs per byte of bf16 cache: below the H100's ~295 FLOPs/byte ridge in
// the counted bytes, but this plain-FMA kernel runs on the CUDA cores
// (67 TFLOP/s fp32), so in practice its FMAs bound it.  The design keeps
// every byte read once per block and every FMA useful:
//   * one block per (row, KV head, tile of bq queries); its 128 threads
//     each own one (query, head) row of the GQA group, with the q row and
//     the fp32 accumulator in registers (D is a template parameter);
//   * the block walks logical pages only up to the tile's causal frontier
//     base + last valid query of the tile, and skips tiles wholly past
//     chunk_lens[b] (they only write zeros);
//   * each page's K/V tile is staged once in shared memory and read by all
//     threads as broadcasts (every thread reads the same key at once), so
//     there are no bank conflicts;
//   * the online softmax rescales once per 16 keys, in fp32.
// wgmma/TMA and a tensor-core QK^T are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKeyTile = 16;  // keys per online-softmax rescale

// grid (ceil(T / bq), B*KV), kThreads threads; thread r owns query
// t = qi*bq + r / G of head kv*G + r % G.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ base_v, const int* __restrict__ clen_v,
    T* __restrict__ out, int T_len, int H, int KV, int num_pages,
    int page_size, int max_pages, int bq, float scale) {
  const int qi = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int t = qi * bq + tid / G;
  const int h = kv * G + tid % G;
  const bool row_in = tid < bq * G && t < T_len;  // a real output row
  const int base = base_v[b];
  const int clen = clen_v[b];
  const bool valid = row_in && t < clen;
  T* o_row = out + (((size_t)b * T_len + t) * H + h) * D;

  if (qi * bq >= clen) {  // tile wholly past the chunk: padding rows only
    if (row_in)
      for (int d = 0; d < D; ++d) o_row[d] = from_f32<T>(0.f);
    return;  // uniform over the block
  }

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (valid) {
    const T* q_row = q + (((size_t)b * T_len + t) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(q_row[d]);
  }
  float m = kNegInf;
  float l = 0.f;
  const int qpos = base + t;

  // causal frontier of the tile: its last valid query's position
  const int t_last = min((qi + 1) * bq, clen) - 1;
  const int last_page = min((base + t_last) / page_size, max_pages - 1);

  extern __shared__ float smem[];
  float* k_s = smem;                    // [page_size][D]
  float* v_s = k_s + page_size * D;     // [page_size][D]

  for (int p = 0; p <= last_page; ++p) {
    int phys = block_table[(size_t)b * max_pages + p];
    phys = min(max(phys, 0), num_pages - 1);  // clamp before addressing
    __syncthreads();  // the previous page's readers are done
    const size_t page_off = ((size_t)phys * page_size * KV + kv) * D;
    for (int i = tid; i < page_size * D; i += kThreads) {
      const int kt = i / D;
      const int d = i % D;
      const size_t off = page_off + (size_t)kt * KV * D + d;
      k_s[i] = to_f32(k_pages[off]);
      v_s[i] = to_f32(v_pages[off]);
    }
    __syncthreads();
    if (!valid) continue;
    const int lo = p * page_size;
    for (int k0 = 0; k0 < page_size && lo + k0 <= qpos; k0 += kKeyTile) {
      float s[kKeyTile];
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeyTile; ++j) {
        const int kt = k0 + j;
        s[j] = kNegInf;
        if (kt < page_size && lo + kt <= qpos) {
          const float* kr = k_s + kt * D;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
          s[j] = dot * scale;
          mb = fmaxf(mb, s[j]);
        }
      }
      const float m_new = fmaxf(m, mb);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeyTile; ++j) {
        const int kt = k0 + j;
        if (kt < page_size && lo + kt <= qpos) {
          const float e = expf(s[j] - m_new);
          l += e;
          const float* vr = v_s + kt * D;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += e * vr[d];
        }
      }
      m = m_new;
    }
  }
  if (!row_in) return;
  const float inv = valid ? 1.f / fmaxf(l, 1e-30f) : 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) o_row[d] = from_f32<T>(valid ? acc[d] * inv : 0.f);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* bt, const int* base, const int* clens, void* out,
                   int B, int T_len, int H, int KV, int num_pages,
                   int page_size, int max_pages, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  if (G > kThreads) return cudaErrorInvalidValue;
  const int bq = kThreads / G;
  const size_t smem = sizeof(float) * 2 * (size_t)page_size * D;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(prefill_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T_len + bq - 1) / bq, B * KV);
  prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), bt, base, clens, static_cast<T*>(out),
      T_len, H, KV, num_pages, page_size, max_pages, bq, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* kp, const void* vp,
                         const int* bt, const int* base, const int* clens,
                         void* out, int B, int T_len, int H, int KV,
                         int num_pages, int page_size, int max_pages,
                         float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kp, vp, bt, base, clens, out, B, T_len, H, KV, num_pages, page_size, max_pages, scale, s);
    case 32: return launch<T, 32>(q, kp, vp, bt, base, clens, out, B, T_len, H, KV, num_pages, page_size, max_pages, scale, s);
    case 64: return launch<T, 64>(q, kp, vp, bt, base, clens, out, B, T_len, H, KV, num_pages, page_size, max_pages, scale, s);
    case 128: return launch<T, 128>(q, kp, vp, bt, base, clens, out, B, T_len, H, KV, num_pages, page_size, max_pages, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Returns cudaGetLastError() after the launch.
extern "C" int prefill_attention_paged(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* base, const void* chunk_lens,
    void* out, int B, int T_len, int H, int KV, int D, int num_pages,
    int page_size, int max_pages, float scale, void* stream) {
  if (B == 0 || T_len == 0) return cudaSuccess;
  if (KV <= 0 || H % KV || num_pages <= 0 || page_size <= 0 || max_pages <= 0)
    return cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_table);
  const int* bs = static_cast<const int*>(base);
  const int* cl = static_cast<const int*>(chunk_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(D, q, k_pages, v_pages, bt, bs, cl, out, B, T_len, H, KV, num_pages, page_size, max_pages, scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(D, q, k_pages, v_pages, bt, bs, cl, out, B, T_len, H, KV, num_pages, page_size, max_pages, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
