// Ragged cache-writing causal prefill over a contiguous slot cache for
// Hopper (sm_90a), fp32 and bf16.
//
// Replaces: the Pallas TPU kernel `prefill_attention`
// (src/repro/kernels/prefill_attention.py, body `_pf_kernel`) together
// with the cache write `write_chunk` that the JAX function runs before it.
//
// What it computes: row b carries chunk_lens[b] fresh tokens at positions
// base[b] + i.  First `chunk_scatter_kernel` copies each fresh K/V token
// into the caches k_cache, v_cache [B, S, KV, D]; a token past
// chunk_lens[b], or whose position falls outside [0, S), is skipped (the
// JAX scatter drops it).  Then `contig_prefill_kernel` lets each valid
// query i attend causally over kpos <= base[b] + i of the row's cache.
// Padding query rows (i >= chunk_lens[b]) are written as exact zeros; rows
// with chunk_lens == 0 are inert (no writes, all zeros).  Both kernels run
// on the caller's stream, in that order, with no host sync in between.
//
// Why the cache write is a kernel: the sync-free torch form of the
// scatter clamps dropped positions to S-1 and writes where(keep, new,
// old).  When base + chunk reaches S, a row's dropped tail then lands on
// the same element as its live write at S-1, and index_put_ picks a winner
// in no fixed order.  Skipping dropped tokens outright has no collision;
// the masked torch form that does skip them syncs the host on `nonzero`.
//
// What bounds it: at serving shapes (a 64-token chunk over a prefix of a
// few hundred tokens) each K/V element staged in shared memory is used by
// G*bq = 128 query rows, ~64 FLOPs per byte of bf16 cache: below the
// H100's ~295 FLOPs/byte ridge in the counted bytes, but this plain-FMA
// kernel runs on the CUDA cores (67 TFLOP/s fp32), so in practice its FMAs
// bound it.  The design, carried over from prefill_attention_paged.cu,
// keeps every byte read once per block and every FMA useful:
//   * one block per (row, KV head, tile of bq queries); its 128 threads
//     each own one (query, head) row of the GQA group, with the q row and
//     the fp32 accumulator in registers (D is a template parameter);
//   * the block walks 32-position K/V tiles of its row only up to the
//     tile's causal frontier base + last valid query (inside the cache),
//     and tiles wholly past chunk_lens[b] only write zeros;
//   * each K/V tile is staged once in shared memory and read by all
//     threads as broadcasts (every thread reads the same key at once);
//   * the online softmax rescales once per 16 keys, in fp32.
// wgmma/TMA and a tensor-core QK^T are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;     // cache positions staged per step
constexpr int kKeyTile = 16;  // keys per online-softmax rescale

// grid (B*T), kThreads threads: one fresh token's K and V rows.
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_scatter_kernel(
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    T* __restrict__ k_cache, T* __restrict__ v_cache,
    const int* __restrict__ base_v, const int* __restrict__ clen_v, int T_len,
    int S, int row_elems) {
  const int bt = blockIdx.x;
  const int b = bt / T_len;
  const int t = bt % T_len;
  if (t >= clen_v[b]) return;  // padding token: dropped
  const int pos = base_v[b] + t;
  if (pos < 0 || pos >= S) return;  // outside the cache row: dropped
  const size_t src = (size_t)bt * row_elems;
  const size_t dst = ((size_t)b * S + pos) * row_elems;
  for (int i = threadIdx.x; i < row_elems; i += kThreads) {
    k_cache[dst + i] = k_new[src + i];
    v_cache[dst + i] = v_new[src + i];
  }
}

// grid (ceil(T / bq), B*KV), kThreads threads; thread r owns query
// t = qi*bq + r / G of head kv*G + r % G.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) contig_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ base_v,
    const int* __restrict__ clen_v, T* __restrict__ out, int T_len, int S,
    int H, int KV, int bq, float scale) {
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

  // causal frontier of the tile, inside the row: its last valid query's
  // position, at most S-1
  const int t_last = min((qi + 1) * bq, clen) - 1;
  const int last_key = min(base + t_last, S - 1);

  extern __shared__ float smem[];
  float* k_s = smem;               // [kTile][D]
  float* v_s = k_s + kTile * D;    // [kTile][D]
  const size_t row_off = ((size_t)b * S * KV + kv) * D;

  for (int p0 = 0; p0 <= last_key; p0 += kTile) {
    const int n = min(kTile, last_key + 1 - p0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int kt = i / D;
      const int d = i % D;
      float kx = 0.f;
      float vx = 0.f;
      if (kt < n) {
        const size_t off = row_off + (size_t)(p0 + kt) * KV * D + d;
        kx = to_f32(k_cache[off]);
        vx = to_f32(v_cache[off]);
      }
      k_s[i] = kx;
      v_s[i] = vx;
    }
    __syncthreads();
    if (!valid) continue;
    for (int k0 = 0; k0 < n && p0 + k0 <= qpos; k0 += kKeyTile) {
      float s[kKeyTile];
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeyTile; ++j) {
        const int kt = k0 + j;
        s[j] = kNegInf;
        if (kt < n && p0 + kt <= qpos) {
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
        if (kt < n && p0 + kt <= qpos) {
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
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_cache, void* v_cache, const int* base,
                   const int* clens, void* out, int B, int T_len, int S,
                   int H, int KV, float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G > kThreads) return cudaErrorInvalidValue;
  chunk_scatter_kernel<T><<<B * T_len, kThreads, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), base, clens, T_len,
      S, KV * D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int bq = kThreads / G;
  const size_t smem = sizeof(float) * 2 * (size_t)kTile * D;
  const dim3 grid((T_len + bq - 1) / bq, B * KV);
  contig_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), base, clens, static_cast<T*>(out),
      T_len, S, H, KV, bq, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* kn, const void* vn,
                         void* kc, void* vc, const int* base, const int* clens,
                         void* out, int B, int T_len, int S, int H, int KV,
                         float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kn, vn, kc, vc, base, clens, out, B, T_len, S, H, KV, scale, s);
    case 32: return launch<T, 32>(q, kn, vn, kc, vc, base, clens, out, B, T_len, S, H, KV, scale, s);
    case 64: return launch<T, 64>(q, kn, vn, kc, vc, base, clens, out, B, T_len, S, H, KV, scale, s);
    case 128: return launch<T, 128>(q, kn, vn, kc, vc, base, clens, out, B, T_len, S, H, KV, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Writes the chunk into the caches in place,
// then attends.  Returns cudaGetLastError() after the launches.
extern "C" int prefill_attention(
    int dtype, const void* q, const void* k_new, const void* v_new,
    void* k_cache, void* v_cache, const void* base, const void* chunk_lens,
    void* out, int B, int T_len, int S, int H, int KV, int D, float scale,
    void* stream) {
  if (B == 0 || T_len == 0) return cudaSuccess;
  if (KV <= 0 || H % KV || S <= 0) return cudaErrorInvalidValue;
  const int* bs = static_cast<const int*>(base);
  const int* cl = static_cast<const int*>(chunk_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(D, q, k_new, v_new, k_cache, v_cache, bs, cl, out, B, T_len, S, H, KV, scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(D, q, k_new, v_new, k_cache, v_cache, bs, cl, out, B, T_len, S, H, KV, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
