// Ragged causal paged prefill attention for Hopper (sm_90a), fp32 and
// bf16, and the cache write that precedes it.
//
// Replaces: the Pallas TPU kernel `prefill_attention_paged`
// (src/repro/kernels/prefill_attention.py, body `paged_kernel` ->
// `_pf_kernel`) together with the cache write `write_chunk_paged` that
// the JAX function runs before it.
//
// What it computes: row b carries chunk_lens[b] fresh tokens at positions
// base[b] + i.  First `paged_scatter_kernel` copies each fresh K/V token
// into the pools [num_pages, page_size, KV, D] through the row's block
// table, exactly where the plain `write_chunk_paged` writes it: logical
// page pos // page_size (floor), slot pos % page_size (floor), a negative
// logical page indexing the table from its end as torch and JAX indexing
// do; the token drops when it is padding (i >= chunk_lens[b]), when its
// logical page is >= max_pages (or below -max_pages) and when the table
// entry lies outside [0, num_pages) (the sentinel).  The decode step's
// append is the same copy with T = 1 and every token live.  Then each
// valid query i attends causally over the row's whole prefix
// kpos <= base[b] + i, read page by page through the block table (sentinel
// table entries are clamped to num_pages-1 before any address is formed).
// Padding query rows are written as exact zeros; rows with chunk_lens == 0
// are inert (all zeros).  Both kernels run on the caller's stream, in that
// order: nothing syncs the host (the masked torch scatter does, on
// `nonzero`).
//
// What bounds it: at the serving shape (one live 64-token chunk at base
// 64 in B 8 slots, tinyllama's H 32, KV 4, D 64, bf16) the call moves
// ~2.6 MB (most of it the zero rows of the seven inert slots) and does
// ~51 MFLOP: ~0.8 us of bytes, ~0.05 us of tensor-core work.  Nothing that
// small fills the card: two launches and each block's chain of dependent
// reads (lengths, block table, K/V) bound it in practice.  The scatter
// reads a token's data while its destination is still being looked up.
//
// bf16 (the serving path): `prefill_paged_wgmma_kernel`, the tensor-core
// block of attn_tc.cuh (`tc_prefill_block`), which the contiguous prefill
// shares; here a key's row is found through the block table.  One block
// (one warpgroup) per 64 flattened query rows r = t*G + g (query token t,
// group head g) of one (row, KV head), so the G heads of a group share
// every staged K/V tile, as the TPU kernel's GQA index map does; a row's
// causal frontier is base + r / G.  Its 64-key K/V tiles are gathered
// four 16-key pages at a time through the block table by cp.async into a
// two-slot ring of swizzled bf16 tiles.  The walk stops at the tile
// holding the block's last valid query's position, keys past it are
// zero-filled and masked, and blocks wholly past chunk_lens[b] write
// zeros and return.  The grid starts the latest (longest) query tiles
// first.
//
// fp32: `prefill_kernel` on the CUDA cores, kept as it was written (the
// tensor cores would round fp32 to TF32, and the fp32 greedy streams are
// held token for token against the plain path).  Its 128 threads each
// own one (query, head) row with the q row and the fp32 accumulator in
// registers; each page's K/V is staged once in shared memory as fp32 and
// read as broadcasts; the online softmax rescales once per 16 keys.
#include "attn_tc.cuh"

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

// grid (B*T), kScatterThreads threads: token j of row b into the pools,
// in units U of its K*D row (16 bytes where the rows allow it).  v_new
// null: K only.  chunk_lens null: every token is live.  Each thread reads
// its units of the token before it knows where they go, so the index
// reads and the data reads are in flight together.
constexpr int kScatterThreads = 64;
template <typename U>
__global__ void __launch_bounds__(kScatterThreads) paged_scatter_kernel(
    const U* __restrict__ k_new, const U* __restrict__ v_new, U* __restrict__ k_pages,
    U* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ base_v, const int* __restrict__ clen_v, int T_len,
    int num_pages, int page_size, int max_pages, int row_units) {
  constexpr int kUnits = 4;  // units a thread holds at once
  const int bj = blockIdx.x;
  const int b = bj / T_len;
  const int j = bj % T_len;
  const size_t src = (size_t)bj * row_units;
  for (int i0 = 0; i0 < row_units; i0 += kUnits * kScatterThreads) {
    U kx[kUnits], vx[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int i = i0 + u * kScatterThreads + threadIdx.x;
      if (i < row_units) {
        kx[u] = k_new[src + i];
        if (v_new) vx[u] = v_new[src + i];
      }
    }
    if (clen_v && j >= clen_v[b]) return;  // padding token: dropped
    const long long pos = (long long)base_v[b] + j;
    long long lp = pos / page_size;
    long long off = pos % page_size;
    if (off < 0) {  // floor division and modulo, as torch's // and %
      off += page_size;
      lp -= 1;
    }
    if (lp >= max_pages) return;  // past the table: dropped
    if (lp < 0) lp += max_pages;  // from the table's end, as indexing does
    if (lp < 0) return;
    const int phys = block_table[(size_t)b * max_pages + lp];
    if (phys < 0 || phys >= num_pages) return;  // sentinel: dropped
    const size_t dst = ((size_t)phys * page_size + off) * row_units;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int i = i0 + u * kScatterThreads + threadIdx.x;
      if (i < row_units) {
        k_pages[dst + i] = kx[u];
        if (v_new) v_pages[dst + i] = vx[u];
      }
    }
  }
}

// grid (n_qt * B*KV), kTcThreads threads: block x owns flattened query
// rows 64*qi .. 64*qi + 63 of (row, KV head) bkv = x % (B*KV), the first
// B*KV blocks taking the last tile.
template <int D>
__global__ void __launch_bounds__(kTcThreads) prefill_paged_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ base_v, const int* __restrict__ clen_v,
    __nv_bfloat16* __restrict__ out, int T_len, int H, int KV, int num_pages,
    int page_size, int max_pages, int BKV, int n_qt, float scale_log2) {
  const int qi = n_qt - 1 - (int)(blockIdx.x / BKV);
  const int bkv = blockIdx.x % BKV;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int* bt = block_table + (size_t)b * max_pages;
  // bring the row's block table into L1 while base and chunk_lens load
  if (threadIdx.x < (max_pages + 31) / 32)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(bt + 32 * threadIdx.x));
  const int base = base_v[b];
  const int clen = clen_v[b];
  tc_prefill_block<D>(q, k_pages, v_pages, out, T_len, H, KV, b, kv, qi, base, clen,
                      max_pages * page_size, scale_log2, [&](int pos) {
    const int phys = min(max(bt[pos / page_size], 0), num_pages - 1);  // clamp first
    return (((size_t)phys * page_size + pos % page_size) * KV + kv) * D;
  });
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k_pages, const void* v_pages,
                      const int* bt, const int* base, const int* clens, void* out, int B,
                      int T_len, int H, int KV, int num_pages, int page_size, int max_pages,
                      float scale, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<D>(1);
  static bool raised[kMaxCards] = {};  // the dynamic shared-memory cap, a card each
  cudaError_t cap = raise_smem_cap(raised, prefill_paged_wgmma_kernel<D>, smem);
  if (cap != cudaSuccess) return cap;
  const int n_qt = (int)(((long long)T_len * (H / KV) + kTcRows - 1) / kTcRows);
  const long long blocks = (long long)n_qt * B * KV;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  prefill_paged_wgmma_kernel<D><<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), bt, base, clens,
      static_cast<__nv_bfloat16*>(out), T_len, H, KV, num_pages, page_size, max_pages,
      B * KV, n_qt, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* bt, const int* base, const int* clens, void* out,
                   int B, int T_len, int H, int KV, int num_pages,
                   int page_size, int max_pages, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  if (G > kThreads) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {  // bf16; rows are D elements apart, so 16 B aligned
    if (aligned16(q) && aligned16(k_pages) && aligned16(v_pages) && aligned16(out))
      return launch_tc<D>(q, k_pages, v_pages, bt, base, clens, out, B, T_len, H, KV,
                          num_pages, page_size, max_pages, scale, stream);
  }
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
    case 96: return launch<T, 96>(q, kp, vp, bt, base, clens, out, B, T_len, H, KV, num_pages, page_size, max_pages, scale, s);
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

// The chunk's cache write: esize bytes an element, row_elems = KV*D
// elements a token; v_new / v_pages may be null (K only), chunk_lens may
// be null (every token live).  Returns cudaGetLastError() after the
// launch.
extern "C" int paged_scatter(int esize, const void* k_new, const void* v_new,
                             void* k_pages, void* v_pages, const void* block_table,
                             const void* base, const void* chunk_lens, int B, int T_len,
                             int row_elems, int num_pages, int page_size, int max_pages,
                             void* stream) {
  if (B == 0 || T_len == 0) return cudaSuccess;
  if (num_pages <= 0 || page_size <= 0 || max_pages <= 0 || esize % 2)
    return cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_table);
  const int* bs = static_cast<const int*>(base);
  const int* cl = static_cast<const int*>(chunk_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_bytes = (long long)row_elems * esize;
  const bool vec = row_bytes % 16 == 0 && aligned16(k_new) && aligned16(k_pages) &&
                   (!v_new || (aligned16(v_new) && aligned16(v_pages)));
  if (vec) {
    using U = uint4;
    paged_scatter_kernel<U><<<B * T_len, kScatterThreads, 0, s>>>(
        static_cast<const U*>(k_new), static_cast<const U*>(v_new), static_cast<U*>(k_pages),
        static_cast<U*>(v_pages), bt, bs, cl, T_len, num_pages, page_size, max_pages,
        (int)(row_bytes / 16));
  } else {
    using U = unsigned short;
    paged_scatter_kernel<U><<<B * T_len, kScatterThreads, 0, s>>>(
        static_cast<const U*>(k_new), static_cast<const U*>(v_new), static_cast<U*>(k_pages),
        static_cast<U*>(v_pages), bt, bs, cl, T_len, num_pages, page_size, max_pages,
        (int)(row_bytes / 2));
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
