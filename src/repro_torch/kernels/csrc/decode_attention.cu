// Split-K decode attention over a contiguous slot cache for Hopper
// (sm_90a), fp32 and bf16.
//
// Replaces: the Pallas TPU kernel `decode_attention`
// (src/repro/kernels/decode_attention.py, body `_dec_kernel`) and its jnp
// `_combine_splits`.
//
// What it computes: for each row b, one query per head attends the live
// positions of the row's own cache k, v [B, S, KV, D]: kpos < cache_len[b]
// and, when window > 0, kpos >= cache_len[b] - window.  cache_len is
// clamped to [0, S] before any address is formed.  A row with nothing live
// (cache_len == 0) returns zeros, as the Pallas kernel does.
//
// What bounds it: bytes.  Each live K/V element is read once and used for
// the G (= H/KV, 8 at tinyllama width) heads of its GQA group, about 4
// FLOPs per byte of bf16 cache, far below the ~295 FLOPs/byte where the
// H100's tensor cores become the limit.  The TPU kernel runs one program
// per (row, KV head) over a 512-key block: at the serving shape (8 slots,
// 4 KV heads) that is 32 blocks, which would leave 100 of the 132 SMs
// idle.  So the design spreads the live bytes over the card:
//   * one block per (row, KV head, span of positions); the wrapper sizes
//     the span so the grid holds ~264 blocks (2 per SM);
//   * a span wholly past cache_len, or wholly before the window, writes a
//     neutral partial (m = -1e30, l = 0, acc = 0) without reading the
//     cache, so the bytes read follow the live length, not S;
//   * the G heads share each 32-position K/V tile staged in shared memory;
//     warp w owns heads w, w+4, ...; lane t scores position t of the tile
//     (a K row padded to D+1 floats, so the 32 lanes hit 32 banks), the
//     online softmax of the tile is two warp reductions, and the P.V
//     product broadcasts each lane's probability with a shuffle while
//     lanes walk D in step (conflict-free V reads);
//   * the combine pass shared with the paged kernel (common.cuh) merges
//     the fp32 partials into [B, H, D] in q's dtype.
// Plain FMA on CUDA cores; wgmma/TMA are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // positions per staged tile: one per lane
constexpr int kMaxHeadsPerWarp = 8;  // so G <= 32

// grid (nsplit, B*KV), kThreads threads.  Partials are laid out
// [B*KV, nsplit, G] (m, l) and [B*KV, nsplit, G, D] (acc).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) contig_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ cache_len,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, int S, int H, int KV, int span, int nsplit,
    int window, float scale) {
  constexpr int kCols = (D + 31) / 32;  // accumulator columns per lane
  const int split = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = cache_len[b];
  // live positions of the row: [lo, hi), clamped into the cache
  const int hi = min(len, S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s0 = split * span;
  const int start = max(s0, lo);
  const int end = min(s0 + span, hi);
  const size_t part = (size_t)bkv * nsplit + split;
  float* m_dst = m_out + part * G;
  float* l_dst = l_out + part * G;
  float* acc_dst = acc_out + part * G * D;

  if (start >= end) {  // nothing live in this span: neutral partial
    for (int i = tid; i < G; i += kThreads) {
      m_dst[i] = kNegInf;
      l_dst[i] = 0.f;
    }
    for (int i = tid; i < G * D; i += kThreads) acc_dst[i] = 0.f;
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;                   // [G][D]
  float* k_s = q_s + G * D;            // [kTile][D+1] (padded)
  float* v_s = k_s + kTile * (D + 1);  // [kTile][D]

  const T* q_row = q + ((size_t)b * H + (size_t)kv * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f32(q_row[i]);

  float m[kMaxHeadsPerWarp];
  float l[kMaxHeadsPerWarp];
  float acc[kMaxHeadsPerWarp][kCols];
#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] = 0.f;
  }

  const size_t row_off = ((size_t)b * S * KV + kv) * D;
  for (int p0 = start; p0 < end; p0 += kTile) {
    const int n = min(kTile, end - p0);  // live positions in this tile, >= 1
    __syncthreads();  // q_s is loaded; the previous tile's readers are done
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int t = i / D;
      const int d = i % D;
      float kx = 0.f;
      float vx = 0.f;
      if (t < n) {
        const size_t off = row_off + (size_t)(p0 + t) * KV * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_s[t * (D + 1) + d] = kx;
      v_s[t * D + d] = vx;
    }
    __syncthreads();
    const bool live = lane < n;
#pragma unroll
    for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g < G) {  // uniform over the warp
        float s = kNegInf;
        if (live) {
          const float* qr = q_s + g * D;
          const float* kr = k_s + lane * (D + 1);
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
          s = dot * scale;
        }
        float mt = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[j], mt);
        const float p = live ? expf(s - m_new) : 0.f;
        float ps = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
        const float alpha = expf(m[j] - m_new);
        l[j] = l[j] * alpha + ps;
        m[j] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[j][c] *= alpha;
        for (int t = 0; t < n; ++t) {
          const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[j][c] += pt * v_s[t * D + d];
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    const int g = warp + j * kWarps;
    if (g < G) {
      if (lane == 0) {
        m_dst[g] = m[j];
        l_dst[g] = l[j];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc_dst[g * D + d] = acc[j][c];
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cache_len, float* m, float* l, float* acc,
                   void* out, int B, int S, int H, int KV, int span,
                   int nsplit, int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G > kWarps * kMaxHeadsPerWarp) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)kTile * (D + 1) +
                                       (size_t)kTile * D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(contig_decode_split_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  contig_decode_split_kernel<T, D><<<dim3(nsplit, B * KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_len, m, l, acc, S, H, KV, span, nsplit,
      window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T, D><<<B * KV, kCombineThreads, 0, stream>>>(
      m, l, acc, static_cast<T*>(out), H, KV, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v,
                         const int* lens, float* m, float* l, float* acc,
                         void* out, int B, int S, int H, int KV, int span,
                         int nsplit, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Returns cudaGetLastError() after the launches.
extern "C" int decode_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* cache_len, void* m, void* l, void* acc, void* out, int B,
    int S, int H, int KV, int D, int span, int nsplit, int window,
    float scale, void* stream) {
  if (B == 0) return cudaSuccess;
  if (KV <= 0 || H % KV || S <= 0 || span <= 0 || nsplit <= 0 ||
      (long long)span * nsplit < S || window < 0)
    return cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(cache_len);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(D, q, k, v, lens, mf, lf, af, out, B, S, H, KV, span, nsplit, window, scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(D, q, k, v, lens, mf, lf, af, out, B, S, H, KV, span, nsplit, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
