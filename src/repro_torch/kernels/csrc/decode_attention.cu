// Decode attention over a contiguous slot cache for Hopper (sm_90a), fp32
// and bf16.
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
// What bounds it: latency.  At the serving shape (B 8, tinyllama's H 32,
// KV 4, D 64, S 512, bf16, live lengths of 36-170) the call reads ~0.75 MB
// of live K/V: a 0.24 us byte bound, and ~4 FLOPs per byte, far below the
// tensor cores' ridge.  What a call costs is its chain of dependent steps:
// the launch, the length read, the K/V round trips, each tile's
// score-softmax-P V chain and, when a row is split, a second launch that
// merges the partials.  The first design (one lane per position scoring
// with a D-long FMA chain, tiles staged by synchronous scalar loads, the
// G heads of a group one after another, fixed ~264-block split-K with a
// combine launch) took 33.3-35.7 us at that shape on an NVIDIA H100 80GB
// HBM3 at 700 W (8.3-8.7 of it in the combine; PERF.md).
//
// Head dims: 16, 24, 32, 64, 96, 128 and 256.  24 is minicpm3's expanded
// MLA decode at smoke width (nope 16 + rope 8); the bf16 body stages and
// multiplies it padded to 32 with zeros (decode_tc.cuh), the fp32 body
// takes it as it is.  256 is recurrentgemma's ring decode (H 16, KV 1, a
// ring of 2048 slots: four 512-position spans and the combine pass); the
// bf16 body takes it at G <= 16 only, with Q staged in shared memory and
// two tiles in flight a warp (decode_tc.cuh), and the fp32 body stages
// ~80 KB of shared memory at G 16.
//
// Which body runs is the wrapper's choice (kernels/decode_attention.py),
// passed in as `tensor_cores`; this file checks that the inputs allow it
// and sizes nothing itself.
//
// bf16 (the serving path): `contig_decode_mma_kernel`, the GQA-packed
// mma.sync tile routine of decode_tc.cuh.  One block of kDecWarps warps
// per (row, KV head, span of at most 512 positions), so at S <= 512 a row
// is one block: its warps walk the live 16-key tiles in turn, each with
// 16-byte cp.async copies into its own ring of three tiles (a tile
// computes while the next two load), the G heads of the group as the M
// rows of one m16 tile (two when G > 16), S = Q K^T and O += P V on the
// tensor cores with P in registers, the online softmax in base 2; then the
// warps merge (m, l, O) in shared memory and the block writes out itself:
// one launch, no partials.  Longer caches split into 512-position spans
// that write fp32 partials, merged by the combine pass of common.cuh
// (`decode_combine_kernel`, which the paged decode shares) in a second
// launch.  A span wholly past cache_len, or wholly before the window,
// reads nothing.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, PERF.md): 4.1-4.4 us of device time per launch at the
// serving shape, against 19.4 us for SDPA on the same inputs; still ~18x
// its byte bound.
//
// fp32: `contig_decode_split_kernel` on the CUDA cores, the first design,
// kept (the tensor cores would round fp32 to TF32, and the fp32 greedy
// streams are held token for token against the plain path), with its own
// spans: split-K sized to ~264 blocks, as it was designed for, so the
// partials and the combine pass unless a row is one span, when it writes
// out itself too.  Warp w owns heads w, w+4, ...; lane t scores position
// t of a 32-position tile staged in shared memory as fp32.  A bf16 call
// whose tensors are not 16-byte aligned takes it too.
#include "decode_tc.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // positions per staged tile: one per lane
constexpr int kMaxHeadsPerWarp = 8;  // so G <= 32

// grid (nsplit, B*KV), kThreads threads.  nsplit == 1: out [B, H, D]
// directly, as the combine pass would write it; else partials laid out
// [B*KV, nsplit, G] (m, l) and [B*KV, nsplit, G, D] (acc).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) contig_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ cache_len,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, T* __restrict__ out, int S, int H, int KV,
    int span, int nsplit, int window, float scale) {
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
  const size_t grp = ((size_t)b * H + (size_t)kv * G) * D;  // the group's q and out rows

  if (start >= end) {  // nothing live in this span: zeros, or a neutral partial
    decode_empty_span<T, D, kThreads>(out, m_out, l_out, acc_out, grp, part, G, nsplit);
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;                   // [G][D]
  float* k_s = q_s + G * D;            // [kTile][D+1] (padded)
  float* v_s = k_s + kTile * (D + 1);  // [kTile][D]

  const T* q_row = q + grp;
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
      if (nsplit > 1 && lane == 0) {
        m_out[part * G + g] = m[j];
        l_out[part * G + g] = l[j];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d >= D) continue;
        if (nsplit == 1)  // the combine pass's arithmetic for one partial
          out[grp + g * D + d] = from_f32<T>(acc[j][c] / fmaxf(l[j], 1e-30f));
        else
          acc_out[(part * G + g) * D + d] = acc[j][c];
      }
    }
  }
}

// grid (nsplit, B*KV), kDecThreads threads.  nsplit == 1: out [B, H, D]
// directly; else fp32 partials laid out as decode_combine_kernel reads
// them, m in units of the scaled score.
template <int D, int MT>
__global__ void __launch_bounds__(kDecThreads) contig_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ cache_len,
    float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
    __nv_bfloat16* __restrict__ out, int S, int H, int KV, int span, int nsplit, int window,
    float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int split = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int G = H / KV;
  const int len = cache_len[b];
  // live positions of the row: [lo, hi), clamped into the cache
  const int hi = min(max(len, 0), S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s0 = split * span;
  const int start = max(s0, lo);
  const int end = min(s0 + span, hi);
  const size_t grp = ((size_t)b * H + (size_t)kv * G) * D;  // the group's q and out rows
  const size_t part = (size_t)bkv * nsplit + split;
  if (start >= end) {  // nothing live in this span
    decode_empty_span<__nv_bfloat16, D, kDecThreads>(out, m_out, l_out, acc_out, grp, part,
                                                      G, nsplit);
    return;  // uniform over the block
  }
  DecAcc<D, MT> acc;
  const size_t row0 = (size_t)b * S * KV + kv;
  dec_attend<D, MT>(q + grp, G, k, v, [&](int pos) { return (row0 + (size_t)pos * KV) * D; },
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
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* cache_len,
                       float* m, float* l, float* acc, void* out, int B, int S, int H, int KV,
                       int span, int nsplit, int window, float scale, cudaStream_t stream) {
  if (nsplit > 1 && (!m || !l || !acc)) return cudaErrorInvalidValue;
  static bool raised[kMaxCards] = {};  // the dynamic shared-memory cap, a card each
  cudaError_t cap = raise_smem_cap(raised, contig_decode_mma_kernel<D, MT>,
                                   dec_smem_bytes<D, MT>(16 * MT));
  if (cap != cudaSuccess) return cap;
  contig_decode_mma_kernel<D, MT>
      <<<dim3(nsplit, B * KV), kDecThreads, dec_smem_bytes<D, MT>(H / KV), stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), cache_len, m, l, acc,
          static_cast<__nv_bfloat16*>(out), S, H, KV, span, nsplit, window, scale,
          scale * 1.4426950408889634f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  decode_combine_kernel<__nv_bfloat16, D><<<B * KV, kCombineThreads, 0, stream>>>(
      m, l, acc, static_cast<__nv_bfloat16*>(out), H, KV, nsplit);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(bool tensor_cores, const void* q, const void* k, const void* v,
                   const int* cache_len, float* m, float* l, float* acc,
                   void* out, int B, int S, int H, int KV, int span,
                   int nsplit, int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G > kWarps * kMaxHeadsPerWarp) return cudaErrorInvalidValue;
  if (tensor_cores) {  // bf16, 16-byte aligned tensors (rows are D elements apart)
    if constexpr (sizeof(T) == 2) {
      if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)))
        return cudaErrorInvalidValue;
      if constexpr (DecShape<D>::kQShared) {  // one staged m16 tile of Q
        if (G > 16) return cudaErrorInvalidValue;
        return launch_mma<D, 1>(q, k, v, cache_len, m, l, acc, out, B, S, H, KV, span,
                                nsplit, window, scale, stream);
      } else {
        return G <= 16 ? launch_mma<D, 1>(q, k, v, cache_len, m, l, acc, out, B, S, H, KV,
                                          span, nsplit, window, scale, stream)
                       : launch_mma<D, 2>(q, k, v, cache_len, m, l, acc, out, B, S, H, KV,
                                          span, nsplit, window, scale, stream);
      }
    }
    return cudaErrorInvalidValue;
  }
  if (nsplit > 1 && (!m || !l || !acc)) return cudaErrorInvalidValue;
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
      static_cast<const T*>(v), cache_len, m, l, acc, static_cast<T*>(out), S, H, KV,
      span, nsplit, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  decode_combine_kernel<T, D><<<B * KV, kCombineThreads, 0, stream>>>(
      m, l, acc, static_cast<T*>(out), H, KV, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, bool tc, const void* q, const void* k, const void* v,
                         const int* lens, float* m, float* l, float* acc,
                         void* out, int B, int S, int H, int KV, int span,
                         int nsplit, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(tc, q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    case 24: return launch<T, 24>(tc, q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    case 32: return launch<T, 32>(tc, q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    case 64: return launch<T, 64>(tc, q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    case 96: return launch<T, 96>(tc, q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    case 128: return launch<T, 128>(tc, q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    case 256: return launch<T, 256>(tc, q, k, v, lens, m, l, acc, out, B, S, H, KV, span, nsplit, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  tensor_cores: 1 runs the mma.sync body
// (bf16 and 16-byte aligned tensors only, else cudaErrorInvalidValue), 0
// the CUDA-core body.  m, l, acc: the fp32 partials, used only when
// nsplit > 1 (they may be null otherwise).  Returns cudaGetLastError()
// after the launches.
extern "C" int decode_attention(
    int dtype, int tensor_cores, const void* q, const void* k, const void* v,
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
  const bool tc = tensor_cores != 0;
  if (dtype == 0)
    return dispatch_dim<float>(D, tc, q, k, v, lens, mf, lf, af, out, B, S, H, KV, span, nsplit, window, scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(D, tc, q, k, v, lens, mf, lf, af, out, B, S, H, KV, span, nsplit, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
