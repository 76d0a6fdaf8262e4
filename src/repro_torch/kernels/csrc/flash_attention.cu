// Causal or full GQA flash-attention forward for Hopper (sm_90a), fp32
// and bf16.
//
// Replaces: the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, body `_fa_kernel`).
//
// What it computes: q [B, H, S, D]; k, v [B, KV, S, D], H = KV * G, query
// head h reading KV head h / G; out [B, H, S, D] in q's dtype.  Each query
// t attends over keys 0..t (causal) or 0..S-1 (full) with an online
// softmax in fp32; a row with no live key would be 0 (the sum is clamped
// at 1e-30, as the TPU kernel clamps it).  Any S, no padding: the walk
// stops at the last key.  Every tensor is addressed through its strides
// (the last dim contiguous), so the model hands over [B, S, H, D]
// activations viewed as [B, H, S, D] without a copy.
//
// What bounds it: at the training shape (B 8, H 32, KV 4, S 512, D 64,
// bf16) the causal triangle is ~8.6 GFLOP against ~38 MB of inputs and
// output, so on the card's tensor cores the bytes bound it (~11 us at
// 3.35 TB/s).  This first kernel runs on the CUDA cores in plain fp32
// FMAs (67 TFLOP/s), where its FMAs bound it, ~0.13 ms.  The design,
// carried over from prefill_attention.cu, keeps every FMA useful:
//   * one block per (row, KV head, tile of bq queries); its 128 threads
//     each own one (query, head) row of the GQA group, with the q row and
//     the fp32 accumulator in registers (D is a template parameter), so
//     the G heads of a group share each staged K/V tile;
//   * the block walks 32-key tiles only up to its tile's causal frontier
//     (the TPU kernel's skip of fully masked blocks), and each row stops
//     at its own last key inside the frontier tile;
//   * each K/V tile is staged once in shared memory as fp32 and read by
//     all threads as broadcasts (every thread reads the same key at once);
//   * the online softmax rescales once per 16 keys.
// wgmma/TMA and a tensor-core QK^T are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;     // keys staged per step
constexpr int kKeyTile = 16;  // keys per online-softmax rescale

// element strides of a [B, heads, S, D] view (the D stride is 1)
struct Strides {
  long long b, h, s;
};

// grid (ceil(S / bq), B*KV), kThreads threads; thread r owns query
// t = qi*bq + r / G of head kv*G + r % G.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Strides qs, Strides ks, Strides vs, Strides os,
    int S, int H, int KV, int bq, int causal, float scale) {
  const int qi = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int t = qi * bq + tid / G;
  const int h = kv * G + tid % G;
  const bool valid = tid < bq * G && t < S;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (valid) {
    const T* q_row = q + b * qs.b + h * qs.h + t * qs.s;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(q_row[d]);
  }
  float m = kNegInf;
  float l = 0.f;
  // keys this row sees: 0..t (causal) or all of them
  const int row_last = causal ? t : S - 1;
  // the block's frontier: its last query's last key
  const int last_key = causal ? min((qi + 1) * bq, S) - 1 : S - 1;

  extern __shared__ float smem[];
  float* k_s = smem;               // [kTile][D]
  float* v_s = k_s + kTile * D;    // [kTile][D]
  const T* k_head = k + b * ks.b + kv * ks.h;
  const T* v_head = v + b * vs.b + kv * vs.h;

  for (int p0 = 0; p0 <= last_key; p0 += kTile) {
    const int n = min(kTile, last_key + 1 - p0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int kt = i / D;
      const int d = i % D;
      float kx = 0.f;
      float vx = 0.f;
      if (kt < n) {
        kx = to_f32(k_head[(p0 + kt) * ks.s + d]);
        vx = to_f32(v_head[(p0 + kt) * vs.s + d]);
      }
      k_s[i] = kx;
      v_s[i] = vx;
    }
    __syncthreads();
    if (!valid) continue;
    const int hi = min(n, row_last + 1 - p0);  // keys of this tile the row sees
    for (int k0 = 0; k0 < hi; k0 += kKeyTile) {
      float s[kKeyTile];
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeyTile; ++j) {
        const int kt = k0 + j;
        s[j] = kNegInf;
        if (kt < hi) {
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
        if (kt < hi) {
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
  if (!valid) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* o_row = out + b * os.b + h * os.h + t * os.s;
#pragma unroll
  for (int d = 0; d < D; ++d) o_row[d] = from_f32<T>(acc[d] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int S, int H, int KV, int causal, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  if (G > kThreads || B * KV > 65535) return cudaErrorInvalidValue;
  const int bq = kThreads / G;
  const size_t smem = sizeof(float) * 2 * (size_t)kTile * D;
  const dim3 grid((S + bq - 1) / bq, B * KV);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, S, H,
      KV, bq, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v,
                         void* out, Strides qs, Strides ks, Strides vs,
                         Strides os, int B, int S, int H, int KV, int causal,
                         float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, qs, ks, vs, os, B, S, H, KV, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, qs, ks, vs, os, B, S, H, KV, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, S, H, KV, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, S, H, KV, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  strides: 12 element strides, (b, head, seq)
// of q, k, v and out in that order.  Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out,
                               const long long* strides, int B, int S, int H,
                               int KV, int D, int causal, float scale,
                               void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(D, q, k, v, out, qs, ks, vs, os, B, S, H, KV, causal, scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(D, q, k, v, out, qs, ks, vs, os, B, S, H, KV, causal, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
