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
// output: ~11 us of bytes at 3.35 TB/s, ~9 us of bf16 tensor-core work at
// 989 TFLOP/s, so on the tensor cores the bytes bound it.
//
// bf16 (the training path): `flash_fwd_wgmma_kernel`, the tensor-core
// tile routine of attn_tc.cuh.  One block of two warpgroups per 128 query
// rows of one head; both read each 64-key K/V tile of KV head h / G,
// copied through its strides by cp.async into a two-slot ring of swizzled
// bf16 tiles, so the next tile loads while wgmma computes S = Q K^T and
// O += P V.  The causal walk stops at the tile holding the block's last
// query, each warpgroup at its own, and masks only the diagonal tile;
// keys past S in the last tile are zero-filled and masked, rows past S
// are not written.  The grid starts the causal triangle's longest tiles
// first, so the last wave is not all long tiles.  The G heads of a group
// read the same K/V tiles, which the 50 MB L2 serves after the first.
// What holds it back at the training shape (PERF.md): the per-tile chain
// of wgmma waits, the MUFU-bound softmax and the barrier runs in lockstep
// in the warpgroups of an SM; the kernel takes ~4x its bound.
//
// fp32: `flash_fwd_kernel` on the CUDA cores, kept as it was written (the
// tensor cores would round fp32 to TF32, and the fp32 checks compare the
// kernel path with the plain one at 1e-4 in the training loss).  One
// block per (row, KV head, tile of bq queries); its 128 threads each own
// one (query, head) row of the GQA group, with the q row and the fp32
// accumulator in registers; 32-key tiles staged in shared memory as fp32
// and read as broadcasts; the online softmax rescales once per 16 keys.
// A bf16 call whose rows are not 16-byte aligned takes this kernel too.
#include "attn_tc.cuh"

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

// two warpgroups a block share each K/V tile; 128 registers a thread
// keeps two blocks on an SM
constexpr int kFlashWG = 2;
constexpr int kFlashRows = kTcRows * kFlashWG;
constexpr int kFlashThreads = kTcThreads * kFlashWG;

// grid (n_qt * B*H), kFlashThreads threads: block x owns the kFlashRows
// query rows of tile qt of head bh = x % (B*H); for causal attention the
// first B*H blocks take the last (longest) tile.
template <int D>
__global__ void __launch_bounds__(kFlashThreads, 2) flash_fwd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, Strides qs,
    Strides ks, Strides vs, Strides os, int S, int H, int KV, int BH, int n_qt, int causal,
    float scale_log2) {
  extern __shared__ unsigned char tc_smem[];
  const uint32_t q_s = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + kFlashWG * TcShape<D>::kTileBytes;
  const int rank = blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int qt = causal ? n_qt - 1 - rank : rank;
  const int b = bh / H;
  const int h = bh % H;
  const int kv = h / (H / KV);
  const int q0 = qt * kFlashRows;
  const __nv_bfloat16* q_head = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* k_head = k + b * ks.b + kv * ks.h;
  const __nv_bfloat16* v_head = v + b * vs.b + kv * vs.h;

  tc_load_rows<D, kFlashWG, kFlashThreads>(q_s, [&](int r) {
    return q0 + r < S ? q_head + (q0 + r) * qs.s : nullptr; }, q);
  // the block's last key: its last query's (causal) or the last of all
  const int last_key = causal ? min(q0 + kFlashRows - 1, S - 1) : S - 1;
  auto load_kv = [&](int j, uint32_t k_dst, uint32_t v_dst) {
    const int k0 = j * kTcKeys;
    tc_load_rows<D, 1, kFlashThreads>(k_dst, [&](int r) {
      return k0 + r <= last_key ? k_head + (k0 + r) * ks.s : nullptr; }, k);
    tc_load_rows<D, 1, kFlashThreads>(v_dst, [&](int r) {
      return k0 + r <= last_key ? v_head + (k0 + r) * vs.s : nullptr; }, v);
  };
  // this warpgroup's rows q0 + 64w .. q0 + 64w + 63
  const int w0 = q0 + kTcRows * tc_wg();
  int lim[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    lim[hh] = causal ? min(q0 + tc_row0() + 8 * hh, S - 1) : S - 1;
  TcAcc<D> acc;
  tc_attend<D>(
      q_s, kv_s, last_key / kTcKeys + 1, load_kv, lim, causal ? w0 : S - 1,
      w0 >= S ? -1 : causal ? min(w0 + kTcRows - 1, S - 1) : S - 1, scale_log2, acc);
  tc_store<D>(acc, [&](int r) {
    return q0 + r < S ? out + b * os.b + h * os.h + (q0 + r) * os.s : nullptr; },
              [](int) { return false; });
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, Strides qs,
                      Strides ks, Strides vs, Strides os, int B, int S, int H, int KV,
                      int causal, float scale, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<D>(kFlashWG);
  static bool attr_set = false;  // raise the dynamic shared-memory cap once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_qt = (S + kFlashRows - 1) / kFlashRows;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<D><<<(unsigned)blocks, kFlashThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), qs, ks, vs,
      os, S, H, KV, B * H, n_qt, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// the tensor-core kernel reads and writes rows with 16-byte accesses
bool rows_aligned(const void* const* ptrs, const Strides* strides) {
  for (int i = 0; i < 4; ++i) {
    if (!aligned16(ptrs[i])) return false;
    if (strides[i].b % 8 || strides[i].h % 8 || strides[i].s % 8) return false;
  }
  return true;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int S, int H, int KV, int causal, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  if (G > kThreads || B * KV > 65535) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {  // bf16
    const void* ptrs[4] = {q, k, v, out};
    const Strides strides[4] = {qs, ks, vs, os};
    if (rows_aligned(ptrs, strides))
      return launch_tc<D>(q, k, v, out, qs, ks, vs, os, B, S, H, KV, causal, scale, stream);
  }
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
    case 96: return launch<T, 96>(q, k, v, out, qs, ks, vs, os, B, S, H, KV, causal, scale, s);
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
