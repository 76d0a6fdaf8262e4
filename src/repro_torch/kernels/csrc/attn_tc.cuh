// The tensor-core attention tile routine for Hopper (sm_90a): bf16 in,
// fp32 accumulate.  The bf16 bodies of flash_attention.cu and of both
// prefills (prefill_attention.cu, prefill_attention_paged.cu, through
// tc_prefill_block at the end) are built on it; their fp32 bodies stay on
// the CUDA cores (tensor cores would round fp32 inputs to TF32).
//
// A block of NWG warpgroups (128 threads each) owns a tile of 64*NWG
// query rows, staged once in shared memory; warpgroup w computes rows
// 64w .. 64w + 63 and every warpgroup reads each K/V tile.  The block
// walks 64-key K/V tiles:
//   * the caller's loader issues 16-byte cp.async copies of a tile into a
//     two-slot ring: tile j + 1 loads while the block computes on tile j;
//     rows it does not load are zero-filled by the copy itself;
//   * S = Q K^T by wgmma m64n64k16 (Q and K from shared memory, both
//     K-major), into fp32 registers;
//   * the online softmax runs on those registers in fp32, in base 2
//     (exp2(s*scale*log2e - m), one FFMA and one MUFU.EX2 a score), with
//     the row sums l taken from the unrounded probabilities;
//   * O += P V by wgmma with P as the register A operand: the S
//     accumulator fragment of 16 keys is, packed to bf16 pairs, exactly
//     the A fragment of one k16 step (FlashAttention-3's scheme), so P
//     never goes through shared memory.  V is read MN-major from the same
//     layout K is stored in.
// Every tile in shared memory is [64 rows][64 bf16] blocks of 128-byte
// rows with the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)), 1024-byte aligned; a row of D columns takes ceil(D / 64)
// such blocks (D = 96 and 128 take two).  When D is not a multiple of 64
// (16, 32, 96) the last block is used in its first columns: Q K^T takes
// D/16 k-steps, the copies zero-fill the block's columns past D, and the
// columns of P V past D (zeros) are never written out.
//
// Measured on the H100 (PERF.md), none of these ran
// faster at the training shape than the one-barrier loop below: issuing a
// tile's scores under the previous softmax, overlapping P V with the next
// softmax (FlashAttention-3's intra-warpgroup overlap), ping-ponging two
// warpgroups on named barriers, Q as a register operand, rings of three
// and four tiles, one warpgroup a block, and GQA-packed rows.  ptxas
// serializes in-flight wgmmas under a 128-register cap (C7512, C7515) and
// under control flow it cannot prove warpgroup-uniform (C7518).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcRows = 64;      // query rows of a tile (wgmma M)
constexpr int kTcKeys = 64;      // keys of a K/V tile
constexpr int kTcStages = 2;     // K/V ring depth
constexpr int kTcBlockBytes = 64 * 128;  // one [64][64] bf16 block

template <int D>
struct TcShape {
  static constexpr int kBlocks = (D + 63) / 64;              // 64-column blocks
  static constexpr int kTileBytes = kBlocks * kTcBlockBytes;  // a Q, K or V tile
  static constexpr int kChunks = D / 8;                       // 16 B chunks of a row
  static constexpr int kRowChunks = kBlocks * 8;              // the same, with the pad
  static constexpr int kSteps = D / 16;                       // k16 steps of Q K^T
};

// shared memory of a block of nwg warpgroups: its Q tiles, the K/V ring,
// and slack to align the base to 1024 B
template <int D>
constexpr int tc_smem_bytes(int nwg) {
  return TcShape<D>::kTileBytes * (nwg + 2 * kTcStages) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk ch of row r in a swizzled tile
__device__ __forceinline__ uint32_t tc_offset(int r, int ch) {
  return (uint32_t)((ch >> 3) * kTcBlockBytes + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads
// nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// order this thread's completed shared-memory writes before wgmma's reads
// (wgmma reads its operands through the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading byte
// offset (unused by the swizzled layouts read here), stride byte offset
// 1024 (from one 8-row group to the next), 128-byte swizzle
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous instruction's issue and wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TC_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TC_OUT32(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),    \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

// d (+)= A B, A and B K-major in shared memory (m64n64k16, bf16 -> fp32);
// accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A from registers (four bf16 pairs a thread), B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : TC_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

#undef TC_D32
#undef TC_OUT32

// 2^x by the MUFU unit (ex2.approx, relative error ~2^-22)
__device__ __forceinline__ float tc_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage 64*NR rows into the swizzled tile(s) at dst (NR tiles of 64 rows,
// one after another) with the block's THREADS threads: src(r) is row r's
// first element, or nullptr for a row to zero-fill (dummy is then the
// address handed to the copy, which reads none of it).  The chunks of the
// last 64-column block past D are zero-filled too.
template <int D, int NR, int THREADS, typename Src>
__device__ __forceinline__ void tc_load_rows(uint32_t dst, Src src,
                                             const __nv_bfloat16* dummy) {
  constexpr int C = TcShape<D>::kRowChunks;
  constexpr int N = kTcRows * NR * C;
#pragma unroll
  for (int it = 0; it < (N + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (N % THREADS == 0 || i < N) {
      const int r = i / C;
      const int ch = i % C;
      const __nv_bfloat16* p = ch < TcShape<D>::kChunks ? src(r) : nullptr;
      cp_async16(dst + (r / kTcRows) * TcShape<D>::kTileBytes + tc_offset(r % kTcRows, ch),
                 p ? p + ch * 8 : dummy, p ? 16 : 0);
    }
  }
}

// One thread's share of its warpgroup's 64 rows: rows r0 = 16*warp + lane/4
// and r0 + 8 (index h = 0, 1) of the warpgroup's tile, columns 64*nb +
// 8*i + 2*(lane%4) + {0, 1}, in wgmma's accumulator order
// o[nb][4*i + 2*h + {0, 1}].
template <int D>
struct TcAcc {
  float o[TcShape<D>::kBlocks][32];
  float m[2];
  float l[2];
};

__device__ __forceinline__ int tc_wg() { return threadIdx.x / kTcThreads; }
// the thread's first row in the block's tile (its second is 8 further)
__device__ __forceinline__ int tc_row0() {
  return kTcRows * tc_wg() + 16 * ((threadIdx.x % kTcThreads) / 32) + (threadIdx.x % 32) / 4;
}

// Issue S = Q K^T for one K tile (not waited on).
template <int D>
__device__ __forceinline__ void tc_issue_scores(float (&s)[32], uint32_t q_s, uint32_t k_s) {
  fence_regs(s);  // s's old values are dead: the first k-step overwrites them
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < TcShape<D>::kSteps; ++ks) {
    const uint32_t off = (ks >> 2) * kTcBlockBytes + (ks & 3) * 32;
    wgmma_ss(s, tc_desc(q_s + off), tc_desc(k_s + off), ks > 0);
  }
  wg_commit();
}

// The online softmax of one tile's raw scores s (keys k0 .. k0 + 63), in
// place: mask, running max, s = P = exp2(s*scale_log2 - m), l from the
// unrounded P.  Returns in alpha the factor O must be scaled by before
// this tile's P V is added.
template <int D>
__device__ __forceinline__ void tc_softmax(float (&s)[32], int k0, const int (&lim)[2],
                                           int min_lim, float scale_log2, TcAcc<D>& acc,
                                           float (&alpha)[2]) {
  const int tq = threadIdx.x % 4;
  if (k0 + kTcKeys - 1 > min_lim) {  // a key past some row's last: mask
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (k0 + 8 * (i >> 2) + 2 * tq + (i & 1) > lim[(i >> 1) & 1]) s[i] = kNegInf;
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float ms[2];  // the running max, scaled to base 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the four threads of a row share its max
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(acc.m[h], mx[h]);
    alpha[h] = tc_exp2((acc.m[h] - m_new) * scale_log2);
    acc.m[h] = m_new;
    ms[h] = m_new * scale_log2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const float p = tc_exp2(fmaf(s[i], scale_log2, -ms[h]));
    s[i] = p;
    sum[h] += p;  // the unrounded probabilities
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) acc.l[h] = acc.l[h] * alpha[h] + sum[h];
}

// O *= alpha, and P (in s) into bf16 A fragments: keys 16kk .. 16kk + 15
// are s[8kk .. 8kk + 7]
template <int D>
__device__ __forceinline__ void tc_rescale_pack(const float (&s)[32], const float (&alpha)[2],
                                                TcAcc<D>& acc, uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int nb = 0; nb < TcShape<D>::kBlocks; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc.o[nb][i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// Issue O += P V for one V tile (not waited on).
template <int D>
__device__ __forceinline__ void tc_issue_pv(TcAcc<D>& acc, const uint32_t (&pa)[4][4],
                                            uint32_t v_s) {
#pragma unroll
  for (int nb = 0; nb < TcShape<D>::kBlocks; ++nb) fence_regs(acc.o[nb]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nb = 0; nb < TcShape<D>::kBlocks; ++nb)
      wgmma_rs(acc.o[nb], pa[kk], tc_desc(v_s + nb * kTcBlockBytes + kk * 16 * 128));
  wg_commit();
}

// The tile loop of a block of warpgroups, warpgroup w owning rows
// 64w .. 64w + 63 of the Q tile at q_s (64-row swizzled tiles, one after
// another), all of them reading each K/V tile.  The caller has issued (not
// committed) the cp.async copies of the Q tile; kv_s is the K/V ring.
// load_kv(j, k_dst, v_dst) issues the copies of K/V tile j (keys 64j ..
// 64j + 63).  Key position p is visible to this thread's rows h = 0, 1
// when p <= lim[h]; the mask is applied on the tiles that hold a key past
// min_lim (the least lim of the warpgroup's live rows), all others being
// wholly visible; the warpgroup computes the tiles up to the one holding
// max_lim (the largest lim of its rows) and only takes part in the
// copies and barriers of the others.  One barrier a tile: once every
// thread has passed it, tile j has landed and tile j - 1's slot is free,
// so the copy of tile j + 1 starts there and runs under the compute of
// tile j.  Leaves acc.o unnormalised and acc.l summed over the row.
template <int D, typename LoadKV>
__device__ __forceinline__ void tc_attend(uint32_t q_s, uint32_t kv_s, int n_tiles,
                                          LoadKV load_kv, const int (&lim)[2], int min_lim,
                                          int max_lim, float scale_log2, TcAcc<D>& acc) {
  constexpr uint32_t TB = TcShape<D>::kTileBytes;
#pragma unroll
  for (int nb = 0; nb < TcShape<D>::kBlocks; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc.o[nb][i] = 0.f;
  acc.m[0] = acc.m[1] = kNegInf;
  acc.l[0] = acc.l[1] = 0.f;
  const uint32_t my_q = q_s + tc_wg() * TB;
  const int n_mine = max_lim < 0 ? 0 : min(n_tiles, max_lim / kTcKeys + 1);

  auto slot = [&](int j) { return kv_s + (uint32_t)(j % kTcStages) * 2 * TB; };
#pragma unroll
  for (int j = 0; j < kTcStages; ++j) {  // group j: tile j (group 0 with Q)
    if (j < n_tiles) load_kv(j, slot(j), slot(j) + TB);
    cp_async_commit();
  }
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  uint32_t pa[4][4];
  for (int j = 0; j < n_tiles; ++j) {
    // of the kTcStages + j groups committed, tile j < kTcStages is group
    // j; a later tile was copied in step j + 1 - kTcStages, group j + 1
    if (j < kTcStages)
      cp_async_wait<kTcStages - 1>();
    else
      cp_async_wait<kTcStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (j >= 1 && j - 1 + kTcStages < n_tiles)
      load_kv(j - 1 + kTcStages, slot(j - 1), slot(j - 1) + TB);
    cp_async_commit();  // one group a step, empty past the last tile
    if (j < n_mine) {  // uniform over the warpgroup
      tc_issue_scores<D>(s, my_q, slot(j));
      wg_wait<0>();
      fence_regs(s);
      float alpha[2];
      tc_softmax<D>(s, j * kTcKeys, lim, min_lim, scale_log2, acc, alpha);
      tc_rescale_pack<D>(s, alpha, acc, pa);
      tc_issue_pv<D>(acc, pa, slot(j) + TB);
      wg_wait<0>();
#pragma unroll
      for (int nb = 0; nb < TcShape<D>::kBlocks; ++nb) fence_regs(acc.o[nb]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    acc.l[h] += __shfl_xor_sync(0xffffffffu, acc.l[h], 1);
    acc.l[h] += __shfl_xor_sync(0xffffffffu, acc.l[h], 2);
  }
}

// Write this thread's share of the normalised tile: dst(r) is row r's
// first output element, or nullptr for a row not to write; zero(r) makes
// the row exact zeros.
template <int D, typename Dst, typename Zero>
__device__ __forceinline__ void tc_store(const TcAcc<D>& acc, Dst dst, Zero zero) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tc_row0() + 8 * h;
    __nv_bfloat16* row = dst(r);
    if (!row) continue;
    const bool z = zero(r);
    const float inv = 1.f / fmaxf(acc.l[h], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < TcShape<D>::kBlocks; ++nb)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * nb + 8 * i + 2 * tq;
        if (col < D)
          *reinterpret_cast<uint32_t*>(row + col) =
              z ? 0u : pack_bf16(acc.o[nb][4 * i + 2 * h] * inv,
                                 acc.o[nb][4 * i + 2 * h + 1] * inv);
      }
  }
}

// true when p is 16-byte aligned
__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The ragged causal chunk prefill of one block (one warpgroup), the body
// of both prefill kernels; they differ only in where a key's row lives.
// The block owns flattened query rows r = t*G + g, 64*qi .. 64*qi + 63,
// of (row b, KV head kv), so the G heads of a group share every staged
// K/V tile; row r's causal frontier is base + r / G.  q, out are [B,
// T_len, H, D]; key position pos (0 <= pos < cap) has its K and V rows at
// element offset key_off(pos) of k and v.  The walk stops at the tile
// holding the block's last valid query's position (inside cap), keys past
// it are zero-filled and masked, and a block wholly past clen writes its
// rows as zeros and returns.  Padding rows (t >= clen) are exact zeros.
template <int D, typename KeyOff>
__device__ __forceinline__ void tc_prefill_block(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int T_len,
    int H, int KV, int b, int kv, int qi, int base, int clen, int cap, float scale_log2,
    KeyOff key_off) {
  extern __shared__ unsigned char tc_smem[];
  const uint32_t q_s = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + TcShape<D>::kTileBytes;  // after the Q tile
  const int G = H / KV;
  const int f0 = qi * kTcRows;  // first flattened row t*G + g of the tile
  auto row_ptr = [&](__nv_bfloat16* p, int r) -> __nv_bfloat16* {
    const int t = (f0 + r) / G;
    return t < T_len ? p + (((size_t)b * T_len + t) * H + kv * G + (f0 + r) % G) * D
                     : nullptr;
  };
  auto is_pad = [&](int r) { return (f0 + r) / G >= clen; };

  if (f0 / G >= clen) {  // tile wholly past the chunk: padding rows only
    TcAcc<D> zero{};
    tc_store<D>(zero, [&](int r) { return row_ptr(out, r); }, [](int) { return true; });
    return;  // uniform over the block
  }
  tc_load_rows<D, 1, kTcThreads>(q_s, [&](int r) -> const __nv_bfloat16* {
    return row_ptr(const_cast<__nv_bfloat16*>(q), r); }, q);
  // the block's causal frontier: its last valid query's position, inside cap
  const int t_last = min(min((f0 + kTcRows - 1) / G, T_len - 1), clen - 1);
  const int frontier = min(base + t_last, cap - 1);
  auto load_kv = [&](int j, uint32_t k_dst, uint32_t v_dst) {
    const int k0 = j * kTcKeys;
    tc_load_rows<D, 1, kTcThreads>(k_dst, [&](int r) -> const __nv_bfloat16* {
      return k0 + r <= frontier ? k + key_off(k0 + r) : nullptr; }, k);
    tc_load_rows<D, 1, kTcThreads>(v_dst, [&](int r) -> const __nv_bfloat16* {
      return k0 + r <= frontier ? v + key_off(k0 + r) : nullptr; }, v);
  };
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)  // padding rows see nothing; their output is 0
    lim[h] = is_pad(tc_row0() + 8 * h) ? -1 : min(base + (f0 + tc_row0() + 8 * h) / G, cap - 1);
  TcAcc<D> acc;
  tc_attend<D>(q_s, kv_s, frontier >= 0 ? frontier / kTcKeys + 1 : 0, load_kv, lim,
               min(base + f0 / G, cap - 1), frontier, scale_log2, acc);
  tc_store<D>(acc, [&](int r) { return row_ptr(out, r); }, is_pad);
}

}  // namespace
