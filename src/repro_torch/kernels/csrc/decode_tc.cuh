// The GQA-packed tensor-core decode tile routine for Hopper (sm_90a):
// bf16 in, fp32 accumulate, by mma.sync.m16n8k16.  The bf16 body of
// decode_attention.cu is built on it; a paged decode needs only another
// key_off (the page gather).
//
// One query token per row: the G query heads of a KV group are the M rows
// of MT m16 tiles (G <= 16 MT; rows G.. are zero padding), so each K/V
// element is read once for the whole group.  Why mma.sync and not wgmma:
// wgmma's 64-row M would leave 56 of 64 rows idle at tinyllama's G 8 and
// 63 of 64 at phi3-mini's G 1, and needs a warpgroup per tile; mma.sync's
// 16 rows serve one warp, so the warps of a block walk the keys
// independently, each on its own ring, with no barrier between them.
//
// A block of kDecWarps warps walks the positions [start, end) in 16-key
// tiles, warp w taking tiles w, w + kDecWarps, ...:
//   * each tile's K and V rows come by 16-byte cp.async into the warp's
//     ring of kDecStages tiles (rows padded by 16 bytes, so ldmatrix's
//     eight rows hit distinct banks); keys past end are zero-filled;
//   * Q's A fragments are loaded once into registers (at D <= 128);
//   * S = Q K^T takes D/16 k-steps per 8 keys (B fragments by ldmatrix);
//   * the online softmax runs on the S accumulator in base 2 with
//     scale*log2e folded in (one FFMA and one ex2 a score), the row sums l
//     taken from the unrounded P;
//   * O += P V takes the S accumulator of 16 keys, packed to bf16 pairs,
//     as its A fragment (the same trick as attn_tc.cuh at the mma.sync
//     tile size), so P never goes through shared memory; V's B fragments
//     come by ldmatrix.trans.
// The caller merges the warps' (m, l, O) (dec_merge).
//
// Head dim 256 (recurrentgemma's ring decode, G 16: one m16 tile) changes
// two things, both to fit the card.  O alone is 128 fp32 registers a lane
// at D 256, and Q's 16 k-steps of A fragments would add 64 more, so Q is
// staged once per warp in shared memory (beside the warp's ring, with the
// first tile's cp.async group) and each k-step's A fragment is read there
// by ldmatrix.  And a tile of K and V is 16.5 KB at D 256, so a warp keeps
// two tiles in flight, not three: four warps' rings and Q copies take
// 165 KB, inside the 227 KB a block may have (three stages with Q would
// need 231 KB); a block is then alone on its SM either way.
#pragma once

#include <stdint.h>

#include "attn_tc.cuh"

namespace {

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecKeys = 16;         // keys of a warp's tile: one k16 step of P V
constexpr int kDecStages = 3;        // tiles a warp keeps in flight, D <= 128

// A head dim that is not a multiple of 16 (24: minicpm3's expanded MLA
// decode at smoke width) is staged and multiplied at DP, the next multiple
// of 16: the chunks of a K or V row past D are zero-filled by cp.async and
// Q's columns past D are zeros, so the pad adds exact zeros to S = Q K^T
// and fills columns of O that are never written out.
template <int D>
struct DecShape {
  static_assert(D % 8 == 0, "rows are staged in 16-byte chunks");
  static constexpr int kDP = (D + 15) / 16 * 16;        // the padded head dim
  static constexpr int kRow = kDP + 8;                  // a staged row, elements
  static constexpr int kTileBytes = kDecKeys * kRow * 2;  // a K or V tile
  // D 256: Q's A fragments from shared memory (one m16 tile, so G <= 16),
  // and two tiles in flight
  static constexpr bool kQShared = D > 128;
  static constexpr int kStages = kQShared ? 2 : kDecStages;
  static constexpr int kRingBytes = kStages * 2 * kTileBytes;
  static constexpr int kQBytes = kQShared ? 16 * kRow * 2 : 0;  // the staged Q tile
  static constexpr int kWarpBytes = kRingBytes + kQBytes;  // a warp's ring and Q
  static constexpr int kChunks = kDP / 8;               // 16 B chunks of a staged row
  static constexpr int kLiveChunks = D / 8;             // of them, those read from memory
  static constexpr int kSteps = kDP / 16;               // k16 steps of Q K^T
  static constexpr int kCols = kDP / 8;                 // n8 tiles of P V
};

// A warp's running state: O for rows r0 = lane/4 and r0 + 8 (index h) of
// each m16 tile mt, columns 8n + 2*(lane%4) + {0, 1}, in mma's
// accumulator order o[mt][n][2h + {0, 1}]; m is the raw (unscaled) max.
template <int D, int MT>
struct DecAcc {
  float o[MT][DecShape<D>::kCols][4];
  float m[MT][2];
  float l[MT][2];
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d += A B (m16n8k16, bf16 -> fp32)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's walk.  q: the group's G rows [G][D]; key position pos has
// its K and V rows at element offset key_off(pos) of k and v; ring: this
// warp's DecShape<D>::kWarpBytes of shared memory (its ring, then at D 256
// its Q tile); start < end.  Leaves acc.o unnormalised and acc.l summed
// over each row.
template <int D, int MT, typename KeyOff>
__device__ __forceinline__ void dec_attend(const __nv_bfloat16* __restrict__ q, int G,
                                           const __nv_bfloat16* __restrict__ k,
                                           const __nv_bfloat16* __restrict__ v, KeyOff key_off,
                                           int start, int end, uint32_t ring,
                                           float scale_log2, DecAcc<D, MT>& acc) {
  using Sh = DecShape<D>;
  static_assert(!Sh::kQShared || MT == 1, "a staged Q tile holds one m16 tile");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (end - start + kDecKeys - 1) / kDecKeys;
  const int n_mine = warp < n_tiles ? (n_tiles - 1 - warp) / kDecWarps + 1 : 0;
  const uint32_t q_s = ring + Sh::kRingBytes;  // the staged Q tile (D 256)
  auto slot = [&](int i) { return ring + (uint32_t)((i % Sh::kStages) * 2 * Sh::kTileBytes); };
  auto load = [&](int i) {  // this warp's i-th tile: tile warp + i * kDecWarps
    const int p0 = start + (warp + i * kDecWarps) * kDecKeys;
    const uint32_t dst = slot(i);
#pragma unroll
    for (int it = 0; it < kDecKeys * Sh::kChunks / 32; ++it) {
      const int c = lane + 32 * it;
      const int r = c / Sh::kChunks;
      const int ch = c % Sh::kChunks;
      const bool live = p0 + r < end && ch < Sh::kLiveChunks;
      const size_t off = live ? key_off(p0 + r) + ch * 8 : 0;
      const uint32_t o = (uint32_t)(r * Sh::kRow + ch * 8) * 2;
      cp_async16(dst + o, k + off, live ? 16 : 0);
      cp_async16(dst + Sh::kTileBytes + o, v + off, live ? 16 : 0);
    }
  };
  if constexpr (Sh::kQShared) {  // Q's 16 rows into group 0; rows past G and
                                 // chunks past D zero-filled
#pragma unroll
    for (int it = 0; it < 16 * Sh::kChunks / 32; ++it) {
      const int c = lane + 32 * it;
      const int r = c / Sh::kChunks;
      const int ch = c % Sh::kChunks;
      const bool live = r < G && ch < Sh::kLiveChunks;
      cp_async16(q_s + (uint32_t)(r * Sh::kRow + ch * 8) * 2, q + (live ? r * D + ch * 8 : 0),
                 live ? 16 : 0);
    }
  }
#pragma unroll
  for (int i = 0; i < Sh::kStages; ++i) {  // group i: this warp's tile i
    if (i < n_mine) load(i);
    cp_async_commit();
  }

  const int r0 = lane / 4;
  const int c2 = 2 * (lane % 4);
  uint32_t qa[MT][Sh::kQShared ? 1 : Sh::kSteps][4];  // at D <= 128
  if constexpr (!Sh::kQShared) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < Sh::kSteps; ++ks)
#pragma unroll
        for (int x = 0; x < 4; ++x) {  // rows r0, r0 + 8; columns c2, 8 + c2
          const int r = 16 * mt + r0 + 8 * (x & 1);
          qa[mt][ks][x] = r < G && 16 * ks + 8 * (x >> 1) < D
                              ? __ldg(reinterpret_cast<const unsigned int*>(
                                    q + r * D + 16 * ks + 8 * (x >> 1) + c2))
                              : 0u;
        }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < Sh::kCols; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc.o[mt][n][x] = 0.f;
    acc.m[mt][0] = acc.m[mt][1] = kNegInf;
    acc.l[mt][0] = acc.l[mt][1] = 0.f;
  }

  for (int i = 0; i < n_mine; ++i) {
    // of the kStages + i groups committed, tile i is group i
    cp_async_wait<Sh::kStages - 1>();
    __syncwarp();
    const uint32_t k_s = slot(i);
    const uint32_t v_s = k_s + Sh::kTileBytes;
    const int p0 = start + (warp + i * kDecWarps) * kDecKeys;
    // S = Q K^T; s[mt][j] holds keys 8j .. 8j + 7 of the tile
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int x = 0; x < 8; ++x) s[mt][x >> 2][x & 3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < Sh::kSteps; ++ks) {
      // matrices: keys 0-7 / 8-15 (lane / 16) x columns 16ks + 0-7 / 8-15
      uint32_t kb[4];
      ldsm_x4(kb, k_s + (uint32_t)(((lane / 16) * 8 + lane % 8) * Sh::kRow +
                                   16 * ks + ((lane / 8) % 2) * 8) * 2);
      if constexpr (Sh::kQShared) {
        // matrices: rows 0-7 / 8-15 (lane % 16) x columns 16ks + 0-7 / 8-15
        uint32_t qf[4];
        ldsm_x4(qf, q_s + (uint32_t)((lane % 16) * Sh::kRow + 16 * ks + (lane / 16) * 8) * 2);
        mma16816(s[0][0], qf, kb[0], kb[1]);
        mma16816(s[0][1], qf, kb[2], kb[3]);
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][0], qa[mt][ks], kb[0], kb[1]);
          mma16816(s[mt][1], qa[mt][ks], kb[2], kb[3]);
        }
      }
    }
    if (p0 + kDecKeys > end) {  // the last tile: mask the keys past end
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int x = 0; x < 8; ++x)
          if (p0 + 8 * (x >> 2) + c2 + (x & 1) >= end) s[mt][x >> 2][x & 3] = kNegInf;
    }
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // row r0 + 8h: s[mt][j][2h + {0, 1}]
        float mx = fmaxf(fmaxf(s[mt][0][2 * h], s[mt][0][2 * h + 1]),
                         fmaxf(s[mt][1][2 * h], s[mt][1][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(acc.m[mt][h], mx);
        alpha[h] = tc_exp2((acc.m[mt][h] - m_new) * scale_log2);
        acc.m[mt][h] = m_new;
        const float ms = m_new * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = tc_exp2(fmaf(s[mt][j][2 * h + e], scale_log2, -ms));
            s[mt][j][2 * h + e] = p;
            sum += p;  // the unrounded probabilities
          }
        acc.l[mt][h] = acc.l[mt][h] * alpha[h] + sum;
      }
#pragma unroll
      for (int n = 0; n < Sh::kCols; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc.o[mt][n][x] *= alpha[x >> 1];
      // P as the A fragment of one k16 step: rows r0 / r0 + 8, keys c2 / 8 + c2
      pa[mt][0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
      pa[mt][1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
      pa[mt][2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
      pa[mt][3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
    }
#pragma unroll
    for (int np = 0; np < Sh::kCols / 2; ++np) {
      // matrices: keys 0-7 / 8-15 ((lane / 8) % 2) x columns 16np + 0-7 / 8-15
      uint32_t vb[4];
      ldsm_x4_trans(vb, v_s + (uint32_t)((lane % 8 + ((lane / 8) % 2) * 8) * Sh::kRow +
                                         16 * np + (lane / 16) * 8) * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(acc.o[mt][2 * np], pa[mt], vb[0], vb[1]);
        mma16816(acc.o[mt][2 * np + 1], pa[mt], vb[2], vb[3]);
      }
    }
    __syncwarp();  // every lane has read the slot before it is refilled
    if (i + Sh::kStages < n_mine) load(i + Sh::kStages);
    cp_async_commit();  // one group a step, empty past the last tile
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the four lanes of a row share its sum
      acc.l[mt][h] += __shfl_xor_sync(0xffffffffu, acc.l[mt][h], 1);
      acc.l[mt][h] += __shfl_xor_sync(0xffffffffu, acc.l[mt][h], 2);
    }
}

// Shared memory of a block: the warps' rings, reused for the merge.
template <int D, int MT>
constexpr int dec_smem_bytes(int G) {
  const int ring = kDecWarps * DecShape<D>::kWarpBytes;
  const int merge = 4 * kDecWarps * (2 * 16 * MT + G * D);
  return ring > merge ? ring : merge;
}

// Merge the block's warps' states in shared memory (after every warp has
// left dec_attend) and hand row g, column d of the group's result to
// emit(g, d, o, m, l): o the unnormalised sum, m the raw max, l the row
// sum, all relative to m.  A warp that walked no tile has m = -1e30 and
// weighs nothing.
template <int D, int MT, typename Emit>
__device__ __forceinline__ void dec_merge(const DecAcc<D, MT>& acc, int G, unsigned char* smem,
                                          float scale_log2, Emit emit) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* m_s = reinterpret_cast<float*>(smem);  // [kDecWarps][16 MT]
  float* l_s = m_s + kDecWarps * 16 * MT;       // [kDecWarps][16 MT]
  float* o_s = l_s + kDecWarps * 16 * MT;       // [kDecWarps][G][D]
  __syncthreads();  // every warp is done with its ring
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + lane / 4 + 8 * h;
      if (r >= G) continue;
      if (lane % 4 == 0) {
        m_s[warp * 16 * MT + r] = acc.m[mt][h];
        l_s[warp * 16 * MT + r] = acc.l[mt][h];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)  // the pad columns past D are dropped
        *reinterpret_cast<float2*>(o_s + ((size_t)warp * G + r) * D + 8 * n + 2 * (lane % 4)) =
            make_float2(acc.o[mt][n][2 * h], acc.o[mt][n][2 * h + 1]);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kDecThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, m_s[w * 16 * MT + g]);
    float l = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = tc_exp2((m_s[w * 16 * MT + g] - mx) * scale_log2);
      l += l_s[w * 16 * MT + g] * f;
      o += o_s[((size_t)w * G + g) * D + d] * f;
    }
    emit(g, d, o, mx, l);
  }
}

}  // namespace
