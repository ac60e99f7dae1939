// The 3xTF32 attention pass shared by the float32 paths of K1 (fused_attention.cu, one pass a
// block; the statistics pass of its backward, fused_attention_bwd.cu) and K3
// (fused_readout_f32.cu, the cross pass and then the self pass of one Q tile).
//
// A block of 4 warps owns 64 q rows of one head, each warp 16 rows across all of D
// (FlashAttention-2's warp layout). Each D % 8 == 0 up to 160 has its own instantiation, so every
// loop has a fixed trip count and every shared offset is a constant. Per 64-key tile:
//   * K and V come to shared memory by cp.async, double-buffered, at leading dims that make every
//     fragment load conflict-free (ld_k_f32, ld_v_f32);
//   * S = Q K^T on the tensor cores, mma.sync.m16n8k8, each float32 operand split where its
//     fragment is loaded into hi = tf32(x) and lo = x - hi (attention_common.cuh split_tf32), each
//     product a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation (the dropped a_lo b_lo term
//     is ~2^-22 relative). Q's fragments are read and split from its tile at each k8 step: held
//     in registers they pushed the count near the 255 limit and ran slower;
//   * with each k8 step's k order permuted (fragment k = t and t + 4 are columns 2t and 2t + 1),
//     the C fragment of a score n8 tile is already the A fragment of P V's k8 step, so the
//     scores and probabilities never leave registers; V's B fragment takes rows 2t and 2t + 1 of
//     the step's 8 keys;
//   * the online softmax is the bf16 pipeline's (attention_wgmma.cuh softmax_tile: exp2 with
//     scale log2 e folded into one FMA);
//   * the tensor cores truncate their f32 sums, so no sum of theirs runs long: Q K^T spans at most
//     20 k8 steps, and each tile's P V is a fresh sum (8 k8 steps), added to the corr-rescaled
//     accumulator with rounded f32 FMAs. In the bf16_probs mode (K1 only) P is exact in bf16, so
//     its TF32 low part is zero and P V takes two products instead of three.

#pragma once

#include "attention_wgmma.cuh"

namespace attn {

// Leading dims (floats) of the shared K and V tiles. K (and Q) rows are read as 8-byte pairs at
// columns 2t of rows g, conflict-free when ld = 8 mod 16 (8 or 24 mod 32); V as single floats at
// rows 2t and 2t + 1, column g, conflict-free when ld = 4 mod 8. Every row start stays 16-byte
// aligned for cp.async.
__host__ __device__ constexpr int ld_k_f32(int d) { return d % 16 == 8 ? d : d + 8; }
__host__ __device__ constexpr int ld_v_f32(int d) { return d + 4; }

// Shared memory (bytes) at head dim D: two stages of a K tile and a V tile, then the Q tile;
// a kernel's own shared memory starts at TOTAL. Stages are addressed as offsets from the shared
// base, so that every load is a shared-memory load.
template <int D>
struct SmemF32 {
  static constexpr size_t KB = align128(size_t(BKV) * ld_k_f32(D) * 4);
  static constexpr size_t VB = align128(size_t(BKV) * ld_v_f32(D) * 4);
  static constexpr size_t STAGE = KB + VB;  // K at 0, V at KB within a stage
  static constexpr size_t Q = 2 * STAGE;
  static constexpr size_t TOTAL = 2 * STAGE + KB;
};

// cp.async of rows [0, 64) x columns [0, D) of a row-major (rows, D) f32 matrix into a tile of
// leading dim LD, 16 bytes a copy.
template <int D, int LD>
__device__ __forceinline__ void copy_tile_f32(float* dst, const float* __restrict__ src) {
  constexpr int CPR = D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < BKV * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    cp_async16(dst + r * LD + 4 * c, src + size_t(r) * D + 4 * c);
  }
}

// Issue (not commit) the cp.async copy of the block's 64 Q rows into its tile; the first pass's
// first K/V tile joins its group.
template <int D>
__device__ __forceinline__ void copy_q_f32(unsigned char* smem, const float* __restrict__ q_rows) {
  copy_tile_f32<D, ld_k_f32(D)>(reinterpret_cast<float*>(smem + SmemF32<D>::Q), q_rows);
}

// One online-softmax pass of this warp's 16 q rows (rows 16 warp + g and + 8 of the Q tile, which
// copy_q_f32 has issued) over the s_len keys of one head: kh and vh point at its (s_len, D) rows,
// s_len % 64 == 0. On return acc holds the unnormalised P V (acc[n] = rows g (0, 1) and g + 8
// (2, 3), columns 8 n + 2 t, + 1) and l_run this thread's share of the two row sums (quad_sum
// before use). The pass ends with a __syncthreads, so a second pass may refill both stages.
// m_run: the two rows' maxima of the unscaled logits on return (the backward's statistics pass).
template <int D, bool BF16P = false>
__device__ __forceinline__ void attend_tf32(unsigned char* smem, const float* __restrict__ kh,
                                            const float* __restrict__ vh, int s_len,
                                            float scale_log2, float scale_bf16,
                                            float (&acc)[D / 8][4], float (&l_run)[2],
                                            float (&m_run)[2]) {
  constexpr int KS = D / 8;    // k8 steps of Q K^T, n8 tiles of O
  constexpr int NS = BKV / 8;  // n8 tiles of a score tile, k8 steps of P V
  constexpr int LDK = ld_k_f32(D), LDV = ld_v_f32(D);
  using L = SmemF32<D>;
  const float* Qs = reinterpret_cast<const float*>(smem + L::Q);
  auto k_tile = [&](int buf) { return reinterpret_cast<float*>(smem + buf * L::STAGE); };
  auto v_tile = [&](int buf) { return reinterpret_cast<float*>(smem + buf * L::STAGE + L::KB); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = s_len / BKV;

  copy_tile_f32<D, LDK>(k_tile(0), kh);
  copy_tile_f32<D, LDV>(v_tile(0), vh);
  cp_async_commit();

#pragma unroll
  for (int n = 0; n < KS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  m_run[0] = m_run[1] = -INFINITY;  // rows g, g + 8, over unscaled logits
  l_run[0] = l_run[1] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      copy_tile_f32<D, LDK>(k_tile(buf ^ 1), kh + size_t(tile + 1) * BKV * D);
      copy_tile_f32<D, LDV>(v_tile(buf ^ 1), vh + size_t(tile + 1) * BKV * D);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // this tile has landed
    __syncthreads();
    const float* Kt = k_tile(buf);
    const float* Vt = v_tile(buf);

    // S = Q K^T, unscaled: K stored (key, D) row-major is the col-major B operand; the small
    // products go first into each sum
    float sc[NS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4];
      load_a_3xtf32(ah, al, Qs, LDK, 16 * warp, 8 * ks, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 kp =
            *reinterpret_cast<const float2*>(Kt + (8 * n + g) * LDK + 8 * ks + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kp.x, bh0, bl0);
        split_tf32(kp.y, bh1, bl1);
        if (ks == 0) {
          mma_tf32_first(sc[n], al, bh0, bh1);
        } else {
          mma_tf32(sc[n], al, bh0, bh1);
        }
        mma_tf32(sc[n], ah, bl0, bl1);
        mma_tf32(sc[n], ah, bh0, bh1);
      }
    }
    float s[4 * NS];  // the same registers in softmax_tile's flat layout
#pragma unroll
    for (int i = 0; i < 4 * NS; ++i) s[i] = sc[i / 4][i % 4];

    float corr[2];
    softmax_tile<BF16P>(s, m_run, l_run, corr, scale_log2, scale_bf16, BKV, t);

    // O = O * corr + P V: the score tile's n8 tile kk is P V's k8 step kk, its C fragment
    // (keys 2t, 2t + 1 of rows g, g + 8) the A fragment under the permuted k order; V's B
    // fragment takes the same order, rows 2t and 2t + 1 of the step's 8 keys
    float part[KS][4];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      // A fragment (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) = C elements 0, 2, 1, 3
      uint32_t ph[4], pl[4];
      if constexpr (BF16P) {  // bf16, so exact in tf32: no low part. s[4 kk] and s[4 kk + 2]
        // hold the packed pairs of rows g and g + 8 (tile_probs); a bf16 value's float32 bits
        // are its 16 bits shifted up
        const uint32_t lo_row = __float_as_uint(s[4 * kk]);
        const uint32_t hi_row = __float_as_uint(s[4 * kk + 2]);
        ph[0] = lo_row << 16;
        ph[1] = hi_row << 16;
        ph[2] = lo_row & 0xFFFF0000u;
        ph[3] = hi_row & 0xFFFF0000u;
      } else {
        split_tf32(s[4 * kk], ph[0], pl[0]);
        split_tf32(s[4 * kk + 2], ph[1], pl[1]);
        split_tf32(s[4 * kk + 1], ph[2], pl[2]);
        split_tf32(s[4 * kk + 3], ph[3], pl[3]);
      }
      const float* v0 = Vt + (8 * kk + 2 * t) * LDV + g;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[8 * n], bh0, bl0);
        split_tf32(v0[8 * n + LDV], bh1, bl1);
        if constexpr (BF16P) {
          if (kk == 0) {
            mma_tf32_first(part[n], ph, bl0, bl1);
          } else {
            mma_tf32(part[n], ph, bl0, bl1);
          }
        } else {
          if (kk == 0) {
            mma_tf32_first(part[n], pl, bh0, bh1);
          } else {
            mma_tf32(part[n], pl, bh0, bh1);
          }
          mma_tf32(part[n], ph, bl0, bl1);
        }
        mma_tf32(part[n], ph, bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], corr[e / 2], part[n][e]);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

// attend_tf32 without the row maxima (the forward kernels').
template <int D, bool BF16P = false>
__device__ __forceinline__ void attend_tf32(unsigned char* smem, const float* __restrict__ kh,
                                            const float* __restrict__ vh, int s_len,
                                            float scale_log2, float scale_bf16,
                                            float (&acc)[D / 8][4], float (&l_run)[2]) {
  float m_run[2];
  attend_tf32<D, BF16P>(smem, kh, vh, s_len, scale_log2, scale_bf16, acc, l_run, m_run);
}

}  // namespace attn
