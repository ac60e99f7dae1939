// Shared machinery of the attention kernels: the float32 check paths of K1 (fused_attention.cu)
// and K3 (fused_readout.cu) and the previous bf16 designs of K1 and K3 (attention_v2.cu,
// fused_readout_v2.cu) use the tile loops below, K4 (streaming_attention.cu) the primitives.
// The bf16 Hopper kernels of K1 and K3 share their pipeline in attention_wgmma.cuh.
//
// The tile loops compute one online-softmax attention pass for a block's 64 query rows over
// every key of one head, keeping the JAX kernels' numerics contract: f32 logits and softmax
// statistics, the row max over the UNSCALED logits with the scale folded into exp's operand,
// the f32 row sum taken before the probabilities are cast to V's dtype for the PV product
// (f32 accumulation). The caller applies 1 / rowsum.
//
// bf16: mma.sync.m16n8k16 with register-resident Q fragments, score tile, probabilities and
// accumulator; K/V tiles double-buffered with cp.async.
// float32: plain FMAs with the score tile and the accumulator in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace attn {

constexpr int BQ = 64;   // q rows per block
constexpr int BKV = 64;  // keys per K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// primitives: cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ inline void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ inline void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ inline void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ inline void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// x rounded to bf16 (to nearest even) and back to f32. On the device with integer operations,
// which run at full rate where a conversion instruction does not (x is never a NaN here).
__host__ __device__ inline float round_bf16(float x) {
#ifdef __CUDA_ARCH__
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
#else
  return __bfloat162float(__float2bfloat16_rn(x));
#endif
}

// The bf16_probs mode's probability of logit s under the f32 row max m, rounded where the TPU
// kernels round (ops/pallas/attention.py:51-55, attention_stream.py:62-69): the centred logit
// s - m to bf16, its product with the bf16 scale to bf16, the exponential to bf16.
__device__ __forceinline__ float prob_bf16(float s, float m, float scale_bf16) {
  return round_bf16(exp2f(round_bf16(round_bf16(s - m) * scale_bf16) * LOG2E));
}

// ---------------------------------------------------------------------------
// bf16 tile loop (4 warps, 16 q rows each)
// ---------------------------------------------------------------------------

// Shared memory of the bf16 loop: Q + 2 x K + 2 x V tiles of 64 rows, rows padded by 16 bytes.
template <int DP>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return size_t(5) * BQ * (DP + 8) * sizeof(bf16);
}

// Copy rows [0, 64) x columns [0, d) of a row-major (rows, d) bf16 matrix into a tile of
// leading dimension LD with cp.async, 16 bytes a thread (d % 8 == 0).
template <int LD>
__device__ inline void load_tile_bf16(bf16* dst, const bf16* src, int d) {
  const int cpr = d / 8;
  for (int i = threadIdx.x; i < BKV * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * 8;
    cp_async16(dst + r * LD + c, src + size_t(r) * d + c);
  }
}

// Zero the padding columns [d, DP) of the five tiles once; cp.async writes only columns < d.
template <int DP>
__device__ inline void zero_padding_bf16(bf16* tiles, int d) {
  constexpr int LD = DP + 8;
  if (d < DP) {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < 5 * BQ * (DP - d); i += THREADS) {
      const int r = i / (DP - d), c = d + i % (DP - d);
      tiles[r * LD + c] = zero;
    }
  }
}

// Load the block's Q tile (64 rows at q_rows) and this warp's A fragments of it.
template <int DP>
__device__ inline void load_q_bf16(unsigned (&qf)[DP / 16][4], bf16* Qs, const bf16* q_rows,
                                   int d) {
  constexpr int LD = DP + 8;
  load_tile_bf16<LD>(Qs, q_rows, d);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    ldmatrix_x4(qf[kc], Qs + (warp * 16 + lane % 16) * LD + kc * 16 + (lane / 16) * 8);
}

// One online-softmax pass of the warp's 16 q rows over all s_len keys of one head (k, v point
// at the head's (s_len, d) rows). Ks and Vs hold two tiles each. On return acc holds the
// unnormalised P V and l_run this thread's share of the two row sums (rows g and g + 8;
// reduce over the lane quad before use). Fragment conventions (PTX ISA, mma.m16n8k16):
// lane = 4 * g + t; an accumulator tile holds rows g and g + 8, columns 2t and 2t + 1.
template <int DP>
__device__ inline void attend_bf16(const unsigned (&qf)[DP / 16][4], const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, int s_len, int d,
                                   float scale_log2, bf16* Ks, bf16* Vs,
                                   float (&acc)[DP / 8][4], float (&l_run)[2]) {
  constexpr int LD = DP + 8;  // 16-byte row pad: conflict-free ldmatrix
  constexpr int TILE = BQ * LD;
  constexpr int KC = DP / 16;  // k16 steps of Q K^T
  constexpr int NT = DP / 8;   // n8 tiles of O
  constexpr int ST = BKV / 8;  // n8 tiles of S
  static_assert(BQ == BKV, "Q and K/V tiles share one layout");
  const int lane = threadIdx.x % 32;
  const int n_tiles = s_len / BKV;

#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8, over unscaled logits
  l_run[0] = l_run[1] = 0.0f;

  load_tile_bf16<LD>(Ks, k, d);
  load_tile_bf16<LD>(Vs, v, d);
  cp_async_commit();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile_bf16<LD>(Ks + (buf ^ 1) * TILE, k + size_t(tile + 1) * BKV * d, d);
      load_tile_bf16<LD>(Vs + (buf ^ 1) * TILE, v + size_t(tile + 1) * BKV * d, d);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // this tile has landed
    __syncthreads();
    const bf16* Kt = Ks + buf * TILE;
    const bf16* Vt = Vs + buf * TILE;

    // S = Q K^T: K stored (key, d) row-major is the col-major B operand
    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        unsigned b[4];
        ldmatrix_x4(b, Kt + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kc * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kc], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    }

    // online softmax on rows g (i = 0) and g + 8 (i = 1); a row lives in one lane quad
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < ST; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      corr[i] = exp2f((m_run[i] - m_new) * scale_log2);  // 0 on the first tile
      m_run[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < ST; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2f((s[n][2 * i + j] - m_new) * scale_log2);
          s[n][2 * i + j] = p;
          sum += p;  // the row sum is taken before the cast, as the TPU kernel does
        }
      }
      l_run[i] = l_run[i] * corr[i] + sum;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the S accumulators of keys 16kc..16kc+15 are the A fragment, cast to bf16;
    // V stored (key, d) row-major is loaded transposed as the col-major B operand
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, Vt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + np * 16 +
                                 (lane / 16) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

// The full row sums of rows g (i = 0) and g + 8 (i = 1) from each lane's share.
__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// ---------------------------------------------------------------------------
// float32 tile loop (plain FMAs, score tile and accumulator in shared memory)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout of the float32 loop, computed identically on the host (launch size)
// and the device: Q, K, V and score tiles, then ``n_out`` accumulators with their running
// max and sum. Odd leading dims keep the scalar loops free of bank conflicts.
struct LayoutF32 {
  int ld_qkv, ld_s, ld_o;
  size_t q, k, v, s, o[2], m[2], l[2];  // byte offsets
  size_t total;
};

__host__ __device__ inline LayoutF32 make_layout_f32(int d, int n_out) {
  LayoutF32 L;
  L.ld_qkv = d + 1;
  L.ld_s = BKV + 1;
  L.ld_o = d + 1;
  size_t off = 0;
  L.q = off; off = align128(off + size_t(BQ) * L.ld_qkv * sizeof(float));
  L.k = off; off = align128(off + size_t(BKV) * L.ld_qkv * sizeof(float));
  L.v = off; off = align128(off + size_t(BKV) * L.ld_qkv * sizeof(float));
  L.s = off; off = align128(off + size_t(BQ) * L.ld_s * sizeof(float));
  for (int i = 0; i < 2; ++i) {
    L.o[i] = L.m[i] = L.l[i] = 0;
    if (i >= n_out) continue;
    L.o[i] = off; off = align128(off + size_t(BQ) * L.ld_o * sizeof(float));
    L.m[i] = off; off = align128(off + BQ * sizeof(float));
    L.l[i] = off; off = align128(off + BQ * sizeof(float));
  }
  L.total = off;
  return L;
}

// Rows [0, 64) x columns [0, d) of a row-major (rows, d) matrix, in 16-byte vectors.
__device__ inline void load_tile_f32(float* dst, int ld, const float* __restrict__ src, int d) {
  const int vpr = d / 4;
  for (int i = threadIdx.x; i < 64 * vpr; i += THREADS) {
    const int r = i / vpr, c = (i % vpr) * 4;
    const float4 val = *reinterpret_cast<const float4*>(src + size_t(r) * d + c);
    dst[r * ld + c] = val.x;
    dst[r * ld + c + 1] = val.y;
    dst[r * ld + c + 2] = val.z;
    dst[r * ld + c + 3] = val.w;
  }
}

// One online-softmax pass of the block's 64 q rows (already in Qs) over all s_len keys of one
// head, into the accumulator Os with running max Ms and sum Ls (all in shared memory). The
// caller applies 1 / Ls after a __syncthreads(). `bf16_probs` (K1's fast mode) rounds the
// probabilities as prob_bf16 does; the row sum adds the rounded values, the rescaling stays f32.
__device__ inline void attend_f32(const LayoutF32& L, unsigned char* smem, int out,
                                  const float* __restrict__ k, const float* __restrict__ v,
                                  int s_len, int d, float scale, bool bf16_probs = false,
                                  float scale_bf16 = 0.0f) {
  const float* Qs = reinterpret_cast<const float*>(smem + L.q);
  float* Ks = reinterpret_cast<float*>(smem + L.k);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);  // scores, then probabilities
  float* Os = reinterpret_cast<float*>(smem + L.o[out]);
  float* Ms = reinterpret_cast<float*>(smem + L.m[out]);
  float* Ls = reinterpret_cast<float*>(smem + L.l[out]);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  for (int i = threadIdx.x; i < BQ * L.ld_o; i += THREADS) Os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    Ms[i] = -INFINITY;
    Ls[i] = 0.0f;
  }

  for (int kv0 = 0; kv0 < s_len; kv0 += BKV) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_f32(Ks, L.ld_qkv, k + size_t(kv0) * d, d);
    load_tile_f32(Vs, L.ld_qkv, v + size_t(kv0) * d, d);
    __syncthreads();

    // S[16 warp rows, 64 keys] = Q K^T (unscaled)
    for (int r = 0; r < 16; ++r) {
      const float* qr = Qs + (r0 + r) * L.ld_qkv;
      for (int j = lane; j < BKV; j += 32) {
        const float* kr = Ks + j * L.ld_qkv;
        float acc = 0.0f;
        for (int c = 0; c < d; ++c) acc = fmaf(qr[c], kr[c], acc);
        Ss[(r0 + r) * L.ld_s + j] = acc;
      }
    }
    __syncwarp();

    // online softmax: two lanes per row, 32 keys each
    {
      const int r = r0 + lane / 2, half = lane % 2;
      float* srow = Ss + r * L.ld_s + half * (BKV / 2);
      float mt = -INFINITY;
      for (int c = 0; c < BKV / 2; ++c) mt = fmaxf(mt, srow[c]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mt);
      const float corr = expf((m_old - m_new) * scale);  // 0 on the first tile
      float sum = 0.0f;
      for (int c = 0; c < BKV / 2; ++c) {
        const float p = bf16_probs ? prob_bf16(srow[c], m_new, scale_bf16)
                                   : expf((srow[c] - m_new) * scale);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      float* orow = Os + r * L.ld_o;
      for (int c = half; c < d; c += 2) orow[c] *= corr;
      __syncwarp();  // both lanes of the pair have read Ms[r] / Ls[r]
      if (half == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + sum;
      }
    }
    __syncwarp();

    // O[16 warp rows, d] += P V
    for (int c = lane; c < d; c += 32) {
      for (int r = 0; r < 16; ++r) {
        const float* prow = Ss + (r0 + r) * L.ld_s;
        float acc = Os[(r0 + r) * L.ld_o + c];
        for (int j = 0; j < BKV; ++j) acc = fmaf(prow[j], Vs[j * L.ld_qkv + c], acc);
        Os[(r0 + r) * L.ld_o + c] = acc;
      }
    }
  }
}

}  // namespace attn
