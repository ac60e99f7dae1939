// K1's backward, its first design, kept as the yardstick of csrc/fused_attention_bwd.cu: built
// only by chip_smoke.py (build.BASELINES), which times it beside the shipped design and holds it
// to the plain version. The gradients dq, dk, dv of softmax(Q K^T / sqrt(D)) V over
// (B*H, S, D), given the output's gradient g.
//
// Replaces the gradient rule of the TPU kernel's custom VJP, `_fused_bwd`
// (diffsim_tpu/ops/pallas/attention.py:132-151), which the DiT trainer differentiates through at
// every block. That rule, and this kernel, recompute the f32 logits and softmax and form
//   dv = W^T g,  dp = g V^T,  dS = (dp - rowsum(dp * W)) * W,  dq = dS K * scale,
//   dk = dS^T Q * scale,
// each gradient cast to its input's dtype. Numerics contract, kept from it and from the forward
// (fused_attention.cu): logits and softmax statistics in f32; the row max m is taken over the
// UNSCALED logits and the scale folded into exp's operand, W = exp((s - m) * scale) / l; the
// softmax is exact whatever mode the forward took (the bf16_probs mode is forward-only, as in
// JAX); Delta = rowsum(dp * W) is an f32 sum of the products, not FlashAttention's rowsum(g * O).
//
// Two kernels, launched back to back on the caller's stream; no atomics, so the gradients are the
// same bit for bit from run to run:
//   * A, row-parallel (bwd_rows): a block owns 64 query rows of one head, 4 warps of 16 rows,
//     with Q and g resident in shared memory. Sweep 1 over 64-key tiles takes the running max m
//     and sum l (the forward's online softmax); sweep 2 forms W and dp = g V^T and sums Delta;
//     sweep 3 forms dS = W (dp - Delta) and accumulates dQ = dS K, then writes dq = dQ scale.
//     It writes m, l and Delta (float32, B*H*S each) to a scratch the wrapper allocates.
//   * B, column-parallel (bwd_cols): a block owns 64 key rows of one head, K and V resident, and
//     walks the query tiles, recomputing W^T from the saved m and l (S^T = K Q^T, dp^T = V g^T),
//     accumulating dV += W^T g and dK += dS^T Q, then writing dv and dk = dK scale.
// K and V (in A) and Q, g and the statistics (in B) stream through shared memory in 64-row tiles,
// double-buffered by cp.async where two stages leave room for a second block on the SM, so no S
// that the forward admits is refused for want of shared memory. Past 80 columns a block computes
// half of D's output columns (grid z = 2), each half recomputing the scores, so that the
// accumulators stay in registers.
//
// The products, mma.sync.m16n8k8 on the tensor cores in both dtypes, with the k order permuted so
// that a score tile's C fragment is the A fragment of the next product (attention_tf32.cuh):
//   * float32: 3xTF32, every operand split by split_tf32 (attention_common.cuh) into hi and lo,
//     each product a_lo b_hi + a_hi b_lo + a_hi b_hi, as K1's float32 forward does;
//   * bf16: mma.sync.m16n8k16 with f32 accumulation. Q K^T and g V^T (two exact bf16 operands)
//     are one bf16 product each. W^T g, dS K and dS^T Q have one float32 operand, W or dS, which
//     is split into bf16 hi + lo (split_bf16x2): two bf16 products, keeping about 16 bits of W or
//     dS where one bf16 rounding (FlashAttention's) keeps 8.
// Each tile's contribution to dQ, dV and dK is a fresh tensor-core sum (the tensor cores
// truncate their f32 sums), added to the accumulator with rounded f32 adds.
//
// Bound at the DiT training site (32, 16, 256, 72), 28 calls a step: the five products are
// 10 B H S^2 D = 24.16 GFLOP, 0.0244 ms on the bf16 tensor cores (989 TFLOP/s), and in float32
// three TF32 passes at 495 TFLOP/s, 0.1464 ms (4.10 ms a step); q, k, v, g read and dq, dk, dv
// written once are 7 B H S D elements, 132.1 MB in bf16 (0.0394 ms at 3.35 TB/s, which is the
// bf16 bound: 1.104 ms a step) and 264.2 MB in float32 (0.0789 ms); the S^2 B H = 33.6 M
// exponentials 0.0086 ms. This design does more than that: ten products of 2 S^2 D where the
// rule has five (A recomputes Q K^T in each of its three sweeps and g V^T in two, B both once);
// in float32 three TF32 passes each (2x the bound's products); in bf16 13 bf16 products (seven
// single, three split in two) against five (2.6x); four exponentials a score instead of one; and
// D = 72 is computed at 80 columns (the instantiations are every 16 columns).
//
// C interface (loaded with ctypes): the entry point returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

using namespace attn;

// Two adjacent gradient values stored in the gradient's dtype.
__device__ __forceinline__ void st_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

constexpr size_t SMEM_BLOCK = 232448;       // shared memory a block may use
constexpr size_t SMEM_TWO_BLOCKS = 115712;  // each of two blocks on one SM (228 KB, 1 KB each)
constexpr size_t STATS_BYTES = 3 * BQ * sizeof(float);  // m, l, Delta of one 64-row query tile

// Shared memory of a block: two resident tiles and `stages` stages of two streamed tiles and the
// statistics of a query tile.
constexpr size_t smem_bytes(size_t tile, int stages) {
  return (2 + 2 * stages) * tile + stages * STATS_BYTES;
}

// The tiling of both kernels at head dim DP (a multiple of 16, zero columns past the true d).
template <int DP, class T>
struct Cfg {
  static constexpr int LD = DP + 16 / int(sizeof(T));  // 16-byte row pad, rows 16-byte aligned
  static constexpr size_t TILE = align128(size_t(BQ) * LD * sizeof(T));
  // two stages where they leave room for two blocks on an SM, else one
  static constexpr int STAGES = smem_bytes(TILE, 2) <= SMEM_TWO_BLOCKS ? 2 : 1;
  static constexpr size_t SMEM = smem_bytes(TILE, STAGES);
  static constexpr int DC = DP <= 80 ? DP : DP / 2;  // output columns a block
  static constexpr int NT = DC / 8;                   // their n8 tiles
  static constexpr bool F32 = sizeof(T) == 4;
  static_assert(SMEM <= SMEM_BLOCK, "tiles exceed the shared memory of a block");
};

// cp.async of rows [0, 64) x columns [0, d) of a row-major (rows, d) matrix into a tile of
// leading dim LD, 16 bytes a copy (d % 8 == 0).
template <class T, int LD>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src, int d) {
  constexpr int E = 16 / int(sizeof(T));
  const int cpr = d / E;
  for (int i = threadIdx.x; i < BQ * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * E;
    cp_async16(dst + r * LD + c, src + size_t(r) * d + c);
  }
}

// Zero columns [d, DP) of n consecutive tiles once: cp.async writes only columns < d, so the
// padding stays zero and adds nothing to a product over D.
template <int DP, class T>
__device__ __forceinline__ void zero_pads(unsigned char* tiles, int n, int d) {
  using C = Cfg<DP, T>;
  const int w = DP - d;
  if (w == 0) return;
  for (int i = threadIdx.x; i < n * BQ * w; i += THREADS) {
    const int tile = i / (BQ * w), r = i / w % BQ, c = d + i % w;
    T* at = reinterpret_cast<T*>(tiles + tile * C::TILE) + r * C::LD + c;
    if constexpr (C::F32) {
      *reinterpret_cast<float*>(at) = 0.0f;
    } else {
      *reinterpret_cast<uint16_t*>(at) = 0;
    }
  }
}

// s = rows row0 + [0, 16) of At times rows [0, 64) of Bt, transposed, over DP columns, in a fresh
// sum: s[n] is the 16 x 8 C fragment of Bt's rows 8n .. 8n + 7 (rows g, g + 8 of the warp; columns
// 2t, 2t + 1). At's rows are the A operand and Bt's the col-major B operand. float32: 3xTF32
// m16n8k8 steps, both read as pairs of columns 2t, 2t + 1 under the permuted k order. bf16: one
// bf16 m16n8k16 product a step, both read as bf16 pairs at columns 2t and 2t + 8 (the PTX ISA's
// fragments, no permutation), with f32 accumulation.
template <int DP, class T>
__device__ __forceinline__ void rows_times_rows(float (&s)[8][4], const T* At, int row0,
                                                const T* Bt, int g, int t) {
  using C = Cfg<DP, T>;
  constexpr int LD = C::LD;
  if constexpr (C::F32) {
#pragma unroll 2
    for (int ks = 0; ks < DP / 8; ++ks) {
      uint32_t ah[4], al[4];
      load_a_3xtf32(ah, al, At, LD, row0, 8 * ks, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 bp = *reinterpret_cast<const float2*>(Bt + (8 * n + g) * LD + 8 * ks + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bp.x, bh0, bl0);
        split_tf32(bp.y, bh1, bl1);
        if (ks == 0) {  // the small products first into each sum
          mma_tf32_first(s[n], al, bh0, bh1);
        } else {
          mma_tf32(s[n], al, bh0, bh1);
        }
        mma_tf32(s[n], ah, bl0, bl1);
        mma_tf32(s[n], ah, bh0, bh1);
      }
    }
  } else {
    auto pair = [](const T* p) { return *reinterpret_cast<const uint32_t*>(p); };
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll 2
    for (int ks = 0; ks < DP / 16; ++ks) {
      const T* pa = At + (row0 + g) * LD + 16 * ks + 2 * t;
      const unsigned a[4] = {pair(pa), pair(pa + 8 * LD), pair(pa + 8), pair(pa + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const T* pb = Bt + (8 * n + g) * LD + 16 * ks + 2 * t;
        mma_bf16(s[n], a, pair(pb), pair(pb + 8));
      }
    }
  }
}

// x0, x1 = hi + lo in bf16 pairs: hi rounded to nearest, lo the rest rounded to nearest (about
// 16 bits of each value kept, the error at most 2^-17 of it).
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
}

// acc += P Bt: P the warp's 16 x 64 tile in C fragments (p[j] keys or queries 8 j .. 8 j + 7, an
// f32 operand), Bt's 64 rows x NT n8 tiles of columns (from Bt's first column), in one fresh
// tensor-core sum added to acc. float32: 3xTF32 m16n8k8 steps, P and Bt split into TF32 hi + lo,
// P's C fragments read as A fragments under the permuted k order. bf16: P split into bf16 hi +
// lo, two m16n8k16 products a step with Bt's bf16 values as they are; the A fragment of step kk
// is the C fragments of n8 tiles 2 kk and 2 kk + 1, and Bt's B fragment its rows 2t, 2t + 1 and
// 2t + 8, 2t + 9 at column g.
template <int DP, class T>
__device__ __forceinline__ void accumulate(float (&acc)[Cfg<DP, T>::NT][4], const float (&p)[8][4],
                                           const T* Bt, int g, int t) {
  using C = Cfg<DP, T>;
  constexpr int LD = C::LD, NT = C::NT;
  float part[NT][4];
  if constexpr (C::F32) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // A fragment (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) = C elements 0, 2, 1, 3
      uint32_t ph[4], pl[4];
      split_tf32(p[kk][0], ph[0], pl[0]);
      split_tf32(p[kk][2], ph[1], pl[1]);
      split_tf32(p[kk][1], ph[2], pl[2]);
      split_tf32(p[kk][3], ph[3], pl[3]);
      const T* b0 = Bt + (8 * kk + 2 * t) * LD + g;  // B rows 2t, 2t + 1 of the step, column g
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b0[8 * n], bh0, bl0);
        split_tf32(b0[8 * n + LD], bh1, bl1);
        if (kk == 0) {  // the small products first
          mma_tf32_first(part[n], pl, bh0, bh1);
        } else {
          mma_tf32(part[n], pl, bh0, bh1);
        }
        mma_tf32(part[n], ph, bl0, bl1);
        mma_tf32(part[n], ph, bh0, bh1);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
      const uint16_t* b0 = reinterpret_cast<const uint16_t*>(Bt + (16 * kk + 2 * t) * LD + g);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t lo_rows = b0[8 * n] | uint32_t(b0[8 * n + LD]) << 16;
        const uint32_t hi_rows = b0[8 * n + 8 * LD] | uint32_t(b0[8 * n + 9 * LD]) << 16;
        mma_bf16(part[n], pl, lo_rows, hi_rows);  // the small product first
        mma_bf16(part[n], ph, lo_rows, hi_rows);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// The warp's accumulator rows row0 + g, + 8 times `mul`, stored at columns c0 + 8 n + 2 t of a
// (rows, d) matrix; columns past d (the kernel's padding) are not stored.
template <int DP, class T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[Cfg<DP, T>::NT][4],
                                           int row0, int c0, int d, float mul, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T* row = out + size_t(row0 + g + 8 * i) * d;
#pragma unroll
    for (int n = 0; n < Cfg<DP, T>::NT; ++n) {
      const int col = c0 + 8 * n;
      if (col < d) st_pair(row + col + 2 * t, acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// A: 64 query rows a block; dq, and m, l, Delta for B
// ---------------------------------------------------------------------------

template <int DP, class T>
__global__ void __launch_bounds__(THREADS)
bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ gr, T* __restrict__ dq, float* __restrict__ stats, int s_len,
         int d, int bh, float scale, float scale_log2) {
  using C = Cfg<DP, T>;
  constexpr int LD = C::LD, NT = C::NT, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = reinterpret_cast<T*>(smem + C::TILE);
  auto k_tile = [&](int b) { return reinterpret_cast<T*>(smem + (2 + 2 * b) * C::TILE); };
  auto v_tile = [&](int b) { return reinterpret_cast<T*>(smem + (3 + 2 * b) * C::TILE); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  const int head = blockIdx.y, q0 = blockIdx.x * BQ, c0 = blockIdx.z * C::DC;
  const size_t base = size_t(head) * s_len * d;
  const int n_tiles = s_len / BKV, total = 3 * n_tiles;

  zero_pads<DP, T>(smem, 2 + 2 * STAGES, d);
  copy_rows<T, LD>(Qs, q + base + size_t(q0) * d, d);
  copy_rows<T, LD>(Gs, gr + base + size_t(q0) * d, d);
  // step it of the three sweeps: K tile it % n_tiles, and its V tile past the first sweep
  auto issue = [&](int it) {
    const int b = it % STAGES;
    const size_t at = base + size_t(it % n_tiles) * BKV * d;
    copy_rows<T, LD>(k_tile(b), k + at, d);
    if (it >= n_tiles) copy_rows<T, LD>(v_tile(b), v + at, d);
    cp_async_commit();
  };
  issue(0);

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};  // rows g, g + 8
  float inv_l[2] = {0.0f, 0.0f}, delta[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < total; ++it) {
    const int sweep = it / n_tiles, b = it % STAGES;
    if constexpr (STAGES == 2) {
      if (it + 1 < total) {
        issue(it + 1);
      } else {
        cp_async_commit();
      }
      cp_async_wait_all_but_one();  // this step's tiles have landed
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    float s[8][4];  // the unscaled logits of rows g, g + 8 against the tile's 64 keys
    rows_times_rows<DP, T>(s, Qs, r0, k_tile(b), g, t);
    if (sweep == 0) {  // the running max and sum, as the forward's online softmax
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        const float corr = exp2f((m_run[i] - m_new) * scale_log2);  // 0 on the first tile
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          sum += exp2f((s[n][2 * i] - m_new) * scale_log2) +
                 exp2f((s[n][2 * i + 1] - m_new) * scale_log2);
        m_run[i] = m_new;
        l_run[i] = l_run[i] * corr + sum;
      }
      if (it == n_tiles - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l_run[i] = quad_sum(l_run[i]);
          inv_l[i] = 1.0f / l_run[i];
        }
      }
    } else {
      // W = exp((s - m) scale) / l in place of s, and dp = g V^T
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = exp2f((s[n][e] - m_run[e / 2]) * scale_log2) * inv_l[e / 2];
      float dp[8][4];
      rows_times_rows<DP, T>(dp, Gs, r0, v_tile(b), g, t);
      if (sweep == 1) {  // Delta = rowsum(dp * W)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) delta[e / 2] = fmaf(dp[n][e], s[n][e], delta[e / 2]);
        if (it == 2 * n_tiles - 1) {
          delta[0] = quad_sum(delta[0]);
          delta[1] = quad_sum(delta[1]);
        }
      } else {  // dS = W (dp - Delta) in place of dp; dQ += dS K
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - delta[e / 2]);
        accumulate<DP, T>(acc, dp, k_tile(b) + c0, g, t);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    if constexpr (STAGES == 1) {
      if (it + 1 < total) issue(it + 1);
    }
  }

  if (blockIdx.z == 0 && t == 0) {  // each row's statistics, once (every z computes the same)
    const size_t n_rows = size_t(bh) * s_len;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t row = size_t(head) * s_len + q0 + r0 + g + 8 * i;
      stats[row] = m_run[i];
      stats[n_rows + row] = l_run[i];
      stats[2 * n_rows + row] = delta[i];
    }
  }
  store_rows<DP, T>(dq + base + size_t(q0) * d, acc, r0, c0, d, scale, g, t);
}

// ---------------------------------------------------------------------------
// B: 64 key rows a block; dk and dv
// ---------------------------------------------------------------------------

template <int DP, class T>
__global__ void __launch_bounds__(THREADS)
bwd_cols(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ gr, T* __restrict__ dk, T* __restrict__ dv,
         const float* __restrict__ stats, int s_len, int d, int bh, float scale,
         float scale_log2) {
  using C = Cfg<DP, T>;
  constexpr int LD = C::LD, NT = C::NT, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + C::TILE);
  auto q_tile = [&](int b) { return reinterpret_cast<T*>(smem + (2 + 2 * b) * C::TILE); };
  auto g_tile = [&](int b) { return reinterpret_cast<T*>(smem + (3 + 2 * b) * C::TILE); };
  auto st_tile = [&](int b) {  // m, l, Delta of the stage's 64 queries
    return reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * C::TILE + b * STATS_BYTES);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  const int head = blockIdx.y, k0 = blockIdx.x * BKV, c0 = blockIdx.z * C::DC;
  const size_t base = size_t(head) * s_len * d;
  const size_t n_rows = size_t(bh) * s_len;
  const int n_tiles = s_len / BQ;

  zero_pads<DP, T>(smem, 2 + 2 * STAGES, d);
  copy_rows<T, LD>(Ks, k + base + size_t(k0) * d, d);
  copy_rows<T, LD>(Vs, v + base + size_t(k0) * d, d);
  auto issue = [&](int i) {
    const int b = i % STAGES;
    copy_rows<T, LD>(q_tile(b), q + base + size_t(i) * BQ * d, d);
    copy_rows<T, LD>(g_tile(b), gr + base + size_t(i) * BQ * d, d);
    if (threadIdx.x < 3 * BQ / 4) {  // 16 bytes a thread: 16 each of m, l and Delta
      const int which = threadIdx.x / (BQ / 4), c = 4 * (threadIdx.x % (BQ / 4));
      cp_async16(st_tile(b) + which * BQ + c,
                 stats + which * n_rows + size_t(head) * s_len + size_t(i) * BQ + c);
    }
    cp_async_commit();
  };
  issue(0);

  float dv_acc[NT][4], dk_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[n][e] = dk_acc[n][e] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const int b = i % STAGES;
    if constexpr (STAGES == 2) {
      if (i + 1 < n_tiles) {
        issue(i + 1);
      } else {
        cp_async_commit();
      }
      cp_async_wait_all_but_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* st = st_tile(b);

    // W^T = exp((s^T - m) scale) / l: rows are the warp's keys, columns the tile's queries
    float w[8][4];
    rows_times_rows<DP, T>(w, Ks, r0, q_tile(b), g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + e % 2;
        w[n][e] = exp2f((w[n][e] - st[col]) * scale_log2) * (1.0f / st[BQ + col]);
      }
    // dS^T = W^T (dp^T - Delta), dp^T = V g^T
    float ds[8][4];
    rows_times_rows<DP, T>(ds, Vs, r0, g_tile(b), g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = w[n][e] * (ds[n][e] - st[2 * BQ + 8 * n + 2 * t + e % 2]);
    accumulate<DP, T>(dv_acc, w, g_tile(b) + c0, g, t);
    accumulate<DP, T>(dk_acc, ds, q_tile(b) + c0, g, t);
    __syncthreads();
    if constexpr (STAGES == 1) {
      if (i + 1 < n_tiles) issue(i + 1);
    }
  }
  store_rows<DP, T>(dv + base + size_t(k0) * d, dv_acc, r0, c0, d, 1.0f, g, t);
  store_rows<DP, T>(dk + base + size_t(k0) * d, dk_acc, r0, c0, d, scale, g, t);
}

template <int DP, class T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                   void* dv, float* stats, int bh, int s, int d, float scale, cudaStream_t st) {
  using C = Cfg<DP, T>;
  cudaError_t err = cudaFuncSetAttribute(bwd_rows<DP, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_cols<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(s / BQ, bh, DP / C::DC);
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* gt = static_cast<const T*>(g);
  bwd_rows<DP, T><<<grid, THREADS, C::SMEM, st>>>(qt, kt, vt, gt, static_cast<T*>(dq), stats, s,
                                                  d, bh, scale, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_cols<DP, T><<<grid, THREADS, C::SMEM, st>>>(qt, kt, vt, gt, static_cast<T*>(dk),
                                                  static_cast<T*>(dv), stats, s, d, bh, scale,
                                                  scale * LOG2E);
  return cudaGetLastError();
}

// launch at DP = d rounded up to 16 (d % 8 == 0, d <= 160): one instantiation every 16 columns
template <class T, int DP = 16>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* g, void* dq,
                     void* dk, void* dv, float* stats, int bh, int s, int d, float scale,
                     cudaStream_t st) {
  if constexpr (DP > 160) {
    return cudaErrorInvalidValue;
  } else {
    return d <= DP ? launch<DP, T>(q, k, v, g, dq, dk, dv, stats, bh, s, d, scale, st)
                   : dispatch<T, DP + 16>(q, k, v, g, dq, dk, dv, stats, bh, s, d, scale, st);
  }
}

}  // namespace

extern "C" {

// q, k, v, g (the output's gradient), dq, dk, dv: contiguous (bh, s, d) of one dtype, 0 = float32,
// 1 = bfloat16; stats: float32 scratch of 3 * bh * s (m, l, Delta), written by the first kernel
// and read by the second; scale: the softmax scale (the caller's unpadded width's).
// Requires s % 64 == 0, d % 8 == 0, 0 < d <= 160, 0 < bh <= 65535.
int fused_attention_bwd_v1(const void* q, const void* k, const void* v, const void* g, void* dq,
                        void* dk, void* dv, void* stats, int bh, int s, int d, float scale,
                        int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % BQ != 0 || d <= 0 || d > 160 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(q, k, v, g, dq, dk, dv, sp, bh, s, d, scale, st));
  if (dtype == 1)
    return static_cast<int>(dispatch<bf16>(q, k, v, g, dq, dk, dv, sp, bh, s, d, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
