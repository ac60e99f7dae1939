// K1's backward: the gradients dq, dk, dv of softmax(Q K^T / sqrt(D)) V over (B*H, S, D), given
// the output's gradient g.
//
// Replaces the gradient rule of the TPU kernel's custom VJP, `_fused_bwd`
// (diffsim_tpu/ops/pallas/attention.py:132-151), which the DiT trainer differentiates through at
// every block. That rule recomputes the f32 logits and softmax and forms
//   dv = W^T g,  dp = g V^T,  dS = (dp - rowsum(dp * W)) * W,  dq = dS K * scale,
//   dk = dS^T Q * scale,
// each gradient cast to its input's dtype. Numerics contract, kept from it and from the forward
// (fused_attention.cu): logits and softmax statistics in f32; the row max m is taken over the
// UNSCALED logits and the scale folded into exp's operand; the softmax is exact whatever mode the
// forward took (the bf16_probs mode is forward-only, as in JAX).
//
// Two kernels and seven products of 2 S^2 D where the rule has five, launched back to back on the
// caller's stream (FlashAttention-2/3's backward):
//   1. a statistics pass, row-parallel: one online-softmax sweep of the forward's (Q K^T, P V),
//      whose epilogue writes for each query row its base-2 log-sum-exp L = m scale log2 e +
//      log2 l and Delta = g . O32, O32 the unrounded P V accumulator over l. By
//      sum_k W_k (g . v_k) = g . sum_k W_k v_k that Delta is the rule's rowsum(dp * W), without an
//      (S, S) tile of dp: two products;
//   2. a key-parallel kernel: a block owns one head's keys, a key block at a time, K and V
//      resident, and walks the query tiles with their L and Delta: S^T = K Q^T, dp^T = V g^T,
//      W^T = exp2(S^T scale log2 e - L) (one exponential a score), dS^T = W^T (dp^T - Delta),
//      dV += W^T g, dK += dS^T Q, and dQ's share dS K of the key block: five products. A block
//      owns all the key blocks of its head and takes them in order, so dQ's sum over the key
//      blocks runs in a fixed order through a float32 accumulator of (B*H, S, D) that only this
//      block reads and writes (each element by the same thread): no atomics, the gradients the
//      same bit for bit from run to run. The last key block writes dq = scale * the sum.
// Past 80 columns a block computes half of D's output columns (grid y = 2), each half
// recomputing the scores, so that the dK and dV accumulators stay in registers.
//
// bf16 (the main path), for sm_90a:
//   * the statistics pass is K1's forward pipeline (attention_wgmma.cuh: a persistent block,
//     TMA, ping-ponged consumer warpgroups of 64 q rows, Q K^T and P V on wgmma, P rounded to
//     bf16 for P V as in the forward) with two consumers where the forward has three, so that a
//     128-row q block divides the training site's 256 tokens, and its epilogue reading g;
//   * the key kernel is FlashAttention-3's backward shape: two consumer warpgroups of 64 keys (128
//     keys a key block) and a producer warp that streams the query tiles (64 rows of Q and g, by
//     TMA, and their L and Delta by bulk copies) through a 2-4 stage mbarrier ring while the key
//     block's K and V stay resident; setmaxnreg gives the producer's registers to the consumers.
//     S^T and dp^T are wgmma with both operands in shared memory, committed apart so that the
//     exponentials of W^T run while dp^T is in flight; W^T and dS^T are rounded to bf16 once
//     (FlashAttention's rounding) and are the register A operands of dV += W^T g and dK += dS^T Q
//     (g and Q read transposed from their (row, d) layout). dS^T is also stored to shared memory
//     as dS (q-major, the 128-byte swizzle) by stmatrix, and after a barrier of the two consumers
//     one of them (by turns, a query tile each) takes dQ's share, dS K over the 128 keys, as one
//     wgmma with K read transposed, while cp.async brings the earlier key blocks' sum of the tile
//     into shared memory; the new sum is staged there and written by one TMA store, to the
//     accumulator or, at the last key block, to dq (scattered stores from registers cost a third
//     of the kernel's time).
// float32 (the DiT trainer's default step): the same two kernels with 3xTF32 mma.sync products
// (every operand split by split_tf32 into hi and lo, a_lo b_hi + a_hi b_lo + a_hi b_hi): the
// statistics pass is K1's float32 forward pass (attention_tf32.cuh, four warps of 16 q rows); the
// key kernel four warps of 16 keys (64 keys a key block), two blocks an SM, K, V, Q and g through
// cp.async, the tiles' C fragments reused as the A fragments of the next product, each product
// issued right after the values it needs (so that few tiles are live at once), dS staged in
// shared memory for dS K, the earlier key blocks' dQ sum loaded before that product. Every
// product is a fresh tensor-core sum a tile (they truncate their sums), past 6 n8 tiles one a
// column half, added with rounded f32 adds.
//
// Bound at the DiT training site (32, 16, 256, 72), 28 calls a step: the rule's five products
// are 10 B H S^2 D = 24.16 GFLOP, 0.0244 ms on the bf16 tensor cores (989 TFLOP/s), and in
// float32 three TF32 passes at 495 TFLOP/s, 0.1464 ms (4.10 ms a step); q, k, v, g read and dq,
// dk, dv written once are 7 B H S D elements, 132.1 MB in bf16 (0.0394 ms at 3.35 TB/s, the bf16
// bound: 1.104 ms a step) and 264.2 MB in float32 (0.0789 ms); the B H S^2 = 33.6 M exponentials
// 0.0086 ms. This design does seven products (two in the statistics pass, five in the key
// kernel), one bf16 product each in bf16 and three TF32 passes each in float32 (21 where the
// first design, fused_attention_bwd_v1.cu, does 30, and 7 bf16 products where it does 13), and
// two exponentials a score (the first design four). It adds the float32 dQ accumulator's traffic
// (written and read once for each key block past the first, 37.7 MB at the training site, most of
// it in L2) and D = 72 computed at 80 columns.
//
// C interface (loaded with ctypes): the entry point returns cudaGetLastError().

#include "attention_tf32.cuh"

namespace {

using namespace attn;

// Two adjacent gradient values stored in the gradient's dtype.
__device__ __forceinline__ void st_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dQ's element pair (a, b) of key block kb: added to `prev`, the earlier key blocks' sum (past
// the first), the sum stored to `acc` (the float32 accumulator) or, at the last key block, scaled
// into dq. The key blocks' sum runs in their order.
__device__ __forceinline__ void dq_sum(float2 prev, float* acc, float* dq, float a, float b,
                                       int kb, int n_kb, float scale) {
  if (kb > 0) {
    a = prev.x + a;
    b = prev.y + b;
  }
  if (kb + 1 < n_kb) {
    *reinterpret_cast<float2*>(acc) = make_float2(a, b);
  } else {
    st_pair(dq, a * scale, b * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16, the statistics pass: K1's forward pipeline, its epilogue L and Delta
// ---------------------------------------------------------------------------

// two consumer warpgroups of 64 q rows (the forward has three): a 128-row q block divides the
// training site's 256 tokens, where 192 rows leave two thirds of every second block idle
constexpr int NWG = 2;
constexpr int BM = 64 * NWG;
constexpr int CONSUMER_WARPS = 4 * NWG;
constexpr int THREADS_WG = (NWG + 1) * 128;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65536

template <int DP>
using StatsCfg = Tiling<DP, NWG>;

// The forward's kernel (fused_attention.cu attention_wgmma) with 128-row q blocks, the exact
// softmax; each consumer row writes L and Delta = g . (acc / l) to stats[0, rows) and
// stats[rows, 2 rows).
template <int DP>
__global__ void __launch_bounds__(THREADS_WG, 1)
bwd_stats_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ gr,
                float* __restrict__ stats, int s_len, int d, int bh, int n_items,
                float scale_log2) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  Pipeline<StatsCfg<DP>> pipe(smem_raw);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int q_blocks = (s_len + BM - 1) / BM;
  const size_t n_rows = size_t(bh) * s_len;

  if (threadIdx.x == 0) pipe.init();
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int head = item / q_blocks, q0 = (item % q_blocks) * BM;
        pipe.load_q(&tm_q, it, q0, head);
        pipe.load_kv(&tm_k, &tm_v, head, s_len);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = warp / 4;
    const int g8 = lane / 4, t = lane % 4;
    float acc[DP / 2], l_run[2], m_run[2];
    open_turns<NWG>(c);
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int head = item / q_blocks, q0 = (item % q_blocks) * BM;
      const bool last_item = item + gridDim.x >= n_items;
      attend_pass<DP>(pipe, acc, l_run, m_run, pipe.wait_q(it, c), it, s_len, scale_log2, c,
                      last_item, true);
      const int r = q0 + 64 * c + 16 * (warp % 4) + g8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float l = quad_sum(l_run[i]);
        const float inv = 1.0f / l;
        const int row = r + 8 * i;  // rows past S (a partial last q block) are not stored
        const bf16* grow = gr + (size_t(head) * s_len + (row < s_len ? row : 0)) * d;
        float part = 0.0f;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          const int col = 8 * n + 2 * t;
          if (col < d) {
            const float2 gp =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(grow + col));
            part = fmaf(gp.x, acc[4 * n + 2 * i] * inv, part);
            part = fmaf(gp.y, acc[4 * n + 2 * i + 1] * inv, part);
          }
        }
        const float delta = quad_sum(part);
        if (t == 0 && row < s_len) {
          const size_t at = size_t(head) * s_len + row;
          stats[at] = m_run[i] * scale_log2 + log2f(l);
          stats[n_rows + at] = delta;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, the key kernel: wgmma + TMA, two consumer warpgroups of 64 keys, a producer warp
// ---------------------------------------------------------------------------

constexpr int KEYS = 128;         // keys of a key block (two consumer warpgroups)
constexpr int KEY_THREADS = 384;  // two consumer warpgroups and the producer's
constexpr int KEY_PRODUCER_REGS = 24, KEY_CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65536
constexpr uint32_t BAR_DS = 1;    // named barrier: both consumers' dS of a query tile stored
constexpr int DS_PANEL = 64 * 128;      // 64 q rows x 64 keys of dS, 128-byte rows
constexpr int DS_BYTES = 2 * DS_PANEL;  // one dS buffer: 64 q rows x 128 keys
constexpr int STAT_FLOATS = 2 * BQ;     // L and Delta of a query tile

// The tiling of the key kernel at padded head dim DP (16, 32, 48, 64, 80, 96, 128 or 160).
template <int DP>
struct KeyCfg {
  static constexpr int DC = DP <= 80 ? DP : DP / 2;  // output columns a block (grid y = DP / DC)
  // panel columns: 64 up to DP = 80 (the last panel partly unused); past that the widest of 64,
  // 32, 16 that divides DC, so that the second half's columns start on a panel
  static constexpr int W = DP <= 80 || DC % 64 == 0 ? 64 : DC % 32 == 0 ? 32 : 16;
  static constexpr int PANELS = (DP + W - 1) / W;
  static constexpr int SPAN = W * 2;
  static constexpr int KV_PANEL = KEYS * SPAN;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // a K (or V) block
  static constexpr int Q_PANEL = BQ * SPAN;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;    // a Q (or g) tile
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;
  static constexpr int DQ_BYTES = BQ * DC * 4;  // a tile of dQ's sum, staged for its TMA store
  static constexpr int FIXED = 1024 + 2 * KV_BYTES + 2 * DS_BYTES + DQ_BYTES + 256;
  static constexpr int STAGE_ALL = STAGE_BYTES + STAT_FLOATS * 4;
  static constexpr int FIT = (232448 - FIXED) / STAGE_ALL;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr size_t SMEM = FIXED + size_t(STAGES) * STAGE_ALL;
  static_assert(STAGES >= 2, "the query ring needs two stages");
  static_assert(DC % 16 == 0 && DC <= 80, "the dQ product's width");
};

// Descriptors (hopper_common.cuh make_desc) of k16 step kk: a K-major operand from panel0 of
// panels `panel_bytes` apart, and an MN-major one (read transposed) from tile0.
template <int W>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* panel0, int panel_bytes, int kk) {
  return hopper::make_desc(panel0 + (kk * 16 / W) * panel_bytes + (kk * 16 % W) * 2, 16, 16 * W,
                           2 * W);
}
template <int W>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile0, int panel_bytes, int kk) {
  return hopper::make_desc(tile0 + kk * 16 * 2 * W, panel_bytes, 16 * W, 2 * W);
}

// A block: head blockIdx.x, output columns [blockIdx.y DC, + DC); its key blocks in order.
// dq_acc: the float32 dQ accumulator (B*H, S, d).
template <int DP>
__global__ void __launch_bounds__(KEY_THREADS, 1)
bwd_keys_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
               const __grid_constant__ CUtensorMap tm_dq,
               const __grid_constant__ CUtensorMap tm_acc,
               const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
               const float* __restrict__ dq_acc, int s_len, int d, int bh, float scale,
               float scale_log2) {
  using namespace hopper;
  using C = KeyCfg<DP>;
  constexpr int DC = C::DC, W = C::W;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kt = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* vt = kt + C::KV_BYTES;
  unsigned char* ds = vt + C::KV_BYTES;       // [2][DS_BYTES]
  unsigned char* ring = ds + 2 * DS_BYTES;    // [STAGES]: a Q tile, then a g tile
  float* st = reinterpret_cast<float*>(ring + C::STAGES * C::STAGE_BYTES);  // [STAGES][L, Delta]
  float* dq_tile = st + C::STAGES * STAT_FLOATS;  // [BQ][DC]: dQ's sum of a tile, its TMA box
  uint64_t* full = reinterpret_cast<uint64_t*>(dq_tile + BQ * DC);
  uint64_t* empty = full + C::STAGES;
  uint64_t* kv_full = empty + C::STAGES;
  uint64_t* kv_empty = kv_full + 1;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int head = blockIdx.x, c0 = blockIdx.y * DC;
  const int n_kb = (s_len + KEYS - 1) / KEYS, n_q = s_len / BQ;
  const size_t n_rows = size_t(bh) * s_len;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // the consumer warps
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<KEY_PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_g);
      tma_prefetch_map(&tm_dq);
      tma_prefetch_map(&tm_acc);
      int gi = 0;
      for (int kb = 0; kb < n_kb; ++kb) {
        mbar_wait(kv_empty, (kb & 1) ^ 1);  // passes at once for the first key block
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_3d(kt + p * C::KV_PANEL, &tm_k, p * W, kb * KEYS, head, kv_full);
          tma_load_3d(vt + p * C::KV_PANEL, &tm_v, p * W, kb * KEYS, head, kv_full);
        }
        for (int m = 0; m < n_q; ++m, ++gi) {
          const int s = gi % C::STAGES;
          mbar_wait(empty + s, ((gi / C::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full + s, C::STAGE_BYTES + STAT_FLOATS * 4);
          unsigned char* qt = ring + s * C::STAGE_BYTES;
          for (int p = 0; p < C::PANELS; ++p) {
            tma_load_3d(qt + p * C::Q_PANEL, &tm_q, p * W, m * BQ, head, full + s);
            tma_load_3d(qt + C::Q_BYTES + p * C::Q_PANEL, &tm_g, p * W, m * BQ, head, full + s);
          }
          const float* rows = stats + size_t(head) * s_len + m * BQ;
          bulk_load(st + s * STAT_FLOATS, rows, BQ * 4, full + s);
          bulk_load(st + s * STAT_FLOATS + BQ, rows + n_rows, BQ * 4, full + s);
        }
      }
    }
  } else {
    setmaxnreg_inc<KEY_CONSUMER_REGS>();
    // consumer c: keys [64 c, 64 c + 64) of the key block; this thread's rows 16 wq + g8, + 8
    const int c = warp / 4, wq = warp % 4;
    const int g8 = lane / 4, t = lane % 4;
    const unsigned char* k_rows = kt + 64 * c * C::SPAN;
    const unsigned char* v_rows = vt + 64 * c * C::SPAN;
    int gi = 0;
    for (int kb = 0; kb < n_kb; ++kb) {
      const int key0 = kb * KEYS + 64 * c + 16 * wq + g8;
      const bool valid[2] = {key0 < s_len, key0 + 8 < s_len};  // keys past S: TMA's zero rows
      float dk_acc[DC / 2], dv_acc[DC / 2];
#pragma unroll
      for (int i = 0; i < DC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
      mbar_wait(kv_full, kb & 1);
      for (int m = 0; m < n_q; ++m, ++gi) {
        const int s = gi % C::STAGES;
        const unsigned char* qt = ring + s * C::STAGE_BYTES;
        const unsigned char* gt = qt + C::Q_BYTES;
        mbar_wait(full + s, (gi / C::STAGES) & 1);

        // S^T = K Q^T and dp^T = V g^T, 64 keys x 64 queries each, in two groups: the
        // exponentials of S^T run while dp^T is in flight
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          WgmmaSS<64>::mma(sc, desc_k<W>(k_rows, C::KV_PANEL, kk),
                           desc_k<W>(qt, C::Q_PANEL, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          WgmmaSS<64>::mma(dp, desc_k<W>(v_rows, C::KV_PANEL, kk),
                           desc_k<W>(gt, C::Q_PANEL, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        // W^T = exp2(S^T scale log2 e - L) in sc, then dS^T = W^T (dp^T - Delta) in dp;
        // sc[4 n + 2 i + e] is key row i, query 8 n + 2 t + e
        const float* lse = st + s * STAT_FLOATS;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * n + 2 * t);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int at = 4 * n + 2 * i + e;
              sc[at] = valid[i] ? ex2(fmaf(sc[at], scale_log2, -(e ? l2.y : l2.x))) : 0.0f;
            }
        }
        fence_regs(sc);  // the exponentials are issued before the wait: they overlap dp^T
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 d2 = *reinterpret_cast<const float2*>(lse + BQ + 8 * n + 2 * t);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int at = 4 * n + 2 * i + e;
              dp[at] = sc[at] * (dp[at] - (e ? d2.y : d2.x));
            }
        }
        uint32_t pw[4][4], pd[4][4];  // W^T and dS^T as bf16 A fragments, k16 step = 16 queries
        pack_p<false>(pw, sc);
        pack_p<false>(pd, dp);

        // dS into buffer gi & 1 as dS[q][key], panel c (this consumer's keys). pd[kk][e] is the
        // 8 x 8 matrix of keys 16 wq + 8 (e & 1) + [0, 8) and queries 16 kk + 8 (e >> 1) +
        // [0, 8): stored transposed, each of its queries one 16-byte chunk of that query's row
        unsigned char* dsb = ds + (gi & 1) * DS_BYTES;
        {
          const int j = lane / 8, chunk = 2 * wq + (j & 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int q = 16 * kk + 8 * (j >> 1) + lane % 8;
            stmatrix_x4_trans(dsb + c * DS_PANEL + q * 128 + ((chunk ^ (q & 7)) << 4), pd[kk]);
          }
        }
        fence_proxy_async();

        // dV += W^T g, dK += dS^T Q over this block's output columns
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaRS<DC>::mma(dv_acc, pw[kk], desc_mn<W>(gt + (c0 / W) * C::Q_PANEL, C::Q_PANEL, kk),
                           1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaRS<DC>::mma(dk_acc, pd[kk], desc_mn<W>(qt + (c0 / W) * C::Q_PANEL, C::Q_PANEL, kk),
                           1);
        wgmma_commit();

        // dQ's share of the key block, dS K over its 128 keys: consumer m % 2's turn, once both
        // consumers' dS is stored (the barrier also orders the buffers of dS and dq_tile: the
        // other consumer is done with the tile before, and the last tile's TMA store has read
        // dq_tile). Past the first key block, each thread copies the earlier blocks' sum of its
        // own dQ elements into dq_tile while the product runs
        if (wq == 0 && lane == 0) bulk_wait_read();
        named_sync(BAR_DS, 256);
        const bool mine = (m & 1) == c;
        float dqa[DC / 2];
        if (mine && kb > 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 16 * wq + g8 + 8 * i;
            const size_t row = size_t(head) * s_len + m * BQ + r;
#pragma unroll
            for (int n = 0; n < DC / 8; ++n) {
              const int col = 8 * n + 2 * t;
              if (c0 + col < d) cp_async8(dq_tile + r * DC + col, dq_acc + row * d + c0 + col);
            }
          }
          cp_async_commit();
        }
        if (mine) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KEYS / 16; ++kk)
            WgmmaSST<DC>::mma(dqa, desc_k<64>(dsb, DS_PANEL, kk),
                              desc_mn<W>(kt + (c0 / W) * C::KV_PANEL, C::KV_PANEL, kk), kk > 0);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(pw[kk]);
          fence_regs(pd[kk]);
        }
        if (lane == 0) mbar_arrive(empty + s);  // this warp is done with the stage
        if (mine) {
          // dQ's sum over the key blocks so far, in their order, staged in dq_tile (float32, or
          // at the last key block dq's bf16 values) and written by one TMA store: to the float32
          // accumulator, or to dq. Columns past d lie outside the maps and are not written.
          fence_regs(dqa);
          const bool last = kb + 1 == n_kb;
          if (kb > 0) {
            cp_async_wait_all();
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int n = 0; n < DC / 8; ++n) {
                const float2 prev = *reinterpret_cast<const float2*>(
                    dq_tile + (16 * wq + g8 + 8 * i) * DC + 8 * n + 2 * t);
                dqa[4 * n + 2 * i] = prev.x + dqa[4 * n + 2 * i];
                dqa[4 * n + 2 * i + 1] = prev.y + dqa[4 * n + 2 * i + 1];
              }
            if (last) named_sync(2 + c, 128);  // every thread has read before the bf16 writes
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int n = 0; n < DC / 8; ++n) {
              const int at = (16 * wq + g8 + 8 * i) * DC + 8 * n + 2 * t;
              const float a = dqa[4 * n + 2 * i], b = dqa[4 * n + 2 * i + 1];
              if (last) {
                st_pair(reinterpret_cast<bf16*>(dq_tile) + at, a * scale, b * scale);
              } else {
                st_pair(dq_tile + at, a, b);
              }
            }
          fence_proxy_async();
          named_sync(2 + c, 128);
          if (wq == 0 && lane == 0) {
            tma_store_3d(last ? &tm_dq : &tm_acc, dq_tile, c0, m * BQ, head);
            bulk_commit();
          }
        }
      }
      // this warp is done with the key block's K and V, and its stores of dQ's sums are done (the
      // next key block reads them back)
      if (wq == 0 && lane == 0) bulk_wait();
      if (lane == 0) mbar_arrive(kv_empty);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!valid[i]) continue;
        const size_t row = size_t(head) * s_len + key0 + 8 * i;
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) {
          const int col = c0 + 8 * n + 2 * t;
          if (col < d) {
            st_pair(dv + row * d + col, dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
            st_pair(dk + row * d + col, dk_acc[4 * n + 2 * i] * scale,
                    dk_acc[4 * n + 2 * i + 1] * scale);
          }
        }
      }
    }
  }
}

// The statistics pass at DS (d rounded up to 16), then the key kernel at DK.
template <int DS, int DK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* g, void* dq,
                        void* dk, void* dv, float* scratch, int bh, int s, int d, float scale,
                        cudaStream_t stream) {
  using SC = StatsCfg<DS>;
  using KC = KeyCfg<DK>;
  const float scale_log2 = scale * LOG2E;
  CUtensorMap sq, sk, sv, tq, tk, tv, tg;
  cudaError_t err = hopper::make_map_bf16(&sq, q, bh, s, d, BM, SC::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&sk, k, bh, s, d, SC::BN, SC::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&sv, v, bh, s, d, SC::BN, SC::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tq, q, bh, s, d, BQ, KC::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tg, g, bh, s, d, BQ, KC::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tk, k, bh, s, d, KEYS, KC::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tv, v, bh, s, d, KEYS, KC::W);
  float* dq_acc = scratch + 2 * size_t(bh) * s;
  CUtensorMap tdq, tacc;
  if (err == cudaSuccess) err = hopper::make_map_rows(&tdq, dq, false, bh, s, d, BQ, KC::DC);
  if (err == cudaSuccess) err = hopper::make_map_rows(&tacc, dq_acc, true, bh, s, d, BQ, KC::DC);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_stats_wgmma<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SC::SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_keys_wgmma<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(KC::SMEM));
  if (err != cudaSuccess) return err;
  const int n_items = (s + BM - 1) / BM * bh;
  const int grid = n_items < hopper::sm_count() ? n_items : hopper::sm_count();
  bwd_stats_wgmma<DS><<<grid, THREADS_WG, SC::SMEM, stream>>>(
      sq, sk, sv, static_cast<const bf16*>(g), scratch, s, d, bh, n_items, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_keys_wgmma<DK><<<dim3(bh, DK / KC::DC), KEY_THREADS, KC::SMEM, stream>>>(
      tq, tk, tv, tg, tdq, tacc, scratch, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dq_acc,
      s, d, bh, scale, scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, const void* g, void* dq,
                          void* dk, void* dv, float* scratch, int bh, int s, int d, float scale,
                          cudaStream_t st) {
#define BWD_BF16(DS, DK) launch_bf16<DS, DK>(q, k, v, g, dq, dk, dv, scratch, bh, s, d, scale, st)
  switch ((d + 15) / 16) {
    case 1: return BWD_BF16(16, 16);
    case 2: return BWD_BF16(32, 32);
    case 3: return BWD_BF16(48, 48);
    case 4: return BWD_BF16(64, 64);
    case 5: return BWD_BF16(80, 80);
    case 6: return BWD_BF16(96, 96);
    case 7: return BWD_BF16(112, 128);
    case 8: return BWD_BF16(128, 128);
    case 9: return BWD_BF16(144, 160);
    case 10: return BWD_BF16(160, 160);
    default: return cudaErrorInvalidValue;
  }
#undef BWD_BF16
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

// The statistics pass: K1's float32 forward pass (attention_tf32.cuh, 64 q rows of one head a
// block), its epilogue L and Delta. Instantiated at every D % 8 == 0 up to 160, as the forward.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
bwd_stats_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ gr,
               float* __restrict__ stats, int s_len, int bh, float scale_log2) {
  constexpr int KS = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t head = size_t(blockIdx.y) * s_len * D;
  const int q0 = blockIdx.x * BQ;

  copy_q_f32<D>(smem, q + head + size_t(q0) * D);
  float acc[KS][4], l_run[2], m_run[2];
  attend_tf32<D>(smem, k + head, v + head, s_len, scale_log2, 0.0f, acc, l_run, m_run);

  const size_t n_rows = size_t(bh) * s_len;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    const float inv = 1.0f / l;
    const int row = q0 + 16 * warp + g + 8 * i;
    const float* grow = gr + head + size_t(row) * D;
    float part = 0.0f;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const float2 gp = *reinterpret_cast<const float2*>(grow + 8 * n + 2 * t);
      part = fmaf(gp.x, acc[n][2 * i] * inv, part);
      part = fmaf(gp.y, acc[n][2 * i + 1] * inv, part);
    }
    const float delta = quad_sum(part);
    if (t == 0) {
      const size_t at = size_t(blockIdx.y) * s_len + row;
      stats[at] = m_run[i] * scale_log2 + log2f(l);
      stats[n_rows + at] = delta;
    }
  }
}

constexpr size_t SMEM_BLOCK = 232448;       // shared memory a block may use
constexpr size_t SMEM_TWO_BLOCKS = 115712;  // each of two blocks on one SM (228 KB, 1 KB each)

constexpr int LDS = BQ + 8;                 // dS rows (floats): 8 mod 16, load_a_3xtf32's pad

// The key kernel's tiling at head dim DP (a multiple of 16, zero columns past the true d): K and
// V resident, `stages` stages of a Q and a g tile and their L and Delta, and dS.
template <int DP>
struct F32Cfg {
  static constexpr int LD = DP + 4;  // 4 mod 8: the B fragments' column reads are conflict-free
  static constexpr size_t TILE = align128(size_t(BQ) * LD * 4);
  static constexpr size_t DS = align128(size_t(BQ) * LDS * 4);
  static constexpr size_t STATS = STAT_FLOATS * 4;
  // two stages where they leave room for two blocks on an SM, else one
  static constexpr int STAGES = 6 * TILE + 2 * STATS + DS <= SMEM_TWO_BLOCKS ? 2 : 1;
  static constexpr size_t SMEM = (2 + 2 * STAGES) * TILE + STAGES * STATS + DS;
  static constexpr int DC = DP <= 80 ? DP : DP / 2;  // output columns a block
  static constexpr int NT = DC / 8;
  static constexpr int HALF = NT > 6 ? (NT + 1) / 2 : NT;  // n8 tiles of a fresh product sum
  static_assert(SMEM <= SMEM_BLOCK, "tiles exceed the shared memory of a block");
};

// cp.async of rows [0, 64) x columns [0, d) of a row-major (rows, d) matrix into a tile of
// leading dim LD, 16 bytes a copy (d % 4 == 0).
template <int LD>
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src, int d) {
  const int cpr = d / 4;
  for (int i = threadIdx.x; i < BQ * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * 4;
    cp_async16(dst + r * LD + c, src + size_t(r) * d + c);
  }
}

// s = rows row0 + [0, 16) of At times rows [0, 64) of Bt, transposed, over DP columns, in a
// fresh 3xTF32 sum: s[n] is the C fragment of Bt's rows 8n .. 8n + 7, k order permuted.
template <int DP>
__device__ __forceinline__ void rows_times_rows(float (&s)[8][4], const float* At, int row0,
                                                const float* Bt, int g, int t) {
  constexpr int LD = F32Cfg<DP>::LD;
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
      if (ks == 0) {
        mma_tf32_first(s[n], al, bh0, bh1);
      } else {
        mma_tf32(s[n], al, bh0, bh1);
      }
      mma_tf32(s[n], ah, bl0, bl1);
      mma_tf32(s[n], ah, bh0, bh1);
    }
  }
}

// The 3xTF32 product of one k8 step into part (the first `count` of its N n8 tiles): A fragment
// (ah, al), B rows b0 and b0 + LD (the step's rows 2t and 2t + 1) at columns 8 n + g.
template <int DP, int N>
__device__ __forceinline__ void step_3xtf32(float (&part)[N][4], const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4], const float* b0, bool first,
                                            int count = N) {
  constexpr int LD = F32Cfg<DP>::LD;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (n >= count) break;
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0[8 * n], bh0, bl0);
    split_tf32(b0[8 * n + LD], bh1, bl1);
    if (first) {  // the small products first
      mma_tf32_first(part[n], al, bh0, bh1);
    } else {
      mma_tf32(part[n], al, bh0, bh1);
    }
    mma_tf32(part[n], ah, bl0, bl1);
    mma_tf32(part[n], ah, bh0, bh1);
  }
}

// acc += P Bt: P the warp's 16 x 64 tile in C fragments (p[j] columns 8 j .. 8 j + 7), Bt's 64
// rows x NT n8 tiles, one fresh sum added to acc; P's C fragments are A fragments under the
// permuted k order. Past 6 n8 tiles the columns go in two halves (F32Cfg::HALF), each its own
// fresh sum, so that the sum's registers stay few (P's fragments are split twice).
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[F32Cfg<DP>::NT][4],
                                           const float (&p)[8][4], const float* Bt, int g, int t) {
  constexpr int LD = F32Cfg<DP>::LD, NT = F32Cfg<DP>::NT, HALF = F32Cfg<DP>::HALF;
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += HALF) {
    float part[HALF][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ph[4], pl[4];  // (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) = C 0, 2, 1, 3
      split_tf32(p[kk][0], ph[0], pl[0]);
      split_tf32(p[kk][2], ph[1], pl[1]);
      split_tf32(p[kk][1], ph[2], pl[2]);
      split_tf32(p[kk][3], ph[3], pl[3]);
      step_3xtf32<DP, HALF>(part, ph, pl, Bt + (8 * kk + 2 * t) * LD + g + 8 * n0, kk == 0,
                            NT - n0);
    }
#pragma unroll
    for (int n = 0; n < HALF; ++n)
      if (n0 + n < NT)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// A block: 4 warps of 16 keys (64 a key block), head blockIdx.x, output columns
// [blockIdx.y DC, + DC); its key blocks in order, each over the query tiles in order.
template <int DP>
__global__ void __launch_bounds__(THREADS)
bwd_keys_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ gr,
              const float* __restrict__ stats, float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ dq_acc, int s_len, int d, int bh,
              float scale, float scale_log2) {
  using C = F32Cfg<DP>;
  constexpr int LD = C::LD, NT = C::NT, HALF = C::HALF, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = reinterpret_cast<float*>(smem + C::TILE);
  auto q_tile = [&](int b) { return reinterpret_cast<float*>(smem + (2 + 2 * b) * C::TILE); };
  auto g_tile = [&](int b) { return reinterpret_cast<float*>(smem + (3 + 2 * b) * C::TILE); };
  auto st_tile = [&](int b) {
    return reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * C::TILE + b * C::STATS);
  };
  float* dSs = reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * C::TILE + STAGES * C::STATS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  const int head = blockIdx.x, c0 = blockIdx.y * C::DC;
  const size_t base = size_t(head) * s_len * d;
  const size_t n_rows = size_t(bh) * s_len;
  const int n_q = s_len / BQ, n_kb = s_len / BQ;

  // zero the tiles' columns [d, DP) once: cp.async writes only columns < d
  if (d < DP)
    for (int i = threadIdx.x; i < (2 + 2 * STAGES) * BQ * (DP - d); i += THREADS) {
      const int tile = i / (BQ * (DP - d)), r = i / (DP - d) % BQ, col = d + i % (DP - d);
      reinterpret_cast<float*>(smem + tile * C::TILE)[r * LD + col] = 0.0f;
    }
  auto issue = [&](int m) {  // query tile m: Q, g, L and Delta
    const int b = m % STAGES;
    copy_rows<LD>(q_tile(b), q + base + size_t(m) * BQ * d, d);
    copy_rows<LD>(g_tile(b), gr + base + size_t(m) * BQ * d, d);
    if (threadIdx.x < STAT_FLOATS / 4) {  // 16 bytes a thread: L, then Delta
      const int which = threadIdx.x / (BQ / 4), col = 4 * (threadIdx.x % (BQ / 4));
      cp_async16(st_tile(b) + which * BQ + col,
                 stats + which * n_rows + size_t(head) * s_len + size_t(m) * BQ + col);
    }
    cp_async_commit();
  };

  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();  // every warp is done with the last key block's tiles
    copy_rows<LD>(Ks, k + base + size_t(kb) * BQ * d, d);
    copy_rows<LD>(Vs, v + base + size_t(kb) * BQ * d, d);
    issue(0);  // joins K and V's group
    float dv_acc[NT][4], dk_acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[n][e] = dk_acc[n][e] = 0.0f;

    for (int m = 0; m < n_q; ++m) {
      const int b = m % STAGES;
      if constexpr (STAGES == 2) {
        if (m + 1 < n_q) {
          issue(m + 1);
        } else {
          cp_async_commit();
        }
        cp_async_wait_all_but_one();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      const float* lse = st_tile(b);

      // W^T = exp2(S^T scale log2 e - L): rows the warp's keys, columns the tile's queries;
      // each product follows the values it needs, so that few tiles are live at once
      float w[8][4];
      rows_times_rows<DP>(w, Ks, r0, q_tile(b), g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[n][e] = hopper::ex2(fmaf(w[n][e], scale_log2, -lse[8 * n + 2 * t + e % 2]));
      accumulate<DP>(dv_acc, w, g_tile(b) + c0, g, t);
      // dS^T = W^T (dp^T - Delta), dp^T = V g^T
      float ds[8][4];
      rows_times_rows<DP>(ds, Vs, r0, g_tile(b), g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = w[n][e] * (ds[n][e] - lse[BQ + 8 * n + 2 * t + e % 2]);
      // dS = (dS^T)^T into shared memory, q rows
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dSs[(8 * n + 2 * t + e % 2) * LDS + r0 + g + 8 * (e / 2)] = ds[n][e];
      accumulate<DP>(dk_acc, ds, q_tile(b) + c0, g, t);
      __syncthreads();
      // dQ's share of the key block, dS K: the warp's 16 query rows over the 64 keys, in the
      // column halves of accumulate. Past the first key block the earlier blocks' sum of this
      // thread's elements of a half is loaded first, so that its latency passes under the product
      const size_t row0 = size_t(head) * s_len + size_t(m) * BQ + r0 + g;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += HALF) {
        float2 prev[2][HALF];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < HALF; ++n) {
            const int col = c0 + 8 * (n0 + n) + 2 * t;
            prev[i][n] = kb > 0 && n0 + n < NT && col < d
                             ? *reinterpret_cast<const float2*>(dq_acc + (row0 + 8 * i) * d + col)
                             : make_float2(0.0f, 0.0f);
          }
        float part[HALF][4];
#pragma unroll 1
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t ah[4], al[4];
          load_a_3xtf32(ah, al, dSs, LDS, r0, 8 * kk, g, t);
          step_3xtf32<DP, HALF>(part, ah, al, Ks + (8 * kk + 2 * t) * LD + c0 + 8 * n0 + g,
                                kk == 0, NT - n0);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const size_t row = row0 + 8 * i;
#pragma unroll
          for (int n = 0; n < HALF; ++n) {
            const int col = c0 + 8 * (n0 + n) + 2 * t;
            if (n0 + n < NT && col < d)
              dq_sum(prev[i][n], dq_acc + row * d + col, dq + row * d + col, part[n][2 * i],
                     part[n][2 * i + 1], kb, n_kb, scale);
          }
        }
      }
      __syncthreads();  // every warp is done with this stage and dS before they are refilled
      if constexpr (STAGES == 1) {
        if (m + 1 < n_q) issue(m + 1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t row = size_t(head) * s_len + size_t(kb) * BQ + r0 + g + 8 * i;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = c0 + 8 * n + 2 * t;
        if (col < d) {
          st_pair(dv + row * d + col, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
          st_pair(dk + row * d + col, dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
        }
      }
    }
  }
}

// The statistics pass at D = d (every D % 8 == 0 up to 160)
template <int D = 8>
cudaError_t stats_f32(const float* q, const float* k, const float* v, const float* g,
                      float* scratch, int bh, int s, int d, float scale_log2, cudaStream_t st) {
  if constexpr (D > 160) {
    return cudaErrorInvalidValue;
  } else {
    if (d != D) return stats_f32<D + 8>(q, k, v, g, scratch, bh, s, d, scale_log2, st);
    constexpr size_t bytes = SmemF32<D>::TOTAL;
    cudaError_t err = cudaFuncSetAttribute(
        bwd_stats_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    bwd_stats_tf32<D><<<dim3(s / BQ, bh), THREADS, bytes, st>>>(q, k, v, g, scratch, s, bh,
                                                               scale_log2);
    return cudaGetLastError();
  }
}

// The key kernel at DP = d rounded up to 16
template <int DP = 16>
cudaError_t keys_f32(const float* q, const float* k, const float* v, const float* g, float* dq,
                     float* dk, float* dv, float* scratch, int bh, int s, int d, float scale,
                     cudaStream_t st) {
  if constexpr (DP > 160) {
    return cudaErrorInvalidValue;
  } else {
    if (d > DP) return keys_f32<DP + 16>(q, k, v, g, dq, dk, dv, scratch, bh, s, d, scale, st);
    using C = F32Cfg<DP>;
    cudaError_t err = cudaFuncSetAttribute(
        bwd_keys_tf32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
    if (err != cudaSuccess) return err;
    bwd_keys_tf32<DP><<<dim3(bh, DP / C::DC), THREADS, C::SMEM, st>>>(
        q, k, v, g, scratch, dq, dk, dv, scratch + 2 * size_t(bh) * s, s, d, bh, scale,
        scale * LOG2E);
    return cudaGetLastError();
  }
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, const void* g, void* dq,
                         void* dk, void* dv, float* scratch, int bh, int s, int d, float scale,
                         cudaStream_t st) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(g);
  cudaError_t err = stats_f32(qf, kf, vf, gf, scratch, bh, s, d, scale * LOG2E, st);
  if (err != cudaSuccess) return err;
  return keys_f32(qf, kf, vf, gf, static_cast<float*>(dq), static_cast<float*>(dk),
                  static_cast<float*>(dv), scratch, bh, s, d, scale, st);
}

}  // namespace

extern "C" {

// q, k, v, g (the output's gradient), dq, dk, dv: contiguous (bh, s, d) of one dtype, 0 = float32,
// 1 = bfloat16; scratch: float32 of (2 + d) * bh * s (L and Delta of each row, written by the
// statistics pass and read by the key kernel, then dQ's accumulator over the key blocks);
// scale: the softmax scale (the caller's unpadded width's).
// Requires s % 64 == 0, d % 8 == 0, 0 < d <= 160, 0 < bh <= 65535.
int fused_attention_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                        void* dk, void* dv, void* scratch, int bh, int s, int d, float scale,
                        int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % BQ != 0 || d <= 0 || d > 160 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scratch);
  if (dtype == 0)
    return static_cast<int>(dispatch_f32(q, k, v, g, dq, dk, dv, sp, bh, s, d, scale, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_bf16(q, k, v, g, dq, dk, dv, sp, bh, s, d, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
