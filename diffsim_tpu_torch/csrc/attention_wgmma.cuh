// The Hopper (sm_90a) attention pipeline shared by the bf16 kernels of K1 (fused_attention.cu,
// and the statistics pass of its backward, fused_attention_bwd.cu) and K3 (fused_readout.cu),
// FlashAttention-3's shape:
//   * a persistent block of NWG consumer warpgroups of 64 q rows and one producer warpgroup.
//     One producer thread loads each q block's Q with TMA into one of two buffers (item it's Q
//     goes where item it - 2's was, so the next block's Q and first K/V tiles load while this
//     block finishes) and streams K/V tiles (128 keys at DP <= 64, else 64) through a ring of
//     2-4 stages in shared memory, each stage guarded by a "full" mbarrier (bytes landed) and an
//     "empty" one (every consumer warp done with it);
//   * a consumer's pass over the ring (attend_pass): S = Q K^T is a wgmma with both operands in
//     shared memory (64 x BN f32 accumulators a warpgroup); the online softmax runs on those
//     registers; P is cast to bf16 in registers and is the register A operand of the P V wgmma,
//     with V read transposed from its (key, d) layout;
//   * the exps overlap the tensor cores twice over. Within a warpgroup, tile j's Q K^T is issued
//     together with tile j-1's P V, and the softmax of tile j runs while that P V is in flight.
//     Across the warpgroups, named barriers pass the turn to issue products round the consumers
//     (ping-pong), so the others' softmaxes run under each one's products;
//   * the head dim pads to DP, a multiple of 16. Up to DP = 128 the tiles are 64-column panels
//     (128-byte rows and swizzle: the widest TMA transfers), the last one partly unused when 64
//     does not divide DP; above that, the 32- or 16-column panels that divide DP. TMA's zero fill
//     supplies the columns past D, the keys past S of a partial last tile (masked) and the rows
//     past S of a partial last q block.
// Numerics (the JAX kernels' contract): f32 logits and softmax statistics, the row max over the
// UNSCALED logits with scale * log2(e) folded into exp2's operand, the f32 row sum taken before
// the probabilities are cast to bf16 unnormalised, f32 accumulation; the caller applies 1 / l.
// The bf16_probs mode (BF16P, K1's --bf16_softmax) rounds as the TPU kernel's fast mode does
// (attention_common.cuh prob_bf16x2: the centred logit, its product with the bf16 scale and the
// exponential each to bf16, two at a time on the card's bf16x2 conversions) and sums the rounded
// probabilities; the rescaling factor stays f32.

#pragma once

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace attn {

constexpr uint32_t BAR_TURN = 1;  // named barriers 1..NWG: consumer c's turn at the tensor cores
constexpr uint32_t TURN_THREADS = 256;

// The tiling of a kernel with NWG consumer warpgroups at padded head dim DP, and its shared
// memory: 1024 bytes of alignment slack, two Q buffers, the K/V ring, EXTRA bytes of the
// kernel's own, then the mbarriers.
template <int DP, int NWG_, int EXTRA = 0>
struct Tiling {
  static constexpr int NWG = NWG_;
  static constexpr int EXTRA_BYTES = EXTRA;
  static constexpr int BM = 64 * NWG;  // q rows per block
  // keys per K/V tile: S (BN / 2), O (DP / 2) and P (BN / 4) registers fit 160 a thread
  static constexpr int BN = DP <= 64 ? 128 : 64;
  // panel columns: 64 up to DP = 128, the last panel partly unused when 64 does not divide DP
  // (TMA zero-fills it, no product reads it); above that, the narrower panels that divide DP,
  // so that the ring keeps two stages
  static constexpr int W = DP <= 128 ? 64 : DP % 32 == 0 ? 32 : 16;
  static constexpr int PANELS = (DP + W - 1) / W;
  static constexpr int SPAN = W * 2;  // bytes of one panel row = the swizzle span
  static constexpr int Q_PANEL = BM * SPAN;
  static constexpr int KV_PANEL = BN * SPAN;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int FIXED = 1024 + 2 * Q_BYTES + EXTRA + 256;
  static constexpr int FIT = (232448 - FIXED) / STAGE_BYTES;  // of 227 KB
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr size_t SMEM = FIXED + size_t(STAGES) * STAGE_BYTES;
  static_assert(STAGES >= 2, "the K/V ring needs two stages");
};

// A block's Q buffers, K/V ring and mbarriers in its dynamic shared memory. `g` counts the K/V
// tiles issued (in the producer) or consumed (in a consumer) so far: the ring position.
template <class C>
struct Pipeline {
  unsigned char* qs;     // [2][Q_BYTES]
  unsigned char* ring;   // [STAGES]: a K tile, then a V tile
  unsigned char* extra;  // the kernel's own EXTRA bytes
  uint64_t* q_full;      // [2]
  uint64_t* q_empty;     // [2]
  uint64_t* full;        // [STAGES]
  uint64_t* empty;       // [STAGES]
  int g = 0;

  __device__ __forceinline__ explicit Pipeline(unsigned char* smem_raw) {
    qs = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
    ring = qs + 2 * C::Q_BYTES;
    extra = ring + C::STAGES * C::STAGE_BYTES;
    q_full = reinterpret_cast<uint64_t*>(extra + C::EXTRA_BYTES);
    q_empty = q_full + 2;
    full = q_full + 4;
    empty = full + C::STAGES;
  }

  // One thread, before the block's __syncthreads(); an empty barrier counts the consumer warps.
  __device__ __forceinline__ void init() const {
    using namespace hopper;
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 4 * C::NWG);
    }
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * C::NWG);
    }
    mbar_fence_init();
  }

  // Producer: item it's q block, rows q0.. of row bh.
  __device__ __forceinline__ void load_q(const CUtensorMap* tm, int it, int q0, int bh) const {
    using namespace hopper;
    const int qb = it & 1;
    mbar_wait(q_empty + qb, ((it >> 1) & 1) ^ 1);  // passes at once for the first two items
    mbar_arrive_expect_tx(q_full + qb, C::Q_BYTES);
    for (int p = 0; p < C::PANELS; ++p)
      tma_load_3d(qs + qb * C::Q_BYTES + p * C::Q_PANEL, tm, p * C::W, q0, bh, q_full + qb);
  }

  // Producer: every K/V tile of row bh (s_len keys), in order, into the ring.
  __device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv, int bh,
                                          int s_len) {
    using namespace hopper;
    const int n_tiles = (s_len + C::BN - 1) / C::BN;
    for (int j = 0; j < n_tiles; ++j, ++g) {
      const int st = g % C::STAGES;
      mbar_wait(empty + st, ((g / C::STAGES) & 1) ^ 1);  // passes at once on the first round
      mbar_arrive_expect_tx(full + st, C::STAGE_BYTES);
      unsigned char* kt = ring + st * C::STAGE_BYTES;
      for (int p = 0; p < C::PANELS; ++p) {
        tma_load_3d(kt + p * C::KV_PANEL, tk, p * C::W, j * C::BN, bh, full + st);
        tma_load_3d(kt + C::KV_BYTES + p * C::KV_PANEL, tv, p * C::W, j * C::BN, bh, full + st);
      }
    }
  }

  // Consumer c: wait for item it's Q and return its 64 rows of it.
  __device__ __forceinline__ const unsigned char* wait_q(int it, int c) const {
    hopper::mbar_wait(q_full + (it & 1), (it >> 1) & 1);
    return qs + (it & 1) * C::Q_BYTES + 64 * c * C::SPAN;
  }
};

// Named barrier BAR_TURN + c is consumer c's turn to issue products, taken round the consumers:
// the last consumer opens the first turn for consumer 0.
template <int NWG>
__device__ __forceinline__ void open_turns(int c) {
  if (c == NWG - 1) hopper::named_arrive(BAR_TURN, TURN_THREADS);
}

// The score tiles below are wgmma (or mma.sync) accumulator registers: s[4 n + 2 i + e] is row
// r (i = 0) or r + 8 (i = 1) of this thread, column 8 n + 2 t + e, a row spread over one lane
// quad (t = lane % 4).

// The maxima of this thread's two rows of a score tile, over the lane quad.
template <int NS>
__device__ __forceinline__ void tile_max(const float (&s)[NS], float (&mx)[2]) {
  // both rows at once, each max in four partial chains: a consumer warp shares its scheduler
  // with others, so short dependency chains are what keeps the exp unit fed
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[i][c] = -INFINITY;
#pragma unroll
  for (int n = 0; n < NS / 4; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      part[i][n % 4] = fmaxf(part[i][n % 4], fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m = fmaxf(fmaxf(part[i][0], part[i][1]), fmaxf(part[i][2], part[i][3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    mx[i] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  }
}

// The online max step of this thread's two rows: m_run takes the tile's maxima mx, corr the
// factor that rescales the earlier tiles (0 on the first), and mb the operand tile_probs takes.
template <bool BF16P>
__device__ __forceinline__ void update_max(float (&m_run)[2], const float (&mx)[2],
                                           float (&corr)[2], float (&mb)[2], float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m_run[i], mx[i]);
    corr[i] = hopper::ex2((m_run[i] - m_new) * scale_log2);  // 0 on the first tile
    m_run[i] = m_new;
    mb[i] = BF16P ? m_new : m_new * scale_log2;
  }
}

// The probabilities of a score tile in place, and this thread's shares of their two row sums.
// Exact mode: p = exp2(s * scale log2 e - mb), one FMA and one ex2 each, summed in f32 before
// the cast to bf16, as the TPU kernel does. bf16_probs mode: prob_bf16x2 on each pair, which
// rounds the probabilities where they are packed for P V: both s[4 n + 2 i] and s[4 n + 2 i + 1]
// then hold the pair's packed bf16x2 bits (p_pair reads the first); the sums add the rounded
// values. The second copy is not read, but a score register left holding the Q K^T product's
// output makes ptxas serialise every wgmma of the pipeline (its C7511 report).
template <bool BF16P, int NS>
__device__ __forceinline__ void tile_probs(float (&s)[NS], const float (&mb)[2], float scale_log2,
                                           float scale_bf16, float (&row_sum)[2]) {
  using hopper::ex2;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale_bf16);
  float sum[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[i][c] = 0.0f;
#pragma unroll
  for (int n = 0; n < NS / 4; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float& s0 = s[4 * n + 2 * i];
      float& s1 = s[4 * n + 2 * i + 1];
      if constexpr (BF16P) {
        const uint32_t pp = prob_bf16x2(s0, s1, mb[i], scale2);
        sum[i][n % 4] += bf16_lo(pp) + bf16_hi(pp);
        s0 = s1 = __uint_as_float(pp);
      } else {
        s0 = ex2(fmaf(s0, scale_log2, -mb[i]));
        s1 = ex2(fmaf(s1, scale_log2, -mb[i]));
        sum[i][n % 4] += s0;
        sum[i][n % 4] += s1;
      }
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) row_sum[i] = (sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]);
}

// The bf16x2 pair of probabilities at s[k], s[k + 1] (k even) after tile_probs: packed here in
// the exact mode, already packed in s[k] in the bf16_probs mode.
template <bool BF16P, int NS>
__device__ __forceinline__ uint32_t p_pair(const float (&s)[NS], int k) {
  return BF16P ? __float_as_uint(s[k]) : pack_bf16(s[k], s[k + 1]);
}

// Online softmax of one 64 x BN score tile held in wgmma accumulator registers. Keys at or past
// `valid` are masked (zero-filled by TMA past S). Leaves the probabilities in s (tile_probs),
// updates m and l (this thread's share of the row sums), and returns in corr the factor that
// rescales the accumulator (0 on the first tile).
template <bool BF16P, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], float scale_log2, float scale_bf16,
                                             int valid, int t) {
  if (valid < 2 * NS) {
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * n + 2 * t + e >= valid) s[4 * n + e] = s[4 * n + 2 + e] = -INFINITY;
  }
  float mx[2], mb[2], sum[2];
  tile_max(s, mx);
  update_max<BF16P>(m_run, mx, corr, mb, scale_log2);
  tile_probs<BF16P>(s, mb, scale_log2, scale_bf16, sum);
#pragma unroll
  for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * corr[i] + sum[i];
}

// The probabilities as bf16 A fragments of the P V wgmma: k16 step kk is accumulator columns
// [16 kk, 16 kk + 16), which is exactly the register A layout.
template <bool BF16P, int KP>
__device__ __forceinline__ void pack_p(uint32_t (&p)[KP][4], const float (&s)[KP * 8]) {
#pragma unroll
  for (int kk = 0; kk < KP; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kk][e] = p_pair<BF16P>(s, 8 * kk + 2 * e);
}

// Consumer c's online-softmax pass of its 64 q rows (q_base, from wait_q) over the s_len keys
// whose K/V tiles come next in the ring. On return acc holds the unnormalised P V and l_run
// this thread's share of the row sums of rows 16 (warp % 4) + lane / 4 (i = 0) and + 8 (i = 1):
// reduce over the lane quad (quad_sum) before use. acc[4 n + e] is row i = e / 2, column
// 8 n + 2 t + e % 2 (t = lane % 4). `last_turn`: the block's last pass, after which the last
// consumer hands no turn on. `release_q`: the pass's last read of Q frees item it's buffer.
// BF16P: the bf16_probs mode, with the bf16-rounded scale `scale_bf16`. On return m_run holds the
// two rows' maxima of the unscaled logits (the backward's statistics pass reads them).
template <int DP, bool BF16P = false, class C>
__device__ __forceinline__ void attend_pass(Pipeline<C>& pipe, float (&acc)[DP / 2],
                                            float (&l_run)[2], float (&m_run)[2],
                                            const unsigned char* q_base, int it, int s_len,
                                            float scale_log2, int c, bool last_turn,
                                            bool release_q, float scale_bf16 = 0.0f) {
  using namespace hopper;
  constexpr int BN = C::BN, NWG = C::NWG;
  constexpr int NS = BN / 2;   // S accumulators a thread
  constexpr int KQ = DP / 16;  // k16 steps of Q K^T
  constexpr int KP = BN / 16;  // k16 steps of P V
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int n_tiles = (s_len + BN - 1) / BN;
  auto desc_kmajor = [](const unsigned char* panel0, int panel_bytes, int kk) {
    return make_desc(panel0 + (kk * 16 / C::W) * panel_bytes + (kk * 16 % C::W) * 2, 16,
                     8 * C::SPAN, C::SPAN);
  };
  auto desc_v = [](const unsigned char* vt, int kk) {
    return make_desc(vt + kk * 16 * C::SPAN, C::KV_PANEL, 8 * C::SPAN, C::SPAN);
  };
  auto k_tile = [&](int g) { return pipe.ring + (g % C::STAGES) * C::STAGE_BYTES; };
  auto v_tile = [&](int g) { return k_tile(g) + C::KV_BYTES; };
  auto release = [&](int g) {  // this warp is done with tile g's stage
    if (lane == 0) mbar_arrive(pipe.empty + g % C::STAGES);
  };
  auto done_with_q = [&](bool last_read) {
    if (release_q && last_read && lane == 0) mbar_arrive(pipe.q_empty + (it & 1));
  };
  // each turn hands the next one on, except the last consumer's very last turn
  auto pass_turn = [&](bool last) {
    if (c != NWG - 1 || !last) named_arrive(BAR_TURN + (c + 1) % NWG, TURN_THREADS);
  };

  float s[NS], corr[2];
  uint32_t p[KP][4];
  m_run[0] = m_run[1] = -INFINITY;
  l_run[0] = l_run[1] = 0.0f;
  int& g = pipe.g;

  // tile 0: S_0 = Q K_0^T
  mbar_wait(pipe.full + g % C::STAGES, (g / C::STAGES) & 1);
  named_sync(BAR_TURN + c, TURN_THREADS);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
    WgmmaSS<BN>::mma(s, desc_kmajor(q_base, C::Q_PANEL, kk),
                     desc_kmajor(k_tile(g), C::KV_PANEL, kk), kk > 0);
  wgmma_commit();
  pass_turn(last_turn && n_tiles == 1);
  wgmma_wait<0>();
  fence_regs(s);
  done_with_q(n_tiles == 1);
  softmax_tile<BF16P>(s, m_run, l_run, corr, scale_log2, scale_bf16, s_len, t);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  pack_p<BF16P>(p, s);

  // tile j: S_j = Q K_j^T issued together with O += P_{j-1} V_{j-1}; the softmax of S_j runs
  // while that P V is in flight
  for (int j = 1; j < n_tiles; ++j) {
    ++g;
    mbar_wait(pipe.full + g % C::STAGES, (g / C::STAGES) & 1);
    named_sync(BAR_TURN + c, TURN_THREADS);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      WgmmaSS<BN>::mma(s, desc_kmajor(q_base, C::Q_PANEL, kk),
                       desc_kmajor(k_tile(g), C::KV_PANEL, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) WgmmaRS<DP>::mma(acc, p[kk], desc_v(v_tile(g - 1), kk), 1);
    wgmma_commit();
    pass_turn(last_turn && j == n_tiles - 1);
    wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
    fence_regs(s);
    done_with_q(j == n_tiles - 1);
    softmax_tile<BF16P>(s, m_run, l_run, corr, scale_log2, scale_bf16, s_len - j * BN, t);
    fence_regs(s);    // keeps the compiler from sinking the exps below the wait: they overlap
    wgmma_wait<0>();  // the P V in flight only if they are issued before it
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) fence_regs(p[kk]);
    release(g - 1);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[4 * n] *= corr[0];
      acc[4 * n + 1] *= corr[0];
      acc[4 * n + 2] *= corr[1];
      acc[4 * n + 3] *= corr[1];
    }
    pack_p<BF16P>(p, s);
  }

  // the last tile's P V, outside the turns: it overlaps the other consumers' products
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) WgmmaRS<DP>::mma(acc, p[kk], desc_v(v_tile(g), kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) fence_regs(p[kk]);
  release(g);
  ++g;
}

// attend_pass without the row maxima (the forward kernels').
template <int DP, bool BF16P = false, class C>
__device__ __forceinline__ void attend_pass(Pipeline<C>& pipe, float (&acc)[DP / 2],
                                            float (&l_run)[2], const unsigned char* q_base, int it,
                                            int s_len, float scale_log2, int c, bool last_turn,
                                            bool release_q, float scale_bf16 = 0.0f) {
  float m_run[2];
  attend_pass<DP, BF16P>(pipe, acc, l_run, m_run, q_base, it, s_len, scale_log2, c, last_turn,
                         release_q, scale_bf16);
}

}  // namespace attn
