// K1: fused square self-attention forward, softmax(Q K^T / sqrt(D)) V over (B*H, S, D).
//
// Replaces the TPU kernel `fused_self_attention` (diffsim_tpu/ops/pallas/attention.py, body
// `_kernel`). Numerics contract, kept from that kernel:
//   * logits and softmax statistics in f32; the row max is taken over the UNSCALED logits and
//     the scale is folded into exp's operand: p = exp((s - m) * scale);
//   * the probabilities are cast to V's dtype before the PV product (f32 accumulation);
//   * 1 / rowsum is applied once, after the last PV product; the output is in V's dtype.
// The TPU kernel holds a head's whole K/V in VMEM (655 KB at S = 4096, D = 40 in bf16, far
// above the 227 KB of shared memory a block may use), so here K/V stream through shared memory
// and the softmax is online (running max m, running sum l, rescaled f32 accumulator), which
// differs from the TPU kernel's global-max softmax only by rounding. exp is exp2 with
// scale * log2(e) folded into one FMA.
//
// Bound on the H100, per head: 4 S^2 D FLOP on the bf16 tensor cores (989 TFLOP/s), S^2
// exponentials on the special-function units (about 3.9e12 exp/s, FlashAttention-3 section 1)
// and 8 S D bytes (3.35 TB/s). At S >= 1024 bytes never bound it; the 256-token, hd-160 site is
// bound by bytes. At D = 64 the exps weigh as much as the products, and at D = 40 (SD-1.5's
// 4096-token sites) they weigh 1.6x more: the exponentials, not the tensor cores, set the floor.
// At (12, 10, 4096, 64) the bound is 0.521 ms of products, 0.516 ms of exps; at (24, 8, 4096,
// 40) 0.521 ms of products against 0.826 ms of exps.
//
// bf16 (the main path), for sm_90a, FlashAttention-3's shape:
//   * a persistent block of 512 threads per SM walks over 192-row q blocks (a head's blocks
//     adjacent, so concurrent blocks share its K/V in L2): three consumer warpgroups of 64 rows
//     and one producer warpgroup, which gives its registers to the consumers (setmaxnreg: 24 a
//     thread for it, 160 for them). One producer thread loads Q with TMA into one of two
//     buffers, so the next block's Q and first K/V tiles load while this block finishes, and
//     streams K/V tiles (128 keys at DP <= 64, else 64) through a ring of 2-4 stages in shared
//     memory, each stage guarded by a "full" mbarrier (bytes landed) and an "empty" one (all 12
//     consumer warps done with it);
//   * S = Q K^T is a wgmma with both operands in shared memory (64 x BN f32 accumulators a
//     warpgroup); the softmax runs on those registers; P is cast to bf16 in registers and is the
//     register A operand of the P V wgmma, with V read transposed from its (key, d) layout;
//   * the exps overlap the tensor cores twice over. Within a warpgroup, tile j's Q K^T is
//     issued together with tile j-1's P V, and the softmax of tile j runs while that P V is in
//     flight. Across the warpgroups, named barriers pass the turn to issue products round the
//     three (ping-pong), so two softmaxes run under each warpgroup's products. The softmax
//     keeps its max and sum chains short (four partial chains a row);
//   * the head dim pads to DP, a multiple of 16. Up to DP = 128 the tiles are 64-column panels
//     (128-byte rows and swizzle: the widest TMA transfers), the last one partly unused when
//     64 does not divide DP; above that, the 32- or 16-column panels that divide DP. TMA's zero
//     fill supplies the columns past D, the keys past S of a partial last tile (masked) and the
//     rows past S of a partial last q block (computed, not stored).
//
// float32 (a tight numerical check on the card, not on any main path): the PR 1 tiling with plain
// FMAs, the score tile and accumulator in shared memory (attention_common.cuh).
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, a producer warpgroup and three ping-ponged consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int NWG = 3;                      // consumer warpgroups of 64 q rows
constexpr int BM = 64 * NWG;                // q rows per block
constexpr int CONSUMER_WARPS = 4 * NWG;
constexpr int THREADS_WG = (NWG + 1) * 128;  // + the producer warpgroup
// the producer gives its registers to the consumers: 128 x 24 + 384 x 160 <= 65536
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 160;
constexpr uint32_t BAR_TURN = 1;  // named barriers 1..3: consumer c's turn at the tensor cores
constexpr uint32_t TURN_THREADS = 256;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
struct Cfg {
  // keys per K/V tile: S (BN / 2), O (DP / 2) and P (BN / 4) registers fit 160 a thread
  static constexpr int BN = DP <= 64 ? 128 : 64;
  // panel columns: 64 (128-byte rows, the widest TMA transfers) up to DP = 128, the last panel
  // partly unused when 64 does not divide DP (TMA zero-fills it, no product reads it); above
  // that, the narrower panels that divide DP, so that the ring keeps two stages.
  static constexpr int W = DP <= 128 ? 64 : DP % 32 == 0 ? 32 : 16;
  static constexpr int PANELS = (DP + W - 1) / W;
  static constexpr int SPAN = W * 2;  // bytes of one panel row = the swizzle span
  static constexpr int Q_PANEL = BM * SPAN;
  static constexpr int KV_PANEL = BN * SPAN;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int FIT = (232448 - 1024 - 256 - 2 * Q_BYTES) / STAGE_BYTES;  // of 227 KB
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  // 1024 bytes of alignment slack, two Q buffers, the ring, then the mbarriers
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + size_t(STAGES) * STAGE_BYTES + 256;
  static_assert(STAGES >= 2, "the K/V ring needs two stages");
};

// Online softmax of one 64 x BN score tile held in wgmma accumulator registers: rows r (i = 0)
// and r + 8 (i = 1) of this thread, a row spread over one lane quad. Keys at or past `valid`
// are masked (zero-filled by TMA past S). Leaves the probabilities in s, updates m and l, and
// returns in corr the factor that rescales the accumulator (0 on the first tile).
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], float scale_log2, int valid,
                                             int t) {
  if (valid < 2 * NS) {
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * n + 2 * t + e >= valid) s[4 * n + e] = s[4 * n + 2 + e] = -INFINITY;
  }
  // both rows at once, each max and sum in four partial chains: a consumer warp shares its
  // scheduler with two others, so short dependency chains are what keeps the exp unit fed
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[i][c] = -INFINITY;
      sum[i][c] = 0.0f;
    }
#pragma unroll
  for (int n = 0; n < NS / 4; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mx[i][n % 4] = fmaxf(mx[i][n % 4], fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
  float mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_run[i], m);
    corr[i] = ex2((m_run[i] - m_new) * scale_log2);  // 0 on the first tile
    m_run[i] = m_new;
    mb[i] = m_new * scale_log2;
  }
#pragma unroll
  for (int n = 0; n < NS / 4; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = ex2(fmaf(s[4 * n + 2 * i + e], scale_log2, -mb[i]));
        s[4 * n + 2 * i + e] = pe;
        sum[i][n % 4] += pe;  // the row sum is taken before the cast, as the TPU kernel does
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l_run[i] = l_run[i] * corr[i] + ((sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]));
}

// The probabilities as bf16 A fragments of the P V wgmma: k16 step kk is accumulator columns
// [16 kk, 16 kk + 16), which is exactly the register A layout.
template <int KP>
__device__ __forceinline__ void pack_p(uint32_t (&p)[KP][4], const float (&s)[KP * 8]) {
#pragma unroll
  for (int kk = 0; kk < KP; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// Persistent: each block walks work items item = blockIdx.x + i * gridDim.x, an item being one
// 192-row q block of one head.
template <int DP>
__global__ void __launch_bounds__(THREADS_WG, 1)
attention_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int s_len, int d,
                int n_items, float scale_log2) {
  using C = Cfg<DP>;
  using namespace hopper;
  constexpr int BN = C::BN;
  constexpr int NS = BN / 2;  // S accumulators a thread
  constexpr int NO = DP / 2;  // O accumulators a thread
  constexpr int KQ = DP / 16;  // k16 steps of Q K^T
  constexpr int KP = BN / 16;  // k16 steps of P V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = Qs + 2 * C::Q_BYTES;  // stage st: K tile, then V tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);  // [2]
  uint64_t* q_empty = q_full + 2;                                                    // [2]
  uint64_t* full = q_full + 4;
  uint64_t* empty = full + C::STAGES;

  // warp-uniform by construction, so the compiler sees the role branches as non-divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int n_tiles = (s_len + BN - 1) / BN;
  const int q_blocks = (s_len + BM - 1) / BM;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, CONSUMER_WARPS);
    }
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int g = 0;  // K/V tiles issued so far: the ring position
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / q_blocks, q0 = (item % q_blocks) * BM;
        // Q is double-buffered: item it's Q goes where item it-2's was, so the copies of this
        // item's Q and first K/V tiles never wait for the previous item's last Q K^T
        const int qb = it & 1;
        mbar_wait(q_empty + qb, ((it >> 1) & 1) ^ 1);  // passes at once for the first two items
        mbar_arrive_expect_tx(q_full + qb, C::Q_BYTES);
        for (int p = 0; p < C::PANELS; ++p)
          tma_load_3d(Qs + qb * C::Q_BYTES + p * C::Q_PANEL, &tm_q, p * C::W, q0, bh,
                      q_full + qb);
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int st = g % C::STAGES;
          mbar_wait(empty + st, ((g / C::STAGES) & 1) ^ 1);  // passes at once on the first round
          mbar_arrive_expect_tx(full + st, C::STAGE_BYTES);
          unsigned char* kt = ring + st * C::STAGE_BYTES;
          for (int p = 0; p < C::PANELS; ++p) {
            tma_load_3d(kt + p * C::KV_PANEL, &tm_k, p * C::W, j * BN, bh, full + st);
            tma_load_3d(kt + C::KV_BYTES + p * C::KV_PANEL, &tm_v, p * C::W, j * BN, bh,
                        full + st);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    // a consumer warpgroup: 64 q rows; this thread holds rows 16 (warp % 4) + g and + 8 of them
    const int c = warp / 4;
    const int g8 = lane / 4, t = lane % 4;
    auto desc_kmajor = [](const unsigned char* panel0, int panel_bytes, int kk) {
      return make_desc(panel0 + (kk * 16 / C::W) * panel_bytes + (kk * 16 % C::W) * 2, 16,
                       8 * C::SPAN, C::SPAN);
    };
    auto desc_v = [](const unsigned char* vt, int kk) {
      return make_desc(vt + kk * 16 * C::SPAN, C::KV_PANEL, 8 * C::SPAN, C::SPAN);
    };
    auto k_tile = [&](int g) { return ring + (g % C::STAGES) * C::STAGE_BYTES; };
    auto v_tile = [&](int g) { return ring + (g % C::STAGES) * C::STAGE_BYTES + C::KV_BYTES; };
    auto release = [&](int g) {  // this warp is done with tile g's stage
      if (lane == 0) mbar_arrive(empty + g % C::STAGES);
    };
    // Named barrier 1 + c is consumer c's turn at the tensor cores, taken round the three. Each
    // turn hands the next one on, except consumer 2's very last turn (nothing follows).
    auto pass_turn = [&](bool last_of_block) {
      if (c != NWG - 1 || !last_of_block) named_arrive(BAR_TURN + (c + 1) % NWG, TURN_THREADS);
    };

    float s[NS], acc[NO];
    uint32_t p[KP][4];
    if (c == NWG - 1) named_arrive(BAR_TURN, TURN_THREADS);  // consumer 0 takes the first turn

    int g = 0;  // K/V tiles consumed so far: the ring position
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / q_blocks, q0 = (item % q_blocks) * BM;
      const bool last_item = item + gridDim.x >= n_items;
      float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f}, corr[2];
      const int qb = it & 1;
      const unsigned char* q_base = Qs + qb * C::Q_BYTES + 64 * c * C::SPAN;
      mbar_wait(q_full + qb, (it >> 1) & 1);

      // tile 0: S_0 = Q K_0^T
      mbar_wait(full + g % C::STAGES, (g / C::STAGES) & 1);
      named_sync(BAR_TURN + c, TURN_THREADS);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        WgmmaSS<BN>::mma(s, desc_kmajor(q_base, C::Q_PANEL, kk),
                         desc_kmajor(k_tile(g), C::KV_PANEL, kk), kk > 0);
      wgmma_commit();
      pass_turn(last_item && n_tiles == 1);
      wgmma_wait<0>();
      fence_regs(s);
      if (n_tiles == 1 && lane == 0) mbar_arrive(q_empty + qb);
      softmax_tile(s, m_run, l_run, corr, scale_log2, s_len, t);
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
      pack_p(p, s);

      // tile j: S_j = Q K_j^T issued together with O += P_{j-1} V_{j-1}; the softmax of S_j runs
      // while that P V is in flight
      for (int j = 1; j < n_tiles; ++j) {
        ++g;
        mbar_wait(full + g % C::STAGES, (g / C::STAGES) & 1);
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
        pass_turn(last_item && j == n_tiles - 1);
        wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
        fence_regs(s);
        if (j == n_tiles - 1 && lane == 0) mbar_arrive(q_empty + qb);  // the last read of Q
        softmax_tile(s, m_run, l_run, corr, scale_log2, s_len - j * BN, t);
        fence_regs(s);  // keeps the compiler from sinking the exps below the wait: they overlap
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
        pack_p(p, s);
      }

      // the last tile's P V, outside the turns: it overlaps the other consumer's products
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

      const int r = q0 + 64 * c + 16 * (warp % 4) + g8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float inv = 1.0f / quad_sum(l_run[i]);
        const int row = r + 8 * i;
        if (row < s_len) {  // rows past S (the last q block of a head) computed on zero rows
          bf16* orow = o + (size_t(bh) * s_len + row) * d;
#pragma unroll
          for (int n = 0; n < DP / 8; ++n) {
            const int col = 8 * n + 2 * t;
            if (col < d)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
          }
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        int d, float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::make_map_bf16(&tq, q, bh, s, d, BM, C::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tk, k, bh, s, d, C::BN, C::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tv, v, bh, s, d, C::BN, C::W);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const int n_items = (s + BM - 1) / BM * bh;
  const int grid = n_items < sm_count() ? n_items : sm_count();
  attention_wgmma<DP><<<grid, THREADS_WG, C::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o),
                                                             s, d, n_items, scale * LOG2E);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s,
                          int d, float scale, cudaStream_t st) {
  switch ((d + 15) / 16) {
    case 1: return launch_bf16<16>(q, k, v, o, bh, s, d, scale, st);
    case 2: return launch_bf16<32>(q, k, v, o, bh, s, d, scale, st);
    case 3: return launch_bf16<48>(q, k, v, o, bh, s, d, scale, st);
    case 4: return launch_bf16<64>(q, k, v, o, bh, s, d, scale, st);
    case 5: return launch_bf16<80>(q, k, v, o, bh, s, d, scale, st);
    case 6: return launch_bf16<96>(q, k, v, o, bh, s, d, scale, st);
    case 7: return launch_bf16<112>(q, k, v, o, bh, s, d, scale, st);
    case 8: return launch_bf16<128>(q, k, v, o, bh, s, d, scale, st);
    case 9: return launch_bf16<144>(q, k, v, o, bh, s, d, scale, st);
    case 10: return launch_bf16<160>(q, k, v, o, bh, s, d, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMAs, score tile and accumulator in shared memory
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int s_len, int d,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutF32 L = make_layout_f32(d, 1);
  const size_t head = size_t(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * BQ;
  load_tile_f32(reinterpret_cast<float*>(smem + L.q), L.ld_qkv, q + head + size_t(q0) * d, d);
  attend_f32(L, smem, 0, k + head, v + head, s_len, d, scale);
  __syncthreads();

  const float* Os = reinterpret_cast<const float*>(smem + L.o[0]);
  const float* Ls = reinterpret_cast<const float*>(smem + L.l[0]);
  float* out = o + head + size_t(q0) * d;
  for (int i = threadIdx.x; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i % d;
    out[i] = Os[r * L.ld_o + c] * (1.0f / Ls[r]);
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int s, int d,
                       float scale, cudaStream_t stream) {
  const LayoutF32 L = make_layout_f32(d, 1);
  cudaError_t err = cudaFuncSetAttribute(attention_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  attention_f32<<<dim3(s / BQ, bh), THREADS, L.total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, d, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (bh, s, d); dtype 0 = float32, 1 = bfloat16.
// Requires s % 64 == 0, d % 8 == 0, 0 < d <= 160, 0 < bh <= 65535.
int fused_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        int d, float scale, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % BQ != 0 || d <= 0 || d > 160 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(dispatch_bf16(q, k, v, o, bh, s, d, scale, st));
  if (dtype == 0) return static_cast<int>(launch_f32(q, k, v, o, bh, s, d, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
