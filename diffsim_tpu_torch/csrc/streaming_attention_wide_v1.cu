// K4's wide-head kernels in their first design, kept as the yardstick of
// streaming_attention_wide.cu's 2-block cluster design: chip_smoke.py alone builds this library
// and times its entry point streaming_attention_wide_v1_fwd beside the shipped kernel. It counts
// no launches and no path of the port calls it. softmax(Q K^T / sqrt(D)) V over (B*H, S, D) with
// 512 < D <= 1024 in both dtypes, and float32 at every D % 8 == 0 up to 1024.
//
// Replaces the same TPU kernel as streaming_attention.cu (`streaming_self_attention`,
// diffsim_tpu/ops/pallas/attention_stream.py, pallas_call in `_pallas_forward`), whose blocks
// are (1, bq, d) at any d, and keeps its contract: f32 logits, the row max over the UNSCALED
// logits with the scale folded into exp's operand, the probabilities cast to V's dtype for P V
// with f32 accumulation, acc / l after the last key tile. Its bf16_probs mode is a second
// instantiation of both paths (BF16P), rounding as streaming_attention.cu does: each probability
// by attention_common.cuh's prob_bf16x2, and the row sum of each float32 64-key tile, or of each
// bf16 consumer's 32 keys of a 64-key tile, to bf16 before it enters the f32 l (the same tiles
// as streaming_attention.cu, so chip_smoke.py's K4_SUM_TILE holds for both files).
//
// The trouble spot is the register file: a 64-row f32 output accumulator at D = 1024 is 256 KB,
// all of an SM's registers. So the output columns are split over blocks: a third grid axis
// takes 512-column halves of D (one half for D <= 512), and each block computes Q K^T over ALL of
// D, the online softmax of its rows and P V for its own half. The two blocks of a row block do
// the same Q K^T and softmax arithmetic on the same data in the same order, so their running
// max and sums are bit for bit the same. The cost is the recomputed Q K^T: 1.5x the products at
// D = 1024, which the cluster design of streaming_attention_wide.cu avoids.
//
// float32 (stream_f32_wide): 3xTF32 on mma.sync.m16n8k8, stream_f32_q64's arithmetic (operands
//   split into hi and lo TF32 parts at fragment load, a_lo b_hi + a_hi b_lo + a_hi b_hi, the
//   tensor cores' truncating f32 sums kept short: a fresh sum for each 64-column chunk of Q K^T
//   and for each 8-key chunk of P V, added into the running sums by rounded f32 adds). At D =
//   1024 a score takes 16 such chunks. Q no longer fits in shared memory (256 KB at D = 1024),
//   so it streams with K: stage (tile j, chunk c) brings Q's and K's columns [64 c, 64 c + 64)
//   of the 64-row q tile and the 64-key tile, a ring slot of two 64 x 72 panels; the last chunk
//   at D % 64 != 0 is copied and multiplied only up to D (its k8 steps stop there, no column
//   past D is read). Then 8 V chunks of 8 keys x the block's 512 columns (leading dim 516 = 4
//   mod 32: conflict-free B loads). 4 slots, cp.async three stages ahead, one barrier a stage.
//   Q K^T: warp w owns a 16 x 32 score tile; softmax in shared memory, 4 threads a row; P V:
//   warp w owns all 64 rows x columns [64 w, 64 w + 64) of the half (128 accumulator registers
//   a thread), its n8 tiles past D skipped. Shared memory 163 KB.
// bf16 (stream_wgmma_wide), 512 < D <= 1024: stream_wgmma's warp roles (a TMA producer
//   warpgroup, two consumer warpgroups that split the keys of Q K^T, 32 each, and the half's 512
//   output columns, 256 each as one m64n256 accumulator). Q (64 rows x 2 ceil(D / 128) panels of
//   64 columns, 128 KB at D = 1024) stays in shared memory, which leaves 5 ring slots of 16 KB;
//   a tile needs ceil(D / 128) K chunks (64 keys x 128 columns) and 4 V chunks (16 keys x the
//   half's 512 columns), up to 12 slots, so the slots cannot all be held at once as
//   stream_wgmma holds a stage's. Each chunk is instead awaited, multiplied (its wgmma group
//   committed and awaited at once) and released before the next: the products of a tile run
//   one chunk after the other, P V after the softmax, and the tensor cores idle while the
//   softmax runs. Columns past D are TMA's zero fill: their products add zeros and their
//   outputs are not stored.
// Other shapes are refused (cudaErrorInvalidValue).
//
// Bound on the H100: 4 S^2 D FLOP per head (the recomputed Q K^T not counted), bf16 at the 989
// TFLOP/s tensor-core peak (2.224 ms at (2, 1, 16384, 1024)), float32 three TF32 passes at 495
// TFLOP/s (13.33 ms there). See PERF.md for the measured share.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include "attention_wgmma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int HALF = 512;     // output columns of one block: a half of D
constexpr int MAX_D = 1024;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// the 3xTF32 fragments and products of attention_common.cuh
using attn::load_a_3xtf32;
using attn::mma_tf32;
using attn::mma_tf32_first;
using attn::split_tf32;

// ---------------------------------------------------------------------------
// float32: Q and K streamed in 64-column chunks, a 512-column half of the output a block
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;  // 8 warps
constexpr int Q64 = 64;       // q rows per block
constexpr int K64 = 64;       // keys per tile
constexpr int DC = 64;        // columns of a Q / K chunk
constexpr int VC = 8;         // keys of a V chunk
constexpr int LDC = DC + 8;   // leading dim of a Q / K chunk and of the score tile (8 mod 32)
constexpr int LDV = HALF + 4;  // leading dim of a V chunk (4 mod 32)
constexpr int SLOTS = 4;      // ring of stage buffers: 3 copies in flight behind the one in use
constexpr int PANEL_FLOATS = Q64 * LDC;
constexpr int SLOT_FLOATS = 2 * PANEL_FLOATS;  // a Q chunk and a K chunk, or a V chunk
static_assert(VC * LDV <= SLOT_FLOATS, "a V chunk must fit a ring slot");

__device__ inline void cp_async_wait_slots() {  // all but the SLOTS - 2 newest groups landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(SLOTS - 2));
}

// Shared memory (bytes): the stage ring, the score tile (row-major; the probabilities
// overwrite it in place) and the row statistics.
struct LayoutWide {
  size_t ring, s, m, l, c, total;
  __host__ __device__ LayoutWide() {
    size_t off = 0;
    ring = off; off = align128(off + size_t(SLOTS) * SLOT_FLOATS * 4);
    s = off; off = align128(off + size_t(Q64) * LDC * 4);
    m = off; off = align128(off + Q64 * 4);
    l = off; off = align128(off + Q64 * 4);
    c = off; off = align128(off + Q64 * 4);
    total = off;
  }
};

// Stage g of the block's sequence: each 64-key tile is nkc chunks (Q's and K's columns [64 st,
// 64 st + 64) cut at d, Q at the slot's start and K a panel further) then 8 V chunks (8 keys x
// the half's columns [c0, c0 + wh)), each copied with cp.async into ring slot g % SLOTS. One
// cp.async group per stage, empty past the end.
__device__ inline void issue_stage_wide(int g, int total, int n_stages, int nkc,
                                        const float* qh, const float* kh, const float* vh,
                                        int d, int c0, int wh, float* ring) {
  if (g < total) {
    const int tile = g / n_stages, st = g % n_stages;
    const int key0 = tile * K64;
    float* dst = ring + (g % SLOTS) * SLOT_FLOATS;
    if (st < nkc) {
      const int col0 = st * DC, vpr = min(DC, d - col0) / 4;  // float4 of a row up to d
      for (int i = threadIdx.x; i < 2 * K64 * (DC / 4); i += THREADS) {
        const int which = i / (K64 * (DC / 4));  // 0: Q, 1: K
        const int r = (i / (DC / 4)) % K64, c4 = i % (DC / 4);
        if (c4 < vpr) {
          const float* src = which ? kh + size_t(key0 + r) * d : qh + size_t(r) * d;
          attn::cp_async16(dst + which * PANEL_FLOATS + r * LDC + 4 * c4, src + col0 + 4 * c4);
        }
      }
    } else {  // rows of at most 128 float4 (wh <= 512)
      const float* src = vh + size_t(key0 + (st - nkc) * VC) * d + c0;
      for (int i = threadIdx.x; i < VC * (HALF / 4); i += THREADS) {
        const int r = i >> 7, c4 = i & 127;
        if (4 * c4 < wh) attn::cp_async16(dst + r * LDV + 4 * c4, src + size_t(r) * d + 4 * c4);
      }
    }
  }
  attn::cp_async_commit();
}

template <bool BF16P>
__global__ void __launch_bounds__(THREADS, 1)
stream_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int s_len, int d,
                float scale, float scale_bf16) {
  constexpr int MT = Q64 / 16;  // m16 tiles of P V a warp: all 64 rows
  constexpr int NT = 8;         // n8 tiles of P V a warp: 64 output columns
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutWide L;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* Ss = reinterpret_cast<float*>(smem + L.s);  // scores, then P, [row][key]
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* Ls = reinterpret_cast<float*>(smem + L.l);
  float* Cs = reinterpret_cast<float*>(smem + L.c);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t head = size_t(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * Q64;
  const int c0 = blockIdx.z * HALF;      // this block's output columns [c0, c0 + wh)
  const int wh = min(HALF, d - c0);
  const int nkc = (d + DC - 1) / DC;
  const int n_stages = nkc + K64 / VC;
  const int total = (s_len / K64) * n_stages;
  const float* qh = q + head + size_t(q0) * d;
  const float* kh = k + head;
  const float* vh = v + head;

  for (int i = tid; i < Q64; i += THREADS) {
    Ms[i] = -INFINITY;
    Ls[i] = 0.0f;
  }
  for (int gs = 0; gs < SLOTS - 1; ++gs)
    issue_stage_wide(gs, total, n_stages, nkc, qh, kh, vh, d, c0, wh, ring);

  const int mw = 16 * (warp % 4);  // Q K^T: this warp's 16 rows
  const int nw = 32 * (warp / 4);  // and its 32 keys of the score tile
  const int cb = 64 * warp;        // P V: this warp's 64 columns of the half, all 64 rows
  const bool pv_warp = cb < wh;    // warp-uniform: a narrow half leaves the last warps idle
  const int rs = tid / 4, qk = tid % 4;  // softmax: row rs, keys [16 qk, + 16)
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;
  float sacc[4][4];

  for (int gs = 0; gs < total; ++gs) {
    const int st = gs % n_stages;
    const float* chunk = ring + (gs % SLOTS) * SLOT_FLOATS;
    // stage gs has landed, and every thread is done with stage gs - 1, whose slot the copy of
    // stage gs + SLOTS - 1 reuses
    cp_async_wait_slots();
    __syncthreads();
    issue_stage_wide(gs + SLOTS - 1, total, n_stages, nkc, qh, kh, vh, d, c0, wh, ring);

    if (st < nkc) {
      // this chunk's columns of Q K^T, summed apart and then added to the scores: the tensor
      // cores' f32 sums truncate, so each running sum takes few of their additions
      const float* qc = chunk;
      const float* kc = chunk + PANEL_FLOATS;
      const int nks = min(DC, d - st * DC) / 8;  // k8 steps up to d
      float part[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll 2
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t ah[4], al[4];
        load_a_3xtf32(ah, al, qc, LDC, mw, 8 * ks, g, t);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float2 kp =
              *reinterpret_cast<const float2*>(kc + (nw + 8 * n + g) * LDC + 8 * ks + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kp.x, bh0, bl0);
          split_tf32(kp.y, bh1, bl1);
          mma_tf32(part[n], al, bh0, bh1);
          mma_tf32(part[n], ah, bl0, bl1);
          mma_tf32(part[n], ah, bh0, bh1);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = st == 0 ? part[n][e] : sacc[n][e] + part[n][e];
      if (st == nkc - 1) {
        // the tile's scores are complete: online softmax of row rs over keys [16 qk, +16)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float* srow = Ss + (mw + g) * LDC + nw + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(srow) = make_float2(sacc[n][0], sacc[n][1]);
          *reinterpret_cast<float2*>(srow + 8 * LDC) = make_float2(sacc[n][2], sacc[n][3]);
        }
        __syncthreads();
        float* srow = Ss + rs * LDC + 16 * qk;
        float x[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v4 = *reinterpret_cast<const float4*>(srow + 4 * i);
          x[4 * i] = v4.x;
          x[4 * i + 1] = v4.y;
          x[4 * i + 2] = v4.z;
          x[4 * i + 3] = v4.w;
        }
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j) mx = fmaxf(mx, x[j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_old = Ms[rs];
        const float m_new = fmaxf(m_old, mx);
        const float corr = expf((m_old - m_new) * scale);  // 0 on the first tile
        float sum = 0.0f;
        const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale_bf16);
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          if (BF16P) {
            const uint32_t pp = attn::prob_bf16x2(x[j], x[j + 1], m_new, scale2);
            x[j] = attn::bf16_lo(pp);
            x[j + 1] = attn::bf16_hi(pp);
          } else {
            x[j] = expf((x[j] - m_new) * scale);
            x[j + 1] = expf((x[j + 1] - m_new) * scale);
          }
          sum += x[j];
          sum += x[j + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (BF16P) sum = attn::round_bf16(sum);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(srow + 4 * i) =
              make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
        if (qk == 0) {
          Ms[rs] = m_new;
          Ls[rs] = Ls[rs] * corr + sum;
          Cs[rs] = corr;
        }
      }
    } else if (pv_warp) {
      // O[all rows, warp columns] += P V over this chunk's 8 keys (rescaled once per tile). Each
      // (m, n) tile's products go to a fresh sum that is then added in f32.
      const int vc = st - nkc;
      if (vc == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float c_lo = Cs[16 * m + g], c_hi = Cs[16 * m + g + 8];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            acc[m][n][0] *= c_lo;
            acc[m][n][1] *= c_lo;
            acc[m][n][2] *= c_hi;
            acc[m][n][3] *= c_hi;
          }
        }
      }
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) load_a_3xtf32(ah[m], al[m], Ss, LDC, 16 * m, vc * VC, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (cb + 8 * n >= wh) continue;  // columns past d (d % 8 == 0: whole n8 tiles)
        const int col = cb + 8 * n + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(chunk[2 * t * LDV + col], bh0, bl0);  // keys 2t and 2t + 1: the permuted k
        split_tf32(chunk[(2 * t + 1) * LDV + col], bh1, bl1);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float part[4];
          if (BF16P) {  // bf16 probabilities are exact in tf32: their low part is zero
            mma_tf32_first(part, ah[m], bl0, bl1);
          } else {
            mma_tf32_first(part, al[m], bh0, bh1);
            mma_tf32(part, ah[m], bl0, bl1);
          }
          mma_tf32(part, ah[m], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += part[e];
        }
      }
    }
  }
  __syncthreads();

  if (pv_warp) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float inv_lo = 1.0f / Ls[16 * m + g], inv_hi = 1.0f / Ls[16 * m + g + 8];
      float* o_lo = o + head + size_t(q0 + 16 * m + g) * d + c0;
      float* o_hi = o_lo + size_t(8) * d;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = cb + 8 * n + 2 * t;
        if (cb + 8 * n >= wh) continue;
        *reinterpret_cast<float2*>(o_lo + col) =
            make_float2(acc[m][n][0] * inv_lo, acc[m][n][1] * inv_lo);
        *reinterpret_cast<float2*>(o_hi + col) =
            make_float2(acc[m][n][2] * inv_hi, acc[m][n][3] * inv_hi);
      }
    }
  }
}

template <bool BF16P>
cudaError_t launch_f32_wide(const void* q, const void* k, const void* v, void* o, int bh, int s,
                            int d, float scale, cudaStream_t stream) {
  const size_t bytes = LayoutWide().total;
  cudaError_t err = cudaFuncSetAttribute(stream_f32_wide<BF16P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int halves = (d + HALF - 1) / HALF;
  stream_f32_wide<BF16P><<<dim3(s / Q64, bh, halves), THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, d, scale, attn::round_bf16(scale));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, a producer warpgroup and two consumer warpgroups that split the keys of
// Q K^T and the half's output columns; every chunk awaited, multiplied and released in turn
// ---------------------------------------------------------------------------

constexpr int BM = 64;                  // q rows per block
constexpr int BN = 64;                  // keys per tile
constexpr int NCW = 2;                  // consumer warpgroups
constexpr int SLICE = BN / NCW;         // keys of a tile whose scores one consumer computes
constexpr int OUT_COLS = HALF / NCW;    // output columns a consumer owns: one m64n256 product
constexpr int PANEL_COLS = 64;          // columns of a 128-byte swizzled panel
constexpr int KEY_PANEL = BN * 128;     // a panel of 64 rows: of Q, or of a K chunk
constexpr int V_KEYS = 16;              // keys of a V chunk: one k16 step of P V
constexpr int V_PANEL = V_KEYS * 128;   // a panel of a V chunk
constexpr int V_CHUNKS = BN / V_KEYS;   // V chunks a tile
constexpr int CHUNK = 2 * KEY_PANEL;    // a ring slot: a K chunk (64 keys x 128 columns) or a
                                        // V chunk (16 keys x the half's 512 columns)
constexpr int P_TILE = BM * BN * 2;     // a P tile: 64 rows x 64 keys, one swizzled panel
constexpr int CONSUMER_THREADS = NCW * 128;
constexpr int THREADS_WG = CONSUMER_THREADS + 128;  // + the producer warpgroup
// the producer gives its registers to the consumers: 128 x 24 + 256 x 240 <= 65536
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr uint32_t BAR_MAX = 1, BAR_P = 2;  // named barriers of the two consumers

// Shared memory: 1024 bytes of alignment slack, Q at D = 1024's 16 panels, the chunk ring, two P
// tiles, the row maxima and sums of both consumers, then the mbarriers.
constexpr int NP_MAX = MAX_D / PANEL_COLS;
constexpr int Q_BYTES = NP_MAX * KEY_PANEL;
constexpr int FIXED = 1024 + Q_BYTES + 2 * P_TILE + 2 * NCW * BM * 4 + 256;
constexpr int STAGES = (232448 - FIXED) / CHUNK;  // of 227 KB: 5
constexpr size_t SMEM = FIXED + size_t(STAGES) * CHUNK;
static_assert(STAGES >= 2, "the ring must hold two chunks");
static_assert(OUT_COLS == 256, "a consumer's columns are one m64n256 accumulator");

// The 8 k16 steps of a consumer's Q K^T over one K chunk: step kk reads columns 16 kk.. of the
// chunk (panel kk / 4, 32 (kk % 4) bytes into its rows), at the same offset in Q's panels and
// in the chunk's. The offsets are immediates of the wgmma asm (mma_at).
template <int KK>
__device__ __forceinline__ void qk_steps(float (&s)[SLICE / 2], uint64_t qd, uint64_t kd,
                                         bool first) {
  if constexpr (KK < 8) {
    hopper::WgmmaSS<SLICE>::mma_at<((KK / 4) * KEY_PANEL + (KK % 4) * 32) / 16>(
        s, qd, kd, first && KK == 0 ? 0 : 1);
    qk_steps<KK + 1>(s, qd, kd, first);
  }
}

template <bool BF16P>
__global__ void __launch_bounds__(THREADS_WG, 1)
stream_wgmma_wide(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int s_len,
                  int d, float scale_log2, float scale_bf16) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + Q_BYTES;                        // 1024-aligned slots
  unsigned char* ps = ring + STAGES * CHUNK;                 // [2][P_TILE]
  float* Mx = reinterpret_cast<float*>(ps + 2 * P_TILE);     // [NCW][BM] row maxima
  float* Lx = Mx + NCW * BM;                                 // [NCW][BM] row sums
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Lx + NCW * BM);
  uint64_t* full = q_full + 1;      // [STAGES]
  uint64_t* empty = full + STAGES;  // [STAGES]

  // warp-uniform by construction, so the compiler sees the role branches as non-divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int c0 = blockIdx.z * HALF;  // this block's output columns [c0, c0 + 512) cut at d
  const int n_tiles = s_len / BN;
  const int nkc = (d + 2 * PANEL_COLS - 1) / (2 * PANEL_COLS);  // K chunks a tile
  // Chunks come in the order the consumers take them: tile j's nkc K chunks, then its V
  // chunks. The ring position of chunk g of that sequence, and the parity of its slot's use:
  auto slot = [&](int g) { return ring + (g % STAGES) * CHUNK; };
  auto phase = [&](int g) { return uint32_t(g / STAGES) & 1u; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * NCW);  // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NCW) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 4 * NCW && lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      // Q's panels as far as the K chunks reach (the last may lie past d: TMA's zeros)
      mbar_arrive_expect_tx(q_full, 2 * nkc * KEY_PANEL);
      for (int p = 0; p < 2 * nkc; ++p)
        tma_load_3d(qs + p * KEY_PANEL, &tm_q, p * PANEL_COLS, q0, bh, q_full);
      for (int t = 0, g = 0; t < n_tiles; ++t) {
        for (int i = 0; i < nkc; ++i, ++g) {  // K: 64 keys x 128 columns
          uint64_t* bar = full + g % STAGES;
          mbar_wait(empty + g % STAGES, phase(g) ^ 1);  // passes at once on round 0
          mbar_arrive_expect_tx(bar, CHUNK);
          for (int p = 0; p < 2; ++p)
            tma_load_3d(slot(g) + p * KEY_PANEL, &tm_k, (2 * i + p) * PANEL_COLS, t * BN, bh,
                        bar);
        }
        for (int kk = 0; kk < V_CHUNKS; ++kk, ++g) {  // V: 16 keys x the half's columns
          uint64_t* bar = full + g % STAGES;
          mbar_wait(empty + g % STAGES, phase(g) ^ 1);
          mbar_arrive_expect_tx(bar, CHUNK);
          for (int p = 0; p < HALF / PANEL_COLS; ++p)
            tma_load_3d(slot(g) + p * V_PANEL, &tm_v, c0 + p * PANEL_COLS, t * BN + kk * V_KEYS,
                        bh, bar);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    // consumer c: the scores of keys [32 c, 32 c + 32) of every tile, and the output columns
    // [c0 + 256 c, c0 + 256 c + 256) of all 64 rows. This thread holds rows r0 and r0 + 8.
    const int c = warp / 4;
    const int r0 = 16 * (warp % 4) + lane / 4, t = lane % 4;
    const uint64_t q_desc = make_desc(qs, 16, 8 * 128, 128);  // Q's first panel

    float acc[OUT_COLS / 2];
#pragma unroll
    for (int i = 0; i < OUT_COLS / 2; ++i) acc[i] = 0.0f;
    float s[SLICE / 2], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f}, corr[2];

    mbar_wait(q_full, 0);
    int g = 0;  // the next chunk of the sequence
    for (int j = 0; j < n_tiles; ++j) {
      // S_j = Q K_j^T over all of D (A = Q, B = this consumer's 32 keys of K), one K chunk at a
      // time: each group is committed and awaited before the next chunk's mbarrier wait, so no
      // wgmma is in flight across a wait (ptxas serialises every product otherwise, C7518)
      for (int i = 0; i < nkc; ++i, ++g) {
        mbar_wait(full + g % STAGES, phase(g));
        wgmma_fence();
        qk_steps<0>(s, q_desc + 2 * i * KEY_PANEL / 16,
                    make_desc(slot(g) + c * SLICE * 128, 16, 8 * 128, 128), i == 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (lane == 0) mbar_arrive(empty + g % STAGES);
      }
      // The online softmax of tile j: the row maxima of both consumers' keys meet in shared
      // memory; each consumer takes the probabilities of its own keys and writes them to P tile
      // j % 2 in the layout TMA would give it (128-byte rows, 16-byte units swizzled by the row
      // mod 8). Two P tiles: a consumer writes tile j's while the other may still read tile
      // j - 1's in its P V.
      const int buf = j & 1;
      float mx[2], mb[2], sum[2];
      attn::tile_max(s, mx);
      if (t == 0) {
        Mx[c * BM + r0] = mx[0];
        Mx[c * BM + r0 + 8] = mx[1];
      }
      named_sync(BAR_MAX, CONSUMER_THREADS);
#pragma unroll
      for (int i = 0; i < 2; ++i) mx[i] = fmaxf(Mx[r0 + 8 * i], Mx[BM + r0 + 8 * i]);
      attn::update_max<BF16P>(m_run, mx, corr, mb, scale_log2);
      attn::tile_probs<BF16P>(s, mb, scale_log2, scale_bf16, sum);
#pragma unroll
      for (int i = 0; i < 2; ++i)  // the mode rounds each 32-key slice's row sum to bf16
        l_run[i] = l_run[i] * corr[i] +
                   (BF16P ? attn::round_bf16(attn::quad_sum(sum[i])) : sum[i]);
      unsigned char* pt = ps + buf * P_TILE;
#pragma unroll
      for (int n = 0; n < SLICE / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(pt + (r0 + 8 * i) * 128 +
                                       (((SLICE / 8 * c + n) ^ (r0 % 8)) << 4) + 4 * t) =
              attn::p_pair<BF16P>(s, 4 * n + 2 * i);
      fence_proxy_async();  // P V reads the tile through the async proxy
      // O rescaled for tile j (no P V in flight), then P of all 64 keys is in place
#pragma unroll
      for (int n = 0; n < OUT_COLS / 8; ++n) {
        acc[4 * n] *= corr[0];
        acc[4 * n + 1] *= corr[0];
        acc[4 * n + 2] *= corr[1];
        acc[4 * n + 3] *= corr[1];
      }
      named_sync(BAR_P, CONSUMER_THREADS);
      // O += P_j V_j: A = P, K-major, B = this consumer's V columns, N-major, one k16 step a
      // V chunk. Columns past D hold TMA's zeros and are never stored.
      for (int kk = 0; kk < V_CHUNKS; ++kk, ++g) {
        mbar_wait(full + g % STAGES, phase(g));
        wgmma_fence();
        WgmmaSST<OUT_COLS>::mma(acc, make_desc(pt + kk * 32, 16, 8 * 128, 128),
                                make_desc(slot(g) + 4 * c * V_PANEL, V_PANEL, 8 * 128, 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + g % STAGES);
      }
    }

    // l = the two consumers' row sums; out = acc / l in bf16
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = BF16P ? l_run[i] : attn::quad_sum(l_run[i]);
      if (t == 0) Lx[c * BM + r0 + 8 * i] = l;
    }
    named_sync(BAR_MAX, CONSUMER_THREADS);
#pragma unroll
    for (int i = 0; i < 2; ++i) inv[i] = 1.0f / (Lx[r0 + 8 * i] + Lx[BM + r0 + 8 * i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* orow = o + (size_t(bh) * s_len + q0 + r0 + 8 * i) * d;
#pragma unroll
      for (int n = 0; n < OUT_COLS / 8; ++n) {
        const int col = c0 + OUT_COLS * c + 8 * n + 2 * t;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[4 * n + 2 * i] * inv[i], acc[4 * n + 2 * i + 1] * inv[i]);
      }
    }
  }
}

// d % 8 == 0, 512 < d <= 1024
template <bool BF16P>
cudaError_t launch_bf16_wide(const void* q, const void* k, const void* v, void* o, int bh, int s,
                             int d, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::make_map_bf16(&tq, q, bh, s, d, BM, PANEL_COLS);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tk, k, bh, s, d, BN, PANEL_COLS);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tv, v, bh, s, d, V_KEYS, PANEL_COLS);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stream_wgmma_wide<BF16P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const int halves = (d + HALF - 1) / HALF;
  stream_wgmma_wide<BF16P><<<dim3(s / BM, bh, halves), THREADS_WG, SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), s, d, scale * LOG2E, attn::round_bf16(scale));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (bh, s, d); dtype 0 = float32, 1 = bfloat16; bf16_probs 0 or 1;
// 0 < bh <= 65535, s % 64 == 0, d % 8 == 0, d <= 1024; bfloat16 requires d > 512 (narrower
// bf16 heads are streaming_attention.cu's).
int streaming_attention_wide_v1_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                                    int s, int d, float scale, int dtype, int bf16_probs,
                                    void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % 64 || d <= 0 || d % 8 || d > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(bf16_probs ? launch_f32_wide<true>(q, k, v, o, bh, s, d, scale, st)
                                       : launch_f32_wide<false>(q, k, v, o, bh, s, d, scale, st));
  if (dtype == 1 && d > HALF)
    return static_cast<int>(bf16_probs ? launch_bf16_wide<true>(q, k, v, o, bh, s, d, scale, st)
                                       : launch_bf16_wide<false>(q, k, v, o, bh, s, d, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
