// K4: streaming self-attention for wide heads, softmax(Q K^T / sqrt(D)) V over (B*H, S, D) with
// D <= 512 and long S: the VAE mid attention of a 1024 px encode, (B, 1, 16384, 512).
//
// Replaces the TPU kernel `streaming_self_attention` (diffsim_tpu/ops/pallas/attention_stream.py,
// body `_kernel`, pallas_call in `_pallas_forward`): an online softmax over K/V blocks with f32
// running max m, sum l and accumulator, the max over the UNSCALED logits with the scale folded
// into exp's operand, the probabilities cast to V's dtype for the PV product (f32
// accumulation), and acc / l after the last block. This kernel keeps that contract, and its
// bf16_probs mode (--bf16_softmax, attention_stream.py:62-73) is a second instantiation of both
// paths (BF16P): each probability is rounded as attention_common.cuh's prob_bf16x2 does (the
// centred logit, its product with the bf16-rounded scale and the exponential, each to bf16), and
// the row sum of each key tile's rounded probabilities is rounded to bf16 before it enters the
// f32 l; the rescaling factor, l and the accumulator stay f32. The TPU kernel rounds the row sum
// of 256-key blocks, this one of its own 64-key tiles (float32) or of each consumer's 32 keys of
// a 64-key tile (bf16). In float32 the probabilities then have no low TF32 part, so P V takes two
// TF32 products instead of three.
//
// The trouble spot is D = 512: a 64-row f32 accumulator is 128 KB and one f32 K tile of 64
// keys another 128 KB, against the 227 KB a block may use. The output accumulator therefore
// lives in registers, spread over the warps ALONG D, never in shared memory, and 8 warps
// share each K/V tile.
//
// float32 (the SDXL main path, whose VAE encodes in f32): 3xTF32 on the tensor cores
//   (mma.sync.m16n8k8.tf32; PERF.md says why not wgmma). Each float32 operand is split where its
//   fragment is loaded, hi = tf32(x) rounded to nearest, lo = x - hi, and each product is
//   a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation: the dropped a_lo b_lo term is
//   ~2^-22 relative, near float32's own rounding, while one TF32 pass (2^-11) would miss the
//   1e-5 check against the plain version. The tensor cores' f32 sums truncate instead of
//   rounding, a bias that grows with every step summed into one accumulator (2048 k8 steps in
//   a 16384-key row); so every product sum is kept short (one 64-column chunk of Q K^T, one
//   8-key chunk of P V) and then added into the running sums with rounded f32 adds.
//   D % 64 == 0, D <= 512, S % 64 == 0 (stream_f32_q64): a 64-row q tile whose Q stays in
//   shared memory (132 KB at D = 512) and 64-key tiles. K streams in 64 x 64 chunks along D,
//   then V in 8-key chunks (one k8 step of P V), through a ring of 4 chunk buffers filled by
//   cp.async three chunks ahead, with one barrier per chunk. Q K^T: warp w owns a 16 x 32
//   score tile (rows 16 (w % 4), keys 32 (w / 4)) over all of D; the tile's scores meet in
//   shared memory for the softmax (4 threads a row), which writes P back in place. P V: warp w
//   owns all 64 rows and output columns [64 w, 64 w + 64): 32 m16n8 accumulator tiles, 128
//   registers a thread, so each V value is loaded and split by one warp only, and each B
//   fragment feeds 4 x 3 products. With each k8 step's k order permuted, a thread's A and K
//   values come as 8-byte loads, and every fragment load is conflict-free (leading dims = 8
//   mod 32 for Q, K and P, 4 mod 32 for V).
// bf16 (SDXL with --xl_vae_bf16, SD-1.5 at 768 px and more), D % 8 == 0, D <= 512, S % 64 == 0
//   (stream_wgmma, sm_90a): wgmma + TMA in the shape of attention_wgmma.cuh's pipeline, whose
//   softmax pieces it reuses (tile_max, update_max, tile_probs, p_pair). A block of 64 q rows
//   has two consumer warpgroups and a producer warpgroup that gives them its registers
//   (setmaxnreg: 24 a thread for it, 240 for them). The grid is (S / 64, B H), one block an SM.
//   * Why this shape. A 64-row f32 accumulator at D = 512 is 128 KB, half of the SM's
//     registers, so no block can hold more than 64 rows; the output columns are split over the
//     consumers (256 each, one m64n256 accumulator, 128 registers a thread). Each consumer then
//     needs the whole probability tile for its columns, and computes the scores of half of the
//     keys: consumer c takes keys [32 c, 32 c + 32) of each 64-key tile over all of D (wgmma
//     m64n32k16, A = Q and B = K both from shared memory, 8 k16 steps a K chunk, the steps'
//     descriptor offsets immediates of the asm: WgmmaSS<32>::mma_at), so no product is done
//     twice.
//   * Meeting. The consumers' row maxima meet in shared memory (named barrier 1), so both take
//     one running max; each writes its bf16 P slice into a 64 x 64 P tile in the 128-byte
//     swizzled layout, and after named barrier 2 both run P V as wgmma m64n256k16 with A = P
//     and B = their V columns, N-major as TMA writes them (the transposed descriptor), both
//     from shared memory. Two P tiles alternate, so a tile's P is written while the P V of the
//     one before reads the other. The row sums stay each consumer's own (in the mode, each
//     32-key slice's sum is rounded to bf16) and meet once, after the last tile.
//   * Copies. Q (64 rows x D, up to 64 KB) loads once. K and V stream through a ring of 16 KB
//     slots (9 at D = 512: 224 KB of shared memory with Q and P), each guarded by a "full" and
//     an "empty" mbarrier, in the order the consumers take them: stage j is tile j's K in
//     chunks of 64 keys x 128 columns (two 128-byte-swizzled panels), then tile j - 1's V in
//     chunks of 16 keys x all columns (one k16 step of P V). One instantiation, at D = 512's
//     eight 64-column panels: at a narrower D, TMA's zero fill supplies the columns past D,
//     whose products add zeros and whose outputs are not stored (no model sends such a D).
//   * Order (attend_pass's): stage j issues S_j = Q K_j^T and then P_{j-1} V_{j-1}, and takes
//     the softmax of S_j while that P V runs. A stage's chunks are awaited before its first
//     product, and every product is issued and awaited outside any branch: ptxas serialises
//     every wgmma of a kernel that waits on an mbarrier between the products of one group or
//     awaits them on a conditional path (its C7518 report). It still reports C7511 (register
//     resources) for some products here: the consumers hold 128 accumulator registers.
//   * L2 traffic. Every block streams its head's whole K and V: 2 S D 2 bytes, 33.5 MB at
//     (S, D) = (16384, 512), 17.2 GB a (2, 1, 16384, 512) launch of 512 blocks; the first
//     design (attention_v2.cu, 32-row blocks) moved 34.4 GB. That is 64 FLOP per byte drawn
//     from L2, so at the rate the SMs can draw from L2 the copies alone take longer than the
//     products at the tensor cores' peak: the kernel is bound by its L2 traffic. A 2-block
//     cluster sharing each chunk by TMA multicast halves that traffic, but each slot then waits
//     for the consumers of both blocks (PERF.md: slower on the H100).
// Other shapes are refused (cudaErrorInvalidValue): no model of the repo gives them.
//
// Bound on the H100: 4*S^2*D FLOP per head against 4*S*D*itemsize bytes, thousands of FLOP per
// byte at S = 16384, so the kernel is bound by operations: for float32 three TF32 passes on the
// tensor cores, 3 x 4 S^2 D FLOP at 495 TFLOP/s (6.66 ms at (2, 1, 16384, 512); the FP32 SIMT
// peak of 67 TFLOP/s that bounded the CUDA-core version gives 16.4 ms); for bf16 the 989
// TFLOP/s tensor-core peak (1.112 ms at (2, 1, 16384, 512), 0.352 ms at (2, 1, 9216, 512)). The
// S^2 exponentials (about 3.9e12/s) weigh little at D = 512. See PERF.md for the measured share.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include "attention_wgmma.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr float LOG2E = 1.4426950408889634f;

// the 3xTF32 fragments and products of attention_common.cuh
using attn::load_a_3xtf32;
using attn::mma_tf32;
using attn::mma_tf32_first;
using attn::split_tf32;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Copy rows [0, rows) x columns [0, d) of a row-major (rows, d) f32 matrix into a tile of
// leading dimension ld with cp.async (d % 4 == 0).
__device__ inline void load_rows_f32(float* dst, int ld, const float* src, int rows, int d) {
  const int vpr = d / 4;
  for (int i = threadIdx.x; i < rows * vpr; i += THREADS) {
    const int r = i / vpr, c = (i % vpr) * 4;
    attn::cp_async16(dst + r * ld + c, src + size_t(r) * d + c);
  }
}

// ---------------------------------------------------------------------------
// float32, 64-row q tile (D % 64 == 0, D <= 512: the SDXL VAE's D = 512)
// ---------------------------------------------------------------------------

constexpr int Q64 = 64;      // q rows per block
constexpr int K64 = 64;      // keys per tile
constexpr int DC = 64;       // columns of one K chunk
constexpr int VC = 8;        // keys of one V chunk
constexpr int LDC = DC + 8;  // leading dim of a K chunk and of the score / probability tile
constexpr int SLOTS = 4;     // ring of chunk buffers: 3 copies in flight behind the one in use
constexpr int SLOT_FLOATS = K64 * LDC;  // one K chunk; one V chunk (8 x (d + 4)) fits for d <= 512

__device__ inline void cp_async_wait_slots() {  // all but the SLOTS - 2 newest groups landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(SLOTS - 2));
}

// Shared memory (bytes): the Q tile (leading dim d + 8), the chunk ring, the score tile
// (row-major; the probabilities overwrite it in place) and the row statistics.
struct LayoutQ64 {
  size_t q, ring, s, m, l, c, total;
  int ldq, ldv;
  __host__ __device__ LayoutQ64(int d) {
    ldq = d + 8;  // = 8 mod 32 for d % 64 == 0: float2 A loads are conflict-free
    ldv = d + 4;  // = 4 mod 32: the B loads of rows 2t and 2t + 1 are conflict-free
    size_t off = 0;
    q = off; off = align128(off + size_t(Q64) * ldq * 4);
    ring = off; off = align128(off + size_t(SLOTS) * SLOT_FLOATS * 4);
    s = off; off = align128(off + size_t(Q64) * LDC * 4);
    m = off; off = align128(off + Q64 * 4);
    l = off; off = align128(off + Q64 * 4);
    c = off; off = align128(off + Q64 * 4);
    total = off;
  }
};

// Stage g of the block's sequence: each 64-key tile is nkc K chunks (columns [64 st, 64 st +
// 64) of its 64 keys) then 8 V chunks (8 keys, all columns), each copied with cp.async into
// ring slot g % SLOTS. One cp.async group per stage, empty past the end.
__device__ inline void issue_stage_q64(int g, int total, int n_stages, int nkc, const float* kh,
                                       const float* vh, int d, int ldv, float* ring) {
  if (g < total) {
    const int tile = g / n_stages, st = g % n_stages;
    const int key0 = tile * K64;
    float* dst = ring + (g % SLOTS) * SLOT_FLOATS;
    if (st < nkc) {
      const float* src = kh + size_t(key0) * d + st * DC;
      for (int i = threadIdx.x; i < K64 * (DC / 4); i += THREADS) {
        const int r = i / (DC / 4), c = (i % (DC / 4)) * 4;
        attn::cp_async16(dst + r * LDC + c, src + size_t(r) * d + c);
      }
    } else {  // rows of at most 128 float4 (d <= 512): no integer division in the loop
      const float* src = vh + size_t(key0 + (st - nkc) * VC) * d;
      for (int i = threadIdx.x; i < VC * 128; i += THREADS) {
        const int r = i >> 7, c4 = i & 127;
        if (c4 < d / 4) attn::cp_async16(dst + r * ldv + 4 * c4, src + size_t(r) * d + 4 * c4);
      }
    }
  }
  attn::cp_async_commit();
}

template <bool BF16P>
__global__ void __launch_bounds__(THREADS, 1)
stream_f32_q64(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int s_len, int d,
               float scale, float scale_bf16) {
  constexpr int MT = Q64 / 16;  // m16 tiles of P V a warp: all 64 rows
  constexpr int NT = 8;         // n8 tiles of P V a warp: 64 output columns
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutQ64 L(d);
  const int ldq = L.ldq, ldv = L.ldv;
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* Ss = reinterpret_cast<float*>(smem + L.s);  // scores, then P, [row][key]
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* Ls = reinterpret_cast<float*>(smem + L.l);
  float* Cs = reinterpret_cast<float*>(smem + L.c);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t head = size_t(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * Q64;
  const int nkc = d / DC;
  const int n_stages = nkc + K64 / VC;
  const int total = (s_len / K64) * n_stages;
  const float* kh = k + head;
  const float* vh = v + head;

  for (int i = tid; i < Q64; i += THREADS) {
    Ms[i] = -INFINITY;
    Ls[i] = 0.0f;
  }
  load_rows_f32(Qs, ldq, q + head + size_t(q0) * d, Q64, d);  // in stage 0's group
  for (int gs = 0; gs < SLOTS - 1; ++gs)
    issue_stage_q64(gs, total, n_stages, nkc, kh, vh, d, ldv, ring);

  const int mw = 16 * (warp % 4);  // Q K^T: this warp's 16 rows
  const int nw = 32 * (warp / 4);  // and its 32 keys of the score tile
  const int cb = 64 * warp;        // P V: this warp's 64 output columns, all 64 rows
  const bool pv_warp = cb < d;     // warp-uniform: D < 512 leaves the last warps idle in P V
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
    issue_stage_q64(gs + SLOTS - 1, total, n_stages, nkc, kh, vh, d, ldv, ring);

    if (st < nkc) {
      // this chunk's 64 columns of Q K^T, summed apart and then added to the scores: the
      // tensor cores' f32 sums truncate, so each running sum takes few of their additions
      float part[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll 2
      for (int ks = 0; ks < DC / 8; ++ks) {
        uint32_t ah[4], al[4];
        load_a_3xtf32(ah, al, Qs, ldq, mw, st * DC + 8 * ks, g, t);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float2 kp =
              *reinterpret_cast<const float2*>(chunk + (nw + 8 * n + g) * LDC + 8 * ks + 2 * t);
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
      // (m, n) tile's three products go to a fresh sum that is then added in f32, again so that
      // the truncating tensor-core sums stay short.
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
        const int col = cb + 8 * n + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(chunk[2 * t * ldv + col], bh0, bl0);  // keys 2t and 2t + 1: the permuted k
        split_tf32(chunk[(2 * t + 1) * ldv + col], bh1, bl1);
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
      float* o_lo = o + head + size_t(q0 + 16 * m + g) * d;
      float* o_hi = o_lo + size_t(8) * d;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = cb + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(o_lo + col) =
            make_float2(acc[m][n][0] * inv_lo, acc[m][n][1] * inv_lo);
        *reinterpret_cast<float2*>(o_hi + col) =
            make_float2(acc[m][n][2] * inv_hi, acc[m][n][3] * inv_hi);
      }
    }
  }
}

template <bool BF16P>
cudaError_t launch_f32_q64(const void* q, const void* k, const void* v, void* o, int bh, int s,
                           int d, float scale, cudaStream_t stream) {
  const size_t bytes = LayoutQ64(d).total;
  cudaError_t err = cudaFuncSetAttribute(stream_f32_q64<BF16P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  stream_f32_q64<BF16P><<<dim3(s / Q64, bh), THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, d, scale, attn::round_bf16(scale));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, a producer warpgroup and two consumer warpgroups that split the keys of
// Q K^T and the output columns of P V
// ---------------------------------------------------------------------------

constexpr int BM = 64;                  // q rows per block
constexpr int BN = 64;                  // keys per tile
constexpr int NCW = 2;                  // consumer warpgroups
constexpr int SLICE = BN / NCW;         // keys of a tile whose scores one consumer computes
constexpr int OUT_COLS = 256;           // output columns a consumer owns: one m64n256 product
constexpr int PANEL_COLS = 64;          // columns of a 128-byte swizzled panel
constexpr int KEY_PANEL = BN * 128;     // a panel of 64 rows: of Q, or of a K chunk
constexpr int V_KEYS = 16;              // keys of a V chunk: one k16 step of P V
constexpr int V_PANEL = V_KEYS * 128;   // a panel of a V chunk
constexpr int CHUNK = 2 * KEY_PANEL;    // a ring slot: a K chunk (64 keys x 128 columns) or a
                                        // V chunk (16 keys x all columns, at most 8 panels)
constexpr int P_TILE = BM * BN * 2;     // a P tile: 64 rows x 64 keys, one swizzled panel
constexpr int CONSUMER_THREADS = NCW * 128;
constexpr int THREADS_WG = CONSUMER_THREADS + 128;  // + the producer warpgroup
// the producer gives its registers to the consumers: 128 x 24 + 256 x 240 <= 65536
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr uint32_t BAR_MAX = 1, BAR_P = 2;  // named barriers of the two consumers

// The tiling at D = 512 (8 panels of 64 columns), and the shared memory: 1024 bytes of
// alignment slack, Q, the chunk ring, two P tiles, the row maxima and sums of both consumers,
// then the mbarriers.
constexpr int NP = 8;                       // 64-column panels of D
constexpr int NKC = NP / 2;                 // K chunks a tile
constexpr int CHUNKS = NKC + BN / V_KEYS;   // ring slots a tile takes
constexpr int Q_BYTES = NP * KEY_PANEL;
constexpr int FIXED = 1024 + Q_BYTES + 2 * P_TILE + 2 * NCW * BM * 4 + 256;
constexpr int STAGES = (232448 - FIXED) / CHUNK;  // of 227 KB: 9
constexpr size_t SMEM = FIXED + size_t(STAGES) * CHUNK;
// a consumer holds tile j - 1's V chunks while it waits for tile j's K chunks
static_assert(STAGES >= CHUNKS, "the ring must hold a tile's chunks");

// The k16 steps [KK, STEPS) of a consumer's Q K^T over one K chunk: step kk reads columns
// 16 kk.. of the chunk (panel kk / 4, 32 (kk % 4) bytes into its rows), at the same offset in
// Q's panels and in the chunk's. The offsets are immediates of the wgmma asm (mma_at).
template <int KK, int STEPS>
__device__ __forceinline__ void qk_steps(float (&s)[SLICE / 2], uint64_t qd, uint64_t kd,
                                         bool first) {
  if constexpr (KK < STEPS) {
    hopper::WgmmaSS<SLICE>::mma_at<((KK / 4) * KEY_PANEL + (KK % 4) * 32) / 16>(
        s, qd, kd, first && KK == 0 ? 0 : 1);
    qk_steps<KK + 1, STEPS>(s, qd, kd, first);
  }
}

template <bool BF16P>
__global__ void __launch_bounds__(THREADS_WG, 1)
stream_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int s_len, int d,
             float scale_log2, float scale_bf16) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + Q_BYTES;
  unsigned char* ps = ring + STAGES * CHUNK;                 // [2][P_TILE]
  float* Mx = reinterpret_cast<float*>(ps + 2 * P_TILE);          // [NCW][BM] row maxima
  float* Lx = Mx + NCW * BM;                                      // [NCW][BM] row sums
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Lx + NCW * BM);
  uint64_t* full = q_full + 1;       // [STAGES]
  uint64_t* empty = full + STAGES;  // [STAGES]

  // warp-uniform by construction, so the compiler sees the role branches as non-divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int n_tiles = s_len / BN;
  // Chunks come in the order the consumers take them: stage t is tile t's K chunks (t < n_tiles)
  // and then tile t - 1's V chunks (t > 0). The ring position of chunk g of that sequence, and
  // the parity of its slot's use:
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
      mbar_arrive_expect_tx(q_full, Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load_3d(qs + p * KEY_PANEL, &tm_q, p * PANEL_COLS, q0, bh, q_full);
      for (int t = 0, g = 0; t <= n_tiles; ++t) {
        for (int i = 0; t < n_tiles && i < NKC; ++i, ++g) {  // K: 64 keys x 128 columns
          uint64_t* bar = full + g % STAGES;
          mbar_wait(empty + g % STAGES, phase(g) ^ 1);  // passes at once on round 0
          mbar_arrive_expect_tx(bar, CHUNK);
          for (int p = 0; p < 2; ++p)
            tma_load_3d(slot(g) + p * KEY_PANEL, &tm_k, (2 * i + p) * PANEL_COLS, t * BN, bh,
                        bar);
        }
        for (int kk = 0; t > 0 && kk < BN / V_KEYS; ++kk, ++g) {  // V: 16 keys x all columns
          uint64_t* bar = full + g % STAGES;
          mbar_wait(empty + g % STAGES, phase(g) ^ 1);
          mbar_arrive_expect_tx(bar, NP * V_PANEL);
          for (int p = 0; p < NP; ++p)
            tma_load_3d(slot(g) + p * V_PANEL, &tm_v, p * PANEL_COLS, (t - 1) * BN + kk * V_KEYS,
                        bh, bar);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    // consumer c: the scores of keys [32 c, 32 c + 32) of every tile, and the output columns
    // [256 c, 256 c + 256) of all 64 rows. This thread holds rows r0 and r0 + 8.
    const int c = warp / 4;
    const int r0 = 16 * (warp % 4) + lane / 4, t = lane % 4;
    auto release = [&](int g) {  // this warp is done with chunk g's slot
      if (lane == 0) mbar_arrive(empty + g % STAGES);
    };
    const uint64_t q_desc = make_desc(qs, 16, 8 * 128, 128);  // Q's first panel

    float acc[OUT_COLS / 2];
#pragma unroll
    for (int i = 0; i < OUT_COLS / 2; ++i) acc[i] = 0.0f;
    float s[SLICE / 2], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f}, corr[2];

    // the chunks at ring positions g.. g + n - 1 have landed
    auto wait_chunks = [&](int g, int n) {
      for (int i = 0; i < n; ++i) mbar_wait(full + (g + i) % STAGES, phase(g + i));
    };
    // S_j = Q K_j^T over all of D (A = Q, B = this consumer's 32 keys of K), from tile j's K
    // chunks at ring positions k0..
    auto issue_s = [&](int k0) {
#pragma unroll
      for (int i = 0; i < NKC; ++i) {
        const uint64_t kd = make_desc(slot(k0 + i) + c * SLICE * 128, 16, 8 * 128, 128);
        qk_steps<0, 8>(s, q_desc + 2 * i * KEY_PANEL / 16, kd, i == 0);
      }
      wgmma_commit();
    };
    // O += P V from P tile `buf` and a tile's V chunks at ring positions v0.. (O already
    // rescaled): A = P, K-major, B = this consumer's V columns, N-major. Columns past D hold
    // TMA's zeros and are never stored.
    auto issue_pv = [&](int v0, int buf) {
#pragma unroll
      for (int kk = 0; kk < BN / V_KEYS; ++kk)
        WgmmaSST<OUT_COLS>::mma(
            acc, make_desc(ps + buf * P_TILE + kk * 32, 16, 8 * 128, 128),
            make_desc(slot(v0 + kk) + 4 * c * V_PANEL, V_PANEL, 8 * 128, 128), 1);
      wgmma_commit();
    };
    // After S_j has landed: release its K chunks, and take the online softmax of tile j. The
    // row maxima of both consumers' keys meet in shared memory; each consumer then takes the
    // probabilities of its own keys and writes them to P tile `buf` in the layout TMA would
    // give it (128-byte rows, 16-byte units swizzled by the row mod 8: the pairs of a warp's
    // store fall in 32 banks). Two P tiles: tile j's is written while P_{j-1} V_{j-1} reads
    // the other.
    auto softmax = [&](int k0, int buf) {
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < NKC; ++i) release(k0 + i);
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
    };
    // After P V has landed: rescale O for the next one; then P is complete.
    auto next_p = [&]() {
#pragma unroll
      for (int n = 0; n < OUT_COLS / 8; ++n) {
        acc[4 * n] *= corr[0];
        acc[4 * n + 1] *= corr[0];
        acc[4 * n + 2] *= corr[1];
        acc[4 * n + 3] *= corr[1];
      }
      named_sync(BAR_P, CONSUMER_THREADS);  // P of all 64 keys is in place
    };
    auto pv_landed = [&](int v0) {
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BN / V_KEYS; ++kk) release(v0 + kk);
    };

    mbar_wait(q_full, 0);
    // Stage 0: S_0 alone. Stage j: S_j issued and then P_{j-1} V_{j-1}, the softmax of S_j
    // while that P V runs (attention_wgmma.cuh attend_pass's order). Stage n_tiles: the last
    // P V. A stage's chunks are awaited before its first product, and each wgmma is issued and
    // waited for outside any branch: ptxas serialises every product of a kernel whose waits it
    // cannot place (C7518), as with an mbarrier's spin loop between the products of one group.
    wait_chunks(0, NKC);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    softmax(0, 0);
    next_p();
    int g = NKC;  // stage j's first chunk: K chunks of tile j, then V chunks of tile j - 1
    for (int j = 1; j < n_tiles; ++j) {
      wait_chunks(g, CHUNKS);
      wgmma_fence();
      issue_s(g);
      issue_pv(g + NKC, (j - 1) & 1);
      wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
      softmax(g, j & 1);
      pv_landed(g + NKC);
      next_p();
      g += CHUNKS;
    }
    wait_chunks(g, BN / V_KEYS);
    wgmma_fence();
    issue_pv(g, (n_tiles - 1) & 1);
    pv_landed(g);

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
        const int col = OUT_COLS * c + 8 * n + 2 * t;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[4 * n + 2 * i] * inv[i], acc[4 * n + 2 * i + 1] * inv[i]);
      }
    }
  }
}

// d % 8 == 0, d <= 512
template <bool BF16P>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        int d, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::make_map_bf16(&tq, q, bh, s, d, BM, PANEL_COLS);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tk, k, bh, s, d, BN, PANEL_COLS);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tv, v, bh, s, d, V_KEYS, PANEL_COLS);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stream_wgmma<BF16P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  stream_wgmma<BF16P><<<dim3(s / BM, bh), THREADS_WG, SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), s, d, scale * LOG2E, attn::round_bf16(scale));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (bh, s, d); dtype 0 = float32, 1 = bfloat16; bf16_probs 0 or 1;
// 0 < bh <= 65535, d <= 512, s % 64 == 0. float32 requires d % 64 == 0; bfloat16 d % 8 == 0.
int streaming_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh, int s,
                            int d, float scale, int dtype, int bf16_probs, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || d <= 0 || d > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && s % Q64 == 0 && d % DC == 0)
    return static_cast<int>(bf16_probs ? launch_f32_q64<true>(q, k, v, o, bh, s, d, scale, st)
                                       : launch_f32_q64<false>(q, k, v, o, bh, s, d, scale, st));
  if (dtype == 1 && s % BM == 0 && d % 8 == 0)
    return static_cast<int>(bf16_probs ? launch_bf16<true>(q, k, v, o, bh, s, d, scale, st)
                                       : launch_bf16<false>(q, k, v, o, bh, s, d, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
