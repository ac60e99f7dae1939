// K4: streaming self-attention for wide heads, softmax(Q K^T / sqrt(D)) V over (B*H, S, D) with
// D <= 512 and long S: the VAE mid attention of a 1024 px encode, (B, 1, 16384, 512).
//
// Replaces the TPU kernel `streaming_self_attention` (diffsim_tpu/ops/pallas/attention_stream.py,
// body `_kernel`, pallas_call in `_pallas_forward`): an online softmax over K/V blocks with f32
// running max m, sum l and accumulator, the max over the UNSCALED logits with the scale folded
// into exp's operand, the probabilities cast to V's dtype for the PV product (f32
// accumulation), and acc / l after the last block. This kernel keeps that contract, and its
// bf16_probs mode (--bf16_softmax, attention_stream.py:62-73) is a second instantiation of both
// paths (BF16P): each probability is rounded as attention_common.cuh's prob_bf16 does (the
// centred logit, its product with the bf16-rounded scale and the exponential, each to bf16), and
// each tile's row sum of the rounded probabilities is rounded to bf16 before it enters the f32
// l; the rescaling factor, l and the accumulator stay f32. The TPU kernel rounds the row sum of
// 256-key blocks, this one of its own 64-key (float32) or 32-key (bf16) tiles. In float32 the
// probabilities then have no low TF32 part, so P V takes two TF32 products instead of three.
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
// bf16 (vae_fp32=False), D % 8 == 0, D <= 512, S % 32 == 0 (stream_bf16): mma.sync.m16n8k16
//   with f32 accumulation, a 32-row q tile and 32-key K/V tiles, one Q, K and V tile in shared
//   memory. Warp w computes one 16 x 8 tile of the 32 x 32 scores over all of D (A from Q, B
//   from K via ldmatrix); 8 threads per row take the softmax and write bf16 probabilities;
//   then warp w owns the output columns [w D/8, (w + 1) D/8) of all 32 rows and accumulates
//   P V there in registers. D is padded to 512 with zero columns in shared memory. The next K
//   tile is copied (cp.async) while this tile's PV product runs, and the next V tile while
//   the next QK^T product runs, so every copy overlaps math without a second buffer.
// Other shapes are refused (cudaErrorInvalidValue): no model of the repo gives them.
//
// Bound on the H100: 4*S^2*D FLOP per head against 4*S*D*itemsize bytes, thousands of FLOP per
// byte at S = 16384, so the kernel is bound by operations: for float32 three TF32 passes on the
// tensor cores, 3 x 4 S^2 D FLOP at 495 TFLOP/s (6.66 ms at (2, 1, 16384, 512); the FP32 SIMT
// peak of 67 TFLOP/s that bounded the CUDA-core version gives 16.4 ms); for bf16 the 989
// TFLOP/s tensor-core peak. The S^2 exponentials (about 3.9e12/s) weigh little at D = 512. See
// PERF.md for the measured share.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include "attention_common.cuh"

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
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          x[j] = BF16P ? attn::prob_bf16(x[j], m_new, scale_bf16) : expf((x[j] - m_new) * scale);
          sum += x[j];
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
// bf16: mma.sync, output columns spread over the warps
// ---------------------------------------------------------------------------

constexpr int BQB = 32, BKB = 32;  // q rows and keys per tile
constexpr int DP = 512;            // head dim, padded with zero columns
constexpr int LDS = BKB + 1;       // score tile, f32
constexpr int LDPB = BKB + 8;      // probability tile, bf16 (16-byte row pad for ldmatrix)

__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return align128(size_t(BQB + 2 * BKB) * (DP + 8) * 2) + align128(size_t(BQB) * LDS * 4) +
         align128(size_t(BQB) * LDPB * 2) + 3 * align128(BQB * 4);
}

template <int LD>
__device__ inline void load_rows_bf16(bf16* dst, const bf16* src, int rows, int d) {
  const int cpr = d / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * 8;
    attn::cp_async16(dst + r * LD + c, src + size_t(r) * d + c);
  }
}

template <bool BF16P>
__global__ void __launch_bounds__(THREADS)
stream_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            bf16* __restrict__ o, int s_len, int d, float scale_log2, float scale_bf16) {
  constexpr int LD = DP + 8;
  constexpr int CW = DP / 8;   // output columns per warp
  constexpr int NTW = CW / 8;  // n8 tiles per warp
  constexpr int TPR = THREADS / BQB, KPT = BKB / TPR;
  static_assert(CW % 16 == 0, "a warp's columns are whole k16 steps of ldmatrix.trans");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQB * LD;
  bf16* Vs = Ks + BKB * LD;
  size_t off = align128(size_t(BQB + 2 * BKB) * LD * 2);
  float* Ss = reinterpret_cast<float*>(smem + off);
  off += align128(size_t(BQB) * LDS * 4);
  bf16* Ps = reinterpret_cast<bf16*>(smem + off);
  off += align128(size_t(BQB) * LDPB * 2);
  float* Ms = reinterpret_cast<float*>(smem + off);
  float* Ls = Ms + align128(BQB * 4) / 4;
  float* Cs = Ls + align128(BQB * 4) / 4;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t head = size_t(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * BQB;
  const int n_tiles = s_len / BKB;
  const bf16* kh = k + head;
  const bf16* vh = v + head;

  if (d < DP) {  // zero the padding columns of Q, K, V once; copies write only columns < d
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = tid; i < (BQB + 2 * BKB) * (DP - d); i += THREADS) {
      const int r = i / (DP - d), c = d + i % (DP - d);
      Qs[r * LD + c] = zero;
    }
  }
  for (int i = tid; i < BQB; i += THREADS) {
    Ms[i] = -INFINITY;
    Ls[i] = 0.0f;
  }
  load_rows_bf16<LD>(Qs, q + head + size_t(q0) * d, BQB, d);
  load_rows_bf16<LD>(Ks, kh, BKB, d);
  attn::cp_async_commit();
  load_rows_bf16<LD>(Vs, vh, BKB, d);
  attn::cp_async_commit();

  const int sm = warp / 4, sn = warp % 4;  // this warp's 16 x 8 score tile
  const int rs = tid / TPR, kp = (tid % TPR) * KPT;
  const int col0 = warp * CW;
  float acc[2][NTW][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTW; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    attn::cp_async_wait_all_but_one();  // Q and this K tile have landed
    __syncthreads();

    // S[16 sm.., 8 sn..] = Q K^T over all of DP, two k16 steps per ldmatrix of K
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int kc = 0; kc < DP / 16; kc += 2) {
      unsigned a0[4], a1[4], b[4];
      attn::ldmatrix_x4(a0, Qs + (16 * sm + lane % 16) * LD + kc * 16 + (lane / 16) * 8);
      attn::ldmatrix_x4(a1, Qs + (16 * sm + lane % 16) * LD + (kc + 1) * 16 + (lane / 16) * 8);
      attn::ldmatrix_x4(b, Ks + (8 * sn + lane % 8) * LD + kc * 16 + (lane / 8) * 8);
      attn::mma_bf16(s, a0, b[0], b[1]);
      attn::mma_bf16(s, a1, b[2], b[3]);
    }
    Ss[(16 * sm + g) * LDS + 8 * sn + 2 * t4] = s[0];
    Ss[(16 * sm + g) * LDS + 8 * sn + 2 * t4 + 1] = s[1];
    Ss[(16 * sm + g + 8) * LDS + 8 * sn + 2 * t4] = s[2];
    Ss[(16 * sm + g + 8) * LDS + 8 * sn + 2 * t4 + 1] = s[3];
    __syncthreads();  // K is free, the scores are complete

    if (tile + 1 < n_tiles) load_rows_bf16<LD>(Ks, kh + size_t(tile + 1) * BKB * d, BKB, d);
    attn::cp_async_commit();

    {
      float x[KPT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        x[j] = Ss[rs * LDS + kp + j];
        mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int off = 1; off < TPR; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[rs];
      const float m_new = fmaxf(m_old, mx);
      const float corr = exp2f((m_old - m_new) * scale_log2);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = BF16P ? attn::prob_bf16(x[j], m_new, scale_bf16)
                              : exp2f((x[j] - m_new) * scale_log2);
        Ps[rs * LDPB + kp + j] = __float2bfloat16(p);
        sum += p;  // the row sum is taken before the cast, as the TPU kernel does
      }
#pragma unroll
      for (int off = 1; off < TPR; off *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (BF16P) sum = attn::round_bf16(sum);
      if (tid % TPR == 0) {
        Ms[rs] = m_new;
        Ls[rs] = Ls[rs] * corr + sum;
        Cs[rs] = corr;
      }
    }
    attn::cp_async_wait_all_but_one();  // this V tile has landed
    __syncthreads();

    // O[32 rows, warp columns] = O * corr + P V
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float c_lo = Cs[16 * m + g], c_hi = Cs[16 * m + g + 8];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        acc[m][n][0] *= c_lo;
        acc[m][n][1] *= c_lo;
        acc[m][n][2] *= c_hi;
        acc[m][n][3] *= c_hi;
      }
    }
#pragma unroll
    for (int kc = 0; kc < BKB / 16; ++kc) {
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        attn::ldmatrix_x4(a[m], Ps + (16 * m + lane % 16) * LDPB + kc * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        unsigned b[4];
        attn::ldmatrix_x4_trans(b, Vs + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + col0 +
                                       np * 16 + (lane / 16) * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          attn::mma_bf16(acc[m][2 * np], a[m], b[0], b[1]);
          attn::mma_bf16(acc[m][2 * np + 1], a[m], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // V and the probabilities are free
    if (tile + 1 < n_tiles) load_rows_bf16<LD>(Vs, vh + size_t(tile + 1) * BKB * d, BKB, d);
    attn::cp_async_commit();
  }

#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * m + g + 8 * i;
      const float inv = 1.0f / Ls[row];
      bf16* orow = o + head + size_t(q0 + row) * d;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int col = col0 + n * 8 + 2 * t4;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[m][n][2 * i] * inv, acc[m][n][2 * i + 1] * inv);
      }
    }
  }
}

template <bool BF16P>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        int d, float scale, cudaStream_t stream) {
  constexpr size_t bytes = bf16_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(stream_bf16<BF16P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  stream_bf16<BF16P><<<dim3(s / BQB, bh), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), s, d, scale * LOG2E, attn::round_bf16(scale));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (bh, s, d); dtype 0 = float32, 1 = bfloat16; bf16_probs 0 or 1;
// 0 < bh <= 65535. float32 requires s % 64 == 0, d % 64 == 0, d <= 512; bfloat16 s % 32 == 0,
// d % 8 == 0, d <= 512.
int streaming_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh, int s,
                            int d, float scale, int dtype, int bf16_probs, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || d <= 0 || d > DP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && s % Q64 == 0 && d % DC == 0)
    return static_cast<int>(bf16_probs ? launch_f32_q64<true>(q, k, v, o, bh, s, d, scale, st)
                                       : launch_f32_q64<false>(q, k, v, o, bh, s, d, scale, st));
  if (dtype == 1 && s % BQB == 0 && d % 8 == 0)
    return static_cast<int>(bf16_probs ? launch_bf16<true>(q, k, v, o, bh, s, d, scale, st)
                                       : launch_bf16<false>(q, k, v, o, bh, s, d, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
