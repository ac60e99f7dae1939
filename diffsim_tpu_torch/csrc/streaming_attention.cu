// K4: streaming self-attention for wide heads, softmax(Q K^T / sqrt(D)) V over (B*H, S, D) with
// D <= 512 and long S: the VAE mid attention of a 1024 px encode, (B, 1, 16384, 512).
//
// Replaces the TPU kernel `streaming_self_attention` (diffsim_tpu/ops/pallas/attention_stream.py,
// body `_kernel`, pallas_call in `_pallas_forward`): an online softmax over K/V blocks with f32
// running max m, sum l and accumulator, the max over the UNSCALED logits with the scale folded
// into exp's operand, the probabilities cast to V's dtype for the PV product (f32
// accumulation), and acc / l after the last block. This kernel keeps that contract (the exact
// mode; the TPU kernel's bf16_probs mode is not ported).
//
// The trouble spot is D = 512: a 64-row f32 accumulator is 128 KB and one f32 K tile of 64
// keys another 128 KB, against the 227 KB a block may use. The output accumulator therefore
// lives in registers, spread over the warps ALONG D, never in shared memory, and 8 warps
// share each K/V tile.
//
// float32 (the SDXL main path, whose VAE encodes in f32): CUDA-core FMAs, no TF32.
//   D % 64 == 0, D <= 512, S % 64 == 0 (stream_f32_q64): a 64-row q tile whose Q stays in
//   shared memory (132 KB at D = 512) and 64-key tiles. K streams in 64 x 64 chunks along D,
//   then V in 8-key chunks, through a ring of 4 chunk buffers filled by cp.async three chunks
//   ahead, with one barrier per chunk. Each thread keeps a 4 x 4 score tile over all of D (8
//   FMAs per 16-byte shared load, each load one conflict-free wavefront) and 16 rows x 8
//   columns of O (128 registers; per key four broadcast loads of P and two of V feed 128
//   FMAs). A 64-row tile reads each K/V byte from L2 once per 64 query rows.
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
// byte at S = 16384, so the kernel is bound by operations: the 67 TFLOP/s non-tensor FP32 peak
// for float32, the 989 TFLOP/s bf16 tensor-core peak for bf16. See PERF.md for the measured
// share.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr float LOG2E = 1.4426950408889634f;

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
constexpr int LDC = DC + 4;  // leading dim of a K chunk and of the score / probability tile
constexpr int SLOTS = 4;     // ring of chunk buffers: 3 copies in flight behind the one in use
constexpr int SLOT_FLOATS = K64 * LDC;  // one K chunk; one V chunk (8 x (d + 4)) fits for d <= 512

__device__ inline void cp_async_wait_slots() {  // all but the SLOTS - 2 newest groups landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(SLOTS - 2));
}

// Shared memory (bytes): the Q tile (leading dim d + 4), the chunk ring, the score tile
// (row-major, then the probabilities key-major in the same place) and the row statistics.
struct LayoutQ64 {
  size_t q, ring, s, m, l, c, total;
  int ldq;
  __host__ __device__ LayoutQ64(int d) {
    ldq = d + 4;
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
                                       const float* vh, int d, int ldq, float* ring) {
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
        if (c4 < d / 4) attn::cp_async16(dst + r * ldq + 4 * c4, src + size_t(r) * d + 4 * c4);
      }
    }
  }
  attn::cp_async_commit();
}

// Thread layout. Scores: the 64 x 64 tile in 4 x 4 register tiles over all of D (no partial
// sums), rows ty + 16 a and keys tx + 16 b, a warp spanning 4 rows x 8 keys so that each
// 16-byte shared load of Q or K is one conflict-free wavefront. Softmax: 4 threads per row,
// 16 keys each. PV: warp w owns rows r0 = 16 (w % 4) .. r0 + 15 and lane l the columns
// 4 (32 (w / 4) + l + 64 n), n < 2: 128 accumulators a thread, fed per key by four broadcast
// float4 loads of P and two float4 loads of V.
__global__ void __launch_bounds__(THREADS, 1)
stream_f32_q64(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int s_len, int d,
               float scale) {
  constexpr int PR = 16;  // PV rows per warp
  constexpr int NCH = 2;  // PV column groups of 4 per lane: D <= 512
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutQ64 L(d);
  const int ldq = L.ldq;
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* Ss = reinterpret_cast<float*>(smem + L.s);  // scores [row][key], then P [key][row]
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* Ls = reinterpret_cast<float*>(smem + L.l);
  float* Cs = reinterpret_cast<float*>(smem + L.c);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t head = size_t(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * Q64;
  const int d4 = d / 4;
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
  for (int g = 0; g < SLOTS - 1; ++g)
    issue_stage_q64(g, total, n_stages, nkc, kh, vh, d, ldq, ring);

  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;  // scores
  const int rs = tid / 4, qk = tid % 4;                                      // softmax
  const int r0 = PR * (warp % 4), cb = 32 * (warp / 4);                      // PV
  float acc[PR][NCH][4];
#pragma unroll
  for (int r = 0; r < PR; ++r)
#pragma unroll
    for (int n = 0; n < NCH; ++n) acc[r][n][0] = acc[r][n][1] = acc[r][n][2] = acc[r][n][3] = 0.f;
  float sacc[4][4];

  for (int g = 0; g < total; ++g) {
    const int st = g % n_stages;
    const float* chunk = ring + (g % SLOTS) * SLOT_FLOATS;
    // stage g has landed, and every thread is done with stage g - 1, whose slot the copy of
    // stage g + SLOTS - 1 reuses
    cp_async_wait_slots();
    __syncthreads();
    issue_stage_q64(g + SLOTS - 1, total, n_stages, nkc, kh, vh, d, ldq, ring);

    if (st < nkc) {
      if (st == 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) sacc[a][b] = 0.0f;
      }
      const float* Qc = Qs + st * DC;
#pragma unroll
      for (int c4 = 0; c4 < DC / 4; ++c4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          qv[a] = *reinterpret_cast<const float4*>(Qc + (ty + 16 * a) * ldq + 4 * c4);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          kv[b] = *reinterpret_cast<const float4*>(chunk + (tx + 16 * b) * LDC + 4 * c4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float s = sacc[a][b];
            s = fmaf(qv[a].x, kv[b].x, s);
            s = fmaf(qv[a].y, kv[b].y, s);
            s = fmaf(qv[a].z, kv[b].z, s);
            s = fmaf(qv[a].w, kv[b].w, s);
            sacc[a][b] = s;
          }
      }
      if (st == nkc - 1) {
        // the tile's scores are complete: online softmax of row rs over keys [16 qk, +16)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) Ss[(ty + 16 * a) * LDC + tx + 16 * b] = sacc[a][b];
        __syncthreads();
        float x[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 t = *reinterpret_cast<const float4*>(Ss + rs * LDC + 16 * qk + 4 * i);
          x[4 * i] = t.x;
          x[4 * i + 1] = t.y;
          x[4 * i + 2] = t.z;
          x[4 * i + 3] = t.w;
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
          x[j] = expf((x[j] - m_new) * scale);
          sum += x[j];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        __syncthreads();  // every thread has read its scores: the tile now takes P
#pragma unroll
        for (int j = 0; j < 16; ++j) Ss[(16 * qk + j) * LDC + rs] = x[j];
        if (qk == 0) {
          Ms[rs] = m_new;
          Ls[rs] = Ls[rs] * corr + sum;
          Cs[rs] = corr;
        }
      }
    } else {
      // O[warp rows, lane columns] += P V over this chunk's 8 keys (rescaled once per tile)
      const int vc = st - nkc;
      if (vc == 0) {
#pragma unroll
        for (int r = 0; r < PR; ++r) {
          const float c = Cs[r0 + r];
#pragma unroll
          for (int n = 0; n < NCH; ++n) {
            acc[r][n][0] *= c;
            acc[r][n][1] *= c;
            acc[r][n][2] *= c;
            acc[r][n][3] *= c;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VC; ++j) {
        const float* prow = Ss + (vc * VC + j) * LDC + r0;
        float p[PR];
#pragma unroll
        for (int i = 0; i < PR / 4; ++i) {
          const float4 t = *reinterpret_cast<const float4*>(prow + 4 * i);
          p[4 * i] = t.x;
          p[4 * i + 1] = t.y;
          p[4 * i + 2] = t.z;
          p[4 * i + 3] = t.w;
        }
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
          const int c4 = cb + lane + 64 * n;
          if (c4 < d4) {
            const float4 vv = *reinterpret_cast<const float4*>(chunk + j * ldq + 4 * c4);
#pragma unroll
            for (int r = 0; r < PR; ++r) {
              acc[r][n][0] = fmaf(p[r], vv.x, acc[r][n][0]);
              acc[r][n][1] = fmaf(p[r], vv.y, acc[r][n][1]);
              acc[r][n][2] = fmaf(p[r], vv.z, acc[r][n][2]);
              acc[r][n][3] = fmaf(p[r], vv.w, acc[r][n][3]);
            }
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < PR; ++r) {
    const int row = r0 + r;
    const float inv = 1.0f / Ls[row];
    float* orow = o + head + size_t(q0 + row) * d;
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
      const int c4 = cb + lane + 64 * n;
      if (c4 < d4)
        *reinterpret_cast<float4*>(orow + 4 * c4) =
            make_float4(acc[r][n][0] * inv, acc[r][n][1] * inv, acc[r][n][2] * inv,
                        acc[r][n][3] * inv);
    }
  }
}

cudaError_t launch_f32_q64(const void* q, const void* k, const void* v, void* o, int bh, int s,
                           int d, float scale, cudaStream_t stream) {
  const size_t bytes = LayoutQ64(d).total;
  cudaError_t err = cudaFuncSetAttribute(stream_f32_q64,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  stream_f32_q64<<<dim3(s / Q64, bh), THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, d, scale);
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

__global__ void __launch_bounds__(THREADS)
stream_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            bf16* __restrict__ o, int s_len, int d, float scale_log2) {
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
        const float p = exp2f((x[j] - m_new) * scale_log2);
        Ps[rs * LDPB + kp + j] = __float2bfloat16(p);
        sum += p;  // the row sum is taken before the cast, as the TPU kernel does
      }
#pragma unroll
      for (int off = 1; off < TPR; off *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
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

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        int d, float scale, cudaStream_t stream) {
  constexpr size_t bytes = bf16_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(stream_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  stream_bf16<<<dim3(s / BQB, bh), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), s, d, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (bh, s, d); dtype 0 = float32, 1 = bfloat16; 0 < bh <= 65535.
// float32 requires s % 64 == 0, d % 64 == 0, d <= 512; bfloat16 s % 32 == 0, d % 8 == 0,
// d <= 512.
int streaming_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh, int s,
                            int d, float scale, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || d <= 0 || d > DP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && s % Q64 == 0 && d % DC == 0)
    return static_cast<int>(launch_f32_q64(q, k, v, o, bh, s, d, scale, st));
  if (dtype == 1 && s % BQB == 0 && d % 8 == 0)
    return static_cast<int>(launch_bf16(q, k, v, o, bh, s, d, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
