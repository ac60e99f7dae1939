// The previous (v2) designs of K1's bf16 and float32 paths and K4's float32 and bf16 paths, kept
// only as yardsticks: chip_smoke.py times each redesigned kernel against its v2 in the same run,
// on the same inputs. No path of the port calls them. Their designs, as PERF.md describes them:
//   * K1 v2 (fused_attention_v2_fwd): one block of 4 warps per 64-row q tile, mma.sync.m16n8k16
//     with register-resident S, P and O, K/V tiles double-buffered with cp.async
//     (attention_common.cuh's tile loop, which K3 still uses);
//   * K1 float32 v1, the first design of K1's float32 path (fused_attention_f32_v1_fwd, both
//     modes): one block of 4 warps per 64-row q tile, plain FMAs, the score tile and the
//     accumulator in shared memory (attention_common.cuh attend_f32, which K3's first float32
//     design in fused_readout_v2.cu runs twice);
//   * K4 v2 (streaming_attention_v2_fwd): CUDA-core FMAs, no TF32, a 64-row q tile with Q in
//     shared memory, K in 64 x 64 chunks and V in 8-key chunks through a 4-buffer cp.async ring.
//   * K4 bf16 v2, the first design of K4's bf16 path (streaming_attention_bf16_v2_fwd,
//     both modes): a block of 8 warps per 32-row q tile over 32-key K/V tiles, one Q, K and V
//     tile in shared memory (D padded to 512), single-buffered by cp.async; mma.sync.m16n8k16,
//     each warp one 16 x 8 score tile over all of D, the scores through shared memory to a
//     softmax of 8 threads a row, then P V with each warp owning D / 8 output columns of all
//     32 rows; two __syncthreads a tile. Each block streams its head's whole K and V, so a
//     (2, 1, 16384, 512) launch moves 34.4 GB from L2 to the SMs.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include "attention_common.cuh"

namespace k1v2 {

using namespace attn;

template <int DP>
__global__ void __launch_bounds__(THREADS)
attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int s_len, int d,
               float scale_log2) {
  constexpr int TILE = BQ * (DP + 8);
  constexpr int NT = DP / 8;  // n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;      // two buffers
  bf16* Vs = Ks + 2 * TILE;  // two buffers

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t head = size_t(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * BQ;

  zero_padding_bf16<DP>(Qs, d);
  unsigned qf[DP / 16][4];
  load_q_bf16<DP>(qf, Qs, q + head + size_t(q0) * d, d);
  float acc[NT][4], l_run[2];
  attend_bf16<DP>(qf, k + head, v + head, s_len, d, scale_log2, Ks, Vs, acc, l_run);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.0f / quad_sum(l_run[i]);
    bf16* orow = o + head + size_t(q0 + warp * 16 + g + 8 * i) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        int d, float scale, cudaStream_t stream) {
  constexpr size_t bytes = bf16_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(attention_bf16<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attention_bf16<DP><<<dim3(s / BQ, bh), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), s, d, scale * LOG2E);
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

}  // namespace k1v2

namespace k1f32v1 {

using namespace attn;

__global__ void __launch_bounds__(THREADS)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int s_len, int d,
              float scale, bool bf16_probs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutF32 L = make_layout_f32(d, 1);
  const size_t head = size_t(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * BQ;
  load_tile_f32(reinterpret_cast<float*>(smem + L.q), L.ld_qkv, q + head + size_t(q0) * d, d);
  attend_f32(L, smem, 0, k + head, v + head, s_len, d, scale, bf16_probs, round_bf16(scale));
  __syncthreads();

  const float* Os = reinterpret_cast<const float*>(smem + L.o[0]);
  const float* Ls = reinterpret_cast<const float*>(smem + L.l[0]);
  float* out = o + head + size_t(q0) * d;
  for (int i = threadIdx.x; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i % d;
    out[i] = Os[r * L.ld_o + c] * (1.0f / (bf16_probs ? round_bf16(Ls[r]) : Ls[r]));
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int s, int d,
                       float scale, bool bf16_probs, cudaStream_t stream) {
  const LayoutF32 L = make_layout_f32(d, 1);
  cudaError_t err = cudaFuncSetAttribute(attention_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  attention_f32<<<dim3(s / BQ, bh), THREADS, L.total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, d, scale, bf16_probs);
  return cudaGetLastError();
}

}  // namespace k1f32v1

namespace k4v2 {

constexpr int THREADS = 256;  // 8 warps

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

}  // namespace k4v2

namespace k4bf16v2 {

constexpr int THREADS = 256;  // 8 warps
using attn::align128;

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
      const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale_bf16);
#pragma unroll
      for (int j = 0; j < KPT; j += 2) {
        float p0, p1;
        if (BF16P) {
          const uint32_t pp = attn::prob_bf16x2(x[j], x[j + 1], m_new, scale2);
          p0 = attn::bf16_lo(pp);
          p1 = attn::bf16_hi(pp);
        } else {
          p0 = exp2f((x[j] - m_new) * scale_log2);
          p1 = exp2f((x[j + 1] - m_new) * scale_log2);
        }
        Ps[rs * LDPB + kp + j] = __float2bfloat16(p0);
        Ps[rs * LDPB + kp + j + 1] = __float2bfloat16(p1);
        sum += p0;  // the row sum is taken before the cast, as the TPU kernel does
        sum += p1;
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
      static_cast<bf16*>(o), s, d, scale * attn::LOG2E, attn::round_bf16(scale));
  return cudaGetLastError();
}

}  // namespace k4bf16v2

extern "C" {

// q, k, v, o: contiguous (bh, s, d) bfloat16; s % 64 == 0, d % 8 == 0, 0 < d <= 160.
int fused_attention_v2_fwd(const void* q, const void* k, const void* v, void* o, int bh, int s,
                           int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % attn::BQ != 0 || d <= 0 || d > 160 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      k1v2::dispatch_bf16(q, k, v, o, bh, s, d, scale, static_cast<cudaStream_t>(stream)));
}

// q, k, v, o: contiguous (bh, s, d) float32; s % 64 == 0, d % 8 == 0, 0 < d <= 160;
// bf16_probs 0 or 1.
int fused_attention_f32_v1_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                               int s, int d, float scale, int bf16_probs, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % attn::BQ != 0 || d <= 0 || d > 160 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(k1f32v1::launch_f32(q, k, v, o, bh, s, d, scale, bf16_probs != 0,
                                              static_cast<cudaStream_t>(stream)));
}

// q, k, v, o: contiguous (bh, s, d) float32; s % 64 == 0, d % 64 == 0, d <= 512.
int streaming_attention_v2_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                               int s, int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % k4v2::Q64 != 0 || d <= 0 || d > 512 ||
      d % k4v2::DC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      k4v2::launch_f32_q64(q, k, v, o, bh, s, d, scale, static_cast<cudaStream_t>(stream)));
}

// q, k, v, o: contiguous (bh, s, d) bfloat16; s % 32 == 0, d % 8 == 0, d <= 512;
// bf16_probs 0 or 1.
int streaming_attention_bf16_v2_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                                    int s, int d, float scale, int bf16_probs, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % k4bf16v2::BQB != 0 || d <= 0 ||
      d > k4bf16v2::DP || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16_probs ? k4bf16v2::launch_bf16<true>(q, k, v, o, bh, s, d, scale, st)
                 : k4bf16v2::launch_bf16<false>(q, k, v, o, bh, s, d, scale, st));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
