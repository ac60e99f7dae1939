// K1: fused square self-attention forward, softmax(Q K^T / sqrt(D)) V over (B*H, S, D).
//
// Replaces the TPU kernel `fused_self_attention` (diffsim_tpu/ops/pallas/attention.py, body
// `_kernel`). Numerics contract, kept from that kernel:
//   * logits and softmax statistics in f32; the row max is taken over the UNSCALED logits and
//     the scale is folded into exp's operand: p = exp((s - m) * scale);
//   * the probabilities are cast to V's dtype before the PV product (f32 accumulation);
//   * 1 / rowsum is applied once, after the last PV product; the output is in V's dtype.
//
// Design. The TPU kernel holds a head's whole K/V in VMEM; at S = 4096, D = 40 bf16 K+V alone is
// 655 KB, far above the 227 KB of shared memory a block may use on Hopper. So K/V stream
// through shared memory in 64-key tiles and the softmax is online (running max m, running sum
// l, rescaled f32 accumulator), which differs from the TPU kernel's global-max softmax only by
// rounding. One block of 4 warps per (b*h, 64-row q tile); each warp owns 16 q rows.
//
// bf16 (the main path): tensor cores through mma.sync.m16n8k16 with f32 accumulation. Q, the
// score tile S, the probabilities P and the output accumulator O stay in registers: the
// accumulator layout of one m16n8 product pair is the A-operand layout of the next k16 step,
// so P feeds the PV product without leaving registers, and each thread owns two rows' (m, l).
// K/V tiles are double-buffered with cp.async, so the next tile's copy overlaps this tile's
// math. The head dim is a template parameter padded to a multiple of 16 (40 -> 48), with zero
// columns in shared memory; exp is exp2 with log2(e) folded into the scale.
//
// float32 (a tight numerical check on the card): the same tiling with plain FMAs, the score
// tile and accumulator in shared memory.
//
// Bound on the H100: 4*S^2*D FLOP per head against 8*S*D bytes, far above the card's
// ~295 FLOP/byte balance point at S >= 1024, so the kernel is bound by tensor-core operations
// (the 256-token, hd-160 site is bound by bytes). At hd 40 the S^2 exponentials also weigh:
// at the SFU's rate they take a large share of the tensor-core bound. See PERF.md for the
// measured share.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BKV = 64;  // keys per K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: mma.sync, register-resident S / P / O
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

template <int DP>
constexpr size_t bf16_smem_bytes() {
  return size_t(5) * BQ * (DP + 8) * sizeof(bf16);  // Q + 2 x K + 2 x V tiles
}

// Fragment conventions (PTX ISA, mma.m16n8k16): lane = 4 * g + t; an accumulator tile holds
// rows g and g + 8, columns 2t and 2t + 1; A and B fragments come from ldmatrix.
template <int DP>
__global__ void __launch_bounds__(THREADS)
attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int s_len, int d,
               float scale_log2) {
  constexpr int LD = DP + 8;  // 16-byte row pad: conflict-free ldmatrix
  constexpr int TILE = BQ * LD;
  constexpr int KC = DP / 16;   // k16 steps of Q K^T
  constexpr int NT = DP / 8;    // n8 tiles of O
  constexpr int ST = BKV / 8;   // n8 tiles of S
  static_assert(BQ == BKV, "Q and K/V tiles share one layout");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;      // two buffers
  bf16* Vs = Ks + 2 * TILE;  // two buffers

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t head = size_t(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = s_len / BKV;

  // head-dim padding: zero columns [d, DP) of all five tiles once (copies write only < d)
  if (d < DP) {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < 5 * BQ * (DP - d); i += THREADS) {
      const int r = i / (DP - d), c = d + i % (DP - d);
      Qs[r * LD + c] = zero;
    }
  }
  auto load_tile = [&](bf16* dst, const bf16* src) {
    const int cpr = d / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < BKV * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      cp_async16(dst + r * LD + c, src + size_t(r) * d + c);
    }
  };
  load_tile(Qs, q + head + size_t(q0) * d);
  load_tile(Ks, k + head);
  load_tile(Vs, v + head);
  cp_async_commit();

  unsigned qf[KC][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8, over unscaled logits
  float l_run[2] = {0.0f, 0.0f};            // this thread's share of the row sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(Ks + (buf ^ 1) * TILE, k + head + size_t(tile + 1) * BKV * d);
      load_tile(Vs + (buf ^ 1) * TILE, v + head + size_t(tile + 1) * BKV * d);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // this tile (and Q) have landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldmatrix_x4(qf[kc], Qs + (warp * 16 + lane % 16) * LD + kc * 16 + (lane / 16) * 8);
    }
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / l;
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

// ---------------------------------------------------------------------------
// float32: plain FMAs, score tile and accumulator in shared memory
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout, computed identically on the host (launch size) and the device. Odd
// leading dims keep the scalar loops free of bank conflicts.
struct Layout {
  int ld_qkv, ld_s, ld_o;
  size_t q, k, v, s, o, m, l;  // byte offsets
  size_t total;
};

__host__ __device__ inline Layout make_layout(int d) {
  Layout L;
  L.ld_qkv = d + 1;
  L.ld_s = BKV + 1;
  L.ld_o = d + 1;
  size_t off = 0;
  L.q = off; off = align128(off + size_t(BQ) * L.ld_qkv * sizeof(float));
  L.k = off; off = align128(off + size_t(BKV) * L.ld_qkv * sizeof(float));
  L.v = off; off = align128(off + size_t(BKV) * L.ld_qkv * sizeof(float));
  L.s = off; off = align128(off + size_t(BQ) * L.ld_s * sizeof(float));
  L.o = off; off = align128(off + size_t(BQ) * L.ld_o * sizeof(float));
  L.m = off; off = align128(off + BQ * sizeof(float));
  L.l = off; off = align128(off + BQ * sizeof(float));
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

__global__ void __launch_bounds__(THREADS)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int s_len, int d,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d);
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* Ks = reinterpret_cast<float*>(smem + L.k);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);  // scores, then probabilities
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* Ls = reinterpret_cast<float*>(smem + L.l);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const size_t head = size_t(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * BQ;

  for (int i = threadIdx.x; i < BQ * L.ld_o; i += THREADS) Os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    Ms[i] = -INFINITY;
    Ls[i] = 0.0f;
  }
  load_tile_f32(Qs, L.ld_qkv, q + head + size_t(q0) * d, d);

  for (int kv0 = 0; kv0 < s_len; kv0 += BKV) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_f32(Ks, L.ld_qkv, k + head + size_t(kv0) * d, d);
    load_tile_f32(Vs, L.ld_qkv, v + head + size_t(kv0) * d, d);
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
        const float p = expf((srow[c] - m_new) * scale);
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
  __syncthreads();

  float* out = o + head + size_t(q0) * d;
  for (int i = threadIdx.x; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i % d;
    out[i] = Os[r * L.ld_o + c] * (1.0f / Ls[r]);
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int s, int d,
                       float scale, cudaStream_t stream) {
  const Layout L = make_layout(d);
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
