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

#include "attention_common.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// bf16: mma.sync, register-resident S / P / O (attention_common.cuh)
// ---------------------------------------------------------------------------

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
