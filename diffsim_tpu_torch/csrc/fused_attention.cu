// K1: fused square self-attention forward, softmax(Q K^T / sqrt(D)) V over (B*H, S, D).
//
// Replaces the TPU kernel `fused_self_attention` (diffsim_tpu/ops/pallas/attention.py, body
// `_kernel`). Numerics contract, kept from that kernel:
//   * logits and softmax statistics in f32; the row max is taken over the UNSCALED logits and
//     the scale is folded into exp's operand: p = exp((s - m) * scale);
//   * the probabilities are cast to V's dtype before the PV product (f32 accumulation);
//   * 1 / rowsum is applied once, after the last PV product; the output is in V's dtype.
// The TPU kernel's bf16_probs mode (--bf16_softmax, attention.py:51-55) is a second
// instantiation of both paths (BF16P / bf16_probs): the centred logit, its product with the
// bf16-rounded scale and the exponential are each rounded to bf16 (attention_common.cuh
// prob_bf16x2, two at a time on the card's bf16x2 conversions and multiply, the exponential by
// ex2.approx), the row sum adds the rounded probabilities and is itself rounded to bf16 before
// 1 / rowsum, as the TPU kernel's bf16 jnp.sum is. The TPU kernel takes its max over the whole
// row; this kernel's running max rounds s - m against the max of the keys seen so far, and the
// f32 factor that rescales the earlier tiles makes up the difference up to rounding.
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
// bf16 (the main path), for sm_90a: the pipeline of attention_wgmma.cuh (FlashAttention-3's
// shape) with one pass per q block. A persistent block of 512 threads per SM walks over 192-row
// q blocks (a head's blocks adjacent, so concurrent blocks share its K/V in L2): three consumer
// warpgroups of 64 rows and one producer warpgroup, which gives its registers to the consumers
// (setmaxnreg: 24 a thread for it, 160 for them). Named barriers pass the turn at the tensor
// cores round the three consumers, so two softmaxes run under each one's products. Each
// consumer scales its accumulator by 1 / l and stores its rows in bf16; the rows past S of a
// partial last q block are computed on TMA's zero rows and not stored.
//
// float32 (the forward of the DiT trainer's default float32 step at (32, 16, 256, 72), of the
// float32 sampler at (16, 16, 256, 72), and the tiny float32 card-vs-CPU checks): 3xTF32 on the
// tensor cores, mma.sync.m16n8k8. Each float32 operand is split where its fragment is loaded,
// hi = tf32(x) rounded to nearest, lo = x - hi (attention_common.cuh split_tf32), and each product
// is a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation; the dropped a_lo b_lo term is
// ~2^-22 relative, while one TF32 pass (2^-11) misses the 1e-5 check against the plain version
// by 24-55x (tests/test_torch_port_k1_tf32x3.py emulates both). The block's pass over the keys
// is attention_tf32.cuh's attend_tf32, which K3's float32 path runs twice (design there): 4 warps
// of 16 q rows over all of D, the grid (S / 64, B H), 2048 blocks at the training site, two
// resident on an SM (about 190 registers a thread at D = 72); K/V in 64-key tiles double-buffered
// by cp.async; scores and probabilities in registers; each tile's P V a fresh tensor-core sum.
// Each D % 8 == 0 up to 160 has its own instantiation: padding D to 16 and skipping the last step
// at run time cut the loops into small blocks that the compiler could not schedule across.
// Why not wgmma: TF32 wgmma takes its B operand from shared memory only K-major, and V stored
// (key, d) is N-major for P V, so it would need a transposing copy first (a later design's lever).
// Bound at the training site: 4 B H S^2 D = 9.66 GFLOP, three TF32 passes at 495 TFLOP/s =
// 0.0586 ms a launch (1.640 ms a training step of 28 launches; 0.0293 ms a launch at the
// sampler's (16, 16, 256, 72)), above the bytes (151 MB, 0.0451 ms) and the exponentials
// (33.6 M, 0.0086 ms). The first design of this path (plain FMAs, score tile and accumulator in
// shared memory, bound by the 67 TFLOP/s FP32 SIMT rate) is kept as a yardstick in
// attention_v2.cu.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include "attention_tf32.cuh"

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

template <int DP>
using Cfg = Tiling<DP, NWG>;

// Persistent: each block walks work items item = blockIdx.x + i * gridDim.x, an item being one
// 192-row q block of one head.
template <int DP, bool BF16P>
__global__ void __launch_bounds__(THREADS_WG, 1)
attention_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int s_len, int d,
                int n_items, float scale_log2, float scale_bf16) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  Pipeline<Cfg<DP>> pipe(smem_raw);

  // warp-uniform by construction, so the compiler sees the role branches as non-divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int q_blocks = (s_len + BM - 1) / BM;

  if (threadIdx.x == 0) pipe.init();
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / q_blocks, q0 = (item % q_blocks) * BM;
        pipe.load_q(&tm_q, it, q0, bh);
        pipe.load_kv(&tm_k, &tm_v, bh, s_len);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    // a consumer warpgroup: 64 q rows; this thread holds rows 16 (warp % 4) + g and + 8 of them
    const int c = warp / 4;
    const int g8 = lane / 4, t = lane % 4;
    float acc[DP / 2], l_run[2];
    open_turns<NWG>(c);
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / q_blocks, q0 = (item % q_blocks) * BM;
      const bool last_item = item + gridDim.x >= n_items;
      attend_pass<DP, BF16P>(pipe, acc, l_run, pipe.wait_q(it, c), it, s_len, scale_log2, c,
                             last_item, true, scale_bf16);

      const int r = q0 + 64 * c + 16 * (warp % 4) + g8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float l = quad_sum(l_run[i]);
        const float inv = 1.0f / (BF16P ? round_bf16(l) : l);
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

template <int DP, bool BF16P>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        int d, float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::make_map_bf16(&tq, q, bh, s, d, BM, C::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tk, k, bh, s, d, C::BN, C::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tv, v, bh, s, d, C::BN, C::W);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_wgmma<DP, BF16P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const int n_items = (s + BM - 1) / BM * bh;
  const int grid = n_items < hopper::sm_count() ? n_items : hopper::sm_count();
  attention_wgmma<DP, BF16P><<<grid, THREADS_WG, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), s, d, n_items, scale * LOG2E, round_bf16(scale));
  return cudaGetLastError();
}

template <bool BF16P>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s,
                          int d, float scale, cudaStream_t st) {
  switch ((d + 15) / 16) {
    case 1: return launch_bf16<16, BF16P>(q, k, v, o, bh, s, d, scale, st);
    case 2: return launch_bf16<32, BF16P>(q, k, v, o, bh, s, d, scale, st);
    case 3: return launch_bf16<48, BF16P>(q, k, v, o, bh, s, d, scale, st);
    case 4: return launch_bf16<64, BF16P>(q, k, v, o, bh, s, d, scale, st);
    case 5: return launch_bf16<80, BF16P>(q, k, v, o, bh, s, d, scale, st);
    case 6: return launch_bf16<96, BF16P>(q, k, v, o, bh, s, d, scale, st);
    case 7: return launch_bf16<112, BF16P>(q, k, v, o, bh, s, d, scale, st);
    case 8: return launch_bf16<128, BF16P>(q, k, v, o, bh, s, d, scale, st);
    case 9: return launch_bf16<144, BF16P>(q, k, v, o, bh, s, d, scale, st);
    case 10: return launch_bf16<160, BF16P>(q, k, v, o, bh, s, d, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 mma.sync, four warps of 16 q rows, scores and probabilities in registers
// ---------------------------------------------------------------------------

// One block: 64 q rows of one head through attention_tf32.cuh's 3xTF32 pass (warp w rows
// 16 w .. 16 w + 15 over all D columns, 64-key K/V tiles double-buffered with cp.async),
// normalised by 1 / rowsum and stored. Instantiated at every D % 8 == 0 up to 160.
template <int D, bool BF16P>
__global__ void __launch_bounds__(THREADS, 2)
attention_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int s_len, float scale_log2,
               float scale_bf16) {
  constexpr int KS = D / 8;  // n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t head = size_t(blockIdx.y) * s_len * D;
  const int q0 = blockIdx.x * BQ;

  copy_q_f32<D>(smem, q + head + size_t(q0) * D);
  float acc[KS][4], l_run[2];
  attend_tf32<D, BF16P>(smem, k + head, v + head, s_len, scale_log2, scale_bf16, acc, l_run);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    const float inv = 1.0f / (BF16P ? round_bf16(l) : l);
    float* orow = o + head + size_t(q0 + 16 * warp + g + 8 * i) * D;
#pragma unroll
    for (int n = 0; n < KS; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <int D, bool BF16P>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        float scale, cudaStream_t stream) {
  constexpr size_t bytes = SmemF32<D>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(attention_tf32<D, BF16P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attention_tf32<D, BF16P><<<dim3(s / BQ, bh), THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, scale * LOG2E, round_bf16(scale));
  return cudaGetLastError();
}

// launch_tf32 at the head dim d (d % 8 == 0, d <= 160): one instantiation per width
template <bool BF16P, int D = 8>
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, int bh, int s,
                         int d, float scale, cudaStream_t st) {
  if constexpr (D > 160) {
    return cudaErrorInvalidValue;
  } else {
    return d == D ? launch_tf32<D, BF16P>(q, k, v, o, bh, s, scale, st)
                  : dispatch_f32<BF16P, D + 8>(q, k, v, o, bh, s, d, scale, st);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (bh, s, d); dtype 0 = float32, 1 = bfloat16; bf16_probs 0 or 1.
// Requires s % 64 == 0, d % 8 == 0, 0 < d <= 160, 0 < bh <= 65535.
int fused_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        int d, float scale, int dtype, int bf16_probs, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % BQ != 0 || d <= 0 || d > 160 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(bf16_probs ? dispatch_bf16<true>(q, k, v, o, bh, s, d, scale, st)
                                       : dispatch_bf16<false>(q, k, v, o, bh, s, d, scale, st));
  if (dtype == 0)
    return static_cast<int>(bf16_probs ? dispatch_f32<true>(q, k, v, o, bh, s, d, scale, st)
                                       : dispatch_f32<false>(q, k, v, o, bh, s, d, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
