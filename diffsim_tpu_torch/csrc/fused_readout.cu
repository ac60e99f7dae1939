// K3: the fused DiffSim readout. For each row n of N = P*B*H and each 64-row q tile it computes
//   o1 = softmax(q K_cross^T / sqrt(D)) V_cross,   o2 = softmax(q K_self^T / sqrt(D)) V_self
// and writes the tile's similarity partials sum(o1 * o2), sum(o1^2), sum(o2^2) (cosine) or
// sum((o1 - o2)^2), 0, 0 (mse) in f32 to out[n, tile, 0:3]. Neither attention output leaves
// the block.
//
// Replaces the TPU kernel `cross_self_partials` (diffsim_tpu/ops/pallas/readout.py, body
// `_kernel`, pallas_call in `_pallas_partials`). That kernel holds one head's whole K/V in VMEM
// and normalises the softmax before the PV product. Here K/V stream through shared memory with
// K1's online softmax (attention_wgmma.cuh: running max over the unscaled logits, exp2 with the
// scale folded in, f32 row sums, probabilities cast to V's dtype unnormalised, f32
// accumulation), and 1 / rowsum is applied after the last tile. The two forms differ only by
// rounding: the bf16 cast rounds exp(s - m) instead of exp(s - m) / l.
//
// Bound on the H100, per row: 8 S^2 D FLOP on the bf16 tensor cores (989 TFLOP/s), 2 S^2
// exponentials on the special-function units (about 3.9e12 exp/s) and 5 S D 2 bytes (q, two K,
// two V read once). At (80, 1024, 64) that is 0.0434 ms of products against 0.0430 ms of exps:
// as in K1 at hd 64, the exps weigh as much as the products, so they have to overlap them.
//
// bf16 design (sm_90a): K1's pipeline (attention_wgmma.cuh) with the readout's two passes:
//   * a persistent block per SM walks over 128-row q blocks (a row's blocks adjacent, so
//     concurrent blocks share its K/V in L2): two consumer warpgroups of 64 rows and a producer
//     warpgroup (setmaxnreg 24 / 240). One producer thread loads a q block's Q once with TMA
//     (double-buffered across q blocks), then streams the cross K/V tiles and after them the
//     self K/V tiles through the one ring;
//   * each consumer runs attend_pass twice, the cross pass and then the self pass, passing the
//     turn at the tensor cores to the other consumer as K1 does;
//   * after the cross pass a consumer normalises O1 (1 / l) and parks it in shared memory as
//     f32, each thread its own accumulator elements at a 128-float stride (no bank conflicts,
//     no registers held through the self pass); after the self pass it forms the partials from
//     O1 and the normalised O2 element by element, reduces them over the warp with shuffles
//     and over its four warps in a fixed order, and writes its 64-row tile's triple;
//   * 128-row q blocks divide S = 1024 (the SDXL tap). 192-row blocks (three consumer
//     warpgroups, as K1 takes) leave 128 of every 1152 rows idle but hide two softmaxes under
//     each consumer's products; the two measured alike at (80, 1024, 64) (PERF.md), so the
//     two-consumer block stays: 240 registers a thread and one code path for every head dim up
//     to 128;
//   * TMA's zero fill supplies the columns past D, which add zeros to the partials, and the
//     keys past S of a partial last tile (masked).
// Torch sums the (N, S / 64, 3) buffer in a fixed order, so a score is the same from run to
// run.
//
// float32 (the scorers built with dtype=torch.float32): fused_readout_f32.cu, 3xTF32 on the
// tensor cores, a library of its own that exports the same entry point for dtype 0.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include "attention_wgmma.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, a producer warpgroup and two ping-ponged consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int NWG = 2;  // consumer warpgroups of 64 q rows
constexpr int BM = 64 * NWG;
constexpr int CONSUMER_WARPS = 4 * NWG;
constexpr int THREADS_WG = (NWG + 1) * 128;  // + the producer warpgroup
// the producer gives its registers to the consumers: 128 x 24 + 256 x 240 <= 65536
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr uint32_t BAR_WG = 1 + NWG;  // named barriers NWG + 1..: one consumer's four warps
constexpr int RED_BYTES = 2 * NWG * 4 * 4 * 4;  // [item parity][consumer][warp][4] floats

// the kernel's own shared memory after the ring: the parked cross outputs (f32), the reduction
template <int DP>
using Cfg = Tiling<DP, NWG, NWG * 128 * (DP / 2) * 4 + RED_BYTES>;

// Persistent: each block walks work items item = blockIdx.x + i * gridDim.x, an item being one
// 128-row q block of one row n; the producer streams its cross K/V tiles, then its self tiles.
template <int DP>
__global__ void __launch_bounds__(THREADS_WG, 1)
readout_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k1,
              const __grid_constant__ CUtensorMap tm_v1, const __grid_constant__ CUtensorMap tm_k2,
              const __grid_constant__ CUtensorMap tm_v2, float* __restrict__ out, int s_len,
              int n_items, float scale_log2, int mse) {
  using namespace hopper;
  constexpr int NO = DP / 2;  // O accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  Pipeline<Cfg<DP>> pipe(smem_raw);
  float* o1s = reinterpret_cast<float*>(pipe.extra);  // [NWG][NO][128]
  float* red = o1s + NWG * NO * 128;                  // [2][NWG][4][4]

  // warp-uniform by construction, so the compiler sees the role branches as non-divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int q_blocks = (s_len + BM - 1) / BM;
  const int q_tiles = s_len / 64;  // partial triples a row

  if (threadIdx.x == 0) pipe.init();
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k1);
      tma_prefetch_map(&tm_v1);
      tma_prefetch_map(&tm_k2);
      tma_prefetch_map(&tm_v2);
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / q_blocks, q0 = (item % q_blocks) * BM;
        pipe.load_q(&tm_q, it, q0, bh);
        pipe.load_kv(&tm_k1, &tm_v1, bh, s_len);  // cross
        pipe.load_kv(&tm_k2, &tm_v2, bh, s_len);  // self
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    // a consumer warpgroup: 64 q rows; this thread holds rows 16 (warp % 4) + lane / 4 and + 8
    const int c = warp / 4, w4 = warp % 4;
    float acc[NO], l_run[2];
    float* o1 = o1s + c * NO * 128 + w4 * 32 + lane;  // this thread's parked O1, stride 128
    open_turns<NWG>(c);
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / q_blocks, q0 = (item % q_blocks) * BM;
      const bool last_item = item + gridDim.x >= n_items;
      const unsigned char* q_base = pipe.wait_q(it, c);
      float part[3] = {0.0f, 0.0f, 0.0f};

      for (int pass = 0; pass < 2; ++pass) {  // cross, then self; the self pass frees Q
        attend_pass<DP>(pipe, acc, l_run, q_base, it, s_len, scale_log2, c,
                        last_item && pass == 1, pass == 1);
        // acc[4 n + e] is row g8 (e < 2) or g8 + 8 (e >= 2), column 8 n + 2 t + e % 2
        const float inv[2] = {1.0f / quad_sum(l_run[0]), 1.0f / quad_sum(l_run[1])};
        if (pass == 0) {
#pragma unroll
          for (int i = 0; i < NO; ++i) o1[i * 128] = acc[i] * inv[(i % 4) / 2];
        } else if (mse) {
#pragma unroll
          for (int i = 0; i < NO; ++i) {
            const float d = o1[i * 128] - acc[i] * inv[(i % 4) / 2];
            part[0] = fmaf(d, d, part[0]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < NO; ++i) {
            const float x = o1[i * 128], y = acc[i] * inv[(i % 4) / 2];
            part[0] = fmaf(x, y, part[0]);
            part[1] = fmaf(x, x, part[1]);
            part[2] = fmaf(y, y, part[2]);
          }
        }
      }

      // this consumer's 64-row tile: the warp's sums (shuffles), then its four warps in order
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
      float* r = red + ((it & 1) * NWG + c) * 16;
      if (lane == 0)
        for (int k = 0; k < 3; ++k) r[4 * w4 + k] = part[k];
      named_sync(BAR_WG + c, 128);
      const int tile = q0 / 64 + c;  // rows past S (a partial last q block) are not written
      if (w4 == 0 && lane == 0 && tile < q_tiles) {
        float* dst = out + (size_t(bh) * q_tiles + tile) * 3;
        for (int k = 0; k < 3; ++k) dst[k] = (r[k] + r[4 + k]) + (r[8 + k] + r[12 + k]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k1, const void* v1, const void* k2,
                        const void* v2, float* out, int n, int s, int d, float scale, int mse,
                        cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk1, tv1, tk2, tv2;
  cudaError_t err = hopper::make_map_bf16(&tq, q, n, s, d, BM, C::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tk1, k1, n, s, d, C::BN, C::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tv1, v1, n, s, d, C::BN, C::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tk2, k2, n, s, d, C::BN, C::W);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tv2, v2, n, s, d, C::BN, C::W);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(readout_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const int n_items = (s + BM - 1) / BM * n;
  const int grid = n_items < hopper::sm_count() ? n_items : hopper::sm_count();
  readout_wgmma<DP><<<grid, THREADS_WG, C::SMEM, stream>>>(tq, tk1, tv1, tk2, tv2, out, s,
                                                           n_items, scale * LOG2E, mse);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k1, const void* v1, const void* k2,
                          const void* v2, float* out, int n, int s, int d, float scale, int mse,
                          cudaStream_t st) {
  switch ((d + 15) / 16) {
    case 1: return launch_bf16<16>(q, k1, v1, k2, v2, out, n, s, d, scale, mse, st);
    case 2: return launch_bf16<32>(q, k1, v1, k2, v2, out, n, s, d, scale, mse, st);
    case 3: return launch_bf16<48>(q, k1, v1, k2, v2, out, n, s, d, scale, mse, st);
    case 4: return launch_bf16<64>(q, k1, v1, k2, v2, out, n, s, d, scale, mse, st);
    case 5: return launch_bf16<80>(q, k1, v1, k2, v2, out, n, s, d, scale, mse, st);
    case 6: return launch_bf16<96>(q, k1, v1, k2, v2, out, n, s, d, scale, mse, st);
    case 7: return launch_bf16<112>(q, k1, v1, k2, v2, out, n, s, d, scale, mse, st);
    case 8: return launch_bf16<128>(q, k1, v1, k2, v2, out, n, s, d, scale, mse, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k1, v1 (cross), k2, v2 (self): contiguous bfloat16 (n, s, d); out: (n, s / 64, 3)
// float32. dtype 1 (bfloat16; float32 is fused_readout_f32.cu's); mse 0 = cosine partials,
// 1 = squared-difference partial. Requires s % 64 == 0, d % 8 == 0, 0 < d <= 128,
// 0 < n <= 65535.
int fused_readout_fwd(const void* q, const void* k1, const void* v1, const void* k2,
                      const void* v2, void* out, int n, int s, int d, float scale, int dtype,
                      int mse, void* stream) {
  if (dtype != 1 || n <= 0 || n > 65535 || s <= 0 || s % BQ != 0 || d <= 0 || d > 128 ||
      d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_bf16(q, k1, v1, k2, v2, static_cast<float*>(out), n, s, d,
                                        scale, mse, static_cast<cudaStream_t>(stream)));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
