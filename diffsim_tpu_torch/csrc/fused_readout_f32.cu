// K3, float32: the fused DiffSim readout of fused_readout.cu on float32 taps. For each row n of
// N = P*B*H and each 64-row q tile it computes
//   o1 = softmax(q K_cross^T / sqrt(D)) V_cross,   o2 = softmax(q K_self^T / sqrt(D)) V_self
// and writes the tile's similarity partials sum(o1 * o2), sum(o1^2), sum(o2^2) (cosine) or
// sum((o1 - o2)^2), 0, 0 (mse) in f32 to out[n, tile, 0:3]. Neither attention output leaves
// the block.
//
// Replaces the TPU kernel `cross_self_partials` (diffsim_tpu/ops/pallas/readout.py, body
// `_kernel`, pallas_call in `_pallas_partials`) for float32 taps: the scorers built with
// dtype=torch.float32 send every readout tap of S >= 512 here (SDXL's (80, 1024, 64) at 2
// triplets, DiT-XL/2's (256, 1024, 72) at 8, SD-1.5's up-block-2 tap at head dim 80). Numerics
// as fused_readout.cu's header states them for both dtypes: K1's online softmax, f32 logits,
// statistics and accumulation, 1 / rowsum after the last tile.
//
// Bound on the H100, per row: 8 S^2 D FLOP, three TF32 passes on the tensor cores at 495
// TFLOP/s (3xTF32, below), 2 S^2 exponentials at about 3.9e12/s and 5 S D 4 bytes. At
// (256, 1024, 72) that is 0.937 ms of products against 0.138 ms of exps and 0.113 ms of bytes:
// the tensor cores bound it, so the design spends its effort on them. The float32 SIMT rate
// (67 TFLOP/s) would put the same products at 2.31 ms, a floor no FMA design can pass.
//
// Design (sm_90a): one block of 4 warps per (64-row q tile, row), the grid (S / 64, N), two
// blocks resident on an SM. Q comes to shared memory once; then the block runs
// attention_tf32.cuh's 3xTF32 pass (mma.sync.m16n8k8, each float32 operand split into TF32 hi and
// lo where its fragment is loaded, K/V in 64-key tiles double-buffered by cp.async, scores and
// probabilities in registers, a fresh tensor-core P V sum per tile) twice: the cross pass, then
// the self pass. K1's float32 path runs the same pass once. Between the passes each thread
// normalises its share of O1 (1 / l) and keeps it: in registers up to D = 80 (every head dim a
// model routes here), so the two passes share the block's two-blocks-an-SM shared memory; above
// that, where a second accumulator in registers would spill, parked in shared memory at a
// 128-float stride, each thread its own elements (no bank conflicts), as the bf16 path parks it.
// After the self pass each thread forms the partials from O1 and the normalised O2 element by
// element in a fixed order, reduces them over its warp with shuffles and over the four warps in
// a fixed order, and thread 0 writes the tile's triple: a score repeats exactly from run to run.
// Each D % 8 == 0 up to 128 has its own instantiation, so every loop has a fixed trip count.
// Why not wgmma: TF32 wgmma takes its B operand from shared memory only K-major, and V stored
// (key, d) is N-major for P V (fused_attention.cu). The previous design of this path (plain
// FMAs, both accumulators in shared memory) is kept as a yardstick in fused_readout_v2.cu.
//
// C interface (loaded with ctypes): fused_readout_fwd, the same entry point as fused_readout.cu's,
// takes dtype 0 here; it returns cudaGetLastError().

#include "attention_tf32.cuh"

namespace {

using namespace attn;

constexpr int O1_REGS_MAX_D = 80;  // O1 in registers up to this head dim, parked above it

template <int D>
struct ReadoutSmem {
  static constexpr bool O1_IN_REGS = D <= O1_REGS_MAX_D;
  static constexpr size_t O1 = SmemF32<D>::TOTAL;  // parked O1: [D / 2][THREADS] floats
  static constexpr size_t RED = O1 + (O1_IN_REGS ? 0 : size_t(D / 2) * THREADS * 4);
  static constexpr size_t TOTAL = RED + WARPS * 4 * 4;  // [warp][3 partials + pad]
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
readout_tf32(const float* __restrict__ q, const float* __restrict__ k1,
             const float* __restrict__ v1, const float* __restrict__ k2,
             const float* __restrict__ v2, float* __restrict__ out, int s_len, float scale_log2,
             int mse) {
  constexpr int KS = D / 8;  // n8 tiles of O
  using L = ReadoutSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* o1_park = reinterpret_cast<float*>(smem + L::O1) + threadIdx.x;
  float* red = reinterpret_cast<float*>(smem + L::RED);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head = size_t(blockIdx.y) * s_len * D;

  copy_q_f32<D>(smem, q + head + size_t(blockIdx.x) * BQ * D);
  float acc[KS][4], l_run[2];
  attend_tf32<D>(smem, k1 + head, v1 + head, s_len, scale_log2, 0.0f, acc, l_run);
  // acc[n][e]: row g (e < 2) or g + 8, column 8 n + 2 t + e % 2; O1 = acc / l, kept
  float o1[L::O1_IN_REGS ? KS : 1][4];
  {
    const float inv[2] = {1.0f / quad_sum(l_run[0]), 1.0f / quad_sum(l_run[1])};
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (L::O1_IN_REGS) {
          o1[n][e] = acc[n][e] * inv[e / 2];
        } else {
          o1_park[(4 * n + e) * THREADS] = acc[n][e] * inv[e / 2];
        }
      }
  }
  attend_tf32<D>(smem, k2 + head, v2 + head, s_len, scale_log2, 0.0f, acc, l_run);

  const float inv[2] = {1.0f / quad_sum(l_run[0]), 1.0f / quad_sum(l_run[1])};
  float part[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x;
      if constexpr (L::O1_IN_REGS) {
        x = o1[n][e];
      } else {
        x = o1_park[(4 * n + e) * THREADS];
      }
      const float y = acc[n][e] * inv[e / 2];
      if (mse) {
        const float d = x - y;
        part[0] = fmaf(d, d, part[0]);
      } else {
        part[0] = fmaf(x, y, part[0]);
        part[1] = fmaf(x, x, part[1]);
        part[2] = fmaf(y, y, part[2]);
      }
    }
  // the tile's sums: each warp's by shuffles, then the four warps in order
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int off = 16; off > 0; off /= 2) part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
  if (lane == 0)
    for (int k = 0; k < 3; ++k) red[4 * warp + k] = part[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    float* dst = out + (size_t(blockIdx.y) * gridDim.x + blockIdx.x) * 3;
    for (int k = 0; k < 3; ++k) dst[k] = (red[k] + red[4 + k]) + (red[8 + k] + red[12 + k]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k1, const void* v1, const void* k2, const void* v2,
                   float* out, int n, int s, float scale, int mse, cudaStream_t stream) {
  constexpr size_t bytes = ReadoutSmem<D>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(readout_tf32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  readout_tf32<D><<<dim3(s / BQ, n), THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k1), static_cast<const float*>(v1),
      static_cast<const float*>(k2), static_cast<const float*>(v2), out, s, scale * LOG2E, mse);
  return cudaGetLastError();
}

// launch at the head dim d (d % 8 == 0, d <= 128): one instantiation per width
template <int D = 8>
cudaError_t dispatch(const void* q, const void* k1, const void* v1, const void* k2,
                     const void* v2, float* out, int n, int s, int d, float scale, int mse,
                     cudaStream_t st) {
  if constexpr (D > 128) {
    return cudaErrorInvalidValue;
  } else {
    return d == D ? launch<D>(q, k1, v1, k2, v2, out, n, s, scale, mse, st)
                  : dispatch<D + 8>(q, k1, v1, k2, v2, out, n, s, d, scale, mse, st);
  }
}

}  // namespace

extern "C" {

// q, k1, v1 (cross), k2, v2 (self): contiguous float32 (n, s, d); out: (n, s / 64, 3) float32;
// dtype 0 (float32; bf16 is fused_readout.cu's); mse 0 = cosine partials, 1 = squared-difference
// partial. Requires s % 64 == 0, d % 8 == 0, 0 < d <= 128, 0 < n <= 65535.
int fused_readout_fwd(const void* q, const void* k1, const void* v1, const void* k2,
                      const void* v2, void* out, int n, int s, int d, float scale, int dtype,
                      int mse, void* stream) {
  if (dtype != 0 || n <= 0 || n > 65535 || s <= 0 || s % BQ != 0 || d <= 0 || d > 128 ||
      d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(q, k1, v1, k2, v2, static_cast<float*>(out), n, s, d, scale,
                                   mse, static_cast<cudaStream_t>(stream)));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
