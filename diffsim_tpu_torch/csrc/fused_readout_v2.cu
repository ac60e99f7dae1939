// The previous designs of K3's two paths, kept only as yardsticks: chip_smoke.py times the
// redesigned kernels (fused_readout.cu, fused_readout_f32.cu) against them in the same run, on
// the same inputs. No path of the port calls them. Their designs, as PERF.md describes them:
//   * bf16 v2 (fused_readout_v2_fwd): one block of 4 warps per (64-row q tile, row); each warp
//     owns 16 q rows; the block runs the cross pass, then the self pass, over one Q tile loaded
//     once, through attention_common.cuh's mma.sync tile loop (K/V tiles of 64 keys
//     double-buffered with cp.async, S, P and both accumulators in registers);
//   * float32 v1, the first design of the float32 path (fused_readout_f32_v1_fwd): the same
//     block and passes through attention_common.cuh's plain-FMA tile loop (attend_f32), the
//     score tile and both accumulators in shared memory, bound by the 67 TFLOP/s FP32 SIMT rate.
// Both epilogues normalise the two outputs and reduce the partials over the warp with shuffles
// and over the block through shared memory, in a fixed order, into out[n, tile, 0:3].
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

using namespace attn;

// Sum of x over the block (4 warps) in a fixed order; the result is valid in thread 0.
__device__ inline float block_sum(float x, float* red, int slot) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[slot * WARPS + warp] = x;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) total += red[slot * WARPS + w];
  return total;
}

__device__ inline void write_partials(float* out, float a, float b, float c, float* red) {
  a = block_sum(a, red, 0);
  b = block_sum(b, red, 1);
  c = block_sum(c, red, 2);
  if (threadIdx.x == 0) {
    float* dst = out + (size_t(blockIdx.y) * gridDim.x + blockIdx.x) * 3;
    dst[0] = a;
    dst[1] = b;
    dst[2] = c;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, both accumulators in registers
// ---------------------------------------------------------------------------

template <int DP>
__host__ __device__ constexpr size_t readout_smem_bytes() {
  return bf16_smem_bytes<DP>() + 3 * WARPS * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
readout_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k1, const bf16* __restrict__ v1,
             const bf16* __restrict__ k2, const bf16* __restrict__ v2, float* __restrict__ out,
             int s_len, int d, float scale_log2, int mse) {
  constexpr int TILE = BQ * (DP + 8);
  constexpr int NT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;
  bf16* Vs = Ks + 2 * TILE;
  float* red = reinterpret_cast<float*>(smem_raw + bf16_smem_bytes<DP>());

  const int t4 = threadIdx.x % 4;
  const size_t head = size_t(blockIdx.y) * s_len * d;
  zero_padding_bf16<DP>(Qs, d);
  unsigned qf[DP / 16][4];
  load_q_bf16<DP>(qf, Qs, q + head + size_t(blockIdx.x) * BQ * d, d);

  float o1[NT][4], l1[2], o2[NT][4], l2[2];
  attend_bf16<DP>(qf, k1 + head, v1 + head, s_len, d, scale_log2, Ks, Vs, o1, l1);
  attend_bf16<DP>(qf, k2 + head, v2 + head, s_len, d, scale_log2, Ks, Vs, o2, l2);

  float a = 0.0f, b = 0.0f, c = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv1 = 1.0f / quad_sum(l1[i]), inv2 = 1.0f / quad_sum(l2[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (n * 8 + 2 * t4 + j >= d) continue;  // padding columns (zero in both)
        const float x = o1[n][2 * i + j] * inv1, y = o2[n][2 * i + j] * inv2;
        if (mse) {
          a = fmaf(x - y, x - y, a);
        } else {
          a = fmaf(x, y, a);
          b = fmaf(x, x, b);
          c = fmaf(y, y, c);
        }
      }
    }
  }
  write_partials(out, a, b, c, red);
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k1, const void* v1, const void* k2,
                        const void* v2, float* out, int n, int s, int d, float scale, int mse,
                        cudaStream_t stream) {
  constexpr size_t bytes = readout_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(readout_bf16<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  readout_bf16<DP><<<dim3(s / BQ, n), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k1), static_cast<const bf16*>(v1),
      static_cast<const bf16*>(k2), static_cast<const bf16*>(v2), out, s, d, scale * LOG2E,
      mse);
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

// ---------------------------------------------------------------------------
// float32 v1: plain FMAs, both accumulators in shared memory
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
readout_f32(const float* __restrict__ q, const float* __restrict__ k1,
            const float* __restrict__ v1, const float* __restrict__ k2,
            const float* __restrict__ v2, float* __restrict__ out, int s_len, int d, float scale,
            int mse) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutF32 L = make_layout_f32(d, 2);
  float* red = reinterpret_cast<float*>(smem + L.total);
  const size_t head = size_t(blockIdx.y) * s_len * d;
  load_tile_f32(reinterpret_cast<float*>(smem + L.q), L.ld_qkv,
                q + head + size_t(blockIdx.x) * BQ * d, d);
  attend_f32(L, smem, 0, k1 + head, v1 + head, s_len, d, scale);
  attend_f32(L, smem, 1, k2 + head, v2 + head, s_len, d, scale);
  __syncthreads();

  const float* O1 = reinterpret_cast<const float*>(smem + L.o[0]);
  const float* O2 = reinterpret_cast<const float*>(smem + L.o[1]);
  const float* L1 = reinterpret_cast<const float*>(smem + L.l[0]);
  const float* L2 = reinterpret_cast<const float*>(smem + L.l[1]);
  float a = 0.0f, b = 0.0f, c = 0.0f;
  for (int i = threadIdx.x; i < BQ * d; i += THREADS) {
    const int r = i / d, col = i % d;
    const float x = O1[r * L.ld_o + col] * (1.0f / L1[r]);
    const float y = O2[r * L.ld_o + col] * (1.0f / L2[r]);
    if (mse) {
      a = fmaf(x - y, x - y, a);
    } else {
      a = fmaf(x, y, a);
      b = fmaf(x, x, b);
      c = fmaf(y, y, c);
    }
  }
  write_partials(out, a, b, c, red);
}

cudaError_t launch_f32(const void* q, const void* k1, const void* v1, const void* k2,
                       const void* v2, float* out, int n, int s, int d, float scale, int mse,
                       cudaStream_t stream) {
  const size_t bytes = make_layout_f32(d, 2).total + 3 * WARPS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(readout_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  readout_f32<<<dim3(s / BQ, n), THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k1),
      static_cast<const float*>(v1), static_cast<const float*>(k2),
      static_cast<const float*>(v2), out, s, d, scale, mse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k1, v1 (cross), k2, v2 (self): contiguous bf16 (n, s, d); out: (n, s / 64, 3) float32;
// mse 0 = cosine partials, 1 = squared-difference partial.
// Requires s % 64 == 0, d % 8 == 0, 0 < d <= 128, 0 < n <= 65535.
int fused_readout_v2_fwd(const void* q, const void* k1, const void* v1, const void* k2,
                         const void* v2, void* out, int n, int s, int d, float scale, int mse,
                         void* stream) {
  if (n <= 0 || n > 65535 || s <= 0 || s % BQ != 0 || d <= 0 || d > 128 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_bf16(q, k1, v1, k2, v2, static_cast<float*>(out), n, s, d,
                                        scale, mse, static_cast<cudaStream_t>(stream)));
}

// The same on contiguous float32 tensors, through the float32 v1 design.
int fused_readout_f32_v1_fwd(const void* q, const void* k1, const void* v1, const void* k2,
                             const void* v2, void* out, int n, int s, int d, float scale,
                             int mse, void* stream) {
  if (n <= 0 || n > 65535 || s <= 0 || s % BQ != 0 || d <= 0 || d > 128 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_f32(q, k1, v1, k2, v2, static_cast<float*>(out), n, s, d,
                                     scale, mse, static_cast<cudaStream_t>(stream)));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
