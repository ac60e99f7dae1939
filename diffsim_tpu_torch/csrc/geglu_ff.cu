// K2: the GEGLU feed-forward of the UNet transformer blocks,
//     out = (h * gelu_erf(g)) @ W2^T + b2,   [h, g] = x @ W1^T + b1,
// with x (N, C), W1 (8C, C), b1 (8C), W2 (C, 4C), b2 (C) in the nn.Linear (out, in) layout.
//
// Replaces the TPU kernel `fused_geglu_ff` (diffsim_tpu/ops/pallas/ff.py, body `_kernel`).
// Numerics contract, kept from that kernel: both products accumulate in f32; b1 is added and
// the GEGLU epilogue h * 0.5 g (1 + erf(g / sqrt 2)) runs in f32; the intermediate y is cast to
// x's dtype (the same cast point as the TPU kernel); b2 is added in f32 and the result cast to
// x's dtype. The bf16 path evaluates erf with the TPU kernel's own Abramowitz & Stegun 7.1.26
// approximation (|err| <= 1.5e-7, far below bf16's resolution of y): one reciprocal and one
// exp2 on the special-function units and about a dozen FMA-unit operations, about half of what
// CUDA's erff costs once a warp runs both of its branches, and the epilogue is the part of GEMM1
// that has to hide under the tensor cores. The float32 path keeps erff, as a tight check.
//
// Bound on the H100: 24 N C^2 FLOP on the bf16 tensor cores (989 TFLOP/s) against x and out
// (4 N C bytes) plus the weights: 0.244 ms at (98304, 320). GEMM1 (16 N C^2, K = C) is bound by
// operations, and its epilogue costs about half of its tensor time at C = 320; GEMM2 (8 N C^2,
// K = 4C) sits at the balance point at C = 320, where reading y and writing out weigh as much as
// its products. y goes through device memory (N 4C 2 bytes each way): a 128-row y tile is 320 KB
// at C = 640, beyond the 227 KB of shared memory, and an out accumulator of 64 x C f32 a
// warpgroup would need 320 registers a thread at C = 640.
//
// bf16 design (sm_90a): two persistent GEMM kernels of one template, one block of 384 threads
// per SM walking output tiles (the columns of a row block adjacent, so concurrent blocks share
// its A rows in L2):
//   * a producer warpgroup (setmaxnreg 40) whose one thread streams k panels of 64 columns
//     (128-byte rows, 128-byte swizzle) with TMA into an mbarrier-guarded ring of 6-7 stages:
//     each stage holds a 128-row A panel and the B panel of the tile's W rows; TMA zero-fills the
//     rows past N and the columns past C (C % 64 == 32);
//   * two consumer warpgroups (setmaxnreg 232) that take the block's tiles in turns, each tile
//     whole: 128 rows as two m64 halves, wgmma with both operands in shared memory, f32
//     accumulators in registers. A named barrier passes the turn to issue products, so one
//     consumer's epilogue runs while the other's products keep the tensor cores busy
//     (ping-pong), and the ring runs on into the next tile meanwhile;
//   * GEMM1 tiles are 128 rows x 64 y columns: a B panel is 64 W1 rows of h (j0..) stacked on
//     the 64 gate rows (4C + j0..), so one m64n128 wgmma gives h and the gate side by side
//     (64 + 64 accumulators a thread a half). Epilogue: + b1, h * gelu(g) in f32, cast, y stored;
//   * GEMM2 tiles are 128 rows x 160 output columns (160 divides 320, 640 and 1280; narrower C
//     runs one partial tile), K = 4C; epilogue + b2, cast, stored.
// float32 (a numerical check): 64x64 tiles with plain FMAs.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <math.h>

#include "hopper_common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BK = 32;  // k slice of the float32 path

// float32 path: CUDA's erff
__device__ inline float gelu_gate(float h, float g) {
  return h * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, persistent, a producer warpgroup and two ping-ponged consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int NWG = 2;                       // consumer warpgroups
constexpr int THREADS_WG = (NWG + 1) * 128;  // + the producer warpgroup
// the producer gives its registers to the consumers: 128 x 40 + 256 x 232 <= 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int TILE_M = 128;            // rows of a tile: two m64 halves
constexpr int PANEL_K = 64;            // k columns of a panel
constexpr int SPAN = 2 * PANEL_K;      // bytes of a panel row = the swizzle span
constexpr int A_BYTES = TILE_M * SPAN;  // one A panel
constexpr uint32_t BAR_TURN = 1;  // named barriers 1, 2: consumer c's turn at the tensor cores
constexpr uint32_t TURN_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// NB = the B panel's rows = the wgmma's N: GEMM1 (GEGLU) 64 h rows + 64 gate rows, GEMM2 160.
template <int NB, bool GEGLU>
struct GemmCfg {
  static constexpr int OUT_COLS = GEGLU ? NB / 2 : NB;  // output columns of a tile
  static constexpr int B_BYTES = NB * SPAN;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT = (232448 - 1024 - 256) / STAGE_BYTES;  // of 227 KB
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  // 1024 bytes of alignment slack, the ring, then the mbarriers
  static constexpr size_t SMEM = 1024 + size_t(STAGES) * STAGE_BYTES + 256;
  static_assert(STAGES >= 4, "the ring needs a few stages to run ahead of the products");
};

// 0.5 g (1 + erf(g / sqrt 2)), erf(x) = sign(x) (1 - poly(t) exp(-x^2)), t = 1 / (1 + p |x|):
// Abramowitz & Stegun 7.1.26, the TPU kernel's coefficients (diffsim_tpu/ops/pallas/ff.py _erf)
__device__ __forceinline__ float gelu_as(float g) {
  const float x = g * 0.70710678118654752f;
  const float t = hopper::rcp_approx(fmaf(0.3275911f, fabsf(x), 1.0f));
  const float poly =
      t * fmaf(fmaf(fmaf(fmaf(1.061405429f, t, -1.453152027f), t, 1.421413741f), t,
                    -0.284496736f),
               t, 0.254829592f);
  const float erf_abs = fmaf(-poly, hopper::ex2(-LOG2E * x * x), 1.0f);
  const float half_g = 0.5f * g;
  return fmaf(half_g, copysignf(erf_abs, x), half_g);
}

// out (m, n_out) = epilogue(A (m, k) @ B^T): B holds n_out rows (GEMM2) or 2 n_out rows, h then
// gate (GEMM1). Item i of n_items is the tile at row block i / col_tiles, column block
// i % col_tiles; block b takes items b, b + gridDim.x, ..., and its local item `it` goes to
// consumer it % NWG.
template <int NB, bool GEGLU>
__global__ void __launch_bounds__(THREADS_WG, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
           const bf16* __restrict__ bias, bf16* __restrict__ out, int m, int n_out, int k,
           int col_tiles, int n_items) {
  using C = GemmCfg<NB, GEGLU>;
  using namespace hopper;
  constexpr int NA = NB / 2;  // accumulators a thread per m64 half
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;

  // warp-uniform by construction, so the compiler sees the role branches as non-divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int k_panels = (k + PANEL_K - 1) / PANEL_K;
  const int n_blocks = gridDim.x;
  const int n_local = (n_items - static_cast<int>(blockIdx.x) + n_blocks - 1) / n_blocks;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // the four warps of the one consumer that reads the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0) {
      tma_prefetch_map(&tm_a);
      tma_prefetch_map(&tm_b);
      int g = 0;  // panels issued so far: the ring position
      for (int it = 0; it < n_local; ++it) {
        const int item = blockIdx.x + it * n_blocks;
        const int m0 = item / col_tiles * TILE_M, j0 = item % col_tiles * C::OUT_COLS;
        for (int kp = 0; kp < k_panels; ++kp, ++g) {
          const int st = g % C::STAGES;
          mbar_wait(empty + st, ((g / C::STAGES) & 1) ^ 1);  // passes at once on the first round
          mbar_arrive_expect_tx(full + st, C::STAGE_BYTES);
          unsigned char* a = ring + st * C::STAGE_BYTES;
          tma_load_3d(a, &tm_a, kp * PANEL_K, m0, 0, full + st);
          tma_load_3d(a + A_BYTES, &tm_b, kp * PANEL_K, j0, 0, full + st);
          if constexpr (GEGLU)  // the gate rows under the h rows
            tma_load_3d(a + A_BYTES + C::B_BYTES / 2, &tm_b, kp * PANEL_K, n_out + j0, 0,
                        full + st);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = warp / 4;
    const int g8 = lane / 4, t = lane % 4;
    auto desc = [](const unsigned char* panel, int kk) {  // K-major, k16 step kk of the panel
      return make_desc(panel + kk * 32, 16, 8 * SPAN, SPAN);
    };
    auto issue = [&](float (&acc)[2][NA], int g, bool first) {  // one panel's products
      const unsigned char* a = ring + (g % C::STAGES) * C::STAGE_BYTES;
      mbar_wait(full + g % C::STAGES, (g / C::STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANEL_K / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          WgmmaSS<NB>::mma(acc[h], desc(a + h * 64 * SPAN, kk), desc(a + A_BYTES, kk),
                           !first || kk > 0);
      wgmma_commit();
    };
    auto release = [&](int g) {  // this warp is done with panel g's stage
      if (lane == 0) mbar_arrive(empty + g % C::STAGES);
    };

    // The turns also keep the ring's parity waits sound: a consumer waits for ring position g
    // only after the other has issued every earlier position, so the stage's previous round has
    // completed (a wait on a barrier two phases behind would pass at once).
    float acc[2][NA];
    if (c == NWG - 1) named_arrive(BAR_TURN, TURN_THREADS);  // consumer 0 takes the first turn
    for (int it = c; it < n_local; it += NWG) {
      const int item = blockIdx.x + it * n_blocks;
      const int m0 = item / col_tiles * TILE_M, j0 = item % col_tiles * C::OUT_COLS;
      const int g0 = it * k_panels;  // ring position of the tile's first panel
      named_sync(BAR_TURN + c, TURN_THREADS);
      issue(acc, g0, true);
      for (int kp = 1; kp < k_panels; ++kp) {
        issue(acc, g0 + kp, false);
        wgmma_wait<1>();  // panel kp - 1's products are done: its stage goes back
        release(g0 + kp - 1);
      }
      // the other consumer issues its tile's products while this one drains and stores
      if (it + 1 < n_local) named_arrive(BAR_TURN + (c + 1) % NWG, TURN_THREADS);
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      release(g0 + k_panels - 1);

      // accumulator layout: this thread holds rows 16 (warp % 4) + g8 (+ 8) of each half,
      // columns 8 j + 2 t (+ 1) in acc[h][4 j + 0..1] (row g8) and acc[h][4 j + 2..3] (+ 8)
      const int r0 = m0 + 16 * (warp % 4) + g8;
      if constexpr (GEGLU) {
        float bh[NA / 8][2], bg[NA / 8][2];  // b1 of this thread's h and gate columns
#pragma unroll
        for (int j = 0; j < NA / 8; ++j) {
          const int col = j0 + 8 * j + 2 * t;
          const float2 vh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
          const float2 vg =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n_out + col));
          bh[j][0] = vh.x;
          bh[j][1] = vh.y;
          bg[j][0] = vg.x;
          bg[j][1] = vg.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = r0 + 64 * h + 8 * i;
            if (row >= m) continue;  // rows past N: zero-filled A rows, not stored
            bf16* orow = out + size_t(row) * n_out + j0 + 2 * t;
#pragma unroll
            for (int j = 0; j < NA / 8; ++j) {
              // h in columns 0..63 of the accumulator, the gate in 64..127
              const float y0 = (acc[h][4 * j + 2 * i] + bh[j][0]) *
                               gelu_as(acc[h][4 * (j + NA / 8) + 2 * i] + bg[j][0]);
              const float y1 = (acc[h][4 * j + 2 * i + 1] + bh[j][1]) *
                               gelu_as(acc[h][4 * (j + NA / 8) + 2 * i + 1] + bg[j][1]);
              *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(y0, y1);
            }
          }
      } else {
        float bo[NB / 8][2];  // b2 of this thread's columns (0 past n_out: not stored)
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int col = j0 + 8 * j + 2 * t;
          float2 v = make_float2(0.0f, 0.0f);
          if (col < n_out) v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
          bo[j][0] = v.x;
          bo[j][1] = v.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = r0 + 64 * h + 8 * i;
            if (row >= m) continue;
            bf16* orow = out + size_t(row) * n_out + j0 + 2 * t;
#pragma unroll
            for (int j = 0; j < NB / 8; ++j)
              if (j0 + 8 * j + 2 * t < n_out)  // n_out is even: col + 1 < n_out too
                *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
                    acc[h][4 * j + 2 * i] + bo[j][0], acc[h][4 * j + 2 * i + 1] + bo[j][1]);
          }
      }
    }
  }
}

// One persistent GEMM: a (m, k) and w (rows of B, k) bf16, contiguous.
template <int NB, bool GEGLU>
cudaError_t gemm_bf16(const void* a, const void* w, const void* bias, void* out, int m, int n_out,
                      int k, cudaStream_t stream) {
  using C = GemmCfg<NB, GEGLU>;
  CUtensorMap ta, tb;
  cudaError_t err = hopper::make_map_bf16(&ta, a, 1, m, k, TILE_M, PANEL_K);
  if (err == cudaSuccess)
    err = hopper::make_map_bf16(&tb, w, 1, GEGLU ? 2 * n_out : n_out, k, C::OUT_COLS, PANEL_K);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_wgmma<NB, GEGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const int col_tiles = (n_out + C::OUT_COLS - 1) / C::OUT_COLS;
  const int n_items = (m + TILE_M - 1) / TILE_M * col_tiles;
  const int grid = n_items < hopper::sm_count() ? n_items : hopper::sm_count();
  gemm_wgmma<NB, GEGLU><<<grid, THREADS_WG, C::SMEM, stream>>>(
      ta, tb, static_cast<const bf16*>(bias), static_cast<bf16*>(out), m, n_out, k, col_tiles,
      n_items);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* y, void* out, int n, int c, cudaStream_t st) {
  cudaError_t err = gemm_bf16<128, true>(x, w1, b1, y, n, 4 * c, c, st);
  if (err != cudaSuccess) return err;
  return gemm_bf16<160, false>(y, w2, b2, out, n, c, 4 * c, st);
}

// ---------------------------------------------------------------------------
// float32: 64x64 tiles, plain FMAs, each thread an 8x4 patch
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BN = 64, F_THREADS = 128;
constexpr int F_LDA = BK + 1;   // odd pad: conflict-free scalar reads
constexpr int F_LDC = F_BN + 4;
constexpr int F_A_BYTES = F_BM * F_LDA * sizeof(float);
constexpr int F_B_BYTES = F_BN * F_LDA * sizeof(float);
constexpr int F_C_BYTES = F_BM * F_LDC * sizeof(float);
// the output tiles (h and gate) reuse the operand tiles' memory after the k-loop
constexpr int F_BYTES = (F_A_BYTES + 2 * F_B_BYTES) > (2 * F_C_BYTES) ? (F_A_BYTES + 2 * F_B_BYTES)
                                                                      : (2 * F_C_BYTES);
static_assert(F_A_BYTES % 16 == 0 && F_B_BYTES % 16 == 0 && F_C_BYTES % 16 == 0, "alignment");

// Rows [row0, row0 + 64) x columns [k0, k0 + BK) of a row-major (rows, ld_src) matrix; rows at
// or past `rows` are zero.
__device__ inline void load_rows_f32(float* dst, const float* __restrict__ src, int row0,
                                     int rows, int ld_src, int k0) {
  constexpr int VPR = BK / 4;
  for (int i = threadIdx.x; i < 64 * VPR; i += F_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const int row = row0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < rows) val = *reinterpret_cast<const float4*>(src + size_t(row) * ld_src + k0 + c);
    dst[r * F_LDA + c] = val.x;
    dst[r * F_LDA + c + 1] = val.y;
    dst[r * F_LDA + c + 2] = val.z;
    dst[r * F_LDA + c + 3] = val.w;
  }
}

template <bool GEGLU>
__global__ void __launch_bounds__(F_THREADS)
gemm_f32(const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
         float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) unsigned char smem[F_BYTES];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + F_A_BYTES);
  float* Gs = reinterpret_cast<float*>(smem + F_A_BYTES + F_B_BYTES);
  float* Ch = reinterpret_cast<float*>(smem);
  float* Cg = reinterpret_cast<float*>(smem + F_C_BYTES);

  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float ch[8][4] = {}, cg[8][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    load_rows_f32(As, A, m0, M, K, k0);
    load_rows_f32(Bs, W, n0, N, K, k0);
    if constexpr (GEGLU) load_rows_f32(Gs, W + size_t(N) * K, n0, N, K, k0);
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty * 8 + i) * F_LDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx * 4 + j) * F_LDA + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ch[i][j] = fmaf(a[i], b[j], ch[i][j]);
      if constexpr (GEGLU) {
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Gs[(tx * 4 + j) * F_LDA + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cg[i][j] = fmaf(a[i], b[j], cg[i][j]);
      }
    }
  }
  __syncthreads();  // the output tiles alias the operand tiles
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int off = (ty * 8 + i) * F_LDC + tx * 4 + j;
      Ch[off] = ch[i][j];
      if constexpr (GEGLU) Cg[off] = cg[i][j];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < F_BM * F_BN; i += F_THREADS) {
    const int r = i / F_BN, c = i % F_BN;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    float h = Ch[r * F_LDC + c] + bias[col];
    if constexpr (GEGLU) h = gelu_gate(h, Cg[r * F_LDC + c] + bias[N + col]);
    out[size_t(row) * N + col] = h;
  }
}

template <bool GEGLU>
cudaError_t gemm(cudaStream_t st, const float* A, const float* W, const float* bias, float* out,
                 int M, int N, int K) {
  const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
  gemm_f32<GEGLU><<<grid, F_THREADS, 0, st>>>(A, W, bias, out, M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* y, void* out, int n, int c, cudaStream_t st) {
  const int hidden = 4 * c;
  cudaError_t err = gemm<true>(st, static_cast<const float*>(x), static_cast<const float*>(w1),
                               static_cast<const float*>(b1), static_cast<float*>(y), n, hidden, c);
  if (err != cudaSuccess) return err;
  return gemm<false>(st, static_cast<const float*>(y), static_cast<const float*>(w2),
                     static_cast<const float*>(b2), static_cast<float*>(out), n, c, hidden);
}

}  // namespace

extern "C" {

// x (n, c), w1 (8c, c), b1 (8c), w2 (c, 4c), b2 (c), y (n, 4c) scratch, out (n, c); all
// contiguous and 16-byte aligned, one dtype: 0 = float32, 1 = bfloat16. Requires c % 32 == 0
// and 0 < ceil(n / 64) <= 65535.
int geglu_ff_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* y, void* out, int n, int c, int dtype, void* stream) {
  if (n <= 0 || (n + F_BM - 1) / F_BM > 65535 || c <= 0 || c % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(launch_bf16(x, w1, b1, w2, b2, y, out, n, c, st));
  if (dtype == 0) return static_cast<int>(launch_f32(x, w1, b1, w2, b2, y, out, n, c, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
