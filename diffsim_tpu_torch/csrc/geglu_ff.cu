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
// that has to hide under the tensor cores. The float32 path keeps erff.
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
//
// float32 (the scorers built with dtype=torch.float32: SD-1.5's (98304, 320) and (24576, 640),
// SDXL's (rows x 4096, 640)): the same two GEMMs and cast point, 3xTF32 on the tensor cores.
// Bound: the same 24 N C^2 FLOP, three TF32 passes at 495 TFLOP/s: 1.464 ms at (98304, 320) and
// at (24576, 640), against 0.08 ms of bytes; the float32 SIMT rate (67 TFLOP/s) would put them at
// 3.61 ms, a floor no FMA design can pass. Each float32 operand is split where its fragment is
// loaded into hi = tf32(x), rounded to nearest, and lo = x - hi (attention_common.cuh
// split_tf32), and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation (the
// dropped a_lo b_lo is ~2^-22 relative; one TF32 pass misses the 1e-4 check against the plain
// version, tests/test_torch_port_f32_tc.py). Design: a block of 8 warps (4 along the rows x 2
// along the columns) per 128-row tile, mma.sync.m16n8k8 with K1's permuted k order (a thread's
// two k values of a row are one 8-byte load), 32-column k panels through a 4-stage cp.async ring
// at a 40-float leading dim (conflict-free fragment loads); GEMM1 tiles are 64 y columns whose
// h and gate W rows share the panel (a warp 32 rows x 32 columns of each, the GEGLU epilogue in
// f32 with CUDA's erff, y stored in float32), GEMM2 tiles 160 output columns, K = 4C. The
// tensor cores truncate their f32 sums (a bias towards zero of up to an ulp a step), so no sum of
// theirs runs long: each panel's products are a fresh sum of 12 steps, added to the f32
// accumulator with one rounded add; at C = 640 GEMM2's K = 2560 is 80 panels, where one running
// sum would take 960 truncating steps (the CPU emulation holds both). Why mma.sync and not TF32
// wgmma: both B operands (W1, W2) are K-major, which TF32 wgmma takes, but its operands come
// from shared memory as TF32 values, so each panel would first be split into hi and lo copies
// there (a conversion pass and twice the shared memory a stage); the split at fragment load
// needs neither and shares K1's primitives. wgmma is the later design's lever. The first design
// of this path (64 x 64 tiles of plain FMAs) is kept as a yardstick in geglu_ff_v2.cu.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <math.h>

#include "attention_common.cuh"  // the 3xTF32 fragments, cp.async

using bf16 = __nv_bfloat16;

namespace {

constexpr int BK = 32;  // k columns of a float32 panel: one pipeline stage, one fresh sum

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
// float32: two 3xTF32 mma.sync GEMMs of one template
// ---------------------------------------------------------------------------

constexpr int T_BM = 128;       // rows of a block tile
constexpr int T_LD = BK + 8;    // 40 floats = 8 mod 16: conflict-free 8-byte fragment loads
constexpr int T_THREADS = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr int T_STAGES = 4;

// NB = the B tile's W rows: GEMM1 (GEGLU) 64 h rows over the 64 gate rows, GEMM2 160 output
// columns (160 divides 320, 640 and 1280; narrower C runs one partial tile).
template <int NB, bool GEGLU>
struct TfCfg {
  static constexpr int OUT_COLS = GEGLU ? NB / 2 : NB;  // output columns of a tile
  static constexpr int SETS = GEGLU ? 2 : 1;            // accumulator sets: h and gate, or out
  static constexpr int WN = OUT_COLS / 2;               // output columns of a warp
  static constexpr int NT = WN / 8;                     // n8 tiles of a warp, per set
  static constexpr int STAGE_FLOATS = (T_BM + NB) * T_LD;
  static constexpr size_t SMEM = size_t(T_STAGES) * STAGE_FLOATS * sizeof(float);
};

// 16-byte async copy; src_bytes = 0 fills the destination with zeros (rows past the edge)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out (m, n_out) = epilogue(A (m, k) @ B^T), B = W's rows: GEGLU, h rows j and gate rows
// n_out + j; else out rows j. Block (x, y) computes the tile at rows 128 y, columns OUT_COLS x;
// warp (wm, wn) rows 32 wm + [0, 32) and columns WN wn + [0, WN) of it, two m16 tiles by NT n8
// tiles per set. Each 32-column k panel's products are a fresh tensor-core sum (12 truncating
// steps: 4 k8 steps of 3 TF32 products), added to the f32 accumulator with one rounded add.
template <int NB, bool GEGLU>
__global__ void __launch_bounds__(T_THREADS, 1)
gemm_tf32(const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
          float* __restrict__ out, int m, int n_out, int k) {
  using C = TfCfg<NB, GEGLU>;
  constexpr int NT = C::NT, SETS = C::SETS;
  extern __shared__ __align__(128) float tsm[];
  const int m0 = blockIdx.y * T_BM, j0 = blockIdx.x * C::OUT_COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t = lane % 4;
  const int panels = k / BK;

  // stage `slot` <- k panel kp: the tile's 128 A rows, then its NB W rows
  auto load_stage = [&](int slot, int kp) {
    float* As = tsm + slot * C::STAGE_FLOATS;
    float* Bs = As + T_BM * T_LD;
    const int k0 = kp * BK;
    for (int i = threadIdx.x; i < (T_BM + NB) * (BK / 4); i += T_THREADS) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      if (r < T_BM) {
        const bool valid = m0 + r < m;
        cp_async16_zfill(As + r * T_LD + c, A + size_t(valid ? m0 + r : 0) * k + k0 + c,
                         valid ? 16 : 0);
      } else {
        const int rb = r - T_BM;
        const int wrow = GEGLU && rb >= C::OUT_COLS ? n_out + j0 + rb - C::OUT_COLS : j0 + rb;
        const bool valid = GEGLU || wrow < n_out;  // GEGLU: n_out = 4C, a multiple of 64
        cp_async16_zfill(Bs + rb * T_LD + c, W + size_t(valid ? wrow : 0) * k + k0 + c,
                         valid ? 16 : 0);
      }
    }
  };

  float acc[SETS][2][NT][4], part[SETS][2][NT][4];
#pragma unroll
  for (int p = 0; p < SETS; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[p][i][j][0] = acc[p][i][j][1] = acc[p][i][j][2] =
          acc[p][i][j][3] = 0.0f;

#pragma unroll
  for (int st = 0; st < T_STAGES - 1; ++st) {
    if (st < panels) load_stage(st, st);
    attn::cp_async_commit();
  }
  for (int kp = 0; kp < panels; ++kp) {
    cp_async_wait<T_STAGES - 2>();  // panel kp has landed
    __syncthreads();                // ... and every warp is done with the slot refilled below
    if (kp + T_STAGES - 1 < panels) load_stage((kp + T_STAGES - 1) % T_STAGES, kp + T_STAGES - 1);
    attn::cp_async_commit();

    const float* As = tsm + (kp % T_STAGES) * C::STAGE_FLOATS;
    const float* Bs = As + T_BM * T_LD;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        attn::load_a_3xtf32(ah[i], al[i], As, T_LD, 32 * wm + 16 * i, 8 * ks, g, t);
#pragma unroll
      for (int p = 0; p < SETS; ++p)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // W stored (n, k) row-major is the col-major B operand, in the permuted k order
          const float2 bp = *reinterpret_cast<const float2*>(
              Bs + (p * C::OUT_COLS + wn * C::WN + 8 * j + g) * T_LD + 8 * ks + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          attn::split_tf32(bp.x, bh0, bl0);
          attn::split_tf32(bp.y, bh1, bl1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {  // the small products first
            if (ks == 0) {
              attn::mma_tf32_first(part[p][i][j], al[i], bh0, bh1);
            } else {
              attn::mma_tf32(part[p][i][j], al[i], bh0, bh1);
            }
            attn::mma_tf32(part[p][i][j], ah[i], bl0, bl1);
            attn::mma_tf32(part[p][i][j], ah[i], bh0, bh1);
          }
        }
    }
#pragma unroll
    for (int p = 0; p < SETS; ++p)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][i][j][e] += part[p][i][j][e];
  }

  // accumulator layout: acc[p][i][j] holds rows 32 wm + 16 i + g (elements 0, 1) and + 8 (2, 3),
  // columns WN wn + 8 j + 2 t (+ 1) of the tile
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j0 + wn * C::WN + 8 * j + 2 * t;
    if (!GEGLU && col >= n_out) continue;  // n_out is even: col + 1 < n_out too
    const float2 b0 = *reinterpret_cast<const float2*>(bias + col);
    float2 bg = make_float2(0.0f, 0.0f);
    if constexpr (GEGLU) bg = *reinterpret_cast<const float2*>(bias + n_out + col);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 32 * wm + 16 * i + g + 8 * h;
        if (row >= m) continue;  // rows past N: zero-filled A rows, not stored
        float y0 = acc[0][i][j][2 * h] + b0.x, y1 = acc[0][i][j][2 * h + 1] + b0.y;
        if constexpr (GEGLU) {
          y0 = gelu_gate(y0, acc[SETS - 1][i][j][2 * h] + bg.x);
          y1 = gelu_gate(y1, acc[SETS - 1][i][j][2 * h + 1] + bg.y);
        }
        *reinterpret_cast<float2*>(out + size_t(row) * n_out + col) = make_float2(y0, y1);
      }
  }
}

template <int NB, bool GEGLU>
cudaError_t gemm_3xtf32(const void* a, const void* w, const void* bias, void* out, int m,
                        int n_out, int k, cudaStream_t stream) {
  using C = TfCfg<NB, GEGLU>;
  cudaError_t err = cudaFuncSetAttribute(gemm_tf32<NB, GEGLU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_out + C::OUT_COLS - 1) / C::OUT_COLS, (m + T_BM - 1) / T_BM);
  gemm_tf32<NB, GEGLU><<<grid, T_THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), m, n_out, k);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* y, void* out, int n, int c, cudaStream_t st) {
  cudaError_t err = gemm_3xtf32<128, true>(x, w1, b1, y, n, 4 * c, c, st);
  if (err != cudaSuccess) return err;
  return gemm_3xtf32<160, false>(y, w2, b2, out, n, c, 4 * c, st);
}

}  // namespace

extern "C" {

// x (n, c), w1 (8c, c), b1 (8c), w2 (c, 4c), b2 (c), y (n, 4c) scratch, out (n, c); all
// contiguous and 16-byte aligned, one dtype: 0 = float32, 1 = bfloat16. Requires c % 32 == 0
// and 0 < ceil(n / 64) <= 65535.
int geglu_ff_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* y, void* out, int n, int c, int dtype, void* stream) {
  if (n <= 0 || (n + 63) / 64 > 65535 || c <= 0 || c % BK != 0)
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
