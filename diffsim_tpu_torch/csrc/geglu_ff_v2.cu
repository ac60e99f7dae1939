// The previous designs of K2's two paths, kept only as yardsticks: chip_smoke.py times the
// redesigned kernels (geglu_ff.cu) against them in the same run, on the same inputs. No path of
// the port calls them. Their designs, as PERF.md describes them, both two GEMM kernels, (a)
// x @ W1^T with the h columns j and the gate columns 4C + j in one block tile and the GEGLU
// epilogue (CUDA's erff) on the accumulators, writing y (N, 4C), then (b) y @ W2^T + b2:
//   * bf16 v2 (geglu_ff_v2_fwd): mma.sync.m16n8k16 with f32 accumulation, 128-row block tiles of
//     8 warps (4 x 2, each 32 rows x 32 output columns), ldmatrix fragments and a 3-stage
//     cp.async pipeline over 32-deep k slices;
//   * float32 v1, the first design of the float32 path (geglu_ff_f32_v1_fwd): 64 x 64 block
//     tiles of 128 threads, each thread an 8 x 4 patch of plain FMAs over 32-deep k slices in
//     shared memory, bound by the 67 TFLOP/s FP32 SIMT rate.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int BK = 32;  // k slice, both dtypes

__device__ inline float gelu_gate(float h, float g) {
  return h * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, 3-stage cp.async pipeline
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 64;  // block tile: rows x output columns
constexpr int THREADS = 256;      // 8 warps: 4 along rows x 2 along columns
constexpr int STAGES = 3;
constexpr int LDS = BK + 8;       // 16-byte row pad: conflict-free ldmatrix

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros (rows past the edge)
__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ inline void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool GEGLU>
constexpr size_t smem_bytes() {  // host side; B tile rows: h rows, then gate rows
  return size_t(STAGES) * (BM + (GEGLU ? 2 * BN : BN)) * LDS * sizeof(bf16);
}

// (M, N) = A (M, K) @ W[:N]^T (+ bias); with GEGLU also the gate product against W[N:2N] and
// the GEGLU epilogue. Requires K % 32 == 0.
template <bool GEGLU>
__global__ void __launch_bounds__(THREADS)
gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ W, const bf16* __restrict__ bias,
          bf16* __restrict__ out, int M, int N, int K) {
  constexpr int BR = GEGLU ? 2 * BN : BN;  // B tile rows: h rows, then gate rows
  constexpr int STAGE = (BM + BR) * LDS;  // elements per stage: A tile then B tile
  constexpr int NG = GEGLU ? 2 : 1;       // products per output element (h, gate)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t4 = lane % 4;
  const int k_tiles = K / BK;

  // stage s of k slice kt: A rows m0.., B rows n0.. (and N + n0.. for the gate)
  auto load_stage = [&](int slot, int kt) {
    bf16* As = smem + slot * STAGE;
    bf16* Bs = As + BM * LDS;
    const int k0 = kt * BK;
    for (int i = threadIdx.x; i < (BM + BR) * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bf16* src;
      bf16* dst;
      bool valid;
      if (r < BM) {
        const int row = m0 + r;
        valid = row < M;
        src = A + size_t(valid ? row : 0) * K + k0 + c;
        dst = As + r * LDS + c;
      } else {
        const int rb = r - BM;  // 0..BR: h rows, then gate rows
        const int col = n0 + rb % BN;
        valid = col < N;
        src = W + size_t((valid ? col : 0) + (rb / BN) * N) * K + k0 + c;
        dst = Bs + rb * LDS + c;
      }
      cp_async16(dst, src, valid ? 16 : 0);
    }
  };

  float acc[NG][2][4][4];  // [h|gate][m16 tile][n8 tile][fragment]
#pragma unroll
  for (int p = 0; p < NG; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][i][j][0] = acc[p][i][j][1] = acc[p][i][j][2] =
          acc[p][i][j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // slice kt has landed
    __syncthreads();              // ... and every warp is done with the slot refilled below
    if (kt + STAGES - 1 < k_tiles) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const bf16* As = smem + (kt % STAGES) * STAGE;
    const bf16* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], As + (wm * 32 + i * 16 + lane % 16) * LDS + kk + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < NG; ++p) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          // W stored (n, k) row-major is the col-major B operand; one x4 load = two n8 tiles
          unsigned b[4];
          ldmatrix_x4(b, Bs + (p * BN + wn * 32 + jp * 16 + lane % 8 + (lane / 16) * 8) * LDS +
                             kk + ((lane / 8) % 2) * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[p][i][2 * jp], a[i], b[0], b[1]);
            mma_bf16(acc[p][i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
  }

  // epilogue on the accumulators: rows g / g + 8 of each m16 tile, columns 2t, 2t + 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t4;
      if (col >= N) continue;  // N is even, so col + 1 < N too
      const float bh0 = __bfloat162float(bias[col]), bh1 = __bfloat162float(bias[col + 1]);
      float bg0 = 0.0f, bg1 = 0.0f;
      if constexpr (GEGLU) {
        bg0 = __bfloat162float(bias[N + col]);
        bg1 = __bfloat162float(bias[N + col + 1]);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm * 32 + i * 16 + g + 8 * hf;
        if (row >= M) continue;
        float y0 = acc[0][i][j][2 * hf] + bh0, y1 = acc[0][i][j][2 * hf + 1] + bh1;
        if constexpr (GEGLU) {
          y0 = gelu_gate(y0, acc[NG - 1][i][j][2 * hf] + bg0);
          y1 = gelu_gate(y1, acc[NG - 1][i][j][2 * hf + 1] + bg1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + size_t(row) * N + col) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

template <bool GEGLU>
cudaError_t gemm(cudaStream_t st, const bf16* A, const bf16* W, const bf16* bias, bf16* out,
                 int M, int N, int K) {
  constexpr size_t bytes = smem_bytes<GEGLU>();
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16<GEGLU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16<GEGLU><<<grid, THREADS, bytes, st>>>(A, W, bias, out, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 v1: 64x64 tiles, plain FMAs, each thread an 8x4 patch
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
cudaError_t gemm_v1(cudaStream_t st, const float* A, const float* W, const float* bias,
                    float* out, int M, int N, int K) {
  const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
  gemm_f32<GEGLU><<<grid, F_THREADS, 0, st>>>(A, W, bias, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, c), w1 (8c, c), b1 (8c), w2 (c, 4c), b2 (c), y (n, 4c) scratch, out (n, c); all
// contiguous bf16. Requires c % 32 == 0 and 0 < ceil(n / 128) <= 65535.
int geglu_ff_v2_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                    void* y, void* out, int n, int c, void* stream) {
  if (n <= 0 || (n + BM - 1) / BM > 65535 || c <= 0 || c % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hidden = 4 * c;
  cudaError_t err = gemm<true>(st, static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                               static_cast<const bf16*>(b1), static_cast<bf16*>(y), n, hidden, c);
  if (err == cudaSuccess)
    err = gemm<false>(st, static_cast<const bf16*>(y), static_cast<const bf16*>(w2),
                      static_cast<const bf16*>(b2), static_cast<bf16*>(out), n, c, hidden);
  return static_cast<int>(err);
}

// The same on contiguous float32 tensors, through the float32 v1 design. Requires c % 32 == 0
// and 0 < ceil(n / 64) <= 65535.
int geglu_ff_f32_v1_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* y, void* out, int n, int c, void* stream) {
  if (n <= 0 || (n + F_BM - 1) / F_BM > 65535 || c <= 0 || c % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hidden = 4 * c;
  cudaError_t err = gemm_v1<true>(st, static_cast<const float*>(x), static_cast<const float*>(w1),
                                  static_cast<const float*>(b1), static_cast<float*>(y), n,
                                  hidden, c);
  if (err == cudaSuccess)
    err = gemm_v1<false>(st, static_cast<const float*>(y), static_cast<const float*>(w2),
                         static_cast<const float*>(b2), static_cast<float*>(out), n, c, hidden);
  return static_cast<int>(err);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
