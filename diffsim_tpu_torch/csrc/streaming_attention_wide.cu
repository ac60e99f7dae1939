// K4 at the widths past streaming_attention.cu's: softmax(Q K^T / sqrt(D)) V over (B*H, S, D)
// with 512 < D <= 1024 in both dtypes, and float32 at every D % 8 == 0 up to 1024 (the D % 64
// != 0 widths that streaming_attention.cu's float32 path refuses). A VAE whose last block is
// wider than 512 channels sends its mid attention here at 1024 px, (B, 1, 16384, D).
//
// Replaces the same TPU kernel as streaming_attention.cu (`streaming_self_attention`,
// diffsim_tpu/ops/pallas/attention_stream.py, pallas_call in `_pallas_forward`), whose blocks
// are (1, bq, d) at any d, and keeps its contract: f32 logits, the row max over the UNSCALED
// logits with the scale folded into exp's operand, the probabilities cast to V's dtype for P V
// with f32 accumulation, acc / l after the last key tile. Its bf16_probs mode is a second
// instantiation of both paths (BF16P), rounding as streaming_attention.cu does: each probability
// by attention_common.cuh's prob_bf16x2, and the row sum of each float32 64-key tile, or of each
// bf16 consumer's 32 keys of a 64-key tile, to bf16 before it enters the f32 l (the same tiles
// as streaming_attention.cu, so chip_smoke.py's K4_SUM_TILE holds for both files).
//
// A pair of blocks, one thread-block cluster of 2, owns a 64-row block of queries. At D = 1024 a
// 64-row f32 output accumulator is 256 KB, all of an SM's registers, so one block cannot hold
// it; the pair splits D instead. Block r owns a share of D's columns (Share below: block 0 the
// first 64 floor(np / 2) of D's np 64-column panels, block 1 the rest; 512 + 512 at D = 1024,
// 384 + 384 at D = 768, never more than 64 apart, each a multiple of 8 on a panel boundary) and
// does ALL of its work on that share: it holds Q's columns of the share, multiplies them with
// K's same columns into a partial 64 x 64 score tile S_r, reads V's columns of the share and
// writes those output columns. No block computes any of its partner's products: 4 S^2 D
// products a head in all, the bound's count (the previous design, streaming_attention_wide_v1.cu,
// ran Q K^T over all of D in each 512-column half: 1.5x that). Each block reads only its share
// of Q, K and V.
//   The exchange. After each key tile's partial, block r stores S_r into its partner's shared
//   memory through distributed shared memory (mapa + st.shared::cluster) and arrives on the
//   partner's "xfull" mbarrier (release at cluster scope); it waits on its own xfull (acquire at
//   cluster scope) for the partner's partial and forms S = S_own + S_partner with one rounded f32
//   add. IEEE addition is commutative, so both blocks hold the same S bit for bit, and from it
//   the same row maxima, probabilities, row sums and rescaling factors: the online softmax is
//   run twice on identical data, and each block applies it to its own output columns. Having
//   read the partner's partial, a block arrives on the partner's "xempty" mbarrier; a block
//   stores tile j + 1's partial only after its xempty says the partner is done with tile j's.
//   One exchange tile a block, not two: shared memory has no room for a second beside Q's share
//   and a ring deep enough to hold a stage (below), and a second would not be used: the
//   partner's next store comes at least a full key tile's products after the read it waits for.
//   A cluster barrier after the mbarriers' initialisation comes before any remote access, and
//   another ends the kernel, so neither block exits while its partner may still address it.
//   The grid is one axis, 2 x (S / 64) x B*H blocks (cluster dims (2, 1, 1)), so B*H has no
//   65535 limit; cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension, and
//   streaming_attention_wide_clusters reports cudaOccupancyMaxActiveClusters (at one block an
//   SM, at most 66 pairs run at once on an H100's 132 SMs).
//
// float32 (stream_f32_pair): 3xTF32 on mma.sync.m16n8k8, stream_f32_q64's arithmetic (operands
//   split into hi and lo TF32 parts at fragment load, a_lo b_hi + a_hi b_lo + a_hi b_hi, the
//   tensor cores' truncating f32 sums kept short: a fresh sum for each 64-column chunk of Q K^T
//   and for each 8-key chunk of P V, added into the running sums by rounded f32 adds). A block
//   sums its own share's chunks in order (8 of D = 1024's 16, the last cut at the share's end),
//   and the exchange adds the two partials. Q's share stays in shared memory (133 KB at a
//   512-column share, leading dim = 8 mod 32), so only K and V stream: per 64-key tile, K's
//   columns of the share in 64 x 64 chunks, then 8 V chunks of 8 keys x the share's columns,
//   through a ring of 4 slots filled by cp.async three stages ahead, one barrier a stage. Q K^T:
//   warp w owns a 16 x 32 score tile; the partner's partial lands in the block's score tile
//   itself (the exchange tile is the score tile, which the softmax and P V reuse, so a block
//   arrives on xempty after its last P V chunk of the tile); softmax in shared memory, 4 threads
//   a row; P V: warp w owns all 64 rows x the share's columns [64 w, 64 w + 64) (128 accumulator
//   registers a thread). Shared memory 226 KB at D = 1024. float32 at D <= 512 with D % 64 != 0
//   runs the same pair (at D = 200, 128 + 72 columns).
// bf16 (stream_wgmma_pair), 512 < D <= 1024: stream_wgmma's warp roles, a TMA producer
//   warpgroup and two consumer warpgroups that split the keys of Q K^T (32 each, over the block's
//   share) and the share's output columns (NPC 64-column panels each: one m64n256 accumulator at
//   D > 768, m64n192 at D <= 768). Q's share (2 NPC panels, 64 KB at D = 1024; panels past the
//   share are zeroed in shared memory, so the products with the K columns loaded beside them add
//   nothing) loads once. The freed shared memory holds a ring of 16 KB slots, 8 at D = 1024 and
//   9 at D <= 768, enough for a stage: tile j's NPC K chunks (64 keys x 128 columns) and tile j -
//   1's 4 V chunks (16 keys x the share's columns). The order is stream_wgmma's, one group
//   behind: S_j = Q K_j^T is issued once tile j's K chunks have landed and P_{j-1} V_{j-1} once
//   tile j - 1's V chunks have (so S_j runs under the last V copies), the K slots go back as soon
//   as S_j has landed, the exchange runs while that P V is in flight, and the V slots go back
//   before the softmax of S_j, which then overlaps the producer's next copies (the fastest of
//   the orders tried on the H100, PERF.md §6). Columns past D are TMA's zero fill: their
//   products add zeros and their outputs are not stored. At NPC = 4 the consumers' 128
//   accumulator registers a thread leave ptxas short of registers: it spills some and
//   serialises some products (its C7512 report, which chip_smoke.py's build phase prints); at
//   NPC = 3 it does neither.
// Other shapes are refused (cudaErrorInvalidValue), and every failure, a refused cluster launch
// included, is returned as its cudaError_t.
//
// Bound on the H100: 4 S^2 D FLOP a head, now also the work done, against 4 S D itemsize bytes:
// bound by operations, bf16 at the 989 TFLOP/s tensor-core peak (2.224 ms at (2, 1, 16384,
// 1024)), float32 three TF32 passes at 495 TFLOP/s (13.33 ms there). What the design does about
// it: no product is done twice, and in bf16 the tensor cores run one group behind the waits.
// What it leaves: every pair streams its head's K and V shares (from L2), and the products of
// mma.sync (float32) run at a fraction of the tensor cores' rate. See PERF.md for the measured
// share.
//
// C interface (loaded with ctypes): every entry point returns a cudaError_t.

#include <climits>

#include "attention_wgmma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_D = 1024;
constexpr int PAIR = 2;  // blocks of a cluster

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// The columns [c0, c0 + w) of D that block r of a pair owns, for Q K^T and for P V.
struct Share {
  int c0, w;
  __host__ __device__ Share(int d, int r) {
    const int d0 = 64 * (((d + 63) / 64) / 2);
    c0 = r ? d0 : 0;
    w = r ? d - d0 : d0;
  }
};

__host__ __device__ inline int widest_share(int d) {
  const int w0 = Share(d, 0).w, w1 = Share(d, 1).w;
  return w0 > w1 ? w0 : w1;
}

// ---------------------------------------------------------------------------
// the cluster: rank, barrier, distributed shared memory and cluster-scope mbarriers
// ---------------------------------------------------------------------------

namespace cluster {

__device__ __forceinline__ uint32_t rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of both blocks: release what it wrote, then acquire what the others wrote.
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in block `peer`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t peer) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(hopper::smem_u32(p)),
               "r"(peer));
  return a;
}

__device__ __forceinline__ void store(uint32_t a, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y)
               : "memory");
}

__device__ __forceinline__ void store(uint32_t a, float x, float y, float z, float w) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(x), "f"(y),
               "f"(z), "f"(w)
               : "memory");
}

// One arrival on the mbarrier at shared::cluster address `bar`, releasing this thread's earlier
// writes (its remote stores included) at cluster scope.
__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(hopper::smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` of this block's mbarrier, acquiring at cluster scope
// what the arrivals released; traps as hopper::mbar_wait does if it never completes.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0; !try_wait(bar, parity); ++polls)
    if (polls > (1u << 26)) __trap();
}

}  // namespace cluster

// The launch of `grid` blocks of `kernel` as 2-block clusters along x, at `smem` bytes of
// dynamic shared memory a block (which the kernel is allowed first).
struct PairLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  cudaError_t err;
  template <class... Params>
  PairLaunch(void (*kernel)(Params...), unsigned grid, int threads, size_t smem,
             cudaStream_t stream) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = PAIR;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// `kernel` over the pairs of (S / 64) row blocks x bh heads.
template <class... Params, class... Args>
cudaError_t launch_pairs(void (*kernel)(Params...), int bh, int s, size_t smem, int threads,
                         cudaStream_t stream, Args... args) {
  if (2LL * (s / 64) * bh > INT_MAX) return cudaErrorInvalidValue;
  PairLaunch launch(kernel, PAIR * (s / 64) * bh, threads, smem, stream);
  if (launch.err != cudaSuccess) return launch.err;
  const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many pairs of `kernel` the card runs at once (cudaOccupancyMaxActiveClusters).
template <class... Params>
cudaError_t pairs_at_once(void (*kernel)(Params...), size_t smem, int threads, int* clusters) {
  PairLaunch launch(kernel, PAIR, threads, smem, nullptr);
  if (launch.err != cudaSuccess) return launch.err;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &launch.cfg);
}

// the 3xTF32 fragments and products of attention_common.cuh
using attn::load_a_3xtf32;
using attn::mma_tf32;
using attn::mma_tf32_first;
using attn::split_tf32;

// ---------------------------------------------------------------------------
// float32: Q's share resident, K's and V's shares streamed, the partials exchanged
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;  // 8 warps
constexpr int Q64 = 64;       // q rows per block
constexpr int K64 = 64;       // keys per tile
constexpr int DC = 64;        // columns of a K chunk
constexpr int VC = 8;         // keys of a V chunk
constexpr int LDC = DC + 8;   // leading dim of a K chunk and of the score tile (8 mod 32)
constexpr int MAX_SHARE = 512;
constexpr int SLOTS = 4;      // ring of stage buffers: 3 copies in flight behind the one in use
constexpr int SLOT_FLOATS = K64 * LDC;  // a K chunk, or a V chunk of 8 x (share + 4)
static_assert(VC * (MAX_SHARE + 4) <= SLOT_FLOATS, "a V chunk must fit a ring slot");

__device__ inline void cp_async_wait_slots() {  // all but the SLOTS - 2 newest groups landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(SLOTS - 2));
}

// Shared memory (bytes): Q's share (leading dim = 8 mod 32), the stage ring, the score tile
// (row-major: the partner's partial lands there, then the scores, then the probabilities), the
// row statistics and the two mbarriers of the exchange. Both blocks of a pair take the layout
// of the wider share.
struct LayoutPair {
  size_t q, ring, s, m, l, c, bar, total;
  int ldq, ldv;
  __host__ __device__ explicit LayoutPair(int d) {
    const int wp = 64 * ((widest_share(d) + 63) / 64);
    ldq = wp + 8;  // float2 A loads conflict-free
    ldv = wp + 4;  // the B loads of rows 2t and 2t + 1 conflict-free
    size_t off = 0;
    q = off; off = align128(off + size_t(Q64) * ldq * 4);
    ring = off; off = align128(off + size_t(SLOTS) * SLOT_FLOATS * 4);
    s = off; off = align128(off + size_t(Q64) * LDC * 4);
    m = off; off = align128(off + Q64 * 4);
    l = off; off = align128(off + Q64 * 4);
    c = off; off = align128(off + Q64 * 4);
    bar = off; off = align128(off + 2 * sizeof(uint64_t));
    total = off;
  }
};

// Stage g of the block's sequence: each 64-key tile is nkc K chunks (K's columns [c0 + 64 st,
// + 64) of the tile's keys, cut at the share's end) then 8 V chunks (8 keys x the share's
// columns), each copied with cp.async into ring slot g % SLOTS. One cp.async group per stage,
// empty past the end.
__device__ inline void issue_stage_pair(int g, int total, int n_stages, int nkc, const float* kh,
                                        const float* vh, int d, int c0, int w, int ldv,
                                        float* ring) {
  if (g < total) {
    const int tile = g / n_stages, st = g % n_stages;
    const int key0 = tile * K64;
    float* dst = ring + (g % SLOTS) * SLOT_FLOATS;
    if (st < nkc) {
      const int vpr = min(DC, w - st * DC) / 4;  // float4 of a row up to the share's end
      const float* src = kh + size_t(key0) * d + c0 + st * DC;
      for (int i = threadIdx.x; i < K64 * (DC / 4); i += THREADS) {
        const int r = i / (DC / 4), c4 = i % (DC / 4);
        if (c4 < vpr) attn::cp_async16(dst + r * LDC + 4 * c4, src + size_t(r) * d + 4 * c4);
      }
    } else {  // rows of at most 128 float4 (w <= 512)
      const float* src = vh + size_t(key0 + (st - nkc) * VC) * d + c0;
      for (int i = threadIdx.x; i < VC * (MAX_SHARE / 4); i += THREADS) {
        const int r = i >> 7, c4 = i & 127;
        if (4 * c4 < w) attn::cp_async16(dst + r * ldv + 4 * c4, src + size_t(r) * d + 4 * c4);
      }
    }
  }
  attn::cp_async_commit();
}

template <bool BF16P>
__global__ void __launch_bounds__(THREADS, 1)
stream_f32_pair(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int s_len, int d,
                float scale, float scale_bf16) {
  constexpr int MT = Q64 / 16;  // m16 tiles of P V a warp: all 64 rows
  constexpr int NT = 8;         // n8 tiles of P V a warp: 64 output columns
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutPair L(d);
  const int ldq = L.ldq, ldv = L.ldv;
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* Ss = reinterpret_cast<float*>(smem + L.s);  // [row][key]
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* Ls = reinterpret_cast<float*>(smem + L.l);
  float* Cs = reinterpret_cast<float*>(smem + L.c);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + L.bar);  // the partner's partial landed
  uint64_t* xempty = xfull + 1;  // the partner is done with the partial this block sent it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t rank = cluster::rank(), peer = rank ^ 1u;
  const int n_rb = s_len / Q64, pair = blockIdx.x / PAIR;
  const size_t head = size_t(pair / n_rb) * s_len * d;
  const int q0 = (pair % n_rb) * Q64;
  const Share sh(d, static_cast<int>(rank));
  const int nkc = (sh.w + DC - 1) / DC;  // 0 for block 0 at d <= 64
  const int n_stages = nkc + K64 / VC;
  const int n_tiles = s_len / K64;
  const int total = n_tiles * n_stages;
  const float* kh = k + head;
  const float* vh = v + head;

  if (tid == 0) {
    hopper::mbar_init(xfull, THREADS);   // every thread of the partner
    hopper::mbar_init(xempty, THREADS);
    hopper::mbar_fence_init();
  }
  for (int i = tid; i < Q64; i += THREADS) {
    Ms[i] = -INFINITY;
    Ls[i] = 0.0f;
  }
  cluster::sync();  // both blocks' mbarriers are initialised before either addresses them
  const uint32_t ss_peer = cluster::peer_addr(Ss, peer);
  const uint32_t xfull_peer = cluster::peer_addr(xfull, peer);
  const uint32_t xempty_peer = cluster::peer_addr(xempty, peer);

  {  // Q's share, in stage 0's cp.async group
    const int vpr = sh.w / 4;
    const float* src = q + head + size_t(q0) * d + sh.c0;
    for (int i = tid; i < Q64 * vpr; i += THREADS) {
      const int r = i / vpr, c = (i % vpr) * 4;
      attn::cp_async16(Qs + r * ldq + c, src + size_t(r) * d + c);
    }
  }
  for (int gs = 0; gs < SLOTS - 1; ++gs)
    issue_stage_pair(gs, total, n_stages, nkc, kh, vh, d, sh.c0, sh.w, ldv, ring);

  const int mw = 16 * (warp % 4);  // Q K^T: this warp's 16 rows
  const int nw = 32 * (warp / 4);  // and its 32 keys of the score tile
  const int cb = 64 * warp;        // P V: this warp's 64 columns of the share, all 64 rows
  const bool pv_warp = cb < sh.w;  // warp-uniform: a share under 512 columns idles the last warps
  const int rs = tid / 4, qk = tid % 4;  // softmax: row rs, keys [16 qk, + 16)
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;
  float sacc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.0f;

  for (int gs = 0; gs < total; ++gs) {
    const int st = gs % n_stages, j = gs / n_stages;
    const float* chunk = ring + (gs % SLOTS) * SLOT_FLOATS;
    // stage gs has landed, and every thread is done with stage gs - 1, whose slot the copy of
    // stage gs + SLOTS - 1 reuses
    cp_async_wait_slots();
    __syncthreads();
    issue_stage_pair(gs + SLOTS - 1, total, n_stages, nkc, kh, vh, d, sh.c0, sh.w, ldv, ring);

    if (st < nkc) {
      // this chunk's columns of Q K^T, summed apart and then added to the partial scores: the
      // tensor cores' f32 sums truncate, so each running sum takes few of their additions
      const float* kc = chunk;
      const int nks = min(DC, sh.w - st * DC) / 8;  // k8 steps up to the share's end
      float part[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll 2
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t ah[4], al[4];
        load_a_3xtf32(ah, al, Qs, ldq, mw, st * DC + 8 * ks, g, t);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float2 kp =
              *reinterpret_cast<const float2*>(kc + (nw + 8 * n + g) * LDC + 8 * ks + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kp.x, bh0, bl0);
          split_tf32(kp.y, bh1, bl1);
          mma_tf32(part[n], al, bh0, bh1);
          mma_tf32(part[n], ah, bl0, bl1);
          mma_tf32(part[n], ah, bh0, bh1);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = st == 0 ? part[n][e] : sacc[n][e] + part[n][e];
      continue;
    }
    const int vc = st - nkc;
    if (vc == 0) {
      // The exchange: this block's partial into the partner's score tile, once the partner is
      // done with the tile j - 1 it held there; then the partner's partial from this block's
      // own, and S = own + partner's (the same in both blocks: addition commutes).
      if (j > 0) cluster::wait(xempty, (j - 1) & 1);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t at = ss_peer + 4u * ((mw + g) * LDC + nw + 8 * n + 2 * t);
        cluster::store(at, sacc[n][0], sacc[n][1]);
        cluster::store(at + 4u * 8 * LDC, sacc[n][2], sacc[n][3]);
      }
      cluster::arrive(xfull_peer);
      cluster::wait(xfull, j & 1);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float* srow = Ss + (mw + g) * LDC + nw + 8 * n + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(srow);
        const float2 hi = *reinterpret_cast<const float2*>(srow + 8 * LDC);
        *reinterpret_cast<float2*>(srow) = make_float2(sacc[n][0] + lo.x, sacc[n][1] + lo.y);
        *reinterpret_cast<float2*>(srow + 8 * LDC) =
            make_float2(sacc[n][2] + hi.x, sacc[n][3] + hi.y);
      }
      __syncthreads();
      // the tile's scores are complete: online softmax of row rs over keys [16 qk, +16)
      float* srow = Ss + rs * LDC + 16 * qk;
      float x[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v4 = *reinterpret_cast<const float4*>(srow + 4 * i);
        x[4 * i] = v4.x;
        x[4 * i + 1] = v4.y;
        x[4 * i + 2] = v4.z;
        x[4 * i + 3] = v4.w;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 16; ++i) mx = fmaxf(mx, x[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = Ms[rs];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf((m_old - m_new) * scale);  // 0 on the first tile
      float sum = 0.0f;
      const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale_bf16);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        if (BF16P) {
          const uint32_t pp = attn::prob_bf16x2(x[i], x[i + 1], m_new, scale2);
          x[i] = attn::bf16_lo(pp);
          x[i + 1] = attn::bf16_hi(pp);
        } else {
          x[i] = expf((x[i] - m_new) * scale);
          x[i + 1] = expf((x[i + 1] - m_new) * scale);
        }
        sum += x[i];
        sum += x[i + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (BF16P) sum = attn::round_bf16(sum);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(srow + 4 * i) =
            make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
      if (qk == 0) {
        Ms[rs] = m_new;
        Ls[rs] = Ls[rs] * corr + sum;
        Cs[rs] = corr;
      }
      __syncthreads();
    }
    if (pv_warp) {
      // O[all rows, warp columns] += P V over this chunk's 8 keys (rescaled once per tile). Each
      // (m, n) tile's products go to a fresh sum that is then added in f32.
      if (vc == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float c_lo = Cs[16 * m + g], c_hi = Cs[16 * m + g + 8];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            acc[m][n][0] *= c_lo;
            acc[m][n][1] *= c_lo;
            acc[m][n][2] *= c_hi;
            acc[m][n][3] *= c_hi;
          }
        }
      }
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) load_a_3xtf32(ah[m], al[m], Ss, LDC, 16 * m, vc * VC, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (cb + 8 * n >= sh.w) continue;  // columns past the share (w % 8 == 0: whole tiles)
        const int col = cb + 8 * n + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(chunk[2 * t * ldv + col], bh0, bl0);  // keys 2t and 2t + 1: the permuted k
        split_tf32(chunk[(2 * t + 1) * ldv + col], bh1, bl1);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float part[4];
          if (BF16P) {  // bf16 probabilities are exact in tf32: their low part is zero
            mma_tf32_first(part, ah[m], bl0, bl1);
          } else {
            mma_tf32_first(part, al[m], bh0, bh1);
            mma_tf32(part, ah[m], bl0, bl1);
          }
          mma_tf32(part, ah[m], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += part[e];
        }
      }
    }
    // this thread is done with the tile's probabilities: the partner may send its next partial
    if (vc == K64 / VC - 1 && j + 1 < n_tiles) cluster::arrive(xempty_peer);
  }
  __syncthreads();

  if (pv_warp) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float inv_lo = 1.0f / Ls[16 * m + g], inv_hi = 1.0f / Ls[16 * m + g + 8];
      float* o_lo = o + head + size_t(q0 + 16 * m + g) * d + sh.c0;
      float* o_hi = o_lo + size_t(8) * d;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = cb + 8 * n + 2 * t;
        if (cb + 8 * n >= sh.w) continue;
        *reinterpret_cast<float2*>(o_lo + col) =
            make_float2(acc[m][n][0] * inv_lo, acc[m][n][1] * inv_lo);
        *reinterpret_cast<float2*>(o_hi + col) =
            make_float2(acc[m][n][2] * inv_hi, acc[m][n][3] * inv_hi);
      }
    }
  }
  cluster::sync();  // no block exits while its partner may still address it
}

template <bool BF16P>
cudaError_t launch_f32_pair(const void* q, const void* k, const void* v, void* o, int bh, int s,
                            int d, float scale, cudaStream_t stream) {
  return launch_pairs(stream_f32_pair<BF16P>, bh, s, LayoutPair(d).total, THREADS, stream,
                      static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o), s, d, scale,
                      attn::round_bf16(scale));
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, a producer warpgroup and two consumer warpgroups that split the keys of
// Q K^T over the block's share and the share's output columns; the partials exchanged
// ---------------------------------------------------------------------------

constexpr int BM = 64;                  // q rows per block
constexpr int BN = 64;                  // keys per tile
constexpr int NCW = 2;                  // consumer warpgroups
constexpr int SLICE = BN / NCW;         // keys of a tile whose scores one consumer computes
constexpr int PANEL_COLS = 64;          // columns of a 128-byte swizzled panel
constexpr int KEY_PANEL = BN * 128;     // a panel of 64 rows: of Q, or of a K chunk
constexpr int V_KEYS = 16;              // keys of a V chunk: one k16 step of P V
constexpr int V_PANEL = V_KEYS * 128;   // a panel of a V chunk
constexpr int V_CHUNKS = BN / V_KEYS;   // V chunks a tile
constexpr int CHUNK = 2 * KEY_PANEL;    // a ring slot: a K chunk (64 keys x 128 columns) or a
                                        // V chunk (16 keys x the share's 2 NPC panels)
constexpr int P_TILE = BM * BN * 2;     // a P tile: 64 rows x 64 keys, one swizzled panel
constexpr int X_TILE = BM * BN * 4;     // the exchange tile: a partner's 64 x 64 f32 partial
constexpr int CONSUMER_THREADS = NCW * 128;
constexpr int THREADS_WG = CONSUMER_THREADS + 128;  // + the producer warpgroup
// the producer gives its registers to the consumers: 128 x 24 + 256 x 240 <= 65536
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr uint32_t BAR_MAX = 1, BAR_P = 2;  // named barriers of the two consumers

// The tiling for NPC output panels a consumer (3 up to D = 768, 4 past it), and the shared
// memory: 1024 bytes of alignment slack, Q's share (2 NPC panels: NPC K chunks' columns), the
// chunk ring, two P tiles, the exchange tile, the row maxima and sums of both consumers, then
// the mbarriers.
template <int NPC>
struct Tiling {
  static constexpr int OUT_COLS = NPC * PANEL_COLS;  // a consumer's m64nOUT_COLS accumulator
  static constexpr int NKC = NPC;                    // K chunks a tile
  static constexpr int Q_PANELS = 2 * NKC;
  static constexpr int CHUNKS = NKC + V_CHUNKS;      // ring slots a stage takes
  static constexpr int Q_BYTES = Q_PANELS * KEY_PANEL;
  static constexpr int FIXED = 1024 + Q_BYTES + 2 * P_TILE + X_TILE + 2 * NCW * BM * 4 + 256;
  static constexpr int STAGES = (232448 - FIXED) / CHUNK;  // of 227 KB: 9 (NPC 3), 8 (NPC 4)
  static constexpr size_t SMEM = FIXED + size_t(STAGES) * CHUNK;
  // a consumer holds tile j - 1's V chunks while it waits for tile j's K chunks
  static_assert(STAGES >= CHUNKS, "the ring must hold a stage's chunks");
  static_assert(2 * NPC * V_PANEL <= CHUNK, "a V chunk must fit a ring slot");
};

// The k16 steps [KK, STEPS) of a consumer's Q K^T over one K chunk: step kk reads columns
// 16 kk.. of the chunk (panel kk / 4, 32 (kk % 4) bytes into its rows), at the same offset in
// Q's panels and in the chunk's. The offsets are immediates of the wgmma asm (mma_at).
template <int KK, int STEPS>
__device__ __forceinline__ void qk_steps(float (&s)[SLICE / 2], uint64_t qd, uint64_t kd,
                                         bool first) {
  if constexpr (KK < STEPS) {
    hopper::WgmmaSS<SLICE>::mma_at<((KK / 4) * KEY_PANEL + (KK % 4) * 32) / 16>(
        s, qd, kd, first && KK == 0 ? 0 : 1);
    qk_steps<KK + 1, STEPS>(s, qd, kd, first);
  }
}

template <bool BF16P, int NPC>
__global__ void __launch_bounds__(THREADS_WG, 1)
stream_wgmma_pair(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int s_len,
                  int d, float scale_log2, float scale_bf16) {
  using namespace hopper;
  using T = Tiling<NPC>;
  constexpr int STAGES = T::STAGES, NKC = T::NKC, OUT_COLS = T::OUT_COLS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + T::Q_BYTES;                     // 1024-aligned slots
  unsigned char* ps = ring + STAGES * CHUNK;                 // [2][P_TILE]
  float* xs = reinterpret_cast<float*>(ps + 2 * P_TILE);     // the partner's partial
  float* Mx = xs + BM * BN;                                  // [NCW][BM] row maxima
  float* Lx = Mx + NCW * BM;                                 // [NCW][BM] row sums
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Lx + NCW * BM);
  uint64_t* full = q_full + 1;      // [STAGES]
  uint64_t* empty = full + STAGES;  // [STAGES]
  uint64_t* xfull = empty + STAGES;  // the partner's partial landed
  uint64_t* xempty = xfull + 1;      // the partner is done with the partial this block sent it

  // warp-uniform by construction, so the compiler sees the role branches as non-divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const uint32_t rank = cluster::rank(), peer = rank ^ 1u;
  const int n_rb = s_len / BM, pair = blockIdx.x / PAIR;
  const int bh = pair / n_rb, q0 = (pair % n_rb) * BM;
  const Share sh(d, static_cast<int>(rank));
  const int q_panels = (sh.w + PANEL_COLS - 1) / PANEL_COLS;  // Q's panels of the share
  const int n_tiles = s_len / BN;
  // Chunks come in the order the consumers take them: stage t is tile t's K chunks (t < n_tiles)
  // and then tile t - 1's V chunks (t > 0). The ring position of chunk g of that sequence, and
  // the parity of its slot's use:
  auto slot = [&](int g) { return ring + (g % STAGES) * CHUNK; };
  auto phase = [&](int g) { return uint32_t(g / STAGES) & 1u; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * NCW);  // every consumer warp
    }
    mbar_init(xfull, CONSUMER_THREADS);  // every consumer thread of the partner
    mbar_init(xempty, CONSUMER_THREADS);
    mbar_fence_init();
  }
  cluster::sync();  // both blocks' mbarriers are initialised before either addresses them

  if (warp >= 4 * NCW) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 4 * NCW && lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(q_full, q_panels * KEY_PANEL);
      for (int p = 0; p < q_panels; ++p)
        tma_load_3d(qs + p * KEY_PANEL, &tm_q, sh.c0 + p * PANEL_COLS, q0, bh, q_full);
      for (int t = 0, g = 0; t <= n_tiles; ++t) {
        for (int i = 0; t < n_tiles && i < NKC; ++i, ++g) {  // K: 64 keys x 128 columns
          uint64_t* bar = full + g % STAGES;
          mbar_wait(empty + g % STAGES, phase(g) ^ 1);  // passes at once on round 0
          mbar_arrive_expect_tx(bar, CHUNK);
          for (int p = 0; p < 2; ++p)
            tma_load_3d(slot(g) + p * KEY_PANEL, &tm_k, sh.c0 + (2 * i + p) * PANEL_COLS, t * BN,
                        bh, bar);
        }
        for (int kk = 0; t > 0 && kk < V_CHUNKS; ++kk, ++g) {  // V: 16 keys x the share
          uint64_t* bar = full + g % STAGES;
          mbar_wait(empty + g % STAGES, phase(g) ^ 1);
          mbar_arrive_expect_tx(bar, 2 * NPC * V_PANEL);
          for (int p = 0; p < 2 * NPC; ++p)
            tma_load_3d(slot(g) + p * V_PANEL, &tm_v, sh.c0 + p * PANEL_COLS,
                        (t - 1) * BN + kk * V_KEYS, bh, bar);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    // consumer c: the scores of keys [32 c, 32 c + 32) of every tile over the share, and the
    // share's output columns [OUT_COLS c, + OUT_COLS) of all 64 rows. This thread holds rows r0
    // and r0 + 8.
    const int c = warp / 4, ct = threadIdx.x;  // ct: this thread among the consumers
    const int r0 = 16 * (warp % 4) + lane / 4, t = lane % 4;
    auto release = [&](int g) {  // this warp is done with chunk g's slot
      if (lane == 0) mbar_arrive(empty + g % STAGES);
    };
    const uint64_t q_desc = make_desc(qs, 16, 8 * 128, 128);  // Q's first panel
    const uint32_t xs_peer = cluster::peer_addr(xs, peer);
    const uint32_t xfull_peer = cluster::peer_addr(xfull, peer);
    const uint32_t xempty_peer = cluster::peer_addr(xempty, peer);

    // Q's panels past the share hold zeros: the last K chunk's products over them add nothing
    for (int i = ct; i < (T::Q_PANELS - q_panels) * KEY_PANEL / 16; i += CONSUMER_THREADS)
      reinterpret_cast<uint4*>(qs + q_panels * KEY_PANEL)[i] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
    named_sync(BAR_P, CONSUMER_THREADS);

    float acc[OUT_COLS / 2];
#pragma unroll
    for (int i = 0; i < OUT_COLS / 2; ++i) acc[i] = 0.0f;
    float s[SLICE / 2], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f}, corr[2];

    // the chunks at ring positions g.. g + n - 1 have landed
    auto wait_chunks = [&](int g, int n) {
      for (int i = 0; i < n; ++i) mbar_wait(full + (g + i) % STAGES, phase(g + i));
    };
    // S_j's partial = Q K_j^T over the share (A = Q, B = this consumer's 32 keys of K), from
    // tile j's K chunks at ring positions k0..
    auto issue_s = [&](int k0) {
#pragma unroll
      for (int i = 0; i < NKC; ++i) {
        const uint64_t kd = make_desc(slot(k0 + i) + c * SLICE * 128, 16, 8 * 128, 128);
        qk_steps<0, 8>(s, q_desc + 2 * i * KEY_PANEL / 16, kd, i == 0);
      }
      wgmma_commit();
    };
    // O += P V from P tile `buf` and a tile's V chunks at ring positions v0.. (O already
    // rescaled): A = P, K-major, B = this consumer's V columns, N-major. Columns past the share
    // (the partner's, or TMA's zeros past D) are never stored.
    auto issue_pv = [&](int v0, int buf) {
#pragma unroll
      for (int kk = 0; kk < V_CHUNKS; ++kk)
        WgmmaSST<OUT_COLS>::mma(
            acc, make_desc(ps + buf * P_TILE + kk * 32, 16, 8 * 128, 128),
            make_desc(slot(v0 + kk) + NPC * c * V_PANEL, V_PANEL, 8 * 128, 128), 1);
      wgmma_commit();
    };
    // After S_j's partial has landed: send it to the partner (once the partner is done with
    // tile j - 1's), take the partner's and add them, own + partner's (the same sum in both
    // blocks: addition commutes). The exchange tile holds each consumer thread's 16 scores as 4
    // float4, float4 i of thread ct at 16 (256 i + ct) bytes: conflict-free on both sides.
    auto exchange = [&](int j) {
      fence_regs(s);
      if (j > 0) cluster::wait(xempty, (j - 1) & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cluster::store(xs_peer + 16u * (CONSUMER_THREADS * i + ct), s[4 * i], s[4 * i + 1],
                       s[4 * i + 2], s[4 * i + 3]);
      cluster::arrive(xfull_peer);
      cluster::wait(xfull, j & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = reinterpret_cast<const float4*>(xs)[CONSUMER_THREADS * i + ct];
        s[4 * i] += x.x;
        s[4 * i + 1] += x.y;
        s[4 * i + 2] += x.z;
        s[4 * i + 3] += x.w;
      }
      if (j + 1 < n_tiles) cluster::arrive(xempty_peer);
    };
    // Once S_j has landed: its K chunks' slots go back to the producer, which loads tile j + 1's
    // K chunks during the exchange and the softmax.
    auto release_k = [&](int k0) {
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < NKC; ++i) release(k0 + i);
    };
    // The online softmax of tile j. The row maxima of both consumers' keys meet in shared memory;
    // each consumer then takes the probabilities of its own keys and writes them to P tile `buf`
    // in the layout TMA would give it (128-byte rows, 16-byte units swizzled by the row mod 8: the
    // pairs of a warp's store fall in 32 banks). Two P tiles: tile j's is written while P_{j-1}
    // V_{j-1} reads the other.
    auto softmax = [&](int buf) {
      fence_regs(s);
      float mx[2], mb[2], sum[2];
      attn::tile_max(s, mx);
      if (t == 0) {
        Mx[c * BM + r0] = mx[0];
        Mx[c * BM + r0 + 8] = mx[1];
      }
      named_sync(BAR_MAX, CONSUMER_THREADS);
#pragma unroll
      for (int i = 0; i < 2; ++i) mx[i] = fmaxf(Mx[r0 + 8 * i], Mx[BM + r0 + 8 * i]);
      attn::update_max<BF16P>(m_run, mx, corr, mb, scale_log2);
      attn::tile_probs<BF16P>(s, mb, scale_log2, scale_bf16, sum);
#pragma unroll
      for (int i = 0; i < 2; ++i)  // the mode rounds each 32-key slice's row sum to bf16
        l_run[i] = l_run[i] * corr[i] +
                   (BF16P ? attn::round_bf16(attn::quad_sum(sum[i])) : sum[i]);
      unsigned char* pt = ps + buf * P_TILE;
#pragma unroll
      for (int n = 0; n < SLICE / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(pt + (r0 + 8 * i) * 128 +
                                       (((SLICE / 8 * c + n) ^ (r0 % 8)) << 4) + 4 * t) =
              attn::p_pair<BF16P>(s, 4 * n + 2 * i);
      fence_proxy_async();  // P V reads the tile through the async proxy
    };
    // After P V has landed: rescale O for the next one; then P is complete.
    auto next_p = [&]() {
#pragma unroll
      for (int n = 0; n < OUT_COLS / 8; ++n) {
        acc[4 * n] *= corr[0];
        acc[4 * n + 1] *= corr[0];
        acc[4 * n + 2] *= corr[1];
        acc[4 * n + 3] *= corr[1];
      }
      named_sync(BAR_P, CONSUMER_THREADS);  // P of all 64 keys is in place
    };
    auto pv_landed = [&](int v0) {
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < V_CHUNKS; ++kk) release(v0 + kk);
    };

    mbar_wait(q_full, 0);
    // Stage 0: S_0 alone. Stage j: S_j issued once tile j's K chunks have landed, then P_{j-1}
    // V_{j-1} once tile j - 1's V chunks have; tile j's K slots go back as soon as S_j has landed,
    // the exchange runs while that P V is in flight (one group behind), and tile j - 1's V slots
    // go back before the softmax of S_j, so that the producer's next copies overlap the softmax.
    // Stage n_tiles: the last P V. Each wgmma is issued and waited for outside any branch, and no
    // mbarrier wait falls between the products of one group.
    wait_chunks(0, NKC);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    release_k(0);
    exchange(0);
    softmax(0);
    next_p();
    int g = NKC;  // stage j's first chunk: K chunks of tile j, then V chunks of tile j - 1
    for (int j = 1; j < n_tiles; ++j) {
      wait_chunks(g, NKC);
      wgmma_fence();
      issue_s(g);
      wait_chunks(g + NKC, V_CHUNKS);  // S_j runs while tile j - 1's last V chunks land
      issue_pv(g + NKC, (j - 1) & 1);
      wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
      release_k(g);
      exchange(j);
      pv_landed(g + NKC);
      softmax(j & 1);
      next_p();
      g += T::CHUNKS;
    }
    wait_chunks(g, V_CHUNKS);
    wgmma_fence();
    issue_pv(g, (n_tiles - 1) & 1);
    pv_landed(g);

    // l = the two consumers' row sums; out = acc / l in bf16, the share's columns
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = BF16P ? l_run[i] : attn::quad_sum(l_run[i]);
      if (t == 0) Lx[c * BM + r0 + 8 * i] = l;
    }
    named_sync(BAR_MAX, CONSUMER_THREADS);
#pragma unroll
    for (int i = 0; i < 2; ++i) inv[i] = 1.0f / (Lx[r0 + 8 * i] + Lx[BM + r0 + 8 * i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* orow = o + (size_t(bh) * s_len + q0 + r0 + 8 * i) * d + sh.c0;
#pragma unroll
      for (int n = 0; n < OUT_COLS / 8; ++n) {
        const int col = OUT_COLS * c + 8 * n + 2 * t;
        if (col < sh.w)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[4 * n + 2 * i] * inv[i], acc[4 * n + 2 * i + 1] * inv[i]);
      }
    }
  }
  cluster::sync();  // no block exits while its partner may still address it
}

// The output panels a consumer takes at width d (512 < d <= 1024): half of the wider share's.
inline int panels_a_consumer(int d) { return ((widest_share(d) + 63) / 64 + 1) / 2; }

// d % 8 == 0, 512 < d <= 1024
template <bool BF16P, int NPC>
cudaError_t launch_bf16_pair(const void* q, const void* k, const void* v, void* o, int bh, int s,
                             int d, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::make_map_bf16(&tq, q, bh, s, d, BM, PANEL_COLS);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tk, k, bh, s, d, BN, PANEL_COLS);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tv, v, bh, s, d, V_KEYS, PANEL_COLS);
  if (err != cudaSuccess) return err;
  return launch_pairs(stream_wgmma_pair<BF16P, NPC>, bh, s, Tiling<NPC>::SMEM, THREADS_WG,
                      stream, tq, tk, tv, static_cast<bf16*>(o), s, d, scale * LOG2E,
                      attn::round_bf16(scale));
}

template <bool BF16P>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s,
                        int d, float scale, cudaStream_t stream) {
  if (panels_a_consumer(d) == 3)
    return launch_bf16_pair<BF16P, 3>(q, k, v, o, bh, s, d, scale, stream);
  return launch_bf16_pair<BF16P, 4>(q, k, v, o, bh, s, d, scale, stream);
}

bool supported(int s, int d, int dtype) {
  return s > 0 && s % 64 == 0 && d > 0 && d % 8 == 0 && d <= MAX_D &&
         (dtype == 0 || (dtype == 1 && d > 512));
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (bh, s, d); dtype 0 = float32, 1 = bfloat16; bf16_probs 0 or 1;
// bh > 0 (no upper limit but the grid's 2^31 - 1 blocks), s % 64 == 0, d % 8 == 0, d <= 1024;
// bfloat16 requires d > 512 (narrower bf16 heads are streaming_attention.cu's).
int streaming_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh, int s,
                            int d, float scale, int dtype, int bf16_probs, void* stream) {
  if (bh <= 0 || !supported(s, d, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(bf16_probs ? launch_f32_pair<true>(q, k, v, o, bh, s, d, scale, st)
                                       : launch_f32_pair<false>(q, k, v, o, bh, s, d, scale, st));
  return static_cast<int>(bf16_probs ? launch_bf16<true>(q, k, v, o, bh, s, d, scale, st)
                                     : launch_bf16<false>(q, k, v, o, bh, s, d, scale, st));
}

// The pairs (2-block clusters) of the kernel that streaming_attention_fwd launches for (d,
// dtype, bf16_probs) that the card runs at once (cudaOccupancyMaxActiveClusters), in *clusters.
int streaming_attention_wide_clusters(int d, int dtype, int bf16_probs, int* clusters) {
  if (!supported(64, d, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = bf16_probs ? pairs_at_once(stream_f32_pair<true>, LayoutPair(d).total, THREADS, clusters)
                     : pairs_at_once(stream_f32_pair<false>, LayoutPair(d).total, THREADS,
                                     clusters);
  else if (panels_a_consumer(d) == 3)
    err = bf16_probs
              ? pairs_at_once(stream_wgmma_pair<true, 3>, Tiling<3>::SMEM, THREADS_WG, clusters)
              : pairs_at_once(stream_wgmma_pair<false, 3>, Tiling<3>::SMEM, THREADS_WG, clusters);
  else
    err = bf16_probs
              ? pairs_at_once(stream_wgmma_pair<true, 4>, Tiling<4>::SMEM, THREADS_WG, clusters)
              : pairs_at_once(stream_wgmma_pair<false, 4>, Tiling<4>::SMEM, THREADS_WG, clusters);
  return static_cast<int>(err);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
