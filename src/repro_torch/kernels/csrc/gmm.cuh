// The grouped (per-expert) GEMMs of moe_gmm.cu (the forward) and
// moe_gmm_bwd.cu (its gradients): kernel bodies for Hopper (sm_90a), one
// template a route, whose parameters say how each operand lies in memory.
// Each source wraps the bodies it needs in kernels of its own names, so a
// profiler trace tells the forward's launches from the backward's.
//
// The three products, for each expert e (x (E,C,D), w (E,D,F), dy (E,C,F)):
//   forward  y  = x  @ w     (C x F), contracting D;
//   backward dx = dy @ w^T   (C x D), contracting F;
//            dw = x^T @ dy   (D x F), contracting C, the expert's tokens.
// In the forward, x is K-major (the contracted axis contiguous) and w
// N-major; dx reads both dy and w K-major; dw reads both x and dy with the
// contracted axis outermost (M- and N-major).
//
// `simt` (gmm_simt): the CUDA cores, any strides.  out[e] (M x N) =
// A[e] (M x K) @ B[e] (K x N) with each operand given by its strides: the
// three products are three stride sets.  Each block stages a 128x8 A tile
// (transposed) and an 8x128 B tile in shared memory as fp32, and 256
// threads each keep an 8x8 block of the 128x128 output in registers: 16
// shared-memory reads feed 64 multiply-adds.  A thread's rows and columns
// are strided by 16, so the reads of a warp hit distinct banks and its
// stores are coalesced.  A tile's loads walk the operand's contiguous axis
// fastest, so a warp's global reads are coalesced for either layout.
// Ragged edges are masked in the loads and the stores.  Exact against the
// plain version at the fp32 tolerance.
//
// `wgmma` (gmm_wgmma, bf16 operands whose strides TMA can describe):
// out[e] (M x N) = A[e] (M x K) @ B[e] (K x N) on the tensor cores.
//  * one block per 128x256 tile of out.  Two consumer warpgroups own 64 rows
//    each (an m64n256k16 wgmma, 128 fp32 sums a thread); one thread of a
//    third (producer) warpgroup streams 64-deep slices of A and B with TMA
//    into a ring of 4 stages of 128-byte-swizzled shared memory (48 KB a
//    stage), and `setmaxnreg` moves registers from the producer to the
//    consumers.  Each consumer keeps one wgmma group in flight and releases
//    a stage once the group before it has finished.
//  * a K-major operand is one box of rows of 64 depths (128 bytes); an
//    MN-major one (A_MN, B_MN: the contracted axis outermost in memory) is
//    kept as 64-column chunks of BK rows and read through wgmma's
//    transpose bit, which 16-bit types have for both operands.  The
//    forward is <K-major A, MN-major B>, dx <K, K>, dw <MN, MN>.
//  * the tensor maps are 3-D, (E, rows, cols), so a tile past M, N or K is
//    clipped and zero-filled at the edge of its own expert; the epilogue
//    converts to bf16 and stores with guards (N is a multiple of 8).
//  * tile order: M tiles run fastest, so the blocks that share one B panel
//    (K x 256) run together and B is read from device memory about once.
//
// `wgmma`, persistent (gmm_wgmma_persistent, the backward's dx and dw): the
// same tiles, warpgroups, layouts and maps, for GEMMs whose blocks are
// short, many or both (arctic-480b's dw: 136,192 tiles of one slice of
// tokens each; grok-1's: 49,152 of 20).  One block a tile ran a tile's
// barrier set-up, its first load's latency, its products and its 64 KB
// store from registers one after another, one block an SM: arctic's dw
// took 10.35 ms against a 2.74 ms byte bound (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md).
//  * as many blocks as the SMs hold (one, by its shared memory) walk the
//    tiles with a static stride, in the same order: every tile is the same
//    work.  The producer's slice count, stage and barrier phases run on
//    across tiles, so the next tile's loads are in flight while this one's
//    products and epilogue run.  Consumers release a tile's last stage once
//    its products are done.
//  * the epilogue converts each warpgroup's 64 x 256 sums to bf16 into a
//    staging tile beside the ring, laid out as four 128-byte-swizzled
//    boxes of 64 columns (a warp's 4-byte stores hit 32 banks), fences them
//    for the async proxy and meets its warpgroup at a named barrier; one
//    thread then stores the boxes through a 3-D map of out (clipped at M
//    and N inside the expert) and commits them as one bulk group.  Before
//    it writes the staging tile again it waits only until that group has
//    read it, so the store drains to device memory under the next tile's
//    products.  The stores are marked L2 evict_first and the operand loads
//    evict_last: the output is written once, the operand panels read by
//    many tiles.
//  * shared memory: three 48 KB stages and 64 KB of staging (209 KB).  On
//    the H100 a fourth stage beside half the staging, the epilogue then in
//    two passes a tile, was slower at every shape (dw 2.7 to 4.7x); two stages
//    were 30 to 43% slower on grok-1's long contractions (PERF.md).
//  * a contraction of 65 to 96 (arctic's 80 tokens an expert) is one slice
//    96 deep a tile in two stages (an MN-major slice may have any multiple
//    of 16 rows), so the ring holds the next tile whole.
//
// `tf32x3` (gmm_tf32x3, fp32 operands whose strides TMA can describe): fp32
// products on the tensor cores at fp32 accuracy, by the split CUTLASS calls
// 3xTF32.  Each value v is split into hi = tf32(v) and lo = tf32(v - hi)
// (round to nearest, ties away: cvt.rna) and a product is a_hi b_hi +
// a_hi b_lo + a_lo b_hi, three TF32 wgmmas summed in fp32 (hopper.cuh:
// split_tf32).  TF32 runs at 495 TFLOP/s on the H100 against 67 for fp32 on
// the CUDA cores (NVIDIA's data sheet, SXM at 700 W), so three products give
// ~165 TFLOP/s of fp32-accurate work at best.
//  * the trap: a TF32 wgmma reads both shared-memory operands K-major; the
//    transpose bit exists only for 16-bit types.  So the body computes
//    out^T[e] (N x M, M contiguous) = sum_k A(m, k) B(n, k) with A the
//    register operand (the RS form, which TF32 allows) and B read K-major
//    from shared memory.  Each thread loads its A fragment values from the
//    raw A tile, whichever way TMA wrote it (A_K: rows of M, K contiguous;
//    else rows of K, M contiguous, in 32-column chunks), and splits them in
//    registers: a transposed A costs nothing but the fragment's addressing.
//    The B tile is split into a K-major B_hi and B_lo tile, which the
//    warpgroup's wgmmas read: elementwise, in its own swizzled layout, when
//    B is K-major in memory (B_K); otherwise the split pass writes the two
//    tiles transposed.  Its lanes walk the depth, so both the raw tile's
//    16-byte reads and the split tiles' 4-byte writes hit 32 distinct banks.
//    forward: y^T = w^T x^T (A = w, rows of D; B = x, K-major);
//    dx:      dx^T = w dy^T (A = w, K-major; B = dy, K-major);
//    dw:      dw^T = dy^T x (A = dy, rows of C; B = x, rows of C).
//  * one block per 64 (M) x 128 (N) tile of out^T, two warpgroups, each
//    owning 64 of the N columns: an m64n64k8 wgmma, 32 fp32 sums a thread.
//    Small tiles fill the card at the shapes the broker sends (128 blocks
//    at the registry's full tier, E8 C256 D512 F512; 32 at smoke) and keep
//    two blocks on an SM at grok width (106 KB of shared memory and 256
//    threads of at most 128 registers a block), so one block's split runs
//    while the other's products do.  Each warpgroup splits only its own
//    rows of B and its own copy of the A fragments, so the two meet only
//    where a raw stage is refilled.
//  * a ring of 3 stages of raw tiles (32-deep: B 128 x 32, A 64 x 32, fp32,
//    128-byte swizzle) filled by TMA, issued by thread 0 two stages ahead
//    once both warpgroups have read the stage it refills (an mbarrier each).
//    Per stage a warpgroup splits its B rows into the hi/lo tiles and its A
//    fragments into registers, fences the writes for the async proxy, meets
//    at a barrier, runs 12 wgmmas (three products for each of four k8
//    steps) and waits for them before the hi/lo tiles are written again.
//    On the H100, an overlapped variant (stage k + 1 split under stage k's
//    products, double-buffered, one block an SM) was a few percent faster
//    at the tiers and much slower at grok width, and one warpgroup with
//    n128 tiles slower at the tiers and faster at grok width (PERF.md).
//  * shared-memory pointers are aligned inside the shared window, so the
//    compiler keeps shared loads and stores, not generic ones.
//  * accuracy: the tensor cores' fp32 accumulation is not round-to-nearest.
//    Twelve wgmmas a stage all summed into one accumulator across D = 512
//    missed the fp32 tolerance (max-abs 2.2e-5 and 2.6e-5 against 2e-5 at
//    the registry's full tier in tests/test_torch_cuda.py, on an NVIDIA
//    H100 80GB HBM3 at 700 W), where the same products summed
//    round-to-nearest miss by 5.2e-6 at most (tests/test_torch_slice8.py).
//    So each stage sums its products in a fresh accumulator, the eight
//    small ones first and the four large ones last, so that only those
//    round at the stage's magnitude, and the CUDA cores add the stage's sum
//    to the running one with an fp32 add that rounds to nearest.
//  * no split of K across blocks: every sum is taken in one order, the same
//    on every run.  Ragged edges are clipped by TMA at the edge of each
//    expert (zero-filled), and the stores are guarded.
//  * tile order: N tiles fastest: the blocks of one A panel run together.
//  * the epilogue stores out^T's fragments to out (E, N, M): a warp's store
//    is 4 runs of 8 consecutive floats, whole 32-byte sectors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// the simt route (fp32 or bf16, any strides)
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BM = 128;  // rows of out (M) per block
constexpr int BN = 128;  // columns of out (N) per block
constexpr int BK = 8;    // depth (K) per shared-memory stage
constexpr int TM = 8;    // rows per thread
constexpr int TN = 8;    // columns per thread
constexpr int NT = 256;  // threads per block: (BM/TM) x (BN/TN)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The strides of one operand, in elements: expert, rows, columns.
struct Strides {
  int64_t e, r, c;
};

// out[e] (M x N, row-major) = A[e] (M x K) @ B[e] (K x N); grid (N tiles, M tiles, E)
template <typename T>
__device__ __forceinline__ void gmm_simt(const T* __restrict__ a, Strides sa, const T* __restrict__ b, Strides sb,
                                         T* __restrict__ out, int M, int N, int K) {
  __shared__ float As[BK][BM + 4];  // A tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN + 4];  // B tile: Bs[k][n]
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* ae = a + e * sa.e;
  const T* be = b + e * sb.e;
  T* oe = out + int64_t(e) * M * N;
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const bool a_k_fast = sa.c == 1, b_n_fast = sb.c == 1;  // each tile's loads walk its contiguous axis
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int idx = tid + i * NT;
      const int mm = a_k_fast ? idx / BK : idx % BM, kk = a_k_fast ? idx % BK : idx / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? to_f32(ae[gm * sa.r + gk * sa.c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / NT; ++i) {
      const int idx = tid + i * NT;
      const int kk = b_n_fast ? idx / BN : idx % BK, nn = b_n_fast ? idx % BN : idx / BK;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? to_f32(be[gk * sb.r + gn * sb.c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) store_as(&oe[int64_t(gm) * N + gn], acc[i][j]);
    }
  }
}

inline dim3 grid(int E, int M, int N) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, E); }

}  // namespace simt

// ---------------------------------------------------------------------------
// the wgmma route (bf16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128;     // rows of out (M) per block: two warpgroups x 64
constexpr int BN = 256;     // columns of out (N) per block
constexpr int BK = 64;      // depth (K) per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;   // A slice
constexpr int A_CHUNK = BK * 64 * 2;   // 64 rows (K-major) or 64 columns (MN-major) of it: a warpgroup's
constexpr int B_CHUNK = BK * 64 * 2;   // 64 columns of an MN-major B slice
constexpr int B_BYTES = BN * BK * 2;   // B slice
constexpr int THREADS = 384;           // 2 consumer warpgroups + the producer's
constexpr size_t SMEM = 1024 + size_t(STAGES) * (A_BYTES + B_BYTES) + 64;

// The persistent body (gmm_wgmma_persistent<.., STAGES_, STG_COLS, D>): a
// ring of STAGES_ slices D deep and, beside it, the staging tile its
// epilogue stores from, a warpgroup's 64 rows x STG_COLS columns in bf16,
// as boxes of 64 columns (128-byte rows, 128-byte swizzle).  The epilogue
// writes a tile in BN / STG_COLS passes.
constexpr int OUT_BOX = 64 * 64 * 2;  // 64 rows x 64 columns of out
template <int STAGES_, int STG_COLS, int D = BK>
__host__ __device__ constexpr size_t persistent_smem() {
  return 1024 + size_t(STAGES_) * (BM + BN) * D * 2 + 2 * size_t(STG_COLS / 64) * OUT_BOX + 64;
}

// One box of a map into shared memory (tma_load_3d), with the L2 policy
// `policy` where HINT.
template <bool HINT>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                         uint64_t policy) {
  if constexpr (HINT) {
    hopper::tma_load_3d_hint(dst, map, bar, c0, c1, c2, policy);
  } else {
    hopper::tma_load_3d(dst, map, bar, c0, c1, c2);
  }
}

// Slice kb, D deep, of A (rows m0.., MN-major: columns m0..) and B (columns
// n0..) of expert e into the ring's A and B slots `ad`, `bd`, counted on
// `bar`; where HINT, under the L2 policy `policy`.  A K-major slice is one
// 128-byte swizzle row of depths (D = BK); an MN-major one is D rows of
// each 64-column chunk, so any multiple of 16 up to 256 will do.
template <bool A_MN, bool B_MN, int D = BK, bool HINT = false>
__device__ __forceinline__ void load_slice(const CUtensorMap* amap, const CUtensorMap* bmap, uint8_t* ad, uint8_t* bd,
                                           uint64_t* bar, int kb, int m0, int n0, int e, uint64_t policy = 0) {
  static_assert(D == BK || (A_MN && B_MN), "a K-major slice is one swizzle row deep");
  constexpr int CHUNK = D * 64 * 2;
  hopper::mbar_arrive_expect_tx(bar, (BM + BN) * D * 2);
  if constexpr (A_MN) {
    for (int c = 0; c < BM / 64; ++c) load_box<HINT>(ad + c * CHUNK, amap, bar, m0 + 64 * c, kb * D, e, policy);
  } else {
    load_box<HINT>(ad, amap, bar, kb * D, m0, e, policy);
  }
  if constexpr (B_MN) {
    for (int c = 0; c < BN / 64; ++c) load_box<HINT>(bd + c * CHUNK, bmap, bar, n0 + 64 * c, kb * D, e, policy);
  } else {
    load_box<HINT>(bd, bmap, bar, kb * D, n0, e, policy);
  }
}

// acc += this warpgroup's 64 rows of the A slice at `a` (shared-window
// address) times the B slice at `b`, both D deep: D / 16 k16 wgmmas,
// issued, not waited for
template <bool A_MN, bool B_MN, int D = BK>
__device__ __forceinline__ void mma_slice(float (&acc)[BN / 2], uint32_t a, uint32_t b) {
  constexpr int CHUNK = D * 64 * 2;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // K-major: step 32 bytes inside the swizzled row; MN-major: step 16
    // rows of 128 bytes, chunks of 64 columns a chunk apart
    const uint64_t da = A_MN ? hopper::make_desc<128>(a + kk * 16 * 128, CHUNK, 1024)
                             : hopper::make_desc<128>(a + kk * 32, 16, 1024);
    const uint64_t db = B_MN ? hopper::make_desc<128>(b + kk * 16 * 128, CHUNK, 1024)
                             : hopper::make_desc<128>(b + kk * 32, 16, 1024);
    hopper::WgmmaSS<BN, B_MN, A_MN>::run(acc, da, db, 1);
  }
  hopper::wgmma_commit();
}

// out[e] (M x N) = A[e] (M x K) @ B[e] (K x N).  amap: (E, M, K) when A is
// K-major, (E, K, M) when A_MN; bmap: (E, N, K) when K-major, (E, K, N) when
// B_MN.  One block a tile, n_m x n_n x E of them, M tiles fastest.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void gmm_wgmma(const CUtensorMap* amap, const CUtensorMap* bmap,
                                          __nv_bfloat16* __restrict__ out, int M, int N, int K, int n_m, int n_n) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = smem;                             // STAGES A slices
  uint8_t* Bs = As + STAGES * A_BYTES;            // STAGES B slices
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;

  const int tile = blockIdx.x;
  const int m0 = (tile % n_m) * BM;
  const int n0 = ((tile / n_m) % n_n) * BN;
  const int e = tile / (n_m * n_n);
  const int n_k = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);  // every consumer thread releases
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    hopper::regs_release<24>();
    if (t == 0) {
      hopper::prefetch_map(amap);
      hopper::prefetch_map(bmap);
      for (int kb = 0; kb < n_k; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) hopper::mbar_wait(&empty[s], ((kb / STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
        uint8_t* ad = As + s * A_BYTES;
        if constexpr (A_MN) {
          for (int c = 0; c < BM / 64; ++c) hopper::tma_load_3d(ad + c * A_CHUNK, amap, &full[s], m0 + 64 * c, kb * BK, e);
        } else {
          hopper::tma_load_3d(ad, amap, &full[s], kb * BK, m0, e);
        }
        uint8_t* bd = Bs + s * B_BYTES;
        if constexpr (B_MN) {
          for (int c = 0; c < BN / 64; ++c) hopper::tma_load_3d(bd + c * B_CHUNK, bmap, &full[s], n0 + 64 * c, kb * BK, e);
        } else {
          hopper::tma_load_3d(bd, bmap, &full[s], kb * BK, n0, e);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64)
    hopper::regs_claim<240>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t a_base = hopper::smem_u32(As) + wg * A_CHUNK;
    const uint32_t b_base = hopper::smem_u32(Bs);
    for (int kb = 0; kb < n_k; ++kb) {
      const int s = kb % STAGES;
      hopper::mbar_wait(&full[s], (kb / STAGES) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major: step 32 bytes inside the swizzled row; MN-major: step 16
        // rows of 128 bytes, chunks of 64 columns a chunk apart
        const uint64_t da = A_MN ? hopper::make_desc<128>(a_base + s * A_BYTES + kk * 16 * 128, A_CHUNK, 1024)
                                 : hopper::make_desc<128>(a_base + s * A_BYTES + kk * 32, 16, 1024);
        const uint64_t db = B_MN ? hopper::make_desc<128>(b_base + s * B_BYTES + kk * 16 * 128, B_CHUNK, 1024)
                                 : hopper::make_desc<128>(b_base + s * B_BYTES + kk * 32, 16, 1024);
        hopper::WgmmaSS<BN, B_MN, A_MN>::run(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the group of slice kb - 1 has finished
      if (kb > 0) hopper::mbar_arrive(&empty[(kb - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    __nv_bfloat16* oe = out + int64_t(e) * M * N;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int row = m0 + 64 * wg + hopper::acc_row(t, i);
      const int col = n0 + hopper::acc_col(t, i);  // even; N is a multiple of 8
      if (row < M && col < N)
        *reinterpret_cast<__nv_bfloat162*>(oe + int64_t(row) * N + col) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// The persistent form of gmm_wgmma: the same products, tiles and layouts,
// with `tiles` = n_m x n_n x E tiles walked by gridDim.x blocks (block b
// takes tiles b, b + gridDim.x, ..., M tiles fastest), and out written by
// TMA through omap (E, M, N; boxes of 64 x 64).  The producer's stage index
// and barrier phases run on across tiles (`it` counts slices over the whole
// walk), so it loads the next tile's slices while the consumers finish this
// one's products and epilogue; each tile's store drains to device memory
// under the next tile's products.
template <bool A_MN, bool B_MN, int STAGES_, int STG_COLS, int D>
__device__ __forceinline__ void gmm_wgmma_persistent(const CUtensorMap* amap, const CUtensorMap* bmap,
                                                     const CUtensorMap* omap, int M, int N, int K, int n_m, int n_n,
                                                     int tiles) {
  static_assert(persistent_smem<STAGES_, STG_COLS, D>() <= 232448, "ring and staging fit in one block's shared memory");
  static_assert(BN % STG_COLS == 0 && STG_COLS % 64 == 0, "whole boxes, whole passes");
  constexpr int STG_WG = (STG_COLS / 64) * OUT_BOX;        // a warpgroup's staging tile
  constexpr int SA = BM * D * 2, SB = BN * D * 2;          // a slice of A, of B
  constexpr int WG_A = 64 * D * 2;                        // a warpgroup's 64 rows (or columns) of it
  // aligned inside the shared window, so the compiler keeps shared-memory
  // stores (not generic ones, with 64-bit addresses) for the staging tile
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* As = smem;                             // STAGES_ A slices
  uint8_t* Bs = As + STAGES_ * SA;                // STAGES_ B slices
  uint8_t* stg = Bs + STAGES_ * SB;               // the two warpgroups' staging tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + 2 * STG_WG);
  uint64_t* empty = full + STAGES_;

  const int n_k = (K + D - 1) / D;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);  // every consumer thread releases
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full, across tiles
    hopper::regs_release<40>();
    if (t == 0) {
      hopper::prefetch_map(amap);
      hopper::prefetch_map(bmap);
      const uint64_t keep = hopper::l2_evict_last();  // each operand slice is read by many tiles
      int it = 0;  // slices issued over the walk: stage it % STAGES_, its use it / STAGES_
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % n_m) * BM, n0 = ((tile / n_m) % n_n) * BN, e = tile / (n_m * n_n);
        for (int kb = 0; kb < n_k; ++kb, ++it) {
          const int s = it % STAGES_;
          // the stage's previous use (it - STAGES_) released by both warpgroups
          if (it >= STAGES_) hopper::mbar_wait(&empty[s], ((it / STAGES_) - 1) & 1);
          load_slice<A_MN, B_MN, D, true>(amap, bmap, As + s * SA, Bs + s * SB, &full[s], kb, m0, n0, e, keep);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64) of each tile
    hopper::regs_claim<232>();
    if (t == 0) hopper::prefetch_map(omap);
    const uint32_t a_base = hopper::smem_u32(As) + wg * WG_A;
    const uint32_t b_base = hopper::smem_u32(Bs);
    const uint64_t once = hopper::l2_evict_first();  // out is written once: let it leave L2 first
    // The staging tile's layout, as TMA reads a 128-byte-swizzled box:
    // column c of box c / 64, row r at r * 128, in 16-byte unit ((c % 64) /
    // 8) ^ (r % 8).  Accumulator pair i of this thread (hopper::acc_row,
    // acc_col) is row row0 + 8 ((i / 2) % 2), columns 8 (i / 4) + 2 (t % 4)
    // and one more: box i / 32, unit (i / 4) % 8, byte 4 (t % 4) of it; the
    // thread's rows share one residue mod 8, so eight XORs, computed once,
    // swizzle all its units, and every other term is a constant offset.  A
    // warp's stores for one i fill 8 rows x 4 pairs: 32 distinct banks.
    const int row0 = hopper::acc_row(t, 0);
    uint8_t* my_stg = stg + wg * STG_WG + row0 * 128 + 4 * (t & 3);
    int unit[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) unit[u] = (u ^ (row0 & 7)) << 4;
    int it = 0;  // slices consumed over the walk, in the producer's order
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < n_k; ++kb, ++it) {
        const int s = it % STAGES_;
        hopper::mbar_wait(&full[s], (it / STAGES_) & 1);
        mma_slice<A_MN, B_MN, D>(acc, a_base + s * SA, b_base + s * SB);
        hopper::wgmma_wait<1>();  // the group of slice it - 1 has finished
        if (kb > 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES_]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (n_k > 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES_]);  // the tile's last slice

      // epilogue, in BN / STG_COLS passes of STG_COLS columns
#pragma unroll
      for (int p = 0; p < BN / STG_COLS; ++p) {
        // the previous store has read the staging tile ...
        if (t == 0) hopper::bulk_wait_group_read<0>();
        hopper::named_sync(1 + wg, 128);
        // ... so write this pass's columns, in bf16
#pragma unroll
        for (int i = p * STG_COLS / 2; i < (p + 1) * STG_COLS / 2; i += 2) {
          const int off = ((i >> 5) - p * STG_COLS / 64) * OUT_BOX + ((i >> 1) & 1) * 8 * 128 + unit[(i >> 2) & 7];
          *reinterpret_cast<uint32_t*>(my_stg + off) = hopper::pack_bf16(acc[i], acc[i + 1]);
        }
        hopper::fence_proxy_async();      // the staging writes, before the TMA store reads them
        hopper::named_sync(1 + wg, 128);  // every thread of the warpgroup has written its part
        if (t == 0) {
          const int m0 = (tile % n_m) * BM, n0 = ((tile / n_m) % n_n) * BN, e = tile / (n_m * n_n);
          const int row = m0 + 64 * wg, col = n0 + p * STG_COLS;
          if (row < M) {  // TMA clips the box at M and N, inside expert e
            for (int c = 0; c < STG_COLS / 64 && col + 64 * c < N; ++c)
              hopper::tma_store_3d_hint(omap, stg + wg * STG_WG + c * OUT_BOX, col + 64 * c, row, e, once);
          }
          hopper::bulk_commit_group();
        }
      }
    }
    if (t == 0) hopper::bulk_wait_group_read<0>();  // the staging tile outlives its last store's reads
  }
}

// The tensor maps of A and B for gmm_wgmma<A_MN, B_MN> (and for the
// persistent body's slices D deep).  Returns 0 or a CUDA error.
template <bool A_MN, bool B_MN, int D = BK>
int make_maps(CUtensorMap* amap, CUtensorMap* bmap, const void* a, const void* b, int E, int M, int N, int K) {
  int err = A_MN ? hopper::make_map_3d(amap, a, E, K, M, D, 64, 128) : hopper::make_map_3d(amap, a, E, M, K, BM, BK, 128);
  if (!err) err = B_MN ? hopper::make_map_3d(bmap, b, E, K, N, D, 64, 128) : hopper::make_map_3d(bmap, b, E, N, K, BN, BK, 128);
  return err;
}

// The map gmm_wgmma_persistent stores out (E, M, N) through: boxes of 64
// rows x 64 columns, 128-byte swizzle.  Returns 0 or a CUDA error.
inline int make_out_map(CUtensorMap* omap, void* out, int E, int M, int N) {
  return hopper::make_map_3d(omap, out, E, M, N, 64, 64, 128);
}

// Launch `kernel` (a __global__ wrapper of gmm_wgmma) over every tile.
template <typename Kernel>
int launch(Kernel kernel, const CUtensorMap& amap, const CUtensorMap& bmap, void* out, int E, int M, int N, int K,
           cudaStream_t stream) {
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (cerr != cudaSuccess) return int(cerr);
  const int n_m = (M + BM - 1) / BM, n_n = (N + BN - 1) / BN;
  const int64_t tiles = int64_t(n_m) * n_n * E;
  if (tiles > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  kernel<<<unsigned(tiles), THREADS, SMEM, stream>>>(amap, bmap, static_cast<__nv_bfloat16*>(out), M, N, K, n_m, n_n);
  return int(cudaGetLastError());
}

// Launch `kernel` (a __global__ wrapper of gmm_wgmma_persistent<.., STAGES_,
// STG_COLS>) on as many blocks as the device's SMs hold at once, or one a
// tile where there are fewer.
template <int STAGES_, int STG_COLS, int D, typename Kernel>
int launch_persistent(Kernel kernel, const CUtensorMap& amap, const CUtensorMap& bmap, const CUtensorMap& omap, int E,
                      int M, int N, int K, int device, cudaStream_t stream) {
  constexpr size_t SMEM_PERSISTENT = persistent_smem<STAGES_, STG_COLS, D>();
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_PERSISTENT));
  if (cerr != cudaSuccess) return int(cerr);
  int sms = 0, per_sm = 0;
  cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cerr == cudaSuccess) cerr = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM_PERSISTENT);
  if (cerr != cudaSuccess) return int(cerr);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int n_m = (M + BM - 1) / BM, n_n = (N + BN - 1) / BN;
  const int64_t tiles = int64_t(n_m) * n_n * E, resident = int64_t(sms) * per_sm;
  const int64_t grid = tiles < resident ? tiles : resident;
  if (tiles + grid > 0x7fffffff) return int(cudaErrorInvalidConfiguration);  // a block's next tile index stays an int
  kernel<<<unsigned(grid), THREADS, SMEM_PERSISTENT, stream>>>(amap, bmap, omap, M, N, K, n_m, n_n, int(tiles));
  return int(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// the tf32x3 route (fp32)
// ---------------------------------------------------------------------------

namespace tf32x3 {

constexpr int BM = 64;                  // rows of out^T (M) per block: the wgmma's m64
constexpr int BN = 128;                 // columns of out^T (N) per block
constexpr int WGS = 2;                  // warpgroups, each owning BN / WGS of the columns
constexpr int WN = BN / WGS;            // a warpgroup's columns: its wgmma's N
constexpr int BK = 32;                  // depth (K) per stage: one 128-byte swizzle row of fp32
constexpr int STAGES = 3;
constexpr int CHUNK = BK * 32 * 4;      // 32 columns of a tile whose rows are depths: 32 rows of 128 bytes
constexpr int B_BYTES = BN * BK * 4;    // B tile: 128 rows (N) of 128 bytes (K-major), or 4 chunks
constexpr int BW_BYTES = B_BYTES / WGS; // a warpgroup's rows of it
constexpr int A_BYTES = BM * BK * 4;    // A tile: 64 rows (M) of 128 bytes (K-major), or 2 chunks
constexpr int STAGE_BYTES = B_BYTES + A_BYTES;
constexpr int THREADS = 128 * WGS;
constexpr size_t SMEM = 1024 + size_t(STAGES) * STAGE_BYTES + 2 * B_BYTES + 128;
static_assert(STAGE_BYTES % 1024 == 0 && BW_BYTES % 1024 == 0, "tiles on the swizzle's 1024-byte period");

// byte offset of the 16-byte unit u of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }

// element (m, k) of the raw A tile: A_K, row m (K contiguous); else chunk
// m / 32 of rows k (M contiguous), as TMA wrote it
template <bool A_K>
__device__ __forceinline__ const float* a_at(const uint8_t* tile, int m, int k) {
  if constexpr (A_K) return reinterpret_cast<const float*>(tile + swz(m, k >> 2) + ((k & 3) << 2));
  return reinterpret_cast<const float*>(tile + (m >> 5) * CHUNK + swz(k, (m & 31) >> 2) + ((m & 3) << 2));
}

// out^T[e] (N x M, M contiguous) = sum_k A(m, k) B(n, k).  amap: (E, M, K)
// when A_K, else (E, K, M); bmap: (E, N, K) when B_K, else (E, K, N).  One
// block a tile, n_n x n_m x E of them, N tiles fastest.
template <bool A_K, bool B_K>
__device__ __forceinline__ void gmm_tf32x3(const CUtensorMap* amap, const CUtensorMap* bmap, float* __restrict__ out,
                                           int M, int N, int K, int n_n, int n_m) {
  // aligned in the shared window itself, so the compiler keeps shared-memory
  // loads and stores (not generic ones) for every pointer derived from it
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023) & ~1023u) - raw);  // STAGES x {B tile, A tile}, raw fp32
  uint8_t* bhi = ring + STAGES * STAGE_BYTES;    // the split B tile, K-major
  uint8_t* blo = bhi + B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(blo + B_BYTES);
  uint64_t* empty = full + STAGES;

  const int tile = blockIdx.x;
  const int n0 = (tile % n_n) * BN;
  const int m0 = ((tile / n_n) % n_m) * BM;
  const int e = tile / (n_n * n_m);
  const int n_k = (K + BK - 1) / BK;
  const int t = threadIdx.x, wg = t >> 7, tw = t & 127, warp = tw >> 5, lane = t & 31;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WGS);  // each warpgroup, once it has read the stage
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  auto issue = [&](int kb) {  // thread 0: stage kb's B and A tiles
    const int s = kb % STAGES;
    uint8_t* st = ring + s * STAGE_BYTES;
    hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
    if constexpr (B_K) {
      hopper::tma_load_3d(st, bmap, &full[s], kb * BK, n0, e);
    } else {
      for (int c = 0; c < BN / 32; ++c) hopper::tma_load_3d(st + c * CHUNK, bmap, &full[s], n0 + 32 * c, kb * BK, e);
    }
    if constexpr (A_K) {
      hopper::tma_load_3d(st + B_BYTES, amap, &full[s], kb * BK, m0, e);
    } else {
      for (int c = 0; c < BM / 32; ++c) hopper::tma_load_3d(st + B_BYTES + c * CHUNK, amap, &full[s], m0 + 32 * c, kb * BK, e);
    }
  };
  if (t == 0) {
    hopper::prefetch_map(amap);
    hopper::prefetch_map(bmap);
    for (int kb = 0; kb < STAGES - 1 && kb < n_k; ++kb) issue(kb);
  }

  float acc[WN / 2], part[WN / 2];  // the running sum (CUDA cores); a stage's products (tensor cores)
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = part[i] = 0.f;
  uint8_t* my_hi = bhi + wg * BW_BYTES;  // this warpgroup's rows of the split B tile: its B operand
  uint8_t* my_lo = blo + wg * BW_BYTES;
  const uint32_t hi_base = hopper::smem_u32(my_hi), lo_base = hopper::smem_u32(my_lo);
  for (int kb = 0; kb < n_k; ++kb) {
    // refill the stage of kb - 1 once both warpgroups have read it
    if (t == 0 && kb + STAGES - 1 < n_k) {
      if (kb > 0) hopper::mbar_wait(&empty[(kb - 1) % STAGES], ((kb - 1) / STAGES) & 1);
      issue(kb + STAGES - 1);
    }
    const int s = kb % STAGES;
    const uint8_t* st = ring + s * STAGE_BYTES;
    hopper::mbar_wait(&full[s], (kb / STAGES) & 1);

    if constexpr (B_K) {
      // this warpgroup's rows, 16-byte units, four a thread, split in place of their offsets
#pragma unroll
      for (int i = 0; i < BW_BYTES / 16 / 128; ++i) {
        const int off = (tw + i * 128) * 16;
        const float4 v = *reinterpret_cast<const float4*>(st + wg * BW_BYTES + off);
        uint4 hi, lo;
        hopper::split_tf32(v.x, hi.x, lo.x);
        hopper::split_tf32(v.y, hi.y, lo.y);
        hopper::split_tf32(v.z, hi.z, lo.z);
        hopper::split_tf32(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(my_hi + off) = hi;
        *reinterpret_cast<uint4*>(my_lo + off) = lo;
      }
    } else {
      // this warpgroup's 64 columns, transposed: lane k reads 4 columns of
      // its depth row and writes them to 4 rows of the K-major tiles
#pragma unroll
      for (int i = 0; i < BW_BYTES / 16 / 128; ++i) {
        const int u = warp + 4 * i;  // 16-byte unit of the warpgroup's columns: columns 4u .. 4u + 3
        const int n = 4 * u;          // its first column, within the warpgroup's 64
        const float4 v = *reinterpret_cast<const float4*>(st + (2 * wg + (n >> 5)) * CHUNK + swz(lane, u & 7));
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t hi, lo;
          hopper::split_tf32(vs[j], hi, lo);
          const int off = swz(n + j, lane >> 2) + ((lane & 3) << 2);
          *reinterpret_cast<uint32_t*>(my_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(my_lo + off) = lo;
        }
      }
    }
    // A: this thread's fragments for the four k8 steps, split in registers
    uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 16 * warp + (lane >> 2) + 8 * (i & 1);
        const int k = 8 * kk + (lane & 3) + 4 * (i >> 1);
        hopper::split_tf32(*a_at<A_K>(st + B_BYTES, m, k), ahi[kk][i], alo[kk][i]);
      }
    hopper::fence_proxy_async();           // the hi/lo tiles are read by wgmma
    hopper::named_sync(1 + wg, 128);       // ... once every thread of the warpgroup has written its part
    if (tw == 0) hopper::mbar_arrive(&empty[s]);  // and the raw stage is read

    // B: K-major, 8 rows of 128 bytes apart by 1024; step 32 bytes (k8) in the row.
    // The stage's small products first, from a fresh accumulator, then the
    // large ones: the tensor cores' fp32 additions (not round-to-nearest;
    // see the header) then round at the stage's magnitude only at its four
    // large additions
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dhi = hopper::make_desc<128>(hi_base + kk * 32, 16, 1024);
      const uint64_t dlo = hopper::make_desc<128>(lo_base + kk * 32, 16, 1024);
      hopper::WgmmaTF32RS<WN>::run(part, alo[kk], dhi, kk > 0);  // a_lo b_hi
      hopper::WgmmaTF32RS<WN>::run(part, ahi[kk], dlo, 1);       // a_hi b_lo
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      hopper::WgmmaTF32RS<WN>::run(part, ahi[kk], hopper::make_desc<128>(hi_base + kk * 32, 16, 1024), 1);  // a_hi b_hi
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    hopper::named_sync(1 + wg, 128);       // every warp's products are done with the hi/lo tiles
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] += part[i];  // round to nearest, on the CUDA cores
  }

  // acc holds out^T: row m, column n
  float* oe = out + int64_t(e) * M * N;
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) {
    const int m = m0 + hopper::acc_row(tw, i);
    const int n = n0 + wg * WN + hopper::acc_col(tw, i);
    if (m < M && n < N) oe[int64_t(n) * M + m] = acc[i];
  }
}

// The tensor maps of A and B for gmm_tf32x3<A_K, B_K>.  Returns 0 or a CUDA error.
template <bool A_K, bool B_K>
int make_maps(CUtensorMap* amap, CUtensorMap* bmap, const void* a, const void* b, int E, int M, int N, int K) {
  int err = A_K ? hopper::make_map_3d(amap, a, E, M, K, BM, BK, 128, true) : hopper::make_map_3d(amap, a, E, K, M, BK, 32, 128, true);
  if (!err) err = B_K ? hopper::make_map_3d(bmap, b, E, N, K, BN, BK, 128, true) : hopper::make_map_3d(bmap, b, E, K, N, BK, 32, 128, true);
  return err;
}

// Launch `kernel` (a __global__ wrapper of gmm_tf32x3) over every tile.
template <typename Kernel>
int launch(Kernel kernel, const CUtensorMap& amap, const CUtensorMap& bmap, void* out, int E, int M, int N, int K,
           cudaStream_t stream) {
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (cerr != cudaSuccess) return int(cerr);
  const int n_n = (N + BN - 1) / BN, n_m = (M + BM - 1) / BM;
  const int64_t tiles = int64_t(n_n) * n_m * E;
  if (tiles > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  kernel<<<unsigned(tiles), THREADS, SMEM, stream>>>(amap, bmap, static_cast<float*>(out), M, N, K, n_n, n_m);
  return int(cudaGetLastError());
}

}  // namespace tf32x3

}  // namespace
