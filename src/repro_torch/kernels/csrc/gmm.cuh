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
// `mma` (gmm_mma): the tensor cores through warp-level mma.sync, any
// strides (the route of every GEMM whose rows TMA cannot describe).
// out[e] (M x N) = A[e] (M x K) @ B[e] (K x N) with each operand given by
// its strides: the three products are three stride sets.  Its CUDA-core
// predecessor (`simt`: 128 x 128 tiles, 8-deep steps each a load round trip
// and two barriers, no prefetch) lost 2 to 3.3x to torch.bmm at E3 C80 D96
// F50 / F100 (PERF.md).
//  * one block of four warps per 64 x 64 tile of out (a warp 32 x 32: 2 x 4
//    m16n8 tiles), so F 50 or 100 no longer takes a 128-wide tile.
//  * the operands reach registers by each thread's own addressing from
//    shared memory, so any layout works and no transpose is needed: each
//    stage's tiles are kept in the operand's own layout (rows along its
//    contiguous axis, padded so that a warp's fragment reads hit 32 banks).
//  * bf16: m16n8k16 products summed in fp32.  fp32: three TF32 m16n8k8
//    products a term (hopper::split_tf32), in tf32x3's order: a stage's
//    small products first into a fresh sum, then its large ones, the
//    stage's sum then added on the CUDA cores, rounding to nearest.
//  * a ring of three 32-deep stages, issued two ahead: by 4-byte cp.asyncs
//    (fp32; bf16 pairs where every stride is even), else by guarded 2-byte
//    loads into registers a stage ahead, stored a stage later.  A 96-deep
//    contraction (E3 C80 D96 F50) has every stage in flight at once.
//  * where the tiles are few, the walk is split over a thread-block cluster
//    (split_of, sum_parts), as tf32x3's gradients are.  Ragged edges are
//    zero-filled in the loads and guarded in the stores.
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
//  * the forward splits no walk: every sum is taken in one order, the same
//    on every run.  The gradients (moe_gmm_bwd.cu), where their tiles are
//    few, split the walk over a cluster of P blocks a tile (split_of: the
//    largest P <= 8 whose clusters are all resident at once and which
//    takes MIN_SAVED stages or more off a walk): each block walks a run of
//    the stages in the order above, from a zero sum, and the parts' sums
//    meet through distributed shared memory in the ring, which the walk
//    has freed: each element's parts are added in part order by one block
//    (sum_parts), fp32 adds that round to nearest, no atomics, so two calls
//    give the same bits.  P = 1 is the one-block kernel.  Ragged edges are
//    clipped by TMA at the edge of each expert (zero-filled), and the
//    stores are guarded.
//  * tile order: N tiles fastest: the blocks of one A panel run together.
//  * the epilogue stores out^T's fragments to out (E, N, M): a warp's store
//    is 4 runs of 8 consecutive floats, whole 32-byte sectors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// a walk split over a thread-block cluster (the tf32x3 gradients, mma)
// ---------------------------------------------------------------------------

constexpr int MAX_PARTS = 8;  // a cluster's blocks, at most: the portable cluster size

// What the device holds of a kernel at once: its SMs; the occupancy
// calculator's blocks an SM at its own shared memory (per_sm); the shared
// memory a split launch asks for, half an SM's and more, so that each block
// of a cluster has an SM of its own (split_smem: two blocks of a cluster
// on one SM share its tensor cores: PERF.md), and its blocks an SM
// (split_per_sm, 1); clusters[p], the clusters of p blocks of a split
// launch resident at once (clusters[1]: the blocks of a one-block launch).
struct Residency {
  int sms, per_sm, split_per_sm, clusters[MAX_PARTS + 1];
  size_t split_smem;
};

// How a grid of `tiles` tiles, each a walk of n_k stages, is cut: P parts of
// spp stages (the last may hold fewer), one block of a P-block cluster
// each.  P is the largest, at most MAX_PARTS and n_k, whose tiles' clusters
// are all resident at once (one wave: clusters of P blocks are placed
// within a GPC, so fewer fit than blocks) and which takes `min_saved`
// stages or more off a block's walk (below that, the cluster's barriers and
// the parts' sum cost more than the stages save: the kernel's own figure,
// timed at P = 1 to 8 on an H100, PERF.md); every part then holds at
// least one stage.  P = 1 where none does.
struct Split {
  int parts, spp;
};

inline Split split_of(int64_t tiles, int n_k, const Residency& r, int min_saved) {
  int want = 1;
  for (int p = (n_k < MAX_PARTS ? n_k : MAX_PARTS); p >= 2; --p) {
    if (tiles <= r.clusters[p] && n_k - (n_k + p - 1) / p >= min_saved) {
      want = p;
      break;
    }
  }
  Split s;
  s.spp = n_k > 0 ? (n_k + want - 1) / want : 0;
  s.parts = n_k > 0 ? (n_k + s.spp - 1) / s.spp : 1;
  return s;
}

// The Residency of `kernel` (`threads` threads, `smem` bytes of dynamic
// shared memory) on `device`, asked of the occupancy calculator once a
// process; the kernel's shared-memory attribute is set to split_smem, so
// that it launches at either size.
template <typename Kernel>
cudaError_t residency_of(Kernel kernel, int threads, size_t smem, int device, Residency* r) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, Residency> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), device);
  const auto it = known.find(key);
  if (it != known.end()) {
    *r = it->second;
    return cudaSuccess;
  }
  int sm_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&r->sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  r->split_smem = smem > size_t(sm_smem / 2 + 1024) ? smem : size_t(sm_smem / 2 + 1024);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(r->split_smem));
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r->per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r->split_per_sm, kernel, threads, r->split_smem);
  if (err == cudaSuccess && (r->per_sm < 1 || r->split_per_sm < 1)) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return err;
  r->clusters[0] = 0;
  r->clusters[1] = r->sms * r->per_sm;
  for (int p = 2; p <= MAX_PARTS && err == cudaSuccess; ++p) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(unsigned(p));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = r->split_smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&r->clusters[p], kernel, &cfg);
  }
  if (err == cudaSuccess) known[key] = *r;
  return err;
}

// The parts' sums meet.  Every thread of every block of a cluster of
// `parts` has written its U units of four partial sums to `mine` in its
// own shared memory (unit u at mine[u * NT + thread]); block `rank` adds
// units rank, rank + parts, ... of the same thread over the parts in part
// order, each an fp32 add that rounds to nearest, and hands each sum to
// store(u, sum).  No atomics: every call adds in the same order.
template <int NT, int U, typename Store>
__device__ __forceinline__ void sum_parts(const float4* mine, int parts, int rank, Store store) {
  hopper::cluster_sync();  // every part's sums are written
  for (int u = rank; u < U; u += parts) {
    const uint32_t addr = hopper::smem_u32(mine + u * NT + threadIdx.x);
    float4 v[MAX_PARTS];  // every part's load in flight before the first add
#pragma unroll
    for (int p = 0; p < MAX_PARTS; ++p)
      if (p < parts) v[p] = hopper::ld_cluster_v4(hopper::map_rank(addr, p));
    float4 s = v[0];
#pragma unroll
    for (int p = 1; p < MAX_PARTS; ++p) {
      if (p < parts) {
        s.x += v[p].x;
        s.y += v[p].y;
        s.z += v[p].z;
        s.w += v[p].w;
      }
    }
    store(u, s);
  }
  hopper::cluster_sync();  // no block leaves while a peer still reads its shared memory
}

// One product's launch: its tiles (n_n x n_m x E of them), stages, the
// fewest stages a split must save, the device's Residency of its kernel
// and its split.
struct Plan {
  int n_n, n_m, n_k, min_saved;
  int64_t tiles;
  Residency res;
  Split split;
};

// The plan of a product out (E x M x N) = a (M x K) b (K x N) a expert on
// tiles of bm x bn, walked bk deep a stage, for `kernel` (`threads`
// threads, `smem` bytes of dynamic shared memory a block where one part).
template <typename Kernel>
cudaError_t plan_of(Kernel kernel, int threads, size_t smem, int min_saved, int bm, int bn, int bk, int E, int M, int N,
                    int K, int device, Plan* pl) {
  const cudaError_t err = residency_of(kernel, threads, smem, device, &pl->res);
  if (err != cudaSuccess) return err;
  pl->n_n = (N + bn - 1) / bn;
  pl->n_m = (M + bm - 1) / bm;
  pl->n_k = (K + bk - 1) / bk;
  pl->min_saved = min_saved;
  pl->tiles = int64_t(pl->n_n) * pl->n_m * E;
  pl->split = split_of(pl->tiles, pl->n_k, pl->res, min_saved);
  return cudaSuccess;
}

// A plan's launch (`threads` threads, `smem` bytes where one part,
// r.split_smem where more), as the occupancy calculator sees it: out[0]
// parts, [1] blocks, [2] threads, [3] dynamic shared memory a block, [4]
// blocks an SM, [5] warps an SM, [6] clusters of `parts` blocks resident
// at once, [7] stages, [8] stages a part, [9] SMs, [10] the fewest stages a
// split must save, [11 + p - 1] clusters of p blocks resident at once, p =
// 1 .. MAX_PARTS.
inline void describe_launch(const Plan& pl, int threads, size_t smem, long long* out) {
  const Residency& r = pl.res;
  const bool split = pl.split.parts > 1;
  const int per_sm = split ? r.split_per_sm : r.per_sm;
  const long long vals[11] = {pl.split.parts, pl.tiles * pl.split.parts, threads, (long long)(split ? r.split_smem : smem),
                              per_sm, per_sm * threads / 32, r.clusters[pl.split.parts], pl.n_k, pl.split.spp, r.sms,
                              pl.min_saved};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  for (int p = 1; p <= MAX_PARTS; ++p) out[10 + p] = r.clusters[p];
}

// ---------------------------------------------------------------------------
// the mma route (fp32 or bf16, any strides)
// ---------------------------------------------------------------------------

namespace mma {

constexpr int BM = 64;      // rows of out (M) per block
constexpr int BN = 64;      // columns of out (N) per block
constexpr int BK = 32;      // depth (K) per stage
constexpr int STAGES = 3;   // a ring of stages, two issued ahead
constexpr int NT = 128;     // four warps, each 32 x 32 of out: 2 x 4 tiles of m16n8
constexpr int UNITS = 8;    // a thread's sums, in units of four: one m16n8 tile each

// The strides of one operand, in elements: expert, rows, columns.
struct Strides {
  int64_t e, r, c;
};

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One operand's tile of a stage in shared memory, in the operand's own
// layout: KC (its contiguous axis is the depth), 64 rows (of M or N) of 32
// depths; else 32 rows (depths) of 64.  Rows are padded so that a warp's
// fragment reads hit 32 distinct banks.
template <typename T, bool KC>
struct Tile {
  static constexpr int PITCH = KC ? (sizeof(T) == 4 ? 36 : 40) : 72;  // elements a row
  static constexpr int IN = KC ? BK : BM;                             // elements a row holds
  static constexpr int OUT = KC ? BM : BK;                            // rows
  static constexpr int BYTES = OUT * PITCH * int(sizeof(T));
  // element (mn, k): mn a row of A or a column of B
  __device__ static int at(int mn, int k) { return KC ? mn * PITCH + k : k * PITCH + mn; }
};

template <typename T, bool A_K, bool B_K>
__host__ __device__ constexpr int stage_bytes() {
  return Tile<T, A_K>::BYTES + Tile<T, B_K>::BYTES;
}

template <typename T, bool A_K, bool B_K>
constexpr size_t smem_bytes() {
  return size_t(STAGES) * stage_bytes<T, A_K, B_K>();
}

// One operand of a stage by 4-byte cp.asyncs: rows mn0.. (of MN) and depths
// k0.. (of K) of the expert's `src`, element (mn, k) at mn * s_mn + k * s_k,
// into `dst`.  A copy is one fp32 value or two bf16 adjacent along the
// contiguous axis (whose stride is then 1, and every other even); what lies
// past MN or K is zero-filled.
template <typename T, bool KC>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int64_t s_mn, int64_t s_k, int mn0, int MN, int k0,
                                           int K) {
  using TL = Tile<T, KC>;
  constexpr int V = 4 / int(sizeof(T));  // elements a copy
#pragma unroll
  for (int i = 0; i < TL::IN * TL::OUT / V / NT; ++i) {
    const int idx = int(threadIdx.x) + i * NT;
    const int in = (idx % (TL::IN / V)) * V, out = idx / (TL::IN / V);  // the copies of a warp walk the contiguous axis
    const int mn = KC ? out : in, k = KC ? in : out;
    const int gmn = mn0 + mn, gk = k0 + k;
    const bool row_in = KC ? gmn < MN : gk < K;
    const int left = (KC ? K - gk : MN - gmn);  // elements of the row from this one on
    const int n = row_in ? (left < V ? (left > 0 ? left : 0) : V) : 0;
    hopper::cp_async_4(dst + TL::at(mn, k), n ? src + gmn * s_mn + gk * s_k : src, uint32_t(n) * sizeof(T));
  }
}

// The same tile's bf16 values where 4-byte copies cannot take them (an odd
// stride or start): fetch() loads them into registers, guarded, put()
// stores them into shared memory a stage later.
template <bool KC>
struct Staged {
  using TL = Tile<__nv_bfloat16, KC>;
  static constexpr int PER = TL::IN * TL::OUT / NT;
  unsigned short v[PER];

  __device__ __forceinline__ void fetch(const __nv_bfloat16* src, int64_t s_mn, int64_t s_k, int mn0, int MN, int k0,
                                        int K) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = int(threadIdx.x) + i * NT;
      const int in = idx % TL::IN, out = idx / TL::IN;
      const int gmn = mn0 + (KC ? out : in), gk = k0 + (KC ? in : out);
      v[i] = gmn < MN && gk < K ? s[gmn * s_mn + gk * s_k] : 0;
    }
  }

  __device__ __forceinline__ void put(__nv_bfloat16* dst) const {
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = int(threadIdx.x) + i * NT;
      const int in = idx % TL::IN, out = idx / TL::IN;
      d[TL::at(KC ? out : in, KC ? in : out)] = v[i];
    }
  }
};

// the fp32 value at element (mn, k) of a tile
template <bool KC>
__device__ __forceinline__ float f32_at(const float* tile, int mn, int k) {
  return tile[Tile<float, KC>::at(mn, k)];
}

// two bf16 at depths k and k + 1 of row or column mn, as one register (k
// in the low half): one 4-byte read where the depth is contiguous
template <bool KC>
__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* tile, int mn, int k) {
  using TL = Tile<__nv_bfloat16, KC>;
  if constexpr (KC) return *reinterpret_cast<const uint32_t*>(tile + TL::at(mn, k));
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(tile + TL::at(mn, k));
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(tile + TL::at(mn, k + 1));
  return lo | (hi << 16);
}

// One fp32 stage on three TF32 products a term, in tf32x3's order: the
// small products (a_lo b_hi, a_hi b_lo) of its four k8 steps first, from a
// fresh sum, then the large ones (a_hi b_hi), each value split again from
// the tile (hopper::split_tf32); the stage's sum is then added to `acc` on
// the CUDA cores, rounding to nearest.  (wm, wn): the warp's corner.
template <bool A_K, bool B_K>
__device__ __forceinline__ void stage_tf32x3(float (&acc)[2][4][4], const float* As, const float* Bs, int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float part[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // 0: the small products; 1: the large ones
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = f32_at<A_K>(As, wm + 16 * mt + g + 8 * (i & 1), 8 * kk + q + 4 * (i >> 1));
          if (pass == 0) {
            hopper::split_tf32(v, ahi[mt][i], alo[mt][i]);
          } else {
            ahi[mt][i] = hopper::to_tf32(v);
          }
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v = f32_at<B_K>(Bs, wn + 8 * nt + g, 8 * kk + q + 4 * i);
          if (pass == 0) {
            hopper::split_tf32(v, bhi[nt][i], blo[nt][i]);
          } else {
            bhi[nt][i] = hopper::to_tf32(v);
          }
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (pass == 0) {
            hopper::mma_tf32_m16n8k8(part[mt][nt], alo[mt], bhi[nt]);
            hopper::mma_tf32_m16n8k8(part[mt][nt], ahi[mt], blo[nt]);
          } else {
            hopper::mma_tf32_m16n8k8(part[mt][nt], ahi[mt], bhi[nt]);
          }
        }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];  // round to nearest, on the CUDA cores
}

// One bf16 stage: two k16 steps of m16n8k16 products into the fp32 sums.
template <bool A_K, bool B_K>
__device__ __forceinline__ void stage_bf16(float (&acc)[2][4][4], const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                           int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[mt][i] = bf16_pair<A_K>(As, wm + 16 * mt + g + 8 * (i & 1), 16 * kk + 2 * q + 8 * (i >> 1));
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) b[nt][i] = bf16_pair<B_K>(Bs, wn + 8 * nt + g, 16 * kk + 2 * q + 8 * i);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) hopper::mma_bf16_m16n8k16(acc[mt][nt], a[mt], b[nt]);
  }
}

// out[e] (M x N, row-major) = A[e] (M x K) @ B[e] (K x N), each operand
// given by its strides (A: rows of M, columns of K; B: rows of K, columns
// of N); A_K and B_K say which has the depth as its contiguous axis.  A
// grid of n_n x n_m x E tiles, N tiles fastest, each a cluster of
// `parts` = ceil(n_k / spp) blocks (one block where spp covers n_k), block
// r of a cluster walking stages r spp .. (r + 1) spp - 1.  ASYNC: every
// operand takes 4-byte cp.asyncs (fp32; bf16 with even strides and starts),
// else the bf16 values are staged through registers (Staged).
template <typename T, bool A_K, bool B_K, bool ASYNC>
__device__ __forceinline__ void gmm_mma(const T* __restrict__ a, Strides sa, const T* __restrict__ b, Strides sb,
                                        T* __restrict__ out, int M, int N, int K, int n_n, int n_m, int spp) {
  using TA = Tile<T, A_K>;
  using TB = Tile<T, B_K>;
  constexpr int STAGE = stage_bytes<T, A_K, B_K>();
  static_assert(ASYNC || sizeof(T) == 2, "fp32 values always take 4-byte copies");
  static_assert(size_t(STAGES) * STAGE >= size_t(UNITS) * NT * 16, "the ring holds the parts' sums");
  extern __shared__ __align__(128) uint8_t smem_raw[];
  auto a_tile = [&](int s) { return reinterpret_cast<T*>(smem_raw + s * STAGE); };
  auto b_tile = [&](int s) { return reinterpret_cast<T*>(smem_raw + s * STAGE + TA::BYTES); };

  const int n_k = (K + BK - 1) / BK;
  const int parts = spp > 0 ? (n_k + spp - 1) / spp : 1;
  const int tile = int(blockIdx.x) / parts, rank = int(blockIdx.x) % parts;
  const int kb0 = rank * spp;
  const int n_s = spp > 0 ? min(spp, n_k - kb0) : 0;  // this part's stages: kb0 .. kb0 + n_s - 1
  const int n0 = (tile % n_n) * BN, m0 = ((tile / n_n) % n_m) * BM, e = tile / (n_n * n_m);
  const T* ae = a + e * sa.e;
  const T* be = b + e * sb.e;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  auto compute = [&](int s) {
    if constexpr (sizeof(T) == 4) {
      stage_tf32x3<A_K, B_K>(acc, a_tile(s), b_tile(s), wm, wn);
    } else {
      stage_bf16<A_K, B_K>(acc, a_tile(s), b_tile(s), wm, wn);
    }
  };
  if constexpr (ASYNC) {
    auto issue = [&](int j) {  // stage j of the part into slot j % STAGES, as one commit group (empty past the part)
      if (j < n_s) {
        const int k0 = (kb0 + j) * BK;
        copy_async<T, A_K>(a_tile(j % STAGES), ae, sa.r, sa.c, m0, M, k0, K);
        copy_async<T, B_K>(b_tile(j % STAGES), be, sb.c, sb.r, n0, N, k0, K);
      }
      hopper::cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) issue(j);
    for (int j = 0; j < n_s; ++j) {
      hopper::cp_async_wait<STAGES - 2>();  // this thread's copies of stage j have landed
      __syncthreads();                      // ... and every thread's; every warp is done with stage j - 1
      issue(j + STAGES - 1);                // into stage j - 1's slot
      compute(j % STAGES);
    }
    hopper::cp_async_wait<0>();
  } else {
    Staged<A_K> ra;
    Staged<B_K> rb;
    auto fetch = [&](int j) {
      const int k0 = (kb0 + j) * BK;
      ra.fetch(ae, sa.r, sa.c, m0, M, k0, K);
      rb.fetch(be, sb.c, sb.r, n0, N, k0, K);
    };
    auto put = [&](int j) {
      ra.put(a_tile(j % STAGES));
      rb.put(b_tile(j % STAGES));
    };
    // stages 0 and 1 in shared memory, stage 2 in registers
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < n_s) {
        fetch(j);
        put(j);
      }
    }
    if (STAGES - 1 < n_s) fetch(STAGES - 1);
    for (int j = 0; j < n_s; ++j) {
      __syncthreads();  // stage j is in shared memory; every warp is done with stage j - 1
      if (j + STAGES - 1 < n_s) {
        put(j + STAGES - 1);                           // into stage j - 1's slot
        if (j + STAGES < n_s) fetch(j + STAGES);       // its loads in flight under this stage's products
      }
      compute(j % STAGES);
    }
  }

  const int g = lane >> 2, q = lane & 3;
  T* oe = out + int64_t(e) * M * N;
  auto store = [&](int u, float4 v) {  // unit u: the m16n8 tile (u / 4, u % 4) of the warp
    const int m = m0 + wm + 16 * (u >> 2) + g, n = n0 + wn + 8 * (u & 3) + 2 * q;
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mi = m + 8 * (i >> 1), ni = n + (i & 1);
      if (mi < M && ni < N) store_as(&oe[int64_t(mi) * N + ni], vs[i]);
    }
  };
  if (parts == 1) {
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
      store(u, make_float4(acc[u >> 2][u & 3][0], acc[u >> 2][u & 3][1], acc[u >> 2][u & 3][2], acc[u >> 2][u & 3][3]));
    return;
  }
  __syncthreads();  // every warp is done with the ring: it holds the parts' sums now
  float4* mine = reinterpret_cast<float4*>(smem_raw);
#pragma unroll
  for (int u = 0; u < UNITS; ++u)
    mine[u * NT + threadIdx.x] =
        make_float4(acc[u >> 2][u & 3][0], acc[u >> 2][u & 3][1], acc[u >> 2][u & 3][2], acc[u >> 2][u & 3][3]);
  sum_parts<NT, UNITS>(mine, parts, rank, store);
}

// The fewest stages a split must take off a walk (split_of): an fp32 stage
// (96 mma.sync a warp) outweighs the split's cost, a bf16 one (16) does not
// (PERF.md: P = 1 to 8 timed at the small shapes)
template <typename T>
constexpr int min_saved() {
  return sizeof(T) == 4 ? 1 : 2;
}

template <typename T, bool A_K, bool B_K, typename Kernel>
cudaError_t plan_mma(Kernel kernel, int E, int M, int N, int K, int device, Plan* pl) {
  return plan_of(kernel, NT, smem_bytes<T, A_K, B_K>(), min_saved<T>(), BM, BN, BK, E, M, N, K, device, pl);
}

// Launch `kernel` (a __global__ wrapper of gmm_mma<T, A_K, B_K, ..>) over
// every tile, one block each or, where the plan cuts the walk, in
// clusters of its parts.  Returns 0 or a CUDA error.
template <typename T, bool A_K, bool B_K, typename Kernel>
int launch(Kernel kernel, const T* a, Strides sa, const T* b, Strides sb, T* out, int E, int M, int N, int K, int device,
           cudaStream_t stream) {
  constexpr size_t SMEM = smem_bytes<T, A_K, B_K>();
  Plan pl;
  cudaError_t err = plan_mma<T, A_K, B_K>(kernel, E, M, N, K, device, &pl);
  if (err != cudaSuccess) return int(err);
  if (pl.tiles == 0) return 0;
  if (pl.tiles * pl.split.parts > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  const unsigned blocks = unsigned(pl.tiles * pl.split.parts);
  if (pl.split.parts == 1) {
    kernel<<<blocks, NT, SMEM, stream>>>(a, sa, b, sb, out, M, N, K, pl.n_n, pl.n_m, pl.split.spp);
  } else {  // no fallback: a refused cluster launch returns its error
    err = hopper::launch_clusters(kernel, dim3(blocks), NT, pl.res.split_smem, stream, unsigned(pl.split.parts), a, sa, b,
                                  sb, out, M, N, K, pl.n_n, pl.n_m, pl.split.spp);
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaGetLastError());
}

// The launch `launch` makes by the rule, as describe_launch writes it.
template <typename T, bool A_K, bool B_K, typename Kernel>
int describe(Kernel kernel, int E, int M, int N, int K, int device, long long* out) {
  Plan pl;
  const cudaError_t err = plan_mma<T, A_K, B_K>(kernel, E, M, N, K, device, &pl);
  if (err != cudaSuccess) return int(err);
  describe_launch(pl, NT, smem_bytes<T, A_K, B_K>(), out);
  return 0;
}

// Whether every operand of a bf16 product takes 4-byte copies (pairs of
// values): each starts on 4 bytes, its depth or row axis has stride 1 and
// every other stride is even.
inline bool pairs_aligned(const void* a, Strides sa, bool a_k, const void* b, Strides sb, bool b_k) {
  auto ok = [](const void* p, Strides s, bool unit_c) {
    const int64_t unit = unit_c ? s.c : s.r, other = unit_c ? s.r : s.c;
    return reinterpret_cast<uintptr_t>(p) % 4 == 0 && unit == 1 && other % 2 == 0 && s.e % 2 == 0;
  };
  // A (M x K): its depth axis is c; B (K x N): its depth axis is r
  return ok(a, sa, a_k) && ok(b, sb, !b_k);
}

}  // namespace mma

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
// block a tile, n_n x n_m x E of them, N tiles fastest; where SPLIT, a
// cluster of parts = ceil(n_k / spp) blocks a tile, block r walking stages
// r spp .. (r + 1) spp - 1, its sums then added to the others' in part
// order (sum_parts).
template <bool A_K, bool B_K, bool SPLIT = false>
__device__ __forceinline__ void gmm_tf32x3(const CUtensorMap* amap, const CUtensorMap* bmap, float* __restrict__ out,
                                           int M, int N, int K, int n_n, int n_m, int spp = 0) {
  // aligned in the shared window itself, so the compiler keeps shared-memory
  // loads and stores (not generic ones) for every pointer derived from it
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023) & ~1023u) - raw);  // STAGES x {B tile, A tile}, raw fp32
  uint8_t* bhi = ring + STAGES * STAGE_BYTES;    // the split B tile, K-major
  uint8_t* blo = bhi + B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(blo + B_BYTES);
  uint64_t* empty = full + STAGES;

  const int n_k = (K + BK - 1) / BK;
  int tile = blockIdx.x, parts = 1, rank = 0, kb0 = 0, n_s = n_k;  // this block's stages: kb0 .. kb0 + n_s - 1
  if constexpr (SPLIT) {
    parts = (n_k + spp - 1) / spp;
    tile = int(blockIdx.x) / parts;
    rank = int(blockIdx.x) % parts;
    kb0 = rank * spp;
    n_s = min(spp, n_k - kb0);
  }
  const int n0 = (tile % n_n) * BN;
  const int m0 = ((tile / n_n) % n_m) * BM;
  const int e = tile / (n_n * n_m);
  const int t = threadIdx.x, wg = t >> 7, tw = t & 127, warp = tw >> 5, lane = t & 31;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WGS);  // each warpgroup, once it has read the stage
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  auto issue = [&](int j) {  // thread 0: the B and A tiles of the block's stage j, slice kb
    const int s = j % STAGES, kb = kb0 + j;
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
    for (int j = 0; j < STAGES - 1 && j < n_s; ++j) issue(j);
  }

  float acc[WN / 2], part[WN / 2];  // the running sum (CUDA cores); a stage's products (tensor cores)
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = part[i] = 0.f;
  uint8_t* my_hi = bhi + wg * BW_BYTES;  // this warpgroup's rows of the split B tile: its B operand
  uint8_t* my_lo = blo + wg * BW_BYTES;
  const uint32_t hi_base = hopper::smem_u32(my_hi), lo_base = hopper::smem_u32(my_lo);
  for (int j = 0; j < n_s; ++j) {
    // refill the stage of j - 1 once both warpgroups have read it
    if (t == 0 && j + STAGES - 1 < n_s) {
      if (j > 0) hopper::mbar_wait(&empty[(j - 1) % STAGES], ((j - 1) / STAGES) & 1);
      issue(j + STAGES - 1);
    }
    const int s = j % STAGES;
    const uint8_t* st = ring + s * STAGE_BYTES;
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);

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
    if constexpr (A_K) {
      // rows m and m + 8 of a_at<true>: both share m % 8, and the tile's
      // rows lie on the swizzle's 1024-byte period, so each unit's swizzle
      // is one XOR of its shared-window address.  Nothing but the XOR and
      // the row's address is kept across the loads (sixteen swizzled
      // offsets kept across stages spilled 32 bytes)
      const uint32_t row = hopper::smem_u32(st + B_BYTES) + (16 * warp + (lane >> 2)) * 128 + ((lane & 3) << 2);
      const uint32_t sw = uint32_t(lane >> 2) << 4;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t at = (row + (i & 1) * 1024 + ((2 * kk + (i >> 1)) << 4)) ^ sw;
          hopper::split_tf32(hopper::ld_shared_f32(at), ahi[kk][i], alo[kk][i]);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = 16 * warp + (lane >> 2) + 8 * (i & 1);
          const int k = 8 * kk + (lane & 3) + 4 * (i >> 1);
          hopper::split_tf32(*a_at<A_K>(st + B_BYTES, m, k), ahi[kk][i], alo[kk][i]);
        }
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
  if constexpr (SPLIT) {
    __syncthreads();  // both warpgroups are done with the ring: it holds the parts' sums now
    float4* mine = reinterpret_cast<float4*>(ring);
#pragma unroll
    for (int u = 0; u < WN / 8; ++u) mine[u * THREADS + t] = make_float4(acc[4 * u], acc[4 * u + 1], acc[4 * u + 2], acc[4 * u + 3]);
    sum_parts<THREADS, WN / 8>(mine, parts, rank, [&](int u, float4 v) {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + hopper::acc_row(tw, 4 * u + c);
        const int n = n0 + wg * WN + hopper::acc_col(tw, 4 * u + c);
        if (m < M && n < N) oe[int64_t(n) * M + m] = vs[c];
      }
    });
    return;
  }
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

// The fewest stages a split must take off a gradient's walk (split_of):
// two stages saved cost more than they save (PERF.md: P = 1 to 8 timed at
// the small shapes)
constexpr int MIN_SAVED = 3;

// A gradient's plan, from the Residency of its split kernel `split`
template <typename Kernel>
cudaError_t plan_grad(Kernel split, int E, int M, int N, int K, int device, Plan* pl) {
  return plan_of(split, THREADS, SMEM, MIN_SAVED, BM, BN, BK, E, M, N, K, device, pl);
}

// Launch a gradient: `one` (gmm_tf32x3, one block a tile: the forward's
// path, the same bits) where its plan takes one part, else `split`
// (gmm_tf32x3<.., true>) in clusters of the plan's parts.
template <typename One, typename Kernel>
int launch_grad(One one, Kernel split, const CUtensorMap& amap, const CUtensorMap& bmap, void* out, int E, int M, int N,
                int K, int device, cudaStream_t stream) {
  Plan pl;
  cudaError_t err = plan_grad(split, E, M, N, K, device, &pl);
  if (err != cudaSuccess) return int(err);
  if (pl.split.parts == 1) return launch(one, amap, bmap, out, E, M, N, K, stream);
  if (pl.tiles * pl.split.parts > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  // no fallback: a refused cluster launch returns its error
  err = hopper::launch_clusters(split, dim3(unsigned(pl.tiles * pl.split.parts)), THREADS, pl.res.split_smem, stream,
                                unsigned(pl.split.parts), amap, bmap, static_cast<float*>(out), M, N, K, pl.n_n, pl.n_m,
                                pl.split.spp);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// The launch `launch_grad` makes by the rule, as describe_launch writes it
// (the residency of the split kernel, whose shared memory and threads the
// one-block kernel shares).
template <typename Kernel>
int describe_grad(Kernel split, int E, int M, int N, int K, int device, long long* out) {
  Plan pl;
  const cudaError_t err = plan_grad(split, E, M, N, K, device, &pl);
  if (err != cudaSuccess) return int(err);
  describe_launch(pl, THREADS, SMEM, out);
  return 0;
}

}  // namespace tf32x3

}  // namespace
