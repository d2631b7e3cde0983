// Grouped (per-expert) matrix product for Hopper (sm_90a): y[e] = x[e] @ w[e].
//
// Replaces the TPU kernel `moe_gmm` / `_gmm_kernel` in
// src/repro/kernels/moe_gmm.py (pallas_call at line 60).
//
// What it computes: x (E,C,D) and w (E,D,F), both fp32 or both bf16, give
// y (E,C,F) in x's type, summed in fp32.  Capacity is dense per expert.
//
// What bounds it on this card: at the grok-1 width the port runs
// (E 8, C 1280, D 6144, F 32768) the product does ~4e12 operations on ~4e9
// bytes (bf16), about 1000 operations a byte, so it is bound by operations:
// the tensor cores' rate for the operands' type.
//
// Three kernels, chosen by a rule in kernels/moe_gmm.py (`route`):
//
// `wgmma` (bf16 operands whose strides TMA can describe): the product runs
// on the tensor cores.
//  * one block per 128x256 tile of y.  Two consumer warpgroups own 64 rows
//    each (an m64n256k16 wgmma, 128 fp32 sums a thread); one thread of a
//    third (producer) warpgroup streams 64-deep slices of x and w with TMA into a ring of 4 stages of
//    128-byte-swizzled shared memory (48 KB a stage), and `setmaxnreg` moves
//    registers from the producer to the consumers.  Each consumer keeps one
//    wgmma group in flight and releases a stage once the group before it
//    has finished.
//  * x is K-major (D contiguous), the natural A operand.  w is N-major (F
//    contiguous): its tile is kept as four 64-column chunks and read through
//    wgmma's transpose bit.
//  * the tensor maps are 3-D, (E, rows, cols), so a tile past C, D or F is
//    clipped and zero-filled at the edge of its own expert; the epilogue
//    converts to bf16 and stores with guards.
//  * tile order: C tiles run fastest, so the blocks that share one w panel
//    (D x 256, 3 MB at grok width) run together and w is read from device
//    memory about once; walking F fastest would sweep an expert's whole w
//    (400 MB, past the 50 MB L2) once per C tile.
//
// `tf32x3` (fp32 operands whose strides TMA can describe): fp32 products on
// the tensor cores at fp32 accuracy, by the split CUTLASS calls 3xTF32.
// Each value v is split into hi = tf32(v) and lo = tf32(v - hi) (round to
// nearest, ties away: cvt.rna) and y = x_hi w_hi + x_hi w_lo + x_lo w_hi,
// three TF32 wgmmas summed in the fp32 accumulator (hopper.cuh:
// split_tf32).  TF32 runs at 495 TFLOP/s on the H100 against 67 for fp32
// on the CUDA cores (NVIDIA's data sheet, SXM at 700 W), so three products
// give ~165 TFLOP/s of fp32-accurate work at best.
//  * the trap: a TF32 wgmma reads both shared-memory operands K-major; the
//    transpose bit that lets the bf16 kernel read w N-major exists only for
//    16-bit types.  x is K-major in device memory, w is not.  So the kernel
//    computes y^T = w^T x^T: w^T is the A operand, taken from registers (the
//    RS form, which TF32 allows), and x^T the B operand, read K-major from
//    shared memory as TMA wrote it.  Each thread loads its A fragment values
//    from the raw w tile (N-major, as TMA wrote it) and splits them in
//    registers: the transpose costs nothing but the fragment's addressing,
//    and no transposed w tile is ever written.  The x tile is split
//    elementwise, in its own swizzled layout, into an x_hi and an x_lo tile,
//    which the warpgroup's wgmmas read.  (The other way round, w as a
//    K-major B tile, would write w_hi and w_lo transposed through shared
//    memory, with bank conflicts, and read them back.)
//  * one block per 64 (F) x 128 (C) tile of y^T, two warpgroups, each
//    owning 64 of the columns: an m64n64k8 wgmma, 32 fp32 sums a thread.
//    Small tiles fill the card at the shapes the broker sends (128 blocks
//    at the registry's full tier, E8 C256 D512 F512; 32 at smoke) and keep
//    two blocks on an SM at grok width (106 KB of shared memory and 256
//    threads of at most 128 registers a block), so one block's split runs
//    while the other's products do.  Each warpgroup splits only its own rows
//    of x (its B operand) and its own copy of the A fragments, so the two
//    meet only where a raw stage is refilled.
//  * a ring of 3 stages of raw tiles (32-deep: x 128 x 32, w 32 x 64, fp32,
//    128-byte swizzle) filled by TMA, issued by thread 0 two stages ahead
//    once both warpgroups have read the stage it refills (an mbarrier each).
//    Per stage a warpgroup splits its x rows into the hi/lo tiles and its A
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
//    round-to-nearest miss by 5.2e-6 at most (tests/test_torch_slice8.py).  So
//    each stage sums its products in a fresh accumulator, the eight small
//    ones first and the four large ones last, so that only those round at
//    the stage's magnitude, and the CUDA cores add the stage's sum to the
//    running one with an fp32 add that rounds to nearest.
//  * no split of D across blocks: every sum is taken in one order, the same
//    on every run.  Ragged C, D and F are clipped by TMA at the edge of each
//    expert (zero-filled), and the stores are guarded.
//  * tile order: C tiles fastest, as for `wgmma`: the blocks of one w panel
//    (D x 64) run together, and an expert's x (31 MB at grok width) stays in
//    L2 while its F tiles are swept.
//  * the epilogue stores y^T's fragments to y (E,C,F): a warp's store is 4
//    runs of 8 consecutive floats, whole 32-byte sectors.
//
// `simt` (fp32 and bf16 whose strides TMA cannot describe): the product
// runs on the CUDA cores in fp32, exact against the plain version at the
// fp32 tolerance.  The grid is (F tiles, C tiles, E); the loop over D inside
// the block takes the place of the TPU's sequential D grid dimension and its
// VMEM accumulator.  Each block stages a 128x8 x tile (transposed) and an
// 8x128 w tile in shared memory as fp32 and 256 threads each keep an 8x8
// block of the 128x128 output in registers: 16 shared-memory reads feed 64
// multiply-adds.  A thread's rows and columns are strided by 16, so the reads
// of a warp hit distinct banks and its stores to y are coalesced.  Ragged
// edges (C, D or F not a multiple of the tile) are masked in the loads and
// the stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // rows of y (C) per block
constexpr int BN = 128;  // columns of y (F) per block
constexpr int BK = 8;    // depth (D) per shared-memory stage
constexpr int TM = 8;    // rows per thread
constexpr int TN = 8;    // columns per thread
constexpr int NT = 256;  // threads per block: (BM/TM) x (BN/TN)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int C, int D,
           int F) {
  __shared__ float As[BK][BM + 4];  // x tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN + 4];  // w tile: Bs[k][n]
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* xe = x + int64_t(e) * C * D;
  const T* we = w + int64_t(e) * D * F;
  T* ye = y + int64_t(e) * C * F;
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int idx = tid + i * NT;
      const int mm = idx / BK, kk = idx % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < C && gk < D) ? to_f32(xe[int64_t(gm) * D + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / NT; ++i) {
      const int idx = tid + i * NT;
      const int kk = idx / BN, nn = idx % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < D && gn < F) ? to_f32(we[int64_t(gk) * F + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < F) store_as(&ye[int64_t(gm) * F + gn], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int E, int C, int D, int F, cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                         static_cast<T*>(y), C, D, F);
  return int(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// the wgmma route (bf16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128;     // rows of y (C) per block: two warpgroups x 64
constexpr int BN = 256;     // columns of y (F) per block
constexpr int BK = 64;      // depth (D) per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;   // x slice, K-major
constexpr int B_CHUNK = BK * 64 * 2;   // 64 columns of the w slice
constexpr int B_BYTES = BN * BK * 2;   // w slice, four column chunks
constexpr int THREADS = 384;           // 2 consumer warpgroups + the producer's
constexpr size_t SMEM = 1024 + size_t(STAGES) * (A_BYTES + B_BYTES) + 64;

__global__ void __launch_bounds__(THREADS, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
          __nv_bfloat16* __restrict__ y, int C, int D, int F, int n_m, int n_n) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = smem;                             // STAGES x slices
  uint8_t* Bs = As + STAGES * A_BYTES;            // STAGES w slices
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;

  // C tiles fastest: the blocks of one w panel are neighbours in launch order
  const int tile = blockIdx.x;
  const int m0 = (tile % n_m) * BM;
  const int n0 = ((tile / n_m) % n_n) * BN;
  const int e = tile / (n_m * n_n);
  const int n_k = (D + BK - 1) / BK;
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
      hopper::prefetch_map(&xmap);
      hopper::prefetch_map(&wmap);
      for (int kb = 0; kb < n_k; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) hopper::mbar_wait(&empty[s], ((kb / STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
        hopper::tma_load_3d(As + s * A_BYTES, &xmap, &full[s], kb * BK, m0, e);
        uint8_t* bd = Bs + s * B_BYTES;
        for (int c = 0; c < BN / 64; ++c)
          hopper::tma_load_3d(bd + c * B_CHUNK, &wmap, &full[s], n0 + 64 * c, kb * BK, e);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64)
    hopper::regs_claim<240>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t a_base = hopper::smem_u32(As) + wg * 64 * 128;
    const uint32_t b_base = hopper::smem_u32(Bs);
    for (int kb = 0; kb < n_k; ++kb) {
      const int s = kb % STAGES;
      hopper::mbar_wait(&full[s], (kb / STAGES) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K-major, step 32 bytes inside the swizzled row; B: MN-major,
        // step 16 rows of 128 bytes, chunks of 64 columns B_CHUNK apart
        const uint64_t da = hopper::make_desc<128>(a_base + s * A_BYTES + kk * 32, 16, 1024);
        const uint64_t db = hopper::make_desc<128>(b_base + s * B_BYTES + kk * 16 * 128, B_CHUNK, 1024);
        hopper::WgmmaSS<BN, 1>::run(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the group of slice kb - 1 has finished
      if (kb > 0) hopper::mbar_arrive(&empty[(kb - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    __nv_bfloat16* ye = y + int64_t(e) * C * F;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int row = m0 + 64 * wg + hopper::acc_row(t, i);
      const int col = n0 + hopper::acc_col(t, i);  // even; F is a multiple of 8
      if (row < C && col < F)
        *reinterpret_cast<__nv_bfloat162*>(ye + int64_t(row) * F + col) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

int launch(const void* x, const void* w, void* y, int E, int C, int D, int F, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int err = hopper::make_map_3d(&xmap, x, E, C, D, BM, BK, 128);
  if (!err) err = hopper::make_map_3d(&wmap, w, E, D, F, BK, 64, 128);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(gmm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (cerr != cudaSuccess) return int(cerr);
  const int n_m = (C + BM - 1) / BM, n_n = (F + BN - 1) / BN;
  const int64_t tiles = int64_t(n_m) * n_n * E;
  if (tiles > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  gmm_wgmma<<<unsigned(tiles), THREADS, SMEM, stream>>>(xmap, wmap, static_cast<__nv_bfloat16*>(y), C, D, F, n_m, n_n);
  return int(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// the tf32x3 route (fp32)
// ---------------------------------------------------------------------------

namespace tf32x3 {

constexpr int BM = 64;                  // rows of y^T (F) per block: the wgmma's m64
constexpr int BN = 128;                 // columns of y^T (C) per block
constexpr int WGS = 2;                  // warpgroups, each owning BN / WGS of the columns
constexpr int WN = BN / WGS;            // a warpgroup's columns: its wgmma's N
constexpr int BK = 32;                  // depth (D) per stage: one 128-byte swizzle row of fp32
constexpr int STAGES = 3;
constexpr int X_BYTES = BN * BK * 4;    // x tile: 128 rows (C) of 128 bytes (K-major)
constexpr int XW_BYTES = X_BYTES / WGS; // a warpgroup's rows of it
constexpr int W_CHUNK = BK * 32 * 4;    // 32 columns (F) of the w tile: 32 rows (D) of 128 bytes
constexpr int W_BYTES = BM / 32 * W_CHUNK;
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
constexpr int THREADS = 128 * WGS;
constexpr size_t SMEM = 1024 + size_t(STAGES) * STAGE_BYTES + 2 * X_BYTES + 128;
static_assert(STAGE_BYTES % 1024 == 0 && XW_BYTES % 1024 == 0, "tiles on the swizzle's 1024-byte period");

// element (f, k) of the raw w tile: chunk f / 32, row k of 128 bytes, its
// 16-byte units permuted by k % 8 (the 128-byte swizzle TMA wrote)
__device__ __forceinline__ const float* w_at(const uint8_t* tile, int f, int k) {
  const int u = ((f & 31) >> 2) ^ (k & 7);
  return reinterpret_cast<const float*>(tile + (f >> 5) * W_CHUNK + k * 128 + (u << 4) + ((f & 3) << 2));
}

__global__ void __launch_bounds__(THREADS, 2)
gmm_tf32x3(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
           float* __restrict__ y, int C, int D, int F, int n_c, int n_f) {
  // aligned in the shared window itself, so the compiler keeps shared-memory
  // loads and stores (not generic ones) for every pointer derived from it
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023) & ~1023u) - raw);  // STAGES x {x tile, w tile}, raw fp32
  uint8_t* xhi = ring + STAGES * STAGE_BYTES;    // the split x tile, same layout
  uint8_t* xlo = xhi + X_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(xlo + X_BYTES);
  uint64_t* empty = full + STAGES;

  // C tiles fastest: the blocks of one w panel are neighbours in launch order
  const int tile = blockIdx.x;
  const int c0 = (tile % n_c) * BN;
  const int f0 = ((tile / n_c) % n_f) * BM;
  const int e = tile / (n_c * n_f);
  const int n_k = (D + BK - 1) / BK;
  const int t = threadIdx.x, wg = t >> 7, tw = t & 127, warp = tw >> 5, lane = t & 31;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WGS);  // each warpgroup, once it has read the stage
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  auto issue = [&](int kb) {  // thread 0: stage kb's x and w tiles
    const int s = kb % STAGES;
    uint8_t* st = ring + s * STAGE_BYTES;
    hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
    hopper::tma_load_3d(st, &xmap, &full[s], kb * BK, c0, e);
    for (int c = 0; c < BM / 32; ++c)
      hopper::tma_load_3d(st + X_BYTES + c * W_CHUNK, &wmap, &full[s], f0 + 32 * c, kb * BK, e);
  };
  if (t == 0) {
    hopper::prefetch_map(&xmap);
    hopper::prefetch_map(&wmap);
    for (int kb = 0; kb < STAGES - 1 && kb < n_k; ++kb) issue(kb);
  }

  float acc[WN / 2], part[WN / 2];  // the running sum (CUDA cores); a stage's products (tensor cores)
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = part[i] = 0.f;
  uint8_t* my_hi = xhi + wg * XW_BYTES;  // this warpgroup's rows of the split x tile: its B operand
  uint8_t* my_lo = xlo + wg * XW_BYTES;
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

    // x: this warpgroup's rows, 16-byte units, four a thread, split in place of their offsets
#pragma unroll
    for (int i = 0; i < XW_BYTES / 16 / 128; ++i) {
      const int off = (tw + i * 128) * 16;
      const float4 v = *reinterpret_cast<const float4*>(st + wg * XW_BYTES + off);
      uint4 hi, lo;
      hopper::split_tf32(v.x, hi.x, lo.x);
      hopper::split_tf32(v.y, hi.y, lo.y);
      hopper::split_tf32(v.z, hi.z, lo.z);
      hopper::split_tf32(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(my_hi + off) = hi;
      *reinterpret_cast<uint4*>(my_lo + off) = lo;
    }
    // w^T: this thread's A fragments for the four k8 steps, split in registers
    uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = 16 * warp + (lane >> 2) + 8 * (i & 1);
        const int k = 8 * kk + (lane & 3) + 4 * (i >> 1);
        hopper::split_tf32(*w_at(st + X_BYTES, f, k), ahi[kk][i], alo[kk][i]);
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
      hopper::WgmmaTF32RS<WN>::run(part, alo[kk], dhi, kk > 0);  // w_lo x_hi
      hopper::WgmmaTF32RS<WN>::run(part, ahi[kk], dlo, 1);       // w_hi x_lo
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      hopper::WgmmaTF32RS<WN>::run(part, ahi[kk], hopper::make_desc<128>(hi_base + kk * 32, 16, 1024), 1);  // w_hi x_hi
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    hopper::named_sync(1 + wg, 128);       // every warp's products are done with the hi/lo tiles
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] += part[i];  // round to nearest, on the CUDA cores
  }

  // acc holds y^T: row f, column c
  float* ye = y + int64_t(e) * C * F;
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) {
    const int f = f0 + hopper::acc_row(tw, i);
    const int c = c0 + wg * WN + hopper::acc_col(tw, i);
    if (f < F && c < C) ye[int64_t(c) * F + f] = acc[i];
  }
}

int launch(const void* x, const void* w, void* y, int E, int C, int D, int F, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int err = hopper::make_map_3d(&xmap, x, E, C, D, BN, BK, 128, true);
  if (!err) err = hopper::make_map_3d(&wmap, w, E, D, F, BK, 32, 128, true);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(gmm_tf32x3, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (cerr != cudaSuccess) return int(cerr);
  const int n_c = (C + BN - 1) / BN, n_f = (F + BM - 1) / BM;
  const int64_t tiles = int64_t(n_c) * n_f * E;
  if (tiles > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  gmm_tf32x3<<<unsigned(tiles), THREADS, SMEM, stream>>>(xmap, wmap, static_cast<float*>(y), C, D, F, n_c, n_f);
  return int(cudaGetLastError());
}

}  // namespace tf32x3

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = simt (either dtype),
// 1 = wgmma (bfloat16 only), 2 = tf32x3 (float32 only).  Returns
// cudaGetLastError() after the launch (0 on success).
int moe_gmm_fwd(const void* x, const void* w, void* y, int E, int C, int D, int F, int dtype,
                int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 && dtype == 1) return tc::launch(x, w, y, E, C, D, F, s);
  if (route == 2 && dtype == 0) return tf32x3::launch(x, w, y, E, C, D, F, s);
  if (route != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, w, y, E, C, D, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, E, C, D, F, s);
  return int(cudaErrorInvalidValue);
}

const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
