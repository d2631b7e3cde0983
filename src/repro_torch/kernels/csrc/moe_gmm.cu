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
// bytes, about 1000 operations a byte, so it is bound by operations: the
// bound is the tensor cores' bf16 rate.
//
// Two kernels, chosen by a rule in kernels/moe_gmm.py (`route`):
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
// `simt` (fp32, and bf16 whose strides TMA cannot describe): the product
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = simt (either dtype),
// 1 = wgmma (bfloat16 only).  Returns cudaGetLastError() after the launch
// (0 on success).
int moe_gmm_fwd(const void* x, const void* w, void* y, int E, int C, int D, int F, int dtype,
                int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 && dtype == 1) return tc::launch(x, w, y, E, C, D, F, s);
  if (route != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, w, y, E, C, D, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, E, C, D, F, s);
  return int(cudaErrorInvalidValue);
}

const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
