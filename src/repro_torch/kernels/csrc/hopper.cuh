// Hopper (sm_90a) building blocks shared by the hand-written kernels: TMA
// tensor maps built on the host, mbarrier waits, TMA tile loads and stores
// (bulk groups, L2 cache policies), bf16 and TF32 wgmma with fp32
// accumulators (the tensor-core kernels) and their warp-level mma.sync
// forms (the GEMM's route for strides TMA cannot describe); cp.async rows of
// any alignment into shared memory and release/acquire flags between blocks
// (the scans); clusters of blocks that add into each other's shared memory
// (the fp32 attention at head width 256) or read it (the selective scan's
// backward).  Everything is PTX written by
// hand; nothing here calls a library kernel.
//
// Shared-memory tiles use the swizzled layouts that TMA writes and wgmma
// reads.  A tile of R rows whose rows are SW bytes long (SW = 64 or 128) is
// stored as R rows of SW bytes, the 16-byte units of each row permuted by
// the row's index mod 8 (CU_TENSOR_MAP_SWIZZLE_64B / _128B).  A matrix wider
// than SW bytes is kept as several such column chunks, one after another.
// Every tile starts on a 1024-byte boundary, the period of the 128-byte
// swizzle, so a descriptor may step inside a row by adding bytes to its
// start address.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reach it through the
// runtime's entry-point query, so the library links against cudart alone.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D map over a contiguous bf16 (or, with `fp32`, float32) array
// (outer, rows, cols), cols innermost, read in boxes of (1, box_rows,
// box_cols) into shared memory swizzled by `swizzle_bytes` (64 or 128, the
// bytes of one box row).  The outer axis is the batch-like one (expert, or
// batch x head), so a box that runs past `rows` is clipped at the edge of
// its own expert or head and zero-filled there, instead of reading the next
// one's rows.  Returns 0 or a CUDA error.
inline int make_map_3d(CUtensorMap* map, const void* base, uint64_t outer, uint64_t rows,
                       uint64_t cols, uint32_t box_rows, uint32_t box_cols, int swizzle_bytes,
                       bool fp32 = false) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorSymbolNotFound);
  const uint64_t item = fp32 ? 4 : 2;
  const cuuint64_t dims[3] = {cols, rows, outer};
  const cuuint64_t strides[2] = {cols * item, rows * cols * item};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw =
      swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapDataType type = fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult res = encode(map, type, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an fp32 word at shared-window address `addr`; volatile, so it stays
// after the barrier waits before it, as a generic load would
__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call from the initialising thread, then __syncthreads
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive once and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase with parity `parity` has completed.  A wait that
// never ends (a barrier that is never completed) traps after ~2^30 polls,
// seconds at the least, so a fault ends the launch with an error instead of
// hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D map into shared memory; completion is counted on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses on 16-byte
// boundaries) into shared memory; completion is counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One box of shared memory (laid out as tma_load_3d would have written it,
// swizzle included) into a 3-D map at element (c0, c1, c2), innermost
// first: the reverse of tma_load_3d.  Elements of the box past the map's
// edges are not written, so a box that runs past `rows` is clipped at the
// edge of its own expert.  The store is asynchronous and joins this
// thread's open bulk group (bulk_commit_group closes it); write the box
// with generic stores, then fence_proxy_async, then a barrier, before one
// thread issues the store.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// An L2 cache policy for the accesses it is handed to: evict_first marks
// lines to leave the cache before others (a stream written once),
// evict_last to stay (operands read again)
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// tma_store_3d under an L2 cache policy
__device__ __forceinline__ void tma_store_3d_hint(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                                  uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

// tma_load_3d under an L2 cache policy
__device__ __forceinline__ void tma_load_3d_hint(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                                 int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

// Close this thread's bulk stores issued since the last commit into a group.
__device__ __forceinline__ void bulk_commit_group() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed bulk groups are still
// reading their shared-memory source.  Their writes to device memory may
// still be in flight: enough to reuse the source, which is all a block
// needs before it writes the source again or exits (the writes are
// complete and visible when the kernel is).
template <int N>
__device__ __forceinline__ void bulk_wait_group_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------------------
// device: cp.async rows into shared memory; flags between blocks
// ---------------------------------------------------------------------------

// one 16-byte cp.async; the bytes of the chunk past `src_bytes` (0 to 16)
// are zero-filled and not read
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// one 4-byte cp.async, zero-filled where `src_bytes` is 0
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// close this thread's cp.asyncs issued since the last commit into a group
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// arrive on `bar` once every cp.async this thread has issued so far has
// landed; the barrier's expected count includes this arrival
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// The bytes before an element's global address within its 16-byte chunk.
// Rows of any width and element alignment are copied by whole 16-byte
// chunks: element i of a row whose first element lies `head` bytes into
// its chunk lands at head + i * size in the row's shared copy.
__device__ __forceinline__ int chunk_head(const void* p) {
  return int(reinterpret_cast<uintptr_t>(p) & 15);
}

// Copy `rows` rows of `row_bytes` bytes each, `stride` bytes apart in
// global memory starting at `src`, into shared rows of PITCH bytes (a
// multiple of 16, at least row_bytes + 16) starting at `dst`, with the NT
// threads of the block (this one is `tid`).  A chunk may begin up to 15
// bytes before a row (on the 16-byte boundary below it, inside the same
// operand when the operand starts on a 16-byte boundary) and never reads
// past the row's end.
template <int PITCH, int NT>
__device__ __forceinline__ void copy_rows_async(char* dst, const char* src, int64_t stride, int rows,
                                                int row_bytes, int tid) {
  static_assert(PITCH % 16 == 0, "shared rows on 16-byte boundaries");
  constexpr int CPR = PITCH / 16;  // chunks a row
  // chunk i = r * CPR + k of the tile goes to thread i % NT; walk r and k
  // by NT chunks a turn without dividing
  int r = tid / CPR, k = tid % CPR;
  const char* row = src + r * stride;
  while (r < rows) {
    const int head = chunk_head(row);
    const int left = head + row_bytes - 16 * k;  // bytes of the row from this chunk on
    if (left > 0) cp_async_16(dst + r * PITCH + 16 * k, row - head + 16 * k, left < 16 ? left : 16);
    k += NT % CPR;
    int step = NT / CPR;
    if (k >= CPR) {
      k -= CPR;
      ++step;
    }
    r += step;
    row += step * stride;
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// wait until *flag is non-zero and return it.  Like mbar_wait, a flag that
// is never set traps (after ~2^24 polls of at least 64 ns: a second or more)
// instead of hanging the device.
__device__ __forceinline__ int wait_flag(const int* flag) {
  int v, polls = 0;
  while ((v = ld_acquire(flag)) == 0) {
    if (++polls == (1 << 24)) __trap();
    __nanosleep(64);
  }
  return v;
}

// Named barriers between warpgroups (id 0 is __syncthreads'): `sync` waits
// until `n` threads have reached the barrier, `arrive` counts this thread
// and goes on.  Shared-memory writes before an arrive are visible to the
// threads that return from the matching sync.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// thread block clusters: rank, barrier, loads from and async stores into a peer's shared memory
// ---------------------------------------------------------------------------

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits for all:
// shared-memory writes before the arrive (mbarrier initialisations among
// them) are visible to every thread of the cluster after the wait.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared-window address `addr` of this block mapped to the same offset
// in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes from a cluster block's shared memory (an address from map_rank);
// written by that block before a cluster_sync that this thread has passed
__device__ __forceinline__ float4 ld_cluster_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// 16 bytes into a cluster block's shared memory, asynchronously: the store
// completes as 16 transaction bytes on that block's mbarrier `remote_bar`
// (both addresses from map_rank)
__device__ __forceinline__ void st_async_v4(uint32_t addr, float4 v, uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
               : "memory");
}

// mbar_wait at cluster scope: the phase's writes by the cluster's other
// blocks (st_async_v4) are visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Launch `kernel` on `grid` in clusters of `n` blocks along x (gridDim.x a
// multiple of n), with `smem` bytes of dynamic shared memory a block.
template <typename... Exp, typename... Act>
inline cudaError_t launch_clusters(void (*kernel)(Exp...), dim3 grid, unsigned threads, size_t smem, cudaStream_t s,
                                   unsigned n, Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
}

// ---------------------------------------------------------------------------
// device: warpgroup register budget
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled tile (SW = 64 or 128 bytes).
//  K-major operand (K contiguous, rows of SW bytes): lbo unused, sbo = the
//    stride between groups of 8 rows (8 * SW).
//  MN-major operand (MN contiguous, used with the transpose bit): lbo = the
//    stride between column chunks of SW bytes along MN, sbo = the stride
//    between groups of 8 rows along K (8 * SW).
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(SW == 64 || SW == 128, "swizzle of 64 or 128 bytes");
  constexpr uint64_t layout = SW == 128 ? 1 : 2;
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands written by threads, not by TMA);
// call after the writes and before the barrier the wgmma's issuers wait on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma: call after wgmma_wait and before issuing.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64nNk16 with fp32 sums (d has N/2 registers):
// thread t of the warpgroup holds d[i] at
//   row = 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2)
//   col = 8 * (i / 4) + 2 * (t % 4) + i % 2
__device__ __forceinline__ int acc_row(int t, int i) { return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int t, int i) { return 8 * (i >> 2) + 2 * (t & 3) + (i & 1); }

#define HOPPER_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                     "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_D16 HOPPER_D8(0), HOPPER_D8(8)
#define HOPPER_D32 HOPPER_D16, HOPPER_D8(16), HOPPER_D8(24)
#define HOPPER_D64 HOPPER_D32, HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
#define HOPPER_D128 HOPPER_D64, HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88), \
                    HOPPER_D8(96), HOPPER_D8(104), HOPPER_D8(112), HOPPER_D8(120)

#define HOPPER_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HOPPER_R16 HOPPER_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_R32 HOPPER_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_R64                                                                                 \
  HOPPER_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
             "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_R128                                                                                \
  HOPPER_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
             "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "   \
             "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
             "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "     \
             "%123, %124, %125, %126, %127"

// d (m64 x N, fp32) (+)= A (m64 x k16, bf16, shared; K-major when TA = 0,
// MN-major when TA = 1) * B (k16 x N, bf16, shared; K-major when TB = 0,
// MN-major when TB = 1).  scale_d = 0 overwrites d, 1 adds to it.
template <int N, int TB, int TA = 0>
struct WgmmaSS;
// d (+)= A (m64 x k16 bf16 in registers: the fragment a[4]) * B (shared).
template <int N, int TB>
struct WgmmaRS;

#define HOPPER_SS(N, REGS, DLIST, IA, IB, IS, IT, ITA)                                                 \
  template <int TB, int TA>                                                                            \
  struct WgmmaSS<N, TB, TA> {                                                                          \
    __device__ __forceinline__ static void run(float (&d)[N / 2], uint64_t da, uint64_t db,            \
                                               int scale_d) {                                          \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                                    \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, %" IA ", %" IB \
                   ", p, 1, 1, %" ITA ", %" IT ";\n}\n"                                                \
                   : DLIST                                                                             \
                   : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));                                \
    }                                                                                                  \
  };
HOPPER_SS(16, HOPPER_R8, HOPPER_D8(0), "8", "9", "10", "11", "12")
HOPPER_SS(32, HOPPER_R16, HOPPER_D16, "16", "17", "18", "19", "20")
HOPPER_SS(64, HOPPER_R32, HOPPER_D32, "32", "33", "34", "35", "36")
HOPPER_SS(128, HOPPER_R64, HOPPER_D64, "64", "65", "66", "67", "68")
HOPPER_SS(256, HOPPER_R128, HOPPER_D128, "128", "129", "130", "131", "132")
#undef HOPPER_SS

#define HOPPER_RS(N, REGS, DLIST, A0, A1, A2, A3, IB, IS, IT)                                     \
  template <int TB>                                                                               \
  struct WgmmaRS<N, TB> {                                                                         \
    __device__ __forceinline__ static void run(float (&d)[N / 2], const uint32_t (&a)[4],         \
                                               uint64_t db, int scale_d) {                        \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                               \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, {%" A0   \
                   ", %" A1 ", %" A2 ", %" A3 "}, %" IB ", p, 1, 1, %" IT ";\n}\n"                \
                   : DLIST                                                                        \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB)); \
    }                                                                                             \
  };
HOPPER_RS(32, HOPPER_R16, HOPPER_D16, "16", "17", "18", "19", "20", "21", "22")
HOPPER_RS(64, HOPPER_R32, HOPPER_D32, "32", "33", "34", "35", "36", "37", "38")
HOPPER_RS(128, HOPPER_R64, HOPPER_D64, "64", "65", "66", "67", "68", "69", "70")
HOPPER_RS(256, HOPPER_R128, HOPPER_D128, "128", "129", "130", "131", "132", "133", "134")
#undef HOPPER_RS

// TF32: d (m64 x N, fp32) (+)= A (m64 x k8, tf32 in registers: a[4], one
// value each, the fragment of mma.sync's m16n8k8 per warp: a[i] holds row
// 16 (t / 32) + (t % 32) / 4 + 8 (i % 2), depth (t % 4) + 4 (i / 2)) * B
// (k8 x N, tf32, shared, K-major: TF32 has no transpose bit).  A tf32
// operand is an fp32 word whose 13 low mantissa bits the tensor cores do
// not read.  k8 is 32 bytes of depth, as k16 is for bf16.
template <int N>
struct WgmmaTF32RS;

#define HOPPER_TF32_RS(N, REGS, DLIST, A0, A1, A2, A3, IB, IS)                                    \
  template <>                                                                                     \
  struct WgmmaTF32RS<N> {                                                                         \
    __device__ __forceinline__ static void run(float (&d)[N / 2], const uint32_t (&a)[4],         \
                                               uint64_t db, int scale_d) {                        \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                               \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, {%" A0    \
                   ", %" A1 ", %" A2 ", %" A3 "}, %" IB ", p, 1, 1;\n}\n"                          \
                   : DLIST                                                                        \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));          \
    }                                                                                             \
  };
HOPPER_TF32_RS(16, HOPPER_R8, HOPPER_D8(0), "8", "9", "10", "11", "12", "13")
HOPPER_TF32_RS(32, HOPPER_R16, HOPPER_D16, "16", "17", "18", "19", "20", "21")
HOPPER_TF32_RS(64, HOPPER_R32, HOPPER_D32, "32", "33", "34", "35", "36", "37")
HOPPER_TF32_RS(128, HOPPER_R64, HOPPER_D64, "64", "65", "66", "67", "68", "69")
#undef HOPPER_TF32_RS

// TF32 with both operands in shared memory: d (m64 x N) (+)= A (m64 x k8,
// K-major) * B (k8 x N, K-major)
template <int N>
struct WgmmaTF32SS;

#define HOPPER_TF32_SS(N, REGS, DLIST, IA, IB, IS)                                                  \
  template <>                                                                                     \
  struct WgmmaTF32SS<N> {                                                                         \
    __device__ __forceinline__ static void run(float (&d)[N / 2], uint64_t da, uint64_t db,       \
                                               int scale_d) {                                     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                               \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, %" IA     \
                   ", %" IB ", p, 1, 1;\n}\n"                                                     \
                   : DLIST                                                                        \
                   : "l"(da), "l"(db), "r"(scale_d));                                             \
    }                                                                                             \
  };
HOPPER_TF32_SS(16, HOPPER_R8, HOPPER_D8(0), "8", "9", "10")
HOPPER_TF32_SS(32, HOPPER_R16, HOPPER_D16, "16", "17", "18")
#undef HOPPER_TF32_SS

#undef HOPPER_D8
#undef HOPPER_D16
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_D128
#undef HOPPER_R8
#undef HOPPER_R16
#undef HOPPER_R32
#undef HOPPER_R64
#undef HOPPER_R128

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as an fp32 word whose 13 low bits are zero
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The 3xTF32 split of v: hi = tf32(v), lo = tf32(v - hi).  v - hi is exact
// in fp32 and at most 2^-11 of v, so hi + lo is v within 2^-22 of it, and
// hi hi' + hi lo' + lo hi' misses v v' by the dropped lo lo' term and lo's
// rounding, about 2^-21 of it: fp32 accuracy from TF32 products.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// two fp32 values as one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// device: warp-level mma.sync (operands in registers, any shared layout)
// ---------------------------------------------------------------------------

// Fragments, with g = lane / 4 and q = lane % 4: d (16 x 8, fp32) holds
// d[i] at row g + 8 (i / 2), column 2 q + i % 2.
// TF32 m16n8k8: a[i] at row g + 8 (i % 2), depth q + 4 (i / 2); b[i] at
// depth q + 4 i, column g.  d += a b.
__device__ __forceinline__ void mma_tf32_m16n8k8(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 m16n8k16, each register two values adjacent in depth (the lower
// depth in the low half): a[i] at row g + 8 (i % 2), depths 2 q + 8 (i / 2)
// and one more; b[i] at depths 2 q + 8 i and one more, column g.  d += a b.
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace hopper
