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
// bound is the tensor cores' bf16 rate.  This first kernel multiplies on the
// CUDA cores in fp32, which is exact against the plain version at the fp32
// tolerance and far from the tensor-core bound; wgmma with TMA-fed tiles is
// the later redesign.
//
// What the design does about it: the grid is (F tiles, C tiles, E); blocks
// run in any order, and the loop over D inside the block takes the place of
// the TPU's sequential D grid dimension and its VMEM accumulator.  Each block
// stages a 128x8 x tile (transposed) and an 8x128 w tile in shared memory as
// fp32 and 256 threads each keep an 8x8 block of the 128x128 output in
// registers: 16 shared-memory reads feed 64 multiply-adds.  A thread's rows
// and columns are strided by 16, so the reads of a warp hit distinct banks and
// its stores to y are coalesced.  Ragged edges (C, D or F not a multiple of
// the tile) are masked in the loads and the stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
int moe_gmm_fwd(const void* x, const void* w, void* y, int E, int C, int D, int F, int dtype,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, E, C, D, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, E, C, D, F, s);
  return int(cudaErrorInvalidValue);
}

const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
