// Forward flash attention for Hopper (sm_90a), fp32 or bf16 in, same type out.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at line 119).
//
// What it computes: for q (B,H,Lq,hd) and k, v (B,KV,Lk,hd), row-wise softmax
// of q.k^T / sqrt(hd) under optional causal and sliding-window masks, times v.
// Query head h reads KV head h*KV/H (grouped-query attention).  The online
// softmax keeps its running max, denominator and accumulator in fp32 and
// repeats the reference's masking arithmetic exactly: masked scores are -1e30
// (not -inf), p = exp(s - m) * mask, and the output is acc / max(l, 1e-37).
//
// What bounds it on this card: at the model widths the port runs (hd 128 and
// 256, L 4096) attention does ~1e11 multiply-adds on ~1e8 bytes, so it is
// bound by operations, and the bound is the tensor cores' bf16 rate.  This
// first kernel does its products on the CUDA cores in fp32 (exact against the
// plain version at the fp32 tolerance); moving them to wgmma is later work.
//
// What the design does about it:
//  * one block per (b*h, q tile); blocks run in any order, and the loop over
//    k tiles inside the block takes the place of the TPU's sequential grid
//    dimension.  The loop is bounded by the causal and window limits, so
//    fully masked k tiles are never visited (the TPU kernel skipped their math
//    but still copied them).
//  * the q, k and v tiles sit in shared memory as fp32, rows padded by one
//    float so that the 4 threads sharing a q row and the 8 rows of a warp
//    read different banks.  At hd 256 the tiles need ~100 KB, past the 48 KB
//    static limit, so shared memory is dynamic and the launch raises the
//    kernel's limit with cudaFuncSetAttribute.
//  * 4 threads own one q row: each keeps BK/4 scores and hd/4 accumulator
//    columns in registers; row max and row sum combine with two warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int HD, int BQ, int BK>
constexpr size_t smem_bytes() {
  // q tile + k tile (padded rows), v tile, p tile (padded rows)
  return sizeof(float) * (size_t(BQ) * (HD + 1) + size_t(BK) * (HD + 1) + size_t(BK) * HD +
                          size_t(BQ) * (BK + 1));
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ * 4)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int KV, int Lq, int Lk, float scale, int causal,
                 int has_window, int window) {
  constexpr int NT = BQ * 4;
  constexpr int QS = HD + 1;  // padded row stride of the q and k tiles
  constexpr int PS = BK + 1;  // padded row stride of the p tile
  constexpr int NS = BK / 4;  // scores per thread
  constexpr int NA = HD / 4;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * HD;

  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h * KV / H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;
  const int qpos = q0 + r;
  const T* qb = q + int64_t(bh) * Lq * HD;
  const T* kb = k + int64_t(b * KV + kvh) * Lk * HD;
  const T* vb = v + int64_t(b * KV + kvh) * Lk * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int row = i / HD, d = i % HD;
    Qs[row * QS + d] = (q0 + row < Lq) ? to_f32(qb[int64_t(q0 + row) * HD + d]) : 0.f;
  }

  // keys that can be live for some row of this q tile: [k_lo, k_hi)
  int k_lo = 0, k_hi = Lk;
  if (causal) k_hi = min(Lk, q0 + BQ);
  if (has_window) k_lo = max(0, q0 - window + 1);

  float m = kNeg, l = 0.f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int kt = (k_lo / BK) * BK; kt < k_hi; kt += BK) {
    __syncthreads();  // the previous tile is consumed (and the q tile is written)
    for (int i = tid; i < BK * HD; i += NT) {
      const int row = i / HD, d = i % HD;
      const bool in = kt + row < Lk;
      Ks[row * QS + d] = in ? to_f32(kb[int64_t(kt + row) * HD + d]) : 0.f;
      Vs[row * HD + d] = in ? to_f32(vb[int64_t(kt + row) * HD + d]) : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * QS + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] += qd * Ks[(sub + 4 * j) * QS + d];
    }

    float mx = kNeg;
    bool live[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int kpos = kt + sub + 4 * j;
      bool ok = kpos < Lk;
      if (causal) ok = ok && qpos >= kpos;
      if (has_window) ok = ok && (qpos - kpos) < window;
      live[j] = ok;
      s[j] = ok ? s[j] * scale : kNeg;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      // exp(s - m_new) <= 1 always, so multiplying by the mask and selecting
      // on it agree exactly
      const float p = live[j] ? expf(s[j] - m_new) : 0.f;
      Ps[r * PS + sub + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= corr;
    __syncwarp();  // the 4 threads of row r (one warp) wrote Ps row r

    for (int j = 0; j < BK; ++j) {
      const float p = Ps[r * PS + j];
      const float* vrow = Vs + j * HD + sub;
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += p * vrow[4 * i];
    }
  }

  if (qpos < Lq) {
    const float den = fmaxf(l, 1e-37f);
    T* orow = o + (int64_t(bh) * Lq + qpos) * HD + sub;
#pragma unroll
    for (int i = 0; i < NA; ++i) store_as(orow + 4 * i, acc[i] / den);
  }
}

template <typename T, int HD, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Lq,
           int Lk, int causal, int has_window, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BQ, BK>();
  auto kernel = flash_fwd_kernel<T, HD, BQ, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Lq + BQ - 1) / BQ, B * H);
  const float scale = float(1.0 / std::sqrt(double(HD)));  // as the reference rounds it
  kernel<<<grid, BQ * 4, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), H, KV, Lq,
                                         Lk, scale, causal, has_window, window);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Lq,
                int Lk, int hd, int causal, int has_window, int window, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32, 64, 32>(q, k, v, o, B, H, KV, Lq, Lk, causal, has_window, window, stream);
    case 64: return launch<T, 64, 64, 32>(q, k, v, o, B, H, KV, Lq, Lk, causal, has_window, window, stream);
    case 128: return launch<T, 128, 64, 32>(q, k, v, o, B, H, KV, Lq, Lk, causal, has_window, window, stream);
    case 256: return launch<T, 256, 32, 32>(q, k, v, o, B, H, KV, Lq, Lk, causal, has_window, window, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  has_window = 0 means no window mask.
// Returns cudaGetLastError() after the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                        int Lq, int Lk, int hd, int causal, int has_window, int window, int dtype,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(q, k, v, o, B, H, KV, Lq, Lk, hd, causal, has_window, window, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, Lq, Lk, hd, causal, has_window, window, s);
  return int(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
