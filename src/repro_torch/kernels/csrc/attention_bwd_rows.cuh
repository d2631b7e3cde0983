// The two light passes that the tensor-core attention backwards share
// (csrc/flash_attention_bwd_wgmma.cu, bf16; csrc/flash_attention_bwd_tf32x3.cu,
// fp32), templated on the element type T of o, dO, dK and dV:
//  * `attn_bwd_rowstats`: one 16-byte chunk of O and dO a lane (8 bf16 or 4
//    fp32 values), a row per 16 hd / sizeof(T) lanes (at most 32: fp32 at
//    hd 256 takes two chunks a lane); writes (LSE2, D) pairs,
//    D = rowsum(dO o O), into a scratch of B*H*Lq_pad rows (Lq_pad = Lq
//    rounded up to 128).  A padded row and a row with no live key (the
//    forward's LSE2 = -inf) get LSE2 = +inf, so their P is 0.
//  * `attn_bwd_kv_sum`: the parts' fp32 dK and dV (parts x n4 float4s each)
//    added in the parts' order and stored as T.
// Each including source gets its own copy (anonymous namespace).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

// the dot product of one 16-byte chunk of a and one of b, as floats
__device__ __forceinline__ float chunk_dot(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  float acc = 0.f;
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  acc = fmaf(x.w, y.w, acc);
  return acc;
}

__device__ __forceinline__ float chunk_dot(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* px = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* py = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fx = __bfloat1622float2(px[e]), fy = __bfloat1622float2(py[e]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

__device__ __forceinline__ void store4(float* dst, float4 v) { *reinterpret_cast<float4*>(dst) = v; }

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(hopper::pack_bf16(v.x, v.y), hopper::pack_bf16(v.z, v.w));
}

// lanes of attn_bwd_rowstats a row takes at head width hd: one a 16-byte
// chunk, at most a warp (fp32 at 256: two chunks a lane)
template <typename T>
__host__ __device__ constexpr int rowstats_lanes(int hd) {
  return hd * int(sizeof(T)) / 16 < 32 ? hd * int(sizeof(T)) / 16 : 32;
}

// rows a 256-thread block of attn_bwd_rowstats covers at head width hd
template <typename T>
__host__ __device__ constexpr int rowstats_rows_per_block(int hd) {
  return 8 * (32 / rowstats_lanes<T>(hd));
}

template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_rowstats(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse2,
                  float2* __restrict__ stats, int BH, int Lq, int Lq_pad, int hd) {
  constexpr int E = 16 / sizeof(T);    // values a chunk
  const int G = rowstats_lanes<T>(hd);  // lanes a row
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t(blockIdx.x) * 8 + threadIdx.x / 32) * (32 / G) + lane / G;
  const bool in = row < int64_t(BH) * Lq_pad;
  const int bh = in ? int(row / Lq_pad) : 0, qp = in ? int(row % Lq_pad) : 0;
  const bool live = in && qp < Lq;
  float acc = 0.f;
  if (live) {
    const int64_t off = (int64_t(bh) * Lq + qp) * hd + E * (lane % G);
    for (int c = 0; c < hd / (E * G); ++c) acc += chunk_dot(o + off + c * E * G, dout + off + c * E * G);
  }
  for (int s = G / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (in && lane % G == 0) {
    float l = live ? lse2[int64_t(bh) * Lq + qp] : INFINITY;
    if (l == -INFINITY) l = INFINITY;
    stats[row] = make_float2(l, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_kv_sum(const float4* __restrict__ dk_part, const float4* __restrict__ dv_part, T* __restrict__ dk,
                T* __restrict__ dv, int parts, int64_t n4) {
  for (int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x; i < n4; i += int64_t(gridDim.x) * 256) {
    float4 x = dk_part[i], y = dv_part[i];
    for (int p = 1; p < parts; ++p) {
      const float4 u = dk_part[p * n4 + i], w = dv_part[p * n4 + i];
      x.x += u.x, x.y += u.y, x.z += u.z, x.w += u.w;
      y.x += w.x, y.y += w.y, y.z += w.z, y.w += w.w;
    }
    store4(dk + 4 * i, x);
    store4(dv + 4 * i, y);
  }
}

}  // namespace
