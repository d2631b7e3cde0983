// The attention backward's preprocess for a caller without the forward's
// LSE, for Hopper (sm_90a): `flash_attention_bwd_lse` re-runs the forward's
// row max and sum (Q K^T on the CUDA cores) and writes each query row's LSE
// in base 2 and D = rowsum(dO o O).  The tensor-core backwards
// (csrc/flash_attention_bwd_wgmma.cu, bf16 at hd 32 to 256;
// csrc/flash_attention_bwd_tf32x3.cu, fp32 at hd 16 to 256 and bf16 at 16)
// read the forward's LSE where the train step passes it
// (kernels/flash_attention.py: flash_attention_bwd), and call this only
// where the caller has none.  The CUDA-core backward kernels that once lived
// here are gone: every width and dtype has a tensor-core backward.
//
// Replaces nothing on the TPU: the reference has no Pallas backward, and
// trains through XLA's autodiff of its plain attention
// (src/repro/models/attention.py:36-96).
//
// `bwd_pre`: one block per (b*h, q tile) with S = scale * Q K^T under the
// forward's mask (q_pos >= k_pos when causal, q_pos - k_pos < window when
// windowed, positions from 0 in both q and k).  LSE is kept in fp32 and in
// base 2: with sl2 = scale * log2(e), LSE2 = max(S sl2) + log2(sum exp2(S
// sl2 - max)).  Tiles that the causal and window bounds mask whole are never
// visited; the mask is applied element by element on the rest.  fp32 on the
// CUDA cores for both dtypes (bf16 operands are converted as they are
// loaded into shared memory).  256 threads as a 16 x 16 grid own the score
// tile in registers: rows ty + 16 r and columns tx + 16 c; head-wide rows
// of hd + 4 floats, 16-byte aligned and 4 banks apart, read 16 bytes at a
// time.  What bounds it: Q K^T's multiply-adds on the fp32 CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int NT = 256;  // a 16 x 16 grid of threads

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool live(int qp, int kp, int Lq, int Lk, int causal, int has_window, int window) {
  bool ok = qp < Lq && kp < Lk;
  if (causal) ok = ok && qp >= kp;
  if (has_window) ok = ok && (qp - kp) < window;
  return ok;
}

template <int HD, int BQ, int BK>
struct Cfg {
  static constexpr int P = HD + 4;  // pitch of a head-wide tile, in floats: 16-byte rows, 4 banks apart
  static constexpr int MI = BQ / 16, MJ = BK / 16, MD = HD / 16;
  static constexpr size_t PRE_SMEM = sizeof(float) * size_t(BQ + BK) * P;  // Q and K tiles
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && HD % 16 == 0, "the 16 x 16 thread grid");
};

// rows [r0, r0 + R) of a (n, HD) matrix into a padded fp32 tile, zeros past n
template <int R, int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int n) {
  for (int i = threadIdx.x; i < R * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 4) + d] = (r0 + r < n) ? ld(src + int64_t(r0 + r) * HD + d) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[r][c] = sum_d A[ty + 16 r][d] * B[tx + 16 c][d]  (both padded head-wide
// tiles), d in order, read 16 bytes at a time
template <int HD, int MA, int MB>
__device__ __forceinline__ void dot_rows(float (&acc)[MA][MB], const float* A, const float* B, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < MA; ++r)
#pragma unroll
    for (int c = 0; c < MB; ++c) acc[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[MA], b[MB];
#pragma unroll
    for (int r = 0; r < MA; ++r) a[r] = ld4(A + (ty + 16 * r) * (HD + 4) + d);
#pragma unroll
    for (int c = 0; c < MB; ++c) b[c] = ld4(B + (tx + 16 * c) * (HD + 4) + d);
#pragma unroll
    for (int r = 0; r < MA; ++r)
#pragma unroll
      for (int c = 0; c < MB; ++c) {
        acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
      }
  }
}

// the keys a q tile [q0, q0 + BQ) can see: [lo, hi)
__device__ __forceinline__ void key_range(int q0, int BQ, int Lk, int causal, int has_window, int window, int& lo, int& hi) {
  lo = has_window ? max(0, q0 - window + 1) : 0;
  hi = causal ? min(Lk, q0 + BQ) : Lk;
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(NT)
bwd_pre(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o, const T* __restrict__ dout,
        float* __restrict__ lse2, float* __restrict__ dd, int H, int KV, int Lq, int Lk, float sl2, int causal,
        int has_window, int window) {
  using C = Cfg<HD, BQ, BK>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * C::P;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h * KV / H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + int64_t(bh) * Lq * HD;
  const T* kb = k + int64_t(b * KV + kvh) * Lk * HD;
  load_tile<BQ, HD>(Qs, qb, q0, Lq);

  float dsum[C::MI], m[C::MI], l[C::MI];
#pragma unroll
  for (int r = 0; r < C::MI; ++r) {
    const int qp = q0 + ty + 16 * r;
    float acc = 0.f;
    if (qp < Lq) {
      const int64_t row = (int64_t(bh) * Lq + qp) * HD;
#pragma unroll
      for (int c = 0; c < C::MD; ++c) acc = fmaf(ld(dout + row + tx + 16 * c), ld(o + row + tx + 16 * c), acc);
    }
    dsum[r] = sum16(acc);
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  int k_lo, k_hi;
  key_range(q0, BQ, Lk, causal, has_window, window, k_lo, k_hi);
  for (int kt = (k_lo / BK) * BK; kt < k_hi; kt += BK) {
    __syncthreads();  // the previous K tile is consumed (and the Q tile written)
    load_tile<BK, HD>(Ks, kb, kt, Lk);
    __syncthreads();
    float s[C::MI][C::MJ];
    dot_rows<HD>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int r = 0; r < C::MI; ++r) {
      const int qp = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < C::MJ; ++c) {
        s[r][c] = live(qp, kt + tx + 16 * c, Lq, Lk, causal, has_window, window) ? s[r][c] * sl2 : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], max16(mx));
      float ps = 0.f;
      if (m_new != -INFINITY) {
#pragma unroll
        for (int c = 0; c < C::MJ; ++c) ps += s[r][c] == -INFINITY ? 0.f : exp2f(s[r][c] - m_new);
      }
      ps = sum16(ps);
      if (m_new != -INFINITY) {
        l[r] = (m[r] == -INFINITY ? 0.f : l[r] * exp2f(m[r] - m_new)) + ps;
        m[r] = m_new;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < C::MI; ++r) {
    const int qp = q0 + ty + 16 * r;
    if (tx == 0 && qp < Lq) {
      // a row with no live key keeps P = 0 everywhere; its LSE is never read
      lse2[int64_t(bh) * Lq + qp] = l[r] > 0.f ? m[r] + log2f(l[r]) : 0.f;
      dd[int64_t(bh) * Lq + qp] = dsum[r];
    }
  }
}

// the preprocess alone: LSE2 and D of every query row
template <typename T, int HD, int BQ, int BK>
int launch_pre(const void* q, const void* k, const void* o, const void* dout, void* lse2, void* dd, int B, int H,
               int KV, int Lq, int Lk, int causal, int has_window, int window, cudaStream_t s) {
  using C = Cfg<HD, BQ, BK>;
  const float sl2 = float(1.0 / std::sqrt(double(HD))) * kLog2e;  // as the forward rounds the scale
  auto pre = bwd_pre<T, HD, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(pre, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::PRE_SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 q_grid((Lq + BQ - 1) / BQ, B * H);
  pre<<<q_grid, NT, C::PRE_SMEM, s>>>(static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(o),
                                        static_cast<const T*>(dout), static_cast<float*>(lse2), static_cast<float*>(dd),
                                        H, KV, Lq, Lk, sl2, causal, has_window, window);
  return int(cudaGetLastError());
}

// the tiles the preprocess takes at each width
template <typename T>
int dispatch_pre(const void* q, const void* k, const void* o, const void* dout, void* lse2, void* dd, int B, int H,
                 int KV, int Lq, int Lk, int hd, int causal, int has_window, int window, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_pre<T, 16, 64, 64>(q, k, o, dout, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    case 32: return launch_pre<T, 32, 64, 64>(q, k, o, dout, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    case 64: return launch_pre<T, 64, 64, 64>(q, k, o, dout, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    case 128: return launch_pre<T, 128, 64, 64>(q, k, o, dout, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    case 256: return launch_pre<T, 256, 64, 32>(q, k, o, dout, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The preprocess alone, for a caller without the forward's LSE: lse2 and
// dd (fp32, B*H*Lq each) get every query row's LSE in base 2 (0 for a row
// with no live key) and D = rowsum(dO * O).  q, o, do (B,H,Lq,hd), k
// (B,KV,Lk,hd): contiguous, of one dtype (0 = float32, 1 = bfloat16).
int flash_attention_bwd_lse(const void* q, const void* k, const void* o, const void* dout, void* lse2, void* dd,
                            int B, int H, int KV, int Lq, int Lk, int hd, int causal, int has_window, int window,
                            int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || Lq == 0 || Lk == 0) return 0;  // nothing to read: every gradient is zero
  if (KV == 0 || H % KV || B * H > 65535) return int(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_pre<float>(q, k, o, dout, lse2, dd, B, H, KV, Lq, Lk, hd, causal, has_window, window, s);
  if (dtype == 1) return dispatch_pre<__nv_bfloat16>(q, k, o, dout, lse2, dd, B, H, KV, Lq, Lk, hd, causal, has_window, window, s);
  return int(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
