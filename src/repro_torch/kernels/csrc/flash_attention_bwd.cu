// Backward of flash attention for Hopper (sm_90a): dq, dk, dv from q, k, v,
// the forward's output o and its gradient do, fp32 or bf16 in, same type out.
//
// Replaces nothing on the TPU: the reference has no Pallas backward, and
// trains through XLA's autodiff of its plain attention
// (src/repro/models/attention.py:36-96).  This is the backward of the
// port's forward kernel (csrc/flash_attention.cu, which replaces
// `flash_attention` / `_flash_kernel`, src/repro/kernels/flash_attention.py,
// pallas_call at line 119), and computes the gradients XLA's autodiff
// computes there.
//
// What it computes, per (b, query head h), with S = scale * Q K^T under the
// forward's mask (q_pos >= k_pos when causal, q_pos - k_pos < window when
// windowed, positions from 0 in both q and k), P = exp(S - LSE) and 0 where
// masked (FlashAttention-2's formulation; deterministic, no atomics):
//   D_i = sum_d dO_id O_id;  dV = P^T dO;  dP = dO V^T;  dS = P * (dP - D);
//   dQ = scale dS K;  dK = scale dS^T Q.
// Query head h reads KV head h*KV/H (GQA), so dK and dV sum over the H/KV
// query heads of a group.
//
// Three kernels, launched in order on the caller's stream:
//  * `bwd_pre`: one block per (b*h, q tile) re-runs the row max and sum of
//    the forward (which keeps no LSE) and writes LSE and D to a scratch the
//    wrapper allocates.  LSE is kept in fp32 and in base 2: with
//    sl2 = scale * log2(e), LSE2 = max(S sl2) + log2(sum exp2(S sl2 - max)),
//    and every kernel forms P = exp2(S sl2 - LSE2) from the same fp32 dot
//    products, summed in the same order, so the three agree on P.
//  * `bwd_dkdv`: one block per (b, KV head, k tile).  Its K and V tiles stay
//    in shared memory; it loops over the query heads of its group and over
//    the q tiles that can see the k tile, so the group's sum for dK and dV
//    happens in registers.
//  * `bwd_dq`: one block per (b*h, q tile), its Q and dO tiles resident,
//    looping over the k tiles the q tile can see.
// Tiles that the causal and window bounds mask whole are never visited; the
// mask is applied element by element on the rest.
//
// Arithmetic: fp32 on the CUDA cores for both dtypes.  bf16 operands are
// converted as they are loaded into shared memory; dq, dk and dv are written
// in the operands' dtype.  256 threads as a 16 x 16 grid own the outputs of
// each product in register tiles: rows ty + 16 r of a score tile and columns
// tx + 16 c, and for the head-wide products (dV, dK, dQ) columns
// 4 tx + 64 c + j, four consecutive ones, from hd 64 up.
//
// What bounds it on this card: 2.5x the forward's multiply-adds (the
// preprocess re-runs Q K^T once more, so the kernels do 3x), on the
// CUDA cores' fp32 rate; at the model widths it is bound by operations.
// Every product reads both operands from shared memory, so what limits it
// is shared memory's 128 bytes a clock per SM, not the FMA units: with one
// 4-byte load per operand a scalar kernel moves one wavefront per FMA
// instruction or so (its first version ran 10 TFLOP/s at recurrentgemma-2b's
// width, PERF.md).  So the head-wide tiles are laid out with rows of
// hd + 4 floats, 16-byte aligned and 4 banks apart, and every read along the
// head is a 16-byte load: a score tile's rows are read 4 steps of d at a
// time, and dV, dK and dQ read 4 consecutive columns a thread, which cuts
// the wavefronts per FMA about 2.5x.  The tensor cores (`wgmma`) and a
// forward that writes LSE are later work (ROADMAP).
//
// Head widths 16, 32, 64, 128 and 256 (the forward's `simt` widths); tiles
// of 64 x 64 rows up to hd 128 and 64 x 32 (q x k) at hd 256, so shared
// memory fits (169 KB at hd 128, 217 KB at hd 256; one block an SM).
// Lq != Lk, ragged lengths and any window are taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int NT = 256;  // a 16 x 16 grid of threads

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
  static constexpr int P = HD + 4;   // pitch of a head-wide tile, in floats: 16-byte rows, 4 banks apart
  static constexpr int SP = BK + 1;  // pitch of a score tile
  static constexpr int MI = BQ / 16, MJ = BK / 16, MD = HD / 16;
  static constexpr size_t PRE_SMEM = sizeof(float) * size_t(BQ + BK) * P;
  // Q, dO, K, V tiles; P and dS tiles; LSE2 and D of the q tile
  static constexpr size_t MAIN_SMEM = sizeof(float) * (size_t(2 * BQ + 2 * BK) * P + size_t(2 * BQ) * SP + 2 * BQ);
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

// The head columns a thread owns in the head-wide products: 4 consecutive
// ones a group (4 tx + 64 g + j) from hd 64 up, so they are read 16 bytes
// at a time; one a group (tx + 16 g) below, where 16 threads x 4 columns
// would not fit the head.
template <int HD>
struct HeadCols {
  static constexpr int VEC = HD >= 64 ? 4 : 1;
  static constexpr int NG = HD / 16 / VEC;  // groups a thread owns
  __device__ static __forceinline__ int col(int tx, int k) {
    return VEC == 4 ? 4 * tx + 64 * (k / 4) + k % 4 : tx + 16 * k;
  }
  // row[col(tx, k)] for every k, from a shared row
  __device__ static __forceinline__ void read(float (&x)[HD / 16], const float* row, int tx) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if constexpr (VEC == 4) {
        const float4 v = ld4(row + 4 * tx + 64 * g);
        x[4 * g] = v.x, x[4 * g + 1] = v.y, x[4 * g + 2] = v.z, x[4 * g + 3] = v.w;
      } else {
        x[g] = row[tx + 16 * g];
      }
    }
  }
};

// acc[r][k] += sum_i S[i][ty + 16 r] * X[i][col(k)]   (S^T X; S of pitch sp, X a padded head-wide tile)
template <int N, int HD, int MA>
__device__ __forceinline__ void acc_tn(float (&acc)[MA][HD / 16], const float* S, int sp, const float* X, int ty, int tx) {
#pragma unroll 4
  for (int i = 0; i < N; ++i) {
    float s[MA], x[HD / 16];
#pragma unroll
    for (int r = 0; r < MA; ++r) s[r] = S[i * sp + ty + 16 * r];
    HeadCols<HD>::read(x, X + i * (HD + 4), tx);
#pragma unroll
    for (int r = 0; r < MA; ++r)
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) acc[r][k] = fmaf(s[r], x[k], acc[r][k]);
  }
}

// acc[r][k] += sum_j S[ty + 16 r][j] * X[j][col(k)]   (S X)
template <int N, int HD, int MA>
__device__ __forceinline__ void acc_nn(float (&acc)[MA][HD / 16], const float* S, int sp, const float* X, int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < N; ++j) {
    float s[MA], x[HD / 16];
#pragma unroll
    for (int r = 0; r < MA; ++r) s[r] = S[(ty + 16 * r) * sp + j];
    HeadCols<HD>::read(x, X + j * (HD + 4), tx);
#pragma unroll
    for (int r = 0; r < MA; ++r)
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) acc[r][k] = fmaf(s[r], x[k], acc[r][k]);
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

// P and dS of one (q tile, k tile) pair from the resident tiles: P into Ps
// (when non-null) and dS into dSs, both [BQ][BK] at pitch SP
template <int HD, int BQ, int BK>
__device__ __forceinline__ void p_and_ds(const float* Qs, const float* dOs, const float* Ks, const float* Vs,
                                         const float* lse_s, const float* d_s, float* Ps, float* dSs, int q0, int k0,
                                         int Lq, int Lk, float sl2, int causal, int has_window, int window, int ty,
                                         int tx) {
  using C = Cfg<HD, BQ, BK>;
  float p[C::MI][C::MJ], dp[C::MI][C::MJ];
  dot_rows<HD>(p, Qs, Ks, ty, tx);
#pragma unroll
  for (int r = 0; r < C::MI; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < C::MJ; ++c) {
      const int j = tx + 16 * c;
      p[r][c] = live(q0 + i, k0 + j, Lq, Lk, causal, has_window, window) ? exp2f(p[r][c] * sl2 - lse_s[i]) : 0.f;
      if (Ps) Ps[i * C::SP + j] = p[r][c];
    }
  }
  dot_rows<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int r = 0; r < C::MI; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < C::MJ; ++c) dSs[i * C::SP + tx + 16 * c] = p[r][c] * (dp[r][c] - d_s[i]);
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(NT, 1)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse2, const float* __restrict__ dd, T* __restrict__ dk, T* __restrict__ dv, int H,
         int KV, int Lq, int Lk, float scale, float sl2, int causal, int has_window, int window) {
  using C = Cfg<HD, BQ, BK>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * C::P;
  float* Ks = dOs + BQ * C::P;
  float* Vs = Ks + BK * C::P;
  float* Ps = Vs + BK * C::P;
  float* dSs = Ps + BQ * C::SP;
  float* lse_s = dSs + BQ * C::SP;
  float* d_s = lse_s + BQ;
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV, rep = H / KV;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<BK, HD>(Ks, k + int64_t(bkv) * Lk * HD, k0, Lk);
  load_tile<BK, HD>(Vs, v + int64_t(bkv) * Lk * HD, k0, Lk);

  float adk[C::MJ][C::MD], adv[C::MJ][C::MD];
#pragma unroll
  for (int r = 0; r < C::MJ; ++r)
#pragma unroll
    for (int c = 0; c < C::MD; ++c) adk[r][c] = adv[r][c] = 0.f;

  // the queries that can see some key of [k0, k0 + BK): [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = has_window ? min(Lq, k0 + BK - 1 + window) : Lq;
  for (int g = 0; g < rep; ++g) {
    const int bh = b * H + kvh * rep + g;
    const T* qb = q + int64_t(bh) * Lq * HD;
    const T* db = dout + int64_t(bh) * Lq * HD;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // the previous tiles are consumed
      load_tile<BQ, HD>(Qs, qb, q0, Lq);
      load_tile<BQ, HD>(dOs, db, q0, Lq);
      for (int i = tid; i < BQ; i += NT) {
        const bool in = q0 + i < Lq;
        lse_s[i] = in ? lse2[int64_t(bh) * Lq + q0 + i] : 0.f;
        d_s[i] = in ? dd[int64_t(bh) * Lq + q0 + i] : 0.f;
      }
      __syncthreads();
      p_and_ds<HD, BQ, BK>(Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, q0, k0, Lq, Lk, sl2, causal, has_window, window, ty, tx);
      __syncthreads();
      acc_tn<BQ, HD>(adv, Ps, C::SP, dOs, ty, tx);
      acc_tn<BQ, HD>(adk, dSs, C::SP, Qs, ty, tx);
    }
  }
#pragma unroll
  for (int r = 0; r < C::MJ; ++r) {
    const int kp = k0 + ty + 16 * r;
    if (kp >= Lk) continue;
    const int64_t row = (int64_t(bkv) * Lk + kp) * HD;
#pragma unroll
    for (int c = 0; c < C::MD; ++c) {
      const int d = HeadCols<HD>::col(tx, c);
      st(dk + row + d, adk[r][c] * scale);
      st(dv + row + d, adv[r][c]);
    }
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(NT, 1)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse2, const float* __restrict__ dd, T* __restrict__ dq, int H, int KV, int Lq, int Lk,
       float scale, float sl2, int causal, int has_window, int window) {
  using C = Cfg<HD, BQ, BK>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * C::P;
  float* Ks = dOs + BQ * C::P;
  float* Vs = Ks + BK * C::P;
  float* dSs = Vs + BK * C::P + BQ * C::SP;  // the P tile's room is left unused here
  float* lse_s = dSs + BQ * C::SP;
  float* d_s = lse_s + BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h * KV / H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<BQ, HD>(Qs, q + int64_t(bh) * Lq * HD, q0, Lq);
  load_tile<BQ, HD>(dOs, dout + int64_t(bh) * Lq * HD, q0, Lq);
  for (int i = tid; i < BQ; i += NT) {
    const bool in = q0 + i < Lq;
    lse_s[i] = in ? lse2[int64_t(bh) * Lq + q0 + i] : 0.f;
    d_s[i] = in ? dd[int64_t(bh) * Lq + q0 + i] : 0.f;
  }
  const T* kb = k + int64_t(b * KV + kvh) * Lk * HD;
  const T* vb = v + int64_t(b * KV + kvh) * Lk * HD;

  float adq[C::MI][C::MD];
#pragma unroll
  for (int r = 0; r < C::MI; ++r)
#pragma unroll
    for (int c = 0; c < C::MD; ++c) adq[r][c] = 0.f;

  int k_lo, k_hi;
  key_range(q0, BQ, Lk, causal, has_window, window, k_lo, k_hi);
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous K and dS tiles are consumed (and the q-side tiles written)
    load_tile<BK, HD>(Ks, kb, k0, Lk);
    load_tile<BK, HD>(Vs, vb, k0, Lk);
    __syncthreads();
    p_and_ds<HD, BQ, BK>(Qs, dOs, Ks, Vs, lse_s, d_s, nullptr, dSs, q0, k0, Lq, Lk, sl2, causal, has_window, window, ty, tx);
    __syncthreads();
    acc_nn<BK, HD>(adq, dSs, C::SP, Ks, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < C::MI; ++r) {
    const int qp = q0 + ty + 16 * r;
    if (qp >= Lq) continue;
    const int64_t row = (int64_t(bh) * Lq + qp) * HD;
#pragma unroll
    for (int c = 0; c < C::MD; ++c) st(dq + row + HeadCols<HD>::col(tx, c), adq[r][c] * scale);
  }
}

template <typename T, int HD, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq, void* dk, void* dv,
           void* lse2, void* dd, int B, int H, int KV, int Lq, int Lk, int causal, int has_window, int window,
           cudaStream_t s) {
  using C = Cfg<HD, BQ, BK>;
  const float scale = float(1.0 / std::sqrt(double(HD)));  // as the forward rounds it
  const float sl2 = scale * kLog2e;
  auto pre = bwd_pre<T, HD, BQ, BK>;
  auto dkdv = bwd_dkdv<T, HD, BQ, BK>;
  auto dqk = bwd_dq<T, HD, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(pre, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::PRE_SMEM));
  if (err == cudaSuccess) err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::MAIN_SMEM));
  if (err == cudaSuccess) err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::MAIN_SMEM));
  if (err != cudaSuccess) return int(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  float* lse = static_cast<float*>(lse2);
  float* dsum = static_cast<float*>(dd);
  const dim3 q_grid((Lq + BQ - 1) / BQ, B * H);
  pre<<<q_grid, NT, C::PRE_SMEM, s>>>(qt, kt, static_cast<const T*>(o), dot, lse, dsum, H, KV, Lq, Lk, sl2, causal,
                                        has_window, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 k_grid((Lk + BK - 1) / BK, B * KV);
  dkdv<<<k_grid, NT, C::MAIN_SMEM, s>>>(qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), H, KV,
                                          Lq, Lk, scale, sl2, causal, has_window, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dqk<<<q_grid, NT, C::MAIN_SMEM, s>>>(qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), H, KV, Lq, Lk, scale, sl2,
                                         causal, has_window, window);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq, void* dk,
             void* dv, void* lse2, void* dd, int B, int H, int KV, int Lq, int Lk, int hd, int causal, int has_window,
             int window, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16, 64, 64>(q, k, v, o, dout, dq, dk, dv, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    case 32: return launch<T, 32, 64, 64>(q, k, v, o, dout, dq, dk, dv, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    case 64: return launch<T, 64, 64, 64>(q, k, v, o, dout, dq, dk, dv, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    case 128: return launch<T, 128, 64, 64>(q, k, v, o, dout, dq, dk, dv, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    case 256: return launch<T, 256, 64, 32>(q, k, v, o, dout, dq, dk, dv, lse2, dd, B, H, KV, Lq, Lk, causal, has_window, window, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, o, do, dq (B,H,Lq,hd); k, v, dk, dv (B,KV,Lk,hd); all contiguous, of one
// dtype (0 = float32, 1 = bfloat16).  lse2 and dd: fp32 scratch of B*H*Lq
// each.  has_window = 0 means no window mask.  Launches the three kernels on
// `stream`; returns the first CUDA error (0 on success).
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                        void* dk, void* dv, void* lse2, void* dd, int B, int H, int KV, int Lq, int Lk, int hd,
                        int causal, int has_window, int window, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (KV == 0 || H % KV || B * H > 65535 || B * KV > 65535) return int(cudaErrorInvalidValue);
  if (Lq == 0 || Lk == 0) {  // no query or no key: every gradient is zero
    const size_t elem = dtype ? 2 : 4;
    err = cudaMemsetAsync(dq, 0, size_t(B) * H * Lq * hd * elem, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dk, 0, size_t(B) * KV * Lk * hd * elem, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, size_t(B) * KV * Lk * hd * elem, s);
    return int(err);
  }
  if (dtype == 0) return dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse2, dd, B, H, KV, Lq, Lk, hd, causal, has_window, window, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse2, dd, B, H, KV, Lq, Lk, hd, causal, has_window, window, s);
  return int(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
