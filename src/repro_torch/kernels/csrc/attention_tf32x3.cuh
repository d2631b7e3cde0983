// The pieces the fp32 attention kernels on the tensor cores (the `tf32x3`
// route) share: the forward in csrc/flash_attention.cu and the backward in
// csrc/flash_attention_bwd_tf32x3.cu.
//
// Arithmetic.  Every product is taken on the tensor cores as three TF32
// products, the split CUTLASS calls 3xTF32 (csrc/moe_gmm.cu does the same
// for the GEMM): each operand value v is split into hi = tf32(v) and
// lo = tf32(v - hi) (hopper.cuh: split_tf32, cvt.rna), and a . b becomes
// a_lo b_hi + a_hi b_lo + a_hi b_hi, the small products first.  The tensor
// cores add in fp32 without rounding to nearest, so a product's sum is taken
// in stages of at most 32 along the depth, each in a fresh accumulator, and
// the CUDA cores add each stage into the running sum (round to nearest).
//
// Layout.  A block is one warpgroup (128 threads) that owns 64 rows: the
// wgmma's m64.  Its own operand rows stay in shared memory for the whole
// block ("resident", A of the first products); it streams tiles of BN rows
// (BN = 16 or 32) of the other side through a ring of 2 raw stages filled by
// cp.async, so the next tile's load runs under this tile's products.  Each
// raw tile is split into hi/lo tiles that wgmma reads:
//  * as is (head-wide rows, K-major over the head): the B operand of a
//    score-like product S = A B^T;
//  * transposed (one 128-byte row a head column, K-major over the BN
//    streamed rows): the B operand of a product P X whose depth is the
//    streamed rows (P V, dS K, P^T dO, dS^T Q).  TF32 wgmma has no transpose
//    bit, so a B operand must be K-major in shared memory; writing the tile
//    transposed in the split pass, which touches every value anyway, costs
//    scalar stores instead of a second pass.  (The other way, O^T = V^T P^T
//    with V^T as register A operand, needs M = hd >= 64 and P^T through
//    shared memory.)
// P and dS come from the score accumulator as register A operands.  An
// m64nNk8 accumulator holds columns 2 (t % 4) and 2 (t % 4) + 1 of each 8,
// where the A fragment wants depths (t % 4) and (t % 4) + 4; rather than
// shuffle values inside the quad, the fragments take the accumulator's
// values as they lie and the transposed tile stores its rows in the same
// order (trans_pos): a sum over the depth does not care in which order its
// terms sit, as long as both operands agree.
//
// Every tile starts on a 1024-byte boundary and uses the 128-byte swizzle
// (16-byte unit u of row r stored at unit u ^ (r % 8)), written by the
// threads, never by TMA.  Head width 16 keeps 128-byte rows of which the
// products read the first 64 bytes.
#pragma once

#include "hopper.cuh"

namespace attn3 {

constexpr int kThreads = 128;  // one warpgroup a block
constexpr int kRows = 64;      // the block's own rows: the wgmma's m64
constexpr float kLog2e = 1.4426950408889634f;

// floats a head-wide tile row takes: whole 128-byte chunks of 32
template <int HD>
__host__ __device__ constexpr int row_floats() {
  return HD < 32 ? 32 : HD;
}
template <int R, int HD>
__host__ __device__ constexpr int asis_bytes() {
  return R * row_floats<HD>() * 4;
}
template <int HD>
__host__ __device__ constexpr int trans_bytes() {
  return HD * 128;
}
template <int R, int HD>
__host__ __device__ constexpr int raw_bytes() {
  return R * HD * 4;
}

// byte offset of 16-byte unit u (columns 4u..4u+3) of row r in a head-wide
// tile of R rows, kept as chunks of 32 columns one after another
template <int R>
__device__ __forceinline__ int asis_off(int r, int u) {
  return (u >> 3) * R * 128 + r * 128 + (((u & 7) ^ (r & 7)) << 4);
}

// byte offset of (head column d, depth position p < 32) in a transposed tile
__device__ __forceinline__ int trans_off(int d, int p) {
  return d * 128 + ((((p >> 2) ^ d) & 7) << 4) + ((p & 3) << 2);
}

// the depth position of streamed row r in a transposed tile: within each 8,
// position l holds row 2 (l % 4) + l / 4, the column the accumulator
// fragment gives A fragment depth l (see the header)
__device__ __forceinline__ int trans_pos(int r) { return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2); }

// byte offset of unit u of row r in a raw stage (rows of HD floats, units
// XOR-swizzled by the row so that a warp's reads down a column of units hit
// distinct banks)
template <int HD>
__device__ __forceinline__ int raw_off(int r, int u) {
  constexpr int U = HD / 4, M = (U < 8 ? U : 8) - 1;
  return r * HD * 4 + ((u ^ (r & M)) << 4);
}

// rows [r0, r0 + R) of an (L, HD) fp32 matrix into a raw stage by cp.async,
// zeros past L (not read)
template <int HD, int R>
__device__ __forceinline__ void load_raw(uint8_t* stage, const float* src, int r0, int L, int t) {
  constexpr int U = HD / 4;
  static_assert(R * U % kThreads == 0, "whole turns of the block");
#pragma unroll
  for (int j = 0; j < R * U / kThreads; ++j) {
    const int i = t + j * kThreads, r = i / U, u = i % U;
    const bool in = r0 + r < L;
    hopper::cp_async_16(stage + raw_off<HD>(r, u), in ? src + int64_t(r0 + r) * HD + 4 * u : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ void split4(const float4 v, uint4& hi, uint4& lo) {
  hopper::split_tf32(v.x, hi.x, lo.x);
  hopper::split_tf32(v.y, hi.y, lo.y);
  hopper::split_tf32(v.z, hi.z, lo.z);
  hopper::split_tf32(v.w, hi.w, lo.w);
}

// A raw stage of R rows split into hi/lo tiles: as is (ASIS) and/or
// transposed (TRANS).  Rows run fastest across a warp, so its transposed
// stores fill one 128-byte row and its reads of a column of units are
// spread by raw_off's swizzle.
template <int HD, int R, bool ASIS, bool TRANS>
__device__ __forceinline__ void split_raw(const uint8_t* stage, uint8_t* a_hi, uint8_t* a_lo, uint8_t* t_hi,
                                          uint8_t* t_lo, int t) {
  constexpr int U = HD / 4;
  static_assert(R * U % kThreads == 0, "whole turns of the block");
#pragma unroll
  for (int j = 0; j < R * U / kThreads; ++j) {
    const int i = t + j * kThreads, r = i % R, u = i / R;
    uint4 hi, lo;
    split4(*reinterpret_cast<const float4*>(stage + raw_off<HD>(r, u)), hi, lo);
    if constexpr (ASIS) {
      const int off = asis_off<R>(r, u);
      *reinterpret_cast<uint4*>(a_hi + off) = hi;
      *reinterpret_cast<uint4*>(a_lo + off) = lo;
    }
    if constexpr (TRANS) {
      const int p = trans_pos(r);
      const uint32_t h[4] = {hi.x, hi.y, hi.z, hi.w}, l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = trans_off(4 * u + e, p);
        *reinterpret_cast<uint32_t*>(t_hi + off) = h[e];
        *reinterpret_cast<uint32_t*>(t_lo + off) = l[e];
      }
    }
  }
}

// rows [r0, r0 + 64) of an (L, HD) fp32 matrix, zeros past L, read from
// device memory and split into the block's resident hi/lo tiles
template <int HD>
__device__ __forceinline__ void load_resident(const float* __restrict__ src, int r0, int L, uint8_t* hi_tile,
                                              uint8_t* lo_tile, int t) {
  constexpr int U = HD / 4;
#pragma unroll
  for (int j = 0; j < kRows * U / kThreads; ++j) {
    const int i = t + j * kThreads, r = i / U, u = i % U;
    const float4 v = r0 + r < L ? __ldg(reinterpret_cast<const float4*>(src + int64_t(r0 + r) * HD) + u)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 hi, lo;
    split4(v, hi, lo);
    const int off = asis_off<kRows>(r, u);
    *reinterpret_cast<uint4*>(hi_tile + off) = hi;
    *reinterpret_cast<uint4*>(lo_tile + off) = lo;
  }
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) { return hopper::make_desc<128>(addr, 16, 1024); }

// d (m64 x N) = A B^T over the head: A the 64 resident rows, B the N
// streamed rows (as-is tiles), each as hi/lo tiles.  Stages of 32 along the
// head (4 k8 steps: 8 small products, then 4 large) each in a fresh
// accumulator, added into d on the CUDA cores.
template <int HD, int N>
__device__ __forceinline__ void product_s(float (&d)[N / 2], uint32_t a_hi, uint32_t a_lo, uint32_t b_hi, uint32_t b_lo) {
  constexpr int KS = HD / 8;  // k8 steps across the head
  float part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = part[i] = 0.f;
#pragma unroll
  for (int c = 0; c < (KS + 3) / 4; ++c) {
    const int steps = KS - 4 * c < 4 ? KS - 4 * c : 4;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < steps; ++kk) {
      const uint32_t oa = c * kRows * 128 + kk * 32, ob = c * N * 128 + kk * 32;
      hopper::WgmmaTF32SS<N>::run(part, desc(a_lo + oa), desc(b_hi + ob), kk > 0);
      hopper::WgmmaTF32SS<N>::run(part, desc(a_hi + oa), desc(b_lo + ob), 1);
    }
#pragma unroll
    for (int kk = 0; kk < steps; ++kk) {
      const uint32_t oa = c * kRows * 128 + kk * 32, ob = c * N * 128 + kk * 32;
      hopper::WgmmaTF32SS<N>::run(part, desc(a_hi + oa), desc(b_hi + ob), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] += part[i];
  }
}

// part (m64 x NO) = P X: P (m64 x K) the accumulator of a product_s, taken
// as register A fragments (split in registers); X the transposed hi/lo tile
// (NO head columns, K streamed rows, K <= 32: one stage, small products
// first, in a fresh accumulator)
template <int NO, int K>
__device__ __forceinline__ void product_px(float (&part)[NO / 2], const float (&p)[K / 2], uint32_t x_hi, uint32_t x_lo) {
  uint32_t ahi[K / 8][4], alo[K / 8][4];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    // a[j] holds row (j % 2) * 8 and depth (j / 2) * 4 of the fragment:
    // accumulator values 0, 2 (column 2 (t % 4)) and 1, 3 (column + 1)
    hopper::split_tf32(p[4 * kk + 0], ahi[kk][0], alo[kk][0]);
    hopper::split_tf32(p[4 * kk + 2], ahi[kk][1], alo[kk][1]);
    hopper::split_tf32(p[4 * kk + 1], ahi[kk][2], alo[kk][2]);
    hopper::split_tf32(p[4 * kk + 3], ahi[kk][3], alo[kk][3]);
  }
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) part[i] = 0.f;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    hopper::WgmmaTF32RS<NO>::run(part, alo[kk], desc(x_hi + kk * 32), kk > 0);
    hopper::WgmmaTF32RS<NO>::run(part, ahi[kk], desc(x_lo + kk * 32), 1);
  }
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) hopper::WgmmaTF32RS<NO>::run(part, ahi[kk], desc(x_hi + kk * 32), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(part);
}

__device__ __forceinline__ bool live_pair(int qp, int kp, int Lq, int Lk, int causal, int has_window, int window) {
  bool ok = qp < Lq && kp < Lk;
  if (causal) ok = ok && qp >= kp;
  if (has_window) ok = ok && qp - kp < window;
  return ok;
}

// the base of a kernel's shared memory, on a 1024-byte boundary of the
// shared window (the launch asks for 1024 bytes more than the tiles take)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = hopper::smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

}  // namespace attn3
