// The pieces the attention kernels on the tensor cores' TF32 products share
// (the `tf32x3`, `tf32x3_cluster` and `tf32` routes): the forward in
// csrc/flash_attention.cu and the backward in
// csrc/flash_attention_bwd_tf32x3.cu.
//
// Arithmetic.  fp32 operands (`tf32x3`, `tf32x3_cluster`): every product is
// taken on the tensor cores as three TF32 products, the split CUTLASS calls
// 3xTF32 (csrc/moe_gmm.cu does the same for the GEMM): each operand value v
// is split into hi = tf32(v) and lo = tf32(v - hi) (hopper.cuh: split_tf32,
// cvt.rna), and a . b becomes a_lo b_hi + a_hi b_lo + a_hi b_hi, the small
// products first.  bf16 operands (`tf32`): a bf16 value (8 significant
// bits) is exact in TF32 (11), so its lo is 0 and one product, hi hi, is
// the whole product; P and dS, computed in fp32, go in rounded to TF32.
// The tensor cores add in fp32 without rounding to nearest, so a product's
// sum is taken in stages of at most 32 along the depth, each in a fresh
// accumulator, and the CUDA cores add each stage into the running sum
// (round to nearest).
//
// Layout.  A block is one warpgroup (128 threads) that owns 64 rows: the
// wgmma's m64.  Its own operand rows stay in shared memory for the whole
// block ("resident", A of the first products); it streams tiles of BN rows
// (BN = 16, 32 or 64) of the other side through a ring of raw stages filled by
// cp.async, so the next tile's load runs under this tile's products.  Each
// raw tile (fp32 or bf16 rows) is split into TF32 tiles that wgmma reads:
//  * as is (head-wide rows, K-major over the head): the B operand of a
//    score-like product S = A B^T;
//  * transposed (one 128-byte row a head column, K-major over 32 of the
//    streamed rows; a tile of 64 rows is two such tiles, one after the
//    other): the B operand of a product P X whose depth is the streamed
//    rows (P V, dS K, P^T dO, dS^T Q).  TF32 wgmma has no transpose
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
// Head width 256 (`tf32x3_cluster`): a block owns W = 128 of the head's
// columns, and two blocks, a cluster, own the same 64 rows.  Each keeps its
// half of the resident operands and streams its half of the other side, so
// its tiles are the hd 128 kernels'; a score-like product over the head is
// the sum of the two halves' partial products, which `PairXch` adds
// through the peer's shared memory, so both blocks hold the same S (and dP)
// and each multiplies P (or dS) into its own half of the output.
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
template <int W>
__host__ __device__ constexpr int row_floats() {
  return W < 32 ? 32 : W;
}
template <int R, int W>
__host__ __device__ constexpr int asis_bytes() {
  return R * row_floats<W>() * 4;
}
template <int W>
__host__ __device__ constexpr int trans_bytes() {
  return W * 128;
}
// one raw stage of R rows of W values of type T
template <typename T, int R, int W>
__host__ __device__ constexpr int raw_bytes() {
  return R * W * int(sizeof(T));
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

// byte offset of unit u of row r in a raw stage of U 16-byte units a row
// (units XOR-swizzled by the row so that a warp's reads down a column of
// units hit distinct banks)
template <int U>
__device__ __forceinline__ int raw_off(int r, int u) {
  constexpr int M = (U < 8 ? U : 8) - 1;
  return r * U * 16 + ((u ^ (r & M)) << 4);
}

// the float4s a 16-byte unit of T widens to: 1 for fp32, 2 for bf16
template <typename T>
constexpr int kF4 = 4 / int(sizeof(T));

// a 16-byte unit of T as floats (a bf16 value is the high half of its fp32)
__device__ __forceinline__ void widen(uint4 x, float4 (&f)[1]) {
  f[0] = make_float4(__uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z), __uint_as_float(x.w));
}
__device__ __forceinline__ void widen(uint4 x, float4 (&f)[2]) {
  f[0] = make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u), __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
  f[1] = make_float4(__uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u), __uint_as_float(x.w << 16),
                     __uint_as_float(x.w & 0xffff0000u));
}

// rows [r0, r0 + R) of an (L, ld) matrix of T, the W columns from `src` on,
// into a raw stage by cp.async, zeros past L (not read)
template <typename T, int W, int R>
__device__ __forceinline__ void load_raw(uint8_t* stage, const T* src, int r0, int L, int ld, int t) {
  constexpr int E = 16 / int(sizeof(T)), U = W / E, N = R * U;
#pragma unroll
  for (int j = 0; j < (N + kThreads - 1) / kThreads; ++j) {
    const int i = t + j * kThreads, r = i / U, u = i % U;
    if (N % kThreads == 0 || i < N) {
      const bool in = r0 + r < L;
      hopper::cp_async_16(stage + raw_off<U>(r, u), in ? src + int64_t(r0 + r) * ld + E * u : src, in ? 16 : 0);
    }
  }
}

// v as TF32 tiles: X3, hi and lo (the three-product split); else hi alone,
// for operands TF32 holds exactly (bf16)
template <bool X3>
__device__ __forceinline__ void split4(const float4 v, uint4& hi, uint4& lo) {
  if constexpr (X3) {
    hopper::split_tf32(v.x, hi.x, lo.x);
    hopper::split_tf32(v.y, hi.y, lo.y);
    hopper::split_tf32(v.z, hi.z, lo.z);
    hopper::split_tf32(v.w, hi.w, lo.w);
  } else {
    hi = make_uint4(hopper::to_tf32(v.x), hopper::to_tf32(v.y), hopper::to_tf32(v.z), hopper::to_tf32(v.w));
    lo = make_uint4(0u, 0u, 0u, 0u);  // not stored
  }
}

// A raw stage of R rows of W values of T split into TF32 tiles (hi, and lo
// with X3): as is (ASIS) and/or transposed (TRANS).  Rows run fastest
// across a warp, so its transposed stores fill one 128-byte row and its
// reads of a column of units are spread by raw_off's swizzle.
template <typename T, int W, int R, bool ASIS, bool TRANS, bool X3>
__device__ __forceinline__ void split_raw(const uint8_t* stage, uint8_t* a_hi, uint8_t* a_lo, uint8_t* t_hi,
                                          uint8_t* t_lo, int t) {
  constexpr int F4 = kF4<T>, U = W / (4 * F4), N = R * U;
#pragma unroll
  for (int j = 0; j < (N + kThreads - 1) / kThreads; ++j) {
    const int i = t + j * kThreads, r = i % R, u = i / R;
    if (N % kThreads == 0 || i < N) {
      float4 f[F4];
      widen(*reinterpret_cast<const uint4*>(stage + raw_off<U>(r, u)), f);
#pragma unroll
      for (int c = 0; c < F4; ++c) {
        const int fu = F4 * u + c;  // the float4 unit of the row
        uint4 hi, lo;
        split4<X3>(f[c], hi, lo);
        if constexpr (ASIS) {
          const int off = asis_off<R>(r, fu);
          *reinterpret_cast<uint4*>(a_hi + off) = hi;
          if constexpr (X3) *reinterpret_cast<uint4*>(a_lo + off) = lo;
        }
        if constexpr (TRANS) {
          const int p = trans_pos(r & 31), tile0 = (r >> 5) * trans_bytes<W>();  // rows 32 .. 63: the second tile
          const uint32_t h[4] = {hi.x, hi.y, hi.z, hi.w}, l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = tile0 + trans_off(4 * fu + e, p);
            *reinterpret_cast<uint32_t*>(t_hi + off) = h[e];
            if constexpr (X3) *reinterpret_cast<uint32_t*>(t_lo + off) = l[e];
          }
        }
      }
    }
  }
}

// rows [r0, r0 + 64) of an (L, ld) matrix of T, the W columns from `src`
// on, zeros past L, read from device memory and split into the block's
// resident TF32 tiles
template <typename T, int W, bool X3>
__device__ __forceinline__ void load_resident(const T* __restrict__ src, int r0, int L, int ld, uint8_t* hi_tile,
                                              uint8_t* lo_tile, int t) {
  constexpr int F4 = kF4<T>, U = W / (4 * F4), N = kRows * U;
#pragma unroll
  for (int j = 0; j < (N + kThreads - 1) / kThreads; ++j) {
    const int i = t + j * kThreads, r = i / U, u = i % U;
    if (N % kThreads == 0 || i < N) {
      const uint4 x = r0 + r < L ? __ldg(reinterpret_cast<const uint4*>(src + int64_t(r0 + r) * ld) + u)
                                 : make_uint4(0u, 0u, 0u, 0u);
      float4 f[F4];
      widen(x, f);
#pragma unroll
      for (int c = 0; c < F4; ++c) {
        uint4 hi, lo;
        split4<X3>(f[c], hi, lo);
        const int off = asis_off<kRows>(r, F4 * u + c);
        *reinterpret_cast<uint4*>(hi_tile + off) = hi;
        if constexpr (X3) *reinterpret_cast<uint4*>(lo_tile + off) = lo;
      }
    }
  }
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) { return hopper::make_desc<128>(addr, 16, 1024); }

// d (m64 x N) = A B^T over the W head columns: A the 64 resident rows, B
// the N streamed rows (as-is tiles), each as TF32 tiles.  Stages of 32 along
// the head (4 k8 steps: with X3 8 small products, then 4 large; else the 4
// large alone) each in a fresh accumulator, added into d on the CUDA cores.
// PIPE keeps two stages in flight (two accumulators): stage c + 1 is issued
// before stage c is waited on, so the tensor cores run under the add.
template <int W, int N, bool X3, bool PIPE = false>
__device__ __forceinline__ void product_s(float (&d)[N / 2], uint32_t a_hi, uint32_t a_lo, uint32_t b_hi, uint32_t b_lo) {
  constexpr int KS = W / 8;               // k8 steps across the head
  constexpr int NS = (KS + 3) / 4;        // stages
  constexpr int NB = PIPE && NS > 1 ? 2 : 1;  // accumulators in flight
  float part[NB][N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) part[b][i] = 0.f;
  auto issue = [&](int c, float (&acc)[N / 2]) {
    const int steps = KS - 4 * c < 4 ? KS - 4 * c : 4;
    hopper::wgmma_fence();
    if constexpr (X3) {
#pragma unroll
      for (int kk = 0; kk < steps; ++kk) {
        const uint32_t oa = c * kRows * 128 + kk * 32, ob = c * N * 128 + kk * 32;
        hopper::WgmmaTF32SS<N>::run(acc, desc(a_lo + oa), desc(b_hi + ob), kk > 0);
        hopper::WgmmaTF32SS<N>::run(acc, desc(a_hi + oa), desc(b_lo + ob), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < steps; ++kk) {
      const uint32_t oa = c * kRows * 128 + kk * 32, ob = c * N * 128 + kk * 32;
      hopper::WgmmaTF32SS<N>::run(acc, desc(a_hi + oa), desc(b_hi + ob), X3 || kk > 0);
    }
    hopper::wgmma_commit();
  };
  if constexpr (NB == 1) {
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      issue(c, part[0]);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part[0]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[i] += part[0][i];
    }
  } else {
    issue(0, part[0]);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      if (c + 1 < NS) {
        issue(c + 1, part[(c + 1) & 1]);
        hopper::wgmma_wait<1>();
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(part[c & 1]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[i] += part[c & 1][i];
    }
  }
}

// part (m64 x NO) = P X: P (m64 x K) the accumulator of a product_s, taken
// as register A fragments (split in registers with X3, else rounded to
// TF32); X the transposed TF32 tile(s) (NO head columns, K streamed rows,
// K <= 32: one stage, small products first, in a fresh accumulator)
template <int NO, int K, bool X3>
__device__ __forceinline__ void product_px(float (&part)[NO / 2], const float (&p)[K / 2], uint32_t x_hi, uint32_t x_lo) {
  uint32_t ahi[K / 8][4], alo[K / 8][4];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    // a[j] holds row (j % 2) * 8 and depth (j / 2) * 4 of the fragment:
    // accumulator values 0, 2 (column 2 (t % 4)) and 1, 3 (column + 1)
    const float v[4] = {p[4 * kk + 0], p[4 * kk + 2], p[4 * kk + 1], p[4 * kk + 3]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (X3)
        hopper::split_tf32(v[j], ahi[kk][j], alo[kk][j]);
      else
        ahi[kk][j] = hopper::to_tf32(v[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) part[i] = 0.f;
  hopper::wgmma_fence();
  if constexpr (X3) {
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      hopper::WgmmaTF32RS<NO>::run(part, alo[kk], desc(x_hi + kk * 32), kk > 0);
      hopper::WgmmaTF32RS<NO>::run(part, ahi[kk], desc(x_lo + kk * 32), 1);
    }
  }
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) hopper::WgmmaTF32RS<NO>::run(part, ahi[kk], desc(x_hi + kk * 32), X3 || kk > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(part);
}

// The sum of a pair's partial accumulators: each block of a two-block
// cluster holds the same fragment positions over its own half of the head,
// sends its values into the peer's shared memory and adds the peer's to its
// own.  mine + peer is the same fp32 sum in both blocks, so both hold the
// same values.  The sends are st.async stores that complete on the
// receiver's mbarrier (one a buffer), so a block waits only for the peer's
// data, not for a cluster barrier.  Two buffers alternate by tile: a block
// sends into buffer b again two tiles later, after the peer's send of the
// tile between, which the peer makes only once it has read buffer b.
struct PairXch {
  const uint8_t* buf;   // this block's two buffers of `bytes` (the peer writes them)
  uint64_t* full;       // their mbarriers: a phase completes when the peer's bytes have landed
  uint32_t peer_buf, peer_full;  // the same in the peer's shared memory
  int bytes;

  // every thread at the start: `base` holds the two buffers, then the two
  // mbarriers; the cluster barrier makes them ready before any send
  __device__ __forceinline__ void init(uint8_t* base, int bytes_, int rank, int t) {
    buf = base;
    bytes = bytes_;
    full = reinterpret_cast<uint64_t*>(base + 2 * bytes_);
    if (t == 0) {
      hopper::mbar_init(&full[0], 1);
      hopper::mbar_init(&full[1], 1);
      hopper::fence_barrier_init();
    }
    peer_buf = hopper::map_rank(hopper::smem_u32(base), uint32_t(rank ^ 1));
    peer_full = hopper::map_rank(hopper::smem_u32(full), uint32_t(rank ^ 1));
    hopper::cluster_sync();
  }
  // tile j: this block waits for `bytes` from the peer (one thread arms
  // it).  The peer's stores may land first: the phase's transaction count
  // then runs below zero until this arrival adds the bytes.
  __device__ __forceinline__ void expect(int j, int t) const {
    if (t == 0) hopper::mbar_arrive_expect_tx(&full[j & 1], bytes);
  }
  // this thread's N values of tile j into the peer's buffer, at byte `off`
  template <int N>
  __device__ __forceinline__ void send(const float (&d)[N], int j, int off, int t) const {
    static_assert(N % 4 == 0, "whole float4s");
    const uint32_t dst = peer_buf + (j & 1) * bytes + off, bar = peer_full + (j & 1) * 8;
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      hopper::st_async_v4(dst + (c * kThreads + t) * 16, make_float4(d[4 * c], d[4 * c + 1], d[4 * c + 2], d[4 * c + 3]),
                          bar);
  }
  __device__ __forceinline__ void wait(int j) const { hopper::mbar_wait_cluster(&full[j & 1], (j >> 1) & 1); }
  // after wait(j): the peer's N values of tile j, at byte `off`, added to d
  template <int N>
  __device__ __forceinline__ void add(float (&d)[N], int j, int off, int t) const {
    const uint8_t* src = buf + (j & 1) * bytes + off;
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(src + (c * kThreads + t) * 16);
      d[4 * c] += x.x;
      d[4 * c + 1] += x.y;
      d[4 * c + 2] += x.z;
      d[4 * c + 3] += x.w;
    }
  }
  // every thread at the end: no block leaves while a send into it may be in flight
  __device__ __forceinline__ void finish() const { hopper::cluster_sync(); }
};

// the exchange's shared memory: two buffers of `bytes` and their mbarriers
__host__ __device__ constexpr int pair_xch_bytes(int bytes) { return 2 * bytes + 16; }

// a row's two adjacent outputs as T
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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
