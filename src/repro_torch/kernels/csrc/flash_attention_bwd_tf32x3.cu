// Backward of flash attention for Hopper (sm_90a) on the tensor cores' TF32
// products: dq, dk, dv from q, k, v, the forward's output o, its gradient do
// and the forward's per-row log-sum-exp, out in the operands' type.  Three
// routes (`bwd_route` in kernels/flash_attention.py): `tf32x3`, fp32 at head
// widths 16 to 128; `tf32x3_cluster`, fp32 at 256 (recurrentgemma-2b's);
// `tf32`, bf16 at 16 (the reduced configs').
//
// Replaces nothing on the TPU: the reference has no Pallas backward and
// trains through XLA's autodiff of its plain attention
// (src/repro/models/attention.py:36).  This computes the gradients XLA
// computes there, for the port's forward kernel (csrc/flash_attention.cu,
// the port of `flash_attention` / `_flash_kernel`,
// src/repro/kernels/flash_attention.py, pallas_call at line 119).
//
// What it computes, per (b, query head h), with S = scale Q K^T under the
// forward's mask (q_pos >= k_pos when causal, q_pos - k_pos < window when
// windowed, positions from 0 in q and k), P = exp2(S log2(e) - LSE2) (0
// where masked), LSE2 the forward's log-sum-exp in base 2:
//   D = rowsum(dO o O);  dV = P^T dO;  dP = dO V^T;  dS = P o (dP - D);
//   dQ = scale dS K;  dK = scale dS^T Q.
// Query head h reads KV head h*KV/H (GQA): dK and dV sum over the group.
// Deterministic: no atomics, every sum in a fixed order.
//
// What bounds it on this card: at the shapes the broker and the train tasks
// send (Lq 96 to 256, one to eight KV heads) latency and serial work, not
// arithmetic; at model width, operations on the tensor cores' TF32 rate.
//
// The products run on the tensor cores: fp32 as three TF32 products each,
// bf16 (exact in TF32) as one, in 32-deep stages with fresh accumulators
// (attention_tf32x3.cuh has the pieces and their reasons).  What held the
// CUDA-core backward of the first port back, and the answer here:
//  * it re-ran Q K^T in a preprocess for the LSE the fp32 forward did not
//    keep: the forward writes LSE2, and a light row pass here
//    (`attn_bwd_rowstats`, attention_bwd_rows.cuh, shared with the bf16
//    `wgmma` backward) reads O and dO once for D;
//  * three kernels in series on grids of 8 to 16 blocks at the broker's
//    shapes: here one launch holds three kinds of block, each one
//    warpgroup, that run side by side:
//      dQ blocks (64 q rows of one head; K and V streamed):
//        S = Q K^T, dP = dO V^T, dS = P o (dP - D), dQ += dS K;
//      dK blocks (64 k rows of one KV head; Q and dO of its query heads
//        streamed):  S^T = K Q^T, dP^T = V dO^T, dS^T, dK += dS^T Q;
//      dV blocks (64 k rows; Q and dO streamed): S^T = K Q^T, P^T,
//        dV += P^T dO.
//    dK and dV apart cost one more product (S^T twice) and double the
//    blocks on the KV side, each holding one head-wide accumulator; the
//    dQ and dK blocks are one code path with the roles of (Q, dO) and
//    (K, V) swapped.  A KV head's query heads may be split across `parts`
//    blocks (kernels/flash_attention.py: kv_parts), each summing into an
//    fp32 scratch that a last pass adds in a fixed order
//    (`attn_bwd_kv_sum`, attention_bwd_rows.cuh).
//  * five products on the CUDA cores, one shared-memory read per FMA: here
//    every product is a wgmma.
// Tiles: 64 own rows a block; streamed tiles of 32 rows (16 for the dQ and
// dK blocks at a block width of 128, whose four resident tiles take 128 KB).
// At hd 256 every block is a two-block cluster, each block 128 head columns
// wide (the hd 128 blocks' tiles and registers): its S and dP are the sum of
// the two halves' partial products (`PairXch`: st.async stores into the
// peer's shared memory that complete on its mbarrier), and each block writes
// its half of the gradient.  Its dQ and dK blocks keep one raw stage, not
// two, to make room for the exchange buffers (~225 KB of shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "attention_bwd_rows.cuh"
#include "attention_tf32x3.cuh"
#include "hopper.cuh"

namespace {

using namespace attn3;

constexpr int kPadRows = 128;  // the row statistics are padded to this many query rows
constexpr int kDQ = 0, kDK = 1, kDV = 2;  // the kinds of block

// one raw stage of BN streamed rows: two tiles and the (LSE2, D) of BN query rows
template <typename T, int BN, int W>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * raw_bytes<T, BN, W>() + BN * 8;
}

// T the operands' type (fp32: three TF32 products; bf16: one), HD the head
// width, SPLIT the blocks of a cluster that share a block's rows, each
// owning W = HD / SPLIT head columns
template <typename T, int HD, int SPLIT>
struct Cfg {
  static constexpr int W = HD / SPLIT;
  static constexpr bool X3 = sizeof(T) == 4;
  static constexpr int NT = X3 ? 2 : 1;              // TF32 tiles an operand: hi and lo, or hi
  static constexpr int DS_BN = W == 128 ? 16 : 32;  // streamed rows of dQ and dK blocks
  static constexpr int DV_BN = 32;                   // of dV blocks
  // raw stages: two, so a tile's load runs under the one before's split;
  // one for the dQ and dK blocks of a cluster, whose exchange buffers take
  // the second's room (the load then runs under the products alone)
  static constexpr int DS_STAGES = SPLIT > 1 ? 1 : 2;
  static constexpr int DV_STAGES = 2;
  static constexpr int RES = asis_bytes<kRows, W>();
  // the pair's exchange of a tile's partial S and dP (dQ, dK) or S (dV),
  // 64 x BN fp32 each
  static constexpr int DS_XCH = SPLIT > 1 ? pair_xch_bytes(2 * kRows * DS_BN * 4) : 0;
  static constexpr int DV_XCH = SPLIT > 1 ? pair_xch_bytes(kRows * DV_BN * 4) : 0;
  static constexpr size_t DS_SMEM = NT * (2 * size_t(RES) + 2 * size_t(asis_bytes<DS_BN, W>()) + size_t(trans_bytes<W>())) +
                                    DS_STAGES * size_t(stage_bytes<T, DS_BN, W>()) + DS_XCH;
  static constexpr size_t DV_SMEM = NT * (size_t(RES) + size_t(asis_bytes<DV_BN, W>()) + size_t(trans_bytes<W>())) +
                                    DV_STAGES * size_t(stage_bytes<T, DV_BN, W>()) + DV_XCH;
  static constexpr size_t SMEM = 1024 + (DS_SMEM > DV_SMEM ? DS_SMEM : DV_SMEM);
  static_assert(1024 + DS_SMEM <= 232448, "shared memory of a dQ or dK block");
  static_assert(1024 + DV_SMEM <= 232448, "shared memory of a dV block");
};

template <typename T>
struct Args {
  const T *q, *k, *v, *dout;
  const float2* stats;  // (LSE2, D) of every padded query row
  T *dq, *dk, *dv;
  float *dk_part, *dv_part;
  int B, H, KV, Lq, Lk, Lq_pad, parts;
  float scale, sl2;
  int causal, has_window, window;
};

// ---------------------------------------------------------------------------
// the three kinds of block
// ---------------------------------------------------------------------------

// One block of kind KIND, its index `idx` among the blocks (with SPLIT > 1:
// the clusters) of its kind.  Its own 64 rows are resident A operands: (Q,
// dO) for dQ, (K, V) for dK, K for dV.  Streamed: T0 = K (dQ) or Q (dK, dV),
// split as is and, for dQ and dK, transposed; T1 = V (dQ) or dO (dK) as is,
// dO (dV) transposed.  With SPLIT > 1 the block holds head columns
// [c0, c0 + W) of every operand and the pair adds its partial S and dP.
template <typename T, int HD, int SPLIT, int KIND>
__device__ __forceinline__ void bwd_block(uint8_t* base, const Args<T>& a, int idx) {
  using C = Cfg<T, HD, SPLIT>;
  constexpr int W = C::W;
  constexpr bool X3 = C::X3;
  constexpr bool DS = KIND != kDV;  // the block forms dS (dQ, dK) rather than P (dV)
  constexpr bool ROWS_Q = KIND == kDQ;  // its own rows are query rows
  constexpr int BN = DS ? C::DS_BN : C::DV_BN;
  constexpr int STAGES = DS ? C::DS_STAGES : C::DV_STAGES;
  constexpr int RES = C::RES, AS = asis_bytes<BN, W>(), TR = trans_bytes<W>(), RAW = raw_bytes<T, BN, W>();
  constexpr int STAGE = stage_bytes<T, BN, W>();
  constexpr int XB = kRows * BN * 4;  // one product's partial of a tile in the exchange
  // the tiles one after another: hi, then lo (X3); a lo pointer is its hi
  // where there is none, and never read
  uint8_t* r0_hi = base;
  uint8_t* r0_lo = X3 ? r0_hi + RES : r0_hi;
  uint8_t* r1_hi = r0_hi + C::NT * RES;  // dQ, dK: dO or V
  uint8_t* r1_lo = X3 ? r1_hi + RES : r1_hi;
  uint8_t* t0_hi = base + (DS ? 2 : 1) * C::NT * RES;  // T0 as is
  uint8_t* t0_lo = X3 ? t0_hi + AS : t0_hi;
  uint8_t* x_hi = t0_hi + C::NT * AS;  // the transposed tile: T0 (dQ, dK) or T1 (dV)
  uint8_t* x_lo = X3 ? x_hi + TR : x_hi;
  uint8_t* t1_hi = x_hi + C::NT * TR;  // dQ, dK: T1 as is
  uint8_t* t1_lo = X3 ? t1_hi + AS : t1_hi;
  uint8_t* ring = DS ? t1_hi + C::NT * AS : x_hi + C::NT * TR;
  uint8_t* xch = ring + STAGES * STAGE;  // SPLIT > 1: the pair's exchange

  const int t = threadIdx.x;
  const int rank = SPLIT > 1 ? int(hopper::cluster_rank()) : 0;
  const int c0h = rank * W;  // the block's first head column
  const int rep = a.H / a.KV;
  // this block's rows [r0, r0 + 64), the heads it streams and their rows
  int r0, bh0, n_heads, bkv = 0, part = 0, ct0, c_hi;
  const T *res0, *res1 = nullptr;
  if (ROWS_Q) {
    const int nqt = (a.Lq + kRows - 1) / kRows;
    const int bh = idx / nqt, b = bh / a.H, kvh = (bh % a.H) / rep;
    r0 = (nqt - 1 - idx % nqt) * kRows;  // the longest causal rows first
    bh0 = bh;
    bkv = b * a.KV + kvh;
    n_heads = 1;
    res0 = a.q + int64_t(bh) * a.Lq * HD + c0h;
    res1 = a.dout + int64_t(bh) * a.Lq * HD + c0h;
    const int lo = a.has_window ? max(0, r0 - a.window + 1) : 0;  // keys some row can see
    c_hi = a.causal ? min(a.Lk, r0 + kRows) : a.Lk;
    ct0 = (lo / BN) * BN;
  } else {
    const int nkt = (a.Lk + kRows - 1) / kRows;
    r0 = (idx % nkt) * kRows;
    bkv = (idx / nkt) % (a.B * a.KV);
    part = idx / (nkt * a.B * a.KV);
    n_heads = rep / a.parts;
    bh0 = (bkv / a.KV) * a.H + (bkv % a.KV) * rep + part * n_heads;
    res0 = a.k + int64_t(bkv) * a.Lk * HD + c0h;
    if (DS) res1 = a.v + int64_t(bkv) * a.Lk * HD + c0h;
    const int lo = a.causal ? r0 : 0;  // queries that see some key
    c_hi = a.has_window ? min(a.Lq, r0 + kRows - 1 + a.window) : a.Lq;
    ct0 = (lo / BN) * BN;
  }
  const int n_per = c_hi > ct0 ? (c_hi - ct0 + BN - 1) / BN : 0;  // streamed tiles a head
  const int n_tiles = n_heads * n_per;
  const int L_res = ROWS_Q ? a.Lq : a.Lk, L_str = ROWS_Q ? a.Lk : a.Lq;

  auto issue = [&](int j) {  // streamed tile j into stage j % STAGES
    if (j < n_tiles) {
      uint8_t* st = ring + (j % STAGES) * STAGE;
      const int c0 = ct0 + (j % n_per) * BN;
      if (ROWS_Q) {
        load_raw<T, W, BN>(st, a.k + int64_t(bkv) * a.Lk * HD + c0h, c0, L_str, HD, t);
        load_raw<T, W, BN>(st + RAW, a.v + int64_t(bkv) * a.Lk * HD + c0h, c0, L_str, HD, t);
      } else {
        const int64_t bh = bh0 + j / n_per;
        load_raw<T, W, BN>(st, a.q + bh * a.Lq * HD + c0h, c0, L_str, HD, t);
        load_raw<T, W, BN>(st + RAW, a.dout + bh * a.Lq * HD + c0h, c0, L_str, HD, t);
        // the (LSE2, D) of its query rows: padded, so always in range
        if (t < BN / 2) hopper::cp_async_16(st + 2 * RAW + 16 * t, a.stats + bh * a.Lq_pad + c0 + 2 * t, 16);
      }
    }
    hopper::cp_async_commit();
  };
  issue(0);
  load_resident<T, W, X3>(res0, r0, L_res, HD, r0_hi, r0_lo, t);
  if (DS) load_resident<T, W, X3>(res1, r0, L_res, HD, r1_hi, r1_lo, t);
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};  // dQ blocks: the statistics of this thread's two rows
  if (ROWS_Q) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = a.stats[int64_t(bh0) * a.Lq_pad + r0 + hopper::acc_row(t, 2 * r)];
      lse_r[r] = v.x;
      d_r[r] = v.y;
    }
  }
  PairXch pair;
  if constexpr (SPLIT > 1) pair.init(xch, (DS ? 2 : 1) * XB, rank, t);

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  const uint32_t a0_hi = hopper::smem_u32(r0_hi), a0_lo = hopper::smem_u32(r0_lo);
  const uint32_t a1_hi = hopper::smem_u32(r1_hi), a1_lo = hopper::smem_u32(r1_lo);
  const uint32_t b0_hi = hopper::smem_u32(t0_hi), b0_lo = hopper::smem_u32(t0_lo);
  const uint32_t b1_hi = hopper::smem_u32(t1_hi), b1_lo = hopper::smem_u32(t1_lo);
  const uint32_t bx_hi = hopper::smem_u32(x_hi), bx_lo = hopper::smem_u32(x_lo);

  for (int j = 0; j < n_tiles; ++j) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // tile j has landed, and every thread is done with tile j - 1
    if (STAGES == 2) issue(j + 1);  // into the stage tile j - 1 left
    const uint8_t* st = ring + (j % STAGES) * STAGE;
    if (DS) {
      split_raw<T, W, BN, true, true, X3>(st, t0_hi, t0_lo, x_hi, x_lo, t);
      split_raw<T, W, BN, true, false, X3>(st + RAW, t1_hi, t1_lo, nullptr, nullptr, t);
    } else {
      split_raw<T, W, BN, true, false, X3>(st, t0_hi, t0_lo, nullptr, nullptr, t);
      split_raw<T, W, BN, false, true, X3>(st + RAW, nullptr, nullptr, x_hi, x_lo, t);
    }
    // dK, dV: the statistics of this thread's columns, 8 c + 2 (t % 4) + e
    float2 cs[BN / 4];
    if (!ROWS_Q) {
#pragma unroll
      for (int c = 0; c < BN / 4; ++c)
        cs[c] = reinterpret_cast<const float2*>(st + 2 * RAW)[8 * (c >> 1) + 2 * (t & 3) + (c & 1)];
    }
    hopper::fence_proxy_async();  // the split tiles are read by wgmma
    __syncthreads();
    if (STAGES == 1) issue(j + 1);  // every thread is done with the stage

    const int c0 = ct0 + (j % n_per) * BN;
    // S (dQ) or S^T (dK, dV), then dP or dP^T; with SPLIT > 1 each half's
    // partial goes to the peer as soon as it is formed (S's stores land
    // under the dP product), and the block then waits for the peer's
    constexpr bool PIPE = SPLIT > 1;  // two stages in flight (product_s)
    float s[BN / 2], dp[BN / 2];
    if constexpr (SPLIT > 1) pair.expect(j, t);
    product_s<W, BN, X3, PIPE>(s, a0_hi, a0_lo, b0_hi, b0_lo);
    if constexpr (SPLIT > 1) pair.send(s, j, 0, t);
    if (DS) {
      product_s<W, BN, X3, PIPE>(dp, a1_hi, a1_lo, b1_hi, b1_lo);
      if constexpr (SPLIT > 1) pair.send(dp, j, XB, t);
    }
    if constexpr (SPLIT > 1) {
      pair.wait(j);
      pair.add(s, j, 0, t);
      if (DS) pair.add(dp, j, XB, t);
    }
    // rows [r0, r0 + 64) against columns [c0, c0 + BN)
    const bool need_mask =
        ROWS_Q ? (c0 + BN > a.Lk || r0 + kRows > a.Lq || (a.causal && c0 + BN - 1 > r0) ||
                  (a.has_window && r0 + kRows - 1 - c0 >= a.window))
               : (r0 + kRows > a.Lk || c0 + BN > a.Lq || (a.causal && c0 < r0 + kRows - 1) ||
                  (a.has_window && c0 + BN - 1 - r0 >= a.window));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int row = r0 + hopper::acc_row(t, i), col = c0 + hopper::acc_col(t, i);
      float lse, dd;
      if (ROWS_Q) {
        lse = lse_r[(i >> 1) & 1];
        dd = d_r[(i >> 1) & 1];
      } else {
        const float2 v = cs[2 * (i >> 2) + (i & 1)];
        lse = v.x;
        dd = v.y;
      }
      float p = exp2f(fmaf(s[i], a.sl2, -lse));
      if (need_mask) {
        const int qp = ROWS_Q ? row : col, kp = ROWS_Q ? col : row;
        p = live_pair(qp, kp, a.Lq, a.Lk, a.causal, a.has_window, a.window) ? p : 0.f;
      }
      s[i] = DS ? p * (dp[i] - dd) : p;
    }
    float part_acc[W / 2];
    product_px<W, BN, X3>(part_acc, s, bx_hi, bx_lo);  // dS K, dS^T Q or P^T dO
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] += part_acc[i];
  }
  if constexpr (SPLIT > 1) pair.finish();

  const float mul = KIND == kDV ? 1.f : a.scale;
  int L_out;
  if (ROWS_Q) {
    T* out = a.dq + int64_t(bh0) * a.Lq * HD + c0h;
    L_out = a.Lq;
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const int row = r0 + hopper::acc_row(t, i);
      if (row < L_out) store2(out + int64_t(row) * HD + hopper::acc_col(t, i), acc[i] * mul, acc[i + 1] * mul);
    }
  } else if (a.parts == 1) {
    T* out = (KIND == kDK ? a.dk : a.dv) + int64_t(bkv) * a.Lk * HD + c0h;
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const int row = r0 + hopper::acc_row(t, i);
      if (row < a.Lk) store2(out + int64_t(row) * HD + hopper::acc_col(t, i), acc[i] * mul, acc[i + 1] * mul);
    }
  } else {  // the part's fp32 sum, which attn_bwd_kv_sum adds
    float* out = (KIND == kDK ? a.dk_part : a.dv_part) + (int64_t(part) * a.B * a.KV + bkv) * a.Lk * HD + c0h;
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const int row = r0 + hopper::acc_row(t, i);
      if (row < a.Lk) store2(out + int64_t(row) * HD + hopper::acc_col(t, i), acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// blocks (clusters with SPLIT > 1) [0, n_kv) are dK blocks, then n_kv dV
// blocks, then n_dq dQ blocks: a dK or dV block walks every query head of
// its part, the longest work of the launch, so it starts first
template <typename T, int HD, int SPLIT>
__global__ void __launch_bounds__(kThreads, 1) tf32_bwd_dqkv(const Args<T> a, int n_dq, int n_kv) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int idx = blockIdx.x / SPLIT;
  if (idx < n_kv)
    bwd_block<T, HD, SPLIT, kDK>(base, a, idx);
  else if (idx < 2 * n_kv)
    bwd_block<T, HD, SPLIT, kDV>(base, a, idx - n_kv);
  else
    bwd_block<T, HD, SPLIT, kDQ>(base, a, idx - 2 * n_kv);
}

template <typename T, int HD, int SPLIT>
int launch(const Args<T>& a, const T* o, const float* lse2, float2* stats, cudaStream_t s) {
  using C = Cfg<T, HD, SPLIT>;
  const int64_t rows = int64_t(a.B) * a.H * a.Lq_pad;
  const int rows_per_block = rowstats_rows_per_block<T>(HD);
  attn_bwd_rowstats<T><<<unsigned((rows + rows_per_block - 1) / rows_per_block), 256, 0, s>>>(
      o, a.dout, lse2, stats, a.B * a.H, a.Lq, a.Lq_pad, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  auto kernel = tf32_bwd_dqkv<T, HD, SPLIT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return int(err);
  const int64_t n_dq = int64_t((a.Lq + kRows - 1) / kRows) * a.B * a.H;
  const int64_t n_kv = int64_t((a.Lk + kRows - 1) / kRows) * a.B * a.KV * a.parts;
  if (SPLIT * (n_dq + 2 * n_kv) > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  const dim3 grid(unsigned(SPLIT * (n_dq + 2 * n_kv)));
  if constexpr (SPLIT > 1) {
    err = hopper::launch_clusters(kernel, grid, kThreads, C::SMEM, s, SPLIT, a, int(n_dq), int(n_kv));
  } else {
    kernel<<<grid, kThreads, C::SMEM, s>>>(a, int(n_dq), int(n_kv));
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || a.parts == 1) return int(err);

  const int64_t n4 = int64_t(a.B) * a.KV * a.Lk * HD / 4;
  const int64_t want = (n4 + 255) / 256;
  attn_bwd_kv_sum<T><<<unsigned(want < 132 * 16 ? want : 132 * 16), 256, 0, s>>>(
      reinterpret_cast<const float4*>(a.dk_part), reinterpret_cast<const float4*>(a.dv_part), a.dk, a.dv, a.parts, n4);
  return int(cudaGetLastError());
}

// the checks and the launch both entries share; `launch_hd` picks the
// instance for the head width
template <typename T, typename F>
int run(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse2, void* dq,
        void* dk, void* dv, void* stats, void* dk_part, void* dv_part, int B, int H, int KV, int Lq, int Lk, int hd,
        int Lq_pad, int parts, int causal, int has_window, int window, int device, void* stream, F launch_hd) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (KV == 0 || H % KV || parts < 1 || (H / KV) % parts || Lq_pad < Lq || Lq_pad % kPadRows)
    return int(cudaErrorInvalidValue);
  if (Lq == 0 || Lk == 0) {  // no query or no key: every gradient is zero
    err = cudaMemsetAsync(dq, 0, size_t(B) * H * Lq * hd * sizeof(T), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dk, 0, size_t(B) * KV * Lk * hd * sizeof(T), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, size_t(B) * KV * Lk * hd * sizeof(T), s);
    return int(err);
  }
  const float scale = float(1.0 / std::sqrt(double(hd)));  // as the forward rounds it
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<const float2*>(stats), static_cast<T*>(dq),
                  static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dk_part),
                  static_cast<float*>(dv_part), B, H, KV, Lq, Lk, Lq_pad, parts, scale, scale * kLog2e,
                  causal, has_window, window};
  return launch_hd(a, static_cast<const T*>(o), static_cast<const float*>(lse2), static_cast<float2*>(stats), s);
}

}  // namespace

extern "C" {

// q, o, do, dq (B,H,Lq,hd); k, v, dk, dv (B,KV,Lk,hd): contiguous, on
// 16-byte boundaries; fp32 at hd 16, 32, 64, 128 (`tf32x3`) or 256
// (`tf32x3_cluster`: two-block clusters).  lse2: the forward's B*H*Lq fp32
// log-sum-exp in base 2.  stats: fp32 scratch of B*H*Lq_pad*2 (Lq_pad = Lq
// rounded up to 128).  parts: how many blocks share a KV head's query heads
// (divides H/KV); with parts > 1, dk_part and dv_part are fp32 scratch of
// parts*B*KV*Lk*hd each, else unused.  has_window = 0 means no window mask.
// Launches the kernels on `stream`; returns the first CUDA error (0 on
// success).
int flash_attention_bwd_tf32x3(const void* q, const void* k, const void* v, const void* o, const void* dout,
                               const void* lse2, void* dq, void* dk, void* dv, void* stats, void* dk_part,
                               void* dv_part, int B, int H, int KV, int Lq, int Lk, int hd, int Lq_pad, int parts,
                               int causal, int has_window, int window, int device, void* stream) {
  return run<float>(q, k, v, o, dout, lse2, dq, dk, dv, stats, dk_part, dv_part, B, H, KV, Lq, Lk, hd, Lq_pad, parts,
                    causal, has_window, window, device, stream,
                    [hd](const Args<float>& a, const float* of, const float* lf, float2* sf, cudaStream_t s) {
                      switch (hd) {
                        case 16: return launch<float, 16, 1>(a, of, lf, sf, s);
                        case 32: return launch<float, 32, 1>(a, of, lf, sf, s);
                        case 64: return launch<float, 64, 1>(a, of, lf, sf, s);
                        case 128: return launch<float, 128, 1>(a, of, lf, sf, s);
                        case 256: return launch<float, 256, 2>(a, of, lf, sf, s);
                        default: return int(cudaErrorInvalidValue);
                      }
                    });
}

// The same for bf16 operands at hd 16 (`tf32`: one TF32 product a
// product); dq, dk, dv in bf16.
int flash_attention_bwd_tf32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                             const void* lse2, void* dq, void* dk, void* dv, void* stats, void* dk_part, void* dv_part,
                             int B, int H, int KV, int Lq, int Lk, int hd, int Lq_pad, int parts, int causal,
                             int has_window, int window, int device, void* stream) {
  return run<__nv_bfloat16>(
      q, k, v, o, dout, lse2, dq, dk, dv, stats, dk_part, dv_part, B, H, KV, Lq, Lk, hd, Lq_pad, parts, causal,
      has_window, window, device, stream,
      [hd](const Args<__nv_bfloat16>& a, const __nv_bfloat16* of, const float* lf, float2* sf, cudaStream_t s) {
        return hd == 16 ? launch<__nv_bfloat16, 16, 1>(a, of, lf, sf, s) : int(cudaErrorInvalidValue);
      });
}

const char* flash_attention_bwd_tf32x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
