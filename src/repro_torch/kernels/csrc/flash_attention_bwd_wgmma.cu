// Backward of flash attention for Hopper (sm_90a), the `wgmma` route: dq, dk,
// dv from bf16 q, k, v, the forward's output o, its gradient do and the
// forward's per-row log-sum-exp; bf16 out.
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
//
// What bounds it on this card: operations.  The least work is 2.5x the
// forward's multiply-adds over the live (q, k) pairs (dV, dP, dQ, dK against
// the forward's S and PV, with S recomputed once), on the tensor cores'
// bf16 rate, 989 TFLOP/s; at the model widths that is ~0.16 ms against
// ~0.01 ms of bytes.  Without atomics dQ needs S and dP once more, so the
// kernels below do 3.5x the forward's products.
//
// What bounded the first port's CUDA-core backward (since retired), and
// the answer here:
//  * its five products ran in fp32 on the CUDA cores, where shared memory's
//    wavefronts held each FMA to ~15 TFLOP/s: here every product is a bf16
//    wgmma with fp32 sums, its operands brought into 128-byte-swizzled
//    shared memory by TMA (64-byte at hd 32) and P, dS fed from registers;
//  * its preprocess re-ran Q K^T for the LSE the forward did not keep: the
//    forward now stores LSE2 (`flash_fwd_wgmma`'s `lse`), and the row pass
//    here reads O and dO once for D;
//  * one dK/dV block walked all the query heads of a KV head in series, 64
//    blocks at recurrentgemma-2b (B1, KV1): here a group's heads split into
//    `parts` blocks by a rule in the wrapper (kernels/flash_attention.py:
//    kv_parts) that fills the card, each part summing into an fp32 scratch
//    that a last pass adds and rounds.  Still deterministic, no atomics.
//
// Four kernels on the caller's stream:
//  * `attn_bwd_rowstats` (attention_bwd_rows.cuh, shared with the fp32
//    `tf32x3` backward): (LSE2, D) pairs into a scratch of B*H*Lq_pad rows
//    (Lq_pad = Lq rounded up to 128; padded rows get LSE2 = +inf, so their
//    P is 0), which TMA can copy a tile at a time.
//  * `attn_bwd_kv_wgmma`: one block per (64-row k tile, b*KV, part).  K and
//    V stay resident; one producer thread streams the Q and dO tiles (and
//    their (LSE2, D) rows) of every query head of the part through a 3-stage
//    TMA ring.  It works in the transposed form, so that P^T and dS^T sit in
//    the accumulator layout an A operand in registers takes.  Two consumer
//    warpgroups split the gradients:
//      warpgroup 0: S^T = K Q^T (SS); P^T = exp2(S^T sl2 - LSE2[col]), masked;
//                   hands P^T (fp32) to warpgroup 1 through shared memory;
//                   dV += P^T dO (RS, dO read MN-major);
//      warpgroup 1: dP^T = V dO^T (SS); dS^T = P^T o (dP^T - D[col]);
//                   dK += dS^T Q (RS, Q read MN-major).
//    Each keeps one hd-wide accumulator (dV or dK: hd/2 registers a thread)
//    and does two products a tile, so the two are balanced.  The hand-off
//    is double-buffered behind named barriers.
//  * `attn_bwd_kv_sum` (attention_bwd_rows.cuh): with parts > 1, adds the
//    parts' fp32 dK and dV and rounds to bf16 (parts = 1 writes bf16
//    directly).
//  * `attn_bwd_q_wgmma`: one block per (128-row q tile, b*h), longest causal
//    tiles first, as the forward; Q and dO resident, K and V streamed
//    through a 3-stage TMA ring.  Each consumer warpgroup owns 64 q rows:
//    S = Q K^T and dP = dO V^T (SS), dS in registers, dQ += dS K (RS, K read
//    MN-major).
// Whole tiles that the causal and window bounds mask are never loaded; a
// tile is masked element by element only where it straddles a bound or a
// ragged edge.  P and dS enter their products as bf16 (FlashAttention-2 and
// 3 do the same); the sums are fp32.
//
// Tiles: dK/dV blocks of 64 k rows with q tiles of 64 (32 at hd 256); dQ
// blocks of 128 q rows with k tiles of 64 (16 at hd 256).  Registers:
// ptxas holds every thread of a 384-thread block to 168, whatever
// `setmaxnreg` grants the consumers later, so an hd-wide accumulator (hd/2
// registers) leaves 40 for the rest at hd 256; the smaller hd 256 tiles
// keep the score tiles at 16 and 8 registers.  The producer gets 40 (at 24
// its loop spilled at hd 128).  Per block, from `nvcc -Xptxas -v` and
// `flash_attention_bwd_wgmma_smem` (printed by chip_smoke.py's set-up):
//   hd   kv kernel: regs, spill st/ld bytes, smem   q kernel: regs, spill st/ld bytes, smem
//   32   168, 0 / 0, 68152                          168, 0 / 0, 42064
//   64   168, 0 / 0, 100920                         168, 0 / 0, 83024
//   128  168, 0 / 0, 166456                         168, 0 / 0, 164944
//   256  168, 128 / 188, 182072                     168, 32 / 60, 181328
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "attention_bwd_rows.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;  // two consumer warpgroups and the producer's
constexpr int kStages = 3;  // TMA ring depth of both kernels
// registers a thread of the producer and of the consumer warpgroups
// (setmaxnreg): at 24 the producer's loop spilled at hd 128; 40 * 128 +
// 232 * 256 fits the SM's 65536
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kPadRows = 128;  // the row statistics are padded to this many query rows
// named barriers of the P^T hand-off (0 is __syncthreads'): full and empty, one per buffer
constexpr int kXFull = 1, kXEmpty = 3;

template <int HD>
struct BwdCfg {
  static constexpr int SW = HD >= 64 ? 128 : 64;  // swizzle: bytes per tile row
  static constexpr int CH = SW / 2;               // columns per chunk of SW bytes
  static constexpr int NCH = HD / CH;             // chunks across the head
  static constexpr int KPC = SW / 32;             // k16 steps per chunk
  // dK/dV kernel
  static constexpr int KV_BK = 64;                 // k rows a block
  static constexpr int KV_BQ = HD == 256 ? 32 : 64;  // q rows a streamed tile
  static constexpr int KV_TILE = KV_BK * HD * 2;   // the K or the V tile
  static constexpr int KV_QTILE = KV_BQ * HD * 2;  // one Q or dO tile
  static constexpr int KV_STATS = KV_BQ * 8;       // (LSE2, D) of one q tile
  static constexpr int KV_X = KV_BK * KV_BQ * 4;   // one P^T hand-off buffer
  static constexpr size_t KV_SMEM = 1024 + 2 * size_t(KV_TILE) + 2 * kStages * size_t(KV_QTILE) +
                                    kStages * size_t(KV_STATS) + 2 * size_t(KV_X) + 8 * (1 + 2 * kStages);
  // dQ kernel
  static constexpr int Q_BQ = 128;                 // q rows a block: two warpgroups x 64
  static constexpr int Q_BK = HD == 256 ? 16 : 64; // k rows a streamed tile
  static constexpr int Q_QTILE = Q_BQ * HD * 2;    // the Q or the dO tile
  static constexpr int Q_KTILE = Q_BK * HD * 2;    // one K or V tile
  static constexpr size_t Q_SMEM = 1024 + 2 * size_t(Q_QTILE) + 2 * kStages * size_t(Q_KTILE) + 8 * (1 + 3 * kStages);
  static_assert(KV_TILE % 1024 == 0 && KV_QTILE % 1024 == 0 && Q_QTILE % 1024 == 0 && Q_KTILE % 1024 == 0,
                "swizzled tiles on 1024-byte boundaries");
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ bool live_pair(int qp, int kp, int Lq, int Lk, int causal, int has_window, int window) {
  bool ok = qp < Lq && kp < Lk;
  if (causal) ok = ok && qp >= kp;
  if (has_window) ok = ok && qp - kp < window;
  return ok;
}

// A fragments of m64 x k16 steps from an m64 x nN accumulator (N = 16 * NK):
// step kk takes columns [16 kk, 16 kk + 16), as the forward's P
template <int NK>
__device__ __forceinline__ void to_frags(uint32_t (&a)[NK][4], const float (&d)[NK * 8]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = hopper::pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// d (m64 x N) = A (64 rows of a K-major tile at a_addr, R_A rows a chunk) *
// B^T (N rows of a K-major tile at b_addr, N rows a chunk), over the head
template <int HD, int N, int R_A>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a_addr, uint32_t b_addr) {
  using C = BwdCfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / C::KPC, off = (kk % C::KPC) * 32;
    const uint64_t da = hopper::make_desc<C::SW>(a_addr + c * R_A * C::SW + off, 16, 8 * C::SW);
    const uint64_t db = hopper::make_desc<C::SW>(b_addr + c * N * C::SW + off, 16, 8 * C::SW);
    hopper::WgmmaSS<N, 0>::run(d, da, db, 1);
  }
}

// acc (m64 x HD) += A (fragments, m64 x K) * X (K rows of a head-wide tile at
// x_addr, read MN-major: K rows a chunk)
template <int HD, int K>
__device__ __forceinline__ void product_rs(float (&acc)[HD / 2], const uint32_t (&a)[K / 16][4], uint32_t x_addr) {
  using C = BwdCfg<HD>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = hopper::make_desc<C::SW>(x_addr + kk * 16 * C::SW, K * C::SW, 8 * C::SW);
    hopper::WgmmaRS<HD, 1>::run(acc, a[kk], db, 1);
  }
}

// ---------------------------------------------------------------------------
// dK and dV
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kv_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                  const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                  const float2* __restrict__ stats, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                  float* __restrict__ dk_part, float* __restrict__ dv_part, int H, int KV, int Lq, int Lk, int Lq_pad,
                  float scale, float sl2, int causal, int has_window, int window) {
  using C = BwdCfg<HD>;
  constexpr int BK = C::KV_BK, BQ = C::KV_BQ, SW = C::SW, CH = C::CH, NCH = C::NCH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + C::KV_TILE;
  uint8_t* Qs = Vs + C::KV_TILE;                  // kStages tiles
  uint8_t* dOs = Qs + kStages * C::KV_QTILE;      // kStages tiles
  float2* Ss = reinterpret_cast<float2*>(dOs + kStages * C::KV_QTILE);  // kStages x BQ (LSE2, D)
  float* Xs = reinterpret_cast<float*>(Ss + kStages * BQ);              // 2 x (BK x BQ) P^T
  uint64_t* bars = reinterpret_cast<uint64_t*>(Xs + 2 * BK * BQ);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV;
  const int rep = H / KV, per = rep / gridDim.z, g0 = blockIdx.z * per;  // this part's query heads
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  // the queries that can see some key of [k0, k0 + BK): [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = has_window ? min(Lq, k0 + BK - 1 + window) : Lq;
  const int qt0 = (q_lo / BQ) * BQ;
  const int n_q = q_hi > qt0 ? (q_hi - qt0 + BQ - 1) / BQ : 0;
  const int n_tiles = per * n_q;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);  // every consumer thread releases
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread loads K and V once, then streams Q, dO and
    // their row statistics, head by head and q tile by q tile
    hopper::regs_release<kProducerRegs>();
    if (t == 0) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&domap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::mbar_arrive_expect_tx(kv_full, 2 * C::KV_TILE);
      for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(Ks + c * BK * SW, &kmap, kv_full, c * CH, k0, bkv);
      for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(Vs + c * BK * SW, &vmap, kv_full, c * CH, k0, bkv);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) hopper::mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        const int bh = b * H + kvh * rep + g0 + j / n_q;
        const int q0 = qt0 + (j % n_q) * BQ;
        uint8_t* qd = Qs + s * C::KV_QTILE;
        uint8_t* dd = dOs + s * C::KV_QTILE;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * C::KV_QTILE + C::KV_STATS);
        for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(qd + c * BQ * SW, &qmap, &full[s], c * CH, q0, bh);
        for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(dd + c * BQ * SW, &domap, &full[s], c * CH, q0, bh);
        hopper::bulk_load(Ss + s * BQ, stats + int64_t(bh) * Lq_pad + q0, C::KV_STATS, &full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup 0 accumulates dV, warpgroup 1 dK, for the
    // block's 64 k rows
    hopper::regs_claim<kConsumerRegs>();
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint32_t k_addr = hopper::smem_u32(Ks), v_addr = hopper::smem_u32(Vs);
    hopper::mbar_wait(kv_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const int q0 = qt0 + (j % n_q) * BQ;
      const int xb = j & 1;
      float* X = Xs + xb * BK * BQ;
      const float2* st = Ss + s * BQ;
      const uint32_t q_addr = hopper::smem_u32(Qs + s * C::KV_QTILE);
      const uint32_t do_addr = hopper::smem_u32(dOs + s * C::KV_QTILE);
      hopper::mbar_wait(&full[s], ph);

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): 64 k rows x BQ q columns
      float sacc[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) sacc[i] = 0.f;
      hopper::wgmma_fence();
      product_ss<HD, BQ, BK>(sacc, wg == 0 ? k_addr : v_addr, wg == 0 ? q_addr : do_addr);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);

      if (wg == 0) {
        const bool need_mask = k0 + BK > Lk || q0 + BQ > Lq || (causal && q0 < k0 + BK - 1) ||
                               (has_window && q0 + BQ - 1 - k0 >= window);
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int qc = hopper::acc_col(t, i);
          float p = exp2f(fmaf(sacc[i], sl2, -st[qc].x));
          if (need_mask) p = live_pair(q0 + qc, k0 + hopper::acc_row(t, i), Lq, Lk, causal, has_window, window) ? p : 0.f;
          sacc[i] = p;
        }
        if (j >= 2) hopper::named_sync(kXEmpty + xb, 256);  // warpgroup 1 has read this buffer's last P^T
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) X[i * 128 + t] = sacc[i];
        hopper::named_arrive(kXFull + xb, 256);
      } else {
        hopper::named_sync(kXFull + xb, 256);
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) sacc[i] = X[i * 128 + t] * (sacc[i] - st[hopper::acc_col(t, i)].y);
        if (j + 2 < n_tiles) hopper::named_arrive(kXEmpty + xb, 256);
      }

      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1)
      uint32_t a[BQ / 16][4];
      to_frags<BQ / 16>(a, sacc);
      hopper::wgmma_fence();
      product_rs<HD, BQ>(acc, a, wg == 0 ? do_addr : q_addr);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[s]);
    }

    const float mul = wg == 1 ? scale : 1.f;
    const int64_t part_base = int64_t(blockIdx.z) * gridDim.y + bkv;
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int kp = k0 + hopper::acc_row(t, i);
      if (kp < Lk) {
        const int col = hopper::acc_col(t, i);
        if (gridDim.z == 1) {
          __nv_bfloat16* out = wg == 0 ? dv : dk;
          *reinterpret_cast<__nv_bfloat162*>(out + (int64_t(bkv) * Lk + kp) * HD + col) =
              __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
        } else {
          float* out = wg == 0 ? dv_part : dk_part;
          *reinterpret_cast<float2*>(out + (part_base * Lk + kp) * HD + col) = make_float2(acc[i] * mul, acc[i + 1] * mul);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_q_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const float2* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int H, int KV, int Lq, int Lk,
                 int Lq_pad, float scale, float sl2, int causal, int has_window, int window) {
  using C = BwdCfg<HD>;
  constexpr int BQ = C::Q_BQ, BK = C::Q_BK, SW = C::SW, CH = C::CH, NCH = C::NCH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* dOs = Qs + C::Q_QTILE;
  uint8_t* Ks = dOs + C::Q_QTILE;               // kStages tiles
  uint8_t* Vs = Ks + kStages * C::Q_KTILE;      // kStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * C::Q_KTILE);
  uint64_t* qd_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h * KV / H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  // keys that can be live for some row of this q tile: [k_lo, k_hi)
  const int k_lo = has_window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Lk, q0 + BQ) : Lk;
  const int kt0 = (k_lo / BK) * BK;
  const int n_tiles = k_hi > kt0 ? (k_hi - kt0 + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    hopper::regs_release<kProducerRegs>();
    if (t == 0) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&domap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::mbar_arrive_expect_tx(qd_full, 2 * C::Q_QTILE);
      for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(Qs + c * BQ * SW, &qmap, qd_full, c * CH, q0, bh);
      for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(dOs + c * BQ * SW, &domap, qd_full, c * CH, q0, bh);
      const int kvb = b * KV + kvh;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) hopper::mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        const int kt = kt0 + j * BK;
        uint8_t* kd = Ks + s * C::Q_KTILE;
        uint8_t* vd = Vs + s * C::Q_KTILE;
        hopper::mbar_arrive_expect_tx(&k_full[s], C::Q_KTILE);
        for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(kd + c * BK * SW, &kmap, &k_full[s], c * CH, kt, kvb);
        hopper::mbar_arrive_expect_tx(&v_full[s], C::Q_KTILE);
        for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(vd + c * BK * SW, &vmap, &v_full[s], c * CH, kt, kvb);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [qw0, qw0 + 64)
    hopper::regs_claim<kConsumerRegs>();
    const int qw0 = q0 + 64 * wg;
    float lse[2], dsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = stats[int64_t(bh) * Lq_pad + qw0 + hopper::acc_row(t, 2 * r)];
      lse[r] = v.x;
      dsum[r] = v.y;
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint32_t q_addr = hopper::smem_u32(Qs) + wg * 64 * SW;
    const uint32_t do_addr = hopper::smem_u32(dOs) + wg * 64 * SW;
    hopper::mbar_wait(qd_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const int kt = kt0 + j * BK;
      // a tile fully masked for these 64 rows (as the forward's)
      const bool dead = (causal && kt > qw0 + 63) || (has_window && qw0 - (kt + BK - 1) >= window) || qw0 >= Lq;
      hopper::mbar_wait(&k_full[s], ph);
      if (!dead) {
        const uint32_t k_addr = hopper::smem_u32(Ks + s * C::Q_KTILE);
        const uint32_t v_addr = hopper::smem_u32(Vs + s * C::Q_KTILE);
        float sacc[BK / 2], pacc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sacc[i] = pacc[i] = 0.f;
        hopper::wgmma_fence();
        product_ss<HD, BK, BQ>(sacc, q_addr, k_addr);  // S = Q K^T
        hopper::wgmma_commit();
        hopper::mbar_wait(&v_full[s], ph);
        product_ss<HD, BK, BQ>(pacc, do_addr, v_addr);  // dP = dO V^T
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc);
        hopper::fence_regs(pacc);

        const bool need_mask = kt + BK > Lk || (causal && kt + BK - 1 > qw0) ||
                               (has_window && (qw0 + 63) - kt >= window);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i >> 1) & 1;
          float p = exp2f(fmaf(sacc[i], sl2, -lse[r]));
          if (need_mask)
            p = live_pair(qw0 + hopper::acc_row(t, i), kt + hopper::acc_col(t, i), Lq, Lk, causal, has_window, window) ? p : 0.f;
          sacc[i] = p * (pacc[i] - dsum[r]);  // dS
        }
        uint32_t a[BK / 16][4];
        to_frags<BK / 16>(a, sacc);
        hopper::wgmma_fence();
        product_rs<HD, BK>(acc, a, k_addr);  // dQ += dS K
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      } else {
        hopper::mbar_wait(&v_full[s], ph);  // the stage is released only once V has landed
      }
      hopper::mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* qb = dq + int64_t(bh) * Lq * HD;
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int qp = qw0 + hopper::acc_row(t, i);
      if (qp < Lq)
        *reinterpret_cast<__nv_bfloat162*>(qb + int64_t(qp) * HD + hopper::acc_col(t, i)) =
            __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const __nv_bfloat16* o,
           const __nv_bfloat16* dout, const float* lse2, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
           float2* stats, float* dk_part, float* dv_part, int B, int H, int KV, int Lq, int Lk, int Lq_pad, int parts,
           int causal, int has_window, int window, cudaStream_t s) {
  using C = BwdCfg<HD>;
  const float scale = float(1.0 / std::sqrt(double(HD)));  // as the forward rounds it
  const float sl2 = scale * kLog2e;

  const int64_t rows = int64_t(B) * H * Lq_pad;
  const int rows_per_block = rowstats_rows_per_block<__nv_bfloat16>(HD);
  attn_bwd_rowstats<__nv_bfloat16><<<unsigned((rows + rows_per_block - 1) / rows_per_block), 256, 0, s>>>(
      o, dout, lse2, stats, B * H, Lq, Lq_pad, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  CUtensorMap qm, dom, km, vm;
  int code = hopper::make_map_3d(&qm, q, uint64_t(B) * H, Lq, HD, C::KV_BQ, C::CH, C::SW);
  if (!code) code = hopper::make_map_3d(&dom, dout, uint64_t(B) * H, Lq, HD, C::KV_BQ, C::CH, C::SW);
  if (!code) code = hopper::make_map_3d(&km, k, uint64_t(B) * KV, Lk, HD, C::KV_BK, C::CH, C::SW);
  if (!code) code = hopper::make_map_3d(&vm, v, uint64_t(B) * KV, Lk, HD, C::KV_BK, C::CH, C::SW);
  if (code) return code;
  auto kv_kernel = attn_bwd_kv_wgmma<HD>;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::KV_SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 kv_grid((Lk + C::KV_BK - 1) / C::KV_BK, B * KV, parts);
  kv_kernel<<<kv_grid, kThreads, C::KV_SMEM, s>>>(qm, dom, km, vm, stats, dk, dv, dk_part, dv_part, H, KV, Lq, Lk,
                                                    Lq_pad, scale, sl2, causal, has_window, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  if (parts > 1) {
    const int64_t n4 = int64_t(B) * KV * Lk * HD / 4;
    const int64_t want = (n4 + 255) / 256;
    attn_bwd_kv_sum<__nv_bfloat16><<<unsigned(want < 132 * 16 ? want : 132 * 16), 256, 0, s>>>(
        reinterpret_cast<const float4*>(dk_part), reinterpret_cast<const float4*>(dv_part), dk, dv, parts, n4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }

  code = hopper::make_map_3d(&qm, q, uint64_t(B) * H, Lq, HD, C::Q_BQ, C::CH, C::SW);
  if (!code) code = hopper::make_map_3d(&dom, dout, uint64_t(B) * H, Lq, HD, C::Q_BQ, C::CH, C::SW);
  if (!code) code = hopper::make_map_3d(&km, k, uint64_t(B) * KV, Lk, HD, C::Q_BK, C::CH, C::SW);
  if (!code) code = hopper::make_map_3d(&vm, v, uint64_t(B) * KV, Lk, HD, C::Q_BK, C::CH, C::SW);
  if (code) return code;
  auto q_kernel = attn_bwd_q_wgmma<HD>;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::Q_SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 q_grid((Lq + C::Q_BQ - 1) / C::Q_BQ, B * H);
  q_kernel<<<q_grid, kThreads, C::Q_SMEM, s>>>(qm, dom, km, vm, stats, dq, H, KV, Lq, Lk, Lq_pad, scale, sl2, causal,
                                                 has_window, window);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o, do, dq (B,H,Lq,hd); k, v, dk, dv (B,KV,Lk,hd): contiguous bf16 on
// 16-byte boundaries.  lse2: the forward's B*H*Lq fp32 log-sum-exp in base
// 2.  stats: fp32 scratch of B*H*Lq_pad*2 (Lq_pad = Lq rounded up to 128).
// parts: how many blocks share a KV head's query heads (divides H/KV); with
// parts > 1, dk_part and dv_part are fp32 scratch of parts*B*KV*Lk*hd each,
// else unused.  has_window = 0 means no window mask.  Launches the kernels
// on `stream`; returns the first CUDA error (0 on success).
int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                              const void* lse2, void* dq, void* dk, void* dv, void* stats, void* dk_part,
                              void* dv_part, int B, int H, int KV, int Lq, int Lk, int hd, int Lq_pad, int parts,
                              int causal, int has_window, int window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (KV == 0 || H % KV || parts < 1 || (H / KV) % parts || B * H > 65535 || B * KV > 65535 ||
      Lq_pad < Lq || Lq_pad % kPadRows)
    return int(cudaErrorInvalidValue);
  if (Lq == 0 || Lk == 0) {  // no query or no key: every gradient is zero
    err = cudaMemsetAsync(dq, 0, size_t(B) * H * Lq * hd * 2, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dk, 0, size_t(B) * KV * Lk * hd * 2, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, size_t(B) * KV * Lk * hd * 2, s);
    return int(err);
  }
  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(q);
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const bf* ob = static_cast<const bf*>(o);
  const bf* db = static_cast<const bf*>(dout);
  const float* lse = static_cast<const float*>(lse2);
  bf* dqb = static_cast<bf*>(dq);
  bf* dkb = static_cast<bf*>(dk);
  bf* dvb = static_cast<bf*>(dv);
  float2* st = static_cast<float2*>(stats);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
  switch (hd) {
    case 32: return launch<32>(qb, kb, vb, ob, db, lse, dqb, dkb, dvb, st, pk, pv, B, H, KV, Lq, Lk, Lq_pad, parts, causal, has_window, window, s);
    case 64: return launch<64>(qb, kb, vb, ob, db, lse, dqb, dkb, dvb, st, pk, pv, B, H, KV, Lq, Lk, Lq_pad, parts, causal, has_window, window, s);
    case 128: return launch<128>(qb, kb, vb, ob, db, lse, dqb, dkb, dvb, st, pk, pv, B, H, KV, Lq, Lk, Lq_pad, parts, causal, has_window, window, s);
    case 256: return launch<256>(qb, kb, vb, ob, db, lse, dqb, dkb, dvb, st, pk, pv, B, H, KV, Lq, Lk, Lq_pad, parts, causal, has_window, window, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one block, in bytes: kernel 0 is the dK/dV
// kernel, 1 the dQ kernel; -1 for a width without an instance.
int flash_attention_bwd_wgmma_smem(int hd, int kernel) {
  switch (hd) {
    case 32: return int(kernel ? BwdCfg<32>::Q_SMEM : BwdCfg<32>::KV_SMEM);
    case 64: return int(kernel ? BwdCfg<64>::Q_SMEM : BwdCfg<64>::KV_SMEM);
    case 128: return int(kernel ? BwdCfg<128>::Q_SMEM : BwdCfg<128>::KV_SMEM);
    case 256: return int(kernel ? BwdCfg<256>::Q_SMEM : BwdCfg<256>::KV_SMEM);
    default: return -1;
  }
}

const char* flash_attention_bwd_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
