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
// bound by operations, and the bound is the tensor cores' rate for the
// operands' type.  At the broker's registry tiers (64 rows to 512) it is
// bound by latency: a few k tiles a block, each a load and a chain of
// dependent products.
//
// Four routes, chosen by a rule in kernels/flash_attention.py (`route`), all
// on the tensor cores:
//
// `wgmma` (bf16 operands at head widths 32 to 256).
//  * one block per (b*h, 128-row q tile), longest causal tiles first; two
//    consumer warpgroups own 64 q rows each; one thread of a third
//    (producer) warpgroup streams the K and V tiles with TMA (3-D tensor maps
//    over (b*heads, L, hd), so a tile past L is clipped and zero-filled at
//    the edge of its own head) into a ring of 2 stages in 128-byte-swizzled
//    shared memory (64-byte at hd 32); the Q tile is loaded once.
//    `setmaxnreg` moves registers from the producer to the consumers.
//  * S = Q.K^T is a wgmma with both operands in shared memory.  The k-tile
//    loop keeps the causal and window bounds, so fully masked tiles are never
//    loaded; a warpgroup skips the math of a tile that is fully masked for
//    its 64 rows, and masks element by element only on diagonal, window-edge
//    and ragged tiles.
//  * the online softmax runs in fp32 registers on the S accumulator.
//  * O += P.V is a wgmma with P from registers (the S accumulator fragment
//    converted in place to an A fragment) and V in shared memory, read
//    MN-major through the transpose bit.  P is split into two bf16 parts,
//    P_hi = bf16(P) and P_lo = bf16(P - P_hi), multiplied against the same V
//    tile: rounding P once to bf16 puts a few early-row outputs (where a few
//    keys cancel and the output is small) outside one bf16 step of the fp32
//    result, and the split keeps P to ~16 bits for one extra product.
//  * on request (a non-null `lse`, B*H*Lq fp32) the epilogue also stores each
//    row's log-sum-exp in base 2, LSE2 = m log2(e) + log2(l) (-inf for a row
//    with no live key), which the backward (csrc/flash_attention_bwd_wgmma.cu)
//    reads instead of re-running Q.K^T.  The store reads m and l after they
//    are final and touches nothing that forms o, so o is the same with or
//    without it.
//  * k tiles of 128 rows up to hd 128; at hd 256 the O accumulator takes 128
//    registers a thread, so the k tile shrinks to 32 rows (the q tile
//    stays): ptxas holds the consumers near 170 registers, and a 64-row tile
//    spills more of the accumulator around each product and runs slower.
//
// `tf32x3` (fp32 operands at head widths 16 to 128): the products run on the
// tensor cores at fp32 accuracy, as three TF32 products each (the pieces and
// their reasons are in attention_tf32x3.cuh).  One TF32 product keeps ~3
// decimal digits and misses the fp32 tolerance (2e-5 max-abs) by ~50x; the
// split keeps ~21 bits.
//  * one block of one warpgroup per (b*h, 64-row q tile), longest causal
//    tiles first: twice the blocks of a 128-row tile, which the registry's
//    tiers (4 to 64 q tiles of 64 rows) need more than the wider tile's
//    reuse.  Where the grid would still fill less than half the card, a q
//    tile's k tiles are split into 2 or 4 runs (`parts`, a rule in
//    kernels/flash_attention.py: fwd_parts), one block each, and a second
//    kernel merges the runs' (m, l, O) in a fixed order, flash-decoding's
//    combine: the full tier runs 128 blocks of at most 8 k tiles instead of
//    64 of at most 16.
//  * Q is read once and split into hi/lo tiles that stay resident.  K and V
//    stream in tiles of 32 rows through a ring of 2 cp.async stages; the
//    load of tile j + 1 is issued before tile j is split, so it runs under
//    tile j's split and products.  K is split as is (the B operand of
//    S = Q K^T), V transposed (the B operand of P V, whose depth is the k
//    rows: TF32 has no transpose bit).
//  * S over the head in stages of 32, each a fresh accumulator; the online
//    softmax in fp32 on it (exp2 with log2(e) folded in, as `wgmma`); P V of
//    the tile (32 deep: one stage) into a fresh accumulator, and
//    O = O corr + P V on the CUDA cores.
//  * LSE2 on request, exactly as `wgmma` writes it; o is the same with or
//    without it.
//
// `tf32x3_cluster` (fp32 at head width 256, recurrentgemma-2b's): the same
// kernel on two-block clusters.  At 256 one block would need 128 KB for Q's
// hi/lo tiles alone and 256 accumulator registers a thread; so the two
// blocks of a cluster own the same 64 q rows and 128 head columns each, and
// each block's tiles, registers and products are the hd 128 kernel's.  Each
// forms its half of S (over its 128 columns), writes it into the peer's
// shared memory (distributed shared memory: st.async stores completing on
// the peer's mbarrier, `PairXch`), and once the peer's half has landed adds
// it to its own: both hold the same S,
// run the same softmax, and multiply the same P into their own half of V,
// so each writes its half of o (the first also LSE2).  About 210 KB of
// shared memory a block; the k split (`parts`) counts a cluster as a block
// on half the SMs.
//
// `tf32` (bf16 at head width 16, the reduced configs', narrower than the
// `wgmma` route's smallest swizzle): the `tf32x3` kernel on bf16 rows (32
// bytes at hd 16, cp.async's 16-byte units), one TF32 product a product: a
// bf16 value is exact in TF32, so its lo part is 0 and hi hi is the whole
// product.  P goes in rounded to TF32 (finer than the reference's bf16 P).
// o is written in bf16; no parts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "attention_tf32x3.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// the wgmma route (bf16)
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct TcConfig {
  static constexpr int BQ = 128;                   // q rows per block: two warpgroups x 64
  static constexpr int BK = HD == 256 ? 32 : 128;  // k rows per tile
  static constexpr int SW = HD >= 64 ? 128 : 64;   // swizzle: bytes per tile row
  static constexpr int CH = SW / 2;                // columns per chunk of SW bytes
  static constexpr int NCH = HD / CH;              // chunks across the head
  static constexpr int KPC = SW / 32;              // k16 steps per chunk
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;     // one K or one V tile
  static constexpr int THREADS = 384;              // 2 consumer warpgroups + the producer's
  // tiles first (each a multiple of 1024 bytes), then the barriers; 1024 for alignment
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * size_t(KV_BYTES) + 64;
};

// Scale, mask and exponentiate one S tile in place (S becomes P), update the
// row max m, the partial row sums l, and rescale the O accumulator.
template <int HD, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[TcConfig<HD>::BK / 2], float (&o)[HD / 2],
                                             float (&m)[2], float (&l)[2], int t, int qw0, int kt,
                                             int Lk, float scale, int causal, int has_window,
                                             int window) {
  constexpr int NS = TcConfig<HD>::BK / 2;
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float v = s[i] * scale;
    if (MASK) {
      const int qpos = qw0 + hopper::acc_row(t, i), kpos = kt + hopper::acc_col(t, i);
      bool live = kpos < Lk;
      if (causal) live = live && qpos >= kpos;
      if (has_window) live = live && (qpos - kpos) < window;
      v = live ? v : kNeg;
    }
    s[i] = v;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
  }
  float corr[2], mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2f((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    mk[r] = m_new * kLog2e;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    // a masked score is -1e30 exactly; exp(s - m) <= 1, so selecting on the
    // mask and multiplying by it agree
    float p = exp2f(fmaf(s[i], kLog2e, -mk[r]));
    if (MASK) p = s[i] == kNeg ? 0.f : p;
    s[i] = p;
    l[r] += p;
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

template <int HD>
__global__ void __launch_bounds__(TcConfig<HD>::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int H, int KV, int Lq, int Lk, float scale, int causal,
                int has_window, int window) {
  using Cfg = TcConfig<HD>;
  constexpr int BQ = Cfg::BQ, BK = Cfg::BK, SW = Cfg::SW, CH = Cfg::CH;
  constexpr int NCH = Cfg::NCH, KPC = Cfg::KPC, STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + Cfg::Q_BYTES;                   // STAGES tiles
  uint8_t* Vs = Ks + STAGES * Cfg::KV_BYTES;         // STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + STAGES * Cfg::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h * KV / H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  // keys that can be live for some row of this q tile: [k_lo, k_hi)
  int k_lo = 0, k_hi = Lk;
  if (causal) k_hi = min(Lk, q0 + BQ);
  if (has_window) k_lo = max(0, q0 - window + 1);
  const int kt0 = (k_lo / BK) * BK;
  const int n_tiles = (k_hi - kt0 + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);  // every consumer thread releases
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread streams Q once, then K and V tile by tile
    hopper::regs_release<24>();
    if (t == 0) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::mbar_arrive_expect_tx(q_full, Cfg::Q_BYTES);
      for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(Qs + c * BQ * SW, &qmap, q_full, c * CH, q0, bh);
      const int kvb = b * KV + kvh;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) hopper::mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
        const int kt = kt0 + j * BK;
        uint8_t* kd = Ks + s * Cfg::KV_BYTES;
        uint8_t* vd = Vs + s * Cfg::KV_BYTES;
        hopper::mbar_arrive_expect_tx(&k_full[s], Cfg::KV_BYTES);
        for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(kd + c * BK * SW, &kmap, &k_full[s], c * CH, kt, kvb);
        hopper::mbar_arrive_expect_tx(&v_full[s], Cfg::KV_BYTES);
        for (int c = 0; c < NCH; ++c) hopper::tma_load_3d(vd + c * BK * SW, &vmap, &v_full[s], c * CH, kt, kvb);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [qw0, qw0 + 64)
    hopper::regs_claim<240>();
    const int qw0 = q0 + 64 * wg;
    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = hopper::smem_u32(Qs) + wg * 64 * SW;
    hopper::mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;
      const int kt = kt0 + j * BK;
      // a tile fully masked for these 64 rows: every key after the last row
      // (causal), or every key too old for the first row (window), or no row
      // inside the sequence
      const bool dead = (causal && kt > qw0 + 63) ||
                        (has_window && qw0 - (kt + BK - 1) >= window) || qw0 >= Lq;
      hopper::mbar_wait(&k_full[s], ph);
      if (!dead) {
        float sacc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
        const uint32_t k_addr = hopper::smem_u32(Ks + s * Cfg::KV_BYTES);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = kk / KPC, off = (kk % KPC) * 32;
          const uint64_t da = hopper::make_desc<SW>(q_addr + c * BQ * SW + off, 16, 8 * SW);
          const uint64_t db = hopper::make_desc<SW>(k_addr + c * BK * SW + off, 16, 8 * SW);
          hopper::WgmmaSS<BK, 0>::run(sacc, da, db, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc);

        const bool need_mask = kt + BK > Lk || (causal && kt + BK - 1 > qw0) ||
                               (has_window && (qw0 + 63) - kt >= window);
        if (need_mask)
          softmax_tile<HD, true>(sacc, oacc, m, l, t, qw0, kt, Lk, scale, causal, has_window, window);
        else
          softmax_tile<HD, false>(sacc, oacc, m, l, t, qw0, kt, Lk, scale, causal, has_window, window);

        // P as A fragments of k16 steps: a[j] = (s[8kk + 2j], s[8kk + 2j + 1])
        uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p0 = sacc[8 * kk + 2 * r], p1 = sacc[8 * kk + 2 * r + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
            p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
            p_lo[kk][r] = hopper::pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
          }
        }
        hopper::mbar_wait(&v_full[s], ph);
        const uint32_t v_addr = hopper::smem_u32(Vs + s * Cfg::KV_BYTES);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = hopper::make_desc<SW>(v_addr + kk * 16 * SW, BK * SW, 8 * SW);
          hopper::WgmmaRS<HD, 1>::run(oacc, p_hi[kk], db, 1);
          hopper::WgmmaRS<HD, 1>::run(oacc, p_lo[kk], db, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(oacc);
      } else {
        hopper::mbar_wait(&v_full[s], ph);  // the stage is released only once V has landed
      }
      hopper::mbar_arrive(&empty[s]);
    }

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-37f);
    }
    __nv_bfloat16* ob = o + int64_t(bh) * Lq * HD;
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int qpos = qw0 + hopper::acc_row(t, i);
      if (qpos < Lq) {
        // __fdividef is inline (den is in [1e-37, Lk], inside its range); the
        // IEEE division calls a slow-path routine, around which the live
        // accumulator spills to the stack
        const float d = den[(i >> 1) & 1];
        *reinterpret_cast<__nv_bfloat162*>(ob + int64_t(qpos) * HD + hopper::acc_col(t, i)) =
            __floats2bfloat162_rn(__fdividef(oacc[i], d), __fdividef(oacc[i + 1], d));
      }
    }
    if (lse != nullptr && (t & 3) == 0) {
      // the 4 threads of a row hold the same m and (reduced above) l
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = qw0 + hopper::acc_row(t, 2 * r);
        if (qpos < Lq) lse[int64_t(bh) * Lq + qpos] = m[r] * kLog2e + log2f(l[r]);
      }
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int KV,
                 int Lq, int Lk, int causal, int has_window, int window, cudaStream_t stream) {
  using Cfg = TcConfig<HD>;
  CUtensorMap qmap, kmap, vmap;
  int err = hopper::make_map_3d(&qmap, q, uint64_t(B) * H, Lq, HD, Cfg::BQ, Cfg::CH, Cfg::SW);
  if (!err) err = hopper::make_map_3d(&kmap, k, uint64_t(B) * KV, Lk, HD, Cfg::BK, Cfg::CH, Cfg::SW);
  if (!err) err = hopper::make_map_3d(&vmap, v, uint64_t(B) * KV, Lk, HD, Cfg::BK, Cfg::CH, Cfg::SW);
  if (err) return err;
  auto kernel = flash_fwd_wgmma<HD>;
  cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Cfg::SMEM));
  if (cerr != cudaSuccess) return int(cerr);
  const dim3 grid((Lq + Cfg::BQ - 1) / Cfg::BQ, B * H);
  const float scale = float(1.0 / std::sqrt(double(HD)));  // as the reference rounds it
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse,
                                                     H, KV, Lq, Lk, scale, causal, has_window, window);
  return int(cudaGetLastError());
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int KV,
                   int Lq, int Lk, int hd, int causal, int has_window, int window, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_wgmma<32>(q, k, v, o, lse, B, H, KV, Lq, Lk, causal, has_window, window, stream);
    case 64: return launch_wgmma<64>(q, k, v, o, lse, B, H, KV, Lq, Lk, causal, has_window, window, stream);
    case 128: return launch_wgmma<128>(q, k, v, o, lse, B, H, KV, Lq, Lk, causal, has_window, window, stream);
    case 256: return launch_wgmma<256>(q, k, v, o, lse, B, H, KV, Lq, Lk, causal, has_window, window, stream);
    default: return int(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// the tf32x3 route (fp32)
// ---------------------------------------------------------------------------

namespace tf32x3 {

using namespace attn3;

constexpr int BN = 32;  // k rows a streamed tile

// T the operands' type (fp32: three TF32 products; bf16: one), HD the head
// width, SPLIT the blocks of a cluster that share a q tile's head columns
template <typename T, int HD, int SPLIT>
struct FwdCfg {
  static constexpr int W = HD / SPLIT;        // the block's head columns
  static constexpr bool X3 = sizeof(T) == 4;  // three TF32 products a product
  static constexpr int NT = X3 ? 2 : 1;       // TF32 tiles an operand: hi and lo, or hi
  static constexpr int Q_T = asis_bytes<kRows, W>();  // one resident Q tile (hi or lo)
  static constexpr int K_T = asis_bytes<BN, W>();
  static constexpr int V_T = trans_bytes<W>();
  static constexpr int RAW = raw_bytes<T, BN, W>();   // one raw K or V tile
  static constexpr int XCH = kRows * BN * 4;  // the peer's partial S of a tile
  static constexpr size_t SMEM = 1024 + NT * size_t(Q_T + K_T + V_T) + 2 * 2 * size_t(RAW) + (SPLIT > 1 ? pair_xch_bytes(XCH) : 0);
  static_assert(Q_T % 1024 == 0 && K_T % 1024 == 0 && V_T % 1024 == 0, "tiles on the swizzle's 1024-byte period");
  static_assert(RAW % 16 == 0, "raw stages on cp.async's 16-byte units");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// Scale, mask and exponentiate one S tile in place (S becomes P); update the
// row max m and the partial row sums l; corr rescales O
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2], float (&corr)[2], int t,
                                             int q0, int kt, int Lq, int Lk, float scale, int causal, int has_window,
                                             int window) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    float v = s[i] * scale;
    if (MASK)
      v = live_pair(q0 + hopper::acc_row(t, i), kt + hopper::acc_col(t, i), Lq, Lk, causal, has_window, window) ? v : kNeg;
    s[i] = v;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
  }
  float mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2f((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    mk[r] = m_new * kLog2e;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    // a masked score is -1e30 exactly; exp(s - m) <= 1, so selecting on the
    // mask and multiplying by it agree
    float p = exp2f(fmaf(s[i], kLog2e, -mk[r]));
    if (MASK) p = s[i] == kNeg ? 0.f : p;
    s[i] = p;
    l[r] += p;
  }
}

// Block (q tile, b*h, part): with parts = 1 it writes o (and LSE2); with
// parts > 1, part p takes the p-th of `parts` equal runs of the q tile's k
// tiles and writes its unnormalized O and its rows' (m, l) to the scratch,
// which flash_fwd_tf32x3_combine merges.  With SPLIT = 2 the two blocks of
// a cluster take the same q tile, each its half of the head's columns, and
// add their partial S through a PairXch; both then hold the same m and l,
// and the first writes LSE2 and (m, l).
template <typename T, int HD, int SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32x3(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ o_part, float2* __restrict__ ml_part, int H, int KV,
                 int Lq, int Lk, float scale, int causal, int has_window, int window) {
  using C = FwdCfg<T, HD, SPLIT>;
  constexpr int W = C::W;
  constexpr bool X3 = C::X3;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* q_hi = aligned_smem(smem_raw);
  uint8_t* q_lo = q_hi + C::Q_T;  // X3 only, as every lo tile
  uint8_t* k_hi = q_hi + C::NT * C::Q_T;
  uint8_t* k_lo = k_hi + C::K_T;
  uint8_t* vt_hi = k_hi + C::NT * C::K_T;
  uint8_t* vt_lo = vt_hi + C::V_T;
  uint8_t* ring = vt_hi + C::NT * C::V_T;  // 2 stages of {K, V} raw
  uint8_t* xch = ring + 2 * 2 * C::RAW;     // SPLIT > 1: the pair's exchange

  const int rank = SPLIT > 1 ? int(hopper::cluster_rank()) : 0;
  const int c0 = rank * W;  // the block's first head column
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h * KV / H;
  const int q0 = (gridDim.x / SPLIT - 1 - blockIdx.x / SPLIT) * kRows;  // the longest causal rows first
  const int t = threadIdx.x;
  const T* kb = k + int64_t(b * KV + kvh) * Lk * HD + c0;
  const T* vb = v + int64_t(b * KV + kvh) * Lk * HD + c0;

  // keys that can be live for some row of this q tile: [k_lo, k_hi)
  const int key_lo = has_window ? max(0, q0 - window + 1) : 0;
  const int key_hi = causal ? min(Lk, q0 + kRows) : Lk;
  const int parts = gridDim.z, part = blockIdx.z;
  const int all = key_hi > (key_lo / BN) * BN ? (key_hi - (key_lo / BN) * BN + BN - 1) / BN : 0;
  const int run = (all + parts - 1) / parts;  // this part's run of the q tile's k tiles
  const int kt0 = (key_lo / BN) * BN + min(all, part * run) * BN;
  const int n_tiles = min(all, (part + 1) * run) - min(all, part * run);

  auto issue = [&](int j) {  // tile j's K and V rows into stage j % 2
    if (j < n_tiles) {
      uint8_t* st = ring + (j & 1) * 2 * C::RAW;
      load_raw<T, W, BN>(st, kb, kt0 + j * BN, Lk, HD, t);
      load_raw<T, W, BN>(st + C::RAW, vb, kt0 + j * BN, Lk, HD, t);
    }
    hopper::cp_async_commit();
  };
  issue(0);
  load_resident<T, W, X3>(q + int64_t(bh) * Lq * HD + c0, q0, Lq, HD, q_hi, q_lo, t);
  PairXch pair;
  if constexpr (SPLIT > 1) pair.init(xch, C::XCH, rank, t);

  float oacc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) oacc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const uint32_t aq_hi = hopper::smem_u32(q_hi), aq_lo = hopper::smem_u32(q_lo);
  const uint32_t ak_hi = hopper::smem_u32(k_hi), ak_lo = hopper::smem_u32(k_lo);
  const uint32_t av_hi = hopper::smem_u32(vt_hi), av_lo = hopper::smem_u32(vt_lo);

  for (int j = 0; j < n_tiles; ++j) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // tile j has landed, and every thread is done with tile j - 1
    issue(j + 1);     // into the stage tile j - 1 left: it loads under this tile's work
    const uint8_t* st = ring + (j & 1) * 2 * C::RAW;
    split_raw<T, W, BN, true, false, X3>(st, k_hi, k_lo, nullptr, nullptr, t);
    split_raw<T, W, BN, false, true, X3>(st + C::RAW, nullptr, nullptr, vt_hi, vt_lo, t);
    hopper::fence_proxy_async();  // the split tiles are read by wgmma
    __syncthreads();

    const int kt = kt0 + j * BN;
    float s[BN / 2];
    product_s<W, BN, X3, (SPLIT > 1)>(s, aq_hi, aq_lo, ak_hi, ak_lo);  // the cluster's: two stages in flight
    if constexpr (SPLIT > 1) {  // the other half of the head's columns
      pair.expect(j, t);
      pair.send(s, j, 0, t);
      pair.wait(j);
      pair.add(s, j, 0, t);
    }
    const bool need_mask = kt + BN > Lk || q0 + kRows > Lq || (causal && kt + BN - 1 > q0) ||
                           (has_window && q0 + kRows - 1 - kt >= window);
    float corr[2];
    if (need_mask)
      softmax_tile<true>(s, m, l, corr, t, q0, kt, Lq, Lk, scale, causal, has_window, window);
    else
      softmax_tile<false>(s, m, l, corr, t, q0, kt, Lq, Lk, scale, causal, has_window, window);
    float part[W / 2];
    product_px<W, BN, X3>(part, s, av_hi, av_lo);
#pragma unroll
    for (int i = 0; i < W / 2; ++i) oacc[i] = fmaf(oacc[i], corr[(i >> 1) & 1], part[i]);
  }
  if constexpr (SPLIT > 1) pair.finish();

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-37f);
  }
  if (parts > 1) {  // the part's unnormalized O and (m, l), for the combine (fp32 only)
    const int64_t rows = (int64_t(part) * gridDim.y + bh) * Lq;
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const int qpos = q0 + hopper::acc_row(t, i);
      if (qpos < Lq) store2(o_part + (rows + qpos) * HD + c0 + hopper::acc_col(t, i), oacc[i], oacc[i + 1]);
    }
    if (rank == 0 && (t & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = q0 + hopper::acc_row(t, 2 * r);
        if (qpos < Lq) ml_part[rows + qpos] = make_float2(m[r], l[r]);
      }
    }
    return;
  }
  T* ob = o + int64_t(bh) * Lq * HD + c0;
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int qpos = q0 + hopper::acc_row(t, i);
    if (qpos < Lq) {
      const float d = den[(i >> 1) & 1];  // in [1e-37, Lk], inside __fdividef's range
      store2(ob + int64_t(qpos) * HD + hopper::acc_col(t, i), __fdividef(oacc[i], d), __fdividef(oacc[i + 1], d));
    }
  }
  if (lse != nullptr && rank == 0 && (t & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + hopper::acc_row(t, 2 * r);
      if (qpos < Lq) lse[int64_t(bh) * Lq + qpos] = m[r] * kLog2e + log2f(l[r]);
    }
  }
}

// o (and LSE2) from the parts' unnormalized O and (m, l), parts in order:
// m = max_p m_p, w_p = exp2((m_p - m) log2(e)), l = sum w_p l_p,
// o = sum w_p O_p / max(l, 1e-37).  One thread a row's 4 columns.
__global__ void __launch_bounds__(256)
flash_fwd_tf32x3_combine(const float4* __restrict__ o_part, const float2* __restrict__ ml_part, float4* __restrict__ o,
                         float* __restrict__ lse, int64_t rows, int hd4, int parts) {
  const int64_t n = rows * hd4;
  for (int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x; i < n; i += int64_t(gridDim.x) * 256) {
    const int64_t row = i / hd4;
    float mx = kNeg;
    for (int p = 0; p < parts; ++p) mx = fmaxf(mx, ml_part[p * rows + row].x);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < parts; ++p) {
      const float2 ml = ml_part[p * rows + row];
      const float w = exp2f((ml.x - mx) * kLog2e);
      const float4 x = o_part[p * n + i];
      l = fmaf(w, ml.y, l);
      acc = make_float4(fmaf(w, x.x, acc.x), fmaf(w, x.y, acc.y), fmaf(w, x.z, acc.z), fmaf(w, x.w, acc.w));
    }
    const float d = fmaxf(l, 1e-37f);
    o[i] = make_float4(__fdividef(acc.x, d), __fdividef(acc.y, d), __fdividef(acc.z, d), __fdividef(acc.w, d));
    if (lse != nullptr && i % hd4 == 0) lse[row] = mx * kLog2e + log2f(l);
  }
}

template <typename T, int HD, int SPLIT>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, float* scratch, int B, int H, int KV,
           int Lq, int Lk, int causal, int has_window, int window, int parts, cudaStream_t stream) {
  using C = FwdCfg<T, HD, SPLIT>;
  auto kernel = flash_fwd_tf32x3<T, HD, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(SPLIT * ((Lq + kRows - 1) / kRows), B * H, parts);
  const float scale = float(1.0 / std::sqrt(double(HD)));  // as the reference rounds it
  const int64_t rows = int64_t(B) * H * Lq;
  float* o_part = parts > 1 ? scratch : nullptr;
  float2* ml_part = parts > 1 ? reinterpret_cast<float2*>(scratch + parts * rows * HD) : nullptr;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if constexpr (SPLIT > 1) {
    err = hopper::launch_clusters(kernel, grid, kThreads, C::SMEM, stream, SPLIT, qt, kt, vt, ot, lse, o_part, ml_part,
                                  H, KV, Lq, Lk, scale, causal, has_window, window);
  } else {
    kernel<<<grid, kThreads, C::SMEM, stream>>>(qt, kt, vt, ot, lse, o_part, ml_part, H, KV, Lq, Lk, scale, causal,
                                                 has_window, window);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || parts == 1) return int(err);
  const int64_t n4 = rows * HD / 4, want = (n4 + 255) / 256;
  flash_fwd_tf32x3_combine<<<unsigned(want < 132 * 16 ? want : 132 * 16), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(o_part), ml_part, static_cast<float4*>(o), lse, rows, HD / 4, parts);
  return int(cudaGetLastError());
}

// route 2 (`tf32x3`): fp32 at hd 16 to 128; route 4 (`tf32x3_cluster`): fp32
// at hd 256, two blocks a q tile; route 3 (`tf32`): bf16 at hd 16, one part
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, float* scratch, int B, int H, int KV,
             int Lq, int Lk, int hd, int causal, int has_window, int window, int parts, int route, cudaStream_t stream) {
  if (parts < 1 || parts > 64 || (parts > 1 && scratch == nullptr) || int64_t(B) * H > 65535)
    return int(cudaErrorInvalidValue);
  if (route == 2) {
    switch (hd) {
      case 16: return launch<float, 16, 1>(q, k, v, o, lse, scratch, B, H, KV, Lq, Lk, causal, has_window, window, parts, stream);
      case 32: return launch<float, 32, 1>(q, k, v, o, lse, scratch, B, H, KV, Lq, Lk, causal, has_window, window, parts, stream);
      case 64: return launch<float, 64, 1>(q, k, v, o, lse, scratch, B, H, KV, Lq, Lk, causal, has_window, window, parts, stream);
      case 128: return launch<float, 128, 1>(q, k, v, o, lse, scratch, B, H, KV, Lq, Lk, causal, has_window, window, parts, stream);
      default: return int(cudaErrorInvalidValue);
    }
  }
  if (route == 4 && hd == 256)
    return launch<float, 256, 2>(q, k, v, o, lse, scratch, B, H, KV, Lq, Lk, causal, has_window, window, parts, stream);
  if (route == 3 && hd == 16 && parts == 1)
    return launch<__nv_bfloat16, 16, 1>(q, k, v, o, lse, scratch, B, H, KV, Lq, Lk, causal, has_window, window, 1, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace tf32x3

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 1 = wgmma (bfloat16, hd 32 to
// 256), 2 = tf32x3 (float32, hd 16 to 128), 3 = tf32 (bfloat16, hd 16),
// 4 = tf32x3_cluster (float32, hd 256).  has_window = 0 means no window
// mask.  lse: null, or B*H*Lq fp32 for each row's log-sum-exp in base 2.
// parts (tf32x3 and tf32x3_cluster only, else 1): blocks a q tile's k tiles
// are split across; with parts > 1, scratch is fp32 of parts*B*H*Lq*(hd +
// 2), else unused.  Returns cudaGetLastError() after the launch (0 on
// success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* scratch, int B,
                        int H, int KV, int Lq, int Lk, int hd, int causal, int has_window, int window, int parts,
                        int dtype, int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse2 = static_cast<float*>(lse);
  if (route == 1 && dtype == 1 && parts == 1)
    return dispatch_wgmma(q, k, v, o, lse2, B, H, KV, Lq, Lk, hd, causal, has_window, window, s);
  if (((route == 2 || route == 4) && dtype == 0) || (route == 3 && dtype == 1))
    return tf32x3::dispatch(q, k, v, o, lse2, static_cast<float*>(scratch), B, H, KV, Lq, Lk, hd, causal, has_window,
                            window, parts, route, s);
  return int(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
