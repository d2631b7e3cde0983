// Backward of the Mamba1 selective-scan chunk for Hopper (sm_90a).
//
// Replaces nothing on the TPU: the reference has no Pallas backward, and
// trains through XLA's autodiff of its plain chunked scan
// (src/repro/models/ssm.py:73-143, use_pallas=False).  This is the backward
// of the port's forward kernel (csrc/selective_scan.cu, which replaces
// `selective_scan_chunk` / `_scan_kernel`, src/repro/kernels/selective_scan.py,
// pallas_call at line 65), and computes the gradients autodiff computes.
//
// What it computes: the forward h_t = e_t h_{t-1} + (dt_t x_t) B_t with
// e_t = exp(dt_t A), y_t = <h_t, C_t>, from h0; for dy (B,chunk,di) and
// dh_last (B,di,N) a reverse-time walk from g = dh_last, for t from the
// chunk's end down to 0:
//   g += dy_t C_t                        (the gradient reaching h_t)
//   dx_t  = dt_t sum_n g B_t
//   ddt_t = sum_n g (A e_t h_{t-1} + x_t B_t)
//   dB_t  = sum_d g dt_t x_t,  dC_t = sum_d dy_t h_t
//   dA   += g dt_t e_t h_{t-1}  (summed over t and the batch rows)
//   g     = e_t g
// and dh0 = g after the walk.  dx in x's dtype (fp32 or bf16), the rest
// fp32.  N <= 64.
//
// What bounds it on this card: by bytes, x, dt and dy read and dx and ddt
// written (five (B,chunk,di) arrays) with B, C, dB, dC, A, dA, h0, dh_last
// and dh0: 44.5 MB, ~13 us at the falcon-mamba width (B 1, chunk 256, di
// 8192, N 16) with fp32 x.  The exponentials set a second floor: the walk
// needs e_t in both directions, B*chunk*di*N = 33.5 M accurate expf
// (libdevice, as torch.exp) each way.  In practice the issue of
// instructions bounds it: a thread's step (four states) is ~68
// instructions in pass A below, ~55 in the recompute and ~108 in the
// reverse step (9 shuffles), ~60 us at one instruction a clock on every
// scheduler, and with 16 warps an SM they issue at under half that rate.
//
// What the design does about it: the chunk is split in time.  B*di*N
// states are all one call offers across channels (131,072 at falcon
// width, 256 blocks of 4 warps: 8 warps an SM), so each chunk is cut into
// P parts of whole segments, one block each, P <= 8 blocks of a
// thread-block cluster (grid (P, di/32, B), cluster (P, 1, 1)); at falcon
// width on an H100's 132 SMs P = 2, 512 blocks, 16 warps an SM in one wave
// (plan_of).  The split is exact: a part p
// over steps [t_p, t_{p+1}) has, from zero,
//   F_p = its states at its end, D_p = prod_t e_t, and
//   L_p = sum_t (prod_{s <= t} e_s) dy_t C_t (its gradient at its start),
// and with H_0 = h0, H_{p+1} = D_p H_p + F_p (the state before part p + 1)
// and G_{P-1} = dh_last, G_{p-1} = D_p G_p + L_p (the gradient entering
// part p - 1 from its end), each part walks back exactly as one walk of the
// whole chunk would, from (H_p, G_p).  So a block
//  * pass A: walks its part forward once: F (from h0 in part 0, so that
//    part's F is H_1 and its segment starts are the forward's states), D
//    as the running product of the e_t, L by that product; one expf a
//    (step, channel, state); keeps each segment's F and the channel's sum
//    of dt since the part's start (a per-call scratch);
//  * the fold: writes F, L and D (3 float4 a thread) to its shared memory,
//    crosses a cluster barrier, reads the cluster's other blocks' through
//    distributed shared memory and folds H_p and G_p in the order above
//    (every block the same order: deterministic), and crosses a second
//    barrier before its shared memory is reused;
//  * pass B: takes its part's segments from the last, each recomputed from
//    its start (exp(A sum dt) H_p + F: the product of the e_t since the
//    part's start, in one expf) into shared memory with its e_t beside the
//    states (SEG x NT float4 each), then walked in reverse with no expf.
// With P = 1 (short chunks, or grids that fill the card alone) pass A is the
// forward walk from h0 and there is no fold.
// The rest is as before the split:
//  * the forward's layout: a thread holds SPT = 4 of the N states of one
//    channel, TPC = NP/4 threads share a channel (N padded to a power of two
//    of at least 4), a block takes DC = 32 channels of one batch row, and
//    tiles of dt, x, dy and the rows of B and C arrive by cp.async in a ring
//    of NSTAGE stages of SEG steps, one mbarrier each; pass B finds the
//    part's last NSTAGE segments still in the ring from pass A;
//  * the reductions: dx_t and ddt_t over a channel's TPC threads and dB_t,
//    dC_t over the channels of a warp by warp shuffles (each round keeps half
//    the values and sends the other half); over the warps of the block in
//    shared memory after each segment; over the di / DC blocks of a batch
//    row, and dA over the batch rows and parts, in a second small launch
//    (selective_bwd_sum) that sums the blocks' partials in a fixed order.
//    No float atomics: two calls on the same operands are bit-equal;
//  * dx and ddt are staged in shared memory and stored one coalesced tile a
//    segment.
// Segments of SEG = 8 steps (SEG x NP <= 128: 4 at N 32, 2 at 64) keep a
// block at ~56 KB of shared memory, four blocks (16 warps) an SM.  Every
// byte of the scratch (segment starts, dt sums, partials) is written before
// it is read, so it is not zeroed.  Ragged shapes: rows of any width and
// element alignment (di 45 or 50, bf16 x at an odd width) are copied by
// whole 16-byte chunks (hopper.cuh: copy_rows_async); channels past di read
// dt = x = dy = 0 and add nothing; the last part and the last segment walk
// only their own steps.
//
// Diagnostic builds (scripts/selective_bwd_timing.py; never the library the
// port loads): -DSSB_PHASES=1 runs pass A and the fold alone, 2 pass B
// alone (on whatever the scratch holds), each without the sums' launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#ifndef SSB_PHASES
#define SSB_PHASES 3
#endif

namespace {

constexpr int DC = 32;         // channels per block
constexpr int SPT = 4;         // states per thread: one float4 of B, C and h
constexpr int NSTAGE = 4;      // segments in the ring
constexpr int MAX_N = 64;
constexpr int MAX_PARTS = 8;   // the portable cluster size
constexpr int SUM_W = 8;       // warps of a selective_bwd_sum block

// steps per segment: the segment's states take SEG x 32 x NP floats
__host__ __device__ constexpr int seg_of(int np) { return np <= 16 ? 8 : 128 / np; }
__host__ __device__ constexpr int threads_of(int np) { return DC * np / SPT; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Shared-memory layout of one instance (NP = N padded, TX = x's type)
template <typename TX, int NP>
struct Smem {
  static constexpr int TPC = NP / SPT;                  // threads per channel
  static constexpr int NT = threads_of(NP);
  static constexpr int NW = NT / 32;                    // warps
  static constexpr int SEG = seg_of(NP);
  static constexpr int F_PITCH = DC * 4 + 16;           // a row of DC floats + the chunk head (dt, dy)
  static constexpr int X_PITCH = (DC * int(sizeof(TX)) + 31) / 16 * 16;
  static constexpr int BC_ROW = NP * 4;                 // a row of B (or C), zeros from N to NP
  static constexpr int DT = 0;
  static constexpr int X = DT + SEG * F_PITCH;
  static constexpr int DY = X + SEG * X_PITCH;
  static constexpr int BT = DY + SEG * F_PITCH;
  static constexpr int CT = BT + SEG * BC_ROW;
  static constexpr int STAGE_BYTES = CT + SEG * BC_ROW;
  static constexpr int H = NSTAGE * STAGE_BYTES;        // the segment's states h_t: SEG x NT float4
  static constexpr int E = H + SEG * NT * 16;           // their e_t
  static constexpr int RED = E + SEG * NT * 16;         // dB_t, dC_t summed over each warp's channels
  static constexpr int OUT = RED + SEG * NW * 2 * NP * 4;  // dx and ddt of the segment: 2 x SEG x DC
  static constexpr int BARS = OUT + 2 * SEG * DC * 4;
  static constexpr int BYTES = BARS + NSTAGE * 8;
  static constexpr int FOLD = H;                        // F, L, D: 3 x NT float4 over the states, before pass B
  static_assert(NT % 32 == 0 && STAGE_BYTES % 16 == 0, "whole warps; 16-byte stages");
  static_assert(FOLD + 3 * NT * 16 <= BARS, "the fold's three float4 a thread fit before the barriers");
};

// Sum CNT values v[] over the lanes that differ in the bits M, M/2, ...
// down to STOP: while a thread holds more than one value, each round it
// keeps half of them (the upper half if bit M of its lane is set), adds its
// partner's sums of those and sends the other half; then it adds plain
// pairs.  Returns the index of the first value the thread holds in v[0],
// v[1], ...
template <int M, int STOP, int CNT>
struct Halve {
  __device__ __forceinline__ static int run(float* v, int lane) {
    if constexpr (M < STOP || M == 0) {
      return 0;
    } else if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool upper = lane & M;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      return (upper ? H : 0) + Halve<M / 2, STOP, H>::run(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      return Halve<M / 2, STOP, 1>::run(v, lane);
    }
  }
};

// The bits LO, 2 LO, ..., HI (powers of two): how many
__host__ __device__ constexpr int n_bits(int lo, int hi) { return lo > hi ? 0 : 1 + n_bits(2 * lo, hi); }
__host__ __device__ constexpr int log2_of(int v) { return v <= 1 ? 0 : 1 + log2_of(v / 2); }

// What a lane holds after Halve<HI, LO, CNT>: COUNT values, and whether it
// is the lane that stores them.  The first rounds (the high bits) halve the
// values; once one is left, the rounds on the low bits add plain pairs, and
// of the lanes that did, the one with those bits 0 stores.
template <int CNT, int LO, int HI>
struct Held {
  static constexpr int R = n_bits(LO, HI);
  static constexpr int HALVINGS = R < log2_of(CNT) ? R : log2_of(CNT);
  static constexpr int COUNT = CNT >> HALVINGS;
  static constexpr int PLAIN_MASK = ((LO << (R - HALVINGS)) - 1) & ~(LO - 1);
  __device__ __forceinline__ static bool stores(int lane) { return (lane & PLAIN_MASK) == 0; }
};

__device__ __forceinline__ float4 f4(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ void unpack(float* v, float4 w) { v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w; }

// Grid (P, ceil(di / DC), B) in clusters of (P, 1, 1): block (p, blk, b)
// walks part p (segments [p spp, (p + 1) spp) of the chunk) of channels
// [blk DC, blk DC + DC) of batch row b.  AL: every row of dt, dy and x
// starts on a 16-byte boundary (di a multiple of 4, and of 8 with bf16 x),
// so a channel's column sits at the same place in every row of a tile.
// 512 threads an SM in the launch bounds cap a thread at 128 registers:
// four 128-thread blocks an SM at N 16.
template <typename TX, int NP, bool AL>
__global__ void __launch_bounds__(Smem<TX, NP>::NT, 512 / Smem<TX, NP>::NT)
selective_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ am, const float* __restrict__ h0,
                     const float* __restrict__ dy, const float* __restrict__ dh_last, TX* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dh0, float4* __restrict__ starts,
                     float* __restrict__ sdts, float* __restrict__ part, float* __restrict__ da_part, int chunk,
                     int di, int N, int spp) {
  using S = Smem<TX, NP>;
  constexpr int TPC = S::TPC, NT = S::NT, NW = S::NW, SEG = S::SEG;
  extern __shared__ __align__(16) char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BARS);
  float4* hs = reinterpret_cast<float4*>(smem + S::H);
  float4* es = reinterpret_cast<float4*>(smem + S::E);
  float* red = reinterpret_cast<float*>(smem + S::RED);
  float* out = reinterpret_cast<float*>(smem + S::OUT);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ch = tid / TPC, q = tid % TPC, n0 = q * SPT;
  // the cluster spans x, so a block's rank in it is blockIdx.x
  const int p = blockIdx.x, P = gridDim.x, blk = blockIdx.y, nblk = gridDim.y, b = blockIdx.z;
  const int d0 = blk * DC, c = d0 + ch;
  const int valid = min(DC, di - d0);
  const bool live = ch < valid;
  const int nseg = (chunk + SEG - 1) / SEG, seg0 = p * spp, t_lo = seg0 * SEG;
  const int nsp = min(spp, nseg - seg0);  // this part's segments, >= 1

  const int64_t xrow0 = int64_t(b) * chunk * di + d0;  // element (b, 0, d0) of x, dt, dy, dx, ddt
  const int64_t brow0 = int64_t(b) * chunk * N;        // element (b, 0, 0) of B and C
  // segment j of the part into stage j % NSTAGE: dt, x, dy, B and C
  auto issue = [&](int j) {
    char* st = smem + (j % NSTAGE) * S::STAGE_BYTES;
    const int t0 = t_lo + j * SEG, rows = min(SEG, chunk - t0);
    const int64_t xo = xrow0 + int64_t(t0) * di, bo = brow0 + int64_t(t0) * N;
    hopper::copy_rows_async<S::F_PITCH, NT>(st + S::DT, reinterpret_cast<const char*>(dt + xo), int64_t(di) * 4,
                                            rows, valid * 4, tid);
    hopper::copy_rows_async<S::X_PITCH, NT>(st + S::X, reinterpret_cast<const char*>(x + xo),
                                            int64_t(di) * int(sizeof(TX)), rows, valid * int(sizeof(TX)), tid);
    hopper::copy_rows_async<S::F_PITCH, NT>(st + S::DY, reinterpret_cast<const char*>(dy + xo), int64_t(di) * 4,
                                            rows, valid * 4, tid);
    // B and C element by element into rows of NP floats, zeros past N and
    // past the segment, so a thread reads its SPT states as one float4
    float* b_t = reinterpret_cast<float*>(st + S::BT);
    float* c_t = reinterpret_cast<float*>(st + S::CT);
    for (int e = tid; e < SEG * NP; e += NT) {
      const int r = e / NP, n = e % NP;
      const bool on = r < rows && n < N;
      const int64_t o = on ? bo + int64_t(r) * N + n : bo;
      hopper::cp_async_4(b_t + e, bm + o, on ? 4 : 0);
      hopper::cp_async_4(c_t + e, cm + o, on ? 4 : 0);
    }
    hopper::cp_async_arrive(&bar[j % NSTAGE]);
  };

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) hopper::mbar_init(&bar[s], NT);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  for (int j = 0; j < NSTAGE && j < nsp; ++j) issue(j);
  // every load into a stage is waited for once, in the order of the loads:
  // bit s is the parity of stage s's next completion
  uint32_t phase = 0;
  auto wait = [&](int j) {
    const int s = j % NSTAGE;
    hopper::mbar_wait(&bar[s], (phase >> s) & 1);
    phase ^= 1u << s;
  };

  // this thread's states: A, h0 and dh_last; the padded states (n >= N)
  // and the channels past di hold 0 and add nothing
  float a[SPT], first[SPT], g[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const bool on = live && n0 + k < N;
    const int64_t o = (int64_t(b) * di + c) * N + n0 + k;
    a[k] = on ? am[int64_t(c) * N + n0 + k] : 0.f;
    first[k] = on ? h0[o] : 0.f;
    g[k] = on ? dh_last[o] : 0.f;
  }
  const int64_t my_seg = (int64_t(b) * nblk + blk) * nseg + seg0;  // the part's first segment in the scratch
  float4* my_starts = starts + my_seg * NT + tid;
  float* my_sdt = sdts + my_seg * DC + ch;
  // row i of a tile starts (head + i * step) % 16 bytes into its chunk
  const int f_step = AL ? 0 : (di * 4) & 15, x_step = AL ? 0 : (di * int(sizeof(TX))) & 15;
  struct Cols {
    const char *dt, *x, *dy;
    const float *b, *c;
    int dt_head, x_head, dy_head;
  };
  auto cols = [&](int j) {
    const char* st = smem + (j % NSTAGE) * S::STAGE_BYTES;
    const int64_t xo = xrow0 + int64_t(t_lo + j * SEG) * di;
    return Cols{st + S::DT + ch * 4, st + S::X + ch * int(sizeof(TX)), st + S::DY + ch * 4,
                reinterpret_cast<const float*>(st + S::BT) + n0, reinterpret_cast<const float*>(st + S::CT) + n0,
                AL ? 0 : hopper::chunk_head(dt + xo), AL ? 0 : hopper::chunk_head(x + xo),
                AL ? 0 : hopper::chunk_head(dy + xo)};
  };
  // a channel past di reads 0: its smem column holds stale data
  auto dt_at = [&](const Cols& k, int i) {
    const float v = *reinterpret_cast<const float*>(k.dt + i * S::F_PITCH + ((k.dt_head + i * f_step) & 15));
    return live ? v : 0.f;
  };
  auto x_at = [&](const Cols& k, int i) {
    const float v = to_f32(*reinterpret_cast<const TX*>(k.x + i * S::X_PITCH + ((k.x_head + i * x_step) & 15)));
    return live ? v : 0.f;
  };
  auto dy_at = [&](const Cols& k, int i) {
    const float v = *reinterpret_cast<const float*>(k.dy + i * S::F_PITCH + ((k.dy_head + i * f_step) & 15));
    return live ? v : 0.f;
  };
  auto rows_of = [&](int j) { return min(SEG, chunk - (t_lo + j * SEG)); };

  // pass A: the part forward once.  F from h0 in part 0, else from 0; D the
  // product of the e_t; L the dy_t C_t weighted by that product; each
  // segment's F and the channel's sum of dt since the part's start kept
  float fw[SPT], lg[SPT], dk[SPT], sdt = 0.f;
#pragma unroll
  for (int k = 0; k < SPT; ++k) fw[k] = p == 0 ? first[k] : 0.f, lg[k] = 0.f, dk[k] = 1.f;
  for (int j = 0; j < nsp; ++j) {
    wait(j);
#if SSB_PHASES != 2
    if (j > 0) {
      my_starts[int64_t(j) * NT] = f4(fw);
      if (q == 0) my_sdt[j * DC] = sdt;
    }
    const Cols kc = cols(j);
    const int rows = rows_of(j);
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const float dtv = dt_at(kc, i), dtx = dtv * x_at(kc, i), dyv = dy_at(kc, i);
      const float4 bv = *reinterpret_cast<const float4*>(kc.b + i * NP);
      const float4 cv = *reinterpret_cast<const float4*>(kc.c + i * NP);
      const float bk[SPT] = {bv.x, bv.y, bv.z, bv.w}, ck[SPT] = {cv.x, cv.y, cv.z, cv.w};
      sdt += dtv;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const float e = expf(dtv * a[k]);
        fw[k] = fmaf(e, fw[k], dtx * bk[k]);
        dk[k] *= e;
        lg[k] = fmaf(dk[k], dyv * ck[k], lg[k]);
      }
    }
#endif
    __syncthreads();  // every thread is done with this stage
    if (j + NSTAGE < nsp) issue(j + NSTAGE);
  }

  // the fold: H (the state before this part) and G (the gradient entering
  // it from its end) from the cluster's parts, in the order of the parts
  float hp0[SPT];  // H
#pragma unroll
  for (int k = 0; k < SPT; ++k) hp0[k] = first[k];
#if SSB_PHASES != 2
  if (P > 1) {
    float4* fold = reinterpret_cast<float4*>(smem + S::FOLD);  // [F | L | D] x NT
    fold[tid] = f4(fw);
    fold[NT + tid] = f4(lg);
    fold[2 * NT + tid] = f4(dk);
    hopper::cluster_sync();
    const uint32_t mine = hopper::smem_u32(fold + tid);
    auto peer = [&](int r, int which, float* v) {
      unpack(v, hopper::ld_cluster_v4(hopper::map_rank(mine + which * NT * 16, uint32_t(r))));
    };
    float f[SPT], d[SPT], l[SPT];
    if (p > 0) {
      peer(0, 0, hp0);  // part 0 walked from h0: its F is H_1
      for (int r = 1; r < p; ++r) {
        peer(r, 0, f);
        peer(r, 2, d);
#pragma unroll
        for (int k = 0; k < SPT; ++k) hp0[k] = fmaf(d[k], hp0[k], f[k]);
      }
    }
    for (int r = P - 1; r > p; --r) {
      peer(r, 1, l);
      peer(r, 2, d);
#pragma unroll
      for (int k = 0; k < SPT; ++k) g[k] = fmaf(d[k], g[k], l[k]);
    }
    hopper::cluster_sync();  // every block has read the others' F, L and D
  }
#endif
#if SSB_PHASES == 1
  if (live) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (n0 + k < N) {
        const int64_t o = ((int64_t(b) * P + p) * di + c) * N + n0 + k;
        da_part[o] = hp0[k] + g[k];
      }
    }
  }
  return;
#endif

  // pass B: the part's segments from the last, each recomputed from its
  // start into shared memory (h_t and e_t), then walked back
  using HeldQ = Held<2, 1, TPC / 2>;      // dx_t, ddt_t over a channel's threads
  using HeldC = Held<2 * SPT, TPC, 16>;   // dB_t, dC_t over a warp's channels
  float da[SPT] = {0.f, 0.f, 0.f, 0.f};
  for (int j = nsp - 1; j >= 0; --j) {
    if (j < nsp - NSTAGE) wait(j);  // the last NSTAGE segments are in the ring since pass A
    const int t0 = t_lo + j * SEG, rows = rows_of(j);
    const int64_t xo = xrow0 + int64_t(t0) * di;
    const Cols kc = cols(j);
    float hp[SPT];  // the state before the segment
    if (j == 0) {
#pragma unroll
      for (int k = 0; k < SPT; ++k) hp[k] = hp0[k];
    } else {
      unpack(hp, my_starts[int64_t(j) * NT]);
      if (p > 0) {  // F from 0, plus H carried over the part's steps so far
        const float s = my_sdt[j * DC];
#pragma unroll
        for (int k = 0; k < SPT; ++k) hp[k] = fmaf(expf(a[k] * s), hp0[k], hp[k]);
      }
    }
    // the segment's states h_t and their e_t, each thread's own, into shared memory
    {
      float hv[SPT] = {hp[0], hp[1], hp[2], hp[3]};
#pragma unroll 4
      for (int i = 0; i < rows; ++i) {
        const float dtv = dt_at(kc, i), dtx = dtv * x_at(kc, i);
        const float4 bv = *reinterpret_cast<const float4*>(kc.b + i * NP);
        const float bk[SPT] = {bv.x, bv.y, bv.z, bv.w};
        float ev[SPT];
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          ev[k] = expf(dtv * a[k]);
          hv[k] = fmaf(ev[k], hv[k], dtx * bk[k]);
        }
        hs[i * NT + tid] = f4(hv);
        es[i * NT + tid] = f4(ev);
      }
    }
    // one step back: h_t (cur4) and h_{t-1} (prev4) of step i
    auto back = [&](int i, float4 cur4, float4 prev4) {
      const float hprev[SPT] = {prev4.x, prev4.y, prev4.z, prev4.w};
      const float hcur[SPT] = {cur4.x, cur4.y, cur4.z, cur4.w};
      const float dtv = dt_at(kc, i), xv = x_at(kc, i), dyv = dy_at(kc, i), dtx = dtv * xv;
      const float4 bv = *reinterpret_cast<const float4*>(kc.b + i * NP);
      const float4 cv = *reinterpret_cast<const float4*>(kc.c + i * NP);
      const float bk[SPT] = {bv.x, bv.y, bv.z, bv.w}, ck[SPT] = {cv.x, cv.y, cv.z, cv.w};
      float ev[SPT];
      unpack(ev, es[i * NT + tid]);
      float s1 = 0.f, s2 = 0.f, v[2 * SPT];
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const float e = ev[k];
        g[k] = fmaf(dyv, ck[k], g[k]);
        const float pe = g[k] * e * hprev[k];  // the gradient reaching e_t, times e_t
        da[k] = fmaf(dtv, pe, da[k]);
        s1 = fmaf(g[k], bk[k], s1);
        s2 = fmaf(a[k], pe, s2);
        v[k] = g[k] * dtx;             // dB_t
        v[SPT + k] = dyv * hcur[k];    // dC_t
        g[k] *= e;
      }
      // dx_t = dt_t sum_n g B, ddt_t = sum_n A p + x_t sum_n g B, over the channel's threads
      float w[2] = {dtv * s1, fmaf(xv, s1, s2)};
      const int fq = Halve<TPC / 2, 1, 2>::run(w, lane);
      if (HeldQ::stores(lane)) {
#pragma unroll
        for (int r = 0; r < HeldQ::COUNT; ++r) out[((fq + r) * SEG + i) * DC + ch] = w[r];
      }
      // dB_t and dC_t of this thread's states, over the warp's channels
      const int fc = Halve<16, TPC, 2 * SPT>::run(v, lane);
      if (HeldC::stores(lane)) {
#pragma unroll
        for (int r = 0; r < HeldC::COUNT; ++r) {
          const int idx = fc + r;  // (which, state) = (idx / SPT, idx % SPT)
          red[((i * NW + warp) * 2 + idx / SPT) * NP + n0 + idx % SPT] = v[r];
        }
      }
    };
    // two steps a turn, so that the two steps' shuffle trees, independent
    // of each other, interleave (an odd segment takes its last step alone)
    int t = rows - 1;
    float4 cur = hs[t * NT + tid];  // h_t
    if (rows & 1) {
      const float4 prev4 = t > 0 ? hs[(t - 1) * NT + tid] : f4(hp);
      back(t, cur, prev4);
      cur = prev4;
      --t;
    }
    for (; t > 0; t -= 2) {
      const float4 mid4 = hs[(t - 1) * NT + tid];
      const float4 low4 = t > 1 ? hs[(t - 2) * NT + tid] : f4(hp);
      back(t, cur, mid4);
      back(t - 1, mid4, low4);
      cur = low4;
    }
    __syncthreads();  // the segment's dx, ddt and warp sums are in shared memory
    for (int e = tid; e < rows * DC; e += NT) {
      const int i = e / DC, cc = e % DC;
      if (cc < valid) {
        store(dx + xo + int64_t(i) * di + cc, out[i * DC + cc]);
        ddt[xo + int64_t(i) * di + cc] = out[(SEG + i) * DC + cc];
      }
    }
    // the block's dB_t and dC_t: the warps' sums added in order
    float* pp = part + ((int64_t(b) * nblk + blk) * chunk + t0) * 2 * N;
    for (int e = tid; e < rows * 2 * NP; e += NT) {
      const int i = e / (2 * NP), wn = e % (2 * NP), n = wn % NP;
      if (n < N) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) s += red[(i * NW + w) * 2 * NP + wn];
        pp[(int64_t(i) * 2 + wn / NP) * N + n] = s;
      }
    }
    __syncthreads();  // every thread is done with this stage, the states and the sums
    if (j >= NSTAGE) issue(j - NSTAGE);
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (n0 + k < N) {
        const int64_t o = (int64_t(b) * di + c) * N + n0 + k;
        if (p == 0) dh0[o] = g[k];
        da_part[((int64_t(b) * P + p) * di + c) * N + n0 + k] = da[k];
      }
    }
  }
}

// dB and dC: each (b, t, which, n) the sum of its nblk blocks' partials,
// warp w adding the blocks w, w + SUM_W, ... and the warps' sums added in
// order; dA: each (d, n) the sum over the batch rows' parts in order.  The
// first n_grad blocks take 32 outputs of dB and dC each, the rest 32 x
// SUM_W of dA.
__global__ void __launch_bounds__(32 * SUM_W)
selective_bwd_sum(const float* __restrict__ part, const float* __restrict__ da_part, float* __restrict__ db,
                  float* __restrict__ dc, float* __restrict__ da, int B, int chunk, int N, int nblk, int di,
                  int n_da, int n_grad) {
  __shared__ float acc[SUM_W][32];
  const int lane = threadIdx.x, w = threadIdx.y;
  if (int(blockIdx.x) < n_grad) {
    const int64_t R = int64_t(chunk) * 2 * N;  // a block's partials of one batch row: (t, which, n)
    const int64_t o = int64_t(blockIdx.x) * 32 + lane;
    const bool on = o < B * R;
    const int64_t bb = on ? o / R : 0, r = on ? o % R : 0;
    float s = 0.f;
    if (on) {
      const float* p = part + bb * nblk * R + r;
      for (int k = w; k < nblk; k += SUM_W) s += p[int64_t(k) * R];
    }
    acc[w][lane] = s;
    __syncthreads();
    if (w == 0 && on) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < SUM_W; ++k) t += acc[k][lane];
      const int64_t step = r / (2 * N), n = r % N;
      ((r / N) % 2 ? dc : db)[(bb * chunk + step) * N + n] = t;
    }
  } else {
    const int64_t o = (int64_t(blockIdx.x) - n_grad) * 32 * SUM_W + w * 32 + lane;
    if (o < int64_t(di) * N) {
      float s = 0.f;
      for (int k = 0; k < n_da; ++k) s += da_part[int64_t(k) * di * N + o];
      da[o] = s;
    }
  }
}

int padded(int N) { return N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : N <= 32 ? 32 : 64; }

int n_segs(int chunk, int N) { return (chunk + seg_of(padded(N)) - 1) / seg_of(padded(N)); }

// How a call is cut: P parts of spp segments each (the last may hold fewer
// or a shorter segment).  P is the largest power of two, at most MAX_PARTS
// and the chunk's segments, whose grid still fits one wave, the `wave`
// blocks the device holds at once (1 where the grid fills it alone): at
// falcon width on an H100's 132 SMs, four blocks each, 2 parts, 512 blocks
// of 4 warps.  Blocks of equal work run in waves that start together, and
// each wave waits on its first loads: more parts than one wave cost more
// than the warps they add (PERF.md section 6, PR 25's P sweep).
struct Plan {
  int parts, spp, nseg, nblk;
};

Plan plan_of(int B, int chunk, int di, int N, int64_t wave) {
  Plan pl;
  pl.nseg = n_segs(chunk, N);
  pl.nblk = (di + DC - 1) / DC;
  int want = 1;
  const int64_t grid = int64_t(pl.nblk) * B;
  while (want < MAX_PARTS && grid * want * 2 <= wave) want *= 2;
  want = min(want, pl.nseg);
  pl.spp = (pl.nseg + want - 1) / want;
  pl.parts = (pl.nseg + pl.spp - 1) / pl.spp;  // every part holds a segment
  return pl;
}

struct Scratch {  // the per-call scratch: segment starts, dt sums, dB / dC partials, dA partials
  int64_t starts, sdts, part, da_part, bytes;
};

int64_t pad16(int64_t n) { return (n + 15) / 16 * 16; }

// dA's partials are sized for the most parts a chunk can take, so that the
// size does not depend on the device
Scratch scratch_layout(int B, int chunk, int di, int N) {
  const int nseg = n_segs(chunk, N), nblk = (di + DC - 1) / DC;
  const int64_t segs = int64_t(B) * nblk * nseg;
  Scratch s;
  s.starts = 0;
  s.sdts = s.starts + segs * threads_of(padded(N)) * 16;
  s.part = s.sdts + pad16(segs * DC * 4);
  s.da_part = s.part + pad16(int64_t(B) * nblk * chunk * 2 * N * 4);
  s.bytes = s.da_part + pad16(int64_t(B) * min(MAX_PARTS, nseg) * di * N * 4);
  return s;
}

// Set the walk's shared-memory attributes and plan the call on `device`
// from its SMs and the occupancy calculator's blocks an SM (*per_sm).
template <typename TX, int NP, bool AL>
cudaError_t prepare(int B, int chunk, int di, int N, int device, Plan* pl, int* per_sm) {
  using S = Smem<TX, NP>;
  auto kernel = selective_bwd_kernel<TX, NP, AL>;
  cudaError_t err = cudaSuccess;
  if (S::BYTES > 48 * 1024) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  // all of the SM's unified memory as shared memory: four blocks fit only so
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, int(cudaSharedmemCarveoutMaxShared));
  int sms = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, S::NT, S::BYTES);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  *pl = plan_of(B, chunk, di, N, int64_t(sms) * *per_sm);
  return cudaSuccess;
}

template <typename TX, int NP, bool AL>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const void* am, const void* h0,
           const void* dy, const void* dh_last, void* dx, void* ddt, void* db, void* dc, void* da, void* dh0,
           void* scratch, int B, int chunk, int di, int N, int device, cudaStream_t s) {
  using S = Smem<TX, NP>;
  Plan pl;
  int per_sm = 0;
  cudaError_t err = prepare<TX, NP, AL>(B, chunk, di, N, device, &pl, &per_sm);
  if (err != cudaSuccess) return int(err);
  const Scratch sl = scratch_layout(B, chunk, di, N);
  char* base = static_cast<char*>(scratch);
  float* part = reinterpret_cast<float*>(base + sl.part);
  float* da_part = reinterpret_cast<float*>(base + sl.da_part);
  // no fallback: a refused cluster launch returns its error
  err = hopper::launch_clusters(
      selective_bwd_kernel<TX, NP, AL>, dim3(pl.parts, pl.nblk, B), S::NT, S::BYTES, s, unsigned(pl.parts),
      static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(am), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last), static_cast<TX*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dh0), reinterpret_cast<float4*>(base + sl.starts),
      reinterpret_cast<float*>(base + sl.sdts), part, da_part, chunk, di, N, pl.spp);
  if (err != cudaSuccess) return int(err);
  err = cudaGetLastError();
  if (err != cudaSuccess || SSB_PHASES != 3) return int(err);
  const int64_t n_grad = (int64_t(B) * chunk * 2 * N + 31) / 32;
  const int64_t n_da = (int64_t(di) * N + 32 * SUM_W - 1) / (32 * SUM_W);
  if (n_grad + n_da > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  selective_bwd_sum<<<unsigned(n_grad + n_da), dim3(32, SUM_W), 0, s>>>(
      part, da_part, static_cast<float*>(db), static_cast<float*>(dc), static_cast<float*>(da), B, chunk, N, pl.nblk,
      di, B * pl.parts, int(n_grad));
  return int(cudaGetLastError());
}

// What the occupancy calculator says of the walk's launch at (B, chunk, di,
// N): out[0] parts P, [1] blocks, [2] threads a block, [3] dynamic shared
// memory a block, [4] blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// [5] warps an SM, [6] clusters resident at once (cudaOccupancyMaxActiveClusters),
// [7] steps a segment.
template <typename TX, int NP, bool AL>
int describe(int B, int chunk, int di, int N, int device, long long* out) {
  using S = Smem<TX, NP>;
  Plan pl;
  int per_sm = 0, clusters = 0;
  cudaError_t err = prepare<TX, NP, AL>(B, chunk, di, N, device, &pl, &per_sm);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.parts, pl.nblk, B);
  cfg.blockDim = dim3(S::NT);
  cfg.dynamicSmemBytes = S::BYTES;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&clusters, selective_bwd_kernel<TX, NP, AL>, &cfg);
  if (err != cudaSuccess) return int(err);
  const long long vals[8] = {pl.parts, int64_t(pl.parts) * pl.nblk * B, S::NT, S::BYTES, per_sm, per_sm * S::NT / 32,
                             clusters, S::SEG};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

#define SSB_BY_N(FN, TX, AL, ...)                  \
  switch (padded(N)) {                             \
    case 4: return FN<TX, 4, AL>(__VA_ARGS__);     \
    case 8: return FN<TX, 8, AL>(__VA_ARGS__);     \
    case 16: return FN<TX, 16, AL>(__VA_ARGS__);   \
    case 32: return FN<TX, 32, AL>(__VA_ARGS__);   \
    default: return FN<TX, 64, AL>(__VA_ARGS__);   \
  }
#define SSB_BY_N_AL(FN, TX, ...)                   \
  if (aligned_rows<TX>(di)) {                      \
    SSB_BY_N(FN, TX, true, __VA_ARGS__)            \
  } else {                                         \
    SSB_BY_N(FN, TX, false, __VA_ARGS__)           \
  }

// every row of dt, dy (fp32) and x (TX) on a 16-byte boundary; the path
// that computes no row's offset in its 16-byte chunk
template <typename TX>
bool aligned_rows(int di) {
  return di % 4 == 0 && (di * int(sizeof(TX))) % 16 == 0;
}

template <typename TX>
int launch_n(const void* x, const void* dt, const void* bm, const void* cm, const void* am, const void* h0,
             const void* dy, const void* dh_last, void* dx, void* ddt, void* db, void* dc, void* da, void* dh0,
             void* scratch, int B, int chunk, int di, int N, int device, cudaStream_t s) {
  SSB_BY_N_AL(launch, TX, x, dt, bm, cm, am, h0, dy, dh_last, dx, ddt, db, dc, da, dh0, scratch, B, chunk, di, N,
              device, s)
}

template <typename TX>
int describe_n(int B, int chunk, int di, int N, int device, long long* out) {
  SSB_BY_N_AL(describe, TX, B, chunk, di, N, device, out)
}

#undef SSB_BY_N_AL
#undef SSB_BY_N

}  // namespace

extern "C" {

// Bytes of the per-call scratch `selective_scan_bwd` takes.
long long selective_scan_bwd_scratch_bytes(int B, int chunk, int di, int N) {
  if (N < 1 || N > MAX_N) return 0;
  return scratch_layout(B, chunk, di, N).bytes;
}

// x (B,chunk,di) fp32 (x_dtype 0) or bf16 (1); dt, dy (B,chunk,di), b and c
// (B,chunk,N), a (di,N), h0 and dh_last (B,di,N) fp32 in; dx (B,chunk,di)
// in x's dtype, ddt (B,chunk,di), db and dc (B,chunk,N), da (di,N), dh0
// (B,di,N) fp32 out; all contiguous, every operand on a 16-byte boundary;
// scratch of selective_scan_bwd_scratch_bytes(B, chunk, di, N) bytes on a
// 16-byte boundary; 1 <= N <= 64.  Two launches on `stream` (the walk, in
// clusters of its parts, then the sums across blocks); returns
// cudaGetLastError() after them (0 on success), or the error of a refused
// cluster launch.
int selective_scan_bwd(const void* x, const void* dt, const void* b, const void* c, const void* a, const void* h0,
                       const void* dy, const void* dh_last, void* dx, void* ddt, void* db, void* dc, void* da,
                       void* dh0, void* scratch, int B, int chunk, int di, int N, int x_dtype, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (N < 1 || N > MAX_N || (x_dtype != 0 && x_dtype != 1)) return int(cudaErrorInvalidValue);
  if (di == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || chunk == 0) {  // no step: dA is 0 and dh0 is dh_last
    err = cudaMemsetAsync(da, 0, size_t(di) * N * 4, s);
    if (err != cudaSuccess || B == 0) return int(err);
    return int(cudaMemcpyAsync(dh0, dh_last, size_t(B) * di * N * 4, cudaMemcpyDeviceToDevice, s));
  }
  if (B > 65535 || (di + DC - 1) / DC > 65535) return int(cudaErrorInvalidConfiguration);
  if (x_dtype == 0)
    return launch_n<float>(x, dt, b, c, a, h0, dy, dh_last, dx, ddt, db, dc, da, dh0, scratch, B, chunk, di, N,
                           device, s);
  return launch_n<__nv_bfloat16>(x, dt, b, c, a, h0, dy, dh_last, dx, ddt, db, dc, da, dh0, scratch, B, chunk, di,
                                 N, device, s);
}

// The walk's launch at (B, chunk, di, N, x_dtype) on `device`, as `describe`
// writes it into out[8]: parts, blocks, threads, shared memory, blocks and
// warps an SM, resident clusters, steps a segment.  Returns 0 or a CUDA error.
int selective_scan_bwd_describe(int B, int chunk, int di, int N, int x_dtype, int device, long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (B < 1 || chunk < 1 || di < 1 || N < 1 || N > MAX_N || (x_dtype != 0 && x_dtype != 1))
    return int(cudaErrorInvalidValue);
  if (x_dtype == 0) return describe_n<float>(B, chunk, di, N, device, out);
  return describe_n<__nv_bfloat16>(B, chunk, di, N, device, out);
}

const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
