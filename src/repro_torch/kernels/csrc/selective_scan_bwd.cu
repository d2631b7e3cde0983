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
// (libdevice, as torch.exp) each way.  As in the forward, the issue of
// instructions bounds it: three walks of ~10 to 25 instructions a
// (t, channel, state).
//
// What the design does about it:
//  * the forward's layout: a thread holds SPT = 4 of the N states of one
//    channel, TPC = NP/4 threads share a channel (N padded to a power of two
//    of at least 4), a block takes DC = 32 channels of one batch row, and
//    tiles of dt, x and dy and the rows of B and C arrive by cp.async in a
//    ring of NSTAGE stages of SEG steps, one mbarrier each;
//  * h_{t-1} without storing the chunk's states (B*chunk*di*N fp32, 134 MB
//    at falcon width, three times the bound's bytes): walk 1 runs the chunk
//    forward from h0 and keeps h at every segment's start (a per-call
//    scratch, each thread's own float4s); walk 2 takes the segments from the
//    last: it recomputes the segment's states into shared memory (SEG x NT
//    float4, 32 KB at N 16) and walks them in reverse.  So the states are
//    recomputed once and never inverted (h_{t-1} = (h_t - u_t) / e_t loses
//    everything where e_t underflows);
//  * the reductions: dx_t and ddt_t over a channel's TPC threads and dB_t,
//    dC_t over the channels of a warp by warp shuffles (each round keeps half
//    the values and sends the other half); over the warps of the block in
//    shared memory after each segment; over the di / DC blocks of a batch
//    row, and dA over the batch rows, in a second small launch
//    (selective_bwd_sum) that sums the blocks' partials in a fixed order.
//    No float atomics: two calls on the same operands are bit-equal;
//  * dx and ddt are staged in shared memory and stored one coalesced tile a
//    segment.
// Segments of SEG = 16 steps (8 at N 32, 4 at N 64) keep a block at ~79 KB
// of shared memory at N 16, two blocks an SM: the 256 blocks of the falcon
// width are resident at once.  Every byte of the scratch (the segment
// starts and the partials) is written before it is read, so it is not
// zeroed.  Ragged shapes: rows of any width and element alignment (di 45 or
// 50, bf16 x at an odd width) are copied by whole 16-byte chunks
// (hopper.cuh: copy_rows_async); channels past di read dt = x = dy = 0 and
// add nothing; the last segment walks only its own steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int DC = 32;      // channels per block
constexpr int SPT = 4;      // states per thread: one float4 of B, C and h
constexpr int NSTAGE = 4;   // segments in flight
constexpr int MAX_N = 64;
constexpr int SUM_W = 8;    // warps of a selective_bwd_sum block

// steps per segment: the segment's states take SEG x 32 x NP floats
__host__ __device__ constexpr int seg_of(int np) { return np <= 16 ? 16 : 256 / np; }
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
  static constexpr int RED = H + SEG * NT * 16;         // dB_t and dC_t summed over each warp's channels
  static constexpr int OUT = RED + SEG * NW * 2 * NP * 4;  // dx and ddt of the segment: 2 x SEG x DC
  static constexpr int BARS = OUT + 2 * SEG * DC * 4;
  static constexpr int BYTES = BARS + NSTAGE * 8;
  static_assert(NT % 32 == 0 && STAGE_BYTES % 16 == 0, "whole warps; 16-byte stages");
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

template <typename TX, int NP>
__global__ void __launch_bounds__(Smem<TX, NP>::NT)
selective_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ am, const float* __restrict__ h0,
                     const float* __restrict__ dy, const float* __restrict__ dh_last, TX* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dh0, float4* __restrict__ starts,
                     float* __restrict__ part, float* __restrict__ da_part, int chunk, int di, int N) {
  using S = Smem<TX, NP>;
  constexpr int TPC = S::TPC, NT = S::NT, NW = S::NW, SEG = S::SEG;
  extern __shared__ __align__(16) char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BARS);
  float4* hs = reinterpret_cast<float4*>(smem + S::H);
  float* red = reinterpret_cast<float*>(smem + S::RED);
  float* out = reinterpret_cast<float*>(smem + S::OUT);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ch = tid / TPC, q = tid % TPC, n0 = q * SPT;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, d0 = blk * DC, c = d0 + ch;
  const int valid = min(DC, di - d0);
  const bool live = ch < valid;
  const int nseg = (chunk + SEG - 1) / SEG, nload = 2 * nseg;

  const int64_t xrow0 = int64_t(b) * chunk * di + d0;  // element (b, 0, d0) of x, dt, dy, dx, ddt
  const int64_t brow0 = int64_t(b) * chunk * N;        // element (b, 0, 0) of B and C
  // load k of the ring: segment k of walk 1 (dt, x and B), then segment
  // 2 nseg - 1 - k of walk 2 (all five)
  auto issue = [&](int k) {
    const bool walk1 = k < nseg;
    const int seg = walk1 ? k : nload - 1 - k;
    char* st = smem + (k % NSTAGE) * S::STAGE_BYTES;
    const int t0 = seg * SEG, rows = min(SEG, chunk - t0);
    const int64_t xo = xrow0 + int64_t(t0) * di, bo = brow0 + int64_t(t0) * N;
    hopper::copy_rows_async<S::F_PITCH, NT>(st + S::DT, reinterpret_cast<const char*>(dt + xo), int64_t(di) * 4,
                                            rows, valid * 4, tid);
    hopper::copy_rows_async<S::X_PITCH, NT>(st + S::X, reinterpret_cast<const char*>(x + xo),
                                            int64_t(di) * int(sizeof(TX)), rows, valid * int(sizeof(TX)), tid);
    if (!walk1)
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
      if (!walk1) hopper::cp_async_4(c_t + e, cm + o, on ? 4 : 0);
    }
    hopper::cp_async_arrive(&bar[k % NSTAGE]);
  };

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) hopper::mbar_init(&bar[s], NT);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  for (int k = 0; k < NSTAGE && k < nload; ++k) issue(k);

  // this thread's states: A, h0, the gradient g and dA's sum; the padded
  // states (n >= N) and the channels past di hold 0 and add nothing
  float a[SPT], first[SPT], h[SPT], g[SPT], da[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const bool on = live && n0 + k < N;
    const int64_t o = (int64_t(b) * di + c) * N + n0 + k;
    a[k] = on ? am[int64_t(c) * N + n0 + k] : 0.f;
    first[k] = on ? h0[o] : 0.f;
    g[k] = on ? dh_last[o] : 0.f;
    h[k] = first[k];
    da[k] = 0.f;
  }
  float4* my_starts = starts + (int64_t(b) * nblk + blk) * nseg * NT + tid;
  // row i of a tile starts (head + i * step) % 16 bytes into its chunk
  const int f_step = (di * 4) & 15, x_step = (di * int(sizeof(TX))) & 15;
  struct Cols {
    const char *dt, *x, *dy;
    const float *b, *c;
    int dt_head, x_head, dy_head;
  };
  auto cols = [&](const char* st, int64_t xo) {
    return Cols{st + S::DT + ch * 4, st + S::X + ch * int(sizeof(TX)), st + S::DY + ch * 4,
                reinterpret_cast<const float*>(st + S::BT) + n0, reinterpret_cast<const float*>(st + S::CT) + n0,
                hopper::chunk_head(dt + xo), hopper::chunk_head(x + xo), hopper::chunk_head(dy + xo)};
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
  // one forward step of the thread's states
  auto step = [&](float* hv, const Cols& k, int i) {
    const float dtv = dt_at(k, i), dtx = dtv * x_at(k, i);
    const float4 bv = *reinterpret_cast<const float4*>(k.b + i * NP);
    const float bk[SPT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int j = 0; j < SPT; ++j) hv[j] = fmaf(expf(dtv * a[j]), hv[j], dtx * bk[j]);
  };

  // walk 1: the chunk forward from h0, keeping each segment's start
  for (int k = 0; k < nseg; ++k) {
    hopper::mbar_wait(&bar[k % NSTAGE], (k / NSTAGE) & 1);
    if (k > 0) my_starts[int64_t(k) * NT] = make_float4(h[0], h[1], h[2], h[3]);
    const int t0 = k * SEG, rows = min(SEG, chunk - t0);
    const Cols kc = cols(smem + (k % NSTAGE) * S::STAGE_BYTES, xrow0 + int64_t(t0) * di);
#pragma unroll 4
    for (int i = 0; i < rows; ++i) step(h, kc, i);
    __syncthreads();  // every thread is done with this stage
    if (k + NSTAGE < nload) issue(k + NSTAGE);
  }

  // walk 2: the segments from the last, each recomputed, then walked back
  using HeldQ = Held<2, 1, TPC / 2>;      // dx_t, ddt_t over a channel's threads
  using HeldC = Held<2 * SPT, TPC, 16>;   // dB_t, dC_t over a warp's channels
  for (int k = nseg; k < nload; ++k) {
    const int seg = nload - 1 - k;
    hopper::mbar_wait(&bar[k % NSTAGE], (k / NSTAGE) & 1);
    const int t0 = seg * SEG, rows = min(SEG, chunk - t0);
    const int64_t xo = xrow0 + int64_t(t0) * di;
    const Cols kc = cols(smem + (k % NSTAGE) * S::STAGE_BYTES, xo);
    float hp[SPT];  // the state before the segment
    if (seg == 0) {
#pragma unroll
      for (int j = 0; j < SPT; ++j) hp[j] = first[j];
    } else {
      const float4 v = my_starts[int64_t(seg) * NT];
      hp[0] = v.x, hp[1] = v.y, hp[2] = v.z, hp[3] = v.w;
    }
    // the segment's states h_t, each thread's own, into shared memory
    {
      float hv[SPT] = {hp[0], hp[1], hp[2], hp[3]};
#pragma unroll 4
      for (int i = 0; i < rows; ++i) {
        step(hv, kc, i);
        hs[i * NT + tid] = make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
    }
    float4 cur = hs[(rows - 1) * NT + tid];  // h_t
#pragma unroll 2
    for (int i = rows - 1; i >= 0; --i) {
      const float4 prev4 = i > 0 ? hs[(i - 1) * NT + tid] : make_float4(hp[0], hp[1], hp[2], hp[3]);
      const float hprev[SPT] = {prev4.x, prev4.y, prev4.z, prev4.w};
      const float hcur[SPT] = {cur.x, cur.y, cur.z, cur.w};
      const float dtv = dt_at(kc, i), xv = x_at(kc, i), dyv = dy_at(kc, i), dtx = dtv * xv;
      const float4 bv = *reinterpret_cast<const float4*>(kc.b + i * NP);
      const float4 cv = *reinterpret_cast<const float4*>(kc.c + i * NP);
      const float bk[SPT] = {bv.x, bv.y, bv.z, bv.w}, ck[SPT] = {cv.x, cv.y, cv.z, cv.w};
      float s1 = 0.f, s2 = 0.f, v[2 * SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float e = expf(dtv * a[j]);
        g[j] = fmaf(dyv, ck[j], g[j]);
        const float p = g[j] * e * hprev[j];  // the gradient reaching e_t, times e_t
        da[j] = fmaf(dtv, p, da[j]);
        s1 = fmaf(g[j], bk[j], s1);
        s2 = fmaf(a[j], p, s2);
        v[j] = g[j] * dtx;             // dB_t
        v[SPT + j] = dyv * hcur[j];    // dC_t
        g[j] *= e;
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
      cur = prev4;
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
    if (k + NSTAGE < nload) issue(k + NSTAGE);
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (n0 + k < N) {
        const int64_t o = (int64_t(b) * di + c) * N + n0 + k;
        dh0[o] = g[k];
        da_part[o] = da[k];
      }
    }
  }
}

// dB and dC: each (b, t, which, n) the sum of its nblk blocks' partials,
// warp w adding the blocks w, w + SUM_W, ... and the warps' sums added in
// order; dA: each (d, n) the sum over the batch rows in order.  The first
// n_grad blocks take 32 outputs of dB and dC each, the rest 32 x SUM_W of dA.
__global__ void __launch_bounds__(32 * SUM_W)
selective_bwd_sum(const float* __restrict__ part, const float* __restrict__ da_part, float* __restrict__ db,
                  float* __restrict__ dc, float* __restrict__ da, int B, int chunk, int N, int nblk, int di,
                  int n_grad) {
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
      for (int k = 0; k < B; ++k) s += da_part[int64_t(k) * di * N + o];
      da[o] = s;
    }
  }
}

struct Scratch {  // the per-call scratch: segment starts, then dB / dC partials, then dA partials
  int64_t starts, part, da_part, bytes;
};

int64_t pad16(int64_t n) { return (n + 15) / 16 * 16; }

int padded(int N) { return N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : N <= 32 ? 32 : 64; }

Scratch scratch_layout(int B, int chunk, int di, int N) {
  const int np = padded(N);
  const int64_t nblk = (di + DC - 1) / DC, nseg = (chunk + seg_of(np) - 1) / seg_of(np);
  Scratch s;
  s.starts = 0;
  s.part = s.starts + int64_t(B) * nblk * nseg * threads_of(np) * 16;
  s.da_part = s.part + pad16(int64_t(B) * nblk * chunk * 2 * N * 4);
  s.bytes = s.da_part + pad16(int64_t(B) * di * N * 4);
  return s;
}

template <typename TX, int NP>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const void* am, const void* h0,
           const void* dy, const void* dh_last, void* dx, void* ddt, void* db, void* dc, void* da, void* dh0,
           void* scratch, int B, int chunk, int di, int N, cudaStream_t s) {
  using S = Smem<TX, NP>;
  auto kernel = selective_bwd_kernel<TX, NP>;
  if (S::BYTES > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (err != cudaSuccess) return int(err);
    // all of the SM's unified memory as shared memory: two blocks fit only so
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, int(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return int(err);
  }
  const Scratch sl = scratch_layout(B, chunk, di, N);
  char* base = static_cast<char*>(scratch);
  float* part = reinterpret_cast<float*>(base + sl.part);
  float* da_part = reinterpret_cast<float*>(base + sl.da_part);
  const int nblk = (di + DC - 1) / DC;
  kernel<<<dim3(nblk, B), S::NT, S::BYTES, s>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(am), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last), static_cast<TX*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dh0), reinterpret_cast<float4*>(base + sl.starts), part, da_part,
      chunk, di, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int64_t n_grad = (int64_t(B) * chunk * 2 * N + 31) / 32;
  const int64_t n_da = (int64_t(di) * N + 32 * SUM_W - 1) / (32 * SUM_W);
  if (n_grad + n_da > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
  selective_bwd_sum<<<unsigned(n_grad + n_da), dim3(32, SUM_W), 0, s>>>(
      part, da_part, static_cast<float*>(db), static_cast<float*>(dc), static_cast<float*>(da), B, chunk, N, nblk, di,
      int(n_grad));
  return int(cudaGetLastError());
}

template <typename TX>
int launch_n(const void* x, const void* dt, const void* bm, const void* cm, const void* am, const void* h0,
             const void* dy, const void* dh_last, void* dx, void* ddt, void* db, void* dc, void* da, void* dh0,
             void* scratch, int B, int chunk, int di, int N, cudaStream_t s) {
#define SSB_ARGS x, dt, bm, cm, am, h0, dy, dh_last, dx, ddt, db, dc, da, dh0, scratch, B, chunk, di, N, s
  switch (padded(N)) {
    case 4: return launch<TX, 4>(SSB_ARGS);
    case 8: return launch<TX, 8>(SSB_ARGS);
    case 16: return launch<TX, 16>(SSB_ARGS);
    case 32: return launch<TX, 32>(SSB_ARGS);
    default: return launch<TX, 64>(SSB_ARGS);
  }
#undef SSB_ARGS
}

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
// 16-byte boundary; 1 <= N <= 64.  Two launches on `stream` (the walk, then
// the sums across blocks); returns cudaGetLastError() after them (0 on
// success).
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
  if (B > 65535) return int(cudaErrorInvalidConfiguration);
  if (x_dtype == 0)
    return launch_n<float>(x, dt, b, c, a, h0, dy, dh_last, dx, ddt, db, dc, da, dh0, scratch, B, chunk, di, N, s);
  return launch_n<__nv_bfloat16>(x, dt, b, c, a, h0, dy, dh_last, dx, ddt, db, dc, da, dh0, scratch, B, chunk, di,
                                 N, s);
}

const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
