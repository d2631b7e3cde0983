// Mamba1 selective-scan chunk for Hopper (sm_90a).
//
// Replaces the TPU kernel `selective_scan_chunk` / `_scan_kernel` in
// src/repro/kernels/selective_scan.py (pallas_call at line 65).
//
// What it computes: one sequence chunk of the diagonal SSM recurrence
//
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   y_t = <h_t, C_t>
//
// for x (B,chunk,di) in fp32 or bf16, dt (B,chunk,di), B and C (B,chunk,N),
// A (di,N) and h0 (B,di,N) in fp32; it returns y (B,chunk,di) and the last
// state h_last (B,di,N), both fp32, so chunks chain through h0.  N <= 64.
//
// What bounds it on this card: ~6 operations per (t, channel, state) on
// ~12 bytes per (t, channel): by bytes 26.8 MB, ~8 us at the falcon-mamba
// width (B 1, chunk 256, di 8192, N 16).  The exponentials set a second
// floor: B*chunk*di*N = 33.5 M accurate expf (libdevice, as torch.exp; an
// approximate exp's error would be carried forward by the recurrence), each
// one MUFU.EX2 at 16 a clock per SM plus its range reduction, ~15 us.  In
// practice the issue of instructions bounds it: an accurate expf is nine
// instructions, and the work per SM is fixed at 64 channels of 16 states
// (eight warps), whose dependent steps the scheduler can only partly hide.
//
// What the design does about it:
//  * it runs over (channel, state): a thread holds SPT = 4 of the N states
//    of one channel, TPC = N/4 threads share a channel (N padded to a power
//    of two of at least 4), and y_t = sum_n h_t[n] C_t[n] is reduced across
//    those threads by warp shuffles.  The 131,072 recurrences at the model
//    width fill the card, so the chunk stays one walk inside the block;
//  * a block takes DC channels of one batch row (32 by default; the knob the
//    reference's block_d sets for fp32 x, 8, 16, 32 or 64, one instance
//    each: kernels/selective_scan.py: tile, whose Python mirror of Smem
//    below is smem_bytes; a variant changes which channels a block holds,
//    not any channel's arithmetic, so every variant gives the same bits).
//    The tiles of dt and
//    x for its channels, and the rows of B and C (shared by every channel
//    of the block, loaded once per tile), arrive by cp.async in a ring of
//    NSTAGE stages of STAGE steps, one mbarrier each.  B and C land element
//    by element in rows of NP floats, zero past N, so a thread reads its
//    four states' B and C as one float4 each and a padded state reads 0;
//  * for each group of four steps, exp(dt_t * A) and (dt_t x_t) B_t are
//    computed first, so the step-to-step chain of each state is one FMA; a
//    group that lies inside the tile (all but the last tile's tail) runs
//    with no test and no branch;
//  * y is staged in shared memory (two tiles, alternating) and stored one
//    coalesced tile at a time.
// x is converted to fp32 on load.  Ragged shapes: rows of any width and
// element alignment (di = 50, bf16 x at an odd width) are copied by whole
// 16-byte chunks, zero-filled past the row's end (hopper.cuh:
// copy_rows_async); channels past di are not stored and the last tile walks
// only its own steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int SPT = 4;      // states per thread: one float4 of B and of C
constexpr int STAGE = 64;   // steps per tile
constexpr int NSTAGE = 2;   // tiles in flight
constexpr int GROUP = 16;   // steps whose exponentials are computed together
constexpr int MAX_N = 64;
static_assert(SPT == 4 && STAGE % GROUP == 0, "float4 states; whole groups in a tile");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Shared-memory layout of one instance (NP = N padded, TX = x's type, DC
// channels a block)
template <typename TX, int NP, int DC>
struct Smem {
  static constexpr int TPC = NP / SPT;                  // threads per channel
  static constexpr int THREADS = DC * TPC;
  static_assert(THREADS <= 512, "a block's threads (kernels/selective_scan.py: MAX_THREADS)");
  // the lanes of a warp that exist: a block of 8 channels of 8 states has 16
  static constexpr unsigned LANES = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  static constexpr int DT_PITCH = DC * 4 + 16;          // a row of DC floats + the chunk head
  static constexpr int X_PITCH = (DC * int(sizeof(TX)) + 31) / 16 * 16;
  static constexpr int BC_ROW = NP * 4;                 // a row of B (or C), zeros from N to NP
  static constexpr int DT = 0;
  static constexpr int X = DT + STAGE * DT_PITCH;
  static constexpr int BT = X + STAGE * X_PITCH;
  static constexpr int CT = BT + STAGE * BC_ROW;
  static constexpr int STAGE_BYTES = CT + STAGE * BC_ROW;
  static constexpr int Y = NSTAGE * STAGE_BYTES;        // y: two tiles of STAGE x DC floats
  static constexpr int BARS = Y + 2 * STAGE * DC * 4;
  static constexpr int BYTES = BARS + NSTAGE * 8;
};

// Sum the GROUP values v[] (one a step) over the TPC threads of a channel,
// rounds M = TPC/2 down to 1: while a thread holds more than one step, each
// round it keeps half of them (the upper half if bit M of its index q is
// set), adds its partner's sums of those, and sends the other half; then
// it adds plain pairs.  Returns the first step whose sum the thread holds
// in v[0], v[1], ...  Fewer shuffles than a butterfly over every step.
// LANES: the warp's lanes that exist (a block of fewer than 32 threads).
template <int M, int CNT, unsigned LANES>
struct Halve {
  __device__ __forceinline__ static int run(float* v, int q) {
    if constexpr (M == 0) {
      return 0;
    } else if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool upper = q & M;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(LANES, send, M);
      }
      return (upper ? H : 0) + Halve<M / 2, H, LANES>::run(v, q);
    } else {
      v[0] += __shfl_xor_sync(LANES, v[0], M);
      return Halve<M / 2, 1, LANES>::run(v, q);
    }
  }
};

template <typename TX, int NP, int DC>
__global__ void __launch_bounds__(Smem<TX, NP, DC>::THREADS)
scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ bm,
            const float* __restrict__ cm, const float* __restrict__ am, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ h_last, int chunk, int di, int N) {
  using S = Smem<TX, NP, DC>;
  constexpr int TPC = S::TPC, NT = S::THREADS;
  extern __shared__ __align__(16) char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BARS);
  float* y_s = reinterpret_cast<float*>(smem + S::Y);

  const int tid = threadIdx.x;
  const int ch = tid / TPC, q = tid % TPC, n0 = q * SPT;
  const int b = blockIdx.y, d0 = blockIdx.x * DC, c = d0 + ch;
  const int valid = min(DC, di - d0);
  const bool live = ch < valid;
  const int n_tiles = (chunk + STAGE - 1) / STAGE;

  const int64_t xrow0 = int64_t(b) * chunk * di + d0;  // element (b, 0, d0) of x, dt and y
  const int64_t brow0 = int64_t(b) * chunk * N;        // element (b, 0, 0) of B and C
  auto issue = [&](int tile) {
    char* st = smem + (tile % NSTAGE) * S::STAGE_BYTES;
    const int t0 = tile * STAGE, rows = min(STAGE, chunk - t0);
    const int64_t xo = xrow0 + int64_t(t0) * di, bo = brow0 + int64_t(t0) * N;
    hopper::copy_rows_async<S::DT_PITCH, NT>(st + S::DT, reinterpret_cast<const char*>(dt + xo), int64_t(di) * 4,
                                             rows, valid * 4, tid);
    hopper::copy_rows_async<S::X_PITCH, NT>(st + S::X, reinterpret_cast<const char*>(x + xo),
                                            int64_t(di) * int(sizeof(TX)), rows, valid * int(sizeof(TX)), tid);
    // B and C element by element into rows of NP floats, zeros past N and
    // past the tile, so a thread reads its SPT states as one float4
    float* b_t = reinterpret_cast<float*>(st + S::BT);
    float* c_t = reinterpret_cast<float*>(st + S::CT);
    for (int e = tid; e < STAGE * NP; e += NT) {
      const int r = e / NP, n = e % NP;
      const bool on = r < rows && n < N;
      const int64_t o = on ? bo + int64_t(r) * N + n : bo;
      hopper::cp_async_4(b_t + e, bm + o, on ? 4 : 0);
      hopper::cp_async_4(c_t + e, cm + o, on ? 4 : 0);
    }
    hopper::cp_async_arrive(&bar[tile % NSTAGE]);
  };

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) hopper::mbar_init(&bar[s], NT);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  for (int tile = 0; tile < NSTAGE && tile < n_tiles; ++tile) issue(tile);

  // this thread's states: A and h; the padded ones (n >= N) have A = 0 and
  // read B = C = 0, so they stay 0 and add nothing to y
  float a[SPT], h[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const bool on = live && n0 + k < N;
    a[k] = on ? am[int64_t(c) * N + n0 + k] : 0.f;
    h[k] = on ? h0[(int64_t(b) * di + c) * N + n0 + k] : 0.f;
  }
  // row i of a tile starts (head + i * step) % 16 bytes into its chunk
  const int dt_step = (di * 4) & 15, x_step = (di * int(sizeof(TX))) & 15;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const char* st = smem + (tile % NSTAGE) * S::STAGE_BYTES;
    hopper::mbar_wait(&bar[tile % NSTAGE], (tile / NSTAGE) & 1);
    const int t0 = tile * STAGE, rows = min(STAGE, chunk - t0);
    const int64_t xo = xrow0 + int64_t(t0) * di;
    float* yt = y_s + (tile & 1) * STAGE * DC;
    // rows past the tile hold stale data, in bounds and never used
    const char* dt_col = st + S::DT + ch * 4;
    const char* x_col = st + S::X + ch * int(sizeof(TX));
    const float* b_col = reinterpret_cast<const float*>(st + S::BT) + n0;
    const float* c_col = reinterpret_cast<const float*>(st + S::CT) + n0;
    const int dt_head = hopper::chunk_head(dt + xo), x_head = hopper::chunk_head(x + xo);
    // one group of GROUP steps; FULL when every step lies inside the tile,
    // so the common case has no test on the step and no branch: a
    // straight line the compiler can interleave.  A step past the tile
    // (the last tile's tail) reads dt = x = 0, so its decay is exp(0) = 1
    // and its input 0, and the state does not move.
    auto group = [&](int g, auto full) {
      constexpr bool FULL = decltype(full)::value;
      // ahead of the chain: the decay and the input of every state and step
      float da[GROUP][SPT], u[GROUP][SPT];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const int i = g + j;
        const bool on = FULL || i < rows;
        float dtv = *reinterpret_cast<const float*>(dt_col + i * S::DT_PITCH + ((dt_head + i * dt_step) & 15));
        float xv = to_f32(*reinterpret_cast<const TX*>(x_col + i * S::X_PITCH + ((x_head + i * x_step) & 15)));
        dtv = on ? dtv : 0.f;
        xv = on ? xv : 0.f;
        const float dtx = dtv * xv;
        const float4 bv = *reinterpret_cast<const float4*>(b_col + i * NP);
        const float bk[SPT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          da[j][k] = expf(dtv * a[k]);
          u[j][k] = dtx * bk[k];
        }
      }
      // the chain, one FMA a state and step, and this thread's part of y_t
      float acc[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const float4 cv = *reinterpret_cast<const float4*>(c_col + (g + j) * NP);
        const float ck[SPT] = {cv.x, cv.y, cv.z, cv.w};
        acc[j] = 0.f;
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          h[k] = fmaf(da[j][k], h[k], u[j][k]);
          acc[j] = fmaf(h[k], ck[k], acc[j]);
        }
      }
      // y of the group's steps, summed over the channel's TPC threads
      constexpr int HELD = GROUP / TPC > 1 ? GROUP / TPC : 1;  // steps a thread ends with
      const int first = Halve<TPC / 2, GROUP, S::LANES>::run(acc, q);
      if ((q & (TPC / (GROUP / HELD) - 1)) == 0) {
#pragma unroll
        for (int r = 0; r < HELD; ++r)
          if (FULL || g + first + r < rows) yt[(g + first + r) * DC + ch] = acc[r];
      }
    };
    int g = 0;
    for (; g + GROUP <= rows; g += GROUP) group(g, std::true_type{});
    if (g < rows) group(g, std::false_type{});
    __syncthreads();  // every thread is done with this stage and with yt
    float* yg = y + xo;
    for (int i = tid; i < rows * DC; i += NT) {
      const int r = i / DC, cc = i % DC;
      if (cc < valid) yg[int64_t(r) * di + cc] = yt[i];
    }
    if (tile + NSTAGE < n_tiles) issue(tile + NSTAGE);
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < SPT; ++k)
      if (n0 + k < N) h_last[(int64_t(b) * di + c) * N + n0 + k] = h[k];
  }
}

template <typename TX, int NP, int DC>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const void* am, const void* h0,
           void* y, void* h_last, int B, int chunk, int di, int N, cudaStream_t s) {
  using S = Smem<TX, NP, DC>;
  auto kernel = scan_kernel<TX, NP, DC>;
  if (S::BYTES > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((di + DC - 1) / DC, B);
  kernel<<<grid, S::THREADS, S::BYTES, s>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(am), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), chunk, di, N);
  return int(cudaGetLastError());
}

template <typename TX, int DC>
int launch_n(const void* x, const void* dt, const void* bm, const void* cm, const void* am, const void* h0,
             void* y, void* h_last, int B, int chunk, int di, int N, cudaStream_t s) {
  if (N <= 4) return launch<TX, 4, DC>(x, dt, bm, cm, am, h0, y, h_last, B, chunk, di, N, s);
  if (N <= 8) return launch<TX, 8, DC>(x, dt, bm, cm, am, h0, y, h_last, B, chunk, di, N, s);
  if (N <= 16) return launch<TX, 16, DC>(x, dt, bm, cm, am, h0, y, h_last, B, chunk, di, N, s);
  if (N <= 32) return launch<TX, 32, DC>(x, dt, bm, cm, am, h0, y, h_last, B, chunk, di, N, s);
  if constexpr (DC <= 32) return launch<TX, 64, DC>(x, dt, bm, cm, am, h0, y, h_last, B, chunk, di, N, s);
  return int(cudaErrorInvalidValue);  // 64 channels of 64 states: past the threads a block takes
}

}  // namespace

extern "C" {

// x (B,chunk,di) fp32 (x_dtype 0) or bf16 (1); dt (B,chunk,di), b and c
// (B,chunk,N), a (di,N), h0 (B,di,N) fp32; y (B,chunk,di) and h_last
// (B,di,N) fp32 out; every operand on a 16-byte boundary; 1 <= N <= 64.
// dc: the channels a block (the variant): 8, 16, 32 or 64 for fp32 x (64
// only where N <= 32), 32 for bf16 x.  Returns cudaGetLastError() after the
// launch (0 on success).
int selective_scan_fwd(const void* x, const void* dt, const void* b, const void* c, const void* a, const void* h0,
                       void* y, void* h_last, int B, int chunk, int di, int N, int x_dtype, int dc, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (N < 1 || N > MAX_N || (x_dtype != 0 && x_dtype != 1)) return int(cudaErrorInvalidValue);
  if (B == 0 || di == 0) return 0;
  if (B > 65535) return int(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1) {
    if (dc != 32) return int(cudaErrorInvalidValue);
    return launch_n<__nv_bfloat16, 32>(x, dt, b, c, a, h0, y, h_last, B, chunk, di, N, s);
  }
  switch (dc) {
    case 8: return launch_n<float, 8>(x, dt, b, c, a, h0, y, h_last, B, chunk, di, N, s);
    case 16: return launch_n<float, 16>(x, dt, b, c, a, h0, y, h_last, B, chunk, di, N, s);
    case 32: return launch_n<float, 32>(x, dt, b, c, a, h0, y, h_last, B, chunk, di, N, s);
    case 64: return launch_n<float, 64>(x, dt, b, c, a, h0, y, h_last, B, chunk, di, N, s);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
