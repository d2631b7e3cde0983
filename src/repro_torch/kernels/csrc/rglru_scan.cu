// RG-LRU linear recurrence (RecurrentGemma) for Hopper (sm_90a).
//
// Replaces the TPU kernel `rglru_scan` / `_rglru_kernel` in
// src/repro/kernels/rglru_scan.py (pallas_call at line 52).
//
// What it computes: h_t = exp(log_a_t) * h_{t-1} + gx_t, elementwise over
// the dr channels, for log_a and gx (B,L,dr) and h0 (B,dr) in fp32; it
// returns y (B,L,dr) and the last state h_last (B,dr), both fp32.
//
// What bounds it on this card: 3 operations per (t, channel) on 12 bytes
// (log_a and gx read, y written), so memory: 252 MB, ~75 us at the
// recurrentgemma-2b width (B 2, L 4096, dr 2560).  What held a walk over
// the whole sequence back was latency: B*dr/32 = 160 one-warp walkers of
// 4096 steps each, with two 128-byte loads in flight per step, keep a few
// tens of KB in flight where the card needs megabytes.
//
// What the design does about it: time is cut too, and then cut again.
//  * one block per (segment of T = 256 steps, block of DC = 32 channels,
//    batch row): B * dr/32 * L/256 = 2560 blocks at the model width, three
//    resident on each SM.  Its W = 8 warps each take a part of 32 steps of
//    the segment, a lane per channel, so no warp walks more than 32 steps;
//  * the block's (T x DC) tiles of log_a and gx arrive by cp.async, a stage
//    (one mbarrier) per part, all issued at once, so each block keeps its
//    64 KB in flight from its first instruction and a warp starts as soon
//    as its own part has landed;
//  * pass 1: each warp walks its part from a zero state, computing
//    a_t = exp(log_a_t) (libdevice's accurate expf, as torch.exp) into
//    shared memory in place of log_a, and the part's summary: the product A
//    of its a's and its end state H.  Warp 0 composes the parts into the
//    segment's summary and publishes it with flag 1;
//  * decoupled look-back (warp 0): the block walks back over the segments
//    before it, composing their summaries (h -> A h + H) until it meets one
//    whose true end state is published (flag 2) or the start of the
//    sequence (h0), which gives its incoming state h_in.  It publishes its
//    own end state A h_in + H with flag 2, and each part's starting state;
//  * pass 2: every warp walks its part again from shared memory starting at
//    its true state, so the step-to-step chain is one FMA (a_t is already
//    there), and writes y; the part holding the sequence's last step writes
//    h_last.  log_a and gx are read once and y written once: the bound's
//    three passes.
// Segments are ordered by an atomic ticket taken when a block starts, not
// by blockIdx: a block only ever waits on a lower ticket, which a block
// that has already started holds, so the look-back cannot deadlock.  The
// values are published before their flag (the warp's stores, __syncwarp,
// then one thread's release store, as CUTLASS's semaphore does with a block
// barrier); the flag is read with acquire and the values past L1.  Flags,
// summaries and the ticket live in a per-call scratch (zeroed here on the
// stream), so concurrent calls share nothing.
//
// Development runs chose the sizes: one warp walking a 64-step segment
// (10240 blocks) reached about half the byte bound, held back by the
// latency of its phases run in order, not by the exponentials or the
// look-back's polling; warps sharing a longer segment shorten every warp's
// walk and cut the blocks, and so the look-backs, by four (PERF.md).
//
// Ragged shapes: rows of any width are copied by whole 16-byte chunks,
// zero-filled past the row's end (hopper.cuh: copy_rows_async), so dr = 50
// or L = 300 run on the same kernel; channels past dr are not computed and
// the last segment walks only its own steps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int DC = 32;                // channels per block: a thread each in every warp
constexpr int T = 256;                // steps per segment
constexpr int W = 8;                  // warps per block, each walking T / W of the steps
constexpr int STAGE = T / W;          // steps per cp.async stage: a warp's part
constexpr int NT = W * DC;
constexpr int PITCH = DC * 4 + 16;    // bytes of one shared row: DC floats + the chunk head
constexpr int SMEM = 2 * T * PITCH;  // the tiles of log_a and gx
constexpr int FLAG_AGG = 1, FLAG_INCL = 2;
static_assert(DC == 32 && T % W == 0, "a warp's lane per channel; whole parts");

// scratch: int flags[n_blocks + 1] (the last is the ticket counter), padded
// to 16 bytes, then float vals[n_blocks][3][DC]: A, H and the end state
int64_t flag_bytes(int64_t n_blocks) { return ((n_blocks + 1) * 4 + 15) / 16 * 16; }

__global__ void __launch_bounds__(NT)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ gx, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ h_last, int L, int dr, int nbd, int nd, int nseg,
             int* __restrict__ flags, float* __restrict__ vals) {
  extern __shared__ __align__(16) char tiles[];
  char* la_s = tiles;               // log_a, then a = exp(log_a) in place
  char* gx_s = tiles + T * PITCH;
  __shared__ uint64_t bar[W];
  __shared__ float part_a[W][DC], part_h[W][DC];  // each warp's summary, then its starting state
  __shared__ int ticket;
  const int tid = threadIdx.x, warp = tid / DC, lane = tid % DC;
  if (tid == 0) {
    ticket = atomicAdd(&flags[nbd * nseg], 1);
    for (int s = 0; s < W; ++s) hopper::mbar_init(&bar[s], NT);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the ticket runs segments slowest: every block of segment s - 1 has
  // started before any of segment s
  const int tk = ticket;
  const int seg = tk / nbd, bd = tk % nbd, b = bd / nd, d0 = (bd % nd) * DC;
  const int t0 = seg * T, steps = min(T, L - t0), valid = min(DC, dr - d0);
  const int64_t row0 = (int64_t(b) * L + t0) * dr + d0;  // element (b, t0, d0)
  const float* la_g = log_a + row0;
  const float* gx_g = gx + row0;
  for (int s = 0; s < W; ++s) {
    const int rows = max(0, min(STAGE, steps - s * STAGE));
    const int64_t off = int64_t(s) * STAGE * dr;
    hopper::copy_rows_async<PITCH, NT>(la_s + s * STAGE * PITCH, reinterpret_cast<const char*>(la_g + off),
                                       int64_t(dr) * 4, rows, valid * 4, tid);
    hopper::copy_rows_async<PITCH, NT>(gx_s + s * STAGE * PITCH, reinterpret_cast<const char*>(gx_g + off),
                                       int64_t(dr) * 4, rows, valid * 4, tid);
    hopper::cp_async_arrive(&bar[s]);
  }

  const bool live = lane < valid;
  const int c = d0 + lane;
  // element `lane` of row i sits (head + i * step) % 16 bytes into the row's
  // first chunk; log_a and gx start on 16-byte boundaries, so the heads agree
  const int head = hopper::chunk_head(la_g), step = (dr * 4) & 15;
  auto at = [&](char* tile, int i) {
    return reinterpret_cast<float*>(tile + i * PITCH + ((head + i * step) & 15)) + lane;
  };
  const int lo = warp * STAGE, hi = min(steps, lo + STAGE);  // this warp's steps

  // pass 1: each warp's summary from a zero state over its part, a_t kept
  // in place of log_a
  hopper::mbar_wait(&bar[warp], 0);
  {
    float A = 1.f, H = 0.f;
    if (live) {
#pragma unroll 4
      for (int i = lo; i < hi; ++i) {
        float* pa = at(la_s, i);
        const float a = expf(*pa);
        *pa = a;
        H = fmaf(a, H, *at(gx_s, i));
        A *= a;
      }
    }
    part_a[warp][lane] = A;
    part_h[warp][lane] = H;
  }
  __syncthreads();

  if (warp == 0) {
    // the segment's summary: the parts composed in order
    float A = 1.f, H = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      H = fmaf(part_a[w][lane], H, part_h[w][lane]);
      A *= part_a[w][lane];
    }
    float* mine = vals + int64_t(tk) * 3 * DC + lane;
    if (live) {
      __stcg(mine, A);
      __stcg(mine + DC, H);
    }
    __syncwarp();
    if (lane == 0) hopper::st_release(&flags[tk], FLAG_AGG);

    // look-back: compose the summaries before this segment into h -> Ac h + Hc
    float h = 0.f;
    if (live) {
      if (seg == 0) {
        h = h0[int64_t(b) * dr + c];
      } else {
        float Ac = 1.f, Hc = 0.f;
        for (int j = tk - nbd;; j -= nbd) {
          const float* theirs = vals + int64_t(j) * 3 * DC + lane;
          if (hopper::wait_flag(&flags[j]) == FLAG_INCL) {
            h = fmaf(Ac, __ldcg(theirs + 2 * DC), Hc);
            break;
          }
          Hc = fmaf(Ac, __ldcg(theirs + DC), Hc);
          Ac *= __ldcg(theirs);
          if (j < nbd) {  // that was segment 0: start from h0
            h = fmaf(Ac, h0[int64_t(b) * dr + c], Hc);
            break;
          }
        }
      }
      __stcg(mine + 2 * DC, fmaf(A, h, H));
    }
    __syncwarp();
    if (lane == 0) hopper::st_release(&flags[tk], FLAG_INCL);
    // each part's starting state, from h_in through the parts before it
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float a = part_a[w][lane], hw = part_h[w][lane];
      part_h[w][lane] = h;
      h = fmaf(a, h, hw);
    }
  }
  __syncthreads();

  // pass 2: the true walk of each part from its starting state, from shared memory
  if (live) {
    float h = part_h[warp][lane];
    float* yg = y + row0 + lane;
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      h = fmaf(*at(la_s, i), h, *at(gx_s, i));
      yg[int64_t(i) * dr] = h;
    }
    if (seg == nseg - 1 && hi == steps && lo < hi) h_last[int64_t(b) * dr + c] = h;
  }
}

int64_t n_blocks(int B, int L, int dr) {
  return int64_t(B) * ((dr + DC - 1) / DC) * ((L + T - 1) / T);
}

}  // namespace

extern "C" {

// Bytes of the per-call scratch `rglru_scan_fwd` takes.
long long rglru_scan_scratch_bytes(int B, int L, int dr) {
  const int64_t n = n_blocks(B, L, dr);
  return flag_bytes(n) + n * 3 * DC * 4;
}

// log_a, gx (B,L,dr), h0 (B,dr) fp32 in; y (B,L,dr), h_last (B,dr) fp32
// out; every operand on a 16-byte boundary; scratch of
// rglru_scan_scratch_bytes(B, L, dr) bytes, on a 16-byte boundary.
// Returns cudaGetLastError() after the launch (0 on success).
int rglru_scan_fwd(const void* log_a, const void* gx, const void* h0, void* y, void* h_last, void* scratch,
                   int B, int L, int dr, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || dr == 0) return 0;
  if (L == 0) return int(cudaMemcpyAsync(h_last, h0, size_t(B) * dr * 4, cudaMemcpyDeviceToDevice, s));
  const int64_t n = n_blocks(B, L, dr);
  if (n > 0x7ffffffe) return int(cudaErrorInvalidConfiguration);
  err = cudaMemsetAsync(scratch, 0, size_t(flag_bytes(n)), s);
  if (err != cudaSuccess) return int(err);
  const int nd = (dr + DC - 1) / DC;
  int* flags = static_cast<int*>(scratch);
  float* vals = reinterpret_cast<float*>(static_cast<char*>(scratch) + flag_bytes(n));
  if (SMEM > 48 * 1024) {
    err = cudaFuncSetAttribute(rglru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return int(err);
  }
  rglru_kernel<<<unsigned(n), NT, SMEM, s>>>(static_cast<const float*>(log_a), static_cast<const float*>(gx),
                                          static_cast<const float*>(h0), static_cast<float*>(y),
                                          static_cast<float*>(h_last), L, dr, B * nd, nd, (L + T - 1) / T,
                                          flags, vals);
  return int(cudaGetLastError());
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
