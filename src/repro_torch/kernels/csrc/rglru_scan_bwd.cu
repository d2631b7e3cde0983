// Backward of the RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces nothing on the TPU: the reference has no Pallas backward, and
// trains through XLA's autodiff of its plain recurrence
// (src/repro/models/rglru.py:137-155, use_pallas=False).  This is the
// backward of the port's forward kernel (csrc/rglru_scan.cu, which replaces
// `rglru_scan` / `_rglru_kernel`, src/repro/kernels/rglru_scan.py,
// pallas_call at line 52), and computes the gradients autodiff computes.
//
// What it computes: the forward h_t = exp(log_a_t) h_{t-1} + gx_t saved y
// (the states h_t, fp32); with h_{t-1} = y_{t-1} and h0 at t = 0, a
// reverse-time scan gives, for dy (B,L,dr) and dh_last (B,dr):
//   g_t = dy_t + exp(log_a_{t+1}) g_{t+1},  g_{L-1} = dy_{L-1} + dh_last;
//   dgx_t = g_t;  dlog_a_t = g_t exp(log_a_t) h_{t-1};  dh0 = exp(log_a_0) g_0.
// All fp32.
//
// What bounds it on this card: bytes.  It reads log_a, y and dy and writes
// dlog_a and dgx, five (B,L,dr) fp32 arrays: 210 MB at the
// recurrentgemma-2b width (B 1, L 4096, dr 2560).
//
// What the design does about it: one pass over the five arrays, the
// forward's design (csrc/rglru_scan.cu) walking time in reverse.  The walk
// from the right end of a stretch of steps is affine in the carry c that
// enters it there (the gradient reaching h_{t1} from h_{t1+1}):
// c_out = A c_in + C, A the product of the stretch's a_t, C the walk from
// c_in = 0.
//  * one block per (segment of T steps, DC = 32 channels, batch row); its
//    W = 8 warps each take a part of T / W steps, a lane per channel.  The
//    block takes an atomic ticket that orders segments from the end of the
//    sequence, so a block only ever waits on a segment to its right, whose
//    block holds a lower ticket and has started: no deadlock;
//  * the block's (T x DC) tiles of log_a and dy, and of y one step back
//    (y_{t-1} for each step t), arrive by cp.async (hopper.cuh:
//    copy_rows_async, rows of any width and alignment), all issued at once,
//    a stage (one mbarrier) per part for log_a and dy and another for y, so
//    a warp starts as soon as its own part of log_a and dy has landed;
//  * pass 1: each warp walks its part backwards from a zero carry, storing
//    a_t = exp(log_a_t) (libdevice's accurate expf, as torch.exp) in place
//    of log_a, and forms the part's summary (A, C).  Warp 0 composes the
//    parts right to left into the segment's summary and publishes it
//    (flag 1);
//  * decoupled look-back (warp 0): the block composes the summaries of the
//    segments to its right (c -> A c + C) until it meets one whose carry-out
//    is published (flag 2) or the sequence's end, where the carry is
//    dh_last.  That is its carry-in; it publishes its own carry-out (flag 2)
//    and each part's carry-in;
//  * pass 2: every warp walks its part again from shared memory starting at
//    its true carry, writing dgx_t = g_t and dlog_a_t = g_t a_t y_{t-1}
//    (h0 at t = 0); the part holding t = 0 writes dh0.
// log_a, dy and y are read once and dlog_a and dgx written once: the five
// arrays the bound counts, in one launch (the first version took three
// kernels and moved seven arrays).  Values are published before their flag
// (the warp's stores, __syncwarp, one thread's release store); the flag is
// read with acquire and the values past L1.  Flags, summaries and the ticket
// live in a per-call scratch, zeroed here on the stream, so concurrent calls
// share nothing.  The last segment starts from dh_last itself, as the plain
// version does; the others from a carry composed in another order, which
// differs from the sequential walk by fp32 rounding.
//
// Segment length: T = 256 steps, three tiles of 256 x 32 fp32 in 111 KB of
// shared memory, two blocks an SM.  T = 128 (55 KB, four blocks an SM, twice
// the blocks and look-backs) measured slower at recurrentgemma-2b's width on
// an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
//
// Ragged shapes: rows are copied by whole 16-byte chunks, zero-filled past
// the row's end, so dr = 50 or L = 300 run on the same kernel; channels past
// dr are not computed and the last segment walks only its own steps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int T = 256;               // steps per segment
constexpr int DC = 32;               // channels per block: a lane each in every warp
constexpr int W = 8;                 // warps per block, each walking T / W of the steps
constexpr int NT = W * DC;
constexpr int PITCH = DC * 4 + 16;   // bytes of one shared row: DC floats + the chunk head
constexpr int FLAG_AGG = 1, FLAG_INCL = 2;

constexpr int SMEM = 3 * T * PITCH;  // the tiles of log_a, dy and y_{t-1}

// scratch: int flags[n_blocks + 1] (the last is the ticket counter), padded
// to 16 bytes, then float vals[n_blocks][3][DC]: A, C and the carry-out
int64_t flag_bytes(int64_t n_blocks) { return ((n_blocks + 1) * 4 + 15) / 16 * 16; }

__global__ void __launch_bounds__(NT)
rglru_bwd_kernel(const float* __restrict__ log_a, const float* __restrict__ h0, const float* __restrict__ y,
                 const float* __restrict__ dy, const float* __restrict__ dh_last, float* __restrict__ dlog_a,
                 float* __restrict__ dgx, float* __restrict__ dh0, int L, int dr, int nbd, int nd, int nseg,
                 int* __restrict__ flags, float* __restrict__ vals) {
  constexpr int STAGE = T / W;  // steps per cp.async stage: a warp's part
  static_assert(T % W == 0, "whole parts");
  extern __shared__ __align__(16) char tiles[];
  char* a_s = tiles;                 // log_a, then a = exp(log_a) in place
  char* dy_s = tiles + T * PITCH;
  char* yp_s = tiles + 2 * T * PITCH;  // row i: y at step t0 + i - 1
  __shared__ uint64_t bar[W], ybar[W];
  __shared__ float part_a[W][DC], part_c[W][DC];  // each warp's summary, then its carry-in
  __shared__ int ticket;
  const int tid = threadIdx.x, warp = tid / DC, lane = tid % DC;
  if (tid == 0) {
    ticket = atomicAdd(&flags[nbd * nseg], 1);
    for (int s = 0; s < W; ++s) {
      hopper::mbar_init(&bar[s], NT);
      hopper::mbar_init(&ybar[s], NT);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the ticket runs segments slowest and from the sequence's end: every
  // block of segment s + 1 has started before any of segment s
  const int tk = ticket;
  const int seg = nseg - 1 - tk / nbd, bd = tk % nbd, b = bd / nd, d0 = (bd % nd) * DC;
  const int t0 = seg * T, steps = min(T, L - t0), valid = min(DC, dr - d0);
  const int64_t row0 = (int64_t(b) * L + t0) * dr + d0;  // element (b, t0, d0)
  const int64_t stride = int64_t(dr) * 4;
  for (int s = 0; s < W; ++s) {
    const int r0 = s * STAGE, rows = max(0, min(STAGE, steps - r0));
    const int64_t off = row0 + int64_t(r0) * dr;
    hopper::copy_rows_async<PITCH, NT>(a_s + r0 * PITCH, reinterpret_cast<const char*>(log_a + off), stride,
                                       rows, valid * 4, tid);
    hopper::copy_rows_async<PITCH, NT>(dy_s + r0 * PITCH, reinterpret_cast<const char*>(dy + off), stride, rows,
                                       valid * 4, tid);
    hopper::cp_async_arrive(&bar[s]);
  }
  for (int s = 0; s < W; ++s) {
    // y_{t0 - 1 + i} into row i; at the sequence's start row 0 would be h0,
    // which pass 2 reads from device memory instead
    const int r0 = (s == 0 && t0 == 0) ? 1 : s * STAGE, rows = max(0, min(s * STAGE + STAGE, steps) - r0);
    hopper::copy_rows_async<PITCH, NT>(yp_s + r0 * PITCH, reinterpret_cast<const char*>(y + row0 + int64_t(r0 - 1) * dr),
                                       stride, rows, valid * 4, tid);
    hopper::cp_async_arrive(&ybar[s]);
  }

  const bool live = lane < valid;
  const int c = d0 + lane;
  // element `lane` of row i sits (head + i * step) % 16 bytes into the row's
  // first chunk, head that of row 0 in the operand's own alignment
  const int step = (dr * 4) & 15;
  const int h_a = hopper::chunk_head(log_a + row0), h_dy = hopper::chunk_head(dy + row0);
  const int h_y = int((reinterpret_cast<uintptr_t>(y + row0) - uintptr_t(stride)) & 15);
  auto at = [&](char* tile, int head, int i) {
    return reinterpret_cast<float*>(tile + i * PITCH + ((head + i * step) & 15)) + lane;
  };
  const int lo = warp * STAGE, hi = min(steps, lo + STAGE);  // this warp's steps

  // pass 1: each warp's summary over its part from a zero carry, a_t kept
  // in place of log_a
  hopper::mbar_wait(&bar[warp], 0);
  {
    float A = 1.f, C = 0.f;
    if (live) {
#pragma unroll 4
      for (int i = hi - 1; i >= lo; --i) {
        float* pa = at(a_s, h_a, i);
        const float a = expf(*pa);
        *pa = a;
        C = a * (*at(dy_s, h_dy, i) + C);
        A *= a;
      }
    }
    part_a[warp][lane] = A;
    part_c[warp][lane] = C;
  }
  __syncthreads();

  if (warp == 0) {
    // the segment's summary: the parts composed right to left
    float A = 1.f, C = 0.f;
#pragma unroll
    for (int w = W - 1; w >= 0; --w) {
      C = fmaf(part_a[w][lane], C, part_c[w][lane]);
      A *= part_a[w][lane];
    }
    float* mine = vals + int64_t(tk) * 3 * DC + lane;
    if (live) {
      __stcg(mine, A);
      __stcg(mine + DC, C);
    }
    __syncwarp();
    if (lane == 0) hopper::st_release(&flags[tk], FLAG_AGG);

    // look-back: compose the summaries after this segment into c -> Ac c + Cc
    float carry = 0.f;
    if (live) {
      const float last = dh_last[int64_t(b) * dr + c];
      if (seg == nseg - 1) {
        carry = last;
      } else {
        float Ac = 1.f, Cc = 0.f;
        for (int j = tk - nbd;; j -= nbd) {
          const float* theirs = vals + int64_t(j) * 3 * DC + lane;
          if (hopper::wait_flag(&flags[j]) == FLAG_INCL) {
            carry = fmaf(Ac, __ldcg(theirs + 2 * DC), Cc);
            break;
          }
          Cc = fmaf(Ac, __ldcg(theirs + DC), Cc);
          Ac *= __ldcg(theirs);
          if (j < nbd) {  // that was the last segment: it starts from dh_last
            carry = fmaf(Ac, last, Cc);
            break;
          }
        }
      }
      __stcg(mine + 2 * DC, fmaf(A, carry, C));
    }
    __syncwarp();
    if (lane == 0) hopper::st_release(&flags[tk], FLAG_INCL);
    // each part's carry-in, from the segment's through the parts after it
#pragma unroll
    for (int w = W - 1; w >= 0; --w) {
      const float a = part_a[w][lane], cw = part_c[w][lane];
      part_c[w][lane] = carry;
      carry = fmaf(a, carry, cw);
    }
  }
  __syncthreads();

  // pass 2: the true walk of each part from its carry-in, from shared memory
  hopper::mbar_wait(&ybar[warp], 0);
  if (live) {
    float carry = part_c[warp][lane];
    float* dgx_g = dgx + row0 + lane;
    float* dla_g = dlog_a + row0 + lane;
    const float first = t0 == 0 ? h0[int64_t(b) * dr + c] : 0.f;  // h_{-1}
#pragma unroll 4
    for (int i = hi - 1; i >= lo; --i) {
      const float a = *at(a_s, h_a, i);
      const float g = *at(dy_s, h_dy, i) + carry;
      const float hp = (t0 == 0 && i == 0) ? first : *at(yp_s, h_y, i);
      dgx_g[int64_t(i) * dr] = g;
      dla_g[int64_t(i) * dr] = g * a * hp;
      carry = a * g;
    }
    if (t0 == 0 && lo == 0 && lo < hi) dh0[int64_t(b) * dr + c] = carry;  // exp(log_a_0) g_0
  }
}

int64_t n_blocks(int B, int L, int dr) {
  return int64_t(B) * ((dr + DC - 1) / DC) * ((L + T - 1) / T);
}

int launch(const float* log_a, const float* h0, const float* y, const float* dy, const float* dh_last, float* dlog_a,
           float* dgx, float* dh0, void* scratch, int B, int L, int dr, cudaStream_t s) {
  const int64_t n = n_blocks(B, L, dr);
  if (n > 0x7ffffffe) return int(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaMemsetAsync(scratch, 0, size_t(flag_bytes(n)), s);
  if (err != cudaSuccess) return int(err);
  const int nd = (dr + DC - 1) / DC;
  int* flags = static_cast<int*>(scratch);
  float* vals = reinterpret_cast<float*>(static_cast<char*>(scratch) + flag_bytes(n));
  err = cudaFuncSetAttribute(rglru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return int(err);
  // all of the SM's unified memory as shared memory: two blocks fit only so
  err = cudaFuncSetAttribute(rglru_bwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  rglru_bwd_kernel<<<unsigned(n), NT, SMEM, s>>>(log_a, h0, y, dy, dh_last, dlog_a, dgx, dh0, L, dr, B * nd, nd,
                                                (L + T - 1) / T, flags, vals);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of the per-call scratch `rglru_scan_bwd` takes.
long long rglru_scan_bwd_scratch_bytes(int B, int L, int dr) {
  const int64_t n = n_blocks(B, L, dr);
  return flag_bytes(n) + n * 3 * DC * 4;
}

// log_a, y, dy (B,L,dr), h0, dh_last (B,dr) fp32 in; dlog_a, dgx (B,L,dr),
// dh0 (B,dr) fp32 out; all contiguous; scratch of
// rglru_scan_bwd_scratch_bytes(B, L, dr) bytes on a 16-byte boundary.  One
// launch on `stream`; returns cudaGetLastError() after it (0 on success).
int rglru_scan_bwd(const void* log_a, const void* h0, const void* y, const void* dy, const void* dh_last,
                   void* dlog_a, void* dgx, void* dh0, void* scratch, int B, int L, int dr, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || dr == 0) return 0;
  if (L == 0) return int(cudaMemcpyAsync(dh0, dh_last, size_t(B) * dr * 4, cudaMemcpyDeviceToDevice, s));
  const auto la = static_cast<const float*>(log_a), h = static_cast<const float*>(h0);
  const auto yy = static_cast<const float*>(y), g = static_cast<const float*>(dy);
  const auto dl = static_cast<const float*>(dh_last);
  const auto out_la = static_cast<float*>(dlog_a), out_gx = static_cast<float*>(dgx), out_h = static_cast<float*>(dh0);
  return launch(la, h, yy, g, dl, out_la, out_gx, out_h, scratch, B, L, dr, s);
}

const char* rglru_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
