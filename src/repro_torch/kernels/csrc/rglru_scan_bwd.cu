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
// dlog_a and dgx, five (B,L,dr) fp32 arrays: 210 MB, ~63 us at the
// recurrentgemma-2b width (B 1, L 4096, dr 2560).
//
// What the design does about it: a walk over the whole sequence, one thread
// a channel, holds only B*dr threads (2560 at the model width) and is bound
// by the latency of its 4096 steps (2.15 ms, 34x the bound, on the H100 in
// its first version).  So the sequence is cut into segments of T = 64 steps,
// and each (batch row, segment, channel) gets a thread, 64x more:
//  * pass 1 (`seg_summary`): the reverse walk over a segment is affine in
//    the gradient that enters it from the right (carry_in, the gradient
//    reaching h_{t1-1} from h_{t1}): carry_out = A carry_in + C with A the
//    product of the segment's a_t and C the walk from carry_in = 0.  Each
//    thread writes its segment's (A, C); it reads log_a and dy.
//  * pass 2 (`seg_carries`): one thread a (batch row, channel) composes the
//    summaries right to left from dh_last, writing each segment's carry_in,
//    and dh0 = the carry out of segment 0.  L/T steps of two loads.
//  * pass 3 (`seg_walk`): each thread walks its segment again from its true
//    carry_in, writing dgx and dlog_a; it reads log_a, dy and y.
// log_a and dy are read twice: 7 arrays move where the bound counts 5.  The
// last segment starts from dh_last itself, as the plain version does; the
// others from a carry composed in another order, which differs from the
// sequential walk by fp32 rounding.  Threads run along channels, so a
// warp's loads at one step are one 128-byte line per array.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // channels per block
constexpr int T = 64;    // steps per segment

__global__ void __launch_bounds__(NT)
seg_summary(const float* __restrict__ log_a, const float* __restrict__ dy, float* __restrict__ sum_a,
            float* __restrict__ sum_c, int L, int dr, int nseg) {
  const int c = blockIdx.x * NT + threadIdx.x, seg = blockIdx.y, b = blockIdx.z;
  if (c >= dr) return;
  const int64_t col = int64_t(b) * L * dr + c;
  const int t0 = seg * T, t1 = min(L, t0 + T);
  float A = 1.f, C = 0.f;
#pragma unroll 8
  for (int t = t1 - 1; t >= t0; --t) {
    const float a = expf(log_a[col + int64_t(t) * dr]);
    C = a * (dy[col + int64_t(t) * dr] + C);
    A *= a;
  }
  const int64_t i = (int64_t(b) * nseg + seg) * dr + c;
  sum_a[i] = A;
  sum_c[i] = C;
}

__global__ void __launch_bounds__(NT)
seg_carries(const float* __restrict__ sum_a, const float* __restrict__ sum_c, const float* __restrict__ dh_last,
            float* __restrict__ carry_in, float* __restrict__ dh0, int dr, int nseg) {
  const int c = blockIdx.x * NT + threadIdx.x, b = blockIdx.y;
  if (c >= dr) return;
  float carry = dh_last[int64_t(b) * dr + c];
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int64_t i = (int64_t(b) * nseg + seg) * dr + c;
    carry_in[i] = carry;
    carry = fmaf(sum_a[i], carry, sum_c[i]);
  }
  dh0[int64_t(b) * dr + c] = carry;  // exp(log_a_0) g_0 (dh_last when L = 0)
}

__global__ void __launch_bounds__(NT)
seg_walk(const float* __restrict__ log_a, const float* __restrict__ h0, const float* __restrict__ y,
         const float* __restrict__ dy, const float* __restrict__ carry_in, float* __restrict__ dlog_a,
         float* __restrict__ dgx, int L, int dr, int nseg) {
  const int c = blockIdx.x * NT + threadIdx.x, seg = blockIdx.y, b = blockIdx.z;
  if (c >= dr) return;
  const int64_t col = int64_t(b) * L * dr + c;
  const int t0 = seg * T, t1 = min(L, t0 + T);
  float carry = carry_in[(int64_t(b) * nseg + seg) * dr + c];
  const float h_init = h0[int64_t(b) * dr + c];
#pragma unroll 8
  for (int t = t1 - 1; t >= t0; --t) {
    const int64_t i = col + int64_t(t) * dr;
    const float a = expf(log_a[i]);
    const float g = dy[i] + carry;
    const float hp = t > 0 ? y[i - dr] : h_init;
    dgx[i] = g;
    dlog_a[i] = g * a * hp;
    carry = a * g;
  }
}

int n_segments(int L) { return (L + T - 1) / T; }

}  // namespace

extern "C" {

// Bytes of the per-call scratch `rglru_scan_bwd` takes: the segments'
// summaries (A, C) and carries, fp32 (B, L/T, dr) each.
long long rglru_scan_bwd_scratch_bytes(int B, int L, int dr) {
  return 3LL * B * n_segments(L) * dr * 4;
}

// log_a, y, dy (B,L,dr), h0, dh_last (B,dr) fp32 in; dlog_a, dgx (B,L,dr),
// dh0 (B,dr) fp32 out; all contiguous; scratch of
// rglru_scan_bwd_scratch_bytes(B, L, dr) bytes.  Launches the three passes
// on `stream`; returns the first CUDA error (0 on success).
int rglru_scan_bwd(const void* log_a, const void* h0, const void* y, const void* dy, const void* dh_last,
                   void* dlog_a, void* dgx, void* dh0, void* scratch, int B, int L, int dr, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (B == 0 || dr == 0) return 0;
  const int nseg = n_segments(L);
  if (B > 65535 || nseg > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sum_a = static_cast<float*>(scratch);
  float* sum_c = sum_a + int64_t(B) * nseg * dr;
  float* carry_in = sum_c + int64_t(B) * nseg * dr;
  const int nc = (dr + NT - 1) / NT;
  if (nseg > 0) {
    seg_summary<<<dim3(nc, nseg, B), NT, 0, s>>>(static_cast<const float*>(log_a), static_cast<const float*>(dy),
                                                 sum_a, sum_c, L, dr, nseg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  seg_carries<<<dim3(nc, B), NT, 0, s>>>(sum_a, sum_c, static_cast<const float*>(dh_last), carry_in,
                                         static_cast<float*>(dh0), dr, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return int(err);
  seg_walk<<<dim3(nc, nseg, B), NT, 0, s>>>(static_cast<const float*>(log_a), static_cast<const float*>(h0),
                                            static_cast<const float*>(y), static_cast<const float*>(dy), carry_in,
                                            static_cast<float*>(dlog_a), static_cast<float*>(dgx), L, dr, nseg);
  return int(cudaGetLastError());
}

const char* rglru_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
