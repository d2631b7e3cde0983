// The gradients of the grouped (per-expert) matrix product y[e] = x[e] @ w[e]
// on Hopper (sm_90a), for each expert e:
//   dx[e] = dy[e] @ w[e]^T   (C x D), contracting F;
//   dw[e] = x[e]^T @ dy[e]   (D x F), contracting C, the expert's tokens.
//
// Backward of the TPU kernel `moe_gmm` in src/repro/kernels/moe_gmm.py
// (pallas_call at line 60).  The reference has no Pallas backward: it
// differentiates its expert einsums (src/repro/models/moe.py:131-135) with
// XLA.  x (E,C,D), w (E,D,F) and dy (E,C,F) share one type, fp32 or bf16;
// dx and dw are summed in fp32 and written in that type.  Either may be
// skipped (a null pointer): autograd asks only for the gradients it needs.
//
// What bounds it on this card, each gradient apart (bf16; the time of each
// is one forward's products, 2 E C D F, against its operands read and its
// output written once):
//  * grok-1's expert shape (E 8, C 1280, D 6144, F 32768): both by the
//    tensor cores, 4.17 ms each.  dx is 1,920 tiles of 512 slices; dw
//    49,152 tiles of 20 slices, each ending in a 64 KB store.
//  * arctic-480b's (E 128, C 80, D 7168, F 4864): both by bytes, 2.74 ms
//    each.  dx reads w's 8.9 GB once (3,584 tiles of 76 slices, as the
//    forward); dw writes its 8.9 GB (136,192 tiles of one short slice of
//    tokens, each tile's work a 64 KB store).
// The earlier design, one block a tile and one an SM, ran each tile's
// prologue, its products and its store from registers one after another:
// arctic's dw took 10.35 ms, four times its bound (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).  The `wgmma` kernels are persistent (gmm.cuh,
// gmm_wgmma_persistent): as many blocks as the SMs hold walk the tiles,
// the ring of slices runs on across tiles, and each tile's bf16 output
// goes through shared memory to a TMA store that drains under the next
// tile's products; L2 keeps the operands (evict_last) ahead of the output
// (evict_first).  Measured (PERF.md): arctic dw 3.83 ms (from 10.35), dx
// 3.07 (3.04); grok dw 6.0 (7.4), dx 5.5 (5.8).  What still bounds arctic's
// dw is the store stream beside the loads: without its loads the same
// kernel's products and stores take 3.0 ms, without its stores 2.0.
//
// Each gradient is one launch of a body of gmm.cuh, on its forward's route
// (kernels/moe_gmm.py, `route`; the backward's operands have the same
// strides):
//  * `wgmma` (bf16, persistent): dx reads dy and w K-major, the natural
//    layouts (no transpose bit: w (D,F) is w^T's K-major form); dw reads
//    x^T and dy with the tokens outermost, both through wgmma's transpose
//    bit.  Each tile of dx or dw is one block's, which walks all of the
//    contraction in one order: no atomics, no split of K, the same bits on
//    every run.
//  * `tf32x3` (fp32): TF32 has no transpose bit.  dx^T = w dy^T: w is the
//    register A operand, read K-major from its raw tile, and dy the K-major
//    B operand, split elementwise.  dw^T = dy^T x: dy^T is the register A
//    operand, read from dy's raw tile with the transposed addressing the
//    forward uses for w^T; x's raw tile has the tokens outermost, and the
//    hi/lo split pass writes it transposed into the K-major B tiles.
//    Where a gradient's tiles are few (E4 C16 D256 F512: dx^T is 16 tiles
//    of 64 x 128, each a walk of 16 stages, on 132 SMs), its contraction
//    is split over a thread-block cluster of P blocks a tile (gmm.cuh,
//    split_of: the largest P <= 8 whose clusters are all resident at
//    once and which takes 3 stages or more off a walk), each walking
//    a run of stages in the one-block order, their sums then added in part
//    order through distributed shared memory (sum_parts).  P = 1 launches
//    the one-block kernel: at grok-1's and arctic-480b's widths the tiles
//    fill the card alone.
//  * `mma` (strides TMA cannot describe): the forward's mma.sync body, given
//    each product's strides, its walk split the same way where the grid is
//    small.
#include "gmm.cuh"

namespace {

// dx (C x D) = dy (C x F, K-major) @ w^T (w^T (f, d) at d F + f: K-major)
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(mma::NT)
gmm_bwd_dx_mma(const T* __restrict__ a, mma::Strides sa, const T* __restrict__ b, mma::Strides sb, T* __restrict__ out,
               int M, int N, int K, int n_n, int n_m, int spp) {
  mma::gmm_mma<T, true, true, ASYNC>(a, sa, b, sb, out, M, N, K, n_n, n_m, spp);
}

// dw (D x F) = x^T (x^T (d, c) at c D + d: M-major) @ dy (C x F, N-major)
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(mma::NT)
gmm_bwd_dw_mma(const T* __restrict__ a, mma::Strides sa, const T* __restrict__ b, mma::Strides sb, T* __restrict__ out,
               int M, int N, int K, int n_n, int n_m, int spp) {
  mma::gmm_mma<T, false, false, ASYNC>(a, sa, b, sb, out, M, N, K, n_n, n_m, spp);
}

// Ring depth and staging columns of each gradient's persistent kernel
// (gmm.cuh, gmm_wgmma_persistent): three stages of 64-deep slices beside
// the whole tile's staging for both.  Four stages beside half the staging,
// the epilogue in two passes, made dx slower at both shapes and dw 2.7
// (grok-1) to 4.7x (arctic) slower (PERF.md).  Where dw's contraction (C, the tokens an
// expert) is 65 to 96 deep, as arctic-480b's 80, a tile is one slice
// DW_SHORT_K deep instead of two 64-deep ones, and two such stages hold the
// next tile whole while this one's products and store run.
constexpr int DX_STAGES = 3, DX_STG_COLS = 256;
constexpr int DW_STAGES = 3, DW_STG_COLS = 256;
constexpr int DW_SHORT_K = 96, DW_SHORT_STAGES = 2;

__global__ void __launch_bounds__(tc::THREADS, 1)
gmm_bwd_dx_wgmma(const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap dxmap, int M, int N, int K, int n_m, int n_n, int tiles) {
  tc::gmm_wgmma_persistent<false, false, DX_STAGES, DX_STG_COLS, tc::BK>(&dymap, &wmap, &dxmap, M, N, K, n_m, n_n, tiles);
}

template <int STAGES_, int D>
__global__ void __launch_bounds__(tc::THREADS, 1)
gmm_bwd_dw_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
                 const __grid_constant__ CUtensorMap dwmap, int M, int N, int K, int n_m, int n_n, int tiles) {
  tc::gmm_wgmma_persistent<true, true, STAGES_, DW_STG_COLS, D>(&xmap, &dymap, &dwmap, M, N, K, n_m, n_n, tiles);
}

// dw (D x F) = x^T (x: rows of C) @ dy (rows of C), in slices D_ deep
template <int STAGES_, int D_>
int launch_dw_wgmma(const void* x, const void* dy, void* dw, int E, int C, int D, int F, int device, cudaStream_t s) {
  CUtensorMap amap, bmap, omap;
  int code = tc::make_maps<true, true, D_>(&amap, &bmap, x, dy, E, D, F, C);
  if (!code) code = tc::make_out_map(&omap, dw, E, D, F);
  if (!code) code = tc::launch_persistent<STAGES_, DW_STG_COLS, D_>(gmm_bwd_dw_wgmma<STAGES_, D_>, amap, bmap, omap, E, D, F, C, device, s);
  return code;
}

__global__ void __launch_bounds__(tf32x3::THREADS, 2)
gmm_bwd_dx_tf32x3(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap dymap,
                  float* __restrict__ dx, int M, int N, int K, int n_n, int n_m) {
  tf32x3::gmm_tf32x3<true, true>(&wmap, &dymap, dx, M, N, K, n_n, n_m);
}

__global__ void __launch_bounds__(tf32x3::THREADS, 2)
gmm_bwd_dw_tf32x3(const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap xmap,
                  float* __restrict__ dw, int M, int N, int K, int n_n, int n_m) {
  tf32x3::gmm_tf32x3<false, false>(&dymap, &xmap, dw, M, N, K, n_n, n_m);
}

// the same gradients with the contraction split over a cluster of blocks
__global__ void __launch_bounds__(tf32x3::THREADS, 2)
gmm_bwd_dx_tf32x3_split(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap dymap,
                        float* __restrict__ dx, int M, int N, int K, int n_n, int n_m, int spp) {
  tf32x3::gmm_tf32x3<true, true, true>(&wmap, &dymap, dx, M, N, K, n_n, n_m, spp);
}

__global__ void __launch_bounds__(tf32x3::THREADS, 2)
gmm_bwd_dw_tf32x3_split(const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap xmap,
                        float* __restrict__ dw, int M, int N, int K, int n_n, int n_m, int spp) {
  tf32x3::gmm_tf32x3<false, false, true>(&dymap, &xmap, dw, M, N, K, n_n, n_m, spp);
}

// The mma route's operands of each gradient: A, B and the product's (M, N, K)
template <typename T>
struct MmaGrad {
  const T *a, *b;
  mma::Strides sa, sb;
  int M, N, K;
};

// dx (C x D) = dy (C x F) @ w^T: w^T (f, d) at d F + f
template <typename T>
MmaGrad<T> dx_operands(const void* w, const void* dy, int C, int D, int F) {
  return {static_cast<const T*>(dy), static_cast<const T*>(w), {int64_t(C) * F, F, 1}, {int64_t(D) * F, 1, F}, C, D, F};
}

// dw (D x F) = x^T (D x C): x^T (d, c) at c D + d; @ dy (C x F)
template <typename T>
MmaGrad<T> dw_operands(const void* x, const void* dy, int C, int D, int F) {
  return {static_cast<const T*>(x), static_cast<const T*>(dy), {int64_t(C) * D, 1, D}, {int64_t(C) * F, F, 1}, D, F, C};
}

// Launch (or, with `out_desc`, describe) one gradient on the mma route:
// kernel <T, true> where its operands take 4-byte copies, else <T, false>.
template <typename T, bool A_K, bool B_K, typename Kernel>
int run_mma(Kernel async_kernel, Kernel staged_kernel, const MmaGrad<T>& g, void* out, int E, int device, cudaStream_t s,
            long long* out_desc) {
  const bool aligned = sizeof(T) == 4 || mma::pairs_aligned(g.a, g.sa, A_K, g.b, g.sb, B_K);
  Kernel kernel = aligned ? async_kernel : staged_kernel;
  if (out_desc) return mma::describe<T, A_K, B_K>(kernel, E, g.M, g.N, g.K, device, out_desc);
  return mma::launch<T, A_K, B_K>(kernel, g.a, g.sa, g.b, g.sb, static_cast<T*>(out), E, g.M, g.N, g.K, device, s);
}

// dx where `dx`, dw where `dw` (either may be null); with `desc`, describe
// the launch of the one gradient asked for instead
template <typename T>
int launch_mma(const void* x, const void* w, const void* dy, void* dx, void* dw, int E, int C, int D, int F, int device,
               cudaStream_t s, long long* desc = nullptr) {
  // fp32 always takes 4-byte copies: its staged kernel is never instantiated
  constexpr bool F32 = sizeof(T) == 4;
  int code = 0;
  if (dx) {
    code = run_mma<T, true, true>(gmm_bwd_dx_mma<T, true>, gmm_bwd_dx_mma<T, F32>, dx_operands<T>(w, dy, C, D, F), dx, E,
                                  device, s, desc);
  }
  if (dw && !code) {
    code = run_mma<T, false, false>(gmm_bwd_dw_mma<T, true>, gmm_bwd_dw_mma<T, F32>, dw_operands<T>(x, dy, C, D, F), dw, E,
                                    device, s, desc);
  }
  return code;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = mma (either dtype),
// 1 = wgmma (bfloat16 only), 2 = tf32x3 (float32 only), as the forward's.
// The tf32x3 and mma walks are split by their rule (gmm.cuh, split_of).
// dx or dw may be null: that gradient is not computed.
// Returns cudaGetLastError() after the launches (0 on success), or the
// error of a refused cluster launch.
int moe_gmm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw, int E, int C, int D, int F,
                int dtype, int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap amap, bmap, omap;
  int code = 0;
  if (route == 1 && dtype == 1) {
    if (dx) {  // dx (C x D) = dy (C x F, K-major) @ w^T (w: rows of D, F contiguous: K-major)
      code = tc::make_maps<false, false>(&amap, &bmap, dy, w, E, C, D, F);
      if (!code) code = tc::make_out_map(&omap, dx, E, C, D);
      if (!code) code = tc::launch_persistent<DX_STAGES, DX_STG_COLS, tc::BK>(gmm_bwd_dx_wgmma, amap, bmap, omap, E, C, D, F, device, s);
    }
    if (dw && !code) {
      code = C > tc::BK && C <= DW_SHORT_K ? launch_dw_wgmma<DW_SHORT_STAGES, DW_SHORT_K>(x, dy, dw, E, C, D, F, device, s)
                                           : launch_dw_wgmma<DW_STAGES, tc::BK>(x, dy, dw, E, C, D, F, device, s);
    }
    return code;
  }
  if (route == 2 && dtype == 0) {
    if (dx) {  // dx^T (D x C) = w (D x F, K-major) dy^T (dy K-major)
      code = tf32x3::make_maps<true, true>(&amap, &bmap, w, dy, E, D, C, F);
      if (!code) code = tf32x3::launch_grad(gmm_bwd_dx_tf32x3, gmm_bwd_dx_tf32x3_split, amap, bmap, dx, E, D, C, F, device, s);
    }
    if (dw && !code) {  // dw^T (F x D) = dy^T (dy: rows of C) x (rows of C)
      code = tf32x3::make_maps<false, false>(&amap, &bmap, dy, x, E, F, D, C);
      if (!code) code = tf32x3::launch_grad(gmm_bwd_dw_tf32x3, gmm_bwd_dw_tf32x3_split, amap, bmap, dw, E, F, D, C, device, s);
    }
    return code;
  }
  if (route != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) return launch_mma<float>(x, w, dy, dx, dw, E, C, D, F, device, s);
  if (dtype == 1) return launch_mma<__nv_bfloat16>(x, w, dy, dx, dw, E, C, D, F, device, s);
  return int(cudaErrorInvalidValue);
}

// The launch of one gradient (grad 0: dx, 1: dw) at (E, C, D, F, dtype) on
// `route` (0 mma, 2 tf32x3) on `device`, by the rule, as describe_launch
// writes it into out[19]: parts, blocks, threads, shared memory, blocks and
// warps an SM, resident clusters of its parts, stages, stages a part, SMs,
// the fewest stages a split must save, then resident clusters of 1 to 8
// blocks.  x, w and dy: the
// operands' data pointers, whose alignment picks the mma route's kernel
// (null pointers count as aligned).  Returns 0 or a CUDA error.
int moe_gmm_bwd_describe(const void* x, const void* w, const void* dy, int grad, int E, int C, int D, int F, int dtype,
                         int route, int device, long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (grad != 0 && grad != 1) return int(cudaErrorInvalidValue);
  if (route == 2 && dtype == 0) {
    if (grad == 0) return tf32x3::describe_grad(gmm_bwd_dx_tf32x3_split, E, D, C, F, device, out);
    return tf32x3::describe_grad(gmm_bwd_dw_tf32x3_split, E, F, D, C, device, out);
  }
  if (route != 0) return int(cudaErrorInvalidValue);
  // a non-null output pointer marks the gradient to describe
  void* dx = grad == 0 ? out : nullptr;
  void* dw = grad == 1 ? out : nullptr;
  if (dtype == 0) return launch_mma<float>(x, w, dy, dx, dw, E, C, D, F, device, nullptr, out);
  if (dtype == 1) return launch_mma<__nv_bfloat16>(x, w, dy, dx, dw, E, C, D, F, device, nullptr, out);
  return int(cudaErrorInvalidValue);
}

// The dynamic shared memory a block of the wgmma route's kernels holds
// (the ring and the epilogue's staging tile): dx (kernel = 0), dw (1), dw
// in slices DW_SHORT_K deep (2).
int moe_gmm_bwd_wgmma_smem(int kernel) {
  if (kernel == 0) return int(tc::persistent_smem<DX_STAGES, DX_STG_COLS, tc::BK>());
  if (kernel == 1) return int(tc::persistent_smem<DW_STAGES, DW_STG_COLS, tc::BK>());
  return int(tc::persistent_smem<DW_SHORT_STAGES, DW_STG_COLS, DW_SHORT_K>());
}

const char* moe_gmm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
