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
//  * `simt` (strides TMA cannot describe): the forward's CUDA-core body, given
//    each product's strides.
#include "gmm.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(simt::NT)
gmm_bwd_simt(const T* __restrict__ a, simt::Strides sa, const T* __restrict__ b, simt::Strides sb,
             T* __restrict__ out, int M, int N, int K) {
  simt::gmm_simt<T>(a, sa, b, sb, out, M, N, K);
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

template <typename T>
int launch_simt(const void* x, const void* w, const void* dy, void* dx, void* dw, int E, int C, int D, int F,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* dyt = static_cast<const T*>(dy);
  const simt::Strides x_s{int64_t(C) * D, D, 1}, dy_s{int64_t(C) * F, F, 1};
  if (dx) {  // dx (C x D) = dy (C x F) @ w^T: w^T (f, d) at d F + f
    gmm_bwd_simt<T><<<simt::grid(E, C, D), simt::NT, 0, stream>>>(dyt, dy_s, wt, {int64_t(D) * F, 1, F},
                                                                   static_cast<T*>(dx), C, D, F);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  if (dw) {  // dw (D x F) = x^T (D x C): x^T (d, c) at c D + d; @ dy (C x F)
    gmm_bwd_simt<T><<<simt::grid(E, D, F), simt::NT, 0, stream>>>(xt, {x_s.e, 1, D}, dyt, dy_s,
                                                                   static_cast<T*>(dw), D, F, C);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = simt (either dtype),
// 1 = wgmma (bfloat16 only), 2 = tf32x3 (float32 only), as the forward's.
// dx or dw may be null: that gradient is not computed.  Returns
// cudaGetLastError() after the launches (0 on success).
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
      if (!code) code = tf32x3::launch(gmm_bwd_dx_tf32x3, amap, bmap, dx, E, D, C, F, s);
    }
    if (dw && !code) {  // dw^T (F x D) = dy^T (dy: rows of C) x (rows of C)
      code = tf32x3::make_maps<false, false>(&amap, &bmap, dy, x, E, F, D, C);
      if (!code) code = tf32x3::launch(gmm_bwd_dw_tf32x3, amap, bmap, dw, E, F, D, C, s);
    }
    return code;
  }
  if (route != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) return launch_simt<float>(x, w, dy, dx, dw, E, C, D, F, s);
  if (dtype == 1) return launch_simt<__nv_bfloat16>(x, w, dy, dx, dw, E, C, D, F, s);
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
