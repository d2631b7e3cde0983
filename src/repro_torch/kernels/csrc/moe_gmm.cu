// Grouped (per-expert) matrix product for Hopper (sm_90a): y[e] = x[e] @ w[e].
//
// Replaces the TPU kernel `moe_gmm` / `_gmm_kernel` in
// src/repro/kernels/moe_gmm.py (pallas_call at line 60).
//
// What it computes: x (E,C,D) and w (E,D,F), both fp32 or both bf16, give
// y (E,C,F) in x's type, summed in fp32.  Capacity is dense per expert.
//
// What bounds it on this card: at the grok-1 width the port runs
// (E 8, C 1280, D 6144, F 32768) the product does ~4e12 operations on ~4e9
// bytes (bf16), about 1000 operations a byte, so it is bound by operations:
// the tensor cores' rate for the operands' type.
//
// Three kernels, chosen by a rule in kernels/moe_gmm.py (`route`); their
// bodies, shared with the backward (moe_gmm_bwd.cu), and their design are in
// gmm.cuh:
//  * `wgmma` (bf16 operands whose strides TMA can describe): x is the
//    K-major A operand, w the N-major B operand, read through wgmma's
//    transpose bit;
//  * `tf32x3` (fp32 operands whose strides TMA can describe): y^T = w^T x^T
//    on three TF32 products a term, w^T the register A operand loaded from
//    w's raw tile, x the K-major B operand; the variant (the C columns a
//    block, 64 or 128, and the ring's stages, 2 or 3) is the one the
//    reference's block_c and block_d pick (kernels/moe_gmm.py: tile);
//  * `mma` (the rest: any strides): warp-level mma.sync products fed by
//    cp.async, x K-major and w N-major, each read by its own addressing.
#include "gmm.cuh"

namespace {

// y (C x F) = x (C x D, K-major) @ w (D x F, N-major); ASYNC: 4-byte copies
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(mma::NT)
gmm_fwd_mma(const T* __restrict__ x, mma::Strides sx, const T* __restrict__ w, mma::Strides sw, T* __restrict__ y, int M,
            int N, int K, int n_n, int n_m, int spp) {
  mma::gmm_mma<T, true, false, ASYNC>(x, sx, w, sw, y, M, N, K, n_n, n_m, spp);
}

__global__ void __launch_bounds__(tc::THREADS, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
          __nv_bfloat16* __restrict__ y, int M, int N, int K, int n_m, int n_n) {
  tc::gmm_wgmma<false, true>(&xmap, &wmap, y, M, N, K, n_m, n_n);
}

template <typename TL>
__global__ void __launch_bounds__(tf32x3::THREADS, 2)
gmm_tf32x3(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
           float* __restrict__ y, int M, int N, int K, int n_n, int n_m) {
  tf32x3::gmm_tf32x3<false, true, false, TL>(&wmap, &xmap, y, M, N, K, n_n, n_m);
}

// y^T (F x C) = w^T (F x D, rows of D) x^T (x K-major) on the tile TL
template <typename TL>
int launch_tf32x3(const void* x, const void* w, void* y, int E, int C, int D, int F, cudaStream_t s) {
  CUtensorMap amap, bmap;
  const int code = tf32x3::make_maps<false, true, TL::BN>(&amap, &bmap, w, x, E, F, C, D);
  return code ? code : tf32x3::launch<TL>(gmm_tf32x3<TL>, amap, bmap, y, E, F, C, D, s);
}

// x's and w's strides: x (e, c, d) at e C D + c D + d; w (e, d, f) at e D F + d F + f
inline mma::Strides x_strides(int C, int D) { return {int64_t(C) * D, D, 1}; }
inline mma::Strides w_strides(int D, int F) { return {int64_t(D) * F, F, 1}; }

template <typename T>
int launch_mma(const void* x, const void* w, void* y, int E, int C, int D, int F, int device, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const mma::Strides sx = x_strides(C, D), sw = w_strides(D, F);
  T* yt = static_cast<T*>(y);
  if constexpr (sizeof(T) == 2) {
    if (!mma::pairs_aligned(x, sx, true, w, sw, false))
      return mma::launch<T, true, false>(gmm_fwd_mma<T, false>, xt, sx, wt, sw, yt, E, C, F, D, device, stream);
  }
  return mma::launch<T, true, false>(gmm_fwd_mma<T, true>, xt, sx, wt, sw, yt, E, C, F, D, device, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = mma (either dtype),
// 1 = wgmma (bfloat16 only), 2 = tf32x3 (float32 only).  The mma route
// splits its walk by its rule (gmm.cuh, split_of).  bn, stages (tf32x3
// only, else unread): the variant, the C columns a block (64 or 128) and
// the ring's stages (2 or 3).  Returns cudaGetLastError() after the launch
// (0 on success), or the error of a refused cluster launch.
int moe_gmm_fwd(const void* x, const void* w, void* y, int E, int C, int D, int F, int dtype,
                int route, int bn, int stages, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap amap, bmap;
  if (route == 1 && dtype == 1) {  // y (C x F) = x (C x D, K-major) @ w (D x F, N-major)
    int code = tc::make_maps<false, true>(&amap, &bmap, x, w, E, C, F, D);
    return code ? code : tc::launch(gmm_wgmma, amap, bmap, y, E, C, F, D, s);
  }
  if (route == 2 && dtype == 0) {
    using tf32x3::Tile;
    if (bn == 64 && stages == 2) return launch_tf32x3<Tile<64, 2>>(x, w, y, E, C, D, F, s);
    if (bn == 64 && stages == 3) return launch_tf32x3<Tile<64, 3>>(x, w, y, E, C, D, F, s);
    if (bn == 128 && stages == 2) return launch_tf32x3<Tile<128, 2>>(x, w, y, E, C, D, F, s);
    if (bn == 128 && stages == 3) return launch_tf32x3<Tile<128, 3>>(x, w, y, E, C, D, F, s);
    return int(cudaErrorInvalidValue);
  }
  if (route != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) return launch_mma<float>(x, w, y, E, C, D, F, device, s);
  if (dtype == 1) return launch_mma<__nv_bfloat16>(x, w, y, E, C, D, F, device, s);
  return int(cudaErrorInvalidValue);
}

// The launch of the mma route at (E, C, D, F, dtype) on `device` for x and
// w at their data pointers (their alignment picks the kernel), as
// describe_launch writes it into out[19]: parts, blocks, threads, shared
// memory, blocks and warps an SM, resident clusters of its parts, stages,
// stages a part, SMs, the fewest stages a split must save, then resident
// clusters of 1 to 8 blocks.  The
// tf32x3 forward takes one part, always.  Returns 0 or a CUDA error.
int moe_gmm_fwd_describe(const void* x, const void* w, int E, int C, int D, int F, int dtype, int device, long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const mma::Strides sx = x_strides(C, D), sw = w_strides(D, F);
  if (dtype == 0) return mma::describe<float, true, false>(gmm_fwd_mma<float, true>, E, C, F, D, device, out);
  if (dtype != 1) return int(cudaErrorInvalidValue);
  if (mma::pairs_aligned(x, sx, true, w, sw, false))
    return mma::describe<__nv_bfloat16, true, false>(gmm_fwd_mma<__nv_bfloat16, true>, E, C, F, D, device, out);
  return mma::describe<__nv_bfloat16, true, false>(gmm_fwd_mma<__nv_bfloat16, false>, E, C, F, D, device, out);
}

const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
