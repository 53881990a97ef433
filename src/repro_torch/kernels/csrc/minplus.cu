// The tiled ⊕⊗ product on Hopper (sm_90a), with and without a witness.
//
// Replaces the TPU kernels minplus_pallas (src/repro/kernels/minplus.py:235)
// and minplus_argmin_pallas (:284), one Pallas body (_minplus_body, :75)
// with two flags.  Here it is one template, <SR, TRACK, ACC>, behind two
// kernel names so that a profile tells them apart:
//   minplus<SR, ACC>         Z = [A ⊕] X ⊗ Y
//   minplus_argmin<SR, ACC>  (Z, K*): K* the global k of the strict winner,
//                            -1 where nothing improved on the start value
// on (G, M, K) x (G, K, N) float32 operands, over (N/BN, M/BM, G) CTAs.
// ACC starts each output element from A, otherwise from the semiring zero;
// either way K* starts at -1.  A strict improvement from the zero leaves -1
// exactly where the reference's is_zero mask puts it, and a strict
// improvement over A leaves -1 where A was kept.
//
// Witness rule.  One thread folds each output element over k in ascending
// order with the strict Semiring::better (fold_tile_argmin), so ties keep
// the smallest k, as jnp.argmin does.  A split-k or tree reduction would
// need a lexicographic (value, k) combine instead.  A NaN candidate never
// improves and a NaN accumulator is never replaced (a comparison with NaN
// is false): the port's NaN rule, which the plain version in
// kernels/minplus.py follows too.  bf16 operands are upcast by the caller
// (kernels/ops.py), so the witness is decided in f32 before the value is
// rounded, as in the JAX package.
//
// What bounds it on this card.  Each candidate costs one ⊗ and one ⊕
// (minplus) or one ⊗, one compare and two selects (minplus_argmin) FP32
// instructions on the CUDA cores: no tensor-core MMA computes a (min, +)
// product.  At the blocked-FW shapes (K = B = 256) the operations bound is
// far above the bytes bound.  The register micro-tiles keep shared-memory
// reads below the instruction rate.  The witness tile holds int32 indices
// beside the floats, so it is 8 x 4 (64 live accumulator registers) where
// the value tile is 8 x 8.
//
// The wrapper (kernels/minplus.py) checks shapes and allocates the outputs;
// the kernel launches on the caller's stream and its error is returned.
#include <cuda_runtime.h>

#include "minplus_tile.cuh"
#include "semiring.cuh"

namespace repro_torch {

template <bool TRACK> struct Tiles;
template <> struct Tiles<false> { static constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8; };
template <> struct Tiles<true> { static constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 4; };

template <bool TRACK>
using ShapeOf = TileShape<Tiles<TRACK>::BM, Tiles<TRACK>::BN, Tiles<TRACK>::BK,
                          Tiles<TRACK>::TM, Tiles<TRACK>::TN>;

template <int SR, bool TRACK, bool ACC>
__device__ __forceinline__ void product_tile(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ a,
    float* __restrict__ z, int* __restrict__ kstar, int m, int k, int n) {
  using C = Tiles<TRACK>;
  using Shape = ShapeOf<TRACK>;
  __shared__ __align__(16) float smem[Shape::kSmemFloats];
  const long long g = blockIdx.z;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  x += g * m * k;
  y += g * k * n;
  const long long zo = g * m * n;
  const int r0 = m0 + Shape::row(threadIdx.x), c0 = n0 + Shape::col(threadIdx.x);
  float acc[C::TM][C::TN];
  int idx[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const bool in = r0 + i < m && c0 + j < n;
      acc[i][j] = (ACC && in) ? a[zo + (long long)(r0 + i) * n + c0 + j] : Semiring<SR>::zero();
      idx[i][j] = -1;
    }
  if constexpr (TRACK)
    fold_tile_argmin<SR, C::BM, C::BN, C::BK, C::TM, C::TN>(acc, idx, x, k, y, n, m0, n0, m,
                                                             n, k, smem);
  else
    fold_tile<SR, C::BM, C::BN, C::BK, C::TM, C::TN>(acc, x, k, y, n, m0, n0, m, n, k, smem);
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
      if (r0 + i < m && c0 + j < n) {
        const long long e = zo + (long long)(r0 + i) * n + c0 + j;
        z[e] = acc[i][j];
        if constexpr (TRACK) kstar[e] = idx[i][j];
      }
}

// Two CTAs an SM (at most 128 registers a thread), as fw_update.
template <int SR, bool ACC>
__global__ void __launch_bounds__(ShapeOf<false>::kThreads, 2)
minplus(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ a,
        float* __restrict__ z, int m, int k, int n) {
  product_tile<SR, false, ACC>(x, y, a, z, nullptr, m, k, n);
}

template <int SR, bool ACC>
__global__ void __launch_bounds__(ShapeOf<true>::kThreads, 2)
minplus_argmin(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ a, float* __restrict__ z, int* __restrict__ kstar,
               int m, int k, int n) {
  product_tile<SR, true, ACC>(x, y, a, z, kstar, m, k, n);
}

template <int SR, bool TRACK, bool ACC>
cudaError_t launch(const float* x, const float* y, const float* a, float* z, int* kstar,
                   int g, int m, int k, int n, cudaStream_t s) {
  using C = Tiles<TRACK>;
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, g);
  if constexpr (TRACK)
    minplus_argmin<SR, ACC><<<grid, ShapeOf<true>::kThreads, 0, s>>>(x, y, a, z, kstar, m, k, n);
  else
    minplus<SR, ACC><<<grid, ShapeOf<false>::kThreads, 0, s>>>(x, y, a, z, m, k, n);
  return cudaGetLastError();
}

template <int SR>
cudaError_t dispatch(bool track, bool acc, const float* x, const float* y, const float* a,
                     float* z, int* kstar, int g, int m, int k, int n, cudaStream_t s) {
  if (track)
    return acc ? launch<SR, true, true>(x, y, a, z, kstar, g, m, k, n, s)
               : launch<SR, true, false>(x, y, a, z, kstar, g, m, k, n, s);
  return acc ? launch<SR, false, true>(x, y, a, z, kstar, g, m, k, n, s)
             : launch<SR, false, false>(x, y, a, z, kstar, g, m, k, n, s);
}

}  // namespace repro_torch

// C interface for ctypes.  x (g, m, k), y (g, k, n), a and z (g, m, n):
// contiguous float32; a may be null when acc == 0; kstar (g, m, n) int32,
// null when track == 0.  Returns a cudaError_t.
extern "C" int minplus_launch(int semiring, int track, int acc, const void* x, const void* y,
                              const void* a, void* z, void* kstar, int g, int m, int k, int n,
                              void* stream) {
  using namespace repro_torch;
  if (g < 1 || g > 65535 || m < 1 || n < 1 || k < 0 || (acc && !a) || (track && !kstar) ||
      (m + 127) / 128 > 65535)
    return cudaErrorInvalidValue;
  const float *xf = static_cast<const float*>(x), *yf = static_cast<const float*>(y),
              *af = static_cast<const float*>(a);
  float* zf = static_cast<float*>(z);
  int* ks = static_cast<int*>(kstar);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return dispatch<0>(track, acc, xf, yf, af, zf, ks, g, m, k, n, s);
    case 1: return dispatch<1>(track, acc, xf, yf, af, zf, ks, g, m, k, n, s);
    case 2: return dispatch<2>(track, acc, xf, yf, af, zf, ks, g, m, k, n, s);
    case 3: return dispatch<3>(track, acc, xf, yf, af, zf, ks, g, m, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}
