// The row-restricted relaxation pass of the dynamic engine on Hopper
// (sm_90a), with and without a witness.
//
// Replaces the TPU kernel row_close_pallas (src/repro/kernels/row_close.py:82;
// its pallas_calls at :142 with the witness, :152 without).  On a float32
// (n, n) matrix D and an int32 list of r row ids R (repeats allowed):
//   row_close<SR>         Z = D[R, :] ⊕ (D[R, :] ⊗ D)            (r, n)
//   row_close_argmin<SR>  (Z, K*): K* the smallest k whose candidate
//                         strictly improved on D[R, :], -1 where it was kept
// over (n/BN, r/BM) CTAs.  Row i of a tile reads row R[m0 + i] of D in the
// kernel (GatheredRows in minplus_tile.cuh), both for the x operand and for
// the ⊕-operand the tile starts from, so no (r, n) copy of D[R, :] is made
// on the host; Y is D itself.  The TPU kernel got the same gather from
// scalar prefetch into its BlockSpec index maps.
//
// Everything else is the staged fold (fold_tile / fold_tile_argmin, with
// the tiles minplus.cu had before it moved onto the cp.async ring): one thread folds each output element over k in
// ascending order with the strict Semiring::better, so ties keep the
// smallest k and a NaN candidate never improves, the port's witness rule.
// A repeated row id computes the same panel row twice; the caller's
// index_copy_ then writes equal values, so the result does not depend on
// which write lands last.  The kernel never writes D: the caller writes the
// panel back after the pass, so each pass reads the state before it, as
// the JAX pass does.
//
// What bounds it on this card.  r * n * n candidates at two FP32
// instructions each (four with the witness), on the CUDA cores; the bytes
// (D read once, the panel written once) are far below that at any r the
// engine sends (r >= 4).  This first version keeps minplus's 128-row tile,
// so a row list shorter than 128 leaves part of each tile idle and a short
// list fills fewer CTAs than the card has SMs; PERF.md has its times.
//
// The wrapper (kernels/row_close.py) checks shapes and the row ids (each in
// [0, n)), so the gather needs no bounds check, and allocates the outputs;
// the kernel launches on the caller's stream and its error is returned.
#include <cuda_runtime.h>

#include "minplus_tile.cuh"
#include "semiring.cuh"

namespace repro_torch {

template <bool TRACK> struct RowTiles;
template <> struct RowTiles<false> { static constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8; };
template <> struct RowTiles<true> { static constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 4; };

template <bool TRACK>
using RowShape = TileShape<RowTiles<TRACK>::BM, RowTiles<TRACK>::BN, RowTiles<TRACK>::BK,
                           RowTiles<TRACK>::TM, RowTiles<TRACK>::TN>;

template <int SR, bool TRACK>
__device__ __forceinline__ void close_rows(const float* __restrict__ d,
                                           const int* __restrict__ rows, float* __restrict__ z,
                                           int* __restrict__ kstar, int r, int n) {
  using C = RowTiles<TRACK>;
  using Shape = RowShape<TRACK>;
  __shared__ __align__(16) float smem[Shape::kSmemFloats];
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int r0 = m0 + Shape::row(threadIdx.x), c0 = n0 + Shape::col(threadIdx.x);
  float acc[C::TM][C::TN];
  int idx[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const bool row_in = r0 + i < r;
    const long long src = row_in ? (long long)rows[r0 + i] * n : 0;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      acc[i][j] = (row_in && c0 + j < n) ? d[src + c0 + j] : Semiring<SR>::zero();
      idx[i][j] = -1;
    }
  }
  const GatheredRows gather{rows};
  if constexpr (TRACK)
    fold_tile_argmin<SR, C::BM, C::BN, C::BK, C::TM, C::TN>(acc, idx, d, n, d, n, m0, n0, r,
                                                             n, n, smem, gather);
  else
    fold_tile<SR, C::BM, C::BN, C::BK, C::TM, C::TN>(acc, d, n, d, n, m0, n0, r, n, n, smem,
                                                     gather);
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
      if (r0 + i < r && c0 + j < n) {
        const long long e = (long long)(r0 + i) * n + c0 + j;
        z[e] = acc[i][j];
        if constexpr (TRACK) kstar[e] = idx[i][j];
      }
}

// Two CTAs an SM (at most 128 registers a thread), as minplus.
template <int SR>
__global__ void __launch_bounds__(RowShape<false>::kThreads, 2)
row_close(const float* __restrict__ d, const int* __restrict__ rows, float* __restrict__ z,
          int r, int n) {
  close_rows<SR, false>(d, rows, z, nullptr, r, n);
}

template <int SR>
__global__ void __launch_bounds__(RowShape<true>::kThreads, 2)
row_close_argmin(const float* __restrict__ d, const int* __restrict__ rows,
                 float* __restrict__ z, int* __restrict__ kstar, int r, int n) {
  close_rows<SR, true>(d, rows, z, kstar, r, n);
}

template <int SR>
cudaError_t launch(bool track, const float* d, const int* rows, float* z, int* kstar, int r,
                   int n, cudaStream_t s) {
  if (track) {
    using C = RowTiles<true>;
    const dim3 grid((n + C::BN - 1) / C::BN, (r + C::BM - 1) / C::BM);
    row_close_argmin<SR><<<grid, RowShape<true>::kThreads, 0, s>>>(d, rows, z, kstar, r, n);
  } else {
    using C = RowTiles<false>;
    const dim3 grid((n + C::BN - 1) / C::BN, (r + C::BM - 1) / C::BM);
    row_close<SR><<<grid, RowShape<false>::kThreads, 0, s>>>(d, rows, z, r, n);
  }
  return cudaGetLastError();
}

}  // namespace repro_torch

// C interface for ctypes.  d (n, n) contiguous float32; rows (r,) int32,
// each in [0, n); z (r, n) float32; kstar (r, n) int32, null when
// track == 0.  Returns a cudaError_t.
extern "C" int row_close_launch(int semiring, int track, const void* d, const void* rows,
                                void* z, void* kstar, int r, int n, void* stream) {
  using namespace repro_torch;
  if (r < 1 || n < 1 || !d || !rows || !z || (track && !kstar) || (r + 127) / 128 > 65535)
    return cudaErrorInvalidValue;
  const float* df = static_cast<const float*>(d);
  const int* ri = static_cast<const int*>(rows);
  float* zf = static_cast<float*>(z);
  int* ks = static_cast<int*>(kstar);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return launch<0>(track, df, ri, zf, ks, r, n, s);
    case 1: return launch<1>(track, df, ri, zf, ks, r, n, s);
    case 2: return launch<2>(track, df, ri, zf, ks, r, n, s);
    case 3: return launch<3>(track, df, ri, zf, ks, r, n, s);
    default: return cudaErrorInvalidValue;
  }
}
