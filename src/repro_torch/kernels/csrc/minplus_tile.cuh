// The tiled ⊕⊗ fold shared by the port's kernels: one CTA folds
//   acc[i][j] = acc[i][j] ⊕ (⊕_k x[i][k] ⊗ y[k][j])
// over k = 0..K into a BM x BN output tile held as TM x TN register
// micro-tiles, one per thread, with k staged through shared memory BK at a
// time.  It ports _minplus_body (src/repro/kernels/minplus.py:75): the same
// candidate set folded into the same accumulator, so with a selective ⊕ the
// bits match the TPU kernel and the plain version.
//
// (min, +) has no tensor-core instruction, so the fold runs on the CUDA
// cores: every candidate costs one ⊗ and one ⊕ instruction.  The TM x TN
// micro-tile gives TM*TN candidates for TM + TN shared-memory reads, which
// keeps the fold bound by those instructions rather than by shared memory.
//
// Out-of-range rows, columns and k are staged as the semiring zero: zero ⊗
// zero = zero for every built-in semiring, so padded k adds nothing, and
// padded rows and columns are never stored.
//
// fold_tile_argmin is the witness fold (the TPU body's ``track`` flag): each
// output element is folded by one thread in ascending k with the strict
// Semiring::better, so ties keep the smallest k (jnp.argmin's rule) with no
// extra work, and the element's global k index rides beside its value.
// Padded k is skipped, so it can never be a witness.
//
// Row i of the tile's x operand is row xrows(m0 + i) of x: ContiguousRows
// (the default) reads rows m0.. as they lie, GatheredRows reads the rows a
// list names (row_close.cu gathers the affected rows of D this way, in the
// kernel).  The default compiles to the same index arithmetic as before.
#pragma once

#include "semiring.cuh"

namespace repro_torch {

struct ContiguousRows {
  __device__ __forceinline__ long long operator()(int r) const { return r; }
};

struct GatheredRows {
  const int* rows;  // r row ids, each in [0, M of the source)
  __device__ __forceinline__ long long operator()(int r) const { return rows[r]; }
};

template <int BM, int BN, int BK, int TM, int TN>
struct TileShape {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kXStride = BM + 4;  // pad the transposed x tile; keeps 16-byte rows
  static constexpr int kSmemFloats = BK * kXStride + BK * BN;
  // Output coordinates of acc[i][j] for thread t: row m0 + row(t) + i,
  // column n0 + col(t) + j.
  static __device__ __forceinline__ int row(int t) { return (t / (BN / TN)) * TM; }
  static __device__ __forceinline__ int col(int t) { return (t % (BN / TN)) * TN; }
};

// Stage k slice k0..k0+BK of x (transposed) and y into shared memory.
template <int SR, int BM, int BN, int BK, int TM, int TN, class TX, class TY, class XRows>
__device__ __forceinline__ void stage_slice(
    const TX* __restrict__ x, long long ldx, const TY* __restrict__ y, long long ldy,
    int m0, int n0, int M, int N, int K, int k0, float* sx, float* sy, XRows xrows) {
  using S = Semiring<SR>;
  using Shape = TileShape<BM, BN, BK, TM, TN>;
  const int t = threadIdx.x;
  for (int e = t; e < BM * BK; e += Shape::kThreads) {
    const int r = e / BK, c = e % BK;
    const int gr = m0 + r, gk = k0 + c;
    sx[c * Shape::kXStride + r] =
        (gr < M && gk < K) ? Storage<TX>::load(x[xrows(gr) * ldx + gk]) : S::zero();
  }
  for (int e = t; e < BK * BN; e += Shape::kThreads) {
    const int r = e / BN, c = e % BN;
    const int gk = k0 + r, gc = n0 + c;
    sy[r * BN + c] =
        (gk < K && gc < N) ? Storage<TY>::load(y[gk * ldy + gc]) : S::zero();
  }
}

// Row kk of the staged slice at this thread's micro-tile, as float4s.
template <int BM, int BN, int BK, int TM, int TN>
__device__ __forceinline__ void read_slice(const float* sx, const float* sy, int kk,
                                           int r0, int c0, float (&a)[TM], float (&b)[TN]) {
  using Shape = TileShape<BM, BN, BK, TM, TN>;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "micro-tiles are read as float4");
#pragma unroll
  for (int i = 0; i < TM; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(&sx[kk * Shape::kXStride + r0 + i]);
    a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < TN; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(&sy[kk * BN + c0 + j]);
    b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
  }
}

// x: rows m0.. of an (M, K) matrix with row stride ldx (through xrows); y: a
// (K, N) matrix with row stride ldy, columns n0..; smem holds
// TileShape::kSmemFloats.  Every thread of the CTA must call it (it
// synchronises the CTA).
template <int SR, int BM, int BN, int BK, int TM, int TN, class TX, class TY,
          class XRows = ContiguousRows>
__device__ __forceinline__ void fold_tile(
    float (&acc)[TM][TN], const TX* __restrict__ x, long long ldx,
    const TY* __restrict__ y, long long ldy, int m0, int n0, int M, int N,
    int K, float* smem, XRows xrows = XRows()) {
  using S = Semiring<SR>;
  using Shape = TileShape<BM, BN, BK, TM, TN>;
  float* sx = smem;                          // [BK][kXStride], x transposed
  float* sy = smem + BK * Shape::kXStride;   // [BK][BN]
  const int r0 = Shape::row(threadIdx.x);
  const int c0 = Shape::col(threadIdx.x);

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_slice<SR, BM, BN, BK, TM, TN>(x, ldx, y, ldy, m0, n0, M, N, K, k0, sx, sy, xrows);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      read_slice<BM, BN, BK, TM, TN>(sx, sy, kk, r0, c0, a, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = S::add(acc[i][j], S::mul(a[i], b[j]));
    }
    __syncthreads();
  }
}

// The witness fold: as fold_tile, plus idx[i][j], the global k (0..K) of
// the candidate that last strictly improved acc[i][j]; untouched where none
// did.  Same contract and shared-memory size as fold_tile.
template <int SR, int BM, int BN, int BK, int TM, int TN, class TX, class TY,
          class XRows = ContiguousRows>
__device__ __forceinline__ void fold_tile_argmin(
    float (&acc)[TM][TN], int (&idx)[TM][TN], const TX* __restrict__ x, long long ldx,
    const TY* __restrict__ y, long long ldy, int m0, int n0, int M, int N, int K,
    float* smem, XRows xrows = XRows()) {
  using S = Semiring<SR>;
  using Shape = TileShape<BM, BN, BK, TM, TN>;
  float* sx = smem;
  float* sy = smem + BK * Shape::kXStride;
  const int r0 = Shape::row(threadIdx.x);
  const int c0 = Shape::col(threadIdx.x);

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_slice<SR, BM, BN, BK, TM, TN>(x, ldx, y, ldy, m0, n0, M, N, K, k0, sx, sy, xrows);
    __syncthreads();
    const int kn = K - k0;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk < kn) {
        float a[TM], b[TN];
        read_slice<BM, BN, BK, TM, TN>(sx, sy, kk, r0, c0, a, b);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const float c = S::mul(a[i], b[j]);
            if (S::better(c, acc[i][j])) {
              acc[i][j] = c;
              idx[i][j] = k0 + kk;
            }
          }
      }
    }
    __syncthreads();
  }
}

}  // namespace repro_torch
