// The row-restricted relaxation pass of the dynamic engine on Hopper
// (sm_90a): values, witnesses, and predecessors derived from the witnesses
// in the epilogue.
//
// Replaces the TPU kernel row_close_pallas (src/repro/kernels/row_close.py:82;
// its pallas_calls at :142 with the witness, :152 without), and the
// predecessor rule that the JAX package applies to its witnesses afterwards
// (ops.row_restricted_close, pred_from_kstar).  On a float32 (n, n) matrix D
// and an int32 list of r row ids R (repeats allowed), one template <SR, MODE,
// BM> behind three kernel names, as minplus.cu has:
//   row_close<SR, BM>         Z = D[R, :] ⊕ (D[R, :] ⊗ D)            (r, n)
//   row_close_argmin<SR, BM>  (Z, K*): K* the smallest k whose candidate
//                             strictly improved on D[R, :], -1 where kept
//   row_close_pred<SR, BM>    (Z, P): for output (i, j) with winner k*,
//                             pred[R[i], k*] when k* == j, else pred[k*, j];
//                             pred[R[i], j] where nothing improved.  K* is
//                             never stored.
// Witness and NaN rules are minplus.cu's: the witness of a fold of each
// output over k in ascending order with the strict Semiring::better (which
// fold_ring defers, bit for bit), so ties keep the smallest k, a NaN
// candidate never improves and a NaN start value is never replaced.  The kernel never writes D: the caller writes the panel back
// after the pass, so each pass reads the state before it, as the JAX pass
// does.  A repeated row id computes the same panel row twice.
//
// The fold.  A small grid, rows_kmajor, writes D[R, :]^T into an f32 (n, rp)
// scratch (rp: r rounded up to 32), so that both operands of the cp.async
// ring (fold_ring, minplus_tile.cuh) are k-major rows: that copy and Y = D
// itself.  It moves r*n*8 bytes, against r*n*n candidates.
//
// Short row lists.  The engine sends r from 1 to n/2.  A 64-row tile would
// leave most of each tile idle at r <= 16, and a grid of one row of tiles
// (n / BN CTAs) would fill only part of the card's SMs.  So the row tile
// is the short list's size (BM = 16, 32 or 64, 128 threads a CTA; the column
// tile widens as BM narrows: the product lattice of minplus_tile.cuh), and
// k is split into chunks over blockIdx.z until the grid fills whole waves
// of the card (kernels/row_close.py launch_plan picks the tile and the
// chunks by that fill rule, or takes them as the tuner's knobs;
// row_close_launch refuses a plan outside the lattice).  With one chunk the
// fold kernel finishes each output itself.  With more, each CTA folds its
// chunk from the semiring zero and stores a partial (value, global k) in an
// (chunks, r, n) scratch, and row_close_merge folds the chunks in ascending order with the strict
// better and finishes.  Either way the finish takes the start value
// D[R[i], j] through the row list last: v wins where better(v, D[R[i], j]).
// That gives the unsplit fold's bits wherever the zero is the ⊕-worst value
// (every value in the semiring's domain, as the ring's zero-padded k already
// assumes): ⊕ is selective in all four semirings (semiring.cuh), a chunk's
// smallest winning k is the global one whenever the chunk wins, a later
// chunk that only ties does not replace it, and a NaN is never a partial
// (it never improves on the zero) but stays a kept start value.
//
// What bounds it on this card.  r*n*n candidates at two FP32 instructions
// each on the CUDA cores, with a witness two where fold_ring defers it and
// 4.55 where a warp folds a slice eagerly (minplus.cu); every fold here
// starts from the zero, so its first slice is eager.  The bytes (D read
// once, the panel written once) bound it only below r = 10 with a witness
// and r = 20 without.  The tiles are minplus's (8 x 8 a thread for values,
// 8 x 4 with a witness, three CTAs an SM) at BM = 64.
//
// The wrapper (kernels/row_close.py) checks shapes and the row ids (each in
// [0, n)), so the gather needs no bounds check, allocates the outputs and
// the scratches, and copies D into rows of a 16-byte pitch where n is not a
// multiple of 4 (y below); every grid launches on the caller's stream and
// its error is returned.
#include <cuda_runtime.h>

#include <cstdint>

#include "minplus_tile.cuh"
#include "semiring.cuh"

namespace repro_torch {

enum : int { kValue = 0, kArgmin = 1, kPred = 2 };

constexpr int kThreads = 128, kMinBlocks = 3, kMergeThreads = 256;

// The tile of one mode and row height BM (64, 32 or 16): the product tile
// lattice of minplus_tile.cuh, which minplus.cu compiles too.
template <int MODE, int BM>
using Tile = ProductTile<MODE != kValue, BM>;
static_assert(Tile<kValue, 64>::kThreads == kThreads &&
                  Tile<kValue, 64>::kMinBlocks == kMinBlocks,
              "row_close launches the lattice's CTAs");

struct Args {
  const float* d;       // D (n, n), pitch n: the gather and the start values
  const float* y;       // D as the ring reads it: 16-byte rows of pitch ldy, read to column ny
  long long ldy, ny;
  const int* rows;      // r ids in [0, n)
  float* xt;            // D[R, :]^T, (n, rp)
  int rp;
  const int* pred;      // (n, n) int32, kPred
  float* z;             // (r, n)
  int* out;             // K* (kArgmin) or preds (kPred), (r, n)
  float* pz;            // partial values (chunks, r, n) when chunks > 1
  int* pk;              // partial k (chunks, r, n), witness modes, chunks > 1
  int r, n, chunk, chunks;
};

// Output (i, j) from the fold's value v over all k and its winner k (-1
// where no candidate improved on the zero): the start value D[R[i], j]
// folded in last, then the mode's outputs.
template <int SR, int MODE>
__device__ __forceinline__ void finish(const Args& A, int i, int j, float v, int k) {
  using S = Semiring<SR>;
  const long long src = (long long)A.rows[i] * A.n;
  const float a = A.d[src + j];
  const long long e = (long long)i * A.n + j;
  if constexpr (MODE == kValue) {
    A.z[e] = S::add(a, v);
  } else {
    const bool won = S::better(v, a);
    A.z[e] = won ? v : a;
    if constexpr (MODE == kArgmin) {
      A.out[e] = won ? k : -1;
    } else {
      // pred[R[i], k*] when k* == j is pred[R[i], j], the kept entry.
      A.out[e] = won && k != j ? A.pred[(long long)k * A.n + j] : A.pred[src + j];
    }
  }
}

template <int SR, int MODE, int BM>
__device__ __forceinline__ void fold_rows(const Args& A) {
  using T = Tile<MODE, BM>;
  using R = typename T::Ring;
  constexpr int TN = T::TN;
  extern __shared__ float4 smem4[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * T::BN, c = blockIdx.z;
  const int k0 = c * A.chunk, kn = min(A.chunk, A.n - k0);
  const int t = threadIdx.x;
  float acc[8][TN];
  int idx[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = Semiring<SR>::zero();
      idx[i][j] = -1;
    }
  fold_ring<SR, BM, T::BN, T::BK, T::STAGES, TN, MODE != kValue>(
      acc, idx, A.xt + (long long)k0 * A.rp, A.rp, A.rp, A.y + k0 * A.ldy, A.ldy, A.ny, m0,
      n0, kn, reinterpret_cast<float*>(smem4));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + R::row(t, i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + R::col(t, j);
      if (r < A.r && col < A.n) {
        const int k = idx[i][j] < 0 ? -1 : idx[i][j] + k0;
        if (A.chunks == 1)
          finish<SR, MODE>(A, r, col, acc[i][j], k);
        else
          store_partial<MODE != kValue>(A.pz, A.pk, (long long)A.r * A.n, c,
                                        (long long)r * A.n + col, acc[i][j], k);
      }
    }
  }
}

template <int SR, int BM>
__global__ void __launch_bounds__(kThreads, kMinBlocks) row_close(const Args A) {
  fold_rows<SR, kValue, BM>(A);
}

template <int SR, int BM>
__global__ void __launch_bounds__(kThreads, kMinBlocks) row_close_argmin(const Args A) {
  fold_rows<SR, kArgmin, BM>(A);
}

template <int SR, int BM>
__global__ void __launch_bounds__(kThreads, kMinBlocks) row_close_pred(const Args A) {
  fold_rows<SR, kPred, BM>(A);
}

// The chunks' partials of each output (i, j), folded in ascending chunk
// order from the zero as the unsplit fold would meet them, then finished.
template <int SR, int MODE>
__global__ void __launch_bounds__(kMergeThreads) row_close_merge(const Args A) {
  const int j = blockIdx.x * kMergeThreads + threadIdx.x;
  if (j >= A.n) return;
  for (int i = blockIdx.y; i < A.r; i += gridDim.y) {
    float v = Semiring<SR>::zero();
    int k = -1;
    fold_partials<SR, MODE != kValue>(A.pz, A.pk, (long long)A.r * A.n,
                                      (long long)i * A.n + j, A.chunks, v, k);
    finish<SR, MODE>(A, i, j, v, k);
  }
}

// D[R, :]^T, 32 x 32 at a time: xt[k][i] = D[R[i], k], columns r..rp filled
// with 0 (rows of the output that are never stored).
__global__ void __launch_bounds__(256) rows_kmajor(const float* __restrict__ d,
                                                   const int* __restrict__ rows,
                                                   float* __restrict__ xt, int r, int n, int rp) {
  __shared__ float tile[32][33];
  const int m0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int row = m0 + i, col = k0 + threadIdx.x;
    tile[i][threadIdx.x] = (row < r && col < n) ? d[(long long)rows[row] * n + col] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int kk = k0 + i;
    if (kk < n) xt[(long long)kk * rp + m0 + threadIdx.x] = tile[threadIdx.x][i];
  }
}

// The dynamic shared bytes are opted into on every launch that asks for
// any: a witness kernel's static slots (fold_ring) count against the 48 KB
// a kernel gets without it.
template <class Kernel>
cudaError_t run(Kernel kernel, int threads, int smem, dim3 grid, cudaStream_t s,
                const Args& A) {
  if (smem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(A);
  return cudaGetLastError();
}

template <int SR, int MODE, int BM>
cudaError_t launch(const Args& A, cudaStream_t s) {
  using T = Tile<MODE, BM>;
  const dim3 grid((A.n + T::BN - 1) / T::BN, (A.r + BM - 1) / BM, A.chunks);
  constexpr int smem = T::Ring::kSmemBytes;
  cudaError_t err;
  if constexpr (MODE == kValue)
    err = run(row_close<SR, BM>, kThreads, smem, grid, s, A);
  else if constexpr (MODE == kArgmin)
    err = run(row_close_argmin<SR, BM>, kThreads, smem, grid, s, A);
  else
    err = run(row_close_pred<SR, BM>, kThreads, smem, grid, s, A);
  if (err != cudaSuccess || A.chunks == 1) return err;
  return run(row_close_merge<SR, MODE>, kMergeThreads, 0,
             dim3((A.n + kMergeThreads - 1) / kMergeThreads, A.r < 65535 ? A.r : 65535), s, A);
}

template <int SR, int MODE>
cudaError_t by_rows(int bm, const Args& A, cudaStream_t s) {
  switch (bm) {
    case 16: return launch<SR, MODE, 16>(A, s);
    case 32: return launch<SR, MODE, 32>(A, s);
    default: return launch<SR, MODE, 64>(A, s);
  }
}

template <int SR>
cudaError_t by_mode(int mode, int bm, const Args& A, cudaStream_t s) {
  switch (mode) {
    case kValue: return by_rows<SR, kValue>(bm, A, s);
    case kArgmin: return by_rows<SR, kArgmin>(bm, A, s);
    default: return by_rows<SR, kPred>(bm, A, s);
  }
}

template <int MODE>
bool tile_is(int bm, int bn, int bk) {
  switch (bm) {
    case 16: return bn == Tile<MODE, 16>::BN && bk == Tile<MODE, 16>::BK;
    case 32: return bn == Tile<MODE, 32>::BN && bk == Tile<MODE, 32>::BK;
    case 64: return bn == Tile<MODE, 64>::BN && bk == Tile<MODE, 64>::BK;
    default: return false;
  }
}

// The plan the kernels can run, the lattice's members: a compiled tile
// (rows bm, columns bn, slice bk) of the mode, k = 0..n in chunks of
// ceil(n / chunks) rounded up to whole slices with none empty (the split
// of minplus.split_k), at most 65535 chunks and row tiles (grid z and y),
// the partial scratches when there is more than one chunk.
bool plan_ok(int mode, int r, int n, int bm, int bn, int bk, int chunk, int chunks,
             const Args& A) {
  const bool tile = mode == kValue ? tile_is<kValue>(bm, bn, bk) : tile_is<kArgmin>(bm, bn, bk);
  return tile && chunk >= 1 && chunk % bk == 0 && chunks >= 1 && chunks <= 65535 &&
         chunk == ((n + chunks - 1) / chunks + bk - 1) / bk * bk &&
         (long long)(chunks - 1) * chunk < n && (long long)chunks * chunk >= n &&
         (r + bm - 1) / bm <= 65535 && (chunks == 1 || (A.pz && (mode == kValue || A.pk)));
}

}  // namespace repro_torch

// C interface for ctypes.  mode 0 (value), 1 (K*) or 2 (preds).  d (n, n)
// contiguous float32; y the same values in 16-byte aligned rows of pitch ldy
// (a multiple of 4), read up to column ny (n <= ny <= ldy, a multiple of 4;
// y may be d itself); rows (r,) int32, each in [0, n); xt float32 scratch of
// n * rp floats, rp = r rounded up to 32, 16-byte aligned; pred (n, n) int32
// contiguous for mode 2; z and out (K* or preds) (r, n) contiguous; pz
// (float32) and pk (int32, modes 1 and 2) scratches of chunks * r * n when
// chunks > 1.  The plan (bm, bn, bk, chunk, chunks) is
// kernels/row_close.py's launch_plan.  Launches rows_kmajor, the fold and,
// with more than one chunk, the merge.  Returns a cudaError_t.
extern "C" int row_close_launch(int semiring, int mode, const void* d, const void* y,
                                long long ldy, long long ny, const void* rows, void* xt, int rp,
                                const void* pred, void* z, void* out, void* pz, void* pk, int r,
                                int n, int bm, int bn, int bk, int chunk, int chunks,
                                void* stream) {
  using namespace repro_torch;
  Args A{};
  A.d = static_cast<const float*>(d);
  A.y = static_cast<const float*>(y);
  A.ldy = ldy;
  A.ny = ny;
  A.rows = static_cast<const int*>(rows);
  A.xt = static_cast<float*>(xt);
  A.rp = rp;
  A.pred = static_cast<const int*>(pred);
  A.z = static_cast<float*>(z);
  A.out = static_cast<int*>(out);
  A.pz = static_cast<float*>(pz);
  A.pk = static_cast<int*>(pk);
  A.r = r;
  A.n = n;
  A.chunk = chunk;
  A.chunks = chunks;
  if (r < 1 || n < 1 || mode < 0 || mode > 2 || !d || !y || !rows || !xt || !z ||
      (mode != kValue && !out) || (mode == kPred && !pred) || rp != (r + 31) / 32 * 32 ||
      (n + 31) / 32 > 65535 || ny < n || ny % 4 != 0 || ldy % 4 != 0 || (n > 1 && ny > ldy) ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(xt) % 16 != 0 ||
      !plan_ok(mode, r, n, bm, bn, bk, chunk, chunks, A))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rows_kmajor<<<dim3(rp / 32, (n + 31) / 32), dim3(32, 8), 0, s>>>(A.d, A.rows, A.xt, r, n, rp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (semiring) {
    case 0: return by_mode<0>(mode, bm, A, s);
    case 1: return by_mode<1>(mode, bm, A, s);
    case 2: return by_mode<2>(mode, bm, A, s);
    case 3: return by_mode<3>(mode, bm, A, s);
    default: return cudaErrorInvalidValue;
  }
}
