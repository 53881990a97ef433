// The tiled ⊕⊗ product on Hopper (sm_90a): values, witnesses, and
// predecessors derived from the witnesses in the epilogue.
//
// Replaces the TPU kernels minplus_pallas (src/repro/kernels/minplus.py:235)
// and minplus_argmin_pallas (:284), one Pallas body (_minplus_body, :75)
// with two flags, and the predecessor rule that the JAX package applies to
// the witnesses afterwards (ops.pred_from_kstar).  Here it is one template,
// <SR, MODE, ACC>, behind three kernel names so that a profile tells them
// apart:
//   minplus<SR, ACC>         Z = [A ⊕] X ⊗ Y
//   minplus_argmin<SR, ACC>  (Z, K*): K* the k of the strict winner, -1
//                            where nothing improved on the start value
//   minplus_pred<SR, ACC>    (Z, P): P from the winner k* as pred_from_kstar
//                            derives it; K* is never stored
// on (G, M, K) x (G, K, N) float32 operands, over (N/BN, M/BM, G) CTAs.
// ACC starts each output element from A, otherwise from the semiring zero;
// either way k* starts at -1.  A strict improvement from the zero leaves -1
// exactly where the reference's is_zero mask puts it, and a strict
// improvement over A leaves -1 where A was kept.
//
// Witness rule.  The witnesses are those of a fold of each output element
// over k in ascending order with the strict Semiring::better (fold_ring's
// TRACK mode, which defers the search for them, bit for bit), so ties keep
// the smallest k, as jnp.argmin does.  A NaN candidate never improves
// and a NaN accumulator is never replaced (a comparison with NaN is false):
// the port's NaN rule, which the plain version in kernels/minplus.py
// follows too.  bf16 operands are upcast by the caller (kernels/ops.py), so
// the witness is decided in f32 before the value is rounded, as in the JAX
// package.
//
// Predecessor rule (minplus_pred), for output (i, j) with winner k*: px[i,
// k*] when k* + k_offset == j + j_offset (the y-path is empty), else py[k*,
// j]; where nothing improved, pa[i, j], or -1 without pa.  The epilogue
// reads px, py and pa through their row pitches (a pred panel is a strided
// view of the state's preds), once for each output element, from L2.  It
// replaces the plain-torch gathers, wheres and casts over N^2 int64
// temporaries that followed every witness launch, and the N^2 int32 K* that
// this kernel wrote only for them to read back.
//
// The fold.  Both operands reach the cp.async ring (fold_ring,
// minplus_tile.cuh) as k-major rows.  Y (K x N) already is; X (M x K) is
// made k-major by a small grid, kmajor, which writes X^T into an f32
// (G, K, Mp) scratch (Mp: M rounded up to 32 floats) through a 32 x 33
// shared tile.  The copy costs G*M*K*8 bytes (16 MiB at 8192 x 256, about
// 5 us at HBM rate) against a product of M*N*K candidates; the other way, a
// transposing shared-memory staging inside the ring, would put a transpose
// on every CTA's every slice, where each X slice is read by N/BN CTAs.
// X may be a strided view: kmajor reads it through its row pitch, so the
// caller makes no contiguous copy first.
//
// What bounds it on this card.  FP32 instructions on the CUDA cores: no
// tensor-core MMA computes a (min, +) product, and at the blocked-FW shapes
// (K = B = 256) the operations bound is far above the bytes bound.  The
// value fold (minplus) costs one ⊗ and one ⊕ a candidate.  The witness
// modes defer the witness (fold_ring, minplus_tile.cuh): each ring slice is
// folded as values are, one ⊗ and one NaN-ignoring ⊕ a candidate into a
// copy of the accumulator, and only the outputs whose slice value strictly
// improves are resolved, each by its own lane's rescan of the slice still
// in its ring slot (the lanes of a warp rescan side by side).  A warp keeps
// the eager fold (one ⊗, one compare and two selects a candidate, 4.55
// instructions) for a slice where one of its lanes had more than 16 outputs
// move in the slice before, for a first slice whose outputs mostly start at
// the semiring zero (every fold from the zero: the chunks of a split
// product, row_close) and for a partial last slice.  The default value tile
// is fw_update's: 64 x 128 outputs, 8 x 8 a thread, three CTAs of 128
// threads an SM.  The witness tile is 8 x 4 (64 x 64 outputs, three CTAs an
// SM): the deferred fold holds the slice value beside the accumulator, and
// the witnesses lie in 16 KB of shared slots, touched only after a slice.
// The deferred loop is 2.12 SASS instructions a candidate; a rescan pass
// costs a warp about 200 scheduler cycles (PERF.md).
//
// A launch given a stats buffer (the wrapper passes one while a profiler
// runs; null otherwise) adds the witness fold's counts to it (kFoldCounts,
// minplus_tile.cuh): one atomic add a count a CTA.
//
// The tile lattice.  The product compiles every tile of ProductTile
// (minplus_tile.cuh), the lattice row_close.cu compiles too: 64, 32 or 16
// rows at 128 threads, the column tile widening as the rows narrow.  It
// replaces minplus_pallas's tile parameters (bm, bn, bk, kc), which the JAX
// package's autotuner measures per shape bucket; here the tuner
// (kernels/autotune.py) measures the tile rows and the k chunks.  A short
// operand (an spd_features hop's L landmark rows, an R-Kleene quadrant's
// panel) fills a 16-row tile where a 64-row one would fold mostly padding.
//
// Split k.  A product of few output tiles (L x N with L = 8 or 64: 64 CTAs
// at most on 132 SMs) leaves the card idle, as row_close's short lists do.
// With chunks > 1, minplus_chunk runs G x chunks CTAs a tile over grid z:
// each folds its k chunk (whole ring slices) from the semiring zero and
// stores a partial (value, global k) into a (chunks, G, M, N) scratch; it
// is a kernel of its own because the unsplit kernels, given its epilogue
// as a branch, spilled and ran 7% slower.  minplus_combine then
// folds each output's partials in ascending chunk order into its start
// value (A, or the zero) with ⊕, or with the strict better for a witness,
// and stores the outputs as the unsplit epilogue does (the pred rule
// included).  That gives the unsplit fold's bits wherever the zero is the
// ⊕-worst value (every value in the semiring's domain): ⊕ is selective, a
// chunk's smallest winning k is the global one whenever the chunk wins, a
// later chunk that only ties does not replace it, a NaN is never a
// partial, and a NaN start value is kept.  The combine reads chunks x
// (4 or 8) bytes an output and writes the outputs once.
//
// The wrapper (kernels/minplus.py) checks shapes, strides and alignment,
// computes the launch plan (launch_plan: tile, chunks, the grids, X^T's
// pitch, the ring's column limit, shared bytes), which minplus_launch
// checks against the lattice (plan_is) and refuses if it is no member, and
// allocates the outputs, the k-major scratch and the partials; the kernels
// launch on the caller's stream and the error is returned.
#include <cuda_runtime.h>

#include <cstdint>

#include "minplus_tile.cuh"
#include "semiring.cuh"

namespace repro_torch {

// A (G, R, C) operand with unit column stride: element (g, r, c) at
// p[g * gs + r * rs + c].
struct View {
  const void* p;
  long long gs, rs;
};

template <class T>
__device__ __forceinline__ T at(const View& v, long long g, long long r, long long c) {
  return static_cast<const T*>(v.p)[g * v.gs + r * v.rs + c];
}

enum : int { kValue = 0, kArgmin = 1, kPred = 2 };

constexpr int kCombineThreads = 256;

struct Args {
  const float* xt;      // X^T, (G, K, mp) contiguous
  int mp;
  View y;               // f32 (G, K, N), read up to column ny
  long long ny;
  View a;               // f32 (G, M, N); p null without ACC
  float* z;             // (G, M, N) contiguous
  int* out;             // K* (kArgmin) or preds (kPred), (G, M, N) contiguous
  View px, py, pa;      // int32 (G, M, K), (G, K, N), (G, M, N); kPred; pa.p may be null
  float* pz;            // partial values (chunks, G, M, N) when chunks > 1
  int* pk;              // partial k (chunks, G, M, N), witness modes, chunks > 1
  int g, m, k, n, koff, joff, chunk, chunks;
  unsigned long long* stats;  // the witness fold's counts, or null
};

// Output (g, r, c) from its folded value v and winner ks (-1 where nothing
// improved on the start value): Z, and K* or the pred rule's predecessor.
template <int MODE>
__device__ __forceinline__ void store(const Args& A, long long g, int r, int c, float v,
                                      int ks) {
  const long long e = (g * A.m + r) * A.n + c;
  A.z[e] = v;
  if constexpr (MODE == kArgmin) A.out[e] = ks;
  if constexpr (MODE == kPred) {
    int p;
    if (ks < 0)
      p = A.pa.p ? at<int>(A.pa, g, r, c) : -1;
    else if (ks + A.koff == c + A.joff)
      p = at<int>(A.px, g, r, ks);
    else
      p = at<int>(A.py, g, ks, c);
    A.out[e] = p;
  }
}

// One output tile of the unsplit product: k whole, the fold started from A
// (or the zero), the outputs stored by the epilogue.
template <int SR, int MODE, bool ACC, int BM>
__device__ __forceinline__ void product_tile(const Args& A) {
  using T = ProductTile<MODE != kValue, BM>;
  using R = typename T::Ring;
  constexpr int TN = T::TN;
  extern __shared__ float4 smem4[];
  const long long g = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * T::BN;
  const int t = threadIdx.x;
  float acc[8][TN];
  int idx[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + R::row(t, i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + R::col(t, j);
      acc[i][j] = (ACC && r < A.m && c < A.n) ? at<float>(A.a, g, r, c) : Semiring<SR>::zero();
      idx[i][j] = -1;
    }
  }
  fold_ring<SR, BM, T::BN, T::BK, T::STAGES, TN, MODE != kValue>(
      acc, idx, A.xt + g * A.k * A.mp, A.mp, A.mp,
      static_cast<const float*>(A.y.p) + g * A.y.gs, A.y.rs, A.ny, m0, n0, A.k,
      reinterpret_cast<float*>(smem4), A.stats);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + R::row(t, i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + R::col(t, j);
      if (r < A.m && c < A.n) store<MODE>(A, g, r, c, acc[i][j], idx[i][j]);
    }
  }
}

// One output tile of one k chunk of a split product (grid z = chunk x G +
// graph): the chunk folded from the zero, the partial (value, and the
// global k with a witness) stored into the (chunks, G, M, N) scratch.  A
// kernel of its own, so that the unsplit kernels keep their registers.
template <int SR, bool TRACK, int BM>
__device__ __forceinline__ void chunk_tile(const Args& A) {
  using T = ProductTile<TRACK, BM>;
  using R = typename T::Ring;
  constexpr int TN = T::TN;
  extern __shared__ float4 smem4[];
  const long long g = blockIdx.z % A.g;
  const int q = blockIdx.z / A.g;
  const int k0 = q * A.chunk, kn = min(A.chunk, A.k - k0);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * T::BN;
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
  fold_ring<SR, BM, T::BN, T::BK, T::STAGES, TN, TRACK>(
      acc, idx, A.xt + (g * A.k + k0) * A.mp, A.mp, A.mp,
      static_cast<const float*>(A.y.p) + g * A.y.gs + k0 * A.y.rs, A.y.rs, A.ny, m0, n0, kn,
      reinterpret_cast<float*>(smem4), A.stats);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + R::row(t, i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + R::col(t, j);
      if (r < A.m && c < A.n)
        store_partial<TRACK>(A.pz, A.pk, (long long)A.g * A.m * A.n, q,
                             (g * A.m + r) * A.n + c, acc[i][j],
                             idx[i][j] < 0 ? -1 : idx[i][j] + k0);
    }
  }
}

template <int SR, bool ACC, int BM>
__global__ void __launch_bounds__(ProductTile<false, BM>::kThreads,
                                  ProductTile<false, BM>::kMinBlocks)
minplus(const Args A) {
  product_tile<SR, kValue, ACC, BM>(A);
}

template <int SR, bool ACC, int BM>
__global__ void __launch_bounds__(ProductTile<true, BM>::kThreads,
                                  ProductTile<true, BM>::kMinBlocks)
minplus_argmin(const Args A) {
  product_tile<SR, kArgmin, ACC, BM>(A);
}

template <int SR, bool ACC, int BM>
__global__ void __launch_bounds__(ProductTile<true, BM>::kThreads,
                                  ProductTile<true, BM>::kMinBlocks)
minplus_pred(const Args A) {
  product_tile<SR, kPred, ACC, BM>(A);
}

// The k chunks of a split product, in every mode: the witness modes store
// the same partials (the pred rule runs in minplus_combine), and A enters
// only there.
template <int SR, bool TRACK, int BM>
__global__ void __launch_bounds__(ProductTile<TRACK, BM>::kThreads,
                                  ProductTile<TRACK, BM>::kMinBlocks)
minplus_chunk(const Args A) {
  chunk_tile<SR, TRACK, BM>(A);
}

// The split-k combine: each output's chunk partials folded in ascending
// chunk order into its start value (A, or the zero), then stored.  One
// thread a column, grid y striding over the G x M rows.
template <int SR, int MODE, bool ACC>
__global__ void __launch_bounds__(kCombineThreads) minplus_combine(const Args A) {
  const int c = blockIdx.x * kCombineThreads + threadIdx.x;
  if (c >= A.n) return;
  const long long rows = (long long)A.g * A.m, plane = rows * A.n;
  for (long long gr = blockIdx.y; gr < rows; gr += gridDim.y) {
    const long long g = gr / A.m;
    const int r = static_cast<int>(gr - g * A.m);
    float v = ACC ? at<float>(A.a, g, r, c) : Semiring<SR>::zero();
    int ks = -1;
    fold_partials<SR, MODE != kValue>(A.pz, A.pk, plane, gr * A.n + c, A.chunks, v, ks);
    store<MODE>(A, g, r, c, v, ks);
  }
}

// X^T of one batch's (M, K) X, 32 x 32 at a time: xt[g][k][m], columns
// M..Mp filled with 0 (rows of the output that are never stored).
__global__ void __launch_bounds__(256) kmajor(const View x, float* __restrict__ xt, int m,
                                              int k, int mp) {
  __shared__ float tile[32][33];
  const long long g = blockIdx.z;
  const int m0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int row = m0 + r, col = k0 + threadIdx.x;
    tile[r][threadIdx.x] = (row < m && col < k) ? at<float>(x, g, row, col) : 0.0f;
  }
  __syncthreads();
  float* out = xt + g * k * mp;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int kk = k0 + r;
    if (kk < k) out[(long long)kk * mp + m0 + threadIdx.x] = tile[threadIdx.x][r];
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

// The launch plan that kernels/minplus.py (launch_plan) computes and passes
// in: the product's tile (bm x bn outputs, bk-deep slices) and grid
// (gx, gy, gz = G x chunks), kmajor's grid (kx, ky, kz; zero when k == 0),
// X^T's pitch mp, threads and dynamic shared bytes a CTA, the k chunk and
// the chunk count, and the ring's column limit ny of y.
struct ProductPlan {
  int bm, bn, bk, gx, gy, gz, kx, ky, kz, mp, threads, smem, chunk, chunks;
  long long ny;
};

template <bool TRACK, int BM>
bool tile_is(const ProductPlan& P) {
  using T = ProductTile<TRACK, BM>;
  return P.bm == BM && P.bn == T::BN && P.bk == T::BK && P.threads == T::kThreads &&
         P.smem == T::Ring::kSmemBytes;
}

// The plans this source launches for mode and (g, m, k, n): a tile of the
// lattice, k in chunks of whole slices (chunk = ceil(k / chunks) rounded up
// to the slice, none empty; one chunk of k rounded up, or 0 when k == 0),
// the grids covering the output and X^T.  Any other plan is refused.
template <int MODE>
bool plan_is(const ProductPlan& P, int g, int m, int k, int n) {
  constexpr bool W = MODE != kValue;
  if (!(tile_is<W, 64>(P) || tile_is<W, 32>(P) || tile_is<W, 16>(P))) return false;
  const int mp = (m + 31) / 32 * 32;
  const bool split = k == 0 ? P.chunks == 1 && P.chunk == 0
                            : P.chunks >= 1 && P.chunks <= k &&
                                  P.chunk == ((k + P.chunks - 1) / P.chunks + P.bk - 1) /
                                                 P.bk * P.bk &&
                                  P.chunks == (k + P.chunk - 1) / P.chunk;
  return split && P.gx == (n + P.bn - 1) / P.bn && P.gy == (m + P.bm - 1) / P.bm &&
         (long long)P.gz == (long long)g * P.chunks && P.mp == mp &&
         P.kx == (k > 0 ? mp / 32 : 0) && P.ky == (k + 31) / 32 && P.kz == (k > 0 ? g : 0) &&
         P.gy <= 65535 && P.gz <= 65535 && P.ky <= 65535 && P.kz <= 65535 && P.smem <= 232448;
}

template <int SR, int MODE, bool ACC, int BM>
cudaError_t launch(const Args& A, const ProductPlan& P, cudaStream_t s) {
  const dim3 grid(P.gx, P.gy, P.gz);
  if (P.chunks > 1)
    return run(minplus_chunk<SR, MODE != kValue, BM>, P.threads, P.smem, grid, s, A);
  if constexpr (MODE == kValue)
    return run(minplus<SR, ACC, BM>, P.threads, P.smem, grid, s, A);
  else if constexpr (MODE == kArgmin)
    return run(minplus_argmin<SR, ACC, BM>, P.threads, P.smem, grid, s, A);
  else
    return run(minplus_pred<SR, ACC, BM>, P.threads, P.smem, grid, s, A);
}

template <int SR, int MODE, bool ACC>
cudaError_t by_rows(const Args& A, const ProductPlan& P, cudaStream_t s) {
  switch (P.bm) {
    case 16: return launch<SR, MODE, ACC, 16>(A, P, s);
    case 32: return launch<SR, MODE, ACC, 32>(A, P, s);
    default: return launch<SR, MODE, ACC, 64>(A, P, s);
  }
}

template <int SR>
cudaError_t dispatch(int mode, bool acc, const Args& A, const ProductPlan& P, cudaStream_t s) {
  switch (mode * 2 + (acc ? 1 : 0)) {
    case 0: return by_rows<SR, kValue, false>(A, P, s);
    case 1: return by_rows<SR, kValue, true>(A, P, s);
    case 2: return by_rows<SR, kArgmin, false>(A, P, s);
    case 3: return by_rows<SR, kArgmin, true>(A, P, s);
    case 4: return by_rows<SR, kPred, false>(A, P, s);
    case 5: return by_rows<SR, kPred, true>(A, P, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int SR>
cudaError_t combine(int mode, bool acc, const Args& A, dim3 grid, cudaStream_t s) {
  switch (mode * 2 + (acc ? 1 : 0)) {
    case 0: return run(minplus_combine<SR, kValue, false>, kCombineThreads, 0, grid, s, A);
    case 1: return run(minplus_combine<SR, kValue, true>, kCombineThreads, 0, grid, s, A);
    case 2: return run(minplus_combine<SR, kArgmin, false>, kCombineThreads, 0, grid, s, A);
    case 3: return run(minplus_combine<SR, kArgmin, true>, kCombineThreads, 0, grid, s, A);
    case 4: return run(minplus_combine<SR, kPred, false>, kCombineThreads, 0, grid, s, A);
    case 5: return run(minplus_combine<SR, kPred, true>, kCombineThreads, 0, grid, s, A);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const View& v) {
  return reinterpret_cast<uintptr_t>(v.p) % 16 == 0 && v.gs % 4 == 0 && v.rs % 4 == 0;
}

}  // namespace repro_torch

// C interface for ctypes.  mode 0 (value), 1 (K*) or 2 (preds).  x (g, m,
// k), y (g, k, n) and a (g, m, n) float32, px (g, m, k), py (g, k, n) and
// pa (g, m, n) int32, each a View with unit column stride; a.p is null when
// acc == 0, pa.p may be null, and x, y, xt, px and py may be null when
// k == 0.  xt: float32 scratch of g * k * plan.mp floats.  y's rows are
// 16-byte aligned and read up to column plan.ny (n <= ny <= its row pitch,
// a multiple of 4).  z and out (K* or preds) (g, m, n) contiguous.  pz
// (float32) and pk (int32, modes 1 and 2): the partials, plan.chunks * g *
// m * n each, when plan.chunks > 1 (then the product writes them, not z
// and out, and minplus_combine_launch finishes).  The plan
// (kernels/minplus.py launch_plan, passed by address) must be one that
// plan_is accepts; any other is refused before anything launches.  stats:
// null, or kFoldCounts uint64 that a witness mode's product adds its
// counts to.  Launches kmajor (when k > 0), then the product.  Returns a
// cudaError_t.
extern "C" int minplus_launch(int semiring, int mode, int acc, repro_torch::View x,
                              void* xt, repro_torch::View y, repro_torch::View a, void* z,
                              void* out, repro_torch::View px, repro_torch::View py,
                              repro_torch::View pa, void* pz, void* pk, int g, int m, int k,
                              int n, int koff, int joff, const repro_torch::ProductPlan* planp,
                              void* stats, void* stream) {
  using namespace repro_torch;
  if (!planp) return cudaErrorInvalidValue;
  const ProductPlan& plan = *planp;
  const bool witness = mode == kArgmin || mode == kPred;
  const bool plan_ok = mode == kValue ? plan_is<kValue>(plan, g, m, k, n)
                                      : plan_is<kArgmin>(plan, g, m, k, n);
  const bool split = plan.chunks > 1;
  const long long ny = plan.ny;
  if (g < 1 || g > 65535 || m < 1 || n < 1 || k < 0 || mode < 0 || mode > 2 || (acc && !a.p) ||
      !z || (witness && !out) ||
      (k > 0 && (!x.p || !y.p || !xt || (mode == kPred && (!px.p || !py.p)))) || !plan_ok ||
      (split && (!pz || (witness && !pk))) || ny < n || ny % 4 != 0 || (k > 1 && ny > y.rs) ||
      !aligned16(y) || reinterpret_cast<uintptr_t>(xt) % 16 != 0)
    return cudaErrorInvalidValue;
  Args A{};
  A.xt = static_cast<const float*>(xt);
  A.mp = plan.mp;
  A.y = y;
  A.ny = ny;
  A.a = a;
  A.z = static_cast<float*>(z);
  A.out = static_cast<int*>(out);
  A.px = px;
  A.py = py;
  A.pa = pa;
  A.pz = static_cast<float*>(pz);
  A.pk = static_cast<int*>(pk);
  A.g = g;
  A.m = m;
  A.k = k;
  A.n = n;
  A.koff = koff;
  A.joff = joff;
  A.chunk = plan.chunk;
  A.chunks = plan.chunks;
  A.stats = static_cast<unsigned long long*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > 0) {
    kmajor<<<dim3(plan.kx, plan.ky, plan.kz), dim3(32, 8), 0, s>>>(
        x, static_cast<float*>(xt), m, k, plan.mp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  switch (semiring) {
    case 0: return dispatch<0>(mode, acc != 0, A, plan, s);
    case 1: return dispatch<1>(mode, acc != 0, A, plan, s);
    case 2: return dispatch<2>(mode, acc != 0, A, plan, s);
    case 3: return dispatch<3>(mode, acc != 0, A, plan, s);
    default: return cudaErrorInvalidValue;
  }
}

// The split-k combine of a product whose plan had chunks > 1: pz (float32)
// and pk (int32, modes 1 and 2) the (chunks, g, m, n) partials, a the start
// values (a.p null when acc == 0), z, out, px, py, pa, koff and joff as
// minplus_launch takes them.  The grid (cx, cy) must be (n / 256 rounded
// up, min(g * m, 65535)); any other is refused.  Returns a cudaError_t.
extern "C" int minplus_combine_launch(int semiring, int mode, int acc, repro_torch::View a,
                                      const void* pz, const void* pk, void* z, void* out,
                                      repro_torch::View px, repro_torch::View py,
                                      repro_torch::View pa, int g, int m, int n, int koff,
                                      int joff, int chunks, int cx, int cy, void* stream) {
  using namespace repro_torch;
  const bool witness = mode == kArgmin || mode == kPred;
  const long long rows = (long long)g * m;
  if (g < 1 || m < 1 || n < 1 || mode < 0 || mode > 2 || chunks < 1 || chunks > 65535 ||
      (acc && !a.p) || !pz || !z || (witness && (!pk || !out)) ||
      (mode == kPred && (!px.p || !py.p)) || cx != (n + kCombineThreads - 1) / kCombineThreads ||
      cy != (rows < 65535 ? rows : 65535))
    return cudaErrorInvalidValue;
  Args A{};
  A.a = a;
  A.pz = const_cast<float*>(static_cast<const float*>(pz));
  A.pk = const_cast<int*>(static_cast<const int*>(pk));
  A.z = static_cast<float*>(z);
  A.out = static_cast<int*>(out);
  A.px = px;
  A.py = py;
  A.pa = pa;
  A.g = g;
  A.m = m;
  A.n = n;
  A.koff = koff;
  A.joff = joff;
  A.chunks = chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(cx, cy);
  switch (semiring) {
    case 0: return combine<0>(mode, acc != 0, A, grid, s);
    case 1: return combine<1>(mode, acc != 0, A, grid, s);
    case 2: return combine<2>(mode, acc != 0, A, grid, s);
    case 3: return combine<3>(mode, acc != 0, A, grid, s);
    default: return cudaErrorInvalidValue;
  }
}
