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
// Witness rule.  One thread folds each output element over k in ascending
// order with the strict Semiring::better (fold_ring's TRACK mode), so ties
// keep the smallest k, as jnp.argmin does.  A NaN candidate never improves
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
// What bounds it on this card.  Each candidate costs one ⊗ and one ⊕
// (minplus) or one ⊗, one compare and two selects (the witness modes) FP32
// instructions on the CUDA cores: no tensor-core MMA computes a (min, +)
// product.  At the blocked-FW shapes (K = B = 256) the operations bound is
// far above the bytes bound.  The value tile is fw_update's: 64 x 128
// outputs, 8 x 8 a thread, three CTAs of 128 threads an SM.  The witness
// tile holds int32 indices beside the floats, so it is 8 x 4 (64 x 64
// outputs, 168 registers, three CTAs an SM): an 8 x 8 witness tile (128
// accumulator registers, 255 in all, two CTAs an SM) ran slower, most of
// all with the pred epilogue (PERF.md).
//
// The wrapper (kernels/minplus.py) checks shapes, strides and alignment,
// computes the launch plan (launch_plan: tile, both grids, X^T's pitch, the
// ring's column limit, shared bytes), which minplus_launch checks against
// its own (plan_is) and refuses if it differs, and allocates the outputs and
// the k-major scratch; the kernels launch on the caller's stream and the
// error is returned.
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

// The value tile (TN = 8) and the witness tile (TN = 4): 64 x 16*TN
// outputs, 32-deep k slices, three ring slots, three CTAs an SM.
template <bool TRACK>
struct Cfg {
  static constexpr int TN = TRACK ? 4 : 8;
  static constexpr int BM = 64, BN = 16 * TN, BK = 32, STAGES = 3, kMinBlocks = 3;
  using Ring = RingShape<BM, BN, BK, STAGES, TN>;
};

struct Args {
  const float* xt;      // X^T, (G, K, mp) contiguous
  int mp;
  View y;               // f32 (G, K, N), read up to column ny
  long long ny;
  View a;               // f32 (G, M, N); p null without ACC
  float* z;             // (G, M, N) contiguous
  int* out;             // K* (kArgmin) or preds (kPred), (G, M, N) contiguous
  View px, py, pa;      // int32 (G, M, K), (G, K, N), (G, M, N); kPred; pa.p may be null
  int m, k, n, koff, joff;
};

template <int SR, int MODE, bool ACC>
__device__ __forceinline__ void product_tile(const Args& A) {
  using C = Cfg<MODE != kValue>;
  using R = typename C::Ring;
  constexpr int TN = C::TN;
  extern __shared__ float4 smem4[];
  const long long g = blockIdx.z;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
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
  fold_ring<SR, C::BM, C::BN, C::BK, C::STAGES, TN, MODE != kValue>(
      acc, idx, A.xt + g * A.k * A.mp, A.mp, A.mp,
      static_cast<const float*>(A.y.p) + g * A.y.gs, A.y.rs, A.ny, m0, n0, A.k,
      reinterpret_cast<float*>(smem4));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + R::row(t, i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + R::col(t, j);
      if (r < A.m && c < A.n) {
        const long long e = (g * A.m + r) * A.n + c;
        A.z[e] = acc[i][j];
        if constexpr (MODE == kArgmin) A.out[e] = idx[i][j];
        if constexpr (MODE == kPred) {
          const int ks = idx[i][j];
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
    }
  }
}

template <int SR, bool ACC>
__global__ void __launch_bounds__(Cfg<false>::Ring::kThreads, Cfg<false>::kMinBlocks)
minplus(const Args A) {
  product_tile<SR, kValue, ACC>(A);
}

template <int SR, bool ACC>
__global__ void __launch_bounds__(Cfg<true>::Ring::kThreads, Cfg<true>::kMinBlocks)
minplus_argmin(const Args A) {
  product_tile<SR, kArgmin, ACC>(A);
}

template <int SR, bool ACC>
__global__ void __launch_bounds__(Cfg<true>::Ring::kThreads, Cfg<true>::kMinBlocks)
minplus_pred(const Args A) {
  product_tile<SR, kPred, ACC>(A);
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

template <class Kernel>
cudaError_t run(Kernel kernel, int threads, int smem, dim3 grid, cudaStream_t s,
                const Args& A) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(A);
  return cudaGetLastError();
}

// The launch plan that kernels/minplus.py (launch_plan) computes and passes
// in: the product's tile (bm x bn outputs, bk-deep slices) and grid
// (gx, gy, gz), kmajor's grid (kx, ky, kz; zero when k == 0), X^T's pitch mp,
// the ring's column limit ny of y, threads and dynamic shared bytes a CTA.
struct ProductPlan {
  int bm, bn, bk, gx, gy, gz, kx, ky, kz, mp, threads, smem;
  long long ny;
};

// The plan this source launches for mode and (g, m, k, n): what launch()
// and minplus_launch() below run.  Any other plan is refused.
template <int MODE>
bool plan_is(const ProductPlan& P, int g, int m, int k, int n) {
  using C = Cfg<MODE != kValue>;
  using R = typename C::Ring;
  const int mp = (m + 31) / 32 * 32;
  return P.bm == C::BM && P.bn == C::BN && P.bk == C::BK && P.gx == (n + C::BN - 1) / C::BN &&
         P.gy == (m + C::BM - 1) / C::BM && P.gz == g && P.mp == mp &&
         P.kx == (k > 0 ? mp / 32 : 0) && P.ky == (k + 31) / 32 && P.kz == (k > 0 ? g : 0) &&
         P.threads == R::kThreads && P.smem == R::kSmemBytes && P.gy <= 65535 && P.gz <= 65535 &&
         P.ky <= 65535 && P.kz <= 65535 && P.smem <= 232448;
}

template <int SR, int MODE, bool ACC>
cudaError_t launch(const Args& A, const ProductPlan& P, cudaStream_t s) {
  const dim3 grid(P.gx, P.gy, P.gz);
  if constexpr (MODE == kValue)
    return run(minplus<SR, ACC>, P.threads, P.smem, grid, s, A);
  else if constexpr (MODE == kArgmin)
    return run(minplus_argmin<SR, ACC>, P.threads, P.smem, grid, s, A);
  else
    return run(minplus_pred<SR, ACC>, P.threads, P.smem, grid, s, A);
}

template <int SR>
cudaError_t dispatch(int mode, bool acc, const Args& A, const ProductPlan& P, cudaStream_t s) {
  switch (mode * 2 + (acc ? 1 : 0)) {
    case 0: return launch<SR, kValue, false>(A, P, s);
    case 1: return launch<SR, kValue, true>(A, P, s);
    case 2: return launch<SR, kArgmin, false>(A, P, s);
    case 3: return launch<SR, kArgmin, true>(A, P, s);
    case 4: return launch<SR, kPred, false>(A, P, s);
    case 5: return launch<SR, kPred, true>(A, P, s);
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
// a multiple of 4).  z and out (K* or preds) (g, m, n) contiguous.  The
// plan (kernels/minplus.py launch_plan, passed by address) must be the one
// plan_is describes;
// any other is refused before anything launches.  Launches kmajor (when
// k > 0), then the product.  Returns a cudaError_t.
extern "C" int minplus_launch(int semiring, int mode, int acc, repro_torch::View x,
                              void* xt, repro_torch::View y, repro_torch::View a, void* z,
                              void* out, repro_torch::View px, repro_torch::View py,
                              repro_torch::View pa, int g, int m, int k, int n, int koff,
                              int joff, const repro_torch::ProductPlan* planp, void* stream) {
  using namespace repro_torch;
  if (!planp) return cudaErrorInvalidValue;
  const ProductPlan& plan = *planp;
  const bool witness = mode == kArgmin || mode == kPred;
  const bool plan_ok = mode == kValue ? plan_is<kValue>(plan, g, m, k, n)
                                      : plan_is<kArgmin>(plan, g, m, k, n);
  const long long ny = plan.ny;
  if (g < 1 || g > 65535 || m < 1 || n < 1 || k < 0 || mode < 0 || mode > 2 || (acc && !a.p) ||
      !z || (witness && !out) ||
      (k > 0 && (!x.p || !y.p || !xt || (mode == kPred && (!px.p || !py.p)))) || !plan_ok ||
      ny < n || ny % 4 != 0 || (k > 1 && ny > y.rs) || !aligned16(y) ||
      reinterpret_cast<uintptr_t>(xt) % 16 != 0)
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
  A.m = m;
  A.k = k;
  A.n = n;
  A.koff = koff;
  A.joff = joff;
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
