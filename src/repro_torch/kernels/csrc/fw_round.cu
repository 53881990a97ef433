// One fused blocked Floyd-Warshall round on Hopper (sm_90a).
//
// Replaces the TPU kernel fw_round_pallas (src/repro/kernels/fw_round.py:65).
// On (G, N, N) storage, f32 or bf16 with f32 arithmetic, with the pivot
// block at element offset o:
//   A*   = FW(D[o:o+B, o:o+B])         B sequential rank-1 ⊕⊗ steps
//   col' = D[:, o:o+B] ⊗ A*
//   D    = D ⊕ col' ⊗ D[o:o+B, :]
// bf16 storage rounds at the closed pivot, at col' and at the output, as the
// TPU kernel does (fw_round.py:102,107,112).
//
// What bounds it on this card.  The update does G*N*N*B candidates, each one
// ⊗ and one ⊕ FP32 instruction (min.NaN is one FMNMX.NAN in the SASS) with
// no tensor-core MMA, so it is bound by CUDA-core issue: 2*G*N^3 / (132 SMs
// * 128 lanes * SM clock) a solve, about 34 ms at N = 8192 and 1.98 GHz.
// Its memory traffic, 2*N*N*4 bytes a round, is far below that.  The
// closure is a chain of B dependent steps and has no card-wide bound.
//
// The round is four grids on one stream (an f32 pivot at B = 256 is 256 KiB,
// more than one CTA's 227 KB of shared memory):
//   1. fw_closure:  one thread-block cluster of 8 CTAs a graph closes its
//      pivot (cluster_close, fw_closure.cuh, shared with fw_block.cu): the
//      tile in the cluster's registers, one cluster barrier for each 8
//      pivots.  It replaces a one-CTA closure (0.74 ms a round at B = 256 on an H100,
//      a quarter of the solve) that ran while 131 SMs waited.
//      Above 256 nodes, fw_closure_grid closes the pivots instead: one
//      cooperative launch of the grid closure (grid_close, fw_closure.cuh),
//      the tile in global memory in L2, one grid barrier a pivot step.
//   2. fw_panels:   32 x 32 tiles copy the column panel transposed and the
//      pivot row panel into (G, B, Np) f32 scratches, and A* into rows of a
//      16-byte pitch: every operand of grids 3 and 4 as k-major rows.
//   3. fw_colpanel: col'^T = A*^T ⊗ colpanel^T on the ring (fold_ring, as
//      grid 4), (G, B/64, N/128) CTAs, written as the rows of a (G, B, Np)
//      f32 scratch.  It replaces col' on the staged fold (scalar loads and
//      a transposing store for each 16-step slice, 64 x 64 tiles, written
//      transposed through shared memory); PERF.md has both times.
//   4. fw_update:   CTAs over (G, N/64, N/128) output tiles fold
//      col'^T ⊗ rowpanel over k = 0..B on top of D and write D in place.
//      Both operands are k-major rows of the scratches, so the fold
//      (fold_ring, minplus_tile.cuh) fills a ring of three shared-memory
//      slices of 32 k steps with 16-byte cp.async copies two slices ahead,
//      with one CTA barrier a slice.  It replaces a fold that staged each
//      16-step slice with scalar loads and a transposing store and then
//      waited (2.06 ms a round on an H100, half its operations bound; 2.43 SASS
//      instructions a candidate, 0.37 of them staging).
// Np and Bp are N and B rounded up to a multiple of 32 floats (computed by
// the wrapper), so every row of the scratches is 16-byte aligned for any N.
// In-place hazard: grid 4 reads the row panel while the CTAs that own those
// rows overwrite them, so it reads the copy grid 2 made.  Scratch is
// G*(B*B + B*Bp + 3*B*Np) floats (24.5 MiB at N = 8192, B = 256), against
// the second N x N buffer (256 MiB) that ping-pong would take.
//
// The wrapper (kernels/fw_round.py) checks shapes, computes the round's
// launch plan (launch_plan: the closure's plan, Np and Bp, the grids of
// stages 2-4, the ring's tile and shared bytes), which fw_round_launch
// checks against its own (round_plan_is, close_plan_ok, grid_plan_ok) and
// refuses if it differs, and allocates the scratch; everything launches on
// the caller's stream, and each launch's error is returned to it.
#include <cuda_runtime.h>

#include "fw_closure.cuh"
#include "minplus_tile.cuh"
#include "semiring.cuh"

namespace repro_torch {

// Update tiles (fold_ring): 64 x 128 outputs, 32-deep k slices, 3 slots.
constexpr int UM = 64, UN = 128, UK = 32, kStages = 3;
using Ring = RingShape<UM, UN, UK, kStages>;

template <int SR, class T>
__global__ void __launch_bounds__(kCloseMaxB)
fw_closure(const T* __restrict__ d, float* __restrict__ apiv, int n, int b, int o, int rows) {
  extern __shared__ float4 smem4[];
  const long long g = blockIdx.x / cluster_size();
  cluster_close<SR, false, T>(d + g * n * n + (long long)o * n + o, n, nullptr,
                              apiv + g * b * b, nullptr, b, rows,
                              reinterpret_cast<float*>(smem4));
}

template <int SR, class T>
__global__ void __launch_bounds__(kGridThreads)
fw_closure_grid(const T* __restrict__ d, float* __restrict__ apiv, int n, int b, int o, int g,
                int* lines) {
  grid_close<SR, false, T>(d + (long long)o * n + o, n, (long long)n * n, nullptr, apiv,
                           nullptr, b, g, lines);
}

// The k-major operands of col'^T, and the row panel, 32 x 32 at a time:
// coln[k][i] = D[i][o + k] (the column panel transposed) and rowp[k][i] =
// D[o + k][i] for i < n, k < b; apv[k][j] = A*[k][j] for j < b, in rows of
// pitch bp (apiv's rows, of pitch b, are 16-byte aligned only when 4
// divides b).
template <class T>
__global__ void __launch_bounds__(256)
fw_panels(const T* __restrict__ d, const float* __restrict__ apiv, float* __restrict__ coln,
          float* __restrict__ rowp, float* __restrict__ apv, int n, int b, int o, int np,
          int bp) {
  __shared__ float tile[32][33];
  const int g = blockIdx.z;
  const int i0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  const T* dg = d + (long long)g * n * n;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int i = i0 + r, k = k0 + tx;
    tile[r][tx] = (i < n && k < b) ? Storage<T>::load(dg[(long long)i * n + o + k]) : 0.0f;
  }
  __syncthreads();
  const long long off = (long long)g * b * np;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int k = k0 + r, i = i0 + tx;
    if (k < b && i < n) {
      coln[off + (long long)k * np + i] = tile[tx][r];
      rowp[off + (long long)k * np + i] = Storage<T>::load(dg[(long long)(o + k) * n + i]);
      if (i < b) apv[((long long)g * b + k) * bp + i] = apiv[((long long)g * b + k) * b + i];
    }
  }
}

// col'^T = A*^T ⊗ colpanel^T (⊗ commutes in every built-in semiring, so
// each candidate has col''s bits), written as rows of colt: CTAs over
// (G, B/64, N/128) output tiles fold apv against coln over k = 0..B on the
// ring, as fw_update does, and round to the storage type as the TPU kernel
// rounds col'.
template <int SR, class T>
__global__ void __launch_bounds__(Ring::kThreads, 3)
fw_colpanel(const float* __restrict__ apv, const float* __restrict__ coln,
            float* __restrict__ colt, int n, int b, int np, int bp) {
  extern __shared__ float4 smem4[];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * UM, n0 = blockIdx.x * UN;
  const int t = threadIdx.x;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = Semiring<SR>::zero();
  const long long off = (long long)g * b * np;
  fold_ring<SR, UM, UN, UK, kStages>(acc, apv + (long long)g * b * bp, bp, coln + off, np, m0,
                                     n0, b, reinterpret_cast<float*>(smem4));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + Ring::row(t, i);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = n0 + Ring::col(t, jj);
      if (r < b && c < n) colt[off + (long long)r * np + c] = Storage<T>::round(acc[i][jj]);
    }
  }
}

// Three CTAs of 128 threads an SM (at most 168 registers a thread, no
// spills; 3 x 72 KiB of ring).  At two CTAs of 256 threads (128 registers)
// the fold spilled and ran 1.3% slower on an H100 (PERF.md).
template <int SR, class T>
__global__ void __launch_bounds__(Ring::kThreads, 3)
fw_update(T* __restrict__ d, const float* __restrict__ colt, const float* __restrict__ rowp,
          int n, int b, int np) {
  extern __shared__ float4 smem4[];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * UM, n0 = blockIdx.x * UN;
  const int t = threadIdx.x;
  T* dg = d + (long long)g * n * n;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + Ring::row(t, i);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = n0 + Ring::col(t, jj);
      acc[i][jj] = (r < n && c < n) ? Storage<T>::load(dg[(long long)r * n + c])
                                    : Semiring<SR>::zero();
    }
  }
  const long long off = (long long)g * b * np;
  fold_ring<SR, UM, UN, UK, kStages>(acc, colt + off, np, rowp + off, np, m0, n0, b,
                                     reinterpret_cast<float*>(smem4));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + Ring::row(t, i);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = n0 + Ring::col(t, jj);
      if (r < n && c < n) dg[(long long)r * n + c] = Storage<T>::store(acc[i][jj]);
    }
  }
}

struct ClosePlan {
  int cluster, rows, threads, shared;
};

// The launch plan of grids 2-4 that kernels/fw_round.py (launch_plan)
// computes and passes in: the scratches' row pitches np and bp, fw_panels'
// grid (px, py), fw_colpanel's (cx, cy) and fw_update's (ux, uy) (grid z is
// G for all three), the ring's tile (um x un outputs, uk-deep slices),
// threads and dynamic shared bytes a ring CTA.
struct RoundPlan {
  int np, bp, px, py, cx, cy, ux, uy, um, un, uk, threads, smem;
};

// The plan this source launches for (g, n, b); any other is refused.
inline bool round_plan_is(const RoundPlan& P, int g, int n, int b) {
  return P.np == (n + 31) / 32 * 32 && P.bp == (b + 31) / 32 * 32 && P.px == (n + 31) / 32 &&
         P.py == (b + 31) / 32 && P.cx == (n + UN - 1) / UN && P.cy == (b + UM - 1) / UM &&
         P.ux == (n + UN - 1) / UN && P.uy == (n + UM - 1) / UM && P.um == UM && P.un == UN &&
         P.uk == UK && P.threads == Ring::kThreads && P.smem == Ring::kSmemBytes &&
         P.py <= 65535 && P.cy <= 65535 && P.uy <= 65535 && g <= 65535 && P.smem <= 232448;
}

struct Scratch {
  float *apiv, *colt, *rowp, *coln, *apv;
};

template <int SR, class T>
cudaError_t launch_round(T* d, const Scratch& w, int g, int n, int b, int o, const RoundPlan& P,
                         ClosePlan plan, int* lines, cudaStream_t s) {
  float* apiv = w.apiv;
  cudaError_t err =
      b > kCloseMaxB
          ? launch_grid_close(fw_closure_grid<SR, T>, (long long)g * b, lines, s,
                              static_cast<const T*>(d), apiv, n, b, o, g, lines)
          : launch_clusters(fw_closure<SR, T>, g, plan.cluster, plan.threads, plan.shared, s,
                            static_cast<const T*>(d), apiv, n, b, o, plan.rows);
  if (err != cudaSuccess) return err;
  fw_panels<T><<<dim3(P.px, P.py, g), dim3(32, 8), 0, s>>>(d, apiv, w.coln, w.rowp, w.apv, n,
                                                            b, o, P.np, P.bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fw_colpanel<SR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P.smem);
  if (err != cudaSuccess) return err;
  fw_colpanel<SR, T><<<dim3(P.cx, P.cy, g), P.threads, P.smem, s>>>(w.apv, w.coln, w.colt, n,
                                                                      b, P.np, P.bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fw_update<SR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P.smem);
  if (err != cudaSuccess) return err;
  fw_update<SR, T><<<dim3(P.ux, P.uy, g), P.threads, P.smem, s>>>(d, w.colt, w.rowp, n, b,
                                                                    P.np);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int semiring, void* d, const Scratch& w, int g, int n, int b, int o,
                     const RoundPlan& P, ClosePlan plan, int* li, cudaStream_t s) {
  T* dd = static_cast<T*>(d);
  switch (semiring) {
    case 0: return launch_round<0, T>(dd, w, g, n, b, o, P, plan, li, s);
    case 1: return launch_round<1, T>(dd, w, g, n, b, o, P, plan, li, s);
    case 2: return launch_round<2, T>(dd, w, g, n, b, o, P, plan, li, s);
    case 3: return launch_round<3, T>(dd, w, g, n, b, o, P, plan, li, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_torch

// C interface for ctypes.  d: (g, n, n) contiguous storage, float32
// (bf16 == 0) or bf16 (bf16 == 1); apiv (g, b, b), colt, rowp and coln
// (g, b, plan.np), and apv (g, b, plan.bp) are float32 scratch.  The round's
// plan (kernels/fw_round.py launch_plan, passed by address: the pitches, the grids of
// fw_panels, fw_colpanel and fw_update, the ring's tile, threads and shared
// bytes) must be the one round_plan_is describes.  The closure's launch
// plan (cluster, rows, threads, shared) is checked too: the cluster
// closure's (close_plan_ok) for b <= 256, the grid closure's
// (grid_plan_ok) above, which also takes `lines`, int32 scratch of
// grid_lines_words(b, g, false) words (null for b <= 256).  A plan that
// fails is refused before anything launches.  Returns a cudaError_t.
extern "C" int fw_round_launch(int semiring, int bf16, void* d, void* apiv, void* colt,
                               void* rowp, void* coln, void* apv, int g, int n, int b, int o,
                               const repro_torch::RoundPlan* roundp, int cluster, int rows,
                               int threads, int shared, void* lines, void* stream) {
  using namespace repro_torch;
  if (!roundp) return cudaErrorInvalidValue;
  const RoundPlan& round = *roundp;
  const bool plan_ok = b <= kCloseMaxB ? close_plan_ok(b, false, cluster, rows, threads, shared)
                                       : grid_plan_ok(b, cluster, rows, threads, shared) && lines;
  if (g < 1 || n < 1 || b < 1 || n % b != 0 || o < 0 || o % b != 0 || o >= n || !plan_ok ||
      !round_plan_is(round, g, n, b))
    return cudaErrorInvalidValue;
  const ClosePlan plan{cluster, rows, threads, shared};
  const Scratch w{static_cast<float*>(apiv), static_cast<float*>(colt), static_cast<float*>(rowp),
                  static_cast<float*>(coln), static_cast<float*>(apv)};
  int* li = static_cast<int*>(lines);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(semiring, d, w, g, n, b, o, round, plan, li, s)
              : dispatch<float>(semiring, d, w, g, n, b, o, round, plan, li, s);
}

// The cluster size the latest fw_closure launch ran on, read from the card
// and set back to 0 (cluster_ctas_seen).
extern "C" int fw_round_cluster_ctas() { return repro_torch::cluster_ctas_seen(false); }
