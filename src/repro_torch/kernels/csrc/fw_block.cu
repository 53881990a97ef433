// Closure of a stack of independent B x B tiles on Hopper (sm_90a), with
// and without predecessors.
//
// fw_block replaces the TPU kernel fw_block_pallas
// (src/repro/kernels/fw_block.py:34): the closure of each (B, B) tile of a
// (T, B, B) float32 stack, B sequential rank-1 ⊕⊗ steps.
//
// fw_block_pred replaces fw_block_pred_pallas (fw_block.py:67): the same
// closure plus int32 predecessors, pred[i, j] <- pred[k, j] on a strict
// improvement through pivot k.  A NaN candidate never improves and a NaN
// value is never replaced, as in the JAX oracle fw_block_pred_ref.
//
// Both run the port's cluster closure (cluster_close, fw_closure.cuh): one
// cluster of C = 8 CTAs a tile, T clusters a launch, the tile (and its
// preds) in the cluster's registers from the first load to the final
// store, and one cluster barrier for each 8 pivots, after which every CTA
// reads the 8 stepped pivot rows through distributed shared memory.  They
// replace a one-CTA closure (fw_block, 0.78 ms a tile at B = 256 on an H100) and a
// one-CTA pred closure that kept its tile in its global output and sent B^2
// loads and stores a step through one SM's share of L2 (fw_block_pred,
// 2.5 ms a tile on an H100 at 700 W; PERF.md).
//
// Tiles above 256 nodes close on the grid closure (grid_close,
// fw_closure.cuh) instead: fw_block_grid and fw_block_pred_grid, one
// cooperative launch for the whole stack, the tiles in their global
// outputs in L2, one grid barrier a pivot step.
//
// What bounds them now.  A closure is a chain of B dependent steps, so the
// card's operations bound (B^3 candidates at 2 or 4 instructions each over
// 132 SMs) is out of reach; each group of 8 pivots costs one cluster
// barrier, a few CTA barriers, 8 DSMEM reads a thread and 8 * R
// candidates a thread (R <= 32 rows).

// The wrapper (kernels/fw_block.py) checks shapes, computes the launch plan
// (cluster size, rows a CTA, threads, shared bytes) and allocates the
// outputs; the kernels launch on the caller's stream and their error is
// returned.
#include <cuda_runtime.h>

#include "fw_closure.cuh"
#include "semiring.cuh"

namespace repro_torch {

template <int SR>
__global__ void __launch_bounds__(kCloseMaxB)
fw_block(const float* __restrict__ d, float* __restrict__ out, int b, int rows) {
  extern __shared__ float4 smem4[];
  const long long tile = (long long)(blockIdx.x / cluster_size()) * b * b;
  cluster_close<SR, false, float>(d + tile, b, nullptr, out + tile, nullptr, b, rows,
                                  reinterpret_cast<float*>(smem4));
}

template <int SR>
__global__ void __launch_bounds__(kCloseMaxB)
fw_block_pred(const float* __restrict__ d, const int* __restrict__ p, float* __restrict__ dout,
              int* __restrict__ pout, int b, int rows) {
  extern __shared__ float4 smem4[];
  const long long tile = (long long)(blockIdx.x / cluster_size()) * b * b;
  cluster_close<SR, true, float>(d + tile, b, p + tile, dout + tile, pout + tile, b, rows,
                                 reinterpret_cast<float*>(smem4));
}

template <int SR>
__global__ void __launch_bounds__(kGridThreads)
fw_block_grid(const float* __restrict__ d, float* __restrict__ out, int b, int t, int* lines) {
  grid_close<SR, false, float>(d, b, (long long)b * b, nullptr, out, nullptr, b, t, lines);
}

template <int SR>
__global__ void __launch_bounds__(kGridThreads)
fw_block_pred_grid(const float* __restrict__ d, const int* __restrict__ p,
                   float* __restrict__ dout, int* __restrict__ pout, int b, int t, int* lines) {
  grid_close<SR, true, float>(d, b, (long long)b * b, p, dout, pout, b, t, lines);
}

template <int SR>
cudaError_t launch(bool pred, const float* d, const int* p, float* dout, int* pout, int t,
                   int b, int cluster, int rows, int threads, int shared, int* lines,
                   cudaStream_t s) {
  if (b > kCloseMaxB) {
    const long long nrows = (long long)t * b;
    if (pred)
      return launch_grid_close(fw_block_pred_grid<SR>, nrows, lines, s, d, p, dout, pout, b, t,
                               lines);
    return launch_grid_close(fw_block_grid<SR>, nrows, lines, s, d, dout, b, t, lines);
  }
  if (pred)
    return launch_clusters(fw_block_pred<SR>, t, cluster, threads, shared, s, d, p, dout,
                           pout, b, rows);
  return launch_clusters(fw_block<SR>, t, cluster, threads, shared, s, d, dout, b, rows);
}

}  // namespace repro_torch

// C interface for ctypes.  d and dout (t, b, b) contiguous float32; with
// pred == 1, p and pout (t, b, b) contiguous int32 (otherwise null).  The
// launch plan (cluster, rows, threads, shared) comes from the wrapper and is
// checked here: the cluster closure's (close_plan_ok) for b <= 256, the grid
// closure's (grid_plan_ok) above, which also takes `lines`, int32 scratch of
// grid_lines_words(b, t, pred) words (null for b <= 256).  Returns a
// cudaError_t.
extern "C" int fw_block_launch(int semiring, int pred, const void* d, const void* p, void* dout,
                               void* pout, int t, int b, int cluster, int rows, int threads,
                               int shared, void* lines, void* stream) {
  using namespace repro_torch;
  const bool plan_ok = b <= kCloseMaxB
                           ? close_plan_ok(b, pred != 0, cluster, rows, threads, shared)
                           : grid_plan_ok(b, cluster, rows, threads, shared) && lines;
  if (t < 1 || b < 1 || (pred && (!p || !pout)) || !plan_ok) return cudaErrorInvalidValue;
  const float* df = static_cast<const float*>(d);
  const int* pi = static_cast<const int*>(p);
  float* dof = static_cast<float*>(dout);
  int* poi = static_cast<int*>(pout);
  int* li = static_cast<int*>(lines);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return launch<0>(pred, df, pi, dof, poi, t, b, cluster, rows, threads, shared, li, s);
    case 1: return launch<1>(pred, df, pi, dof, poi, t, b, cluster, rows, threads, shared, li, s);
    case 2: return launch<2>(pred, df, pi, dof, poi, t, b, cluster, rows, threads, shared, li, s);
    case 3: return launch<3>(pred, df, pi, dof, poi, t, b, cluster, rows, threads, shared, li, s);
    default: return cudaErrorInvalidValue;
  }
}

// The cluster size the latest closure launch with (pred == 1) or without
// preds ran on, read from the card and set back to 0 (cluster_ctas_seen).
extern "C" int fw_block_cluster_ctas(int pred) {
  return repro_torch::cluster_ctas_seen(pred != 0);
}
