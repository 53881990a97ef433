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
// The round is three grids on one stream (an f32 pivot at B = 256 is 256 KiB,
// more than one CTA's 227 KB of shared memory):
//   1. fw_closure:  one thread-block cluster of 8 CTAs a graph closes its
//      pivot (cluster_close, fw_closure.cuh, shared with fw_block.cu): the
//      tile in the cluster's registers, one cluster barrier for each 8
//      pivots.  It replaces a one-CTA closure (0.74 ms a round at B = 256 on an H100,
//      a quarter of the solve) that ran while 131 SMs waited.
//      Above 256 nodes, fw_closure_grid closes the pivots instead: one
//      cooperative launch of the grid closure (grid_close, fw_closure.cuh),
//      the tile in global memory in L2, one grid barrier a pivot step.
//   2. fw_colpanel: col' with the tiled fold (fold_tile) in 64 x 64 tiles,
//      (B/64) * (N/64) CTAs (512 at N = 8192, B = 256, against 128 before),
//      written transposed through shared memory into a (G, B, Np) f32
//      scratch; the CTAs of the first column of tiles also copy the pivot
//      row panel into a (G, B, Np) f32 scratch.
//   3. fw_update:   CTAs over (G, N/64, N/128) output tiles fold
//      col'^T ⊗ rowpanel over k = 0..B on top of D and write D in place.
//      Both operands are k-major rows of the scratches, so the fold
//      (fold_ring, minplus_tile.cuh) fills a ring of three shared-memory
//      slices of 32 k steps with 16-byte cp.async copies two slices ahead,
//      with one CTA barrier a slice.  It replaces a fold that staged each
//      16-step slice with scalar loads and a transposing store and then
//      waited (2.06 ms a round on an H100, half its operations bound; 2.43 SASS
//      instructions a candidate, 0.37 of them staging).
// Np is N rounded up to a multiple of 32 floats (computed by the wrapper),
// so every row of both scratches is 16-byte aligned for any N.
// In-place hazard: grid 3 reads the row panel while the CTAs that own those
// rows overwrite them, so it reads the copy grid 2 made.  Scratch is
// G*(B*B + 2*B*Np) floats (16 MiB at N = 8192, B = 256), against the second
// N x N buffer (256 MiB) that ping-pong would take.
//
// The wrapper (kernels/fw_round.py) checks shapes, computes the closure's
// launch plan and Np, and allocates the scratch; everything launches on the
// caller's stream, and each launch's error is returned to it.
#include <cuda_runtime.h>

#include "fw_closure.cuh"
#include "minplus_tile.cuh"
#include "semiring.cuh"

namespace repro_torch {

// Column panel tiles (fold_tile) and their transposed staging pitch.
constexpr int PM = 64, PN = 64, PK = 16, PT = 4;
using Panel = TileShape<PM, PN, PK, PT, PT>;
constexpr int kPanelPitch = PM + 1;
constexpr int kPanelSmemFloats =
    Panel::kSmemFloats > PN * kPanelPitch ? Panel::kSmemFloats : PN * kPanelPitch;

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

template <int SR, class T>
__global__ void __launch_bounds__(Panel::kThreads)
fw_colpanel(const T* __restrict__ d, const float* __restrict__ apiv,
            float* __restrict__ colt, float* __restrict__ rowp, int n, int b, int o, int np) {
  __shared__ __align__(16) float smem[kPanelSmemFloats];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * PM, n0 = blockIdx.x * PN;
  const int t = threadIdx.x;
  const T* dg = d + (long long)g * n * n;
  float acc[PT][PT];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int jj = 0; jj < PT; ++jj) acc[i][jj] = Semiring<SR>::zero();
  fold_tile<SR, PM, PN, PK, PT, PT>(acc, dg + o, n, apiv + (long long)g * b * b, b,
                                    m0, n0, n, b, b, smem);
  // fold_tile ends on a barrier: its shared memory now takes the tile
  // transposed, [column][row], so that the stores below are row runs.
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int jj = 0; jj < PT; ++jj)
      smem[(Panel::col(t) + jj) * kPanelPitch + Panel::row(t) + i] =
          Storage<T>::round(acc[i][jj]);
  __syncthreads();
  float* cg = colt + (long long)g * b * np;
  for (int e = t; e < PM * PN; e += Panel::kThreads) {
    const int c = e / PM, r = e % PM;
    if (n0 + c < b && m0 + r < n) cg[(long long)(n0 + c) * np + m0 + r] = smem[c * kPanelPitch + r];
  }

  // Columns m0..m0+PM of the pivot row panel, copied once per row tile.
  if (blockIdx.x == 0) {
    float* rg = rowp + (long long)g * b * np;
    for (int e = t; e < b * PM; e += Panel::kThreads) {
      const int r = e / PM, c = m0 + e % PM;
      if (c < n) rg[(long long)r * np + c] = Storage<T>::load(dg[(long long)(o + r) * n + c]);
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

template <int SR, class T>
cudaError_t launch_round(T* d, float* apiv, float* colt, float* rowp, int g, int n, int b,
                         int o, int np, ClosePlan plan, int* lines, cudaStream_t s) {
  cudaError_t err =
      b > kCloseMaxB
          ? launch_grid_close(fw_closure_grid<SR, T>, (long long)g * b, lines, s,
                              static_cast<const T*>(d), apiv, n, b, o, g, lines)
          : launch_clusters(fw_closure<SR, T>, g, plan.cluster, plan.threads, plan.shared, s,
                            static_cast<const T*>(d), apiv, n, b, o, plan.rows);
  if (err != cudaSuccess) return err;
  const dim3 panel((b + PN - 1) / PN, (n + PM - 1) / PM, g);
  fw_colpanel<SR, T><<<panel, Panel::kThreads, 0, s>>>(d, apiv, colt, rowp, n, b, o, np);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fw_update<SR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 update((n + UN - 1) / UN, (n + UM - 1) / UM, g);
  fw_update<SR, T><<<update, Ring::kThreads, Ring::kSmemBytes, s>>>(d, colt, rowp, n, b, np);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int semiring, void* d, void* apiv, void* colt, void* rowp, int g, int n,
                     int b, int o, int np, ClosePlan plan, int* li, cudaStream_t s) {
  T* dd = static_cast<T*>(d);
  float *a = static_cast<float*>(apiv), *c = static_cast<float*>(colt),
        *r = static_cast<float*>(rowp);
  switch (semiring) {
    case 0: return launch_round<0, T>(dd, a, c, r, g, n, b, o, np, plan, li, s);
    case 1: return launch_round<1, T>(dd, a, c, r, g, n, b, o, np, plan, li, s);
    case 2: return launch_round<2, T>(dd, a, c, r, g, n, b, o, np, plan, li, s);
    case 3: return launch_round<3, T>(dd, a, c, r, g, n, b, o, np, plan, li, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_torch

// C interface for ctypes.  d: (g, n, n) contiguous storage, float32
// (bf16 == 0) or bf16 (bf16 == 1); apiv (g, b, b), colt (g, b, np) and rowp
// (g, b, np) are float32 scratch, np a multiple of 32 that is >= n.  The
// closure's launch plan (cluster, rows, threads, shared) comes from the
// wrapper and is checked here: the cluster closure's (close_plan_ok) for
// b <= 256, the grid closure's (grid_plan_ok) above, which also takes
// `lines`, int32 scratch of grid_lines_words(b, g, false) words (null for
// b <= 256).  Returns a cudaError_t.
extern "C" int fw_round_launch(int semiring, int bf16, void* d, void* apiv, void* colt,
                               void* rowp, int g, int n, int b, int o, int np, int cluster,
                               int rows, int threads, int shared, void* lines, void* stream) {
  using namespace repro_torch;
  const bool plan_ok = b <= kCloseMaxB ? close_plan_ok(b, false, cluster, rows, threads, shared)
                                       : grid_plan_ok(b, cluster, rows, threads, shared) && lines;
  if (g < 1 || n < 1 || b < 1 || n % b != 0 || o < 0 || o % b != 0 || o >= n || np < n ||
      np % 32 != 0 || !plan_ok)
    return cudaErrorInvalidValue;
  const ClosePlan plan{cluster, rows, threads, shared};
  int* li = static_cast<int*>(lines);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(semiring, d, apiv, colt, rowp, g, n, b, o, np, plan, li, s)
              : dispatch<float>(semiring, d, apiv, colt, rowp, g, n, b, o, np, plan, li, s);
}

// The cluster size the latest fw_closure launch ran on, read from the card
// and set back to 0 (cluster_ctas_seen).
extern "C" int fw_round_cluster_ctas() { return repro_torch::cluster_ctas_seen(false); }
