// Closure of a stack of independent B x B tiles on Hopper (sm_90a), with
// and without predecessors.
//
// fw_block replaces the TPU kernel fw_block_pallas
// (src/repro/kernels/fw_block.py:34): the closure of each (B, B) tile of a
// (T, B, B) float32 stack, B sequential rank-1 ⊕⊗ steps.  It runs the
// fused round's closure code (close_tile, fw_closure.cuh) on one CTA per
// tile, B <= 256.
//
// fw_block_pred replaces fw_block_pred_pallas (fw_block.py:67): the same
// closure plus int32 predecessors, pred[i, j] <- pred[k, j] on a strict
// improvement through pivot k.  A tile at B = 256 is 256 KiB of values and
// 256 KiB of preds, more than an SM's registers and shared memory, so this
// first version keeps the tile in its global output (where it stays in L2)
// and runs one CTA of 1024 threads per tile.  At each step k the CTA stages
// row k (values and preds) and column k (values) in shared memory, waits,
// updates, and waits again.  The staging is required, not an optimisation:
// when d[k, k] is not the semiring one (a tropical negative cycle) step k
// rewrites row k and column k, and the JAX step reads the old ones.  Each
// thread owns one column j and the rows i0, i0 + groups, ...; it writes a
// value and a pred only where the value strictly improves, so a NaN
// candidate never improves and a NaN value is never replaced, as in the JAX
// oracle fw_block_pred_ref.
//
// What bounds them on this card.  A closure is B^3 candidates, all on one
// SM: it is bound by that SM's instruction issue (fw_block) or by its share
// of L2 bandwidth, B^2 loads a step (fw_block_pred), not by the card.  At
// B = 256 fw_block_pred moves about 13 bytes a cycle (2.5 ms a tile on an
// H100 at 700 W), so its next design keeps the tile on chip (close_tile's
// registers and shared memory, or a cluster's distributed shared memory)
// and sends only the preds to L2.
//
// The wrapper (kernels/fw_block.py) checks shapes and allocates the
// outputs; the kernels launch on the caller's stream and their error is
// returned.
#include <cuda_runtime.h>

#include "fw_closure.cuh"
#include "semiring.cuh"

namespace repro_torch {

constexpr int kPredThreads = 1024;

template <int SR>
__global__ void __launch_bounds__(kCloseThreads, 1)
fw_block(const float* __restrict__ d, float* __restrict__ out, int b) {
  extern __shared__ float4 smem4[];
  const long long tile = (long long)blockIdx.x * b * b;
  close_tile<SR, float>(d + tile, out + tile, b, b, smem4);
}

template <int SR>
__global__ void __launch_bounds__(kPredThreads, 1)
fw_block_pred(const float* __restrict__ d, const int* __restrict__ p, float* dout, int* pout,
              int b) {
  using S = Semiring<SR>;
  __shared__ float srow[kCloseMaxB];
  __shared__ float scol[kCloseMaxB];
  __shared__ int sprow[kCloseMaxB];
  const long long tile = (long long)blockIdx.x * b * b;
  d += tile;
  p += tile;
  dout += tile;
  pout += tile;
  const int t = threadIdx.x;
  for (int e = t; e < b * b; e += kPredThreads) {
    dout[e] = d[e];
    pout[e] = p[e];
  }
  const int groups = kPredThreads / b;
  const int j = t % b;
  const int i0 = t / b;
  const bool active = i0 < groups;
  __syncthreads();
  for (int k = 0; k < b; ++k) {
    if (t < b) {
      srow[t] = dout[k * b + t];
      sprow[t] = pout[k * b + t];
      scol[t] = dout[t * b + k];
    }
    __syncthreads();
    if (active) {
      const float rj = srow[j];
      const int pj = sprow[j];
      for (int i = i0; i < b; i += groups) {
        const int e = i * b + j;
        const float via = S::mul(scol[i], rj);
        if (S::better(via, dout[e])) {
          dout[e] = via;
          pout[e] = pj;
        }
      }
    }
    __syncthreads();
  }
}

template <int SR>
cudaError_t launch(bool pred, const float* d, const int* p, float* dout, int* pout, int t,
                   int b, cudaStream_t s) {
  if (pred) {
    fw_block_pred<SR><<<t, kPredThreads, 0, s>>>(d, p, dout, pout, b);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      fw_block<SR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kCloseSmemBytes);
  if (err != cudaSuccess) return err;
  fw_block<SR><<<t, kCloseThreads, kCloseSmemBytes, s>>>(d, dout, b);
  return cudaGetLastError();
}

}  // namespace repro_torch

// C interface for ctypes.  d and dout (t, b, b) contiguous float32; with
// pred == 1, p and pout (t, b, b) contiguous int32 (otherwise null).
// Returns a cudaError_t.
extern "C" int fw_block_launch(int semiring, int pred, const void* d, const void* p, void* dout,
                               void* pout, int t, int b, void* stream) {
  using namespace repro_torch;
  if (t < 1 || b < 1 || b > kCloseMaxB || (pred && (!p || !pout))) return cudaErrorInvalidValue;
  const float* df = static_cast<const float*>(d);
  const int* pi = static_cast<const int*>(p);
  float* dof = static_cast<float*>(dout);
  int* poi = static_cast<int*>(pout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return launch<0>(pred, df, pi, dof, poi, t, b, s);
    case 1: return launch<1>(pred, df, pi, dof, poi, t, b, s);
    case 2: return launch<2>(pred, df, pi, dof, poi, t, b, s);
    case 3: return launch<3>(pred, df, pi, dof, poi, t, b, s);
    default: return cudaErrorInvalidValue;
  }
}
